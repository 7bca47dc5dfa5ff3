"""Smoke test of the Benson main path on one GPU.

    python chip_smoke.py              # one GPU; last line {"ok": true, ...}
    python chip_smoke.py --four       # the mesh path on four GPUs only
    python chip_smoke.py --rehearse   # same phases, CPU, small sizes
    python chip_smoke.py --only ex10  # a subset of phases (comma list)

Phases (one process; every input generated from bensolve_tpu.examples
or a fixed seed, and written with vlp/writer.py under
chiprun_out/smoke/ inside the checkout):

  device    platform, device kind and count, jax version, x64, the
            card's name and power limit (nvidia-smi), polytope engine
  cli       `python -m bensolve_tpu` semantics on ex01, 02, 04, 05,
            06, 08, 11: exact ex01 vertex sets, expected statuses, the
            support oracle on ex11
  ex10      the bensolvehedron (n=343) through solve() at default
            options, primal and dual algorithm, support oracle at 1e-4
  lu        batched f64 LU (lp/linalg.py) against scipy
  backends  each simplex backend against HiGHS: tableau f64 and f32
            (timed), dual-simplex warm re-solve, revised f64
  ipm       the IPM route at the config-#4 P2 shape, f64 and f32,
            against HiGHS

Every phase runs; a failed phase prints its traceback and makes the
exit code 1.  The last line, printed only when every phase passed on a
GPU, is {"ok": true, "device": {"platform", "kind", "count"}}.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import time
import traceback

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

# f64 reference epsilon of the LP layer (GLPK-grade, bslv_main.h:71-78)
TOL_F64 = 1e-7


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str | None:
    """The card's name and power limit, read off JAX by a child."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else None


def peak_bytes(dev) -> str:
    stats = dev.memory_stats()
    if not stats or "peak_bytes_in_use" not in stats:
        return "not available"
    return str(stats["peak_bytes_in_use"])


def rel_err(obj, ref) -> float:
    return abs(float(obj) - float(ref)) / (1.0 + abs(float(ref)))


def check_vs_highs(name, res, refs, idx, tol, precision) -> None:
    """Worst relative objective error of ``res`` against the HiGHS
    results ``refs`` of the sampled instances ``idx``; every sample must
    be OPTIMAL in both."""
    import numpy as np

    from bensolve_tpu.lp.simplex import OPTIMAL

    worst = 0.0
    for i, (status, fun, message) in zip(idx, refs):
        assert status == 0, (name, i, message)
        assert res.status[i] == OPTIMAL, (name, i, int(res.status[i]))
        worst = max(worst, rel_err(res.obj[i], fun))
    n_opt = int((np.asarray(res.status) == OPTIMAL).sum())
    log(f"  {name}: precision={precision} optimal={n_opt}/"
        f"{len(res.status)} worst_rel_err_vs_highs={worst!r} "
        f"(n={len(idx)}, tol={tol!r})")
    assert worst <= tol, (name, worst, tol)


def _highs_obj(*lp):
    """(status, objective, message) of one LP by HiGHS.  Runs in a child
    process that loads bensolve_tpu/oracle.py alone (numpy and scipy),
    so it never imports JAX or touches the card."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "_oracle", os.path.join(REPO, "bensolve_tpu", "oracle.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    r = mod.highs_lp(*lp)
    return int(r.status), float(r.fun) if r.status == 0 else None, r.message


class Refs:
    """HiGHS reference objectives, solved in child processes while the
    device phases run (a P2-shape LP takes HiGHS seconds)."""

    def __init__(self):
        import concurrent.futures
        import multiprocessing

        workers = max(1, min(8, (os.cpu_count() or 2) - 2))
        self.pool = concurrent.futures.ProcessPoolExecutor(
            workers, mp_context=multiprocessing.get_context("spawn"))
        self.futs = {}

    def submit(self, key, inputs, idx):
        A, c, rlb, rub, clb, cub = inputs
        self.futs[key] = [self.pool.submit(_highs_obj, A, c[i], rlb[i],
                                           rub[i], clb[i], cub[i])
                          for i in idx]

    def get(self, key):
        return [f.result() for f in self.futs[key]]

    def close(self):
        self.pool.shutdown(wait=True, cancel_futures=True)


def timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


class Smoke:
    def __init__(self, rehearse: bool):
        import jax

        self.jax = jax
        self.rehearse = rehearse
        self.dev = jax.devices()[0]
        self.out = os.path.join(REPO, "chiprun_out", "smoke")
        os.makedirs(self.out, exist_ok=True)

    # -- phases ----------------------------------------------------------

    def device(self):
        jax = self.jax
        from bensolve_tpu import native

        devs = jax.devices()
        log(f"  platform={devs[0].platform} kind={devs[0].device_kind} "
            f"count={len(devs)} jax={jax.__version__} "
            f"x64={bool(jax.config.jax_enable_x64)}")
        smi = nvidia_smi()
        if smi is None:
            assert self.rehearse, "nvidia-smi gave no card name"
            log("  nvidia-smi: not available")
        else:
            log(smi)
        engine = "native" if native.lib() is not None else "python"
        log(f"  polytope engine: {engine}")
        cache = (os.environ.get("JAX_COMPILATION_CACHE_DIR")
                 or jax.config.jax_compilation_cache_dir)
        log(f"  compile cache: {cache}")

    def cli(self):
        from bensolve_tpu import examples
        from bensolve_tpu.__main__ import main as cli_main
        from bensolve_tpu.algs.driver import solve_file
        from bensolve_tpu.oracle import check_support
        from bensolve_tpu.vlp.options import Options

        ex_dir = examples.write_suite(os.path.join(self.out, "ex"))
        # expected exit code and status line of the reference CLI
        expect = {"ex01": (0, ""), "ex02": (1, "infeasible"),
                  "ex04": (1, "totally unbounded"), "ex05": (0, ""),
                  "ex06": (0, ""), "ex08": (0, ""), "ex11": (0, "")}
        for ex, (rc_want, msg) in expect.items():
            path = os.path.join(ex_dir, f"{ex}.vlp")
            base = os.path.join(self.out, "cli", ex)
            os.makedirs(os.path.dirname(base), exist_ok=True)
            buf = io.StringIO()
            rc, dt = timed(lambda: _quiet(
                buf, lambda: cli_main([path, "-o", base])))
            text = buf.getvalue()
            ok = rc == rc_want and msg in text.lower()
            log(f"  {ex}: rc={rc} ({'as expected' if ok else 'WRONG'}) "
                f"{dt:.3f}s")
            assert ok, (ex, rc, text[-400:])

        pts = _read_sol(os.path.join(self.out, "cli", "ex01_img_p.sol"))
        verts = sorted(tuple(r[1:]) for r in pts if r[0] == 1)
        dirs = sorted(tuple(r[1:]) for r in pts if r[0] == 0)
        ok = (verts == [(-6.0, 6.0), (0.0, 4.0)]
              and dirs == [(-1.0, 1.0), (1.0, 0.0)])
        log(f"  ex01 vertex sets: points={verts} directions={dirs} "
            f"({'exact' if ok else 'MISMATCH'})")
        assert ok

        buf = io.StringIO()
        r = _quiet(buf, lambda: solve_file(
            os.path.join(ex_dir, "ex11.vlp"),
            Options(filename=os.path.join(self.out, "cli", "ex11_lib"),
                    message_level=0)))
        assert r.status.name == "OPTIMAL", r.status
        assert r.sol.pp_dir == 22, r.sol.pp_dir
        check_support(r, n_samples=16)
        log(f"  ex11: directions={r.sol.pp_dir} support oracle ok at "
            f"{TOL_F64!r} (lps={r.stats.lps})")

    def ex10(self):
        from bensolve_tpu import examples
        from bensolve_tpu.algs.driver import solve
        from bensolve_tpu.oracle import check_support
        from bensolve_tpu.vlp.options import Alg, Options

        vlp_fn = ((lambda: examples.example10(m=1)) if self.rehearse
                  else (lambda: examples.load("ex10")))
        label = "ex10(m=1)" if self.rehearse else "ex10"

        def run(**kw):
            return solve(vlp_fn(), Options(write_files=False, **kw))

        r1, t1 = timed(run)
        r2, t2 = timed(run)
        for r in (r1, r2):
            assert r.status.name == "OPTIMAL", r.status
        assert _vset(r1.primal_points) == _vset(r2.primal_points)
        check_support(r2, n_samples=16, tol=1e-4)
        s = r2.stats
        log(f"  {label} primal: rounds={s.rounds} lps={s.lps} "
            f"pivots={s.pivots} points={len(r2.primal_points)} "
            f"directions={len(r2.primal_directions)} "
            f"first_solve_s={t1!r} solve_s={t2!r} "
            f"compile_s~={t1 - t2!r} peak_bytes_in_use={peak_bytes(self.dev)}"
            f" support oracle ok at 1e-4")
        rd, td = timed(lambda: run(alg_phase1=Alg.DUAL, alg_phase2=Alg.DUAL))
        assert rd.status.name == "OPTIMAL", rd.status
        check_support(rd, n_samples=16, tol=1e-4)
        s = rd.stats
        log(f"  {label} dual: rounds={s.rounds} lps={s.lps} "
            f"points={len(rd.primal_points)} "
            f"directions={len(rd.primal_directions)} "
            f"first_solve_s={td!r} peak_bytes_in_use="
            f"{peak_bytes(self.dev)} support oracle ok at 1e-4")

    def lu(self):
        import jax
        import jax.numpy as jnp
        import numpy as np
        import scipy.linalg

        from bensolve_tpu.lp import linalg

        shapes = ([(32, 64), (101, 4)] if self.rehearse
                  else [(96, 4096), (1011, 16)])
        fac = jax.jit(jax.vmap(linalg.lu_factor))
        sol = jax.jit(jax.vmap(linalg.lu_solve))
        for M, B in shapes:
            rng = np.random.default_rng(M)
            A = rng.standard_normal((B, M, M))
            b = rng.standard_normal((B, M))
            lu, piv = fac(jnp.asarray(A))
            x = np.asarray(sol((lu, piv), jnp.asarray(b)))
            worst = 0.0
            for i in range(0, B, max(1, B // 16)):
                xr = scipy.linalg.solve(A[i], b[i])
                worst = max(worst, float(np.linalg.norm(x[i] - xr)
                                         / np.linalg.norm(xr)))
            log(f"  vmap(lu_factor) f64 M={M} B={B}: worst relative "
                f"solution error vs scipy={worst!r} (tol=1e-9)")
            assert worst <= 1e-9, (M, B, worst)

    def prepare(self, names) -> None:
        """Generate the LP batches of the backend phases and hand their
        sampled instances to HiGHS in the background."""
        import numpy as np

        from bench import make_instances, make_p2_instances

        small = self.rehearse
        self.refs = Refs()
        self.lps = {}
        rng = np.random.default_rng(11)
        if "ipm" in names:
            # the config-#4 P2 shape; the f32 route solves the same LPs
            # rounded to f32, so both are held to the f64 references
            B, kw = ((8, dict(m=100, n=200, ipm_min=100)) if small
                     else (128, {}))
            t2, extra_ub = make_p2_instances(B, dtype=np.float64, **kw)
            inp = (t2.A_lp,) + t2.build_inputs(extra_ub)
            idx = np.sort(rng.choice(B, min(16, B), replace=False))
            self.lps["p2"] = (B, kw, idx)
            self.refs.submit("p2", inp, idx)
        if "backends" in names:
            M, N, B = (32, 32, 64) if small else (96, 96, 4096)
            idx = np.sort(rng.choice(B, 16, replace=False))
            for dt in (np.float64, np.float32):
                inp = make_instances(M, N, B, dtype=dt)
                self.lps[f"tableau {np.dtype(dt).name}"] = (inp, idx)
                self.refs.submit(f"tableau {np.dtype(dt).name}", inp, idx)
            # the Benson re-solve pattern: row bounds tightened a little
            A, c, rlb, rub, clb, cub = self.lps["tableau float64"][0]
            inp = (A, c, rlb, rub * 0.99, clb, cub)
            self.lps["dual"] = (inp, idx)
            self.refs.submit("dual", inp, idx)
            M, N, B = (16, 128, 32) if small else (128, 1024, 512)
            inp = make_instances(M, N, B, seed=1, dtype=np.float64)
            idx = np.sort(rng.choice(B, 16, replace=False))
            self.lps["revised"] = (inp, idx)
            self.refs.submit("revised", inp, idx)

    def backends(self):
        import numpy as np

        from bensolve_tpu.lp import revised, simplex
        from bensolve_tpu.lp.dual_simplex import solve_batch_dual

        # tableau: f64 held to the reference epsilon; f32 to 1e-4 — its
        # feasibility and reduced-cost tolerances are 1e-5
        # (simplex._tols), and the final f32 LU solve adds ~1e-6
        res64 = None
        for dt, tol in ((np.float64, TOL_F64), (np.float32, 1e-4)):
            name = f"tableau {np.dtype(dt).name}"
            inp, idx = self.lps[name]
            B = inp[1].shape[0]

            def go():
                return simplex.solve_batch(*inp, dtype=dt, max_chunk=B)

            _, t_first = timed(go)
            res, t = timed(go)
            M, N = inp[0].shape
            log(f"  {name} {M}x{N} B={B}: first_call_s={t_first!r} "
                f"solve_s={t!r} LP/s={B / t!r} "
                f"mean_pivots={float(res.iters.mean())!r}")
            check_vs_highs(name, res, self.refs.get(name), idx, tol,
                           np.dtype(dt).name)
            if dt is np.float64:
                res64 = res

        # dual-simplex warm re-solve from each LP's own optimal basis
        inp, idx = self.lps["dual"]
        warm = (np.asarray(res64.basis), np.asarray(res64.at_upper))

        def go_dual():
            return solve_batch_dual(*inp, start_basis=warm,
                                    dtype=np.float64, max_chunk=B)

        _, t_first = timed(go_dual)
        res, t = timed(go_dual)
        log(f"  dual warm float64 {M}x{N} B={B}: first_call_s={t_first!r} "
            f"solve_s={t!r} mean_pivots={float(res.iters.mean())!r}")
        check_vs_highs("dual warm float64", res, self.refs.get("dual"), idx,
                       TOL_F64, "float64")

        # revised simplex on a tall batch (N >= REVISED_RATIO * M)
        inp, idx = self.lps["revised"]
        M, N = inp[0].shape
        B = inp[1].shape[0]
        assert N >= revised.REVISED_RATIO * M

        def go_rev():
            return revised.solve_batch_revised(*inp, dtype=np.float64,
                                               max_chunk=B)

        _, t_first = timed(go_rev)
        res, t = timed(go_rev)
        log(f"  revised float64 {M}x{N} B={B}: first_call_s={t_first!r} "
            f"solve_s={t!r} mean_pivots={float(res.iters.mean())!r}")
        check_vs_highs("revised float64", res, self.refs.get("revised"),
                       idx, TOL_F64, "float64")

    def ipm(self):
        import numpy as np

        from bench import make_p2_instances

        # the IPM route at the config-#4 P2 shape: the device IPM and its
        # host polish alone (host HiGHS and simplex fallbacks off), f64
        # then f32.  Instances the IPM reports clean (quality 0) are held
        # to the dtype's tolerance; those it flags (quality >= 1, which
        # the default route re-solves with host HiGHS) to its loose
        # acceptance bound, 250x its own tolerance (lp/ipm.py _params).
        B, kw, idx = self.lps["p2"]
        refs = self.refs.get("p2")
        bad = []
        with _env(BENSOLVE_HOST_FALLBACK="0", BENSOLVE_IPM_FALLBACK_M="0"):
            for dt, tol, loose in ((np.float64, TOL_F64, 2.5e-6),
                                   (np.float32, F32_IPM_TOL, 2.5e-2)):
                t2, extra_ub = make_p2_instances(B, dtype=dt, **kw)
                res, t = timed(lambda: t2.solve(extra_ub))
                # only the IPM reports a per-instance quality
                assert res.quality is not None, "P2 batch missed the IPM"
                name = np.dtype(dt).name
                prec = (name if dt is np.float64 else name + ", matmul "
                        + os.environ.get("BENSOLVE_IPM_PRECISION",
                                         "highest"))
                M, N = t2.A_lp.shape
                log(f"  ipm {name} P2 {M}x{N} B={B}: first_solve_s={t!r} "
                    f"max_iters={int(res.iters.max())} quality_counts="
                    f"{np.bincount(res.quality, minlength=3).tolist()}")
                clean = res.quality[idx] == 0
                for sel, lim, what in ((clean, tol, "clean"),
                                       (~clean, loose, "flagged")):
                    if not sel.any():
                        continue
                    try:
                        check_vs_highs(
                            f"ipm {name} {what}", res,
                            [r for r, s in zip(refs, sel) if s], idx[sel],
                            lim, prec)
                    except AssertionError as e:
                        bad.append(e)
        assert not bad, bad

    def run(self, names) -> list:
        """Run the phases in order; return the names of those failed."""
        failed = []
        for name in names:
            log(f"[{name}]")
            t0 = time.perf_counter()
            try:
                getattr(self, name)()
            except Exception:
                traceback.print_exc()
                sys.stdout.flush()
                failed.append(name)
                log(f"[{name}] FAILED after "
                    f"{time.perf_counter() - t0:.1f}s")
                continue
            log(f"[{name}] passed in {time.perf_counter() - t0:.1f}s")
        return failed

    # -- four devices ----------------------------------------------------

    def four(self):
        import __graft_entry__
        from bensolve_tpu import examples
        from bensolve_tpu.algs.driver import solve
        from bensolve_tpu.vlp.options import Options

        n_dev = len(self.jax.devices())
        assert n_dev >= 4, f"--four needs 4 devices, found {n_dev}"
        vlp_fn = ((lambda: examples.example10(m=1)) if self.rehearse
                  else (lambda: examples.load("ex10")))

        def sets_match(r, ref):
            return (_sets_match(r.primal_points, ref.primal_points)
                    and _sets_match(r.primal_directions,
                                    ref.primal_directions)
                    and _sets_match(r.dual_points, ref.dual_points))

        ref, t = timed(lambda: solve(vlp_fn(), Options(write_files=False)))
        assert ref.status.name == "OPTIMAL", ref.status
        log(f"  single device: lps={ref.stats.lps} "
            f"points={len(ref.primal_points)} first_solve_s={t!r}")
        # the solution is compared, not the path: a mesh solve re-solves
        # P2 LPs by primal warm starts (the dual warm re-solve and the
        # kept tableau are single-device paths, algs/templates.py), and
        # on ex10's exactly tied reduced costs the last bits of a
        # differently compiled kernel pick other optimal bases, so the
        # LP count may differ; it is printed
        for axes in (("dp",), ("dp", "tp")):
            got, t = timed(lambda: solve(vlp_fn(), Options(
                write_files=False, mesh_axes=axes, mesh_devices=4)))
            assert got.status.name == "OPTIMAL", got.status
            ok = sets_match(got, ref)
            log(f"  mesh {axes}: lps={got.stats.lps} "
                f"points={len(got.primal_points)} first_solve_s={t!r} "
                f"(vertex sets {'equal' if ok else 'DIFFERENT'} within "
                f"1e-9 of the single-device solve)")
            assert ok, axes
        __graft_entry__.dryrun_multichip(4)
        log("  dryrun_multichip(4): ok")


# f32 IPM at the P2 shape against HiGHS: the f32 IPM stops at a relative
# KKT residual of 1e-4 (lp/ipm.py _params), so its objective is good to
# about that times the problem's conditioning; 1e-3 (1+|obj|) leaves one
# decade for it and would still catch a TF32-grade (1e-3 per product)
# normal matrix that stalls or drifts.
F32_IPM_TOL = 1e-3


def _quiet(buf, fn):
    with contextlib.redirect_stdout(buf):
        return fn()


@contextlib.contextmanager
def _env(**kv):
    old = {k: os.environ.get(k) for k in kv}
    os.environ.update(kv)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _read_sol(path):
    rows = []
    with open(path) as fh:
        for line in fh:
            if line.strip():
                rows.append(tuple(round(float(t), 9) for t in line.split()))
    return rows


def _vset(a):
    import numpy as np

    return sorted(map(tuple, np.round(np.atleast_2d(a), 9)))


def _sets_match(a, b, tol=1e-9):
    """Unordered equality of two point sets within ``tol``."""
    import numpy as np

    a, b = np.atleast_2d(a), np.atleast_2d(b)
    if a.shape != b.shape:
        return False
    if a.size == 0:
        return True
    d = np.abs(a[:, None, :] - b[None, :, :]).max(axis=2)
    return bool((d.min(axis=1) <= tol).all() and (d.min(axis=0) <= tol).all())


PHASES = ("device", "cli", "ex10", "lu", "backends", "ipm")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rehearse", action="store_true",
                    help="CPU dry run at small sizes; never prints ok")
    ap.add_argument("--four", action="store_true",
                    help="only the four-device mesh path")
    ap.add_argument("--only", default="",
                    help="comma-separated subset of " + ",".join(PHASES))
    args = ap.parse_args(argv)

    import jax

    jax.config.update("jax_enable_x64", True)
    devs = jax.devices()
    if devs[0].platform != "gpu" and not args.rehearse:
        print(f"chip_smoke: JAX found no GPU (platform "
              f"{devs[0].platform!r}); use --rehearse for a CPU dry run",
              file=sys.stderr)
        return 1

    from bensolve_tpu.lp import ensure_compile_cache

    ensure_compile_cache()
    smoke = Smoke(args.rehearse)
    if args.four:
        names = ["device", "four"]
    else:
        names = [p for p in (args.only.split(",") if args.only else PHASES)
                 if p]
    t_all = time.perf_counter()
    smoke.prepare(names)
    try:
        failed = smoke.run(names)
    finally:
        smoke.refs.close()
    log(f"total {time.perf_counter() - t_all:.1f}s; "
        f"failed phases: {failed or 'none'}")
    if failed:
        return 1
    if args.rehearse or args.only:
        log("rehearsal or partial run: no ok line")
        return 0
    smi = nvidia_smi()
    log(f"card: {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
