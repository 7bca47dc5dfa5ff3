"""Benchmark: the three BASELINE.json metrics on one GPU.

Prints ONE JSON line whose primary metric is batched scalarization-LP
throughput (LP/s/chip) with vs_baseline = ratio over a serial CPU HiGHS
solver on identical instances (the stand-in for the reference's serial
GLPK loop, bslv_algs.c:863-895 — GLPK itself cannot be built here).
Secondary fields on the same line:

  p2_LPs_per_s / p2_vs_baseline — throughput on P2-TEMPLATE-SHAPED LPs
      (the Benson oracle's actual shape: m VLP rows + q coupling rows +
      p cut rows + eta row, equality coupling block, mixed bounds) built
      from the BASELINE config-#4 synthetic VLP (q=5, 1k x 2k).
  ex11_wall_s — wall-clock to epsilon-solve ex11.vlp (steady state,
      compile excluded by a warmup solve).
  benson_iters_per_s — Benson rounds/s during that ex11 solve.
  warm_pivots_per_lp / cold_pivots_per_lp — warm-start efficacy of the
      dual-simplex re-solve (the Benson re-solve pattern: same LP,
      changed row bounds).

Usage: python bench.py    (exits non-zero when JAX finds no GPU)
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

from bensolve_tpu.oracle import highs_lp


def make_instances(M, N, B, seed=0, dtype=np.float32):
    """Random feasible bounded LP batch sharing one constraint matrix:
    min c'x  s.t.  Ax <= b (b = A x0 + margin), 0 <= x <= 10."""
    rng = np.random.default_rng(seed)
    A = (rng.standard_normal((M, N)) / np.sqrt(N)).astype(dtype)
    x0 = rng.random((B, N)).astype(dtype)
    b = (x0 @ A.T + 0.5 + rng.random((B, M))).astype(dtype)
    c = rng.standard_normal((B, N)).astype(dtype)
    row_lb = np.full((B, M), -np.inf, dtype)
    col_lb = np.zeros((B, N), dtype)
    col_ub = np.full((B, N), 10.0, dtype)
    return A, c, row_lb, b, col_lb, col_ub


def run_device(A, c, row_lb, row_ub, col_lb, col_ub, reps=3):
    """The XLA lockstep tableau solver on the device, plus the Benson
    re-solve pattern (pivots/LP cold vs dual-simplex warm)."""
    from bensolve_tpu.lp import simplex

    dtype = A.dtype.type
    B = c.shape[0]

    def solve(cc, rub, warm=None):
        return simplex.solve_batch(A, cc, row_lb, rub, col_lb, col_ub,
                                   dtype=dtype, max_chunk=B,
                                   start_basis=warm)

    t_c0 = time.perf_counter()
    res = solve(c, row_ub)
    compile_s = time.perf_counter() - t_c0
    n_opt = int((res.status == simplex.OPTIMAL).sum())
    cold_pivots = float(res.iters.mean())

    times = []
    for r in range(reps):
        # perturb objectives so nothing is cached as a constant
        c2 = c * (1.0 + 0.01 * (r + 1))
        t0 = time.perf_counter()
        res = solve(c2, row_ub)
        times.append(time.perf_counter() - t0)
    best = min(times)

    # Benson re-solve pattern: keep objectives, tighten row bounds a
    # little, warm-start from an optimal basis of the previous solve.
    # Measured through the PRODUCTION warm route — the dual simplex
    # from the parent basis (bound changes keep it dual feasible,
    # lp/dual_simplex.py; templates._use_dual_warm).
    warm_pivots = None
    ok = np.flatnonzero(res.status == simplex.OPTIMAL)
    if ok.size and res.basis is not None:
        from bensolve_tpu.lp.dual_simplex import solve_batch_dual

        # per-instance parent bases, exactly like the Benson frontier
        # (_FacetWarm): each LP restarts from ITS OWN optimal basis
        # after a small row-bound tightening, which keeps the basis
        # dual feasible
        warm = (np.asarray(res.basis), np.asarray(res.at_upper))
        rub2 = (row_ub * 0.99).astype(row_ub.dtype)

        def wsolve(cc):
            return solve_batch_dual(A, cc, row_lb, rub2, col_lb,
                                    col_ub, start_basis=warm,
                                    dtype=dtype, max_chunk=B)

        wres = wsolve(c)                  # compile (new shape set)
        t0 = time.perf_counter()
        wres = wsolve(c)
        warm_time = time.perf_counter() - t0
        warm_pivots = float(wres.iters.mean())
        print(f"# warm re-solve (dual simplex): {B / warm_time:.0f} LP/s, "
              f"pivots/LP {warm_pivots:.1f} (cold {cold_pivots:.1f})",
              file=sys.stderr)
    return B / best, n_opt, compile_s, cold_pivots, warm_pivots


def run_serial_baseline(A, c, row_lb, row_ub, col_lb, col_ub, k=24):
    """Serial scipy/HiGHS on the first k instances."""
    t0 = time.perf_counter()
    n_ok = 0
    for i in range(k):
        res = highs_lp(A, c[i], row_lb[i], row_ub[i], col_lb[i],
                         col_ub[i])
        n_ok += res.status == 0
    dt = time.perf_counter() - t0
    return k / dt, n_ok


def make_p2_instances(B, q=5, m=1000, n=2000, seed=7, dtype=np.float32,
                      ipm_min=2000):
    """P2-template LP batch from the BASELINE config-#4 synthetic VLP:
    the exact matrix/bound structure the Benson hot loop issues
    (templates.py P2Template; reference init_P2 bslv_algs.c:562-664).
    ipm_min=2000 selects the PRODUCTION route for this size (M+N ≈
    3000): the Mehrotra IPM — the cold lockstep tableau needs >20k
    pivots at M ≈ 1000."""
    from bensolve_tpu.algs.templates import INHOMOGENEOUS, P2Template
    from bensolve_tpu.examples import random_vlp

    vlp = random_vlp(q=q, m=m, n=n, seed=seed)
    Z = np.eye(q)
    c_dual = np.full(q, 1.0 / q)
    # Z'c = 1 scaling (sol_init contract, bslv_vlp.c:775-792)
    Z = Z / (Z.T @ c_dual)[None, :]
    eta = np.full(q, 1.0 / q)
    t2 = P2Template(vlp, vlp.P.astype(float), Z, eta, INHOMOGENEOUS,
                    dtype=dtype, ipm_min=ipm_min)
    rng = np.random.default_rng(seed + 1)
    V = rng.random((B, q)) * 2.0 + 1.0          # synthetic frontier
    extra_ub = V @ t2.ZR
    return t2, extra_ub


def run_p2_shape(B=128):
    """Throughput on the P2-template shape + a serial HiGHS baseline on
    the SAME LPs, through the PRODUCTION route for this size (the IPM,
    ipm_min=2000 — see make_p2_instances): one cold template solve
    (compile + solve), then timed re-solve rounds with perturbed row
    bounds, exactly the Benson round pattern (warm-interior carry,
    straggler caps, quality classification all engaged).  The rate is
    the steady-state round rate a real ex07-scale solve sustains."""
    from bensolve_tpu.lp import simplex

    t2, extra_ub = make_p2_instances(B)
    print(f"# p2-shape: cold solve B={B} starting", file=sys.stderr,
          flush=True)
    t0 = time.perf_counter()
    cold = t2.solve(extra_ub)
    cold_s = time.perf_counter() - t0            # includes compile
    n_opt = int((cold.status == simplex.OPTIMAL).sum())
    print(f"# p2-shape: cold done {cold_s:.1f}s optimal={n_opt}/{B}",
          file=sys.stderr, flush=True)

    times = []
    for r in range(3):
        t0 = time.perf_counter()
        res = t2.solve(extra_ub * (1.0 - 0.002 * (r + 1)))
        dt = time.perf_counter() - t0
        times.append(dt)
        n_ok_w = int((res.status == simplex.OPTIMAL).sum())
        qual = (res.quality if res.quality is not None
                else np.zeros(1, int))
        print(f"# p2-shape: warm round {r} {dt:.2f}s optimal="
              f"{n_ok_w}/{B} loose={int((qual == 2).sum())}",
              file=sys.stderr, flush=True)
    rate = B / min(times)

    # serial baseline on identical P2 LPs (free/one-sided rows split by
    # bound pattern — linprog rejects non-finite b_ub)
    obj, row_lb, row_ub, col_lb, col_ub = t2.build_inputs(extra_ub)
    A_lp = t2.A_lp
    k = 4
    t0 = time.perf_counter()
    n_ok = 0
    for i in range(k):
        r = highs_lp(A_lp, obj[i], row_lb[i], row_ub[i], col_lb[i],
                       col_ub[i])
        n_ok += r.status == 0
    base_rate = k / (time.perf_counter() - t0)
    print(f"# p2-shape batch={B} M={A_lp.shape[0]} N={A_lp.shape[1]} "
          f"cold={cold_s:.1f}s optimal={n_opt}/{B} "
          f"warm_times={[round(t, 2) for t in times]} "
          f"serial_highs={base_rate:.2f} LP/s (ok {n_ok})",
          file=sys.stderr)
    return rate, base_rate


def run_ex11():
    """Wall-clock to epsilon-solve ex11 (BASELINE metric #2) and Benson
    rounds/s (metric #3).  Steady state: one warmup solve populates the
    jit caches, the second is timed."""
    from bensolve_tpu.algs.driver import solve
    from bensolve_tpu.examples import example11
    from bensolve_tpu.vlp.options import Options

    r = solve(example11(), Options(write_files=False))   # warmup
    assert r.status.name == "OPTIMAL", r.status
    t0 = time.perf_counter()
    r = solve(example11(), Options(write_files=False))
    wall = time.perf_counter() - t0
    iters_per_s = (r.stats.rounds + 1) / wall
    print(f"# ex11: wall={wall:.2f}s rounds={r.stats.rounds} "
          f"lps={r.stats.lps} status={r.status.name}", file=sys.stderr)
    return wall, iters_per_s


def main():
    import jax

    from bensolve_tpu.lp import ensure_compile_cache

    devs = jax.devices()
    print(f"# device: platform={devs[0].platform} "
          f"kind={devs[0].device_kind} count={len(devs)}",
          file=sys.stderr, flush=True)
    if devs[0].platform != "gpu":
        print("bench.py: no GPU found; refusing to report CPU numbers",
              file=sys.stderr)
        sys.exit(1)
    ensure_compile_cache()
    M, N, B = 96, 96, 4096
    args = make_instances(M, N, B)
    print("# stage: device", file=sys.stderr, flush=True)
    lps_per_s, n_opt, compile_s, cold_piv, warm_piv = run_device(*args)
    print("# stage: serial baseline", file=sys.stderr, flush=True)
    base_rate, base_ok = run_serial_baseline(*args)
    print("# stage: p2 shape", file=sys.stderr, flush=True)
    p2_rate, p2_base = run_p2_shape()
    print("# stage: ex11", file=sys.stderr, flush=True)
    ex11_wall, iters_per_s = run_ex11()
    out = {
        "device": {"platform": devs[0].platform,
                   "kind": devs[0].device_kind, "count": len(devs)},
        "metric": "scalarization_LPs_per_s_per_chip",
        "value": round(lps_per_s, 2),
        "unit": "LP/s",
        "vs_baseline": round(lps_per_s / base_rate, 3),
        "p2_LPs_per_s": round(p2_rate, 2),
        "p2_vs_baseline": round(p2_rate / p2_base, 3),
        "ex11_wall_s": round(ex11_wall, 3),
        "benson_iters_per_s": round(iters_per_s, 3),
        "cold_pivots_per_lp": round(cold_piv, 1),
        "warm_pivots_per_lp": (round(warm_piv, 1)
                               if warm_piv is not None else None),
    }
    print(json.dumps(out))
    print(f"# batch={B} size={M}x{N} optimal={n_opt}/{B} "
          f"compile={compile_s:.1f}s serial_highs={base_rate:.1f} LP/s "
          f"(ok {base_ok})", file=sys.stderr)


if __name__ == "__main__":
    main()
