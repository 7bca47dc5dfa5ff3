"""Auxiliary-subsystem tests: determinism (the substitute for race
detection, SURVEY.md section 5), profiler tracing, stdout output."""

import glob

import numpy as np

from bensolve_tpu import examples
from bensolve_tpu.algs.driver import solve
from bensolve_tpu.vlp.options import Options


def test_deterministic_across_runs():
    vlp = examples.load("ex05")
    r1 = solve(vlp, Options())
    r2 = solve(vlp, Options())
    # bit-identical vertex sets, not just epsilon-close
    np.testing.assert_array_equal(r1.primal_points, r2.primal_points)
    np.testing.assert_array_equal(r1.dual_points, r2.dual_points)
    np.testing.assert_array_equal(r1.primal_directions,
                                  r2.primal_directions)
    assert r1.stats.lps == r2.stats.lps


def test_profile_trace(tmp_path):
    vlp = examples.load("ex01")
    r = solve(vlp, Options(profile_dir=str(tmp_path)))
    assert r.status.name == "OPTIMAL"
    assert glob.glob(str(tmp_path / "**" / "*.trace*"), recursive=True) or \
        glob.glob(str(tmp_path / "**" / "*.pb"), recursive=True) or \
        list(tmp_path.iterdir())


def test_message_levels(capsys):
    """-m 3 prints per-LP/per-cut progress lines (bslv_algs.c:877,888)
    plus per-round summaries; -M 2 makes the LP layer emit batch
    summaries (the lp_message_level analogue, bslv_lp.c:200-215)."""
    vlp = examples.load("ex01")
    solve(vlp, Options(message_level=3, lp_message_level=2))
    out = capsys.readouterr().out
    assert "process primal vertex - solve lp" in out
    assert "add dual vertex" in out
    assert "round" in out and "LPs" in out
    assert "lp_solve: batch=" in out

    # default levels stay quiet
    solve(vlp, Options())
    assert "lp_solve" not in capsys.readouterr().out


def test_stdout_listing(capsys, ex_dir):
    from bensolve_tpu.algs.driver import solve_file
    import tempfile, os
    with tempfile.TemporaryDirectory() as d:
        solve_file(f"{ex_dir}/ex01.vlp",
                   Options(filename=os.path.join(d, "x"), message_level=1))
    out = capsys.readouterr().out
    assert "Upper image of primal problem:" in out
    assert "Lower image of dual problem:" in out


def test_distributed_mode_single_process():
    """distributed=True on one process: shard == whole frontier, cuts
    applied in canonical order; deterministic and epsilon-correct."""
    from tests.test_e2e import check_support

    vlp = examples.load("ex05")
    r1 = solve(vlp, Options(distributed=True))
    r2 = solve(vlp, Options(distributed=True))
    assert r1.status.name == "OPTIMAL"
    np.testing.assert_array_equal(r1.primal_points, r2.primal_points)
    check_support(r1, n_samples=24)


def test_canonical_order_is_order_invariant():
    from bensolve_tpu.parallel.distributed import canonical_order

    rng = np.random.default_rng(3)
    cuts = rng.standard_normal((20, 4))
    perm = rng.permutation(20)
    o1 = canonical_order(cuts)
    o2 = canonical_order(cuts[perm])
    np.testing.assert_allclose(cuts[o1], cuts[perm][o2])
