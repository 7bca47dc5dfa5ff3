"""End-to-end acceptance tests on the reference example suite
(generated by bensolve_tpu.examples; the behavior matrix of SURVEY.md
section 4).

Correctness oracle: support-function equality against scipy/HiGHS
(bensolve_tpu.oracle.check_support).
"""

import numpy as np
import pytest

from bensolve_tpu import examples
from bensolve_tpu.algs.driver import solve
from bensolve_tpu.algs.solution import SolStatus
from bensolve_tpu.oracle import check_support
from bensolve_tpu.vlp.options import Alg, Options
from bensolve_tpu.vlp.problem import VLPProblem


def run(ex, **opt_kw):
    return solve(examples.load(ex), Options(**opt_kw))


def test_ex01_exact():
    r = run("ex01")
    assert r.status is SolStatus.OPTIMAL
    got = sorted(map(tuple, np.round(r.primal_points, 9)))
    assert got == [(-6.0, 6.0), (0.0, 4.0)]
    dirs = sorted(map(tuple, np.round(r.primal_directions, 9)))
    assert dirs == [(-1.0, 1.0), (1.0, 0.0)]
    duals = sorted(map(tuple, np.round(r.dual_points, 9)))
    assert duals == [(0.0, 4.0), (0.25, 3.0), (0.5, 0.0)]
    check_support(r)


def test_ex02_infeasible():
    assert run("ex02").status is SolStatus.INFEASIBLE


def test_ex03_novertex():
    assert run("ex03").status is SolStatus.NOVERTEX


def test_ex04_totally_unbounded():
    assert run("ex04").status is SolStatus.UNBOUNDED


def test_ex05_cone_q3():
    r = run("ex05")
    assert r.status is SolStatus.OPTIMAL
    check_support(r)


def test_ex06_max_dualcone():
    r = run("ex06")
    assert r.status is SolStatus.OPTIMAL
    # max problem: the primal image is written as a "lower image";
    # support check runs on the canonical min form
    check_support(r)


def test_ex08_unbounded_with_directions():
    r = run("ex08")
    assert r.status is SolStatus.OPTIMAL
    assert r.sol.pp >= 1 and r.sol.pp_dir >= 1
    check_support(r)


@pytest.mark.slow
def test_ex11_q5_phase1_stress():
    r = run("ex11")
    assert r.status is SolStatus.OPTIMAL
    # known structure: recession cone of the upper image has 22 extreme
    # directions (ex/example11.m:1-2)
    assert r.sol.pp_dir == 22
    check_support(r, n_samples=16)


def assert_point_sets_match(a, b, tol=1e-6):
    """Unordered vertex-set equality within tol: every point of each
    set has a counterpart in the other (the golden-test comparison rule
    of SURVEY.md section 7.4 — batched rounds may enumerate vertices in
    a different order than the serial reference)."""
    a, b = np.atleast_2d(a), np.atleast_2d(b)
    assert a.shape[0] == b.shape[0], (a, b)
    if a.shape[0] == 0:
        return
    d = np.abs(a[:, None, :] - b[None, :, :]).max(axis=2)
    assert (d.min(axis=1) <= tol).all(), (a, b)
    assert (d.min(axis=0) <= tol).all(), (a, b)


def _norm_dirs(d):
    d = np.atleast_2d(d)
    if d.size == 0:
        return d
    return d / np.abs(d).max(axis=1, keepdims=True)


def test_dual_algorithm_matches_primal():
    r_p = run("ex01")
    r_d = run("ex01", alg_phase1=Alg.DUAL, alg_phase2=Alg.DUAL)
    assert r_d.status is SolStatus.OPTIMAL
    got_p = sorted(map(tuple, np.round(r_p.primal_points, 6)))
    got_d = sorted(map(tuple, np.round(r_d.primal_points, 6)))
    assert got_p == got_d
    check_support(r_d)


@pytest.mark.parametrize("ex", ["ex05", "ex06", "ex08"])
def test_dual_algorithm_cross_check(ex):
    """Primal and dual Benson must produce the same epsilon-solution on
    the cone / max / unbounded-with-directions examples — the reference
    treats -A dual -a dual as a first-class alternative
    (bslv_algs.c:1248-1592); round-3 verified the equivalence only on
    ex01 (VERDICT r3 missing #4)."""
    r_p = run(ex)
    r_d = run(ex, alg_phase1=Alg.DUAL, alg_phase2=Alg.DUAL)
    assert r_p.status is SolStatus.OPTIMAL
    assert r_d.status is SolStatus.OPTIMAL
    assert_point_sets_match(r_p.primal_points, r_d.primal_points)
    assert_point_sets_match(_norm_dirs(r_p.primal_directions),
                            _norm_dirs(r_d.primal_directions))
    assert_point_sets_match(r_p.dual_points, r_d.dual_points)
    check_support(r_d)


def test_per_candidate_warm_starts_cut_pivots():
    """warm_mode=per_candidate must (a) keep results identical and
    (b) spend fewer total simplex pivots than shared-basis warm starts
    (VERDICT r1 item 6; the reference's implicit warm-start strategy,
    bslv_lp.c:31)."""
    r_shared = run("ex05", warm_mode="shared")
    r_pc = run("ex05", warm_mode="per_candidate")
    assert r_pc.status is SolStatus.OPTIMAL
    got_s = sorted(map(tuple, np.round(r_shared.primal_points, 6)))
    got_p = sorted(map(tuple, np.round(r_pc.primal_points, 6)))
    assert got_s == got_p
    assert r_pc.stats.pivots < r_shared.stats.pivots, \
        (r_pc.stats, r_shared.stats)


def test_dual_warm_resolve_cuts_pivots(monkeypatch):
    """P2 re-solves change only row bounds, so the production route
    warm-starts the DUAL simplex from the parent basis
    (templates._use_dual_warm; the batched form of the reference's
    carried-basis strategy, bslv_lp.c:31).  It must keep results
    identical and strictly reduce total pivots vs the primal-warm path
    (VERDICT r3 weak #3 / next #4)."""
    monkeypatch.setenv("BENSOLVE_NO_DUAL_WARM", "1")
    r_old = run("ex11")
    monkeypatch.delenv("BENSOLVE_NO_DUAL_WARM")
    r_new = run("ex11")
    assert r_new.status is SolStatus.OPTIMAL
    got_o = sorted(map(tuple, np.round(r_old.primal_points, 6)))
    got_n = sorted(map(tuple, np.round(r_new.primal_points, 6)))
    assert got_o == got_n
    assert r_new.stats.pivots < r_old.stats.pivots, \
        (r_new.stats, r_old.stats)


def test_bounded_shortcut():
    # ex01 restricted to a box is bounded; -b skips phases 0 and 1
    vlp = examples.load("ex01")
    vlp.cols.ub[:] = 50.0
    vlp.cols.types[:] = "d"
    r = solve(vlp, Options(bounded=True))
    assert r.status is SolStatus.OPTIMAL
    pts = sorted(map(tuple, np.round(r.primal_points, 6)))
    assert (-6.0, 6.0) in pts and (0.0, 4.0) in pts


def test_preimages_ex01():
    r = run("ex01", solution=True)
    assert r.status is SolStatus.OPTIMAL
    P = r.pair.primal
    vlp = r.vlp
    for i in P.live():
        if P.ideal[i]:
            continue
        x = P.primg[i, : vlp.n]
        y = vlp.P @ x
        assert np.allclose(y, P.data[i], atol=1e-6), (y, P.data[i])
        s = vlp.A @ x
        assert np.all(s >= vlp.rows.lb - 1e-7)
        assert np.all(x >= vlp.cols.lb - 1e-9)


def test_from_arrays_api():
    # the prob2vlp.m-style front end builds the same problem as ex01.vlp
    prob = VLPProblem.from_arrays(
        P=[[1, -1], [1, 1]],
        A=[[2, 1], [1, 2]],
        a=[6, 6],
        l=[0, 0],
    )
    r = solve(prob)
    assert r.status is SolStatus.OPTIMAL
    got = sorted(map(tuple, np.round(r.primal_points, 9)))
    assert got == [(-6.0, 6.0), (0.0, 4.0)]


def test_poly_test_option():
    r = run("ex05", poly_test=True)
    assert r.status is SolStatus.OPTIMAL
    assert r.message == ""  # no invariant violations


def test_plot_output(tmp_path, ex_dir):
    from bensolve_tpu.algs.driver import solve_file
    base = str(tmp_path / "ex05")
    r = solve_file(f"{ex_dir}/ex05.vlp", Options(plot=True, filename=base))
    assert r.status is SolStatus.OPTIMAL
    off = open(base + "_p.off").read().splitlines()
    assert off[0] == "OFF"
    nv, nf, _ = map(int, off[1].split())
    assert nv > 3 and nf >= 4
    # every facet line references valid vertex ids and forms a ring
    facet_lines = [l for l in off if "\t" in l]
    assert len(facet_lines) == nf
    for line in facet_lines:
        cnt, ids = line.split("\t")
        ids = [int(t) for t in ids.split()]
        assert len(ids) == int(cnt) and all(0 <= i < nv for i in ids)
    assert "INST" in open(base + "_p.inst").read()
    assert (tmp_path / "ex05_d.off").exists()
    # dual algorithm produces the role-swapped plots too
    base2 = str(tmp_path / "ex05b")
    r2 = solve_file(f"{ex_dir}/ex05.vlp",
                    Options(plot=True, filename=base2,
                            alg_phase1=Alg.DUAL, alg_phase2=Alg.DUAL))
    assert r2.status is SolStatus.OPTIMAL
    assert (tmp_path / "ex05b_p.off").exists()
    assert (tmp_path / "ex05b_d.off").exists()
