"""Interior-point backend tests: objective/solution parity with serial
HiGHS, dual sign conventions interchangeable with the simplex backends
(simplex._final_solutions contract), bound-type coverage ('f','l','u',
'd','s' per bslv_lp.c:34-43), and status classification."""

import numpy as np
import pytest
from scipy.optimize import linprog

from bensolve_tpu.lp import simplex
from bensolve_tpu.lp.ipm import solve_batch_ipm


def random_lp(M, N, B, seed=0, eq_rows=0, fixed_cols=0, free_cols=0):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((M, N)) / np.sqrt(N)
    x0 = rng.random((B, N))
    b = x0 @ A.T + 0.5 + rng.random((B, M))
    c = rng.standard_normal((B, N))
    row_lb = np.full((B, M), -np.inf)
    row_ub = b.copy()
    col_lb = np.zeros((B, N))
    col_ub = np.full((B, N), 10.0)
    if eq_rows:
        # turn the first rows into equalities at a feasible activity
        act = x0 @ A.T
        row_lb[:, :eq_rows] = act[:, :eq_rows]
        row_ub[:, :eq_rows] = act[:, :eq_rows]
    if fixed_cols:
        col_lb[:, :fixed_cols] = 0.3
        col_ub[:, :fixed_cols] = 0.3
    if free_cols:
        col_lb[:, N - free_cols:] = -np.inf
        col_ub[:, N - free_cols:] = np.inf
    return A, c, row_lb, row_ub, col_lb, col_ub


def highs_solve(A, c, row_lb, row_ub, col_lb, col_ub, i):
    eq = row_lb[i] == row_ub[i]
    ub_rows = np.isfinite(row_ub[i]) & ~eq
    lb_rows = np.isfinite(row_lb[i]) & ~eq
    A_ub = np.concatenate([A[ub_rows], -A[lb_rows]])
    b_ub = np.concatenate([row_ub[i][ub_rows], -row_lb[i][lb_rows]])
    return linprog(c[i], A_ub=A_ub, b_ub=b_ub, A_eq=A[eq],
                   b_eq=row_ub[i][eq],
                   bounds=list(zip(col_lb[i], col_ub[i])), method="highs")


@pytest.mark.parametrize("eq_rows,fixed_cols,free_cols", [
    (0, 0, 0), (3, 0, 0), (0, 2, 0), (0, 0, 2), (2, 1, 1)])
def test_ipm_matches_highs(eq_rows, fixed_cols, free_cols):
    args = random_lp(24, 40, 4, seed=eq_rows * 7 + fixed_cols * 3
                     + free_cols, eq_rows=eq_rows, fixed_cols=fixed_cols,
                     free_cols=free_cols)
    res = solve_batch_ipm(*args, dtype=np.float64)
    for i in range(4):
        ref = highs_solve(*args, i)
        assert ref.status == 0
        assert res.status[i] == simplex.OPTIMAL
        assert res.obj[i] == pytest.approx(ref.fun, abs=1e-6, rel=1e-6)


def test_ipm_duals_match_simplex_convention():
    """row_dual/col_dual must be interchangeable with solve_batch's:
    col_dual = c - A' row_dual, and the duals of active rows agree."""
    args = random_lp(12, 20, 2, seed=5)
    A, c = args[0], args[1]
    res_i = solve_batch_ipm(*args, dtype=np.float64)
    res_s = simplex.solve_batch(*args, dtype=np.float64)
    for i in range(2):
        assert res_i.status[i] == simplex.OPTIMAL
        assert res_s.status[i] == simplex.OPTIMAL
        assert res_i.obj[i] == pytest.approx(res_s.obj[i], rel=1e-7,
                                             abs=1e-6)
        # stationarity under the shared convention
        np.testing.assert_allclose(
            res_i.col_dual[i], c[i] - A.T @ res_i.row_dual[i], atol=1e-6)
        np.testing.assert_allclose(
            res_i.row_dual[i], res_s.row_dual[i], atol=1e-5)


def test_ipm_float32():
    args = random_lp(32, 64, 4, seed=11)
    args32 = tuple(np.asarray(a, np.float32) for a in args)
    res = solve_batch_ipm(*args32, dtype=np.float32)
    for i in range(4):
        ref = highs_solve(*args, i)
        assert res.status[i] == simplex.OPTIMAL
        assert res.obj[i] == pytest.approx(ref.fun, abs=2e-3, rel=2e-3)


def test_ipm_infeasible():
    # x1 + x2 <= -1 with x >= 0 is infeasible
    A = np.array([[1.0, 1.0]])
    c = np.array([[1.0, 1.0]])
    res = solve_batch_ipm(A, c, np.array([[-np.inf]]), np.array([[-1.0]]),
                          np.zeros((1, 2)), np.full((1, 2), np.inf),
                          dtype=np.float64)
    assert res.status[0] in (simplex.INFEASIBLE, simplex.ITLIM)
    assert res.status[0] == simplex.INFEASIBLE


def test_ipm_unbounded():
    # min -x1, x1 - x2 <= 1, x >= 0: drive x1 -> inf along x1 = x2
    A = np.array([[1.0, -1.0]])
    c = np.array([[-1.0, 0.0]])
    res = solve_batch_ipm(A, c, np.array([[-np.inf]]), np.array([[1.0]]),
                          np.zeros((1, 2)), np.full((1, 2), np.inf),
                          dtype=np.float64)
    assert res.status[0] == simplex.UNBOUNDED


def test_ipm_crossed_bounds():
    A = np.array([[1.0, 1.0]])
    c = np.array([[1.0, 1.0]])
    res = solve_batch_ipm(A, c, np.array([[-np.inf]]), np.array([[4.0]]),
                          np.array([[2.0, 0.0]]), np.array([[1.0, 1.0]]),
                          dtype=np.float64)
    assert res.status[0] == simplex.INFEASIBLE


def test_ipm_e2e_driver_route(monkeypatch):
    """Force EVERY Benson LP through the IPM route (BENSOLVE_IPM_MIN=1)
    and require the same epsilon-solution as the simplex route on
    ex05/ex08/ex11 — the integration the round-3 default routing broke
    (wrong duals at scale corrupt cut construction silently)."""
    from bensolve_tpu.algs.driver import solve
    from bensolve_tpu.algs.solution import SolStatus
    from bensolve_tpu.vlp.options import Options
    from bensolve_tpu import examples

    for ex in ("ex05", "ex08", "ex11"):
        vlp = examples.load(ex)
        monkeypatch.delenv("BENSOLVE_IPM_MIN", raising=False)
        r_s = solve(vlp, Options(write_files=False))
        monkeypatch.setenv("BENSOLVE_IPM_MIN", "1")
        r_i = solve(vlp, Options(write_files=False))
        monkeypatch.delenv("BENSOLVE_IPM_MIN")
        assert r_i.status is SolStatus.OPTIMAL, ex
        got_s = sorted(map(tuple, np.round(r_s.primal_points, 5)))
        got_i = sorted(map(tuple, np.round(r_i.primal_points, 5)))
        assert got_s == got_i, (ex, got_s, got_i)


def test_ipm_e2e_status_examples(monkeypatch):
    """Status classification through the driver on the IPM route:
    infeasible / totally-unbounded examples must keep their reference
    verdicts (bslv_main.c:272-287) when the oracle is the IPM."""
    from bensolve_tpu.algs.driver import solve
    from bensolve_tpu.algs.solution import SolStatus
    from bensolve_tpu.vlp.options import Options
    from bensolve_tpu import examples

    monkeypatch.setenv("BENSOLVE_IPM_MIN", "1")
    assert solve(examples.load("ex02"),
                 Options(write_files=False)).status is SolStatus.INFEASIBLE
    assert solve(examples.load("ex04"),
                 Options(write_files=False)).status is SolStatus.UNBOUNDED


def test_ipm_p2_template_shape():
    """The Benson oracle's own LP shape (P2 template on a random VLP):
    primal/dual values feed cut construction, so the duals must agree
    with the tableau backend on the same batch."""
    from bensolve_tpu.algs.templates import INHOMOGENEOUS, P2Template
    from bensolve_tpu.examples import random_vlp

    vlp = random_vlp(q=3, m=12, n=10, seed=3)
    q = 3
    Z = np.eye(q)
    cdual = np.full(q, 1.0 / q)
    Z = Z / (Z.T @ cdual)[None, :]
    eta = np.full(q, 1.0 / q)
    t2 = P2Template(vlp, vlp.P.astype(float), Z, eta, INHOMOGENEOUS)
    rng = np.random.default_rng(0)
    V = rng.random((6, q)) * 2.0
    extra_ub = V @ t2.ZR
    obj, row_lb, row_ub, col_lb, col_ub = t2.build_inputs(extra_ub)
    res_s = simplex.solve_batch(t2.A_lp, obj, row_lb, row_ub, col_lb,
                                col_ub, dtype=np.float64)
    res_i = solve_batch_ipm(t2.A_lp, obj, row_lb, row_ub, col_lb, col_ub,
                            dtype=np.float64)
    ok = res_s.status == simplex.OPTIMAL
    assert ok.any()
    np.testing.assert_allclose(res_i.obj[ok], res_s.obj[ok], atol=1e-6)
    np.testing.assert_allclose(res_i.row_dual[ok], res_s.row_dual[ok],
                               atol=1e-4)


def test_ipm_warm_interior_start():
    """Carried-interior warm start (templates._run -> solve_batch_ipm
    warm_interior): a re-solve with slightly changed row bounds from
    the previous solution's interior point must converge to the same
    optimum, in no more iterations than a cold solve."""
    A, c, rlb, rub, clb, cub = random_lp(12, 18, 4, seed=21,
                                         free_cols=2)
    cold = solve_batch_ipm(A, c, rlb, rub, clb, cub, dtype=np.float64)
    assert (cold.status == simplex.OPTIMAL).all()
    rub2 = rub * 0.995
    cold2 = solve_batch_ipm(A, c, rlb, rub2, clb, cub, dtype=np.float64)
    wi = (cold.x[0], cold.s[0], cold.row_dual[0])
    warm2 = solve_batch_ipm(A, c, rlb, rub2, clb, cub, dtype=np.float64,
                            warm_interior=wi)
    assert (warm2.status == simplex.OPTIMAL).all()
    np.testing.assert_allclose(warm2.obj, cold2.obj, rtol=1e-6,
                               atol=1e-6)
    # warm must not be slower on the instance that supplied the point
    assert int(warm2.iters[0]) <= int(cold2.iters[0])


def test_host_highs_fallback_duals_match():
    """The terminal host fallback (sparse HiGHS) must return duals in
    solve_batch's sign convention (c = A' row_dual + col_dual), across
    two-sided rows, equalities, fixed and free columns."""
    from bensolve_tpu.lp import ipm

    A, c, rlb, rub, clb, cub = random_lp(14, 20, 3, seed=13, eq_rows=3,
                                         fixed_cols=2, free_cols=2)
    rlb = rlb.copy()
    rlb[:, 5:8] = rub[:, 5:8] - 2.0       # two-sided rows
    ref = simplex.solve_batch(A, c, rlb, rub, clb, cub)
    A_csr = ipm._sparse_A(A)
    for i in range(3):
        st, obj, x, s, rd, cd = ipm._host_highs_one(
            A_csr, c[i], rlb[i], rub[i], clb[i], cub[i])
        assert st == simplex.OPTIMAL
        assert obj == pytest.approx(ref.obj[i], abs=1e-8)
        stat = c[i] - rd @ A - cd
        assert np.abs(stat).max() < 1e-9
        np.testing.assert_allclose(rd, ref.row_dual[i], atol=1e-7)
