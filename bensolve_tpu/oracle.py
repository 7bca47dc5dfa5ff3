"""Independent correctness oracles: scipy/HiGHS on the host.

``check_support`` is the support-function oracle of the Benson solve.
For the canonical min problem, the upper image U = P[feasible] + C has
support value h(w) = min_x w'P_eff x for every w in C*.  The solver's
epsilon-solution (points V, directions D) must satisfy
min_{y in V} w'y == h(w) within epsilon for sampled w in the interior of
C*, and every direction must have nonnegative support against such w.

``highs_lp`` solves one LP of the batched backends' contract
(row_lb <= A x <= row_ub, col_lb <= x <= col_ub) with HiGHS.
"""

import numpy as np
from scipy.optimize import linprog


def scalarized_min(vlp, P_eff, w):
    """min w'P_eff x over the VLP feasible set, via scipy (HiGHS)."""
    m, n = vlp.A.shape
    A_ub, b_ub, A_eq, b_eq = [], [], [], []
    for i in range(m):
        lo, hi = vlp.rows.lb[i], vlp.rows.ub[i]
        if np.isfinite(lo) and lo == hi:
            A_eq.append(vlp.A[i]); b_eq.append(lo)
        else:
            if np.isfinite(hi):
                A_ub.append(vlp.A[i]); b_ub.append(hi)
            if np.isfinite(lo):
                A_ub.append(-vlp.A[i]); b_ub.append(-lo)
    kw = {}
    if A_ub:
        kw["A_ub"], kw["b_ub"] = np.array(A_ub), np.array(b_ub)
    if A_eq:
        kw["A_eq"], kw["b_eq"] = np.array(A_eq), np.array(b_eq)
    res = linprog(w @ P_eff, bounds=list(zip(vlp.cols.lb, vlp.cols.ub)),
                  method="highs", **kw)
    if res.status == 3:
        return -np.inf
    assert res.status == 0, res.message
    return res.fun


def canonical_P(vlp, sol):
    """P of the canonical min/c_q>0 problem (sign flips of
    bslv_vlp.c:856-861)."""
    flip = (sol.c_dir.value < 0) == (vlp.optdir == 1)
    return (-vlp.P if flip else vlp.P).astype(float)


def canonical_points(result):
    """Solution points/directions mapped back to canonical min form
    (undo poly_trans_primal/dual output transforms)."""
    vlp, sol = result.vlp, result.sol
    pts = result.primal_points.copy()
    dirs = result.primal_directions.copy()
    pos = sol.c_dir.value > 0
    if pos and vlp.optdir == -1 or (not pos and vlp.optdir == 1):
        pts, dirs = -pts, -dirs
    return pts, dirs


def check_support(result, n_samples=64, tol=1e-7):
    """Support-function oracle.  Default tol matches the reference's
    Benson epsilon contract EPS_BENSON = 1e-7 (bslv_main.h:74-78) for
    the float64 default path; float32 / loose-eps call sites pass an
    explicit looser tol."""
    vlp, sol = result.vlp, result.sol
    P_eff = canonical_P(vlp, sol)
    pts, dirs = canonical_points(result)
    assert pts.shape[0] > 0
    rng = np.random.default_rng(0)
    q = vlp.q
    for _ in range(n_samples):
        lam = rng.random(sol.p) + 1e-3
        w = sol.Z @ lam
        w = w / np.abs(w).sum()
        h_true = scalarized_min(vlp, P_eff, w)
        h_hat = float(np.min(pts @ w))
        scale = 1 + abs(h_true) if np.isfinite(h_true) else 1.0
        if dirs.size and np.min(dirs @ w) < -1e-9:
            h_hat = -np.inf  # unbounded along a computed direction
        if not np.isfinite(h_true):
            assert not np.isfinite(h_hat), (w, h_hat)
        else:
            assert abs(h_hat - h_true) <= tol * scale, (w, h_hat, h_true)


def highs_lp(A, ci, rlb, rub, clb, cub):
    """One serial HiGHS solve handling the full bound-type range: split
    rows by pattern (equality / <= / >= / free), dropping free rows —
    the P2 template's inhomogeneous eta row has lb=-inf, ub=+inf, and
    linprog rejects non-finite b_ub."""
    A = np.float64(A)
    rlb, rub = np.float64(rlb), np.float64(rub)
    eq = np.isfinite(rlb) & np.isfinite(rub) & (rlb == rub)
    ub_rows = np.isfinite(rub) & ~eq
    lb_rows = np.isfinite(rlb) & ~eq
    A_ub = np.concatenate([A[ub_rows], -A[lb_rows]])
    b_ub = np.concatenate([rub[ub_rows], -rlb[lb_rows]])
    return linprog(np.float64(ci),
                   A_ub=A_ub if A_ub.size else None,
                   b_ub=b_ub if b_ub.size else None,
                   A_eq=A[eq] if eq.any() else None,
                   b_eq=rub[eq] if eq.any() else None,
                   bounds=list(zip(np.float64(clb), np.float64(cub))),
                   method="highs")
