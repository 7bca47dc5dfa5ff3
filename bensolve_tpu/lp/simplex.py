"""Batched dense bounded-variable primal simplex.

This is the batched device replacement for the reference's single
warm-started GLPK instance (bslv_lp.c:31, lp_solve bslv_lp.c:219-259).
Where the reference re-parameterizes ONE LP and solves candidates
serially (bslv_algs.c:863-895), this solver takes a *batch* of LPs that
share the constraint matrix but differ in objective and bounds, and
pivots all of them in lockstep on device.

Formulation (GLPK-compatible, bslv_lp.h:60-105):

    variables   z = (s, x),  s in R^M auxiliary (rows), x in R^N structural
    equalities  E z = 0  with  E = [I | -A]          (s = A x)
    bounds      lb <= z <= ub   (+-inf allowed, lb == ub means fixed)
    objective   min c' z        (c zero on auxiliaries in practice)

All five GLPK bound types 'f','l','u','d','s' (bslv_lp.c:34-43) are
plain (lb, ub) data here, so row/column type changes are batch data, not
structure.

Algorithm: bounded-variable primal *tableau* simplex:

  * state is the full tableau W = Binv @ E of shape (B, M, NT); one
    pivot is a rank-1 update W -= alpha (x) w_r/alpha_r — pure fused
    elementwise FMA, no factorizations, no O(M^3) work in the loop.
    The basis inverse is never materialized separately: since
    E = [I | -A], Binv IS the first M columns of W, so duals come free;
  * composite phase-1 (costs +-1 on out-of-bounds basic variables, no
    artificial variables);
  * Dantzig pricing with Bland's rule after a degeneracy stall;
  * basis bound/cost arrays (lbB/ubB/cB) maintained incrementally (one
    scatter per pivot) instead of per-iteration gathers;
  * one accurate re-solve at termination: the basis system is
    refactorized once (batched LU) to deliver primal and dual solutions
    at factorization accuracy regardless of rank-1 drift.

Statuses mirror lp_status_type (bslv_lp.h:44).  Exact basic primal AND
dual solutions are returned (duals in GLPK sign convention: row dual
lambda_i >= 0 for a binding lower row bound of a min problem).
"""

from __future__ import annotations

import collections
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from bensolve_tpu.lp import linalg

# status codes
RUNNING = 0
OPTIMAL = 1
INFEASIBLE = 2
UNBOUNDED = 3
ITLIM = 4
DUAL_LOST = 5  # dual simplex lost dual feasibility: retry with primal
#   (the batched analogue of GLPK's GLP_DUALP dual->primal fallback,
#   bslv_lp.c:190-192 + lp_solve retry, bslv_lp.c:219-227)

BLAND_AFTER = 64  # consecutive degenerate steps before switching to Bland


def _tols(dtype):
    """(feasibility, reduced-cost, pivot) tolerances per dtype.  float64
    matches GLPK-era 1e-9; float32 is looser.
    The f32 pivot tolerance is deliberately coarse: a pivot of size p
    amplifies basis-inverse error by ~1/p, and with ~7 significant
    digits a 1e-6 pivot destroys the factorization in one step."""
    if jnp.dtype(dtype) == jnp.dtype(jnp.float32):
        return 1e-5, 1e-5, 1e-4
    return 1e-9, 1e-9, 1e-11


@dataclasses.dataclass
class LPResult:
    """Mirror of the GLPK getters used by the reference
    (bslv_lp.c:261-308)."""

    status: np.ndarray    # (B,) int
    obj: np.ndarray       # (B,) objective value c'x
    x: np.ndarray         # (B, N) structural primal values
    s: np.ndarray         # (B, M) row activities (auxiliary primals)
    row_dual: np.ndarray  # (B, M) row duals, GLPK sign
    col_dual: np.ndarray  # (B, N) reduced costs of structural variables
    iters: np.ndarray     # (B,) pivot count
    basis: np.ndarray | None = None  # (B, M) final basis (warm-start seed)
    at_upper: np.ndarray | None = None  # (B, M+N) nonbasic bound pattern
    quality: np.ndarray | None = None  # (B,) int solution quality:
    #   0 = clean (KKT residuals at the backend's own tolerance),
    #   1 = salvaged (accepted at <=100x the dtype tolerance),
    #   2 = loose (accepted at <=250x — budget-exhausted f32 IPM).
    #   None (the simplex family) means clean: exact basic solutions.
    #   Callers running at a tight epsilon can re-verify/defer quality>0
    #   instances (the Benson loop defers quality==2, algs/phases.py).


def concat_results(parts: list) -> "LPResult":
    """Concatenate chunked LPResults field-wise; a field that is None in
    any part (basis/at_upper/quality are backend-dependent) stays None."""
    vals = []
    for f in dataclasses.fields(LPResult):
        cols = [getattr(p, f.name) for p in parts]
        vals.append(None if any(v is None for v in cols)
                    else np.concatenate(cols))
    return LPResult(*vals)


def _nb_value(lb, ub, at_upper):
    """Value of a nonbasic variable resting at its active bound."""
    lo = jnp.where(jnp.isfinite(lb), lb, jnp.where(jnp.isfinite(ub), ub, 0.0))
    hi = jnp.where(jnp.isfinite(ub), ub, jnp.where(jnp.isfinite(lb), lb, 0.0))
    return jnp.where(at_upper, hi, lo)


def _e_matmul(A, v):
    """E @ v for E = [I | -A]; v has shape (..., M+N).  ``A`` may be
    (M, N) shared or (B, M, N) per-instance (scenario batches)."""
    M = A.shape[-2]
    if A.ndim == 3:
        return v[..., :M] - jnp.einsum("bn,bmn->bm", v[..., M:], A)
    return v[..., :M] - v[..., M:] @ A.T


def _e_rmatmul(A, y):
    """E^T @ y; y has shape (..., M)."""
    if A.ndim == 3:
        return jnp.concatenate([y, -jnp.einsum("bm,bmn->bn", y, A)],
                               axis=-1)
    return jnp.concatenate([y, -(y @ A)], axis=-1)


def _build_basis_matrix(A, basis, AT=None):
    """B matrix (M, M) whose columns are E[:, basis[k]] (A is (M, N)).

    Structural columns are gathered as ROWS of A^T: a column gather of
    the row-major A is along the minor dimension, which a gather
    expander may rewrite into a one-hot dot_general whose one-hot
    operand is (M, N) floats (gigabytes at m=4608, n=36939).  A row
    gather of A^T is a contiguous gather; the final transpose of the
    (M, M) result is cheap."""
    M, N = A.shape
    if AT is None:
        AT = A.T
    is_aux = basis < M
    eye_rows = jax.nn.one_hot(basis, M, dtype=A.dtype)             # (M, M)
    a_rows = -jnp.take(AT, jnp.clip(basis - M, 0, N - 1), axis=0)  # (M, M)
    return jnp.where(is_aux[:, None], eye_rows, a_rows).T


def _batched_basis_matrices(A, bases):
    """(B, M, M) basis matrices for (B, M) bases; shared or 3-D A."""
    if A.ndim == 3:
        return jax.vmap(_build_basis_matrix)(A, bases)
    AT = A.T  # transpose once; shared across the vmapped gather
    return jax.vmap(lambda b: _build_basis_matrix(A, b, AT))(bases)


@dataclasses.dataclass
class _State:
    basis: jnp.ndarray      # (B, M) int32 variable index per basis slot
    in_basis: jnp.ndarray   # (B, NT) bool
    at_upper: jnp.ndarray   # (B, NT) bool (meaningful for nonbasic)
    W: jnp.ndarray          # (B, M, NT) tableau Binv @ E
    xb: jnp.ndarray         # (B, M) basic variable values
    lbB: jnp.ndarray        # (B, M) bounds of basic variables
    ubB: jnp.ndarray        # (B, M)
    cB: jnp.ndarray         # (B, M) true costs of basic variables
    status: jnp.ndarray     # (B,) int32
    stall: jnp.ndarray      # (B,) int32 consecutive degenerate steps
    iters: jnp.ndarray      # (B,) int32
    step: jnp.ndarray       # () int32 global step counter
    gamma: jnp.ndarray | None = None  # (B, NT) devex reference weights


jax.tree_util.register_dataclass(
    _State,
    data_fields=["basis", "in_basis", "at_upper", "W", "xb", "lbB", "ubB",
                 "cB", "status", "stall", "iters", "step", "gamma"],
    meta_fields=[],
)


def _devex_entering(d, eligible, gamma, use_bland, NT, dtype):
    """Entering-variable choice: devex scores d^2/gamma (fewer, better
    pivots than Dantzig for the same per-iteration cost), Bland's rule
    after a degeneracy stall."""
    devex_score = jnp.where(eligible, d * d / gamma, -jnp.inf)
    bland_score = jnp.where(eligible, -jnp.arange(NT, dtype=dtype),
                            -jnp.inf)
    score = jnp.where(use_bland[:, None], bland_score, devex_score)
    return jnp.argmax(score, axis=1)


def _devex_update(gamma, w_r_scaled, alpha_r, q_idx, leaving, do_pivot,
                  lane=None):
    """Forrest-Goldfarb reference-weight update after a pivot."""
    B, NT = gamma.shape
    batch = jnp.arange(B)
    gamma_q = jnp.take_along_axis(gamma, q_idx[:, None], axis=1)
    g_upd = jnp.maximum(gamma, w_r_scaled * w_r_scaled * gamma_q)
    g_leave = jnp.maximum(gamma_q[:, 0] / (alpha_r * alpha_r), 1.0)
    g_upd = g_upd.at[batch, leaving].set(g_leave)
    g_new = jnp.where(do_pivot[:, None], g_upd, gamma)
    return jnp.where(g_new > 1e8, 1.0, g_new)


def _initial_state(A, c, lb, ub, basis0=None, at_upper0=None,
                   ssharding=None):
    """Initial tableau state.  With ``basis0`` (a shared (M,) basis, e.g.
    the optimal basis of a previous Benson round's LP) the whole batch
    warm-starts from one factorization: W0 = Binv @ E is identical
    across the batch and costs a single (M, M) LU — the batched
    analogue of GLPK's warm start from the previous solve
    (bslv_lp.c:219-227).  ``at_upper0`` additionally carries the
    previous solution's nonbasic bound pattern; without it, every
    nonbasic variable whose optimal rest bound differs from the default
    guess costs one bound-flip iteration (box-constrained problems pay
    hundreds)."""
    B, NT = c.shape
    M, N = A.shape[-2:]
    dtype = c.dtype
    if A.ndim == 3:
        E = jnp.concatenate(
            [jnp.broadcast_to(jnp.eye(M, dtype=dtype)[None], (B, M, M)),
             -A], axis=2)                                         # (B, M, NT)
    else:
        E = jnp.concatenate([jnp.eye(M, dtype=dtype), -A], axis=1)
    if basis0 is not None and jnp.asarray(basis0).ndim == 1 and A.ndim == 3:
        # a shared warm basis over per-instance matrices is still a
        # per-instance factorization
        basis0 = jnp.broadcast_to(
            jnp.asarray(basis0, jnp.int32)[None, :], (B, M))
    if basis0 is None:
        basis = jnp.tile(jnp.arange(M, dtype=jnp.int32)[None, :], (B, 1))
        in_basis1 = jnp.concatenate([jnp.ones(M, bool), jnp.zeros(N, bool)])
        in_basis = jnp.broadcast_to(in_basis1[None, :], (B, NT))
        if A.ndim == 3:
            W = E
        else:
            W = jnp.broadcast_to(E[None], (B, M, NT)) + jnp.zeros(
                (B, 1, 1), dtype)
    elif jnp.asarray(basis0).ndim == 2:
        # per-instance warm start (e.g. each frontier candidate descends
        # from the basis of the LP that generated it): batched LU
        basis = jnp.asarray(basis0, jnp.int32)
        in_basis = jax.vmap(
            lambda b: jnp.zeros(NT, bool).at[b].set(True))(basis)
        Bmat = _batched_basis_matrices(A, basis)
        lu, piv = jax.vmap(linalg.lu_factor)(Bmat)
        if A.ndim == 3:
            W = jax.vmap(lambda f, p, e: linalg.lu_solve((f, p), e))(
                lu, piv, E)
        else:
            W = jax.vmap(lambda f, p: linalg.lu_solve((f, p), E))(lu, piv)
    else:
        basis0 = jnp.asarray(basis0, jnp.int32)
        basis = jnp.broadcast_to(basis0[None, :], (B, M))
        in_basis1 = jnp.zeros(NT, bool).at[basis0].set(True)
        in_basis = jnp.broadcast_to(in_basis1[None, :], (B, NT))
        Bmat = _build_basis_matrix(A, basis0)
        lu, piv = linalg.lu_factor(Bmat)
        W0 = linalg.lu_solve((lu, piv), E)
        W = jnp.broadcast_to(W0[None], (B, M, NT)) + jnp.zeros((B, 1, 1),
                                                               dtype)
    if at_upper0 is None:
        at_upper = (~jnp.isfinite(lb)) & jnp.isfinite(ub) & ~in_basis
    else:
        at_upper0 = jnp.asarray(at_upper0, bool)
        if at_upper0.ndim == 1:
            at_upper0 = at_upper0[None, :]
        at_upper = jnp.broadcast_to(at_upper0, (B, NT))
        # only meaningful where resting at ub is actually possible
        at_upper = at_upper & jnp.isfinite(ub) & ~in_basis
        # a nonbasic with only an upper bound must rest there
        at_upper = at_upper | ((~jnp.isfinite(lb)) & jnp.isfinite(ub)
                               & ~in_basis)
    if ssharding is not None:
        # pin the (B, M, NT) tableau's sharding so the while-loop carry
        # stays distributed over the mesh (dp on batch, tp on columns)
        W = jax.lax.with_sharding_constraint(W, ssharding)
    zn = jnp.where(in_basis, 0.0, _nb_value(lb, ub, at_upper))
    # xb solves B xb = -E zn;  xb = -W @ zn
    xb = -jnp.einsum("bmn,bn->bm", W, zn)
    zeros = jnp.zeros(B, jnp.int32)
    lbB = jnp.take_along_axis(lb, basis, axis=1)
    ubB = jnp.take_along_axis(ub, basis, axis=1)
    cB = jnp.take_along_axis(c, basis, axis=1)
    # crossed bounds (lb > ub) make an instance trivially infeasible, and
    # the phase-1 machinery cannot see them on NONBASIC variables (a
    # variable resting at lb quietly violates ub); reject upfront
    crossed = jnp.any(lb > ub, axis=1)
    status = jnp.where(crossed, INFEASIBLE, zeros)
    return _State(basis, in_basis, at_upper, W, xb,
                  lbB, ubB, cB,
                  status, zeros, zeros, jnp.int32(0),
                  jnp.ones((B, NT), dtype))


def _step(A, c, lb, ub, st: _State) -> _State:
    TOL_BND, TOL_DJ, TOL_PIV = _tols(c.dtype)
    B, NT = c.shape
    M, N = A.shape[-2:]
    batch = jnp.arange(B)
    running = st.status == RUNNING

    viol_lo = st.xb < st.lbB - TOL_BND
    viol_up = st.xb > st.ubB + TOL_BND
    feasible = ~jnp.any(viol_lo | viol_up, axis=1)                 # (B,)

    # effective costs: true costs in phase 2, +-1 on violating basics in ph.1
    cB1 = jnp.where(viol_up, 1.0, 0.0) + jnp.where(viol_lo, -1.0, 0.0)
    cB_eff = jnp.where(feasible[:, None], st.cB, cB1).astype(c.dtype)

    # reduced costs d = c_eff - cB_eff @ W (duals y never materialized)
    d = jnp.where(feasible[:, None], c, 0.0) - jnp.einsum(
        "bm,bmn->bn", cB_eff, st.W)

    # entering variable
    val = _nb_value(lb, ub, st.at_upper)
    can_inc = (~st.in_basis) & (val < ub)
    can_dec = (~st.in_basis) & (val > lb)
    elig_inc = can_inc & (d < -TOL_DJ)
    elig_dec = can_dec & (d > TOL_DJ)
    eligible = elig_inc | elig_dec
    use_bland = st.stall > BLAND_AFTER
    q_idx = _devex_entering(d, eligible, st.gamma, use_bland, NT, c.dtype)
    has_entering = jnp.any(eligible, axis=1)

    # finished instances: optimal if feasible, else proven infeasible
    finish_status = jnp.where(feasible, OPTIMAL, INFEASIBLE)
    new_status = jnp.where(running & ~has_entering, finish_status, st.status)
    act = running & has_entering                                   # will pivot

    sigma = jnp.where(
        jnp.take_along_axis(elig_inc, q_idx[:, None], axis=1)[:, 0], 1.0, -1.0
    ).astype(c.dtype)

    # pivot column alpha = Binv E_q = W[:, :, q]
    alpha = jnp.take_along_axis(
        st.W, q_idx[:, None, None], axis=2)[:, :, 0]               # (B, M)
    rate = -sigma[:, None] * alpha                                 # dxB/dt

    # ratio test (composite phase-1 aware, short-step rule)
    inc = rate > TOL_PIV
    dec = rate < -TOL_PIV
    target_inc = jnp.where(viol_lo, st.lbB, st.ubB)
    target_dec = jnp.where(viol_up, st.ubB, st.lbB)
    t_inc = jnp.where(viol_up, jnp.inf, (target_inc - st.xb) / rate)
    t_dec = jnp.where(viol_lo, jnp.inf, (target_dec - st.xb) / rate)
    t = jnp.where(inc, t_inc, jnp.where(dec, t_dec, jnp.inf))
    t = jnp.maximum(t, 0.0)
    t = jnp.where(jnp.isnan(t), jnp.inf, t)

    tmin = jnp.min(t, axis=1)                                      # (B,)
    # leaving among near-minimal ratios: largest |pivot| (stability), or
    # smallest variable index under Bland
    cand = t <= tmin[:, None] + 1e-12
    stab_score = jnp.where(cand, jnp.abs(rate), -1.0)
    basis_f = st.basis.astype(c.dtype)
    bland_leave = jnp.where(cand, -basis_f, -jnp.inf)
    leave_score = jnp.where(use_bland[:, None], bland_leave, stab_score)
    r_idx = jnp.argmax(leave_score, axis=1)                        # (B,)

    # entering variable's own opposite bound (bound flip)
    lb_q = jnp.take_along_axis(lb, q_idx[:, None], axis=1)[:, 0]
    ub_q = jnp.take_along_axis(ub, q_idx[:, None], axis=1)[:, 0]
    span = ub_q - lb_q
    span = jnp.where(jnp.isfinite(span), span, jnp.inf)
    do_flip = span < tmin
    t_star = jnp.where(do_flip, span, tmin)

    unbounded = act & feasible & ~jnp.isfinite(t_star)
    new_status = jnp.where(unbounded, UNBOUNDED, new_status)
    act = act & jnp.isfinite(t_star)

    # apply the step
    delta = jnp.where(act, sigma * t_star, 0.0)                    # (B,)
    xb_new = st.xb - delta[:, None] * alpha

    do_pivot = act & ~do_flip
    alpha_r = jnp.take_along_axis(alpha, r_idx[:, None], axis=1)[:, 0]
    alpha_r = jnp.where(jnp.abs(alpha_r) < TOL_PIV,
                        jnp.where(alpha_r < 0, -TOL_PIV, TOL_PIV), alpha_r)

    # rank-1 tableau update: W_i -= alpha_i * (w_r/alpha_r), W_r = w_r/alpha_r.
    # Folding the row-r replacement (coefficient alpha_r - 1) and the
    # do_pivot mask (coefficient 0) into the rank-1 coefficient vector
    # makes this ONE fused FMA pass over W — the tableau is the whole
    # memory footprint, and the naive set+where formulation costs three
    # full materializations per pivot instead of one.
    w_r = jnp.take_along_axis(
        st.W, r_idx[:, None, None], axis=1)[:, 0, :]               # (B, NT)
    w_r_scaled = w_r / alpha_r[:, None]
    coef = alpha.at[batch, r_idx].add(-1.0)
    coef = jnp.where(do_pivot[:, None], coef, 0.0)
    W_new = st.W - coef[:, :, None] * w_r_scaled[:, None, :]

    leaving = jnp.take_along_axis(st.basis, r_idx[:, None], axis=1)[:, 0]
    entering_val = _nb_value(lb, ub, st.at_upper)
    val_q = jnp.take_along_axis(entering_val, q_idx[:, None], axis=1)[:, 0]
    xq_new = val_q + delta
    xb_new = jnp.where(
        do_pivot[:, None],
        xb_new.at[batch, r_idx].set(xq_new),
        xb_new,
    )
    basis_upd = st.basis.at[batch, r_idx].set(q_idx.astype(jnp.int32))
    basis_new = jnp.where(do_pivot[:, None], basis_upd, st.basis)

    # incremental basis metadata at slot r
    cB_q = jnp.take_along_axis(c, q_idx[:, None], axis=1)[:, 0]
    lbB_new = jnp.where(do_pivot[:, None],
                        st.lbB.at[batch, r_idx].set(lb_q), st.lbB)
    ubB_new = jnp.where(do_pivot[:, None],
                        st.ubB.at[batch, r_idx].set(ub_q), st.ubB)
    cB_new = jnp.where(do_pivot[:, None],
                       st.cB.at[batch, r_idx].set(cB_q), st.cB)

    in_basis_upd = st.in_basis.at[batch, q_idx].set(True)
    in_basis_upd = in_basis_upd.at[batch, leaving].set(False)
    in_basis_new = jnp.where(do_pivot[:, None], in_basis_upd, st.in_basis)

    # leaving variable rests at the ratio-test target bound: an increasing
    # basic variable targets ub unless it was below lb (phase-1), and vice
    # versa (see target_inc/target_dec above)
    rate_r = jnp.take_along_axis(rate, r_idx[:, None], axis=1)[:, 0]
    viol_lo_r = jnp.take_along_axis(viol_lo, r_idx[:, None], axis=1)[:, 0]
    viol_up_r = jnp.take_along_axis(viol_up, r_idx[:, None], axis=1)[:, 0]
    leave_at_upper = jnp.where(rate_r > 0, ~viol_lo_r, viol_up_r)
    at_upper_upd = st.at_upper.at[batch, leaving].set(leave_at_upper)
    # bound flip: entering variable switches bound
    q_at_upper = jnp.take_along_axis(st.at_upper, q_idx[:, None], axis=1)[:, 0]
    at_upper_flip = st.at_upper.at[batch, q_idx].set(~q_at_upper)
    at_upper_new = jnp.where(
        do_pivot[:, None], at_upper_upd,
        jnp.where((act & do_flip)[:, None], at_upper_flip, st.at_upper),
    )

    degen = act & (t_star < TOL_BND)
    stall_new = jnp.where(act, jnp.where(degen, st.stall + 1, 0), st.stall)
    iters_new = st.iters + act.astype(jnp.int32)
    gamma_new = _devex_update(st.gamma, w_r_scaled, alpha_r, q_idx,
                              leaving, do_pivot)

    return _State(basis_new, in_basis_new, at_upper_new, W_new, xb_new,
                  lbB_new, ubB_new, cB_new,
                  new_status, stall_new, iters_new, st.step + 1, gamma_new)


def _final_solutions(A, c, lb, ub, st: _State, Bmat=None):
    """Accurate primal/dual recovery at termination: refactorize the
    final basis once (batched LU) so results do not inherit rank-1
    drift from the pivot loop.  ``Bmat``: precomputed (B, M, M) basis
    matrices (the revised path maintains them incrementally — gathering
    basis columns from a huge A inside jit can one-hot-expand into
    multi-GB temporaries)."""
    B, NT = c.shape
    M, N = A.shape[-2:]
    batch = jnp.arange(B)

    if Bmat is None:
        Bmat = _batched_basis_matrices(A, st.basis)
    zn = jnp.where(st.in_basis, 0.0, _nb_value(lb, ub, st.at_upper))
    rhs = -_e_matmul(A, zn)                                        # (B, M)
    lu, piv = jax.vmap(linalg.lu_factor)(Bmat)
    xb = jax.vmap(linalg.lu_solve)((lu, piv), rhs)
    y = jax.vmap(lambda f, p, b: linalg.lu_solve((f, p), b, trans=1))(
        lu, piv, st.cB)

    z = zn.at[batch[:, None], st.basis].set(xb)
    obj = jnp.sum(c * z, axis=1)
    d = c - _e_rmatmul(A, y)
    row_dual = -y                 # GLPK sign convention
    col_dual = d[:, M:]
    return obj, z[:, M:], z[:, :M], row_dual, col_dual


@functools.partial(jax.jit, static_argnames=("max_iter", "ssharding"))
def _solve_batch_jit(A, c, lb, ub, max_iter, ssharding=None):
    """Whole-solve-in-one-program form, kept for callers that must stay
    inside a single jittable function (the shard_map mesh path,
    parallel/mesh.py:67, and the driver's compile witness).  Host-driven
    production paths use _solve_tableau_segmented instead, which bounds
    every device program's step count (see _tableau_run_jit)."""
    st = _initial_state(A, c, lb, ub, ssharding=ssharding)

    def cond(s):
        return jnp.any(s.status == RUNNING) & (s.step < max_iter)

    st = jax.lax.while_loop(cond, lambda s: _step(A, c, lb, ub, st=s), st)
    status = jnp.where(st.status == RUNNING, ITLIM, st.status)
    obj, x, s_act, row_dual, col_dual = _final_solutions(A, c, lb, ub, st)
    return (status, obj, x, s_act, row_dual, col_dual, st.iters, st.basis,
            st.at_upper)


@dataclasses.dataclass
class KeptState:
    """Final tableau state of a solve, kept ON DEVICE so the next
    Benson round's warm re-solves skip both factorizations: a child LP
    warm-starting from its parent's optimal basis can reuse the
    parent's final W = Binv @ E VERBATIM (same basis -> same inverse),
    so the start costs one gather instead of a batched LU + (M,M)@
    (M,NT) expansion.  ``age``: pivots accumulated since the last true LU along
    the warm chain (rank-1 drift bound; the owner drops the state when
    it exceeds the refresh threshold)."""

    basis: object      # (B, M) device
    in_basis: object   # (B, NT) device
    at_upper: object   # (B, NT) device
    W: object          # (B, M, NT) device
    age: int = 0

    @property
    def nbytes(self) -> int:
        return int(np.prod(self.W.shape)) * self.W.dtype.itemsize


def _keep_state(st: _State, age: int) -> KeptState:
    return KeptState(st.basis, st.in_basis, st.at_upper, st.W, age)


def _concat_kept(states: list[KeptState]) -> KeptState:
    if len(states) == 1:
        return states[0]
    return KeptState(
        jnp.concatenate([s.basis for s in states]),
        jnp.concatenate([s.in_basis for s in states]),
        jnp.concatenate([s.at_upper for s in states]),
        jnp.concatenate([s.W for s in states]),
        max(s.age for s in states))


@jax.jit
def _tableau_start_from_state_jit(A, c, lb, ub, basis_s, in_basis_s,
                                  at_upper_s, W_s, idx):
    """Warm start by GATHERING parent rows of a kept state: instance i
    starts from row idx[i] of the previous solve's final tableau.  No
    factorization — W rows are exact basis inverses (up to the carried
    rank-1 drift tracked by KeptState.age)."""
    B = c.shape[0]
    basis = basis_s[idx]
    in_basis = in_basis_s[idx]
    at_upper = at_upper_s[idx]
    W = W_s[idx]
    at_upper = at_upper & jnp.isfinite(ub) & ~in_basis
    at_upper = at_upper | ((~jnp.isfinite(lb)) & jnp.isfinite(ub)
                           & ~in_basis)
    zn = jnp.where(in_basis, 0.0, _nb_value(lb, ub, at_upper))
    xb = -jnp.einsum("bmn,bn->bm", W, zn)
    lbB = jnp.take_along_axis(lb, basis, axis=1)
    ubB = jnp.take_along_axis(ub, basis, axis=1)
    cB = jnp.take_along_axis(c, basis, axis=1)
    zeros = jnp.zeros(B, jnp.int32)
    crossed = jnp.any(lb > ub, axis=1)
    status = jnp.where(crossed, INFEASIBLE, zeros)
    return _State(basis, in_basis, at_upper, W, xb, lbB, ubB, cB,
                  status, zeros, zeros, jnp.int32(0),
                  jnp.ones(c.shape, c.dtype))


@jax.jit
def _tableau_cheap_finish_jit(A, c, lb, ub, st):
    """LU-free termination: primal values from the loop state, duals
    from the tableau's embedded basis inverse (E = [I | -A] makes
    Binv = W[:, :, :M]).  Valid while the carried rank-1 drift is small
    (the caller gates on KeptState.age + this solve's pivots); skips
    the batched refactorization that dominates short warm re-solves."""
    status = jnp.where(st.status == RUNNING, ITLIM, st.status)
    B = c.shape[0]
    M = A.shape[-2]
    batch = jnp.arange(B)
    zn = jnp.where(st.in_basis, 0.0, _nb_value(lb, ub, st.at_upper))
    z = zn.at[batch[:, None], st.basis].set(st.xb)
    obj = jnp.sum(c * z, axis=1)
    y = jnp.einsum("bm,bmk->bk", st.cB, st.W[:, :, :M])
    d = c - _e_rmatmul(A, y)
    return (status, obj, z[:, M:], z[:, :M], -y, d[:, M:], st.iters,
            st.basis, st.at_upper)


# pivots of carried rank-1 drift allowed on a warm chain before the
# kept state is dropped and the next solve refactorizes (f64; f32
# chains are capped at a quarter of this).  f64 rank-1 drift from an
# exact LU grows roughly linearly in pivots and is ~1e-12 at this cap;
# the e2e support oracle at 1e-7 is the acceptance bar (measured on
# ex10: oracle passes at 1e-6 with full chains).
STATE_WARM_MAX_AGE = 128


@functools.partial(jax.jit, static_argnames=("ssharding",))
def _tableau_start_jit(A, c, lb, ub, ssharding=None):
    return _initial_state(A, c, lb, ub, ssharding=ssharding)


@functools.partial(jax.jit, static_argnames=("ssharding",))
def _tableau_start_warm_jit(A, c, lb, ub, basis0, at_upper0,
                            ssharding=None):
    return _initial_state(A, c, lb, ub, basis0, at_upper0, ssharding)


@functools.partial(jax.jit, static_argnames=("seg",))
def _tableau_run_jit(A, c, lb, ub, st, seg, max_iter):
    """Advance the pivot loop by at most ``seg`` steps.  Bounding the
    per-program step count keeps every device program short (a cold
    solve at the P2 bench shape spans ~150k pivots) and lets the host
    observe progress between segments.  ``max_iter`` is traced so data-derived
    caps never retrace the kernel."""
    seg_end = jnp.minimum(st.step + seg, max_iter)

    def cond(s):
        return jnp.any(s.status == RUNNING) & (s.step < seg_end)

    return jax.lax.while_loop(cond, lambda s: _step(A, c, lb, ub, st=s), st)


@jax.jit
def _tableau_finish_jit(A, c, lb, ub, st):
    status = jnp.where(st.status == RUNNING, ITLIM, st.status)
    obj, x, s_act, row_dual, col_dual = _final_solutions(A, c, lb, ub, st)
    return (status, obj, x, s_act, row_dual, col_dual, st.iters, st.basis,
            st.at_upper)


def _tableau_segment_steps(B: int, M: int, NT: int, itemsize: int) -> int:
    """Steps per device program, sized so one segment stays well under
    the worker watchdog (~10-30 s): one tableau pivot streams W about
    three times (reduced-cost pass, rank-1 read, rank-1 write)."""
    per_step = 3 * B * M * NT * itemsize
    return int(max(256, min(65536, 6e11 // max(per_step, 1))))


def _solve_tableau_segmented(A, c, lb, ub, basis0, at_upper0, max_iter,
                             ssharding=None, step_fn_jit=None):
    """Host-side segment loop around the jitted tableau pivot kernel
    (same structure as revised._solve_revised_segmented).  State stays on
    device between segments; only status/step come back per segment.
    ``step_fn_jit``: the segmented run kernel (primal pivots by default;
    dual_simplex passes its own)."""
    if step_fn_jit is None:
        step_fn_jit = _tableau_run_jit
    if basis0 is None:
        st = _tableau_start_jit(A, c, lb, ub, ssharding=ssharding)
    else:
        st = _tableau_start_warm_jit(A, c, lb, ub, basis0, at_upper0,
                                     ssharding=ssharding)
    B, NT = c.shape
    M = A.shape[-2]
    seg = _tableau_segment_steps(B, M, NT, np.dtype(c.dtype).itemsize)
    while True:
        st = step_fn_jit(A, c, lb, ub, st, seg, max_iter)
        status = np.asarray(st.status)
        if (status != RUNNING).all() or int(st.step) >= max_iter:
            break
    return _tableau_finish_jit(A, c, lb, ub, st)


def _bucket(x: int) -> int:
    """Round a dimension up to a standard size so distinct problem shapes
    share compiled executables (dummy rows are free, dummy columns fixed
    at zero, so padding never changes the solution)."""
    if x <= 8:
        return 8
    step = max(8, 1 << (x.bit_length() - 3))
    return -(-x // step) * step


MAX_CHUNK = 256  # largest batch shape compiled; bigger batches split
TABLEAU_BYTES_BUDGET = 2 << 30  # cap on the (B, M, NT) tableau size


@dataclasses.dataclass
class _PreparedA:
    """A constraint matrix padded to its bucketed shape and kept resident
    on device, so per-round Benson solves do not re-pad (host memcpy) and
    re-transfer (host->device) a matrix that never changes.  For ex09
    (m=4608, n=36939, SURVEY.md section 6) the padded matrix is ~0.8 GB
    in f32 — re-uploading it every round would dominate the solve."""

    A: np.ndarray       # original (strong ref keeps the cache key valid)
    M: int
    N: int
    Mp: int
    Np: int
    dev: jax.Array      # (Mp, Np) padded, on the default device
    host: np.ndarray    # (Mp, Np) padded host copy (warm-basis builds)
    devT: jax.Array | None = None  # (Np, Mp) transpose, device-resident
    #   (the revised path needs BOTH layouts; an in-jit A.T materializes
    #   an 800 MB copy per compiled program at ex09 scale)

    def transposed(self) -> jax.Array:
        if self.devT is None:
            self.devT = jnp.asarray(np.ascontiguousarray(self.host.T))
        return self.devT


_A_CACHE: collections.OrderedDict = collections.OrderedDict()
_A_CACHE_MAX = 8


def _prepare_A(A, dtype) -> _PreparedA:
    """Pad ``A`` to bucketed dims and place it on device, memoized by
    object identity (callers must not mutate ``A`` after first use —
    Benson templates build their LP matrix once and never touch it)."""
    if isinstance(A, _PreparedA):
        return A
    key = (id(A), np.dtype(dtype).str)
    hit = _A_CACHE.get(key)
    if hit is not None and hit.A is A:
        _A_CACHE.move_to_end(key)
        return hit
    arr = np.asarray(A, dtype)
    M, N = arr.shape
    Mp, Np = _bucket(M), _bucket(N)
    A_p = np.zeros((Mp, Np), dtype)
    A_p[:M, :N] = arr
    prep = _PreparedA(A if isinstance(A, np.ndarray) else arr,
                      M, N, Mp, Np, jnp.asarray(A_p), A_p)
    _A_CACHE[key] = prep
    while len(_A_CACHE) > _A_CACHE_MAX:
        _A_CACHE.popitem(last=False)
    return prep


def _bucket_batch(B: int, Mp: int) -> int:
    """Bucket the batch axis to a power of two (few compiled shapes).
    Small problems get a floor of 8 (padding instances are nearly free);
    large-M problems pay O(M^2) state per padding instance, so they use
    the exact power of two down to 1."""
    Bp = 1 << max(0, B - 1).bit_length()
    return max(8, Bp) if Mp <= 1024 else max(1, Bp)


def _pad_batch_inputs(prep: _PreparedA, c, row_lb, row_ub, col_lb, col_ub,
                      Bp, dtype):
    """(B, *) objective/bounds -> padded (Bp, Mp+Np) jit inputs.  Padding
    instances replicate row 0 (real, terminating data); padding columns
    are fixed at zero so they never enter the basis usefully.  An EMPTY
    batch (B == 0 — e.g. a distributed host whose frontier shard is
    empty) keeps the pure-fill padding rows, which form a trivially
    optimal LP (free rows, columns fixed at zero), so the host still
    reaches the round's collectives."""
    M, N, Mp, Np = prep.M, prep.N, prep.Mp, prep.Np
    c = np.atleast_2d(np.asarray(c, dtype))
    if c.size == 0:
        c = c.reshape(0, N)
    B = c.shape[0]

    def _pad(arr, k, kp, fill):
        arr = np.asarray(arr, dtype).reshape(-1, k)
        out = np.full((Bp, kp), fill, dtype)
        out[:B, :k] = arr
        if Bp > B > 0:
            out[B:, :k] = arr[:1]
        return out

    full_c = np.concatenate(
        [np.zeros((Bp, Mp), dtype), _pad(c, N, Np, 0.0)], axis=1)
    lb = np.concatenate(
        [_pad(row_lb, M, Mp, -np.inf), _pad(col_lb, N, Np, 0.0)], axis=1)
    ub = np.concatenate(
        [_pad(row_ub, M, Mp, np.inf), _pad(col_ub, N, Np, 0.0)], axis=1)
    return full_c, lb, ub


def _slice_warm(start_basis, sl):
    """Restrict a warm start to a batch chunk (per-instance arrays are
    sliced; a shared basis applies to every chunk unchanged)."""
    if start_basis is None:
        return None
    b0, u0 = (start_basis if isinstance(start_basis, tuple)
              else (start_basis, None))
    if np.asarray(b0).ndim == 2:
        b0 = np.asarray(b0)[sl]
        if u0 is not None and np.asarray(u0).ndim == 2:
            u0 = np.asarray(u0)[sl]
    return b0 if u0 is None else (b0, u0)


def _pad_warm(start_basis, Mp, NTp, B, Bp):
    """Normalize a warm start to jit inputs: (basis, at_upper) arrays,
    per-instance rows padded to the bucketed batch by replicating row 0.
    A wider at_upper (from a solve at a larger padded shape) is
    truncated: real variables share the same numbering (rows then
    structurals at offset Mp) in every backend, and extra padded
    columns are fixed at 0 so they never enter a basis."""
    if isinstance(start_basis, tuple):
        b0, u0 = start_basis
    else:
        b0, u0 = start_basis, None
    b0 = np.asarray(b0, np.int32)
    if u0 is None:
        u0 = np.zeros(NTp if b0.ndim == 1 else (b0.shape[0], NTp), bool)
    u0 = np.asarray(u0, bool)
    if u0.shape[-1] > NTp:
        u0 = u0[..., :NTp]
    if b0.ndim == 2:
        if b0.shape[0] < Bp:
            b0 = np.concatenate(
                [b0, np.broadcast_to(b0[:1], (Bp - b0.shape[0], Mp))])
        if u0.ndim == 1:
            u0 = np.broadcast_to(u0[None], (Bp, NTp)).copy()
        elif u0.shape[0] < Bp:
            u0 = np.concatenate(
                [u0, np.broadcast_to(u0[:1], (Bp - u0.shape[0], NTp))])
    return b0, u0


def _auto_chunk(M: int, N: int, itemsize: int) -> int:
    """Largest power-of-two batch whose tableau fits the byte budget."""
    per = (M + 8) * (M + N + 16) * itemsize
    cap = max(1, TABLEAU_BYTES_BUDGET // per)
    return min(MAX_CHUNK, 1 << (cap.bit_length() - 1))


def solve_batch(A, c, row_lb, row_ub, col_lb, col_ub, *,
                max_iter: int | None = None, dtype=np.float64,
                start_basis=None, max_chunk: int | None = None,
                sharding=None, mesh=None) -> LPResult:
    """Solve a batch of LPs sharing constraint matrix ``A`` (M, N).

    ``c``: (B, N) objective on structural variables.
    ``row_lb``/``row_ub``: (B, M); ``col_lb``/``col_ub``: (B, N).
    ``dtype``: float64 (default; GLPK-grade tolerances) or float32
    (looser tolerances — see _tols).
    ``start_basis``: optional warm start — either a shared (M,) basis
    (variable indices in the PADDED numbering: rows then columns) or a
    tuple (basis, at_upper_pattern); typically ``result.basis[i]`` /
    ``result.at_upper[i]`` of a related previous solve.
    ``max_chunk``: batches larger than this are processed in fixed-size
    chunks, so arbitrarily large frontiers reuse ONE compiled shape and
    the tableau memory stays bounded.
    ``mesh``: multi-chip execution (Options.mesh_axes): "dp" shards the
    batch, "tp" the tableau columns, via committed input shardings plus
    a sharding constraint on the loop-carried tableau.
    """
    if not isinstance(A, _PreparedA) and np.asarray(A).ndim == 3:
        return _solve_batch_3d(np.asarray(A), c, row_lb, row_ub, col_lb,
                               col_ub, max_iter=max_iter, dtype=dtype,
                               start_basis=start_basis,
                               max_chunk=max_chunk, sharding=sharding)
    prep = _prepare_A(A, dtype)
    if max_chunk is None:
        chunk = _auto_chunk(prep.M, prep.N, np.dtype(dtype).itemsize)
    else:
        chunk = max_chunk
    c2 = np.atleast_2d(np.asarray(c))
    if c2.shape[0] > chunk:
        parts = []
        for s in range(0, c2.shape[0], chunk):
            sl = slice(s, s + chunk)
            parts.append(solve_batch(
                prep, c2[sl], np.asarray(row_lb)[sl], np.asarray(row_ub)[sl],
                np.asarray(col_lb)[sl], np.asarray(col_ub)[sl],
                max_iter=max_iter, dtype=dtype,
                start_basis=_slice_warm(start_basis, sl),
                max_chunk=chunk, mesh=mesh))
        return concat_results(parts)
    M, N, Mp, Np = prep.M, prep.N, prep.Mp, prep.Np
    B = c2.shape[0]
    Bp = _bucket_batch(B, Mp)
    ssharding = None
    A_dev = prep.dev
    put = jnp.asarray
    if mesh is not None:
        from bensolve_tpu.lp.revised import _mesh_shardings

        shA, _, shB, ssharding = _mesh_shardings(mesh)
        if "dp" in mesh.axis_names:
            dp_size = mesh.shape["dp"]
            while Bp % dp_size:
                Bp *= 2
        A_dev = jax.device_put(prep.host, shA)
        put = functools.partial(jax.device_put, device=shB)
    if max_iter is None:
        # derived from the PADDED dims so it is as bucketed as the shapes
        max_iter = 50 * (Mp + Np) + 500
    full_c, lb, ub = _pad_batch_inputs(prep, c2, row_lb, row_ub,
                                       col_lb, col_ub, Bp, dtype)

    if start_basis is None:
        out = _solve_tableau_segmented(A_dev, put(full_c),
                                       put(lb), put(ub), None, None,
                                       max_iter, ssharding=ssharding)
    else:
        b0, u0 = _pad_warm(start_basis, Mp, Mp + Np, B, Bp)
        out = _solve_tableau_segmented(
            A_dev, put(full_c), put(lb),
            put(ub), jnp.asarray(b0), jnp.asarray(u0), max_iter,
            ssharding=ssharding)
    (status, obj, x, s, row_dual, col_dual, iters, basis, at_upper) = (
        np.asarray(o) for o in out)
    return LPResult(status[:B], obj[:B], x[:B, :N], s[:B, :M],
                    row_dual[:B, :M], col_dual[:B, :N], iters[:B],
                    basis[:B], at_upper[:B])


def _solve_batch_3d(A, c, row_lb, row_ub, col_lb, col_ub, *,
                    max_iter=None, dtype=np.float64, start_basis=None,
                    max_chunk=None, sharding=None) -> LPResult:
    """solve_batch for per-instance constraint matrices A (B, M, N) —
    the instance-level-DP form (scenario batches, BASELINE.json config
    #5): every LP in the batch is a DIFFERENT problem, pivoted in
    lockstep on device.  Padding and chunking mirror the shared-A path;
    padding instances replicate instance 0."""
    A = np.asarray(A, dtype)
    B0, M, N = A.shape
    c2 = np.atleast_2d(np.asarray(c))
    if c2.shape[0] != B0:
        raise ValueError(f"A batch {B0} != objective batch {c2.shape[0]}")
    if max_chunk is None:
        per = (M + 8) * (M + N + 16) * np.dtype(dtype).itemsize * 2
        cap = max(1, TABLEAU_BYTES_BUDGET // per)
        max_chunk = min(MAX_CHUNK, 1 << (cap.bit_length() - 1))
    if B0 > max_chunk:
        parts = []
        for s in range(0, B0, max_chunk):
            sl = slice(s, s + max_chunk)
            parts.append(_solve_batch_3d(
                A[sl], c2[sl], np.asarray(row_lb)[sl],
                np.asarray(row_ub)[sl], np.asarray(col_lb)[sl],
                np.asarray(col_ub)[sl], max_iter=max_iter, dtype=dtype,
                start_basis=_slice_warm(start_basis, sl),
                max_chunk=max_chunk, sharding=sharding))
        return concat_results(parts)

    Mp, Np = _bucket(M), _bucket(N)
    Bp = _bucket_batch(B0, Mp)
    if max_iter is None:
        max_iter = 50 * (Mp + Np) + 500
    A_p = np.zeros((Bp, Mp, Np), dtype)
    A_p[:B0, :M, :N] = A
    if Bp > B0 > 0:
        A_p[B0:, :M, :N] = A[0]

    def _pad(arr, k, kp, fill):
        arr = np.asarray(arr, dtype).reshape(-1, k)
        out = np.full((Bp, kp), fill, dtype)
        out[:B0, :k] = arr
        if Bp > B0 > 0:
            out[B0:, :k] = arr[:1]
        return out

    full_c = np.concatenate(
        [np.zeros((Bp, Mp), dtype), _pad(c2, N, Np, 0.0)], axis=1)
    lb = np.concatenate(
        [_pad(row_lb, M, Mp, -np.inf), _pad(col_lb, N, Np, 0.0)], axis=1)
    ub = np.concatenate(
        [_pad(row_ub, M, Mp, np.inf), _pad(col_ub, N, Np, 0.0)], axis=1)

    def _put(x):
        # lay the batch axis over the mesh's data axis: lockstep
        # pivoting is embarrassingly parallel across instances, so SPMD
        # partitioning needs no collectives at all
        return (jax.device_put(x, sharding) if sharding is not None
                else jnp.asarray(x))

    if start_basis is None:
        out = _solve_tableau_segmented(_put(A_p), _put(full_c),
                                       _put(lb), _put(ub), None, None,
                                       max_iter)
    else:
        b0, u0 = _pad_warm(start_basis, Mp, Mp + Np, B0, Bp)
        out = _solve_tableau_segmented(
            _put(A_p), _put(full_c), _put(lb),
            _put(ub), _put(b0), _put(u0), max_iter)
    (status, obj, x, s, row_dual, col_dual, iters, basis, at_upper) = (
        np.asarray(o) for o in out)
    return LPResult(status[:B0], obj[:B0], x[:B0, :N], s[:B0, :M],
                    row_dual[:B0, :M], col_dual[:B0, :N], iters[:B0],
                    basis[:B0], at_upper[:B0])
