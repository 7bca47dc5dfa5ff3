"""Batched dense *revised* bounded-variable simplex for tall problems.

The tableau solver (lp/simplex.py) carries the full (B, M, M+N) tableau
through every pivot — ideal when M and N are comparable, but for
problems with N >> M (e.g. the reference's ex09: m=4608, n=36939,
bslv_vlp-scale radiotherapy/financial instances) the tableau is ~1.5 GB
per LP and the batch degenerates to size 1.  This solver keeps only the
basis inverse (B, M, M) per instance plus ONE shared constraint matrix:

    per iteration     tableau               revised (this file)
    state traffic     B * M * (M+N)         B * M^2  (+ A once for pricing)
    pricing           included in tableau   y = cB_eff @ Binv; d = c - y E
    pivot column      tableau column        alpha = Binv @ E_q (gathered)

E = [I | -A] as in lp/simplex.py, so duals stay free (y = cB @ Binv) and
the pricing product y @ A is a single matmul over the shared A.

Semantics (statuses, bound types, composite phase-1, Bland fallback,
final LU refactorization) mirror lp/simplex.py exactly; results are
interchangeable.  Reference contract: bslv_lp.c:219-303.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from bensolve_tpu.lp import linalg
from bensolve_tpu.lp import simplex as sx
from bensolve_tpu.lp.simplex import (BLAND_AFTER, INFEASIBLE, ITLIM, OPTIMAL,
                                     RUNNING, UNBOUNDED, LPResult, _nb_value,
                                     _tols)


@dataclasses.dataclass
class _RState:
    basis: jnp.ndarray      # (B, M) int32
    in_basis: jnp.ndarray   # (B, NT) bool
    at_upper: jnp.ndarray   # (B, NT) bool
    Binv: jnp.ndarray       # (B, M, M)
    Brows: jnp.ndarray      # (B, M, M): row k = basis column E[:, basis[k]]
    #   maintained incrementally (one row scatter per pivot) so the
    #   refactorization and the endgame never GATHER basis columns out
    #   of the huge A inside jit — a gather expander may rewrite that
    #   into a one-hot dot_general with a (B, N, M) float temp
    #   (gigabytes at m=4608, n=36939)
    xb: jnp.ndarray         # (B, M)
    lbB: jnp.ndarray        # (B, M)
    ubB: jnp.ndarray        # (B, M)
    cB: jnp.ndarray         # (B, M)
    status: jnp.ndarray     # (B,)
    stall: jnp.ndarray      # (B,)
    iters: jnp.ndarray      # (B,)
    step: jnp.ndarray       # ()
    gamma: jnp.ndarray = None  # (B, NT) devex reference weights
    # carried phase-2 reduced-cost row (the classic cost-row rank-1
    # update): while every running instance is primal feasible the full
    # pricing pass d = c - (cB Binv) E -- ONE whole-A matmul per pivot,
    # the dominant cost at ex09 scale -- is replaced by
    # d' = d - d_q * w_r, reusing the w_r row devex already computes.
    dred: jnp.ndarray = None   # (B, NT)
    # instances whose carried row is stale (just turned feasible, was
    # reset at refactorization, or wants to declare optimality off a
    # carried row): forces an exact pricing pass next step
    force: jnp.ndarray = None  # (B,) bool
    # singular-basis slack resets applied by _refactor (diagnostic)
    resets: jnp.ndarray = None  # (B,) int32


jax.tree_util.register_dataclass(
    _RState,
    data_fields=["basis", "in_basis", "at_upper", "Binv", "Brows", "xb",
                 "lbB", "ubB", "cB", "status", "stall", "iters", "step",
                 "gamma", "dred", "force", "resets"],
    meta_fields=[],
)


def _e_col(A, AT, q):
    """Column q of E = [I | -A] for a batch of indices q (B,) -> (B, M).

    Gathers ROWS of the precomputed A^T: a per-step column gather of
    the row-major A would strided-load M elements at stride N (or be
    one-hot-dot expanded); A^T rows are contiguous."""
    M, N = A.shape
    is_aux = q < M
    aux_col = jax.nn.one_hot(q, M, dtype=A.dtype)                 # (B, M)
    a_col = -jnp.take(AT, jnp.clip(q - M, 0, N - 1), axis=0)      # (B, M)
    return jnp.where(is_aux[:, None], aux_col, a_col)


def _initial_rstate(A, c, lb, ub, basis0=None, at_upper0=None, Brows0=None,
                    ssharding=None):
    """``Brows0``: host-built (1 or B, M, M) basis-column rows matching
    ``basis0`` (see _host_brows) — basis matrices are never gathered out
    of A inside jit.  ``ssharding``: NamedSharding for the (B, M, M)
    state blocks (Binv/Brows) under multi-chip execution — constraining
    the INITIAL state fixes the while-loop carry sharding, so the
    per-instance panels stay distributed instead of replicating."""
    B, NT = c.shape
    M, N = A.shape
    dtype = c.dtype
    if basis0 is None:
        basis = jnp.tile(jnp.arange(M, dtype=jnp.int32)[None, :], (B, 1))
        in_basis1 = jnp.concatenate([jnp.ones(M, bool), jnp.zeros(N, bool)])
        in_basis = jnp.broadcast_to(in_basis1[None, :], (B, NT))
        Binv = jnp.broadcast_to(
            jnp.eye(M, dtype=dtype)[None], (B, M, M)) + jnp.zeros(
            (B, 1, 1), dtype)
        Brows = Binv   # identity basis: rows ARE unit vectors
    elif jnp.asarray(basis0).ndim == 2:
        # per-instance warm start: batched LU of each candidate's basis
        basis = jnp.asarray(basis0, jnp.int32)
        in_basis = jax.vmap(
            lambda b: jnp.zeros(NT, bool).at[b].set(True))(basis)
        Brows = jnp.asarray(Brows0, dtype)
        Bmat = jnp.swapaxes(Brows, 1, 2)
        lu, piv = jax.vmap(linalg.lu_factor)(Bmat)
        eye = jnp.eye(M, dtype=dtype)
        Binv = jax.vmap(lambda f, p: linalg.lu_solve((f, p), eye))(lu, piv)
    else:
        basis0 = jnp.asarray(basis0, jnp.int32)
        basis = jnp.broadcast_to(basis0[None, :], (B, M))
        in_basis1 = jnp.zeros(NT, bool).at[basis0].set(True)
        in_basis = jnp.broadcast_to(in_basis1[None, :], (B, NT))
        Brows1 = jnp.asarray(Brows0, dtype)[0]          # (M, M)
        lu, piv = linalg.lu_factor(Brows1.T)
        Binv0 = linalg.lu_solve((lu, piv), jnp.eye(M, dtype=dtype))
        Binv = jnp.broadcast_to(Binv0[None], (B, M, M)) + jnp.zeros(
            (B, 1, 1), dtype)
        Brows = jnp.broadcast_to(Brows1[None], (B, M, M)) + jnp.zeros(
            (B, 1, 1), dtype)
    if at_upper0 is None:
        at_upper = (~jnp.isfinite(lb)) & jnp.isfinite(ub) & ~in_basis
    else:
        at_upper0 = jnp.asarray(at_upper0, bool)
        if at_upper0.ndim == 1:
            at_upper0 = at_upper0[None, :]
        at_upper = jnp.broadcast_to(at_upper0, (B, NT))
        at_upper = at_upper & jnp.isfinite(ub) & ~in_basis
        at_upper = at_upper | ((~jnp.isfinite(lb)) & jnp.isfinite(ub)
                               & ~in_basis)
    zn = jnp.where(in_basis, 0.0, _nb_value(lb, ub, at_upper))
    # xb = Binv (-E zn)
    rhs = -sx._e_matmul(A, zn)                                     # (B, M)
    xb = rhs if basis0 is None else jnp.einsum("bij,bj->bi", Binv, rhs)
    zeros = jnp.zeros(B, jnp.int32)
    lbB = jnp.take_along_axis(lb, basis, axis=1)
    ubB = jnp.take_along_axis(ub, basis, axis=1)
    cB = jnp.take_along_axis(c, basis, axis=1)
    crossed = jnp.any(lb > ub, axis=1)
    status = jnp.where(crossed, INFEASIBLE, zeros)
    if ssharding is not None:
        Binv = jax.lax.with_sharding_constraint(Binv, ssharding)
        Brows = jax.lax.with_sharding_constraint(Brows, ssharding)
    return _RState(basis, in_basis, at_upper, Binv, Brows, xb, lbB, ubB, cB,
                   status, zeros, zeros, jnp.int32(0),
                   jnp.ones((B, NT), dtype),
                   jnp.zeros((B, NT), dtype), jnp.ones(B, bool),
                   jnp.zeros(B, jnp.int32))


# pricing mode: True replaces most full pricing passes with the carried
# rank-1-updated cost row (one whole-A matmul saved per pivot); False
# reprices exactly every step.  Module-level so a mis-compiling backend
# can be bisected; flips require a fresh process (jit caches key on the
# traced program).
CARRIED_PRICING = True


def _rstep(A, AT, c, lb, ub, st: _RState) -> _RState:
    TOL_BND, TOL_DJ, TOL_PIV = _tols(c.dtype)
    B, NT = c.shape
    M, N = A.shape
    batch = jnp.arange(B)
    running = st.status == RUNNING

    viol_lo = st.xb < st.lbB - TOL_BND
    viol_up = st.xb > st.ubB + TOL_BND
    feasible = ~jnp.any(viol_lo | viol_up, axis=1)

    cB1 = jnp.where(viol_up, 1.0, 0.0) + jnp.where(viol_lo, -1.0, 0.0)
    cB_eff = jnp.where(feasible[:, None], st.cB, cB1).astype(c.dtype)

    # duals y = cB_eff @ Binv (needed for the finite guard regardless
    # of the pricing mode; M x M work, cheap next to the A pass)
    y = jnp.einsum("bm,bmk->bk", cB_eff, st.Binv)                  # (B, M)

    # pricing: the full pass d = c_eff - y E streams the whole shared A
    # once per pivot -- at ex09 scale (M~4.6k, N~37k) that is the
    # dominant per-step cost.  While every running instance is primal
    # feasible, the carried cost row st.dred (rank-1-updated each pivot)
    # prices the step with no A pass at all; the full pass runs while
    # any instance is infeasible (composite phase-1 costs are not
    # rank-1-maintainable), when a carried row is stale (st.force), and
    # on a periodic drift refresh.
    def full_price(_):
        return jnp.where(feasible[:, None], c, 0.0) - sx._e_rmatmul(A, y)

    if CARRIED_PRICING:
        run_full = (jnp.any(running & ~feasible)
                    | jnp.any(running & st.force)
                    | (st.step % 64 == 0))
        d = jax.lax.cond(run_full, full_price, lambda _: st.dred, 0)
    else:
        run_full = jnp.bool_(True)
        d = full_price(0)

    # non-finite guard: an overflowed/NaN-poisoned instance must not be
    # classified (NaN comparisons read as "feasible & no entering" ->
    # bogus OPTIMAL).  It stays RUNNING and the periodic refactorization
    # repairs Binv/xb from the (always valid) basis indices.
    finite = jnp.all(jnp.isfinite(st.xb), axis=1) & \
        jnp.all(jnp.isfinite(y), axis=1)

    val = _nb_value(lb, ub, st.at_upper)
    can_inc = (~st.in_basis) & (val < ub)
    can_dec = (~st.in_basis) & (val > lb)
    elig_inc = can_inc & (d < -TOL_DJ)
    elig_dec = can_dec & (d > TOL_DJ)
    eligible = elig_inc | elig_dec
    use_bland = st.stall > BLAND_AFTER
    q_idx = sx._devex_entering(d, eligible, st.gamma, use_bland, NT,
                               c.dtype)
    has_entering = jnp.any(eligible, axis=1)

    finish_status = jnp.where(feasible, OPTIMAL, INFEASIBLE)
    # a finish verdict is only trusted when this step's pricing was
    # exact (run_full); off a carried row the instance instead sets
    # st.force so the NEXT step reprices exactly and finishes then
    would_finish = running & ~has_entering & finite
    new_status = jnp.where(would_finish & run_full, finish_status,
                           st.status)
    act = running & has_entering & finite

    sigma = jnp.where(
        jnp.take_along_axis(elig_inc, q_idx[:, None], axis=1)[:, 0], 1.0, -1.0
    ).astype(c.dtype)

    # pivot column alpha = Binv @ E_q (gathered shared-A column)
    e_q = _e_col(A, AT, q_idx)                                         # (B, M)
    alpha = jnp.einsum("bmk,bk->bm", st.Binv, e_q)
    rate = -sigma[:, None] * alpha

    inc = rate > TOL_PIV
    dec = rate < -TOL_PIV
    target_inc = jnp.where(viol_lo, st.lbB, st.ubB)
    target_dec = jnp.where(viol_up, st.ubB, st.lbB)
    t_inc = jnp.where(viol_up, jnp.inf, (target_inc - st.xb) / rate)
    t_dec = jnp.where(viol_lo, jnp.inf, (target_dec - st.xb) / rate)
    t = jnp.where(inc, t_inc, jnp.where(dec, t_dec, jnp.inf))
    t = jnp.maximum(t, 0.0)
    t = jnp.where(jnp.isnan(t), jnp.inf, t)

    tmin = jnp.min(t, axis=1)
    cand = t <= tmin[:, None] + 1e-12
    stab_score = jnp.where(cand, jnp.abs(rate), -1.0)
    basis_f = st.basis.astype(c.dtype)
    bland_leave = jnp.where(cand, -basis_f, -jnp.inf)
    leave_score = jnp.where(use_bland[:, None], bland_leave, stab_score)
    r_idx = jnp.argmax(leave_score, axis=1)

    lb_q = jnp.take_along_axis(lb, q_idx[:, None], axis=1)[:, 0]
    ub_q = jnp.take_along_axis(ub, q_idx[:, None], axis=1)[:, 0]
    span = ub_q - lb_q
    span = jnp.where(jnp.isfinite(span), span, jnp.inf)
    do_flip = span < tmin
    t_star = jnp.where(do_flip, span, tmin)

    unbounded = act & feasible & ~jnp.isfinite(t_star)
    new_status = jnp.where(unbounded, UNBOUNDED, new_status)
    act = act & jnp.isfinite(t_star)

    delta = jnp.where(act, sigma * t_star, 0.0)
    xb_new = st.xb - delta[:, None] * alpha

    do_pivot = act & ~do_flip
    alpha_r = jnp.take_along_axis(alpha, r_idx[:, None], axis=1)[:, 0]
    alpha_r = jnp.where(jnp.abs(alpha_r) < TOL_PIV,
                        jnp.where(alpha_r < 0, -TOL_PIV, TOL_PIV), alpha_r)

    # rank-1 basis-inverse update (product form): Binv_i -= alpha_i b_r,
    # Binv_r = b_r, with b_r = Binv_r / alpha_r.  As in lp/simplex.py,
    # the row-r replacement (coefficient alpha_r - 1) and the do_pivot
    # mask (coefficient 0) fold into the rank-1 coefficient vector, so
    # the update is ONE fused FMA pass over Binv instead of three
    # materializations.
    b_r = jnp.take_along_axis(
        st.Binv, r_idx[:, None, None], axis=1)[:, 0, :]            # (B, M)
    b_r_scaled = b_r / alpha_r[:, None]
    coef = alpha.at[batch, r_idx].add(-1.0)
    coef = jnp.where(do_pivot[:, None], coef, 0.0)
    Binv_new = st.Binv - coef[:, :, None] * b_r_scaled[:, None, :]

    leaving = jnp.take_along_axis(st.basis, r_idx[:, None], axis=1)[:, 0]
    val_q = jnp.take_along_axis(val, q_idx[:, None], axis=1)[:, 0]
    xq_new = val_q + delta
    xb_new = jnp.where(do_pivot[:, None],
                       xb_new.at[batch, r_idx].set(xq_new), xb_new)
    basis_upd = st.basis.at[batch, r_idx].set(q_idx.astype(jnp.int32))
    basis_new = jnp.where(do_pivot[:, None], basis_upd, st.basis)

    # basis-matrix rows follow the basis: slot r's column becomes E_q.
    # The do_pivot mask folds into the scattered VALUE (keep the current
    # row when not pivoting) so the scatter is unconditional and XLA
    # updates Brows in place instead of copying the whole (B, M, M)
    cur_row = jnp.take_along_axis(
        st.Brows, r_idx[:, None, None], axis=1)[:, 0, :]
    new_row = jnp.where(do_pivot[:, None], e_q, cur_row)
    Brows_new = st.Brows.at[batch, r_idx].set(new_row)

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

    rate_r = jnp.take_along_axis(rate, r_idx[:, None], axis=1)[:, 0]
    viol_lo_r = jnp.take_along_axis(viol_lo, r_idx[:, None], axis=1)[:, 0]
    viol_up_r = jnp.take_along_axis(viol_up, r_idx[:, None], axis=1)[:, 0]
    leave_at_upper = jnp.where(rate_r > 0, ~viol_lo_r, viol_up_r)
    at_upper_upd = st.at_upper.at[batch, leaving].set(leave_at_upper)
    q_at_upper = jnp.take_along_axis(st.at_upper, q_idx[:, None], axis=1)[:, 0]
    at_upper_flip = st.at_upper.at[batch, q_idx].set(~q_at_upper)
    at_upper_new = jnp.where(
        do_pivot[:, None], at_upper_upd,
        jnp.where((act & do_flip)[:, None], at_upper_flip, st.at_upper),
    )

    degen = act & (t_star < TOL_BND)
    stall_new = jnp.where(act, jnp.where(degen, st.stall + 1, 0), st.stall)
    iters_new = st.iters + act.astype(jnp.int32)
    # devex needs the pivot ROW over all NT columns: w_r = Binv_r @ E,
    # one extra shared-A matmul per pivot — paid back by the pivot-count
    # reduction devex buys on these tall instances
    w_r_full = sx._e_rmatmul(A, b_r_scaled)                        # (B, NT)
    gamma_new = sx._devex_update(st.gamma, w_r_full,
                                 alpha_r, q_idx, leaving, do_pivot)

    # carried cost row: d' = d - d_q * w_r (exact phase-2 update; the
    # entering column's new reduced cost is exactly 0 since w_r_q = 1)
    d_q = jnp.take_along_axis(d, q_idx[:, None], axis=1)           # (B, 1)
    dred_new = jnp.where(do_pivot[:, None], d - d_q * w_r_full, d)
    force_new = (running & ~feasible) | (would_finish & ~run_full)

    return _RState(basis_new, in_basis_new, at_upper_new, Binv_new,
                   Brows_new, xb_new, lbB_new, ubB_new, cB_new,
                   new_status, stall_new, iters_new, st.step + 1,
                   gamma_new, dred_new, force_new, st.resets)


# pivots between basis-inverse refactorizations.  The product-form
# rank-1 updates drift (GLPK refactorizes every ~100 pivots for the
# same reason); without this, hundreds-of-pivot chains (ex07/ex09
# scale) can misclassify statuses before the endgame LU repairs the
# solution values.  float32 drifts faster than float64.
REFACTOR_EVERY_F32 = 64
REFACTOR_EVERY_F64 = 200


def _refactor_interval(M: int, NT: int, dtype) -> int:
    """Refactorization cadence.  A full LU + explicit inverse costs
    ~M^2/NT pivots' worth of work, so the dtype cadence is stretched on
    huge bases (ex09: M~5k) to cap refactor overhead — but never beyond
    a hard cap: the rank-1 product form drifts with every update, and a
    thousand-update gap leaves too little accuracy for the f32 pivot
    tolerances to classify statuses."""
    f32 = jnp.dtype(dtype) == jnp.dtype(jnp.float32)
    base = REFACTOR_EVERY_F32 if f32 else REFACTOR_EVERY_F64
    cap = 64 if f32 else 1024
    return max(min(base, cap), min(4 * M * M // max(NT, 1), cap))


def _refactor(A, c, lb, ub, st: _RState) -> _RState:
    """Recompute Binv and xb from a fresh batched LU of the current
    basis (incrementally maintained in st.Brows — no gather from A),
    discarding accumulated product-form error.

    Singular-basis recovery: when even the fresh LU leaves non-finite
    state (a clamped-pivot factorization of a numerically dependent
    basis), the instance RESETS to the standard slack basis and
    re-solves from scratch — the batched analogue of GLPK's
    glp_std_basis retry (bslv_lp.c:222-227).  Without this, a poisoned
    instance livelocks: every pivot is skipped by the finite guard and
    every refactorization rebuilds the same singular basis."""
    M = A.shape[0]
    B, NT = c.shape
    dtype = c.dtype
    Bmat = jnp.swapaxes(st.Brows, 1, 2)
    lu, piv = jax.vmap(linalg.lu_factor)(Bmat)
    eye = jnp.eye(M, dtype=dtype)
    Binv = jax.vmap(lambda f, p: linalg.lu_solve((f, p), eye))(lu, piv)
    zn = jnp.where(st.in_basis, 0.0, _nb_value(lb, ub, st.at_upper))
    xb = jnp.einsum("bij,bj->bi", Binv, -sx._e_matmul(A, zn))

    bad = (st.status == RUNNING) & ~(
        jnp.all(jnp.isfinite(xb), axis=1)
        & jnp.all(jnp.isfinite(Binv.reshape(B, -1)), axis=1))
    aux = jnp.arange(M, dtype=jnp.int32)
    in_basis1 = jnp.concatenate([jnp.ones(M, bool),
                                 jnp.zeros(NT - M, bool)])
    basis = jnp.where(bad[:, None], aux[None, :], st.basis)
    in_basis = jnp.where(bad[:, None], in_basis1[None, :], st.in_basis)
    atup_def = (~jnp.isfinite(lb)) & jnp.isfinite(ub) & ~in_basis1[None, :]
    at_upper = jnp.where(bad[:, None], atup_def, st.at_upper)
    eyeB = jnp.broadcast_to(eye[None], Binv.shape)
    Binv = jnp.where(bad[:, None, None], eyeB, Binv)
    Brows = jnp.where(bad[:, None, None], eyeB, st.Brows)
    lbB = jnp.where(bad[:, None],
                    jnp.take_along_axis(lb, basis, axis=1), st.lbB)
    ubB = jnp.where(bad[:, None],
                    jnp.take_along_axis(ub, basis, axis=1), st.ubB)
    cB = jnp.where(bad[:, None],
                   jnp.take_along_axis(c, basis, axis=1), st.cB)
    zn2 = jnp.where(in_basis, 0.0, _nb_value(lb, ub, at_upper))
    rhs2 = -sx._e_matmul(A, zn2)
    xb = jnp.where(bad[:, None], rhs2, xb)
    gamma = jnp.where(bad[:, None], jnp.ones((), dtype), st.gamma)
    stall = jnp.where(bad, 0, st.stall)
    # the fresh Binv invalidates every carried cost row (it was rank-1
    # maintained against the drifted product form)
    force = jnp.ones_like(st.force)
    return dataclasses.replace(st, basis=basis, in_basis=in_basis,
                               at_upper=at_upper, Binv=Binv, Brows=Brows,
                               xb=xb, lbB=lbB, ubB=ubB, cB=cB,
                               stall=stall, gamma=gamma, force=force,
                               resets=st.resets + bad.astype(jnp.int32))


@jax.jit
def _rebound_jit(A, c, lb, ub, st):
    """Switch a finished perturbed-bounds solve back to the EXACT
    bounds, keeping the basis/factorization: re-gather the basic bound
    columns, recompute xb from the exact nonbasic values, and resume
    every non-INFEASIBLE instance (stage 2 of the anti-degeneracy
    perturbation — typically a handful of cleanup pivots)."""
    lbB = jnp.take_along_axis(lb, st.basis, axis=1)
    ubB = jnp.take_along_axis(ub, st.basis, axis=1)
    zn = jnp.where(st.in_basis, 0.0, _nb_value(lb, ub, st.at_upper))
    xb = jnp.einsum("bij,bj->bi", st.Binv, -sx._e_matmul(A, zn))
    status = jnp.where(st.status == INFEASIBLE, INFEASIBLE, RUNNING)
    return dataclasses.replace(st, lbB=lbB, ubB=ubB, xb=xb,
                               status=status,
                               stall=jnp.zeros_like(st.stall),
                               force=jnp.ones_like(st.force))


# anti-degeneracy bound perturbation (stage-1 relaxation scale,
# relative): must clearly exceed the dtype feasibility tolerance
# (_tols: 1e-5 f32 / 1e-9 f64) to actually separate degenerate
# vertices.  Fully degenerate instances — e.g. the homogeneous Benson
# LPs, whose RHS is identically 0 so EVERY basis is degenerate — make
# the primal simplex wander plateaus for tens of thousands of pivots
# without this (the ex09 phase-0 grind).
PERT_F32 = 1e-4
PERT_F64 = 1e-7
# cold instances at least this large get the two-stage treatment
PERTURB_MIN_M = 512


def _perturbed_bounds(lb: np.ndarray, ub: np.ndarray, dtype):
    """Deterministic outward perturbation of every finite bound:
    lb - e, ub + e with e = s*(1+|b|)*u, u in [0.5, 1.5) from a fixed
    seed.  Expansion preserves feasibility of the exact problem, and
    INFEASIBLE on the relaxed instance implies INFEASIBLE exactly."""
    s = PERT_F32 if np.dtype(dtype) == np.dtype(np.float32) else PERT_F64
    rng = np.random.default_rng(0x5EED)
    u_lo = rng.random(lb.shape[-1]) + 0.5
    u_hi = rng.random(ub.shape[-1]) + 0.5
    lb1 = np.where(np.isfinite(lb),
                   lb - s * (1.0 + np.abs(lb)) * u_lo, lb)
    ub1 = np.where(np.isfinite(ub),
                   ub + s * (1.0 + np.abs(ub)) * u_hi, ub)
    return lb1.astype(dtype), ub1.astype(dtype)


@functools.partial(jax.jit, static_argnames=("ssharding",))
def _revised_start_jit(A, c, lb, ub, ssharding=None):
    return _initial_rstate(A, c, lb, ub, ssharding=ssharding)


@functools.partial(jax.jit, static_argnames=("ssharding",))
def _revised_start_warm_jit(A, c, lb, ub, basis0, at_upper0, Brows0,
                            ssharding=None):
    return _initial_rstate(A, c, lb, ub, basis0, at_upper0, Brows0,
                           ssharding)


@functools.partial(jax.jit, static_argnames=("seg",))
def _revised_run_jit(A, AT, c, lb, ub, st, seg, max_iter):
    """Advance the pivot loop by at most ``seg`` steps.  Bounding the
    per-program step count keeps each device program short, and the
    host sees progress (step/status) between segments for free.

    ``max_iter`` is TRACED (it only feeds a jnp.minimum): the
    anti-degeneracy stage 2 derives its cleanup cap from the
    data-dependent stage-1 exit step, and a static cap would retrace
    the whole pivot kernel on nearly every cold solve."""
    every = _refactor_interval(A.shape[0], c.shape[1], c.dtype)
    seg_end = jnp.minimum(st.step + seg, max_iter)

    def cond(s):
        return jnp.any(s.status == RUNNING) & (s.step < seg_end)

    def body(s):
        s = _rstep(A, AT, c, lb, ub, st=s)
        # repair non-finite state early (overflowed rank-1 updates); the
        # %16 gate stops a singular-basis livelock from refactorizing
        # every single step until max_iter
        bad = jnp.any((s.status == RUNNING)
                      & ~jnp.all(jnp.isfinite(s.xb), axis=1))
        return jax.lax.cond((s.step % every == 0)
                            | (bad & (s.step % 16 == 0)),
                            lambda t: _refactor(A, c, lb, ub, t),
                            lambda t: t, s)

    return jax.lax.while_loop(cond, body, st)


@jax.jit
def _revised_finish_jit(A, c, lb, ub, st):
    status = jnp.where(st.status == RUNNING, ITLIM, st.status)
    final = sx._State(basis=st.basis, in_basis=st.in_basis,
                      at_upper=st.at_upper, W=None, xb=None, lbB=None,
                      ubB=None, cB=st.cB, status=status, stall=None,
                      iters=st.iters, step=None)
    obj, x, s_act, row_dual, col_dual = sx._final_solutions(
        A, c, lb, ub, final, Bmat=jnp.swapaxes(st.Brows, 1, 2))
    return (status, obj, x, s_act, row_dual, col_dual, st.iters, st.basis,
            st.at_upper)


def _segment_steps(M: int, NT: int, B: int, itemsize: int) -> int:
    """Steps per device program, sized so one segment stays ~10-30 s:
    per-step traffic ~ 4 Binv passes + one A read."""
    per_step = 4 * B * M * M * itemsize + 2 * M * (NT - M) * itemsize
    return int(max(256, min(65536, 6e11 // max(per_step, 1))))


def _solve_revised_segmented(A, AT, c, lb, ub, basis0, at_upper0, Brows0,
                             max_iter, ssharding=None, verbose=0,
                             pert=None):
    """Host-side segment loop around the jitted pivot kernel.  State
    stays on device between segments; only status/step (a few bytes) are
    fetched to decide termination.

    ``pert``: (lb1, ub1) outward-perturbed bounds for the two-stage
    anti-degeneracy solve — stage 1 pivots on the relaxed bounds (all
    vertices distinct), then _rebound_jit restores the exact bounds and
    stage 2 cleans up warm from the stage-1 basis."""
    import time as _time

    lb_run, ub_run = (pert if pert is not None else (lb, ub))
    if basis0 is None:
        st = _revised_start_jit(A, c, lb_run, ub_run, ssharding=ssharding)
    else:
        st = _revised_start_warm_jit(A, c, lb_run, ub_run, basis0,
                                     at_upper0, Brows0, ssharding=ssharding)
    B, NT = c.shape
    seg = _segment_steps(A.shape[0], NT, B, c.dtype.itemsize)
    t0 = _time.perf_counter()
    stage = 1 if pert is not None else 2
    cap = max_iter
    while True:
        st = _revised_run_jit(A, AT, c, lb_run, ub_run, st, seg, cap)
        status = np.asarray(st.status)
        step = int(st.step)
        done = (status != RUNNING).all() or step >= cap
        if verbose >= 2:
            dt = _time.perf_counter() - t0
            n_run = int((status == RUNNING).sum())
            obj = float(np.asarray(
                jnp.sum(st.cB[0] * st.xb[0])))   # basic-part objective
            stall = int(np.asarray(st.stall[0]))
            resets = int(np.asarray(st.resets[0]))
            nbs = int(np.asarray((st.basis[0] >= A.shape[0]).sum()))
            print(f"lp_solve[revised]: step={step} running={n_run}/{B} "
                  f"{step / max(dt, 1e-9):.0f} steps/s "
                  f"obj0~{obj:.6g} stall0={stall} resets0={resets} "
                  f"nbstruct0={nbs}"
                  f"{' [perturbed]' if stage == 1 else ''}", flush=True)
        if done:
            if stage == 1:
                stage = 2
                lb_run, ub_run = lb, ub
                st = _rebound_jit(A, c, lb, ub, st)
                # cleanup budget: warm re-verification is short
                cap = step + max(2 * A.shape[0], 2000)
                continue
            break
    return _revised_finish_jit(A, c, lb_run, ub_run, st)


def _host_brows(prep: sx._PreparedA, b0: np.ndarray, dtype) -> np.ndarray:
    """Basis-column rows for a warm start, built on HOST: out[b, k, :] =
    E[:, b0[b, k]] with E = [I | -A_padded].  Row/column indices use the
    padded numbering (rows 0..Mp-1, structurals Mp..Mp+Np-1)."""
    Mp = prep.Mp
    b2 = np.atleast_2d(np.asarray(b0))
    B, M = b2.shape
    out = np.zeros((B, Mp, Mp), dtype)
    aux = b2 < Mp
    bi, ki = np.nonzero(aux)
    out[bi, ki, b2[aux]] = 1.0
    bi, ki = np.nonzero(~aux)
    if bi.size:
        out[bi, ki, :] = -prep.host[:, b2[~aux] - Mp].T
    return out


# N/M ratio above which solve_batch should route here: the tableau
# carries (M+N)/M times more state than the basis inverse
REVISED_RATIO = 4


@dataclasses.dataclass
class _ScaledA:
    """Equilibrated matrix (the glp_scale_prob role): A' = R A C with
    power-of-two scales, so scaling is EXACT in floating point.  Badly
    scaled instances (ex09 spans ~150x, radiotherapy/financial data
    generally worse) are what break float32 pivoting."""

    A: object           # original (cache identity)
    prep: sx._PreparedA
    rscale: np.ndarray  # (M,)
    cscale: np.ndarray  # (N,)


_S_CACHE: "dict" = {}


def _pow2(x: np.ndarray) -> np.ndarray:
    return np.exp2(np.round(np.log2(np.maximum(x, 1e-30))))


def _prepare_scaled(A, dtype) -> _ScaledA:
    if isinstance(A, _ScaledA):
        return A
    key = (id(A), np.dtype(dtype).str)
    hit = _S_CACHE.get(key)
    if hit is not None and hit.A is A:
        return hit
    arr = np.asarray(A, np.float64)
    absA = np.abs(arr)
    r = _pow2(1.0 / np.maximum(absA.max(axis=1), 1e-12))
    cvec = _pow2(1.0 / np.maximum((absA * r[:, None]).max(axis=0), 1e-12))
    As = arr * r[:, None] * cvec[None, :]
    prep = sx._prepare_A(np.asarray(As, dtype), dtype)
    scaled = _ScaledA(A if isinstance(A, np.ndarray) else arr, prep,
                      r, cvec)
    if len(_S_CACHE) > 8:
        _S_CACHE.clear()
    _S_CACHE[key] = scaled
    return scaled


def _mesh_shardings(mesh):
    """(A, AT, batch, state) NamedShardings for a ("dp"|"tp") mesh: "tp"
    shards A's columns / AT's rows and the minor axis of the per-instance
    Binv/Brows panels; "dp" shards the batch."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    names = mesh.axis_names
    dp = "dp" if "dp" in names else None
    tp = "tp" if "tp" in names else None
    return (NamedSharding(mesh, P(None, tp)),
            NamedSharding(mesh, P(tp, None)),
            NamedSharding(mesh, P(dp, None)),
            NamedSharding(mesh, P(dp, None, tp)))


def solve_batch_revised(A, c, row_lb, row_ub, col_lb, col_ub, *,
                        max_iter: int | None = None, dtype=np.float64,
                        start_basis=None, max_chunk: int | None = None,
                        scale: bool = True, mesh=None,
                        verbose: int = 0) -> LPResult:
    """Drop-in alternative to simplex.solve_batch for N >> M (same
    padding, chunking, and warm-start contract).  ``scale`` runs the
    solve on the equilibrated problem (exact power-of-two scales) and
    returns unscaled solutions; basis indices and bound patterns are
    scale-invariant, so warm starts pass straight through.

    ``mesh``: multi-chip execution (Options.mesh_axes): a "tp" axis
    shards A / A^T and the (B, M, M) basis-inverse panels — the TP path
    for ex09-scale single LPs (SURVEY.md section 2.2); a "dp" axis
    shards the batch."""
    if scale and not isinstance(A, (sx._PreparedA, _ScaledA)):
        sc = _prepare_scaled(A, dtype)
        r, cv = sc.rscale, sc.cscale
        res = solve_batch_revised(
            sc.prep, np.atleast_2d(np.asarray(c)) * cv[None, :],
            np.asarray(row_lb) * r[None, :], np.asarray(row_ub) * r[None, :],
            np.asarray(col_lb) / cv[None, :], np.asarray(col_ub) / cv[None, :],
            max_iter=max_iter, dtype=dtype, start_basis=start_basis,
            max_chunk=max_chunk, scale=False, mesh=mesh, verbose=verbose)
        return LPResult(res.status, res.obj, res.x * cv[None, :],
                        res.s / r[None, :], res.row_dual * r[None, :],
                        res.col_dual / cv[None, :], res.iters,
                        res.basis, res.at_upper)
    prep = sx._prepare_A(A, dtype)
    M, N, Mp, Np = prep.M, prep.N, prep.Mp, prep.Np
    if max_chunk is None:
        # Binv dominates: (B, M, M) + shared A
        per = (M + 8) * (M + 8) * np.dtype(dtype).itemsize * 3
        cap = max(1, int(sx.TABLEAU_BYTES_BUDGET // per))
        max_chunk = min(sx.MAX_CHUNK, 1 << (cap.bit_length() - 1))
    c2 = np.atleast_2d(np.asarray(c))
    if c2.shape[0] > max_chunk:
        parts = []
        for s in range(0, c2.shape[0], max_chunk):
            sl = slice(s, s + max_chunk)
            parts.append(solve_batch_revised(
                prep, c2[sl], np.asarray(row_lb)[sl], np.asarray(row_ub)[sl],
                np.asarray(col_lb)[sl], np.asarray(col_ub)[sl],
                max_iter=max_iter, dtype=dtype,
                start_basis=sx._slice_warm(start_basis, sl),
                max_chunk=max_chunk, mesh=mesh, verbose=verbose))
        return sx.concat_results(parts)

    B = c2.shape[0]
    Bp = sx._bucket_batch(B, Mp)
    ssharding = None
    A_dev, AT_dev = prep.dev, None
    put = jnp.asarray
    if mesh is not None:
        import jax as _jax

        shA, shAT, shB, ssharding = _mesh_shardings(mesh)
        if "dp" in mesh.axis_names:
            dp_size = mesh.shape["dp"]
            while Bp % dp_size:
                Bp *= 2
        A_dev = _jax.device_put(prep.host, shA)
        AT_dev = _jax.device_put(np.ascontiguousarray(prep.host.T), shAT)
        put = functools.partial(_jax.device_put, device=shB)
    if AT_dev is None:
        AT_dev = prep.transposed()
    if max_iter is None:
        # the generic shape-derived cap, bounded for huge-N instances
        # (ex09: 50*(Mp+Np) ~ 2.3M steps would run for days at ~ms/step;
        # real solves of well-scaled problems take O(M) pivots)
        max_iter = min(50 * (Mp + Np) + 500, 40 * Mp + 20000)
    full_c, lb, ub = sx._pad_batch_inputs(prep, c2, row_lb, row_ub,
                                          col_lb, col_ub, Bp, dtype)

    if start_basis is None:
        pert = None
        if Mp >= PERTURB_MIN_M:
            lb1, ub1 = _perturbed_bounds(lb, ub, dtype)
            pert = (put(lb1), put(ub1))
        out = _solve_revised_segmented(
            A_dev, AT_dev, put(full_c), put(lb), put(ub),
            None, None, None, max_iter, ssharding, verbose=verbose,
            pert=pert)
    else:
        b0, u0 = sx._pad_warm(start_basis, Mp, Mp + Np, B, Bp)
        brows0 = _host_brows(prep, b0, dtype)   # (1 or Bp, Mp, Mp)
        out = _solve_revised_segmented(
            A_dev, AT_dev, put(full_c), put(lb), put(ub),
            jnp.asarray(b0), jnp.asarray(u0), jnp.asarray(brows0),
            max_iter, ssharding, verbose=verbose)
    (status, obj, x, s, row_dual, col_dual, iters, basis, at_upper) = (
        np.asarray(o) for o in out)
    return LPResult(status[:B], obj[:B], x[:B, :N], s[:B, :M],
                    row_dual[:B, :M], col_dual[:B, :N], iters[:B],
                    basis[:B], at_upper[:B])
