"""Batched bounded-variable DUAL simplex (tableau form).

The reference maps -k/-L/-l onto GLPK's primal/dual simplex with a
dual->primal retry (bslv_lp.c:153-217, GLP_DUALP at :190-192, retry in
lp_solve :219-259).  This module is the batched device counterpart: the
same lockstep tableau state as lp/simplex.py, but pivots chosen by the
dual rules — leaving row first (most primal-infeasible basic), entering
column by the dual ratio test that preserves sign-feasible reduced
costs.

Why it exists beyond CLI fidelity: Benson phase-2 re-solves change ONLY
row bounds (the P2 template's extra-row ubs, bslv_algs.c:871-875).  A
previous optimum's basis therefore stays DUAL feasible, and the dual
simplex warm-started from it walks straight back to optimality, usually
in a handful of pivots — the principled warm-start story.

Instances whose starting basis is NOT dual feasible finish with status
DUAL_LOST; ``solve_batch_dual`` then re-solves exactly those with the
primal solver from the same basis (the batched GLP_DUALP fallback).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from bensolve_tpu.lp import simplex as sx
from bensolve_tpu.lp.simplex import (BLAND_AFTER, DUAL_LOST, INFEASIBLE,
                                     ITLIM, OPTIMAL, RUNNING, LPResult,
                                     _nb_value, _tols)


def _dstep(A, c, lb, ub, st: sx._State) -> sx._State:
    TOL_BND, TOL_DJ, TOL_PIV = _tols(c.dtype)
    B, NT = c.shape
    M = A.shape[-2]
    batch = jnp.arange(B)
    running = st.status == RUNNING

    # --- leaving row: most primal-infeasible basic variable -----------
    below = st.xb < st.lbB - TOL_BND
    above = st.xb > st.ubB + TOL_BND
    viol = jnp.where(below, st.lbB - st.xb,
                     jnp.where(above, st.xb - st.ubB, 0.0))
    feasible = ~jnp.any(viol > 0, axis=1)

    use_bland = st.stall > BLAND_AFTER
    basis_f = st.basis.astype(c.dtype)
    dantzig_r = jnp.where(viol > 0, viol, -jnp.inf)
    bland_r = jnp.where(viol > 0, -basis_f, -jnp.inf)
    r_idx = jnp.argmax(jnp.where(use_bland[:, None], bland_r, dantzig_r),
                       axis=1)
    r_below = jnp.take_along_axis(below, r_idx[:, None], axis=1)[:, 0]

    # --- reduced costs (fresh pricing, like the primal solver) --------
    d = c - jnp.einsum("bm,bmn->bn", st.cB, st.W)

    # --- entering column: dual ratio test on row r ---------------------
    alpha_row = jnp.take_along_axis(
        st.W, r_idx[:, None, None], axis=1)[:, 0, :]               # (B, NT)
    val = _nb_value(lb, ub, st.at_upper)
    can_inc = (~st.in_basis) & (val < ub)
    can_dec = (~st.in_basis) & (val > lb)
    elig = jnp.where(
        r_below[:, None],
        (can_inc & (alpha_row < -TOL_PIV)) | (can_dec & (alpha_row > TOL_PIV)),
        (can_inc & (alpha_row > TOL_PIV)) | (can_dec & (alpha_row < -TOL_PIV)))
    ratio = jnp.where(elig, jnp.abs(d) / jnp.abs(alpha_row), jnp.inf)
    rmin = jnp.min(ratio, axis=1)
    near = elig & (ratio <= rmin[:, None] + TOL_DJ)
    stab = jnp.where(near, jnp.abs(alpha_row), -1.0)
    bland_q = jnp.where(near, -jnp.arange(NT, dtype=c.dtype), -jnp.inf)
    q_idx = jnp.argmax(jnp.where(use_bland[:, None], bland_q, stab), axis=1)
    has_entering = jnp.any(elig, axis=1)

    # --- statuses -------------------------------------------------------
    new_status = jnp.where(running & feasible, OPTIMAL, st.status)
    # dual unbounded == primal infeasible (no column can absorb row r)
    new_status = jnp.where(running & ~feasible & ~has_entering,
                           INFEASIBLE, new_status)
    act = running & ~feasible & has_entering

    # --- pivot ----------------------------------------------------------
    alpha_col = jnp.take_along_axis(
        st.W, q_idx[:, None, None], axis=2)[:, :, 0]               # (B, M)
    alpha_rq = jnp.take_along_axis(alpha_row, q_idx[:, None], axis=1)[:, 0]
    alpha_rq = jnp.where(jnp.abs(alpha_rq) < TOL_PIV,
                         jnp.where(alpha_rq < 0, -TOL_PIV, TOL_PIV),
                         alpha_rq)
    lbB_r = jnp.take_along_axis(st.lbB, r_idx[:, None], axis=1)[:, 0]
    ubB_r = jnp.take_along_axis(st.ubB, r_idx[:, None], axis=1)[:, 0]
    xb_r = jnp.take_along_axis(st.xb, r_idx[:, None], axis=1)[:, 0]
    target = jnp.where(r_below, lbB_r, ubB_r)
    dx_q = jnp.where(act, (xb_r - target) / alpha_rq, 0.0)

    val_q = jnp.take_along_axis(val, q_idx[:, None], axis=1)[:, 0]
    xq_new = val_q + dx_q
    xb_new = st.xb - dx_q[:, None] * alpha_col
    xb_new = jnp.where(act[:, None],
                       xb_new.at[batch, r_idx].set(xq_new), st.xb)

    # rank-1 tableau update, fused exactly like the primal pivot
    w_r = jnp.take_along_axis(st.W, r_idx[:, None, None], axis=1)[:, 0, :]
    w_r_scaled = w_r / alpha_rq[:, None]
    coef = alpha_col.at[batch, r_idx].add(-1.0)
    coef = jnp.where(act[:, None], coef, 0.0)
    W_new = st.W - coef[:, :, None] * w_r_scaled[:, None, :]

    leaving = jnp.take_along_axis(st.basis, r_idx[:, None], axis=1)[:, 0]
    basis_upd = st.basis.at[batch, r_idx].set(q_idx.astype(jnp.int32))
    basis_new = jnp.where(act[:, None], basis_upd, st.basis)

    lb_q = jnp.take_along_axis(lb, q_idx[:, None], axis=1)[:, 0]
    ub_q = jnp.take_along_axis(ub, q_idx[:, None], axis=1)[:, 0]
    cB_q = jnp.take_along_axis(c, q_idx[:, None], axis=1)[:, 0]
    lbB_new = jnp.where(act[:, None],
                        st.lbB.at[batch, r_idx].set(lb_q), st.lbB)
    ubB_new = jnp.where(act[:, None],
                        st.ubB.at[batch, r_idx].set(ub_q), st.ubB)
    cB_new = jnp.where(act[:, None],
                       st.cB.at[batch, r_idx].set(cB_q), st.cB)

    in_basis_upd = st.in_basis.at[batch, q_idx].set(True)
    in_basis_upd = in_basis_upd.at[batch, leaving].set(False)
    in_basis_new = jnp.where(act[:, None], in_basis_upd, st.in_basis)

    # leaving variable rests at the bound it was pushed to
    at_upper_upd = st.at_upper.at[batch, leaving].set(~r_below)
    at_upper_new = jnp.where(act[:, None], at_upper_upd, st.at_upper)

    degen = act & (jnp.abs(dx_q) < TOL_BND)
    stall_new = jnp.where(act, jnp.where(degen, st.stall + 1, 0), st.stall)
    iters_new = st.iters + act.astype(jnp.int32)

    return sx._State(basis_new, in_basis_new, at_upper_new, W_new, xb_new,
                     lbB_new, ubB_new, cB_new,
                     new_status, stall_new, iters_new, st.step + 1,
                     st.gamma)   # devex weights unused by the dual rules


def _dual_feasible_mask(A, c, lb, ub, st) -> jnp.ndarray:
    """(B,) True where the starting basis is sign-feasible in the duals:
    at-lb nonbasics need d >= -tol, at-ub need d <= tol, free nonbasics
    need |d| <= tol."""
    _, TOL_DJ, _ = _tols(c.dtype)
    d = c - jnp.einsum("bm,bmn->bn", st.cB, st.W)
    val = _nb_value(lb, ub, st.at_upper)
    nonb = ~st.in_basis
    at_lb = nonb & ~st.at_upper & jnp.isfinite(lb)
    at_ub = nonb & st.at_upper & jnp.isfinite(ub)
    free = nonb & ~jnp.isfinite(lb) & ~jnp.isfinite(ub)
    fixed = nonb & (lb == ub)
    bad = (at_lb & ~fixed & (d < -TOL_DJ)) | (at_ub & ~fixed & (d > TOL_DJ)) \
        | (free & (jnp.abs(d) > TOL_DJ))
    return ~jnp.any(bad, axis=1)


@jax.jit
def _dual_start_jit(A, c, lb, ub, basis0, at_upper0):
    st = sx._initial_state(A, c, lb, ub, basis0, at_upper0)
    ok = _dual_feasible_mask(A, c, lb, ub, st)
    return dataclasses.replace(
        st, status=jnp.where((st.status == RUNNING) & ~ok,
                             DUAL_LOST, st.status))


@jax.jit
def _dual_start_from_state_jit(A, c, lb, ub, basis_s, in_basis_s,
                               at_upper_s, W_s, idx):
    st = sx._tableau_start_from_state_jit(A, c, lb, ub, basis_s,
                                          in_basis_s, at_upper_s, W_s,
                                          idx)
    ok = _dual_feasible_mask(A, c, lb, ub, st)
    return dataclasses.replace(
        st, status=jnp.where((st.status == RUNNING) & ~ok,
                             DUAL_LOST, st.status))


@functools.partial(jax.jit, static_argnames=("seg",))
def _dual_run_jit(A, c, lb, ub, st, seg, max_iter):
    """Advance the dual pivot loop by at most ``seg`` steps — same
    segmentation contract as simplex._tableau_run_jit (short device
    programs, progress visible to the host between segments)."""
    seg_end = jnp.minimum(st.step + seg, max_iter)

    def cond(s):
        return jnp.any(s.status == RUNNING) & (s.step < seg_end)

    return jax.lax.while_loop(cond, lambda s: _dstep(A, c, lb, ub, st=s), st)


def _solve_dual_segmented(A, c, lb, ub, basis0, at_upper0, max_iter,
                          state_warm=None, keep_state=False):
    """``state_warm``: (KeptState, idx (Bp,)) — gather-based warm start
    from a previous solve's kept tableau (no factorizations).
    ``keep_state``: also return the final state as a KeptState for the
    NEXT round; age accounts for the carried rank-1 drift."""
    age0 = 0
    if state_warm is not None:
        ks, idx = state_warm
        age0 = ks.age
        st = _dual_start_from_state_jit(A, c, lb, ub, ks.basis,
                                        ks.in_basis, ks.at_upper, ks.W,
                                        jnp.asarray(idx, jnp.int32))
    else:
        st = _dual_start_jit(A, c, lb, ub, basis0, at_upper0)
    B, NT = c.shape
    M = A.shape[-2]
    seg = sx._tableau_segment_steps(B, M, NT, np.dtype(c.dtype).itemsize)
    while True:
        st = _dual_run_jit(A, c, lb, ub, st, seg, max_iter)
        status = np.asarray(st.status)
        if (status != RUNNING).all() or int(st.step) >= max_iter:
            break
    max_piv = int(np.asarray(st.iters).max())
    # drift carried by the state's W: the inherited chain age plus this
    # solve's pivots (a start WITHOUT state_warm began from an exact
    # LU or from E itself, so its chain starts at max_piv)
    age = (age0 + max_piv) if state_warm is not None else max_piv
    cap = (sx.STATE_WARM_MAX_AGE
           if c.dtype == jnp.float64 else sx.STATE_WARM_MAX_AGE // 4)
    # LU-free finish only when the whole batch terminated OPTIMAL and
    # the warm chain's accumulated drift stays within the cap; anything
    # else gets the refactorized (exact) finish
    if (state_warm is not None and age <= cap
            and (status == OPTIMAL).all()):
        out = sx._tableau_cheap_finish_jit(A, c, lb, ub, st)
    else:
        out = sx._tableau_finish_jit(A, c, lb, ub, st)
    kept = sx._keep_state(st, age) if keep_state else None
    return out, kept


def solve_batch_dual(A, c, row_lb, row_ub, col_lb, col_ub, *,
                     max_iter: int | None = None, dtype=np.float64,
                     start_basis=None, max_chunk: int | None = None,
                     retry_primal: bool = True, start_state=None,
                     keep_state: bool = False):
    """Dual simplex over the batch; instances whose start basis is not
    dual feasible (or that hit the iteration cap, when ``retry_primal``)
    are re-solved with the primal solver from the same basis — the
    batched equivalent of GLPK's GLP_DUALP dual->primal fallback
    (bslv_lp.c:190-192, 219-259).

    ``start_state``: (KeptState, idx (B,)) — warm start by gathering
    parent rows of a previous solve's kept device tableau, eliminating
    BOTH batched LUs of the warm path (see simplex.KeptState).
    ``keep_state``: return ``(LPResult, KeptState | None)`` so the
    caller can chain the next round's warm start; the kept state is
    dropped (None) when any instance took the primal retry (its rows
    would not describe the returned solution).

    Batches larger than ``max_chunk`` (default: the largest power-of-two
    batch whose (B, M, M+N) tableau fits TABLEAU_BYTES_BUDGET, same rule
    as the primal tableau path) are processed in fixed-size chunks, so a
    large frontier under -l dual_simplex keeps bounded device memory and
    reuses one compiled shape."""
    prep = sx._prepare_A(A, dtype)
    M, N, Mp, Np = prep.M, prep.N, prep.Mp, prep.Np
    if max_chunk is None:
        max_chunk = sx._auto_chunk(M, N, np.dtype(dtype).itemsize)
    c2 = np.atleast_2d(np.asarray(c))
    if c2.shape[0] > max_chunk:
        parts, keeps = [], []
        for s in range(0, c2.shape[0], max_chunk):
            sl = slice(s, s + max_chunk)
            sub_state = (None if start_state is None else
                         (start_state[0],
                          np.asarray(start_state[1])[sl]))
            out = solve_batch_dual(
                prep, c2[sl], np.asarray(row_lb)[sl], np.asarray(row_ub)[sl],
                np.asarray(col_lb)[sl], np.asarray(col_ub)[sl],
                max_iter=max_iter, dtype=dtype,
                start_basis=sx._slice_warm(start_basis, sl),
                max_chunk=max_chunk, retry_primal=retry_primal,
                start_state=sub_state, keep_state=keep_state)
            if keep_state:
                out, kept_i = out
                keeps.append(kept_i)
            parts.append(out)
        res = sx.concat_results(parts)
        if keep_state:
            kept = (sx._concat_kept(keeps)
                    if all(k is not None for k in keeps) else None)
            return res, kept
        return res
    B = c2.shape[0]
    Bp = sx._bucket_batch(B, Mp)
    if max_iter is None:
        max_iter = 50 * (Mp + Np) + 500
    full_c, lb, ub = sx._pad_batch_inputs(prep, c2, row_lb, row_ub,
                                          col_lb, col_ub, Bp, dtype)
    state_warm = None
    b0 = u0 = None
    if start_state is not None:
        ks, sidx = start_state
        sidx = np.asarray(sidx, np.int32).reshape(-1)
        if (ks is not None and ks.W.shape[-1] == Mp + Np
                and ks.W.shape[-2] == Mp and sidx.size == B):
            pad_idx = np.zeros(Bp, np.int32)
            pad_idx[:B] = sidx
            if Bp > B > 0:
                pad_idx[B:] = sidx[0]
            state_warm = (ks, pad_idx)
    if state_warm is None:
        if start_basis is None:
            # the all-slack basis is dual feasible only for c <= 0 on
            # structurals; DUAL_LOST instances fall back below
            b0 = np.arange(Mp, dtype=np.int32)
            u0 = np.zeros(Mp + Np, bool)
        else:
            b0, u0 = sx._pad_warm(start_basis, Mp, Mp + Np, B, Bp)
        b0 = jnp.asarray(b0, jnp.int32)
        u0 = jnp.asarray(u0, bool)
    out, kept = _solve_dual_segmented(
        prep.dev, jnp.asarray(full_c), jnp.asarray(lb), jnp.asarray(ub),
        b0, u0, max_iter, state_warm=state_warm, keep_state=keep_state)
    if kept is not None and Bp != B:
        # drop padding rows so row i of the kept state is row i of the
        # caller's batch (chunk concatenation relies on this)
        kept = sx.KeptState(kept.basis[:B], kept.in_basis[:B],
                            kept.at_upper[:B], kept.W[:B], kept.age)
    (status, obj, x, s, row_dual, col_dual, iters, basis, at_upper) = (
        np.asarray(o) for o in out)
    res = LPResult(status[:B], obj[:B], x[:B, :N], s[:B, :M],
                   row_dual[:B, :M], col_dual[:B, :N], iters[:B],
                   basis[:B], at_upper[:B])
    retry = (res.status == DUAL_LOST) | (res.status == ITLIM)
    if retry_primal and retry.any():
        idx = np.flatnonzero(retry)
        pri = sx.solve_batch(
            prep, c2[idx], np.asarray(row_lb)[idx], np.asarray(row_ub)[idx],
            np.asarray(col_lb)[idx], np.asarray(col_ub)[idx],
            max_iter=max_iter, dtype=dtype,
            start_basis=(res.basis[idx], res.at_upper[idx]),
            max_chunk=max_chunk)
        merged = {}
        for f in dataclasses.fields(LPResult):
            dst = getattr(res, f.name)
            src = getattr(pri, f.name)
            if dst is not None and src is not None:
                dst = np.array(dst)   # jax outputs are read-only views
                dst[idx] = src
            merged[f.name] = dst
        res = LPResult(**merged)
        kept = None   # kept rows no longer describe the returned result
    if keep_state:
        return res, kept
    return res
