"""LP solution-quality surfacing and the Benson loop's loose-LP
contract (VERDICT r4 item 3; reference exactness contract
bslv_lp.c:219-259):

* LPResult.quality: the IPM reports measured per-instance quality
  (0 clean / 1 salvaged / 2 loose); the simplex family reports None
  (exact basic solutions).
* The Benson primal loop DEFERS quality==2 results (retrying the
  candidate in a later round) instead of cutting with ~1e-2-error
  duals, and accepts only after the retry budget — planted loose
  flags must leave the final vertex set unchanged.
* Segmented tableau/dual-simplex device loops return identical results
  to the single-program form.
"""

import numpy as np

from bensolve_tpu.lp import simplex as sx
from bensolve_tpu.lp.ipm import solve_batch_ipm
from tests.test_e2e import run
from tests.test_ipm import random_lp


def test_ipm_reports_quality():
    A, c, rlb, rub, clb, cub = random_lp(12, 18, 4, seed=3)
    res = solve_batch_ipm(A, c, rlb, rub, clb, cub, dtype=np.float64)
    assert res.quality is not None
    assert res.quality.shape == (4,)
    # a clean, well-conditioned f64 solve must measure clean
    assert (res.status == sx.OPTIMAL).all()
    assert (res.quality == 0).all()


def test_simplex_quality_is_none_and_concat_safe():
    A, c, rlb, rub, clb, cub = random_lp(8, 10, 6, seed=5)
    # max_chunk forces the chunked concat path over the None quality
    res = sx.solve_batch(A, c, rlb, rub, clb, cub, max_chunk=2)
    assert res.quality is None
    assert res.status.shape == (6,)


def test_tableau_segmented_matches_single_program(monkeypatch):
    A, c, rlb, rub, clb, cub = random_lp(10, 14, 5, seed=7)
    ref = sx.solve_batch(A, c, rlb, rub, clb, cub)
    # force tiny segments: many host round-trips, same pivots
    monkeypatch.setattr(sx, "_tableau_segment_steps",
                        lambda *a, **k: 3)
    seg = sx.solve_batch(A, c, rlb, rub, clb, cub)
    np.testing.assert_array_equal(ref.status, seg.status)
    np.testing.assert_allclose(ref.obj, seg.obj, rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(ref.iters, seg.iters)


def test_dual_simplex_segmented_matches(monkeypatch):
    from bensolve_tpu.lp import dual_simplex as dsx

    A, c, rlb, rub, clb, cub = random_lp(10, 14, 5, seed=11)
    ref = dsx.solve_batch_dual(A, c, rlb, rub, clb, cub)
    monkeypatch.setattr(sx, "_tableau_segment_steps",
                        lambda *a, **k: 3)
    seg = dsx.solve_batch_dual(A, c, rlb, rub, clb, cub)
    np.testing.assert_array_equal(ref.status, seg.status)
    np.testing.assert_allclose(ref.obj, seg.obj, rtol=1e-12, atol=1e-12)


def _solve_with_planted_loose(ex, n_loose_rounds):
    """Solve ``ex`` with the first ``n_loose_rounds`` template solves
    flagged quality=2 (results themselves stay exact), returning the
    result object.  Exercises defer-and-retry (round later resolves
    clean) and forced acceptance (flag persists past the retry
    budget)."""
    from bensolve_tpu.algs import templates

    orig = templates._TemplateBase._run
    state = {"n": 0}

    def wrapped(self, *a, **k):
        res = orig(self, *a, **k)
        state["n"] += 1
        if state["n"] <= n_loose_rounds:
            q = np.zeros(res.status.shape[0], np.int32)
            q[:] = 2
            res = type(res)(**{**res.__dict__, "quality": q})
        return res

    templates._TemplateBase._run = wrapped
    try:
        return run(ex, write_files=False)
    finally:
        templates._TemplateBase._run = orig


def test_loose_lps_ordered_last_vertex_set_unchanged():
    """A Benson round whose LPs come back loose must not corrupt the
    final vertex set: loose results are applied AFTER the round's clean
    cuts (never re-solved — the LP is deterministic), counted via
    stats.loose_cuts, and the solution matches the unplanted run."""
    clean = run("ex05", write_files=False)
    # the count covers phase 0's probes and the phase-1 init (quality
    # is ignored there) plus the first Benson-loop rounds
    planted = _solve_with_planted_loose("ex05", n_loose_rounds=8)
    assert planted.status is clean.status
    # vertex sets equal as unordered sets within the reference epsilon
    a = np.asarray(clean.primal_points)
    b = np.asarray(planted.primal_points)
    assert a.shape == b.shape
    for row in a:
        assert np.min(np.abs(b - row).sum(axis=1)) < 1e-6
    assert planted.stats.loose_cuts > 0


def test_loose_lps_always_loose_still_solves():
    """With EVERY LP flagged loose the loop must still terminate with
    the correct vertex set (the results are exact underneath) and
    report how many cuts rode loose LPs."""
    planted = _solve_with_planted_loose("ex05", n_loose_rounds=10**6)
    clean = run("ex05", write_files=False)
    assert planted.status is clean.status
    a = np.asarray(clean.primal_points)
    b = np.asarray(planted.primal_points)
    assert a.shape == b.shape
    for row in a:
        assert np.min(np.abs(b - row).sum(axis=1)) < 1e-6
    assert planted.stats.loose_cuts > 0
