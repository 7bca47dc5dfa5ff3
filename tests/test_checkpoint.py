"""Round-level checkpoint / resume (batched-build subsystem; the reference
has none, SURVEY.md section 5)."""

import numpy as np

from bensolve_tpu import examples
from bensolve_tpu.algs.driver import solve
from bensolve_tpu.algs.solution import SolStatus
from bensolve_tpu.vlp.options import Alg, Options


def _vset(r):
    return sorted(map(tuple, np.round(r.primal_points, 8)))


def test_checkpoint_resume_matches(tmp_path):
    ck = str(tmp_path / "st.ckpt")
    vlp = examples.load("ex05")
    r1 = solve(vlp, Options(checkpoint_path=ck))
    assert r1.status is SolStatus.OPTIMAL
    r2 = solve(vlp, Options(), resume=ck)
    assert r2.status is SolStatus.OPTIMAL
    assert _vset(r1) == _vset(r2)


def test_phase1_checkpoint_resume(tmp_path, monkeypatch):
    """Phase-1 rounds are checkpointable too: simulate a crash right
    after the first phase-1 snapshot and resume from it."""
    import pytest

    from bensolve_tpu.io import checkpoint as ckpt

    ck = str(tmp_path / "p1.ckpt")
    vlp = examples.load("ex05")
    ref = solve(vlp, Options())

    real = ckpt.save_checkpoint
    state = {"crashed": False}

    def crash_after_first_phase1(path, **kw):
        real(path, **kw)
        if kw["phase"].startswith("phase1"):
            state["crashed"] = True
            raise RuntimeError("simulated crash")

    monkeypatch.setattr(ckpt, "save_checkpoint", crash_after_first_phase1)
    with pytest.raises(RuntimeError, match="simulated crash"):
        solve(vlp, Options(checkpoint_path=ck, checkpoint_every=1))
    assert state["crashed"]
    monkeypatch.setattr(ckpt, "save_checkpoint", real)

    r2 = solve(vlp, Options(), resume=ck)
    assert r2.status is SolStatus.OPTIMAL
    assert _vset(r2) == _vset(ref)


def test_checkpoint_resume_dual_alg(tmp_path):
    ck = str(tmp_path / "st.ckpt")
    vlp = examples.load("ex01")
    r1 = solve(vlp, Options(checkpoint_path=ck, alg_phase1=Alg.DUAL,
                            alg_phase2=Alg.DUAL))
    assert r1.status is SolStatus.OPTIMAL
    r2 = solve(vlp, Options(alg_phase2=Alg.DUAL), resume=ck)
    assert r2.status is SolStatus.OPTIMAL
    assert _vset(r1) == _vset(r2)
