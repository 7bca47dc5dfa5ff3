"""The LP router (lp.solve_batch_auto) and the compile-cache setup
(lp.ensure_compile_cache)."""

import os

import jax
import numpy as np
import pytest

from bensolve_tpu import lp
from bensolve_tpu.lp import revised
from bensolve_tpu.lp import simplex as sx
from bensolve_tpu.oracle import highs_lp
from tests.test_ipm import random_lp


def _spy(monkeypatch, module, name):
    calls = []
    real = getattr(module, name)

    def wrapped(*a, **kw):
        calls.append(kw.get("dtype"))
        return real(*a, **kw)

    monkeypatch.setattr(module, name, wrapped)
    return calls


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_square_batch_routes_to_xla_tableau(monkeypatch, dtype):
    """Square-ish batches, float32 included, go to the XLA lockstep
    tableau and agree with HiGHS."""
    monkeypatch.delenv("BENSOLVE_IPM_MIN", raising=False)
    tableau = _spy(monkeypatch, sx, "solve_batch")
    rev = _spy(monkeypatch, revised, "solve_batch_revised")
    A, c, rlb, rub, clb, cub = random_lp(8, 10, 3, seed=5)
    res = lp.solve_batch_auto(A.astype(dtype), c, rlb, rub, clb, cub,
                              dtype=dtype)
    assert tableau == [dtype] and rev == []
    assert (res.status == sx.OPTIMAL).all()
    tol = 1e-7 if dtype == np.float64 else 1e-4
    for i in range(3):
        ref = highs_lp(A.astype(dtype), c[i], rlb[i], rub[i], clb[i],
                       cub[i])
        assert abs(res.obj[i] - ref.fun) <= tol * (1 + abs(ref.fun))


def test_tall_batch_routes_to_revised(monkeypatch):
    monkeypatch.delenv("BENSOLVE_IPM_MIN", raising=False)
    tableau = _spy(monkeypatch, sx, "solve_batch")
    rev = _spy(monkeypatch, revised, "solve_batch_revised")
    M = 4
    A, c, rlb, rub, clb, cub = random_lp(M, revised.REVISED_RATIO * M, 2,
                                         seed=6)
    res = lp.solve_batch_auto(A, c, rlb, rub, clb, cub)
    assert rev and tableau == []
    assert (res.status == sx.OPTIMAL).all()


def test_ipm_route_is_opt_in(monkeypatch):
    from bensolve_tpu.lp import ipm

    calls = _spy(monkeypatch, ipm, "solve_batch_ipm")
    A, c, rlb, rub, clb, cub = random_lp(6, 8, 2, seed=7)
    monkeypatch.delenv("BENSOLVE_IPM_MIN", raising=False)
    lp.solve_batch_auto(A, c, rlb, rub, clb, cub)
    assert calls == []
    res = lp.solve_batch_auto(A, c, rlb, rub, clb, cub, ipm_min=10)
    assert len(calls) == 1 and res.quality is not None


@pytest.fixture
def cache_config():
    """Restore jax's compile-cache settings after the test."""
    keys = ("jax_compilation_cache_dir",
            "jax_persistent_cache_min_compile_time_secs")
    old = {k: getattr(jax.config, k) for k in keys}
    yield
    for k, v in old.items():
        jax.config.update(k, v)


def test_compile_cache_default_in_checkout(monkeypatch, cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    jax.config.update("jax_compilation_cache_dir", None)
    lp.ensure_compile_cache()
    path = jax.config.jax_compilation_cache_dir
    assert path == lp.DEFAULT_CACHE_DIR
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert os.path.dirname(path) == repo


def test_compile_cache_honours_env(monkeypatch, cache_config, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    jax.config.update("jax_compilation_cache_dir", None)
    lp.ensure_compile_cache()
    # nothing is set in code: jax reads the variable itself
    assert jax.config.jax_compilation_cache_dir is None


def test_compile_cache_keeps_configured_dir(monkeypatch, cache_config,
                                            tmp_path):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    jax.config.update("jax_compilation_cache_dir", str(tmp_path))
    lp.ensure_compile_cache()
    assert jax.config.jax_compilation_cache_dir == str(tmp_path)
