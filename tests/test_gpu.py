"""Checks that need a GPU: the f64 LU, the f64 tableau and a Benson solve
compiled for the card.  They skip elsewhere; run them on a GPU machine
with

    JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg

from bensolve_tpu import examples
from bensolve_tpu.algs.driver import solve
from bensolve_tpu.lp import linalg
from bensolve_tpu.lp import simplex as sx
from bensolve_tpu.oracle import check_support, highs_lp
from bensolve_tpu.vlp.options import Options
from tests.test_ipm import random_lp

pytestmark = pytest.mark.gpu


def test_lu_f64_batched(gpu):
    rng = np.random.default_rng(0)
    B, M = 256, 96
    A = rng.standard_normal((B, M, M))
    b = rng.standard_normal((B, M))
    Ad = jax.device_put(jnp.asarray(A), gpu)
    lu, piv = jax.jit(jax.vmap(linalg.lu_factor))(Ad)
    x = np.asarray(jax.jit(jax.vmap(linalg.lu_solve))((lu, piv),
                                                      jnp.asarray(b)))
    for i in range(0, B, 32):
        ref = scipy.linalg.solve(A[i], b[i])
        assert np.linalg.norm(x[i] - ref) <= 1e-9 * np.linalg.norm(ref)


def test_tableau_f64_vs_highs(gpu):
    A, c, rlb, rub, clb, cub = random_lp(48, 64, 32, seed=2)
    res = sx.solve_batch(A, c, rlb, rub, clb, cub, dtype=np.float64)
    assert (res.status == sx.OPTIMAL).all()
    for i in range(0, 32, 4):
        ref = highs_lp(A, c[i], rlb[i], rub[i], clb[i], cub[i])
        assert abs(res.obj[i] - ref.fun) <= 1e-7 * (1 + abs(ref.fun))


def test_ex05_solve_support(gpu):
    r = solve(examples.load("ex05"), Options(write_files=False))
    assert r.status.name == "OPTIMAL"
    check_support(r)
