"""Unit tests for the LU wrapper of the simplex endgame (lp/linalg.py):
jax.scipy.linalg with a clamp of singular pivots."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg

from bensolve_tpu.lp import linalg


@pytest.mark.parametrize("m", [1, 2, 5, 17, 64])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_lu_solve_matches_scipy(m, dtype):
    rng = np.random.default_rng(m)
    A = rng.standard_normal((m, m)).astype(dtype)
    A += m * np.eye(m, dtype=dtype)  # well-conditioned
    b = rng.standard_normal((m, 3)).astype(dtype)

    lu, piv = jax.jit(linalg.lu_factor)(A)
    x = np.asarray(jax.jit(linalg.lu_solve)((lu, piv), jnp.asarray(b)))
    x_ref = scipy.linalg.solve(np.float64(A), np.float64(b))
    rtol = 1e-10 if dtype == np.float64 else 1e-3
    np.testing.assert_allclose(x, x_ref, rtol=rtol, atol=rtol)


@pytest.mark.parametrize("trans", [0, 1])
def test_lu_solve_trans_and_vector(trans):
    rng = np.random.default_rng(7)
    m = 23
    A = rng.standard_normal((m, m)) + m * np.eye(m)
    b = rng.standard_normal(m)
    lu, piv = linalg.lu_factor(jnp.asarray(A))
    x = np.asarray(linalg.lu_solve((lu, piv), jnp.asarray(b), trans=trans))
    ref = np.linalg.solve(A.T if trans else A, b)
    np.testing.assert_allclose(x, ref, rtol=1e-10, atol=1e-12)


def test_lu_needs_pivoting():
    # zero on the diagonal: fails without partial pivoting
    A = jnp.asarray(np.array([[0.0, 1.0], [1.0, 0.0]]))
    b = jnp.asarray(np.array([2.0, 3.0]))
    x = np.asarray(linalg.lu_solve(linalg.lu_factor(A), b))
    np.testing.assert_allclose(x, [3.0, 2.0], atol=1e-14)


def test_lu_batched_vmap():
    rng = np.random.default_rng(0)
    B, m = 4, 12
    A = rng.standard_normal((B, m, m)) + m * np.eye(m)
    b = rng.standard_normal((B, m))
    lu, piv = jax.vmap(linalg.lu_factor)(jnp.asarray(A))
    x = np.asarray(jax.vmap(linalg.lu_solve)((lu, piv), jnp.asarray(b)))
    for i in range(B):
        np.testing.assert_allclose(x[i], np.linalg.solve(A[i], b[i]),
                                    rtol=1e-9, atol=1e-11)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_lu_singular_clamped_finite(dtype):
    """An exactly singular matrix factorizes with its zero pivot clamped
    to a tiny signed value, so the solve is finite (the simplex endgame
    recovers 'whatever accuracy survives' from a singular basis)."""
    A = np.array([[1.0, 2.0, 3.0], [2.0, 4.0, 6.0], [1.0, 0.0, 1.0]],
                 dtype)
    lu, piv = jax.jit(linalg.lu_factor)(jnp.asarray(A))
    assert lu.dtype == dtype
    d = np.abs(np.diagonal(np.asarray(lu)))
    assert d.min() > 0
    x = np.asarray(linalg.lu_solve((lu, piv), jnp.ones(3, dtype)))
    assert np.all(np.isfinite(x))


def test_lu_f64_matches_jax_scipy():
    """On a regular matrix the wrapper is exactly jax.scipy.linalg."""
    rng = np.random.default_rng(3)
    A = jnp.asarray(rng.standard_normal((9, 9)) + 9 * np.eye(9))
    lu, piv = linalg.lu_factor(A)
    lu_ref, piv_ref = jax.scipy.linalg.lu_factor(A)
    np.testing.assert_array_equal(np.asarray(lu), np.asarray(lu_ref))
    np.testing.assert_array_equal(np.asarray(piv), np.asarray(piv_ref))
