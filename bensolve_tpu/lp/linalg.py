"""Dense LU with partial pivoting for the simplex endgame.

``lu_factor``/``lu_solve`` follow the scipy contract and call
``jax.scipy.linalg`` on every backend (LAPACK on the CPU, cuSOLVER and
cuBLAS on the GPU, float64 included).  The one addition is a clamp of
numerically singular pivots, so that a singular basis yields finite
output instead of inf/nan.
"""

from __future__ import annotations

import jax.numpy as jnp
import jax.scipy.linalg as jsl


def _tiny(dtype):
    return jnp.asarray(1e-30 if jnp.dtype(dtype) == jnp.dtype(jnp.float64)
                       else 1e-20, dtype)


def lu_factor(A):
    """LU with partial pivoting of a single (M, M) matrix (scipy
    lu_factor contract: returns (LU, piv), row k swapped with piv[k])."""
    LU, piv = jsl.lu_factor(A)
    # clamp numerically-singular pivots: LAPACK returns a zero diagonal
    # for a singular basis and the subsequent solve would produce
    # inf/nan; the simplex endgame wants "whatever accuracy survives"
    # instead, exactly like a drifted tableau would give
    d = jnp.diagonal(LU)
    tiny = _tiny(LU.dtype)
    d_fixed = jnp.where(jnp.abs(d) < tiny,
                        jnp.where(d < 0, -tiny, tiny), d)
    M = LU.shape[0]
    LU = LU.at[jnp.arange(M), jnp.arange(M)].set(d_fixed)
    return LU, piv


def lu_solve(lu_and_piv, b, trans: int = 0):
    """Solve A x = b (trans=0) or A^T x = b (trans=1) from lu_factor
    output.  ``b`` may be (M,) or (M, K)."""
    return jsl.lu_solve(lu_and_piv, b, trans=trans)
