"""bensolve_tpu — a batched, accelerator-resident vector linear program
(VLP) solver.

A from-scratch JAX/XLA re-design of the capabilities of BENSOLVE 2.0.1
(reference: C99 + GLPK).  The reference solves one scalar
LP at a time with a single warm-started GLPK instance (bslv_lp.c:31) and
maintains the outer-approximating polyhedron with pointer-linked adjacency
lists (bslv_poly.c).  This package instead:

  * solves the *entire Benson frontier* per round as one batched dense
    bounded-variable simplex on device (``bensolve_tpu.lp``),
  * keeps the polytope pair (upper image / lower image) as array-backed
    incremental halfspace intersection (``bensolve_tpu.poly``),
  * shards LP batches over a ``jax.sharding.Mesh`` for multi-device scale
    (``bensolve_tpu.parallel``).

Float64 is required for bensolve's 1e-7..1e-9 tolerances (bslv_main.h:71-78),
so x64 mode is enabled at import; the GPU runs it natively.  Float32 matmuls
default to full f32 precision: at XLA's DEFAULT a GPU may run them in TF32
(about three decimal digits), which the float32 LP tolerances (1e-5,
lp/simplex.py _tols) cannot absorb.
"""

import jax

jax.config.update("jax_enable_x64", True)
jax.config.update("jax_default_matmul_precision", "highest")

from bensolve_tpu.vlp.problem import VLPProblem, Bounds  # noqa: E402
from bensolve_tpu.vlp.options import Options  # noqa: E402
from bensolve_tpu.vlp.reader import read_vlp  # noqa: E402
from bensolve_tpu.algs.driver import solve  # noqa: E402

__version__ = "0.1.0"

__all__ = [
    "VLPProblem",
    "Bounds",
    "Options",
    "read_vlp",
    "solve",
]
