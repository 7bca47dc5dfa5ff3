"""Multi-chip execution: shard the scalarization-LP batch over a device
mesh.

The reference is single-threaded with one mutable LP (bslv_lp.c:31); the
batched execution model instead treats each Benson round's frontier
as a batch axis (SURVEY.md section 2.2):

* ``dp`` (data parallel) — independent scalarization LPs of one round
  sharded across chips; the per-instance simplex state (basis inverse,
  bounds) lives entirely on the owning chip, so the while_loop runs
  without any cross-chip traffic except the global "all done" reduction.
* ``tp`` (tensor parallel) — the within-LP linear algebra (the
  (B, M, M) basis-inverse update and the (B, NT) pricing row) sharded on
  its trailing axis for very large single LPs.

The polytope update stays replicated host-side; new cuts are gathered
back (all-gather over the batch axis happens implicitly when results
are fetched).
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from bensolve_tpu.lp import simplex


def make_mesh(n_devices: int | None = None,
              axes: tuple[str, ...] = ("dp",)) -> Mesh:
    """Build a device mesh.  With two axes the device count is split as
    evenly as possible (dp major)."""
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    n = len(devs)
    if len(axes) == 1:
        shape = (n,)
    elif len(axes) == 2:
        dp = 1
        for cand in range(int(np.sqrt(n)), 0, -1):
            if n % cand == 0:
                dp = n // cand
                break
        shape = (dp, n // dp)
    else:
        raise ValueError("1 or 2 mesh axes supported")
    return Mesh(np.asarray(devs).reshape(shape), axes)


def solve_batch_sharded(mesh: Mesh, A, c, lb, ub, *, max_iter: int):
    """Run the batched simplex with the batch axis sharded over the
    mesh's first axis (and the variable axis over the second, if any).

    Arguments are the PADDED dense arrays of simplex._solve_batch_jit:
    ``A`` (M, N) shared, ``c``/``lb``/``ub`` (B, M+N).  B must divide by
    the dp axis size.  Returns the same tuple as _solve_batch_jit with
    fully replicated outputs.
    """
    dp = mesh.axis_names[0]
    tp = mesh.axis_names[1] if len(mesh.axis_names) > 1 else None
    repl = NamedSharding(mesh, P())
    batched = NamedSharding(mesh, P(dp, tp))

    core = simplex._solve_batch_jit.__wrapped__
    fn = jax.jit(
        lambda A, c, lb, ub: core(A, c, lb, ub, max_iter=max_iter),
        in_shardings=(repl, batched, batched, batched),
        out_shardings=repl,
    )
    return fn(jax.device_put(A, repl), jax.device_put(c, batched),
              jax.device_put(lb, batched), jax.device_put(ub, batched))


def benson_round_sharded(mesh: Mesh, A_lp, obj, V, ZR, base_row_lb,
                         base_row_ub, col_lb, col_ub, n_extra_offset: int,
                         *, max_iter: int):
    """One full primal Benson round, jitted over the mesh: from the
    frontier vertex batch V (B, q), build the P2 row-bound batch
    ub_j = (ZR' v)_j, solve all LPs, and return (status, obj, row_duals)
    from which the host extracts cuts.  V is sharded over dp; everything
    template-shaped is replicated."""
    dp = mesh.axis_names[0]
    repl = NamedSharding(mesh, P())
    vshard = NamedSharding(mesh, P(dp))

    def jnp_tile(x, B):
        return jax.numpy.broadcast_to(x, (B,) + x.shape)

    def round_fn(A_lp, obj, V, ZR, base_row_lb, base_row_ub, col_lb, col_ub):
        B = V.shape[0]
        extra_ub = V @ ZR                                   # (B, p)
        row_ub = jnp_tile(base_row_ub, B)
        row_ub = row_ub.at[:, n_extra_offset:n_extra_offset + ZR.shape[1]].set(
            extra_ub)
        row_lb = jnp_tile(base_row_lb, B)
        c = jnp_tile(obj, B)
        lb = jax.numpy.concatenate([row_lb, jnp_tile(col_lb, B)], axis=1)
        ub = jax.numpy.concatenate([row_ub, jnp_tile(col_ub, B)], axis=1)
        return simplex._solve_batch_jit.__wrapped__(A_lp, c, lb, ub,
                                                    max_iter=max_iter)

    fn = jax.jit(round_fn,
                 in_shardings=(repl, repl, vshard, repl, repl, repl, repl,
                               repl),
                 out_shardings=repl)
    return fn(A_lp, obj, jax.device_put(V, vshard), ZR, base_row_lb,
              base_row_ub, col_lb, col_ub)
