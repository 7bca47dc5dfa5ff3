"""Multi-host execution of the Benson rounds.

The reference is single-process (SURVEY.md section 2.2).  The batched
model shards each round's frontier of scalarization LPs across
processes, all-gathers the resulting cuts, and applies them to the
REPLICATED polytope in a canonical order so every host's outer
approximation stays bit-identical — the determinism contract that
replaces cut-insertion-order dependence (SURVEY.md section 5,
"long-context" entry).

On a single process everything degenerates to local compute; the same
code runs under ``jax.distributed`` across processes, where gathers ride
the XLA collective runtime.
"""

from __future__ import annotations

import numpy as np

import jax


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """jax.distributed bring-up (no-op when already initialized or
    single-process).

    Must not touch the XLA backend before ``jax.distributed.initialize``
    runs (``jax.process_count()`` would initialize it), so the
    already-initialized check reads the distributed client state
    directly."""
    if coordinator_address is None:
        return
    from jax._src.distributed import global_state

    if global_state.client is not None:
        return
    jax.distributed.initialize(coordinator_address, num_processes,
                               process_id)


def shard_indices(n: int, *, process_id: int | None = None,
                  process_count: int | None = None) -> np.ndarray:
    """This host's strided share of a frontier of size n."""
    pid = jax.process_index() if process_id is None else process_id
    pcount = jax.process_count() if process_count is None else process_count
    return np.arange(pid, n, pcount)


def allgather_rows(local: np.ndarray, total: int | None = None
                   ) -> np.ndarray:
    """Concatenate each process's rows (single-process: identity).
    Multi-host: jax.experimental.multihost_utils.process_allgather over
    the default mesh.

    ``total``: global row count (known to every host — the frontier
    size).  Strided shards differ in length by one, and the collective
    needs equal shapes, so local rows are padded to ceil(total/P) with
    NaN rows that are dropped after the gather."""
    local = np.asarray(local)
    pcount = jax.process_count()
    if pcount == 1:
        return local
    from jax.experimental import multihost_utils

    if total is None:
        total = local.shape[0] * pcount
    rows_max = -(-total // pcount)
    if local.shape[0] < rows_max:
        pad = np.full((rows_max - local.shape[0], local.shape[1]), np.nan)
        local = np.concatenate([local, pad])
    out = np.asarray(multihost_utils.process_allgather(local, tiled=True))
    keep = ~np.all(np.isnan(out), axis=1)
    return out[keep]


def canonical_order(cuts: np.ndarray) -> np.ndarray:
    """Deterministic application order for a round's gathered cuts:
    lexicographic on the cut vectors, independent of which host produced
    which cut and of the frontier traversal order."""
    cuts = np.asarray(cuts)
    if cuts.size == 0:
        return np.arange(0)
    return np.lexsort(np.round(cuts.T[::-1], 12))
