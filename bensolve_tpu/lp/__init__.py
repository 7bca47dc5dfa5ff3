"""LP backends: batched tableau simplex (square-ish problems), batched
revised simplex (tall problems, N >> M), dual-simplex warm re-solves and
an opt-in Mehrotra interior-point method (huge problems)."""

import os

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# persistent compile cache used when JAX_COMPILATION_CACHE_DIR is unset:
# a fixed directory inside the checkout, so repeated runs of any entry
# point hit the same cache key (listed in .gitignore)
DEFAULT_CACHE_DIR = os.path.join(_REPO, ".jax_cache")


def solve_batch_auto(A, c, row_lb, row_ub, col_lb, col_ub, **kw):
    """Route a batch of LPs to the best backend (the role of GLPK's
    glp_simplex dispatch behind lp_solve, bslv_lp.c:219):

    * huge problems (M+N above the opt-in IPM threshold): Mehrotra IPM;
    * tall problems (N >= REVISED_RATIO * M): revised simplex — the
      tableau would carry (M+N)/M x more state per instance;
    * otherwise: the XLA lockstep tableau solver.

    ``mesh`` (Options.mesh_axes): multi-device sharding — routes to the
    revised/tableau SPMD paths.
    """
    import numpy as np

    from bensolve_tpu.lp import revised, simplex

    if isinstance(A, simplex._PreparedA):
        M, N = A.M, A.N
    else:
        M, N = np.asarray(A).shape
    mesh = kw.get("mesh")
    # Options.lp_ipm_min (native routing) takes effect alongside the
    # BENSOLVE_IPM_MIN env var: whichever enables the route wins
    ipm_min = kw.pop("ipm_min", 0) or (1 << 62)
    warm_interior = kw.pop("warm_interior", None)
    if mesh is None and M + N >= min(ipm_min, _ipm_min_size()):
        # huge instances: every simplex variant advances one pivot per
        # device-loop iteration, so it is pivot-count-bound; the
        # Mehrotra IPM solves in ~15-40 matmul-shaped iterations
        # independent of degeneracy (lp/ipm.py)
        from bensolve_tpu.lp import ipm

        ipm_kw = {}
        if "max_iter" in kw:
            ipm_kw["max_iter"] = kw["max_iter"]
        return ipm.solve_batch_ipm(A, c, row_lb, row_ub, col_lb, col_ub,
                                   dtype=kw.get("dtype", np.float64),
                                   verbose=kw.get("verbose", 0),
                                   warm_interior=warm_interior, **ipm_kw)
    if N >= revised.REVISED_RATIO * M:
        return revised.solve_batch_revised(A, c, row_lb, row_ub,
                                           col_lb, col_ub, **kw)
    kw.pop("mesh", None)
    kw.pop("verbose", None)
    return simplex.solve_batch(A, c, row_lb, row_ub, col_lb, col_ub,
                               mesh=mesh, **kw)


def ensure_compile_cache() -> None:
    """Enable jax's persistent compilation cache, so that every entry
    point (CLI, library, direct backend calls) reuses compiled programs
    across processes.  When JAX_COMPILATION_CACHE_DIR is set, jax reads
    it itself and nothing is changed here; otherwise the cache lives in
    DEFAULT_CACHE_DIR."""
    import jax

    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    if jax.config.jax_compilation_cache_dir:
        return
    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)


def _ipm_min_size() -> int:
    """M+N above which solve_batch_auto routes to the interior-point
    backend.  Opt-in: the route is DISABLED unless BENSOLVE_IPM_MIN is
    set to a positive threshold (0 also disables).  The simplex family
    remains the default production path for every size; callers that
    want the IPM at scale set the env knob, pass Options.lp_ipm_min, or
    call ipm.solve_batch_ipm directly."""
    v = os.environ.get("BENSOLVE_IPM_MIN")
    if v:
        n = int(v)
        return n if n > 0 else 1 << 62
    return 1 << 62
