"""BASELINE.json config #5: scenario-batched portfolio VLP at scale.

Solves N random bounded VLP instances through the lockstep
instance-level-DP engine (algs/many.py), optionally sharded over a
device mesh, and prints per-status counts + instances/s.

Usage:
    python scale_many.py [N] [--mesh] [--q Q] [--m M] [--n NVARS]

CPU virtual mesh:  XLA_FLAGS=--xla_force_host_platform_device_count=8
                   JAX_PLATFORMS=cpu python scale_many.py 10000 --mesh
One GPU:           python scale_many.py 10000
"""

import collections
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def main() -> None:
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    n_inst = int(args[0]) if args else 10000
    use_mesh = "--mesh" in sys.argv

    from bensolve_tpu.algs.many import solve_many
    from bensolve_tpu.examples import random_vlp
    from bensolve_tpu.lp import ensure_compile_cache
    from bensolve_tpu.parallel.mesh import make_mesh
    from bensolve_tpu.vlp.options import Options

    ensure_compile_cache()
    t0 = time.time()
    vlps = [random_vlp(q=3, m=10, n=8, seed=s) for s in range(n_inst)]
    print(f"generated {n_inst} instances in {time.time()-t0:.1f}s",
          flush=True)

    mesh = make_mesh(None, ("dp",)) if use_mesh else None
    opt = Options(bounded=True, write_files=False)
    t0 = time.time()
    rs = solve_many(vlps, opt, mesh=mesh)
    wall = time.time() - t0
    local = [r for r in rs if r is not None]
    counts = collections.Counter(r.status.name for r in local)
    lps = sum(r.stats.lps for r in local)
    print(f"solved {len(local)}/{n_inst} local instances in {wall:.1f}s "
          f"({len(local)/wall:.1f} inst/s, {lps} LPs, "
          f"{lps/wall:.0f} LP/s)", flush=True)
    print("statuses:", dict(counts), flush=True)


if __name__ == "__main__":
    main()
