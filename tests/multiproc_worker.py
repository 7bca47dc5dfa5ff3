"""Subprocess worker for the real multi-process distributed tests.

Each worker is one jax process (CPU backend, Gloo collectives over
localhost).  The parent test (tests/test_multiprocess.py) spawns P of
these with a shared coordinator port, waits, and compares the artifacts
they write.  This is the SURVEY.md section 4(d) multi-host test rig:
real ``jax.distributed.initialize`` process groups without a pod.

Usage: python multiproc_worker.py MODE PORT NPROC PID OUTDIR
"""

import json
import os
import sys


def main() -> None:
    mode, port, nproc, pid, outdir = sys.argv[1:6]
    nproc, pid = int(nproc), int(pid)
    os.environ["JAX_PLATFORMS"] = "cpu"

    import jax

    jax.config.update("jax_enable_x64", True)

    import numpy as np

    from bensolve_tpu.parallel import distributed as dist

    dist.initialize(f"localhost:{port}", nproc, pid)
    assert jax.process_count() == nproc, jax.process_count()

    # Warm the Gloo context NOW, while the processes are still in
    # lockstep: the first collective creates the context with a 30 s
    # key-exchange deadline, and jit-compile skew between hosts during
    # a solve can exceed that.
    dist.allgather_rows(np.zeros((1, 1)), total=nproc)

    if mode == "allgather":
        # uneven strided shards (total=7 over 2 procs -> 4 and 3 rows):
        # exercises the NaN padding/drop path of allgather_rows
        total = 7
        idx = dist.shard_indices(total)
        local = np.stack([np.arange(3.0) + 10 * i for i in idx]) \
            if idx.size else np.zeros((0, 3))
        out = dist.allgather_rows(local, total=total)
        np.save(f"{outdir}/allgather_{pid}.npy", out)
    elif mode in ("solve", "solve_dual"):
        from bensolve_tpu.algs.driver import solve
        from bensolve_tpu.vlp.options import Alg, Options
        from bensolve_tpu import examples

        vlp = examples.load("ex05")
        opt = Options(distributed=True, write_files=False)
        if mode == "solve_dual":
            opt.alg_phase1 = opt.alg_phase2 = Alg.DUAL
        r = solve(vlp, opt)
        np.save(f"{outdir}/pts_{pid}.npy", r.primal_points)
        np.save(f"{outdir}/dpts_{pid}.npy", r.dual_points)
        with open(f"{outdir}/stats_{pid}.json", "w") as f:
            json.dump({"status": r.status.name, "lps": r.stats.lps,
                       "rounds": r.stats.rounds, "cuts": r.stats.cuts}, f)
    elif mode == "many":
        # instance-level DP across hosts: each host owns a strided shard
        # of the instance list (SURVEY.md section 2.2 DP row)
        from bensolve_tpu.algs.many import solve_many
        from bensolve_tpu.examples import random_vlp
        from bensolve_tpu.vlp.options import Options

        vlps = [random_vlp(q=2, m=6, n=5, seed=s) for s in range(24)]
        rs = solve_many(vlps, Options(bounded=True, write_files=False))
        owned = [i for i, r in enumerate(rs) if r is not None]
        np.save(f"{outdir}/many_idx_{pid}.npy", np.asarray(owned))
        for i in owned:
            np.save(f"{outdir}/many_pts_{i}.npy", rs[i].primal_points)
        with open(f"{outdir}/many_stats_{pid}.json", "w") as f:
            json.dump({str(i): rs[i].status.name for i in owned}, f)
    else:
        raise SystemExit(f"unknown mode {mode}")


if __name__ == "__main__":
    main()
