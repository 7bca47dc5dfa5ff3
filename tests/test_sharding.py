"""Device-mesh sharding of the LP batch (runs on the virtual 8-device
CPU mesh set up in conftest)."""

import numpy as np

import jax

from bensolve_tpu.lp import simplex as sx
from bensolve_tpu.parallel import mesh as pmesh


def _instances(M, N, B, seed=0):
    rng = np.random.default_rng(seed)
    A = (rng.standard_normal((M, N)) / np.sqrt(N)).astype(np.float32)
    x0 = rng.random((B, N)).astype(np.float32)
    b = (x0 @ A.T + 0.5 + rng.random((B, M))).astype(np.float32)
    c = rng.standard_normal((B, N)).astype(np.float32)
    NT = M + N
    full_c = np.concatenate([np.zeros((B, M), np.float32), c], axis=1)
    lb = np.concatenate([np.full((B, M), -np.inf, np.float32),
                         np.zeros((B, N), np.float32)], axis=1)
    ub = np.concatenate([b, np.full((B, N), 10.0, np.float32)], axis=1)
    return A, full_c, lb, ub


def test_dp_sharded_matches_single_device():
    assert len(jax.devices()) >= 8
    M = N = 16
    A, c, lb, ub = _instances(M, N, 16)
    E_args = (np.asarray(A), c, lb, ub)

    ref = sx._solve_batch_jit(A, c, lb, ub, 512)
    m = pmesh.make_mesh(8, ("dp",))
    got = pmesh.solve_batch_sharded(m, A, c, lb, ub, max_iter=512)
    np.testing.assert_array_equal(np.asarray(ref[0]), np.asarray(got[0]))
    np.testing.assert_allclose(np.asarray(ref[1]), np.asarray(got[1]),
                               rtol=1e-5, atol=1e-5)


def test_2d_mesh_benson_round():
    m = pmesh.make_mesh(8, ("dp", "tp"))
    assert m.devices.size == 8
    M = N = 16
    A, c, lb, ub = _instances(M, N, 8)
    V = np.random.default_rng(1).random((8, 2)).astype(np.float32)
    ZR = np.eye(2, dtype=np.float32)
    out = pmesh.benson_round_sharded(
        m, np.asarray(A), c[0], V, ZR, lb[0, :M], ub[0, :M],
        lb[0, M:], ub[0, M:], n_extra_offset=4, max_iter=256)
    status = np.asarray(out[0])
    assert status.shape == (8,)


def _tall_instances(M, N, B, seed=3):
    """Tall (N >> M) batch in solve_batch_revised argument form."""
    rng = np.random.default_rng(seed)
    A = (rng.standard_normal((M, N)) / np.sqrt(N)).astype(np.float64)
    x0 = rng.random((B, N))
    b = x0 @ A.T + 0.5 + rng.random((B, M))
    c = rng.standard_normal((B, N))
    row_lb = np.full((B, M), -np.inf)
    col_lb = np.zeros((B, N))
    col_ub = np.full((B, N), 10.0)
    return A, c, row_lb, b, col_lb, col_ub


def test_tp_sharded_revised_matches_single_device():
    """The TP path for huge single LPs (Options.mesh_axes=("tp",)): the
    revised solver with A / A^T / basis-inverse panels sharded over an
    8-way tp axis must reproduce the unsharded results."""
    from bensolve_tpu.lp import revised

    A, c, rlb, rub, clb, cub = _tall_instances(8, 64, 4)
    ref = revised.solve_batch_revised(A, c, rlb, rub, clb, cub)
    m = pmesh.make_mesh(8, ("tp",))
    got = revised.solve_batch_revised(A, c, rlb, rub, clb, cub, mesh=m)
    np.testing.assert_array_equal(ref.status, got.status)
    ok = ref.status == sx.OPTIMAL
    assert ok.any()
    np.testing.assert_allclose(got.obj[ok], ref.obj[ok], rtol=1e-8,
                               atol=1e-8)
    np.testing.assert_allclose(got.row_dual[ok], ref.row_dual[ok],
                               rtol=1e-7, atol=1e-9)


def test_mesh_axes_end_to_end_solve():
    """Options(mesh_axes=...) routes a whole VLP solve through the
    sharded LP backends; the vertex sets must match the single-device
    solve exactly."""
    from bensolve_tpu.algs.driver import solve
    from bensolve_tpu.vlp.options import Options
    from bensolve_tpu import examples

    vlp = examples.load("ex05")
    ref = solve(vlp, Options(write_files=False))
    got = solve(examples.load("ex05"),
                Options(write_files=False, mesh_axes=("dp", "tp")))
    assert got.status.name == "OPTIMAL"

    def canon(a):
        return sorted(map(tuple, np.round(a, 9)))

    assert canon(got.primal_points) == canon(ref.primal_points)
    assert canon(got.dual_points) == canon(ref.dual_points)


def test_tp_sharding_distributes_state():
    """Memory-distribution witness: under an 8-way tp mesh the
    (M, N) constraint matrix and the (B, M, M) basis-inverse panels are
    actually SPLIT across devices (per-device bytes ~ 1/8 of total)."""
    import jax as _jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from bensolve_tpu.lp import revised
    from bensolve_tpu.lp import simplex

    m = pmesh.make_mesh(8, ("tp",))
    A, c, rlb, rub, clb, cub = _tall_instances(8, 64, 2)
    prep = simplex._prepare_A(np.asarray(A, np.float64), np.float64)
    shA, shAT, shB, ssh = revised._mesh_shardings(m)
    A_dev = _jax.device_put(prep.host, shA)
    # each device holds one 1/8 column slice of A
    shard_shapes = {s.data.shape for s in A_dev.addressable_shards}
    assert shard_shapes == {(prep.Mp, prep.Np // 8)}
