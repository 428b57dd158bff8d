"""Multi-chip SpMV tests on a simulated 8-device CPU mesh (SURVEY §4)."""

import numpy as np
import pytest

import jax
from jax.sharding import Mesh

from spmv_tpu import spmv_ref
from spmv_tpu.io.generate import power_law_csr, random_csr, banded_csr
from spmv_tpu.ops.semiring import MIN_PLUS
from spmv_tpu.ops.reference import spmv_ref_semiring
from spmv_tpu.parallel import distribute_csr, partition_rows


def _mesh(n):
    devs = np.array(jax.devices()[:n])
    return Mesh(devs, ("shards",))


@pytest.mark.parametrize("n_devices", [2, 4, 8])
def test_distributed_matches_oracle(n_devices):
    A = power_law_csr(500, 500, 6000, seed=3)
    x = np.random.default_rng(0).standard_normal(500).astype(np.float32)
    dist = distribute_csr(A, _mesh(n_devices))
    y = np.asarray(dist.matvec(x))
    np.testing.assert_allclose(y, spmv_ref(A, x, np.float64), rtol=2e-5, atol=1e-5)


def test_distributed_rectangular():
    A = random_csr(300, 170, 2500, seed=5)
    x = np.random.default_rng(1).standard_normal(170).astype(np.float32)
    dist = distribute_csr(A, _mesh(4))
    y = np.asarray(dist.matvec(x))
    np.testing.assert_allclose(y, spmv_ref(A, x, np.float64), rtol=2e-5, atol=1e-5)


def test_distributed_semiring():
    A = random_csr(200, 200, 1500, seed=6)
    Ax = np.abs(np.asarray(A.Ax)).astype(np.float32)
    from spmv_tpu.formats import COO, coo_to_csr

    A = coo_to_csr(COO(200, 200, A.row_ids(), np.asarray(A.Aj), Ax))
    x = np.abs(np.random.default_rng(2).standard_normal(200)).astype(np.float32)
    dist = distribute_csr(A, _mesh(4))
    y = np.asarray(dist.matvec(x, semiring=MIN_PLUS))
    y_ref = spmv_ref_semiring(A, x, MIN_PLUS, y_dtype=np.float32)
    np.testing.assert_allclose(y, y_ref, rtol=2e-5, atol=1e-5)


def test_partition_merge_balance():
    # nnz-balanced split: no shard should hold a wildly outsized nnz share.
    A = power_law_csr(1000, 1000, 20000, seed=7)
    part = partition_rows(A, 8, balance="merge")
    Ap = np.asarray(A.Ap, np.int64)
    shard_nnz = Ap[part.row_starts[1:]] - Ap[part.row_starts[:-1]]
    items = shard_nnz + (part.row_starts[1:] - part.row_starts[:-1])
    mean = items.mean()
    # merge balance bounds each shard's items near the mean (within the
    # largest single row, which cannot be split in a 1-D row partition).
    max_row = A.row_lengths().max()
    assert items.max() <= mean + max_row + 1


def test_partition_empty_and_tiny():
    A = banded_csr(5, 1)
    part = partition_rows(A, 8)
    assert part.row_starts[-1] == 5
    dist = distribute_csr(A, _mesh(8))
    x = np.ones(5, np.float32)
    y = np.asarray(dist.matvec(x))
    np.testing.assert_allclose(y, spmv_ref(A, x, np.float64), rtol=1e-5, atol=1e-6)


def test_weak_scaling_structure():
    # Same per-shard work at 2 and 4 shards: partition sizes stay flat.
    A = random_csr(800, 800, 16000, seed=8)
    p2 = partition_rows(A, 2)
    p4 = partition_rows(A, 4)
    assert p4.nnz_per_shard <= p2.nnz_per_shard


def test_halo_exchange_volume_and_equivalence():
    # banded matrix: halo = only boundary columns -> comm volume must
    # be far below the all-gather volume, and both modes must agree.
    A = banded_csr(4096, bandwidth=2, seed=9)
    x = np.random.default_rng(3).standard_normal(4096).astype(np.float32)
    dist = distribute_csr(A, _mesh(8))
    assert dist.comm_bytes_per_shard < dist.allgather_bytes_per_shard / 8, (
        dist.comm_bytes_per_shard, dist.allgather_bytes_per_shard)
    y_halo = np.asarray(dist.matvec(x, mode="halo"))
    y_ag = np.asarray(dist.matvec(x, mode="allgather"))
    np.testing.assert_allclose(y_halo, y_ag, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        y_halo, spmv_ref(A, x, np.float64), rtol=2e-5, atol=1e-5)


def test_overlap_structure_self_independent_of_exchange():
    # The compiled module must contain an all-to-all (halo exchange),
    # and the self-block matvec must not depend on it: check the jaxpr
    # has all_to_all (not all_gather) in halo mode.
    # balance='merge' keeps cuts row-aligned -> no boundary exports,
    # so the ONLY collective in halo mode must be the all_to_all
    A = banded_csr(512, bandwidth=1, seed=10)
    x = np.ones(512, np.float32)
    dist = distribute_csr(A, _mesh(4), balance="merge")
    assert not dist.plan.export_flag.any()
    import jax

    from spmv_tpu.parallel.dist_spmv import _dist_matvec

    d = dist.dev
    jaxpr = jax.make_jaxpr(
        lambda *a: _dist_matvec(
            *a, mesh=dist.mesh, axis=dist.axis, R=dist.plan.R,
            sr=__import__("spmv_tpu").PLUS_TIMES, mode="halo",
            export_meta=(tuple(int(r) for r in dist.plan.export_rows),
                         False)))(
        d["send_idx"], d["recv_idx"], d["self"], d["halo"],
        d["idx_own"], d["own_start"], dist.unpad_idx, dist.shard_x(x))
    s = str(jaxpr)
    assert "all_to_all" in s
    assert "all_gather" not in s


def test_nnz_split_hub_row():
    """balance='nnz' splits an indivisible hub row across shards and
    the boundary-partial combine reassembles it exactly (the carry
    fixup at chip granularity). A row-aligned split would pin 60% of
    the nnz to one shard; here per-shard padded nnz is ~equal."""
    rng = np.random.default_rng(3)
    n = 1024
    rows = np.concatenate([np.full(6000, 37), rng.integers(0, n, 4000)])
    cols = rng.integers(0, n, rows.size)
    vals = rng.standard_normal(rows.size).astype(np.float32)
    from spmv_tpu.formats import COO, coo_to_csr

    A = coo_to_csr(COO(n, n, rows, cols, vals))
    x = rng.standard_normal(n).astype(np.float32)
    dist = distribute_csr(A, _mesh(8), balance="nnz")
    assert dist.plan.export_flag.sum() >= 4  # hub row really split
    # padded per-shard nnz within 128 (one pad granule) of nnz/8
    assert dist.plan.N_self + dist.plan.N_halo <= A.nnz // 8 + 2 * 128
    y = np.asarray(dist.matvec(x))
    np.testing.assert_allclose(y, spmv_ref(A, x, np.float64),
                               rtol=2e-5, atol=1e-5)
    # semiring path through the split: min-plus
    from spmv_tpu import MIN_PLUS
    from spmv_tpu.ops.reference import spmv_ref_semiring

    ym = np.asarray(dist.matvec(x, semiring=MIN_PLUS))
    np.testing.assert_allclose(
        ym, spmv_ref_semiring(A, x, MIN_PLUS), rtol=2e-5, atol=1e-5)


def test_bootstrap_single_process():
    """init_distributed is a no-op without a coordinator; make_mesh
    builds a flat mesh over the global device list; put_global
    places replicated host data onto it (the multi-host path collapses
    to device_put semantics at process_count=1)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from spmv_tpu.parallel import init_distributed, make_mesh, put_global

    assert init_distributed() == 1
    assert init_distributed() == 1  # idempotent
    mesh = make_mesh("shards")
    assert mesh.shape["shards"] == len(jax.devices())
    a = np.arange(mesh.shape["shards"] * 4, dtype=np.float32)
    g = put_global(a, NamedSharding(mesh, P("shards")))
    np.testing.assert_array_equal(np.asarray(g), a)
    assert len(g.sharding.device_set) == len(jax.devices())


def test_bootstrap_mesh_feeds_distribute():
    from spmv_tpu.parallel import make_mesh

    A = power_law_csr(400, 400, 4000, seed=8)
    x = np.random.default_rng(2).standard_normal(400).astype(np.float32)
    dist = distribute_csr(A, make_mesh("shards"))
    y = np.asarray(dist.matvec(x))
    np.testing.assert_allclose(y, spmv_ref(A, x, np.float64),
                               rtol=2e-5, atol=1e-5)


@pytest.mark.parametrize("ring", ["plus_times", "max_plus"])
def test_shard_matvec_kernel_choice(ring):
    """Each shard runs the merge-path kernel for a built-in ring and the
    plain gather + segment reduce for a user-defined one."""
    import jax.numpy as jnp

    from spmv_tpu import PLUS_TIMES, Semiring

    sr = PLUS_TIMES if ring == "plus_times" else Semiring(
        "max_plus", lambda: float("-inf"), lambda a, x: a + x,
        lambda acc, v: jnp.maximum(acc, v))
    A = power_law_csr(300, 300, 3000, seed=13)
    x = np.random.default_rng(13).standard_normal(300).astype(np.float32)
    dist = distribute_csr(A, _mesh(4))
    xd = dist.shard_x(x)
    jaxpr = str(jax.make_jaxpr(lambda v: dist.matvec(v, semiring=sr))(xd))
    assert ("merge_path_spmv_plus_times" in jaxpr) == (sr is PLUS_TIMES)
    y = np.asarray(dist.matvec(xd, semiring=sr))
    np.testing.assert_allclose(
        y, spmv_ref_semiring(A, x, sr, y_dtype=np.float64), rtol=2e-5,
        atol=1e-5)
