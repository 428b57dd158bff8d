"""RCM reordering: permutation validity, bandwidth, SpMV equivalence."""

import numpy as np
import pytest

from spmv_tpu import spmv, spmv_ref
from spmv_tpu.io.generate import banded_csr, power_law_csr, random_csr
from spmv_tpu.ops.reorder import (
    bandwidth,
    permute,
    rcm_permutation,
    rcm_reorder,
)


def _shuffled_banded(n=200, bw=4, seed=0):
    """A matrix that IS low-bandwidth under some relabeling: shuffle a
    banded matrix, so RCM has a known-good answer to approach."""
    A = banded_csr(n, bandwidth=bw, seed=seed)
    rng = np.random.default_rng(seed + 1)
    p = rng.permutation(n)
    return permute(A, p), bw


def test_rcm_is_a_permutation():
    A = random_csr(150, 150, nnz=900, seed=2)
    perm = rcm_permutation(A)
    assert sorted(perm) == list(range(150))


def test_rcm_recovers_banded_bandwidth():
    A_shuf, bw = _shuffled_banded()
    assert bandwidth(A_shuf) > 10 * bw  # the shuffle destroyed locality
    B, _ = rcm_reorder(A_shuf)
    # RCM on a path-like band graph should land near the true bandwidth
    assert bandwidth(B) <= 3 * bw


def test_permute_spmv_equivalence():
    A = power_law_csr(256, 256, nnz=2000, alpha=1.3, seed=6)
    x = np.random.default_rng(4).standard_normal(256).astype(np.float32)
    B, perm = rcm_reorder(A)
    y = spmv_ref(A, x)
    yB = spmv_ref(B, x[perm])
    np.testing.assert_allclose(yB, y[perm], rtol=1e-5, atol=1e-6)


def test_permute_rectangular_rowcol():
    A = random_csr(60, 40, nnz=300, seed=8)
    rp = np.random.default_rng(1).permutation(60)
    cp = np.random.default_rng(2).permutation(40)
    B = permute(A, rp, cp)
    D = A.to_dense()
    np.testing.assert_allclose(B.to_dense(), D[np.ix_(rp, cp)], rtol=1e-6)


def test_permute_preserves_dtypes():
    A = random_csr(50, 50, nnz=200, seed=3, index_dtype=np.int64,
                   offset_dtype=np.int64)
    B = permute(A, np.arange(50)[::-1])
    assert np.asarray(B.Ap).dtype == np.int64
    assert np.asarray(B.Aj).dtype == np.int64


def test_permute_length_check():
    A = random_csr(10, 10, nnz=30, seed=0)
    with pytest.raises(ValueError, match="length"):
        permute(A, np.arange(9))


def test_rcm_rejects_rectangular():
    A = random_csr(10, 12, nnz=30, seed=0)
    with pytest.raises(ValueError, match="square"):
        rcm_permutation(A)


def test_rcm_disconnected_components():
    # block-diagonal: two islands; RCM must visit both
    from spmv_tpu.formats import COO, coo_to_csr

    rows = np.array([0, 1, 2, 5, 6, 7], np.int64)
    cols = np.array([1, 2, 0, 6, 7, 5], np.int64)
    vals = np.ones(6, np.float32)
    A = coo_to_csr(COO(8, 8, rows, cols, vals))
    perm = rcm_permutation(A)
    assert sorted(perm) == list(range(8))


def test_kernel_on_reordered_matrix():
    A = power_law_csr(512, 512, nnz=4000, alpha=1.4, seed=12)
    B, perm = rcm_reorder(A)
    x = np.random.default_rng(9).standard_normal(512).astype(np.float32)
    y = np.asarray(spmv("merge", B, x[perm]))
    np.testing.assert_allclose(y, spmv_ref(A, x)[perm], rtol=1e-3,
                               atol=1e-4)


def test_rcm_shrinks_column_window_count():
    # x-gather locality: how many distinct 128-wide x windows each
    # row block touches; RCM should cut it.
    A_shuf, _ = _shuffled_banded(n=1024, bw=4, seed=5)
    B, _ = rcm_reorder(A_shuf)

    def windows_touched(C, block=128, win=128):
        rows = C.row_ids() // block
        wins = np.asarray(C.Aj) // win
        return len(set(zip(rows.tolist(), wins.tolist())))

    assert windows_touched(B) < windows_touched(A_shuf) / 2
