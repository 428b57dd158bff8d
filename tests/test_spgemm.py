"""SpGEMM tests: pattern + values vs scipy, semiring products.

North-star component (SURVEY §7.5): CSR x CSR with a host symbolic
phase and a device numeric phase on the plain path (virtual-CSR
reduction; see kernels/spgemm.py).
"""

import numpy as np
import pytest
import scipy.sparse as sp

from spmv_tpu import spgemm
from spmv_tpu.formats import COO, coo_to_csr
from spmv_tpu.io.generate import power_law_csr, random_csr
from spmv_tpu.ops.semiring import MIN_PLUS


def _to_scipy(A):
    return sp.csr_matrix(
        (np.asarray(A.Ax), np.asarray(A.Aj), np.asarray(A.Ap)),
        shape=A.shape)


def _check_plus_times(A, B):
    C = spgemm(A, B)
    C_ref = (_to_scipy(A) @ _to_scipy(B)).sorted_indices()
    Cs = _to_scipy(C)
    # pattern: ours keeps structural zeros; scipy's @ does too (it only
    # merges duplicates), so patterns must match exactly
    np.testing.assert_array_equal(Cs.indptr, C_ref.indptr)
    np.testing.assert_array_equal(Cs.indices, C_ref.indices)
    np.testing.assert_allclose(Cs.data, C_ref.data, rtol=2e-4, atol=1e-4)


@pytest.mark.parametrize("seed", [1, 3])
def test_spgemm_random(seed):
    A = random_csr(300, 400, 3000, seed=seed)
    B = random_csr(400, 250, 2800, seed=seed + 1)
    _check_plus_times(A, B)


def test_spgemm_power_law():
    A = power_law_csr(500, 500, 6000, alpha=1.5, seed=3)
    B = power_law_csr(500, 500, 5000, alpha=1.5, seed=4)
    _check_plus_times(A, B)


def test_spgemm_square_self():
    A = random_csr(200, 200, 1500, seed=5)
    _check_plus_times(A, A)


def test_spgemm_empty_result():
    # A's columns only hit empty rows of B
    A = coo_to_csr(COO(4, 6, np.array([0, 2], np.int32),
                       np.array([5, 5], np.int32),
                       np.array([1.0, 2.0], np.float32)))
    B = coo_to_csr(COO(6, 3, np.array([0], np.int32),
                       np.array([1], np.int32),
                       np.array([3.0], np.float32)))
    C = spgemm(A, B)
    assert C.nnz == 0
    assert C.shape == (4, 3)


def test_spgemm_shape_mismatch():
    A = random_csr(10, 11, 30, seed=0)
    B = random_csr(12, 10, 30, seed=0)
    with pytest.raises(ValueError, match="mismatch"):
        spgemm(A, B)


def test_spgemm_min_plus_apsp_step():
    # One APSP relaxation: D2 = D (min.+) D on a small digraph.
    rng = np.random.default_rng(7)
    n = 60
    A = random_csr(n, n, 500, seed=7)
    # dedupe (i, k) pairs: the dense reference below is last-write-wins,
    # which only matches semiring semantics for a simple graph
    rr, cc = A.row_ids(), np.asarray(A.Aj)
    _, keep = np.unique(rr.astype(np.int64) * n + cc, return_index=True)
    W = (np.abs(np.asarray(A.Ax)[keep]).astype(np.float32) + 0.1)
    D = coo_to_csr(COO(n, n, rr[keep], cc[keep], W))
    C = spgemm(D, D, semiring=MIN_PLUS)
    # dense min-plus reference: ref[i, j] = min_k (D[i,k] + D[k,j])
    Dd = np.full((n, n), np.inf, np.float64)
    Dd[np.asarray(D.row_ids()), np.asarray(D.Aj)] = W
    ref = (Dd[:, :, None] + Dd[None, :, :]).min(axis=1)
    # compare on C's structural pattern (absent = +inf semiring zero)
    Cp = np.asarray(C.Ap)
    Cjj = np.asarray(C.Aj)
    Cx = np.asarray(C.Ax)
    for i in range(n):
        for t in range(Cp[i], Cp[i + 1]):
            assert abs(Cx[t] - ref[i, Cjj[t]]) < 1e-4, (i, Cjj[t])


def test_spgemm_plan_cached_and_value_correct_for_distinct_B():
    A = random_csr(50, 50, 300, seed=8)
    B1 = random_csr(50, 50, 280, seed=9)
    B2 = random_csr(50, 50, 280, seed=10)
    _check_plus_times(A, B1)
    _check_plus_times(A, B2)  # distinct plan per B identity
    _check_plus_times(A, B1)  # cached plan still valid
