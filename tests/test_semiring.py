"""Semiring SpMV algebraic tests (merge_genl parity, SURVEY §4)."""

import numpy as np
import pytest

from spmv_tpu import spmv, spmv_ref_semiring
from spmv_tpu.ops.semiring import MIN_PLUS, MAX_TIMES, OR_AND, PLUS_TIMES
from spmv_tpu.io.generate import power_law_csr, random_csr
from spmv_tpu.formats import COO, coo_to_csr

SEMIRING_KINDS = ["xla", "csr_vector", "light_vec", "merge_genl", "merge"]
SEMIRINGS = [MIN_PLUS, MAX_TIMES, OR_AND]


@pytest.fixture(scope="module")
def graph():
    # Positive weights (edge lengths / probabilities).
    rng = np.random.default_rng(7)
    A = random_csr(120, 120, 900, seed=7)
    Ax = np.abs(np.asarray(A.Ax)) + 0.1
    return coo_to_csr(COO(120, 120, A.row_ids(), np.asarray(A.Aj), Ax.astype(np.float32)))


@pytest.mark.parametrize("kind", SEMIRING_KINDS)
@pytest.mark.parametrize("sr", SEMIRINGS, ids=lambda s: s.name)
def test_semiring_matches_oracle(graph, kind, sr):
    rng = np.random.default_rng(11)
    x = np.abs(rng.standard_normal(graph.n_cols)).astype(np.float32)
    if sr is OR_AND:
        x = (x > 0.5).astype(np.float32)
        graph_b = coo_to_csr(COO(graph.n_rows, graph.n_cols, graph.row_ids(),
                                 np.asarray(graph.Aj),
                                 np.ones(graph.nnz, np.float32)))
        A = graph_b
    else:
        A = graph
    y = np.asarray(spmv(kind, A, x, semiring=sr))
    y_ref = spmv_ref_semiring(A, x, sr, y_dtype=np.float32)
    np.testing.assert_allclose(y, y_ref, rtol=2e-5, atol=1e-5,
                               err_msg=f"{kind}/{sr.name}")


def test_min_plus_empty_rows_give_identity():
    # Rows with no edges must yield +inf (the min identity), matching
    # the oracle's initialize() semantics (ref: cpu_navie.hpp:20-35).
    A = coo_to_csr(COO(5, 5, np.array([1], np.int32), np.array([2], np.int32),
                       np.array([3.0], np.float32)))
    x = np.zeros(5, np.float32)
    for kind in SEMIRING_KINDS:
        y = np.asarray(spmv(kind, A, x, semiring=MIN_PLUS))
        assert np.isinf(y[[0, 2, 3, 4]]).all(), kind
        assert y[1] == 3.0, kind


@pytest.mark.parametrize("sr", SEMIRINGS, ids=lambda s: s.name)
def test_semiring_skewed_matrix(sr):
    A = power_law_csr(150, 150, 3000, seed=9)
    Ax = np.abs(np.asarray(A.Ax)).astype(np.float32) + 0.01
    A = coo_to_csr(COO(150, 150, A.row_ids(), np.asarray(A.Aj), Ax))
    x = np.abs(np.random.default_rng(1).standard_normal(150)).astype(np.float32)
    y = np.asarray(spmv("merge_genl", A, x, semiring=sr))
    y_ref = spmv_ref_semiring(A, x, sr, y_dtype=np.float32)
    np.testing.assert_allclose(y, y_ref, rtol=2e-5, atol=1e-5)


def test_plus_times_is_default():
    A = random_csr(30, 30, 100, seed=2)
    x = np.ones(30, np.float32)
    y1 = np.asarray(spmv("merge", A, x))
    y2 = np.asarray(spmv("merge", A, x, semiring=PLUS_TIMES))
    np.testing.assert_array_equal(y1, y2)


def test_unsupported_semiring_kind_raises():
    A = random_csr(10, 10, 20, seed=3)
    with pytest.raises(ValueError):
        spmv("dense", A, np.ones(10, np.float32), semiring=MIN_PLUS)


def test_max_times_negative_products_folds_identity():
    """max_times has identity 0: a row whose products are ALL negative
    must come out 0 (the oracle's acc = initialize() participates in
    every row, ref: cpu_navie.hpp:20-35). Regression: a kernel that
    skips the fold returns the max negative product."""
    from spmv_tpu import spmv
    from spmv_tpu.io.generate import power_law_csr
    from spmv_tpu.ops.reference import spmv_ref_semiring
    from spmv_tpu.ops.semiring import MAX_TIMES

    A = power_law_csr(1 << 13, 1 << 13, 30000, alpha=1.5, seed=1)
    x = np.random.default_rng(0).standard_normal(1 << 13).astype(np.float32)
    y_ref = np.asarray(spmv_ref_semiring(A, x, MAX_TIMES))
    for kind in ("merge_genl", "stream"):
        y = np.asarray(spmv(kind, A, x, semiring=MAX_TIMES))
        np.testing.assert_allclose(y, y_ref, rtol=1e-5, atol=1e-5,
                                   err_msg=kind)
