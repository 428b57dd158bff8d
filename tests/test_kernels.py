"""Kernel-zoo equivalence tests vs the CPU oracle.

The test pyramid the reference lacks (SURVEY §4): every registered
kind is checked against `spmv_ref` on synthetic matrices spanning the
structural regimes (banded/regular, uniform random, power-law skew,
empty rows, single column), with explicit float tolerances rather than
the reference's eyeballed delta (ref: main.cu:84-97).
"""

import numpy as np
import pytest

import spmv_tpu
from spmv_tpu import spmv, spmv_ref, list_kinds
from spmv_tpu.io.generate import banded_csr, power_law_csr, random_csr
from spmv_tpu.formats import COO, coo_to_csr

DEVICE_KINDS = [
    "xla",
    "csr_scalar",
    "csr_vector",
    "csr_vector_shfl",
    "csr_vector_shfl2",
    "csr_vector_ell",
    "csr_vector_shfl_ell",
    "csr_vector_shfl2_ell",
    "light_vec",
    "light_warp",
    "light_vec_ell",
    "light_warp_ell",
    "merge",
    "merge_stock",
    "merge_genl",
    "merge_tiled",
]


def _check(A, kind, rtol=2e-5, atol=5e-5, seed=1):
    # float32 sums taken in another order than the float64 oracle's:
    # the merge-path tree, and atomics across tiles
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(A.n_cols).astype(np.float32)
    y = np.asarray(spmv(kind, A, x))
    y_ref = spmv_ref(A, x, y_dtype=np.float64)
    np.testing.assert_allclose(y, y_ref, rtol=rtol, atol=atol, err_msg=kind)


@pytest.fixture(scope="module")
def matrices():
    return {
        "banded": banded_csr(300, bandwidth=3, seed=0),
        "random": random_csr(200, 150, 2000, seed=1),
        "powerlaw": power_law_csr(400, 300, 5000, seed=2),
    }


@pytest.mark.parametrize("kind", DEVICE_KINDS)
@pytest.mark.parametrize("mat", ["banded", "random", "powerlaw"])
def test_kind_matches_oracle(matrices, kind, mat):
    _check(matrices[mat], kind)


@pytest.mark.parametrize("kind", DEVICE_KINDS)
def test_empty_rows(kind):
    # Matrix with many empty rows and one giant row.
    rng = np.random.default_rng(3)
    n = 257
    rows = np.concatenate([np.full(500, 100), rng.integers(200, 210, 40)])
    cols = rng.integers(0, 64, rows.size)
    vals = rng.standard_normal(rows.size)
    A = coo_to_csr(COO(n, 64, rows.astype(np.int32), cols.astype(np.int32),
                       vals.astype(np.float32)))
    _check(A, kind, rtol=5e-5, atol=5e-5)


@pytest.mark.parametrize("kind", DEVICE_KINDS)
def test_single_column(kind):
    # 1-col degenerate (ref: dispatch_spmv_orig.cuh:560-597 early-out).
    rng = np.random.default_rng(4)
    rows = np.arange(0, 50, 2)
    A = coo_to_csr(COO(50, 1, rows.astype(np.int32),
                       np.zeros(rows.size, np.int32),
                       rng.standard_normal(rows.size).astype(np.float32)))
    _check(A, kind)


@pytest.mark.parametrize("kind", DEVICE_KINDS)
def test_empty_matrix(kind):
    A = coo_to_csr(COO(10, 10, np.zeros(0, np.int32), np.zeros(0, np.int32),
                       np.zeros(0, np.float32)))
    x = np.ones(10, np.float32)
    y = np.asarray(spmv(kind, A, x))
    np.testing.assert_allclose(y, np.zeros(10), atol=0)


def test_registry_unknown_kind():
    A = banded_csr(10, 1)
    with pytest.raises(KeyError, match="unknown SpMV kind"):
        spmv("nope", A, np.ones(10, np.float32))


def test_reference_aliases_present():
    kinds = list_kinds(include_aliases=True)
    # All 9 reference registry names (ref: spmv.h:18-27) must dispatch
    # (cusparse→xla, cusp→csr_vector, ..., cub_merge→merge_stock).
    for ref_kind in ["cusparse", "cusp", "cusp1", "cusp2", "light_vec",
                     "light_warp", "cub_merge", "merge", "merge_genl"]:
        assert ref_kind in kinds, ref_kind


def test_low_level_signature():
    # SpMV(kind, n_rows, n_cols, nnz, Ap, Aj, Ax, x) (ref: spmv.h:29-34).
    A = banded_csr(64, 2, seed=5)
    x = np.linspace(0, 1, 64).astype(np.float32)
    y = spmv_tpu.SpMV("xla", A.n_rows, A.n_cols, A.nnz,
                      np.asarray(A.Ap), np.asarray(A.Aj), np.asarray(A.Ax), x)
    np.testing.assert_allclose(np.asarray(y), spmv_ref(A, x), rtol=2e-5, atol=1e-5)


def test_plan_cache_reuse(matrices):
    A = matrices["banded"]
    x = np.ones(A.n_cols, np.float32)
    y1 = np.asarray(spmv("merge", A, x))
    y2 = np.asarray(spmv("merge", A, x))
    np.testing.assert_array_equal(y1, y2)


@pytest.mark.parametrize("kind", ["xla", "stream", "merge", "csr_vector"])
def test_bfloat16_values(kind):
    """bf16 A/x runs end-to-end on every implementation; the merge-path
    kernel accumulates in f32 so error stays at bf16 input-rounding
    level (no reference analog)."""
    import ml_dtypes

    from spmv_tpu.formats import CSR
    from spmv_tpu.io.generate import power_law_csr

    A = power_law_csr(3000, 3000, 24000, seed=1)
    Ab = CSR(A.n_rows, A.n_cols, A.Ap, A.Aj,
             np.asarray(A.Ax).astype(ml_dtypes.bfloat16))
    x = np.random.default_rng(0).standard_normal(3000)
    yref = spmv_ref(A, x.astype(np.float32))
    y = np.asarray(spmv(kind, Ab, x.astype(ml_dtypes.bfloat16)))
    rel = np.abs(y.astype(np.float32) - yref).max() / max(
        1.0, np.abs(yref).max())
    assert rel < 0.08, rel
