"""Tests for SpMM (kernels/spmm.py): ragged and single-column B,
empty matrices, skew and semirings against a dense float64 product."""

import numpy as np
import pytest

from spmv_tpu import MIN_PLUS, spmm
from spmv_tpu.formats import COO, coo_to_csr
from spmv_tpu.io.generate import banded_csr, random_csr


def _ref(A, X):
    d = A.to_dense().astype(np.float64)
    return d @ X.astype(np.float64)


def _check(A, B=128, seed=0, rtol=2e-4, atol=1e-4):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((A.n_cols, B)).astype(np.float32)
    Y = np.asarray(spmm(A, X))
    np.testing.assert_allclose(Y, _ref(A, X), rtol=rtol, atol=atol)


def test_spmm_xla_matches():
    A = random_csr(1200, 1000, 10000, seed=5)
    _check(A)


def test_spmm_xla_wide_B():
    _check(random_csr(800, 700, 6000, seed=2), B=256)


def test_spmm_semiring():
    A = banded_csr(600, bandwidth=1, seed=6)  # no duplicate coordinates
    rng = np.random.default_rng(6)
    X = rng.standard_normal((A.n_cols, 128)).astype(np.float32)
    Y = np.asarray(spmm(A, X, semiring=MIN_PLUS))
    d = A.to_dense().astype(np.float64)
    mask = d != 0
    full = np.where(mask, d, np.inf)
    ref = np.min(full[:, :, None] + X[None, :, :], axis=1)
    np.testing.assert_allclose(Y, ref, rtol=1e-5, atol=1e-5)


def test_spmm_empty_rows():
    rng = np.random.default_rng(7)
    rows = rng.integers(0, 300, 2500).astype(np.int32)  # rows 300+ empty
    cols = rng.integers(0, 700, 2500).astype(np.int32)
    A = coo_to_csr(COO(900, 700, rows, cols,
                       rng.standard_normal(2500).astype(np.float32)))
    _check(A)


def test_spmm_window_random():
    _check(random_csr(600, 500, 5000, seed=8))


def test_spmm_window_skewed():
    from spmv_tpu.io.generate import power_law_csr

    _check(power_law_csr(800, 700, 8000, alpha=1.5, seed=9))


def test_spmm_window_small_cols():
    # n_cols < 128
    _check(random_csr(300, 90, 1500, seed=10))


def test_spmm_window_ragged_B():
    _check(random_csr(400, 350, 3000, seed=11), B=70)
    _check(random_csr(400, 350, 3000, seed=12), B=200)


def test_spmm_window_B1():
    _check(random_csr(500, 400, 4000, seed=13), B=1)


def test_spmm_window_semiring():
    A = banded_csr(600, bandwidth=1, seed=14)
    rng = np.random.default_rng(14)
    X = rng.standard_normal((A.n_cols, 128)).astype(np.float32)
    Y = np.asarray(spmm(A, X, semiring=MIN_PLUS))
    d = A.to_dense().astype(np.float64)
    mask = d != 0
    full = np.where(mask, d, np.inf)
    ref = np.min(full[:, :, None] + X[None, :, :], axis=1)
    np.testing.assert_allclose(Y, ref, rtol=1e-5, atol=1e-5)


def test_spmm_window_empty():
    import jax.numpy as jnp

    from spmv_tpu.formats import CSR

    A = CSR(10, 8, np.zeros(11, np.int32), np.zeros(0, np.int32),
            np.zeros(0, np.float32))
    Y = np.asarray(spmm(A, jnp.zeros((8, 5), jnp.float32)))
    np.testing.assert_array_equal(Y, np.zeros((10, 5)))
