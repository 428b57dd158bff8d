"""DIA (diagonal-format) kind: correctness, routing, plain fallback."""

import numpy as np
import pytest

from spmv_tpu import spmv, spmv_ref
from spmv_tpu.io.generate import banded_csr, power_law_csr
from spmv_tpu.kernels.dia import diag_profile
from spmv_tpu.ops.reference import spmv_ref_semiring
from spmv_tpu.ops.registry import implementation
from spmv_tpu.ops.semiring import MIN_PLUS


def test_dia_matches_oracle_banded():
    A = banded_csr(3000, bandwidth=5, seed=0)
    x = np.random.default_rng(1).standard_normal(3000).astype(np.float32)
    y = np.asarray(spmv("dia", A, x))
    np.testing.assert_allclose(y, spmv_ref(A, x, np.float64),
                               rtol=2e-5, atol=1e-5)


def test_dia_semiring():
    A = banded_csr(1000, bandwidth=3, seed=2)
    x = np.random.default_rng(2).standard_normal(1000).astype(np.float32)
    y = np.asarray(spmv("dia", A, x, semiring=MIN_PLUS))
    y_ref = np.asarray(spmv_ref_semiring(A, x, MIN_PLUS))
    both_inf = np.isinf(y) & np.isinf(y_ref)
    np.testing.assert_allclose(np.where(both_inf, 0.0, y - y_ref), 0.0,
                               atol=1e-5)


def test_dia_fallback_nondiagonal():
    """Non-diagonal matrices run the plain path, and say so."""
    A = power_law_csr(2000, 2000, 20000, seed=2)
    assert diag_profile(A) is None
    x = np.random.default_rng(2).standard_normal(2000).astype(np.float32)
    assert implementation("dia", A, x) == "plain"
    y = np.asarray(spmv("dia", A, x))
    np.testing.assert_allclose(y, spmv_ref(A, x, np.float64),
                               rtol=2e-4, atol=1e-4)


def test_csr_vector_routes_banded_to_dia():
    """No hidden format switch: csr_vector runs the merge-path kernel
    on banded input too, and `dia` is what runs DIA."""
    A = banded_csr(2000, bandwidth=4, seed=1)
    assert diag_profile(A) is not None
    x = np.random.default_rng(0).standard_normal(2000).astype(np.float32)
    assert implementation("csr_vector", A, x) == "hopper"
    assert implementation("dia", A, x) == "dia"
    y = np.asarray(spmv("csr_vector", A, x))
    np.testing.assert_allclose(y, spmv_ref(A, x, np.float64),
                               rtol=2e-5, atol=1e-5)
