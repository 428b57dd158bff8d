"""Native C++ host runtime vs pure-Python oracle parity.

The native library (spmv_tpu/native/host.cpp) re-implements the host
layer the reference keeps in C++ (loader ref: include/load.hpp,
merge-path planning ref: merge_based/dispatch_spmv_orig.cuh:104-148);
the Python implementations are the semantics oracle. These tests pin
the two against each other on representative and adversarial inputs.
"""

import io
import os
import tempfile

import numpy as np
import pytest

from spmv_tpu import native
from spmv_tpu.formats import COO, coo_to_csr
from spmv_tpu.io.generate import power_law_csr, random_csr
from spmv_tpu.io.matrix_market import read_matrix_market, write_matrix_market

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native library unavailable"
)


def _write(tmp_path, text):
    p = os.path.join(tmp_path, "m.mtx")
    with open(p, "w") as f:
        f.write(text)
    return p


class TestMMRead:
    def test_general_real(self, tmp_path):
        p = _write(tmp_path, (
            "%%MatrixMarket matrix coordinate real general\n"
            "% a comment\n\n"
            "3 4 3\n"
            "1 1 2.5\n"
            "3 2 -1e-3\n"
            "2 4 7\n"
        ))
        nr, nc, r, c, v = native.mm_read(p)
        assert (nr, nc) == (3, 4)
        np.testing.assert_array_equal(r, [0, 2, 1])
        np.testing.assert_array_equal(c, [0, 1, 3])
        np.testing.assert_allclose(v, [2.5, -1e-3, 7.0])

    def test_matches_python_reader(self, tmp_path):
        A = random_csr(60, 45, 400, seed=3)
        p = os.path.join(tmp_path, "rt.mtx")
        write_matrix_market(p, A)
        nat = read_matrix_market(p, as_csr=True)
        pyr = read_matrix_market(p, as_csr=True, use_native=False)
        np.testing.assert_array_equal(np.asarray(nat.Ap), np.asarray(pyr.Ap))
        np.testing.assert_array_equal(np.asarray(nat.Aj), np.asarray(pyr.Aj))
        np.testing.assert_allclose(np.asarray(nat.Ax), np.asarray(pyr.Ax),
                                   rtol=1e-6)

    def test_symmetric_expansion(self, tmp_path):
        p = _write(tmp_path, (
            "%%MatrixMarket matrix coordinate real symmetric\n"
            "3 3 3\n"
            "1 1 5\n"
            "2 1 1.5\n"
            "3 2 2.5\n"
        ))
        nr, nc, r, c, v = native.mm_read(p)
        assert len(r) == 5  # 3 + 2 off-diagonal mirrors
        d = np.zeros((3, 3))
        d[r, c] = v
        np.testing.assert_allclose(d, d.T)

    def test_skew_symmetric(self, tmp_path):
        p = _write(tmp_path, (
            "%%MatrixMarket matrix coordinate real skew-symmetric\n"
            "2 2 1\n"
            "2 1 4\n"
        ))
        _, _, r, c, v = native.mm_read(p)
        d = np.zeros((2, 2))
        d[r, c] = v
        np.testing.assert_allclose(d, -d.T)

    def test_pattern(self, tmp_path):
        p = _write(tmp_path, (
            "%%MatrixMarket matrix coordinate pattern general\n"
            "2 2 2\n"
            "1 2\n"
            "2 1\n"
        ))
        _, _, r, c, v = native.mm_read(p)
        np.testing.assert_allclose(v, [1.0, 1.0])

    def test_exponent_forms(self, tmp_path):
        p = _write(tmp_path, (
            "%%MatrixMarket matrix coordinate real general\n"
            "1 1 1\n"
            "1 1 -3.25E+2\n"
        ))
        _, _, _, _, v = native.mm_read(p)
        np.testing.assert_allclose(v, [-325.0])

    def test_rejects_zero_based(self, tmp_path):
        p = _write(tmp_path, (
            "%%MatrixMarket matrix coordinate real general\n"
            "2 2 1\n"
            "0 1 3\n"
        ))
        with pytest.raises(ValueError):
            native.mm_read(p)

    def test_rejects_bad_banner(self, tmp_path):
        p = _write(tmp_path, "%%NotMatrixMarket x y z w\n1 1 0\n")
        with pytest.raises(ValueError):
            native.mm_read(p)

    def test_unsupported_falls_back(self, tmp_path):
        # complex field: native raises NotImplementedError so the
        # Python reader takes over (and itself rejects complex).
        p = _write(tmp_path, (
            "%%MatrixMarket matrix coordinate complex general\n"
            "1 1 1\n"
            "1 1 1.0 0.0\n"
        ))
        with pytest.raises(NotImplementedError):
            native.mm_read(p)


class TestCooToCsr:
    def test_matches_numpy(self):
        rng = np.random.default_rng(0)
        n_rows, nnz = 50, 300
        rows = rng.integers(0, n_rows, nnz).astype(np.int32)
        cols = rng.integers(0, 40, nnz).astype(np.int32)
        vals = rng.standard_normal(nnz).astype(np.float32)
        coo = COO(n_rows, 40, rows, cols, vals)
        os.environ["SPMV_TPU_NO_NATIVE"] = "1"
        try:
            # force-NumPy conversion for the oracle
            import importlib

            ref = coo_to_csr(coo)
        finally:
            del os.environ["SPMV_TPU_NO_NATIVE"]
        Ap, Aj, perm = native.coo_to_csr_perm(n_rows, rows, cols)
        np.testing.assert_array_equal(Ap, np.asarray(ref.Ap))
        np.testing.assert_array_equal(Aj, np.asarray(ref.Aj))
        np.testing.assert_allclose(vals[perm], np.asarray(ref.Ax))

    def test_stability(self):
        # duplicates within a row keep input order (ref: load.hpp:420-474)
        rows = np.array([1, 1, 1], np.int32)
        cols = np.array([5, 5, 2], np.int32)
        Ap, Aj, perm = native.coo_to_csr_perm(3, rows, cols)
        np.testing.assert_array_equal(Aj, [5, 5, 2])
        np.testing.assert_array_equal(perm, [0, 1, 2])


class TestSpgemmSymbolic:
    def test_matches_numpy_symbolic(self):
        import os

        import spmv_tpu.native as n
        from spmv_tpu.io.generate import power_law_csr, random_csr
        from spmv_tpu.kernels.spgemm import _spgemm_symbolic

        if not n.available():
            pytest.skip("native unavailable")
        A = power_law_csr(2000, 1500, 20000, alpha=1.5, seed=1)
        B = random_csr(1500, 1800, 15000, seed=2)
        sym = _spgemm_symbolic(A, B)
        os.environ["SPMV_TPU_NO_NATIVE"] = "1"
        try:
            saved = n._lib, n._tried
            n._lib, n._tried = None, True
            ref = _spgemm_symbolic(A, B)
            n._lib, n._tried = saved
        finally:
            del os.environ["SPMV_TPU_NO_NATIVE"]
        for k in ("Cp", "Cj", "v_ap"):
            np.testing.assert_array_equal(sym[k], ref[k])
        assert sym["n_triples"] == ref["n_triples"]
        # triple lists may be permuted WITHIN a group (the numeric
        # reduce is order-free); compare group-canonicalized
        g = np.repeat(np.arange(sym["Cj"].shape[0]),
                      np.diff(sym["v_ap"]))
        for key in ("srcA", "srcB"):
            o1 = np.lexsort((sym[key], g))
            o2 = np.lexsort((ref[key], g))
            np.testing.assert_array_equal(sym[key][o1], ref[key][o2])

    def test_empty_product(self):
        import spmv_tpu.native as n
        from spmv_tpu.io.generate import random_csr
        from spmv_tpu.kernels.spgemm import spgemm

        if not n.available():
            pytest.skip("native unavailable")
        # B's rows touched by A's columns are all empty
        A = random_csr(50, 40, 100, seed=3)
        from spmv_tpu.formats import CSR

        B = CSR(40, 60, np.zeros(41, np.int64), np.zeros(0, np.int64),
                np.zeros(0, np.float32))
        C = spgemm(A, B)
        assert C.nnz == 0 and C.shape == (50, 60)
