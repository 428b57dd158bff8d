"""spmv_tpu — a sparse linear-algebra library on JAX, for NVIDIA Hopper.

A from-scratch JAX/XLA/Pallas rebuild of the capability set of the CUDA
kernel zoo in peakcrosser7/spmv-samples (reference: /root/reference):

- COO/CSR containers with 5-way dtype genericity
  (ref: include/load.hpp:131-161, include/spmv.h:29-34)
- Matrix Market I/O with symmetric expansion and pattern support
  (ref: include/load.hpp:163-408)
- A CPU oracle, plain and semiring-generalized
  (ref: include/spmv/cpu_navie.hpp:3-35)
- A string-dispatched kernel registry (ref: include/spmv.h:18-27)
- The reference's SpMV kind names, each running one of three
  implementations: a merge-path Pallas kernel for Hopper (equal-nnz
  tiles, in-tile reduce-by-key, atomic fix-up of rows that cross tiles;
  the CUB merge analog), the plain XLA path, or DIA for banded
  matrices; all generalized over semirings.
- A benchmark harness with correctness deltas and roofline-audited
  timing (ref: main.cu:84-113).
- A multi-device distribution layer (mesh + shard_map) that the
  single-GPU reference does not have.
"""

from spmv_tpu.formats import COO, CSR, coo_to_csr, csr_to_dense
from spmv_tpu.ops.semiring import (
    Semiring,
    PLUS_TIMES,
    MIN_PLUS,
    MAX_TIMES,
    OR_AND,
)
from spmv_tpu.ops.registry import (
    register,
    get_kernel,
    list_kinds,
    spmv,
    SpMV,
)
from spmv_tpu.ops.reference import spmv_ref, spmv_ref_semiring

# Importing the kernel modules registers all built-in kinds.
from spmv_tpu import kernels as _kernels  # noqa: F401
from spmv_tpu.kernels.spmm import spmm
from spmv_tpu.kernels.spgemm import spgemm
from spmv_tpu.kernels.trisolve import sptrsv, ilu0, ilu0_apply
from spmv_tpu.solvers import cg, bicgstab, gmres
from spmv_tpu.ops.autodiff import SparseOperator, spmv_values
from spmv_tpu.io.matrix_market import read_matrix_market, write_matrix_market

__version__ = "0.1.0"

__all__ = [
    "COO",
    "CSR",
    "coo_to_csr",
    "csr_to_dense",
    "Semiring",
    "PLUS_TIMES",
    "MIN_PLUS",
    "MAX_TIMES",
    "OR_AND",
    "register",
    "get_kernel",
    "list_kinds",
    "spmv",
    "SpMV",
    "spmm",
    "spgemm",
    "sptrsv",
    "ilu0",
    "ilu0_apply",
    "cg",
    "bicgstab",
    "gmres",
    "SparseOperator",
    "spmv_values",
    "spmv_ref",
    "spmv_ref_semiring",
    "read_matrix_market",
    "write_matrix_market",
]
