"""Sparse matrix containers: COO and CSR.

A re-design of the reference's host containers
(ref: include/load.hpp:131-161). The reference parameterizes its whole
API over five independent types — ``index_t, offset_t, mat_value_t,
vec_x_value_t, vec_y_value_t`` (ref: include/spmv.h:29-34); here that
genericity is carried by dtypes: ``Aj.dtype`` (index), ``Ap.dtype``
(offset), ``Ax.dtype`` (matrix value), with x/y dtypes free at call
time.

Arrays may be NumPy or JAX arrays; kernels move them to device as
needed. Containers are registered as JAX pytrees so they can cross
``jit`` boundaries.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import numpy as np

Array = Any  # np.ndarray | jax.Array


def _asnumpy(a: Array) -> np.ndarray:
    return np.asarray(a)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(eq=False)  # identity hash: containers key plan caches
class COO:
    """Coordinate-format sparse matrix (ref: include/load.hpp:131-144).

    rows/cols/vals are parallel 1-D arrays of length nnz.
    """

    n_rows: int
    n_cols: int
    rows: Array
    cols: Array
    vals: Array

    @property
    def nnz(self) -> int:
        return int(self.rows.shape[0])

    @property
    def shape(self):
        return (self.n_rows, self.n_cols)

    def tree_flatten(self):
        return (self.rows, self.cols, self.vals), (self.n_rows, self.n_cols)

    @classmethod
    def tree_unflatten(cls, aux, children):
        rows, cols, vals = children
        return cls(aux[0], aux[1], rows, cols, vals)

    def sort_by_row(self) -> "COO":
        """Stable sort entries by (row, col)."""
        r, c, v = _asnumpy(self.rows), _asnumpy(self.cols), _asnumpy(self.vals)
        order = np.lexsort((c, r))
        return COO(self.n_rows, self.n_cols, r[order], c[order], v[order])

    def to_dense(self) -> np.ndarray:
        d = np.zeros((self.n_rows, self.n_cols), dtype=_asnumpy(self.vals).dtype)
        np.add.at(d, (_asnumpy(self.rows), _asnumpy(self.cols)), _asnumpy(self.vals))
        return d


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(eq=False)  # identity hash: containers key plan caches
class CSR:
    """Compressed-sparse-row matrix (ref: include/load.hpp:146-161).

    Ap: (n_rows+1,) row offsets (``offset_t`` analog — dtype is the
        offset type; use int64 when nnz may exceed int32).
    Aj: (nnz,) column indices (``index_t`` analog).
    Ax: (nnz,) values (``mat_value_t`` analog).
    """

    n_rows: int
    n_cols: int
    Ap: Array
    Aj: Array
    Ax: Array

    @property
    def nnz(self) -> int:
        return int(self.Aj.shape[0])

    @property
    def shape(self):
        return (self.n_rows, self.n_cols)

    @property
    def mean_nnz_per_row(self) -> float:
        return self.nnz / max(self.n_rows, 1)

    def tree_flatten(self):
        return (self.Ap, self.Aj, self.Ax), (self.n_rows, self.n_cols)

    @classmethod
    def tree_unflatten(cls, aux, children):
        Ap, Aj, Ax = children
        return cls(aux[0], aux[1], Ap, Aj, Ax)

    def row_lengths(self) -> np.ndarray:
        ap = _asnumpy(self.Ap)
        return ap[1:] - ap[:-1]

    def row_ids(self) -> np.ndarray:
        """Per-nnz row index (the COO row array of this CSR)."""
        ap = _asnumpy(self.Ap).astype(np.int64)
        return np.repeat(
            np.arange(self.n_rows, dtype=_asnumpy(self.Aj).dtype),
            ap[1:] - ap[:-1],
        )

    def to_coo(self) -> COO:
        return COO(self.n_rows, self.n_cols, self.row_ids(), _asnumpy(self.Aj), _asnumpy(self.Ax))

    def to_dense(self) -> np.ndarray:
        return self.to_coo().to_dense()

    def transpose(self) -> "CSR":
        """A^T as CSR (host-side stable counting sort over columns).

        The reference has no transpose; it rounds out the container API
        for column-access algorithms (PageRank on out-link graphs,
        A^T A products) without a CSC twin type."""
        coo = self.to_coo()
        flipped = COO(self.n_cols, self.n_rows, coo.cols, coo.rows,
                      coo.vals)
        return coo_to_csr(flipped,
                          offset_dtype=_asnumpy(self.Ap).dtype,
                          index_dtype=_asnumpy(self.Aj).dtype)

    def astype(self, value_dtype=None, index_dtype=None, offset_dtype=None) -> "CSR":
        Ap = _asnumpy(self.Ap).astype(offset_dtype) if offset_dtype else self.Ap
        Aj = _asnumpy(self.Aj).astype(index_dtype) if index_dtype else self.Aj
        Ax = _asnumpy(self.Ax).astype(value_dtype) if value_dtype else self.Ax
        return CSR(self.n_rows, self.n_cols, Ap, Aj, Ax)


def coo_to_csr(
    coo: COO,
    offset_dtype=np.int32,
    index_dtype=None,
    sum_duplicates: bool = False,
) -> CSR:
    """COO → CSR via counting sort (ref: include/load.hpp:420-474).

    The reference's ToCsr is a counting sort over rows that preserves
    per-row input order; we match that (stable), then optionally merge
    duplicate (row, col) entries (the reference keeps duplicates; so do
    we by default).
    """
    rows = _asnumpy(coo.rows).astype(np.int64)
    cols = _asnumpy(coo.cols)
    vals = _asnumpy(coo.vals)
    n_rows, n_cols = coo.n_rows, coo.n_cols
    if rows.size and (rows.min() < 0 or rows.max() >= n_rows):
        raise ValueError("COO row index out of range")
    if cols.size and (_asnumpy(cols).min() < 0 or _asnumpy(cols).max() >= n_cols):
        raise ValueError("COO col index out of range")

    # Stable counting sort; the native C++ path (spmv_tpu/native/
    # host.cpp spmv_coo_to_csr) when available, NumPy stable argsort
    # otherwise. Both preserve per-row input order.
    order = None
    i32max = np.iinfo(np.int32).max
    if n_rows <= i32max and n_cols <= i32max and np.issubdtype(cols.dtype, np.integer):
        try:
            from spmv_tpu import native

            if native.available():
                Ap, Aj_n, order = native.coo_to_csr_perm(n_rows, rows, cols)
                Aj = Aj_n.astype(cols.dtype, copy=False)
                Ax = vals[order]
        except (NotImplementedError, ValueError):
            order = None
    if order is None:
        counts = np.bincount(rows, minlength=n_rows).astype(np.int64)
        Ap = np.zeros(n_rows + 1, dtype=np.int64)
        np.cumsum(counts, out=Ap[1:])
        if Ap[-1] != rows.size:
            raise AssertionError("internal: offset sum mismatch")
        order = np.argsort(rows, kind="stable")
        Aj = cols[order]
        Ax = vals[order]

    if sum_duplicates:
        # Sort within rows by column and merge equal (row, col) runs.
        order2 = np.lexsort((Aj, rows[order]))
        r2, j2, x2 = rows[order][order2], Aj[order2], Ax[order2]
        key_change = np.empty(r2.size, dtype=bool)
        key_change[0] = True
        key_change[1:] = (r2[1:] != r2[:-1]) | (j2[1:] != j2[:-1])
        group = np.cumsum(key_change) - 1
        n_groups = int(group[-1]) + 1 if r2.size else 0
        Ax_m = np.zeros(n_groups, dtype=x2.dtype)
        np.add.at(Ax_m, group, x2)
        Aj = j2[key_change]
        r_m = r2[key_change]
        counts = np.bincount(r_m, minlength=n_rows).astype(np.int64)
        Ap = np.zeros(n_rows + 1, dtype=np.int64)
        np.cumsum(counts, out=Ap[1:])
        Ax = Ax_m

    if index_dtype is None:
        index_dtype = _asnumpy(coo.cols).dtype
    max_off = int(Ap[-1])
    if np.dtype(offset_dtype) == np.int32 and max_off > np.iinfo(np.int32).max:
        raise OverflowError(
            f"nnz={max_off} overflows int32 offsets; pass offset_dtype=np.int64"
        )
    return CSR(
        n_rows,
        n_cols,
        Ap.astype(offset_dtype),
        Aj.astype(index_dtype),
        Ax,
    )


def csr_from_dense(dense: np.ndarray, index_dtype=np.int32, offset_dtype=np.int32) -> CSR:
    dense = np.asarray(dense)
    rows, cols = np.nonzero(dense)
    coo = COO(dense.shape[0], dense.shape[1], rows.astype(index_dtype), cols.astype(index_dtype), dense[rows, cols])
    return coo_to_csr(coo, offset_dtype=offset_dtype, index_dtype=index_dtype)


def csr_to_dense(csr: CSR) -> np.ndarray:
    return csr.to_dense()
