"""Differentiable SpMV — autodiff support the CUDA reference cannot have.

The reference stops at ``y = A @ x`` (ref: include/spmv.h:29-34); a
JAX library lives inside JAX's transform system, so its
matvec should compose with ``jax.grad`` / ``jax.vjp`` / ``jax.jit``.
Two paths, by what is being differentiated:

1. **Fixed structure and values, grad w.r.t. x** (the common case:
   solvers, PageRank-style fixed operators, GNNs with fixed adjacency).
   `SparseOperator` wraps any registered kernel kind in a
   ``jax.custom_vjp`` whose backward pass is one SpMV with the cached
   transpose ``A^T`` — both directions run the registered kernels,
   and both device copies amortize across calls.

2. **Grad w.r.t. the nonzero values too** (learned edge weights).
   `spmv_values(A, Ax, x)` takes the values as a live JAX array over
   the static sparsity pattern and computes gather → multiply →
   sorted-segment-sum in plain jnp, so JAX's native autodiff (both
   JVP and VJP) applies with no custom rules:
   ``d/dAx[k] = g[row(k)] * x[col(k)]`` falls out of the gather graph.
   This is the XLA-baseline math (kernels/baseline.py), which is the
   right tool here — the gradient path is traced/retraced with fresh
   tangent values, where a host-side plan permutation cannot run.

Semirings are not differentiable in general (min-plus has kinks,
or-and is discrete); both paths are plus-times only and say so.
"""

from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from spmv_tpu.formats import CSR
from spmv_tpu.ops.registry import spmv


class SparseOperator:
    """A fixed sparse matrix as a differentiable linear map.

    ``op(x)`` computes ``A @ x`` with the requested kernel kind and is
    differentiable w.r.t. ``x``: the VJP is ``A^T @ g``, dispatched
    through the same registry on a transpose built once and cached.

    Parameters
    ----------
    A : CSR
        The matrix. Treated as a constant (its values do not receive
        gradients; use `spmv_values` for that).
    kind : str
        Registered kernel kind for the forward matvec.
    rkind : str, optional
        Kind for the transpose matvec (defaults to ``kind``). The
        transpose of a power-law matrix can have a very different row
        profile, so the best kind may differ.
    """

    def __init__(self, A: CSR, kind: str = "xla",
                 rkind: Optional[str] = None):
        self.A = A
        self.kind = kind
        self.rkind = rkind or kind
        self._AT: Optional[CSR] = None
        self._Top: Optional["SparseOperator"] = None

        @jax.custom_vjp
        def _apply(x):
            return spmv(self.kind, self.A, x)

        def _fwd(x):
            return _apply(x), None

        def _bwd(_, g):
            return (self.rmatvec(g),)

        _apply.defvjp(_fwd, _bwd)
        self._apply = _apply

    @property
    def shape(self):
        return (self.A.n_rows, self.A.n_cols)

    @property
    def dtype(self):
        return np.asarray(self.A.Ax).dtype

    def _transpose_csr(self) -> CSR:
        if self._AT is None:
            self._AT = self.A.transpose()
        return self._AT

    @property
    def T(self) -> "SparseOperator":
        """The transpose as its own differentiable operator. Shares the
        underlying arrays: ``op.T.T`` reuses this operator's ``A``."""
        if self._Top is None:
            t = SparseOperator(self._transpose_csr(), self.rkind,
                               rkind=self.kind)
            t._AT = self.A
            t._Top = self
            self._Top = t
        return self._Top

    def matvec(self, x) -> jax.Array:
        """``A @ x`` (not differentiable through the plan; use
        ``__call__`` under autodiff)."""
        return spmv(self.kind, self.A, x)

    def rmatvec(self, y) -> jax.Array:
        """``A^T @ y`` via the cached transpose."""
        return spmv(self.rkind, self._transpose_csr(), y)

    def __call__(self, x) -> jax.Array:
        return self._apply(x)


def spmv_values(A: CSR, Ax, x, *, n_rows: Optional[int] = None) -> jax.Array:
    """SpMV with live values over A's static pattern — differentiable
    in both ``Ax`` and ``x`` by plain JAX autodiff (JVP and VJP).

    ``A`` contributes only ``Ap``/``Aj`` (the sparsity pattern); its
    stored values are ignored in favor of ``Ax``, which must have
    ``A.nnz`` entries. Runs the XLA gather + sorted-segment-sum path:
    under ``jax.grad`` the cotangent w.r.t. ``Ax`` is
    ``g[row_ids] * x[Aj]`` and w.r.t. ``x`` is the segment-sum scatter
    of ``g[row_ids] * Ax`` over columns, both derived automatically.
    """
    Ax = jnp.asarray(Ax)
    if Ax.shape != (A.nnz,):
        raise ValueError(
            f"Ax has shape {Ax.shape}, expected ({A.nnz},) for A's pattern")
    rows = jnp.asarray(A.row_ids())
    Aj = jnp.asarray(np.asarray(A.Aj))
    n = n_rows if n_rows is not None else A.n_rows
    prod = Ax * jnp.take(jnp.asarray(x), Aj)
    return jax.ops.segment_sum(prod, rows, num_segments=n,
                               indices_are_sorted=True)


def spmv_value_grad(A: CSR, x, g) -> jax.Array:
    """Per-nonzero gradient ``d(g . Ax)/dAx[k] = g[row(k)] * x[col(k)]``
    as a standalone helper (e.g. to feed edge-weight updates without
    building the full autodiff graph)."""
    rows = jnp.asarray(A.row_ids())
    Aj = jnp.asarray(np.asarray(A.Aj))
    return jnp.take(jnp.asarray(g), rows) * jnp.take(jnp.asarray(x), Aj)
