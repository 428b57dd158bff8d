"""DIA (diagonal-format) SpMV for banded and stencil matrices.

Banded/stencil matrices (BASELINE.md config 2's regular regime) are
structurally shifts: y[r] = Σ_d A[r, r+d] * x[r+d] over a small set
of diagonals d. That is elementwise: no gathers and no column indices,
one fused pass over n_diags value streams and shifted x slices. The
CSR byte model charges 12 B/nnz (Ax + Aj + x-gather); DIA moves about
8 B/nnz, since Aj is implicit.

The reference has no DIA kind (its zoo is CSR-only); this is a
beyond-reference format specialization (SURVEY §7 step 5 spirit).
Matrices that are not diagonal-sparse run the plain path.

Semiring-generalized like every kind: y[r] = reduce_d combine(Ad, xs)
with absent diagonal slots masked to the identity.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from spmv_tpu.formats import CSR
from spmv_tpu.kernels.baseline import plain_spmv
from spmv_tpu.ops.registry import register, plan_cache, resolve_val_dtype
from spmv_tpu.ops.semiring import Semiring, PLUS_TIMES

MAX_DIAGS = 64          # diagonals before DIA stops being "regular"
MAX_FILL = 4.0          # DIA slots per nnz before padding outweighs


def diag_profile(A: CSR):
    """(diags, fill) or None when the matrix is not diagonal-sparse."""
    if A.nnz == 0 or A.n_rows != A.n_cols:
        return None
    Ap = np.asarray(A.Ap, np.int64)
    Aj = np.asarray(A.Aj, np.int64)
    rows = np.repeat(np.arange(A.n_rows, dtype=np.int64),
                     Ap[1:] - Ap[:-1])
    d = Aj - rows
    uniq = np.unique(d)
    if uniq.size > MAX_DIAGS:
        return None
    fill = uniq.size * A.n_rows / max(A.nnz, 1)
    if fill > MAX_FILL:
        return None
    return uniq, fill


def build_dia_plan(A: CSR, diags: np.ndarray):
    """Dense per-diagonal value lanes + validity mask."""
    Ap = np.asarray(A.Ap, np.int64)
    Aj = np.asarray(A.Aj, np.int64)
    Ax = np.asarray(A.Ax)
    rows = np.repeat(np.arange(A.n_rows, dtype=np.int64),
                     Ap[1:] - Ap[:-1])
    d = Aj - rows
    k = np.searchsorted(diags, d)
    vals = np.zeros((diags.size, A.n_rows), Ax.dtype)
    valid = np.zeros((diags.size, A.n_rows), np.int8)
    # CSR may carry duplicate (row, col) entries: accumulate like the
    # oracle does (+ for the storage; semiring combine sees the sum,
    # matching coo_to_csr's duplicate policy)
    np.add.at(vals, (k, rows), Ax)
    valid[k, rows] = 1
    # concrete device arrays even when first asked for under a trace
    with jax.ensure_compile_time_eval():
        return jnp.asarray(vals), jnp.asarray(valid), tuple(
            int(x) for x in diags)


@functools.partial(jax.jit, static_argnames=("sr", "diags", "n_rows"))
def _dia_matvec(vals, valid, x, *, sr: Semiring, diags, n_rows):
    """One shifted-slice pass per diagonal; XLA fuses them into one
    elementwise pass over the value lanes."""
    val_dtype = vals.dtype
    ident = sr.identity_for(np.dtype(val_dtype))
    lo = -min(min(diags), 0)
    hi = max(max(diags), 0)
    xp = jnp.pad(x.astype(val_dtype), (lo, hi))
    y = jnp.full((n_rows,), ident, val_dtype)
    for i, d in enumerate(diags):
        xs = jax.lax.dynamic_slice_in_dim(xp, lo + d, n_rows)
        t = jnp.where(valid[i] > 0, sr.combine(vals[i], xs), ident)
        y = sr.reduce(y, t)
    return y


def _profile(A: CSR):
    return plan_cache(A, ("dia", "profile"), lambda: diag_profile(A))


@register("dia", supports_semiring=True,
          reference_analog="(none — beyond-reference diagonal-format "
                           "specialization for regular matrices)",
          implementation=lambda A, val_dtype, sr:
              "plain" if _profile(A) is None else "dia")
def _dia(A: CSR, x, *, semiring: Semiring = PLUS_TIMES):
    """DIA SpMV for diagonal-sparse matrices; other matrices run the
    plain path, so the kind is total."""
    prof = _profile(A)
    if prof is None:
        return plain_spmv(A, x, semiring)
    vals, valid, dtup = plan_cache(
        A, ("dia", "plan"), lambda: build_dia_plan(A, prof[0]))
    val_dtype = resolve_val_dtype(A, x)
    return _dia_matvec(vals.astype(val_dtype), valid, jnp.asarray(x),
                       sr=semiring, diags=dtup, n_rows=A.n_rows)
