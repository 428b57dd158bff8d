"""SpMM: Y = A @ X for CSR A and dense X (n_cols, B).

Beyond the reference, which is SpMV-only (SURVEY §7 step 5). The
product is the plain formulation: gather the rows of X that A's
nonzeros name, combine with the values, and reduce by row with the
semiring's sorted segment reduction.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from spmv_tpu.formats import CSR
from spmv_tpu.kernels.baseline import device_csr
from spmv_tpu.ops.registry import resolve_val_dtype
from spmv_tpu.ops.semiring import Semiring, PLUS_TIMES, segment_reduce_sorted


def spmm(A: CSR, X, semiring: Semiring = PLUS_TIMES) -> jax.Array:
    """Y = A ⊗ X (dense X of shape (n_cols, B))."""
    X = jnp.asarray(X)
    # a wrong-shaped X would otherwise clamp-gather into plausible garbage
    if X.ndim != 2 or X.shape[0] != A.n_cols:
        raise ValueError(f"X must be (n_cols, B) = ({A.n_cols}, B); "
                         f"got {X.shape}")
    val_dtype = resolve_val_dtype(A, X)
    d = device_csr(A)
    xg = jnp.take(X.astype(val_dtype), d["Aj"], axis=0)
    prod = semiring.combine(d["Ax"].astype(val_dtype)[:, None], xg)
    ident = float(semiring.identity_for(val_dtype))
    return segment_reduce_sorted(prod, d["rows"], A.n_rows, semiring, ident)
