"""Baseline SpMV kinds: CPU oracle, the plain XLA path, dense.

``xla`` is the plain implementation every other kind is measured
against and falls back to: XLA's native gather + sorted segment
reduction (the reference's vendor-library slot, ref:
include/spmv/cusparse.cuh:36-89, is filled by whatever the compiler
makes of the plain formulation).

``cpu_naive`` mirrors the oracle kind (ref: include/spmv/cpu_navie.hpp)
so the harness can time it like any other kind.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from spmv_tpu.formats import CSR
from spmv_tpu.ops.registry import register, plan_cache
from spmv_tpu.ops.reference import spmv_ref, spmv_ref_semiring
from spmv_tpu.ops.semiring import Semiring, PLUS_TIMES, segment_reduce_sorted


@register("cpu_naive", supports_semiring=True, reference_analog="cpu_navie.hpp:3-35",
          aliases=("cpu_navie",), implementation="host")
def _cpu_naive(A: CSR, x, *, semiring: Semiring = PLUS_TIMES):
    """Host NumPy row-loop oracle (ref: cpu_navie.hpp:3-35)."""
    if semiring is PLUS_TIMES:
        return jnp.asarray(spmv_ref(A, np.asarray(x)))
    return jnp.asarray(spmv_ref_semiring(A, np.asarray(x), semiring))


def device_csr(A: CSR) -> dict:
    """A's per-nnz row ids, column indices and values on the device,
    cached per matrix; the plain path and the merge-path kernel share
    them."""
    def build():
        # concrete device arrays even when first asked for under a
        # trace (a solver's loop body), so the cache never holds tracers
        with jax.ensure_compile_time_eval():
            return {
                "rows": jnp.asarray(A.row_ids()),
                "Aj": jnp.asarray(np.asarray(A.Aj)),
                "Ax": jnp.asarray(np.asarray(A.Ax)),
            }

    return plan_cache(A, "device_csr", build)


# `sr` is static: user-defined semirings trace straight in (functor_t
# analog, ref: merge_genl/agent_spmv_orig.cuh:98-124).
@functools.partial(jax.jit, static_argnames=("n_rows", "sr"))
def _plain_spmv(rows, Aj, Ax, x, n_rows: int, sr: Semiring):
    prod = sr.combine(Ax, jnp.take(x, Aj))
    ident = float(sr.identity_for(prod.dtype))
    return segment_reduce_sorted(prod, rows, n_rows, sr, ident)


def plain_spmv(A: CSR, x, semiring: Semiring = PLUS_TIMES):
    """The plain implementation: XLA gather + sorted segment reduce."""
    d = device_csr(A)
    return _plain_spmv(d["rows"], d["Aj"], d["Ax"], jnp.asarray(x),
                       n_rows=A.n_rows, sr=semiring)


@register("xla", supports_semiring=True, reference_analog="cusparse.cuh:36-89",
          aliases=("cusparse",), implementation="plain")
def _xla(A: CSR, x, *, semiring: Semiring = PLUS_TIMES):
    """Plain path: XLA gather + sorted segment reduction."""
    return plain_spmv(A, x, semiring)


@register("dense", reference_analog="(none; sanity baseline)")
def _dense(A: CSR, x, *, semiring: Semiring = PLUS_TIMES):
    """Densify + matvec — sanity baseline for small matrices only."""
    if semiring is not PLUS_TIMES:
        raise ValueError("kind 'dense' supports plus_times only")
    if A.n_rows * A.n_cols > 64 * 1024 * 1024:
        raise ValueError("matrix too large to densify")
    d = plan_cache(A, "dense", lambda: jnp.asarray(A.to_dense()))
    # full float32 products: a GPU would otherwise run this in TF32
    return jnp.matmul(d, jnp.asarray(x), precision=jax.lax.Precision.HIGHEST)
