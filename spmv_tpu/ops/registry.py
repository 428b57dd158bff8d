"""String-dispatched SpMV kernel registry.

A rebuild of the reference's X-macro registry + uniform
dispatch (ref: include/spmv.h:18-48): a string kind maps to a kernel
entry; unknown kinds raise with the list of valid kinds. The
documented extension point — "add a label + function" — becomes the
`@register` decorator (ref: README.md:28-46).

Kernel entry contract::

    @register("mykind", supports_semiring=True)
    def mykind(A: CSR, x: jax.Array, *, semiring: Semiring) -> jax.Array:
        ...

Kernels may precompute per-matrix device arrays (a *plan*); plans are
cached via `plan_cache` so repeated calls are launch-only, mirroring
how the reference amortizes (or fails to amortize, see
main.cu:102-113) its per-call setup.
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Callable, Dict, Optional

import jax.numpy as jnp
import numpy as np

from spmv_tpu.formats import CSR
from spmv_tpu.ops.semiring import Semiring, PLUS_TIMES


def resolve_val_dtype(A: CSR, x) -> np.dtype:
    """Compute dtype of the product stream: result_type(Ax, x).

    fp64 without jax_enable_x64 raises loudly instead of silently
    degrading — the reference's mat_value_t contract computes in the
    requested type or fails (ref: include/spmv.h:29-34)."""
    import jax

    # x may be a tracer (kernels are called under jit): use dtype only.
    x_dtype = getattr(x, "dtype", None) or np.asarray(x).dtype
    val = np.promote_types(np.asarray(A.Ax).dtype, np.dtype(x_dtype))
    if val == np.float64 and not jax.config.jax_enable_x64:
        raise ValueError(
            "float64 SpMV requested but jax_enable_x64 is off; enable it "
            "(jax.config.update('jax_enable_x64', True)) or cast A/x to "
            "float32"
        )
    return np.dtype(val)


@dataclasses.dataclass
class KernelEntry:
    name: str
    fn: Callable
    supports_semiring: bool
    doc: str
    reference_analog: str = ""
    # (A, val_dtype, semiring) -> name of the implementation that runs
    implementation: Callable = None


_REGISTRY: Dict[str, KernelEntry] = {}
_ALIASES: Dict[str, str] = {}


def register(
    name: str,
    *,
    supports_semiring: bool = False,
    reference_analog: str = "",
    aliases: tuple = (),
    implementation=None,
):
    """Register an SpMV kernel under a string kind (ref: spmv.h:18-27).

    `implementation` names what the kind runs: a string, or a callable
    (A, val_dtype, semiring) -> str when the choice depends on the
    call; None means the kind's own name."""
    if not callable(implementation):
        fixed = implementation or name
        implementation = lambda A, val_dtype, sr: fixed  # noqa: E731

    def deco(fn):
        entry = KernelEntry(
            name=name,
            fn=fn,
            supports_semiring=supports_semiring,
            doc=(fn.__doc__ or "").strip().splitlines()[0] if fn.__doc__ else "",
            reference_analog=reference_analog,
            implementation=implementation,
        )
        _REGISTRY[name] = entry
        for a in aliases:
            _ALIASES[a] = name
        return fn

    return deco


def get_kernel(kind: str) -> KernelEntry:
    kind = _ALIASES.get(kind, kind)
    if kind not in _REGISTRY:
        raise KeyError(
            f"unknown SpMV kind {kind!r}; valid kinds: {sorted(_REGISTRY)}"
            f" (aliases: {sorted(_ALIASES)})"
        )  # ref: spmv.h:46-47 unknown-kind error
    return _REGISTRY[kind]


def list_kinds(include_aliases: bool = False):
    kinds = sorted(_REGISTRY)
    if include_aliases:
        kinds += sorted(_ALIASES)
    return kinds


# Per-matrix plan caches, keyed by (CSR identity, plan key).
_PLAN_CACHES: "weakref.WeakKeyDictionary[CSR, dict]" = weakref.WeakKeyDictionary()


def plan_cache(A: CSR, key, builder: Callable[[], object]):
    """Fetch-or-build a cached plan for matrix A."""
    cache = _PLAN_CACHES.get(A)
    if cache is None:
        cache = {}
        _PLAN_CACHES[A] = cache
    if key not in cache:
        cache[key] = builder()
    return cache[key]


def implementation(kind: str, A: CSR, x, semiring: Optional[Semiring] = None) -> str:
    """Name of the implementation `spmv(kind, A, x, semiring)` runs:
    'hopper' (the merge-path Pallas kernel), 'plain' (XLA gather +
    segment reduce), 'dia' (XLA shifted slices), 'dense' or 'host'."""
    entry = get_kernel(kind)
    sr = semiring if semiring is not None else PLUS_TIMES
    return entry.implementation(A, resolve_val_dtype(A, x), sr)


def spmv(
    kind: str,
    A: CSR,
    x,
    semiring: Optional[Semiring] = None,
    y_dtype=None,
):
    """Uniform dispatch: y = A ⊗ x with the named kernel.

    Mirrors SpMV(kind_str, ...) (ref: spmv.h:29-48). `semiring=None`
    means the plain (+,×) ring; passing a semiring to a kernel that
    does not support one raises. `y_dtype` selects the output dtype
    independently of the compute dtype (the vec_y_value_t analog,
    ref: spmv.h:29-34); None keeps the compute dtype.
    """
    entry = get_kernel(kind)
    sr = semiring if semiring is not None else PLUS_TIMES
    if semiring is not None and sr is not PLUS_TIMES and not entry.supports_semiring:
        raise ValueError(
            f"kind {entry.name!r} does not support semirings; "
            f"semiring-capable kinds: "
            f"{[k for k, e in _REGISTRY.items() if e.supports_semiring]}"
        )
    x = jnp.asarray(x)
    if x.shape != (A.n_cols,):
        raise ValueError(f"x has shape {x.shape}, expected ({A.n_cols},)")
    y = entry.fn(A, x, semiring=sr)
    if y_dtype is not None and y.dtype != jnp.dtype(y_dtype):
        y = y.astype(y_dtype)
    return y


def SpMV(kind, n_rows, n_cols, nnz, Ap, Aj, Ax, x, semiring=None, y_dtype=None):
    """Reference-signature shim (ref: spmv.h:29-34, README.md:32-38).

    SpMV(kind, n_rows, n_cols, nnz, Ap, Aj, Ax, x) -> y. Provided so a
    user of the reference's C API shape finds the same entry point; the
    container API `spmv(kind, A, x)` is the idiomatic path (it caches
    per-matrix plans).
    """
    Ap = np.asarray(Ap)
    Aj = np.asarray(Aj)
    Ax = np.asarray(Ax)
    if Ap.shape != (int(n_rows) + 1,):
        raise ValueError("Ap must have shape (n_rows+1,)")
    if Aj.shape != (int(nnz),) or Ax.shape != (int(nnz),):
        raise ValueError("Aj/Ax must have shape (nnz,)")
    A = CSR(int(n_rows), int(n_cols), Ap, Aj, Ax)
    return spmv(kind, A, x, semiring=semiring, y_dtype=y_dtype)
