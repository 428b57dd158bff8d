"""Semiring abstraction for generalized SpMV.

The analog of the reference's static functor concept
(ref: include/spmv/merge_genl/agent_spmv_orig.cuh:98-100 and
merge_genl.cuh:22-38): a semiring provides

    initialize() -> identity of `reduce`
    combine(a_ij, x_j) -> product term
    reduce(acc, v) -> accumulation

The reference threads this through every accumulation site of the
merge kernel, including the cross-tile fixup (its AtomicReduce CAS
loop, ref: merge_genl/agent_segment_fixup.cuh:56-86). Here the same
three callables are threaded through the JAX/Pallas kernels; because
kernels are traced Python, this is plain function composition rather
than template surgery — but it reaches every reduction site, including
tile carries and the fixup combine, exactly as the reference requires.

`reduce` must be associative. No inverse is assumed (the kernels use
segmented scans, not prefix-sum differences), so min/max/or semirings
work unmodified.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import jax.numpy as jnp
import numpy as np


@dataclasses.dataclass(frozen=True)
class Semiring:
    name: str
    initialize: Callable[[], float]  # identity of reduce
    combine: Callable  # (a_ij, x_j) -> term
    reduce: Callable  # (acc, v) -> acc'   (associative)

    def identity_for(self, dtype) -> np.ndarray:
        """Identity value cast to a concrete dtype (handles ±inf for int)."""
        ident = self.initialize()
        dt = np.dtype(dtype)
        if np.isinf(ident) and dt.kind in "iu":
            info = np.iinfo(dt)
            return np.array(info.max if ident > 0 else info.min, dtype=dt)
        return np.array(ident, dtype=dt)

    def reduce_array(self, arr, axis=None):
        """Reduce a jnp array along an axis with this semiring's reduce.

        Fast paths for the built-ins map to native jnp reductions.
        """
        if self is PLUS_TIMES or self.name == "plus_times":
            return jnp.sum(arr, axis=axis)
        if self.name == "min_plus":
            return jnp.min(arr, axis=axis)
        if self.name in ("max_times", "max_plus", "max_min"):
            return jnp.max(arr, axis=axis)
        if self.name == "or_and":
            return jnp.max(arr, axis=axis)
        # Generic fallback: log-tree reduction along the axis.
        if axis is None:
            arr = arr.reshape(-1)
            axis = 0
        n = arr.shape[axis]
        arr = jnp.moveaxis(arr, axis, 0)
        while n > 1:
            half = n // 2
            lo = arr[:half]
            hi = arr[half : 2 * half]
            merged = self.reduce(lo, hi)
            if n % 2:
                merged = jnp.concatenate([merged, arr[2 * half : n]], axis=0)
            arr = merged
            n = arr.shape[0]
        return arr[0]


# The conventional (+, ×) ring: the reference's MergeFunctor default
# (ref: merge_genl/merge_genl.cuh:22-38).
PLUS_TIMES = Semiring(
    name="plus_times",
    initialize=lambda: 0.0,
    combine=lambda a, x: a * x,
    reduce=lambda acc, v: acc + v,
)

# Tropical (min, +): shortest-path relaxation.
MIN_PLUS = Semiring(
    name="min_plus",
    initialize=lambda: float("inf"),
    combine=lambda a, x: a + x,
    reduce=lambda acc, v: jnp.minimum(acc, v),
)

# (max, ×): maximum-reliability paths.
MAX_TIMES = Semiring(
    name="max_times",
    initialize=lambda: 0.0,
    combine=lambda a, x: a * x,
    reduce=lambda acc, v: jnp.maximum(acc, v),
)

# Boolean (or, and): reachability. Genuinely boolean on ANY data:
# combine = (a != 0) AND (x != 0) -> {0, 1} in the value dtype, reduce
# = OR (max over {0, 1}); arbitrary nonzero inputs are truthy rather
# than silently mis-combined by min/max arithmetic.
def _or_and_combine(a, x):
    t = (a != 0) & (x != 0)
    dt = np.result_type(getattr(a, "dtype", type(a)),
                        getattr(x, "dtype", type(x)))
    return jnp.where(t, jnp.ones((), dt), jnp.zeros((), dt))


OR_AND = Semiring(
    name="or_and",
    initialize=lambda: 0.0,
    combine=_or_and_combine,
    reduce=lambda acc, v: jnp.maximum(acc, v),
)

BUILTIN_SEMIRINGS = {
    s.name: s for s in (PLUS_TIMES, MIN_PLUS, MAX_TIMES, OR_AND)
}


def segment_reduce_sorted(vals, seg, n_segments: int, sr: Semiring,
                          identity):
    """Reduce `vals` over sorted segment ids with semiring `sr.reduce`.

    vals: (n,) or (n, B); seg: (n,) non-decreasing int ids < n_segments.
    Segments absent from `seg` yield `identity`. Built-in semirings map
    to native XLA segment reductions; arbitrary user semirings run a
    segmented `associative_scan` and pick each segment's last element —
    the generic path the reference reaches with its functor_t template
    + AtomicReduce CAS (ref: merge_genl/agent_segment_fixup.cuh:56-86).
    """
    import jax

    if seg.shape[0] == 0:
        shape = (n_segments,) + tuple(vals.shape[1:])
        return jnp.full(shape, identity, vals.dtype)
    if sr.name == "plus_times":
        return jax.ops.segment_sum(
            vals, seg, num_segments=n_segments, indices_are_sorted=True)
    if sr.name in ("min_plus", "min_times", "min_max"):
        y = jax.ops.segment_min(
            vals, seg, num_segments=n_segments, indices_are_sorted=True)
    elif sr.name in ("max_times", "max_plus", "max_min", "or_and"):
        y = jax.ops.segment_max(
            vals, seg, num_segments=n_segments, indices_are_sorted=True)
    else:
        def op(a, b):
            va, sa = a
            vb, sb = b
            same = sa == sb
            if vals.ndim == 2:
                same = same[..., None]
            return jnp.where(same, sr.reduce(va, vb), vb), sb

        scanned, _ = jax.lax.associative_scan(op, (vals, seg), axis=0)
        n = seg.shape[0]
        is_last = jnp.concatenate(
            [seg[1:] != seg[:-1], jnp.ones((1,), bool)])
        # non-last positions scatter into a junk slot (n_segments)
        idx = jnp.where(is_last, seg, n_segments)
        shape = (n_segments + 1,) + tuple(vals.shape[1:])
        y = jnp.full(shape, identity, vals.dtype)
        return y.at[idx].set(scanned)[:n_segments]
    # segment_min/max fill absent segments with ±inf: fold the identity
    # into every row (also the oracle's acc = initialize() semantics,
    # ref: cpu_navie.hpp:20-35)
    return sr.reduce(y, jnp.full_like(y, identity))
