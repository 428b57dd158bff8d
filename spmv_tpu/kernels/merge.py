"""Merge-path SpMV for Hopper: one Pallas kernel through Triton.

Reference: the vendored CUB merge-based SpMV
(ref: include/spmv/merge_based/*) and its semiring generalization
(ref: include/spmv/merge_genl/*). The CUDA design splits the nonzeros
into equal tiles, reduces by key inside each tile, and repairs the rows
that cross tiles in a fix-up pass (ref: agent_spmv_orig.cuh:120-760,
agent_segment_fixup.cuh). Equal-nnz tiles are what a scale-free matrix
needs: one row may hold a third of all nonzeros, which would pin a
row-per-block kernel to one SM and make per-nonzero atomics collide on
one address.

Here each program owns TILE consecutive nonzeros:

- it loads its slice of the per-nnz row ids, column indices and values
  with masked loads (the last tile is ragged), gathers x (which at real
  sizes sits in the 50 MB L2) and applies the ring's ``combine``;
- it reduces by key with a pairwise tree: at every level adjacent
  blocks merge their (first row, last row) partials, and a row that
  becomes complete inside the tile is stored straight to y;
- the tile's first and last rows may continue in the neighbouring
  tiles, so they go to y through atomics, into a y pre-filled with the
  ring's identity. Blocks run unordered, so this replaces both the
  reference's decoupled look-back and the carry chain a sequential grid
  allowed.

No nnz-sized intermediate is written to device memory, and a hub row
costs one atomic per tile, not one per nonzero.

Float min and max have no hardware atomic. For those rings y travels as
order-preserving int32 keys, whose signed integer order is the float
order, so integer atomic min/max apply.

The kernel serves the four built-in rings over float32, bfloat16 and
float16 values, accumulating in float32. Other dtypes and user-defined
semirings run the plain path; `ops.registry.implementation` says which
one a call gets.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from spmv_tpu import config
from spmv_tpu.formats import CSR
from spmv_tpu.kernels.baseline import device_csr, plain_spmv
from spmv_tpu.ops.registry import register, resolve_val_dtype
from spmv_tpu.ops.semiring import (
    Semiring, PLUS_TIMES, MIN_PLUS, MAX_TIMES, OR_AND)

# Nonzeros per program and warps per program, chosen on the H100
# (PERF.md "Kernel decisions").
TILE = 2048
NUM_WARPS = 4

# ring -> the atomic that folds a boundary row's partial into y
_ATOMICS = {
    PLUS_TIMES: plgpu.atomic_add,
    MIN_PLUS: plgpu.atomic_min,
    MAX_TIMES: plgpu.atomic_max,
    OR_AND: plgpu.atomic_max,
}
_VALUE_DTYPES = tuple(np.dtype(d) for d in
                      (jnp.float32, jnp.bfloat16, jnp.float16))
_INT32_MAX = np.iinfo(np.int32).max


def ring_and_dtype_served(val_dtype, semiring: Semiring) -> bool:
    """True when the kernel has an atomic for the ring and a load for
    the value dtype."""
    return semiring in _ATOMICS and np.dtype(val_dtype) in _VALUE_DTYPES


def kernel_serves(A: CSR, val_dtype, semiring: Semiring) -> bool:
    """True when the merge-path kernel runs this product; False sends
    it to the plain path."""
    return (ring_and_dtype_served(val_dtype, semiring)
            and max(A.nnz, A.n_rows, A.n_cols) < _INT32_MAX - TILE)


def _order_key(bits):
    """int32 bits of a float32 <-> int32 whose signed order is the float
    order. The map is its own inverse."""
    return jnp.where(bits < 0, bits ^ 0x7FFFFFFF, bits)


def _to_key(v):
    return _order_key(lax.bitcast_convert_type(v, jnp.int32))


def _from_key(k):
    return lax.bitcast_convert_type(_order_key(k), jnp.float32)


def _halves(v, n: int):
    """Even and odd elements of a (2n,) vector, each (n,)."""
    lo, hi = lax.split(v.reshape(n, 2), (1, 1), axis=1)
    return lo.reshape(n), hi.reshape(n)


def _merge_path_kernel(rows_ref, aj_ref, ax_ref, x_ref, y_in_ref, y_ref, *,
                       sr: Semiring, tile: int, nnz: int, n_rows: int):
    del y_in_ref  # the same buffer as y_ref
    ident = jnp.float32(sr.identity_for(np.float32))

    def enc(v):
        # a row's reduction starts from the identity, as in the oracle
        # (ref: cpu_navie.hpp:20-35); y holds keys for min/max rings
        v = sr.reduce(ident, v)
        return v if sr == PLUS_TIMES else _to_key(v)

    start = pl.program_id(0) * tile
    live = start + lax.iota(jnp.int32, tile) < nnz
    win = pl.ds(start, tile)
    # lanes past nnz read as the spare row n_rows, which y carries
    key = plgpu.load(rows_ref.at[win], mask=live, other=n_rows)
    col = plgpu.load(aj_ref.at[win], mask=live, other=0)
    a = plgpu.load(ax_ref.at[win], mask=live, other=0).astype(jnp.float32)
    xj = plgpu.load(x_ref.at[col], mask=live, other=0).astype(jnp.float32)
    val = jnp.where(live, sr.combine(a, xj), ident)

    # Each block of the tree carries its first row (fk, fv) and its last
    # row (lk, lv); rows between them are complete and already stored.
    fk, fv, lk, lv = key, val, key, val
    n = tile
    while n > 1:
        n //= 2
        l_fk, r_fk = _halves(fk, n)
        l_lk, r_lk = _halves(lk, n)
        l_fv, r_fv = _halves(fv, n)
        l_lv, r_lv = _halves(lv, n)
        joined = l_lk == r_fk  # a row runs across the seam
        both = sr.reduce(l_lv, r_fv)
        l_one = l_fk == l_lk
        r_one = r_fk == r_lk
        # the left block's last row completes unless it is also the
        # merged block's first row
        plgpu.store(y_ref.at[l_lk], enc(jnp.where(joined, both, l_lv)),
                    mask=~l_one & (~joined | ~r_one))
        # the right block's first row completes when it starts here
        plgpu.store(y_ref.at[r_fk], enc(r_fv), mask=~joined & ~r_one)
        fk, lk = l_fk, r_lk
        fv = jnp.where(joined & l_one, both, l_fv)
        lv = jnp.where(joined & r_one, both, r_lv)

    # The tile's first and last rows may continue next door. Atomics
    # take a vector index: a one-row tile sends its second partial to
    # the spare row.
    atomic = _ATOMICS[sr]
    one_row = lk == fk
    atomic(y_ref, (fk,), enc(fv))
    atomic(y_ref, (jnp.where(one_row, n_rows, lk),),
           enc(jnp.where(one_row, ident, lv)))


@functools.partial(jax.jit, static_argnames=(
    "sr", "n_rows", "tile", "interpret"))
def merge_path_rows(rows, aj, ax, x, *, sr: Semiring, n_rows: int,
                    interpret: bool, tile: int = TILE):
    """The kernel on device arrays: per-nnz row ids (sorted; ids equal
    to n_rows are dropped), column indices and values. Returns float32."""
    nnz = aj.shape[0]
    ident = np.float32(sr.identity_for(np.float32))
    if sr == PLUS_TIMES:
        y0 = jnp.full((n_rows + 1,), ident, jnp.float32)
    else:
        y0 = jnp.full((n_rows + 1,), _to_key(jnp.float32(ident)), jnp.int32)
    y = pl.pallas_call(
        functools.partial(_merge_path_kernel, sr=sr, tile=tile, nnz=nnz,
                          n_rows=n_rows),
        out_shape=jax.ShapeDtypeStruct(y0.shape, y0.dtype),
        grid=(pl.cdiv(nnz, tile),),
        input_output_aliases={4: 0},
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS),
        interpret=interpret,
        name=f"merge_path_spmv_{sr.name}",
    )(rows, aj, ax, x, y0)[:n_rows]
    return y if sr == PLUS_TIMES else _from_key(y)


def merge_path_spmv(A: CSR, x, semiring: Semiring = PLUS_TIMES, *,
                    tile: int = TILE):
    """y = A ⊗ x through the merge-path kernel (see `kernel_serves`)."""
    x = jnp.asarray(x)
    val_dtype = resolve_val_dtype(A, x)
    if not kernel_serves(A, val_dtype, semiring):
        raise ValueError(
            f"the merge-path kernel does not serve {semiring.name} over "
            f"{np.dtype(val_dtype).name}; use the plain path")
    if A.nnz == 0:
        ident = semiring.identity_for(val_dtype)
        return jnp.full((A.n_rows,), ident, dtype=val_dtype)
    d = device_csr(A)
    y = merge_path_rows(d["rows"], d["Aj"], d["Ax"], x, sr=semiring,
                        n_rows=A.n_rows, tile=tile,
                        interpret=config.use_interpret())
    return y.astype(val_dtype)


def _select(A: CSR, val_dtype, semiring: Semiring) -> str:
    return "hopper" if kernel_serves(A, val_dtype, semiring) else "plain"


def _merge_kind(A: CSR, x, *, semiring: Semiring = PLUS_TIMES):
    """Merge-path SpMV (the Hopper kernel), or the plain path for the
    dtypes and semirings the kernel does not serve."""
    if _select(A, resolve_val_dtype(A, x), semiring) == "hopper":
        return merge_path_spmv(A, x, semiring)
    return plain_spmv(A, x, semiring)


# The reference's kind names (ref: spmv.h:18-27) and the strategy
# variants earlier versions added. On Hopper they all run the one
# merge-path kernel: kind -> (reference analog, aliases).
_KINDS = {
    "merge": ("merge_based/* (dispatch_spmv_orig.cuh:533-769)", ()),
    "merge_stock": ("cub_merge.cuh:16-55", ("cub_merge",)),
    "merge_genl": ("merge_genl/* (merge_genl.cuh:41-80)", ()),
    "merge_tiled": ("merge_based/agent_spmv_orig.cuh:120-760", ()),
    "stream": ("(beyond the reference: equal-nnz tile walk)", ()),
    "csr_scalar": ("(SURVEY §7.3a; row-parallel baseline)", ()),
    "csr_vector": ("cusp/cusp.cuh:19-237", ("cusp",)),
    "csr_vector_shfl": ("cusp/cusp_warp_reduce.cuh:11-148", ("cusp1",)),
    "csr_vector_shfl2": ("cusp/cusp_warp_read_reduce.cuh:11-154",
                         ("cusp2",)),
    "csr_vector_ell": ("cusp/cusp.cuh:19-237", ()),
    "csr_vector_shfl_ell": ("cusp/cusp_warp_reduce.cuh:11-148", ()),
    "csr_vector_shfl2_ell": ("cusp/cusp_warp_read_reduce.cuh:11-154", ()),
    "light_vec": ("LightSpMV.cuh:110-182,376-395", ()),
    "light_warp": ("LightSpMV.cuh:184-263,397-416", ()),
    "light_vec_ell": ("LightSpMV.cuh:110-182", ()),
    "light_warp_ell": ("LightSpMV.cuh:184-263", ()),
}
for _name, (_analog, _aliases) in _KINDS.items():
    register(_name, supports_semiring=True, reference_analog=_analog,
             aliases=_aliases, implementation=_select)(_merge_kind)
