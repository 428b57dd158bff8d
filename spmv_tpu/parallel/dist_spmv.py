"""Multi-device SpMV over a device mesh (shard_map + collectives).

The layer the single-GPU reference lacks (SURVEY §2/§7):

- **Halo-compacted exchange**: the plan (partition.build_halo_plan)
  knows exactly which x entries each device reads from each owner;
  the runtime exchange is ONE `all_to_all` of value payloads sized by
  the halo (not an all-gather of every column). Remote column indices
  are remapped at plan time into halo-table coordinates — zero index
  traffic.
- **Overlap**: each shard's nonzeros are split into a SELF block
  (locally-owned columns; no dependency on the exchange) and a HALO
  block (depends on the received table). XLA's latency-hiding
  scheduler runs the `all_to_all` concurrently with the self matvec
  because the data dependencies permit it; y = reduce(y_self, y_halo).
- **Local matvec**: each block runs the single-device merge-path
  kernel inside shard_map (a Kronecker shard keeps its hub rows), or
  the plain gather + sorted segment reduce for the rings and dtypes
  the kernel does not serve.

`mode="allgather"` keeps the full-gather path (useful as a baseline
and for meshes where the halo is nearly everything).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from spmv_tpu import config
from spmv_tpu.formats import CSR
from spmv_tpu.kernels.merge import merge_path_rows, ring_and_dtype_served
from spmv_tpu.ops.semiring import (
    Semiring,
    PLUS_TIMES,
    segment_reduce_sorted,
)
from spmv_tpu.parallel.partition import HaloPlan, build_halo_plan


@dataclasses.dataclass
class DistributedSpMV:
    """A CSR matrix distributed over one mesh axis, ready for matvec."""

    mesh: Mesh
    axis: str
    plan: HaloPlan
    n_rows: int
    n_cols: int
    dev: dict            # sharded device arrays
    unpad_idx: jax.Array  # (n_rows,) into flattened (n*R_out,) owned y
    x_pad: int           # n_shards * B

    @property
    def comm_bytes_per_shard(self) -> int:
        return self.plan.comm_bytes_per_shard

    @property
    def allgather_bytes_per_shard(self) -> int:
        return self.plan.allgather_bytes_per_shard

    def shard_x(self, x) -> jax.Array:
        from spmv_tpu.parallel.bootstrap import put_global

        xp = np.zeros((self.x_pad,), np.asarray(x).dtype)
        xp[: self.n_cols] = np.asarray(x)
        return put_global(xp, NamedSharding(self.mesh, P(self.axis)))

    def matvec(self, x, semiring: Semiring = PLUS_TIMES,
               mode: str = "halo") -> jax.Array:
        """y = A·x, x/y row-sharded over the mesh axis.

        mode='halo' (default): all_to_all of halo values overlapped
        with the self-block matvec. mode='allgather': v1 full gather.
        """
        x = jnp.asarray(x)
        if x.shape[0] == self.n_cols and self.n_cols != self.x_pad:
            x = self.shard_x(x)
        d = self.dev
        return _dist_matvec(
            d["send_idx"], d["recv_idx"], d["self"], d["halo"],
            d["idx_own"], d["own_start"], self.unpad_idx, x,
            mesh=self.mesh, axis=self.axis, R=self.plan.R,
            sr=semiring, mode=mode,
            export_meta=(tuple(int(r) for r in self.plan.export_rows),
                         bool(self.plan.export_flag.any())),
        )


def _local_matvec(rows, cols, vals, x, *, R, sr: Semiring, identity):
    """One shard's block. Pad entries carry row id R, past the block's
    rows, and are dropped."""
    vals = vals.astype(x.dtype)
    if ring_and_dtype_served(x.dtype, sr):
        return merge_path_rows(rows, cols, vals, x, sr=sr, n_rows=R,
                               interpret=config.use_interpret()
                               ).astype(x.dtype)
    prod = sr.combine(vals, jnp.take(x, cols))
    return segment_reduce_sorted(prod, rows, R + 1, sr, identity)[:R]


@functools.partial(jax.jit, static_argnames=(
    "mesh", "axis", "R", "sr", "mode", "export_meta"))
def _dist_matvec(send_idx, recv_idx, blk_self, blk_halo, idx_own,
                 own_start, unpad_idx, x,
                 *, mesh, axis, R, sr, mode, export_meta):
    n = mesh.shape[axis]
    identity = float(sr.identity_for(np.dtype(x.dtype)))
    # plan-time constants, identical on every shard (baked in)
    export_rows, any_export = export_meta

    def local(send_idx_l, recv_idx_l, rs, cs, vs, rh, ch, vh,
              idx_own_l, own_start_l, x_l):
        xl = x_l
        if mode == "allgather":
            # v1 baseline: gather every column, then read the SAME
            # halo-table coordinates out of the full vector
            # (recv_idx[me][t] = what owner t would have sent me)
            x_full = jax.lax.all_gather(xl, axis, tiled=True)
            ri = recv_idx_l[0]
            B = x_full.shape[0] // n
            base = jnp.arange(n, dtype=ri.dtype)[:, None] * B
            table = jnp.take(x_full, (ri + base).reshape(-1))
        else:
            # value-only halo exchange; the self matvec below has no
            # data dependency on it, so XLA overlaps the two
            send = jnp.take(xl, send_idx_l[0].reshape(-1)).reshape(
                send_idx_l[0].shape)
            recv = jax.lax.all_to_all(
                send, axis, split_axis=0, concat_axis=0, tiled=False)
            table = recv.reshape(-1)
        y_self = _local_matvec(rs[0], cs[0], vs[0], xl, R=R, sr=sr,
                               identity=identity)
        y_halo = _local_matvec(rh[0], ch[0], vh[0], table, R=R, sr=sr,
                               identity=identity)
        y = sr.reduce(y_self, y_halo)
        # owned output block: slot j = local row idx_own[j] (-1 -> id)
        io = idx_own_l[0]
        y_own = jnp.where(io >= 0, jnp.take(y, jnp.clip(io, 0, R - 1)),
                          identity)
        if any_export:
            # rows split across shards: every shard whose entry range
            # starts mid-row exports its partial for that first row;
            # the row's owner reduces them in (the cross-device carry
            # fixup — SURVEY §7.6 boundary-partial combine). Tiny:
            # one value per shard, one all_gather. export_rows is a
            # plan-time constant, so the same-row grouping is done in
            # NumPy at trace time and the traced graph is O(1) in the
            # shard count: one static permutation,
            # one segment reduce, one distinct-index scatter.
            parts = jax.lax.all_gather(y[:1], axis, tiled=True)  # (n,)
            er = np.asarray(export_rows)
            order = np.argsort(er, kind="stable")
            er_sorted = er[order]
            uniq, seg_of = np.unique(er_sorted, return_inverse=True)
            ps = jnp.take(parts, jnp.asarray(order))
            ps = jnp.where(jnp.asarray(er_sorted >= 0), ps, identity)
            comb = segment_reduce_sorted(
                ps, jnp.asarray(seg_of.astype(np.int32)), len(uniq),
                sr, identity)
            keep = np.nonzero(uniq >= 0)[0]
            if keep.size:
                comb_v = jnp.take(comb, jnp.asarray(keep))
                pos = jnp.asarray(uniq[keep]) - own_start_l[0, 0]
                # rows owned elsewhere fall out of [0, R_out): gather
                # with a fill and scatter with mode="drop" — clipping
                # instead would collide several masked updates on index
                # R_out-1 and the duplicate-scatter winner is undefined.
                # JAX wraps NEGATIVE indices even under fill/drop, so
                # send those to an out-of-bounds sentinel first.
                pos = jnp.where(pos >= 0, pos, y_own.shape[0])
                old = jnp.take(y_own, pos, mode="fill",
                               fill_value=identity)
                upd = sr.reduce(old, comb_v)
                y_own = y_own.at[pos].set(upd, mode="drop")
        return y_own[None, :]

    blk = P(axis, None)
    # check_vma=False: the kernel's pallas_call states no varying axes
    y_sharded = shard_map(
        local,
        mesh=mesh,
        check_vma=False,
        in_specs=(P(axis, None, None), P(axis, None, None),
                  blk, blk, blk, blk, blk, blk, blk, blk, P(axis)),
        out_specs=blk,
    )(send_idx, recv_idx, blk_self["rows"], blk_self["cols"],
      blk_self["vals"], blk_halo["rows"], blk_halo["cols"],
      blk_halo["vals"], idx_own, own_start, x)
    y_flat = y_sharded.reshape(-1)
    return jnp.take(y_flat, unpad_idx)


def distribute_csr(
    A: CSR,
    mesh: Mesh,
    axis: str = "shards",
    balance: str = "nnz",
) -> DistributedSpMV:
    n = mesh.shape[axis]
    plan = build_halo_plan(A, n, balance=balance)

    row_starts = plan.row_starts  # ownership starts
    shard_of = np.searchsorted(row_starts, np.arange(A.n_rows),
                               side="right") - 1
    shard_of = np.clip(shard_of, 0, n - 1)
    unpad_idx = (shard_of * plan.R_out
                 + (np.arange(A.n_rows) - row_starts[shard_of]))

    from spmv_tpu.parallel.bootstrap import put_global

    shd = NamedSharding(mesh, P(axis))
    put = lambda a: put_global(np.asarray(a), shd)
    dev = {
        "send_idx": put(plan.send_idx),
        # recv_idx[s, t] = send_idx[t, s]: what owner t sends shard s
        # (the allgather-baseline table construction needs it locally)
        "recv_idx": put(plan.send_idx.transpose(1, 0, 2).copy()),
        "self": {"rows": put(plan.rows_self), "cols": put(plan.cols_self),
                 "vals": put(plan.vals_self)},
        "halo": {"rows": put(plan.rows_halo), "cols": put(plan.cols_halo),
                 "vals": put(plan.vals_halo)},
        "idx_own": put(plan.idx_own),
        "own_start": put(plan.row_starts[:n, None].astype(np.int32)),
    }
    return DistributedSpMV(
        mesh=mesh,
        axis=axis,
        plan=plan,
        n_rows=A.n_rows,
        n_cols=A.n_cols,
        dev=dev,
        unpad_idx=jnp.asarray(unpad_idx.astype(np.int32)),
        x_pad=n * plan.B,
    )
