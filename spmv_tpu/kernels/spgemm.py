"""SpGEMM: C = A @ B for CSR x CSR, semiring-generalized.

North-star extension beyond the reference (SURVEY §7.5; the reference
is SpMV-only). Everything structural happens on the host, everything
value-dependent on the device:

- **Symbolic phase** (host, cached per (A, B) pair): expand the
  intermediate triple list (i, k, j) for every (i,k) in A crossed with
  row k of B — the row-merge formulation of Gustavson's algorithm —
  then sort by (i, j) and collapse duplicates into C's CSR pattern.
  This is the host analog of a GPU hash/sort SpGEMM symbolic pass.
- **Numeric phase** (device): the intermediate products grouped by
  output nonzero are exactly an SpMV on a *virtual* CSR:

      V.n_rows = nnz(C)        (one virtual row per output nonzero)
      V.Ap     = triple-group offsets
      V.Aj     = source index into B's value array
      V.Ax     = per-triple A value (plan-permuted)
      x        = B.Ax
      C.data   = spmv(V, B.Ax)

  which runs the plain path, with its semiring generality
  (combine(a_ik, b_kj) / reduce).

C keeps structural zeros (entries whose values reduce to the semiring
identity), matching scipy.sparse semantics.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from spmv_tpu.formats import CSR
from spmv_tpu.kernels.baseline import plain_spmv
from spmv_tpu.ops.registry import plan_cache
from spmv_tpu.ops.semiring import Semiring, PLUS_TIMES


def _spgemm_symbolic(A: CSR, B: CSR):
    """Expand triples, sort by (i, j), build C's pattern.

    Returns dict with the virtual CSR's host arrays and C's pattern.
    """
    Ap = np.asarray(A.Ap, dtype=np.int64)
    Aj = np.asarray(A.Aj, dtype=np.int64)
    Bp = np.asarray(B.Ap, dtype=np.int64)
    Bj = np.asarray(B.Aj, dtype=np.int64)
    nnzA = int(Ap[-1])

    # Native Gustavson SPA walk (host.cpp spmv_spgemm_symbolic) when
    # available; the NumPy lexsort below has identical semantics. The
    # SPA is O(B.n_cols) memory/time, so skip it for ultra-wide sparse
    # B (the lexsort scales with triples, not columns), and fall back
    # on ANY native failure (alloc, >int32 columns) — every native
    # entry point keeps a pure-NumPy fallback.
    native_ok = (B.n_cols <= np.iinfo(np.int32).max
                 and B.n_cols <= 64 * max(int(Bp[-1]) + A.n_rows, 1))
    if native_ok:
        try:
            from spmv_tpu import native

            if native.available():
                Cp, Cj, v_ap, srcA, srcB, total = native.spgemm_symbolic(
                    A.n_rows, B.n_cols, Ap, Aj, Bp, Bj)
                return {"Cp": Cp, "Cj": Cj.astype(np.int64),
                        "v_ap": v_ap, "srcB": srcB, "srcA": srcA,
                        "n_triples": total}
        except (NotImplementedError, ValueError):
            pass

    iA = np.repeat(np.arange(A.n_rows, dtype=np.int64), Ap[1:] - Ap[:-1])
    lensB = Bp[Aj + 1] - Bp[Aj]  # per A-nnz: how many B entries expand
    total = int(lensB.sum())
    if total == 0:
        return {
            "Cp": np.zeros(A.n_rows + 1, np.int64),
            "Cj": np.zeros(0, np.int64),
            "v_ap": np.zeros(1, np.int64),
            "srcB": np.zeros(0, np.int64),
            "srcA": np.zeros(0, np.int64),
            "n_triples": 0,
        }
    # triple t -> source A-nnz e(t), offset within B row
    e_of_t = np.repeat(np.arange(nnzA, dtype=np.int64), lensB)
    starts = np.concatenate([[0], np.cumsum(lensB)])
    off = np.arange(total, dtype=np.int64) - starts[e_of_t]
    srcB = Bp[Aj[e_of_t]] + off
    i_t = iA[e_of_t]
    j_t = Bj[srcB]

    order = np.lexsort((j_t, i_t))
    i_s, j_s = i_t[order], j_t[order]
    new_out = np.ones(total, dtype=bool)
    new_out[1:] = (i_s[1:] != i_s[:-1]) | (j_s[1:] != j_s[:-1])
    group = np.cumsum(new_out) - 1
    nnzC = int(group[-1]) + 1
    Cj = j_s[new_out]
    Ci = i_s[new_out]
    Cp = np.zeros(A.n_rows + 1, dtype=np.int64)
    np.add.at(Cp, Ci + 1, 1)
    np.cumsum(Cp, out=Cp)

    v_ap = np.zeros(nnzC + 1, dtype=np.int64)
    np.add.at(v_ap, group + 1, 1)
    np.cumsum(v_ap, out=v_ap)
    return {
        "Cp": Cp, "Cj": Cj,
        "v_ap": v_ap,
        "srcB": srcB[order],
        "srcA": e_of_t[order],
        "n_triples": total,
    }


def _ident_token(M: CSR):
    """A per-object token safe to embed in plan-cache keys (unlike
    id(), it cannot alias a recycled object)."""
    tok = getattr(M, "_ident_token", None)
    if tok is None:
        tok = object()
        M._ident_token = tok
    return tok


def _plan(A: CSR, B: CSR):
    """Fetch-or-build the (A, B) symbolic plan + virtual CSR, cached in
    A's plan cache under B's identity token."""
    key = ("spgemm", _ident_token(B))

    def build():
        sym = _spgemm_symbolic(A, B)
        Ax = np.asarray(A.Ax)
        V = CSR(
            n_rows=int(sym["Cj"].shape[0]),
            n_cols=B.nnz,
            Ap=sym["v_ap"],
            Aj=sym["srcB"].astype(
                np.int32 if B.nnz <= np.iinfo(np.int32).max else np.int64),
            Ax=Ax[sym["srcA"]] if sym["n_triples"] else Ax[:0],
        )
        return {"sym": sym, "V": V}

    return plan_cache(A, key, build)


def spgemm(A: CSR, B: CSR, semiring: Semiring = PLUS_TIMES) -> CSR:
    """C = A (x) B over `semiring`; returns CSR with C's pattern."""
    if A.n_cols != B.n_rows:
        raise ValueError(
            f"inner dimensions mismatch: A is {A.shape}, B is {B.shape}")
    plan = _plan(A, B)
    sym, V = plan["sym"], plan["V"]
    nnzC = sym["Cj"].shape[0]
    val_dtype = np.promote_types(np.asarray(A.Ax).dtype,
                                 np.asarray(B.Ax).dtype)
    if nnzC == 0:
        return CSR(A.n_rows, B.n_cols, sym["Cp"],
                   sym["Cj"].astype(np.int32), np.zeros(0, val_dtype))
    cvals = plain_spmv(V, jnp.asarray(np.asarray(B.Ax)), semiring)
    idx_dtype = (np.int32 if B.n_cols <= np.iinfo(np.int32).max
                 else np.int64)
    return CSR(A.n_rows, B.n_cols, sym["Cp"],
               sym["Cj"].astype(idx_dtype), cvals)
