"""Iterative Krylov solvers on top of the SpMV kernel zoo.

The reference is a kernel benchmark and stops at y = A @ x; a
standalone sparse library must also *use* its kernels. This module
supplies the two standard Krylov methods (CG for SPD systems,
BiCGSTAB for general square systems) as jit-compiled
`lax.while_loop`s — every iteration is one or two SpMV dispatches
through the registry (any registered kind) plus vector work XLA fuses
into a handful of HBM passes, with optional Jacobi or ILU(0)
preconditioning (kernels/trisolve.py).

The loop carries only O(n) vectors; convergence tests ride in the
carry (no host sync per iteration); the one host decision — total
iteration count — is `maxiter`, a static bound. Callers read
`info["iters"]`/`info["resnorm"]` afterwards (one device fetch).

Every inner product asks for full float32 precision: on a GPU a
float32 dot may otherwise run in TF32, which keeps about three
decimal digits.
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import jax
import jax.numpy as jnp
import numpy as np

from spmv_tpu.formats import CSR
from spmv_tpu.kernels.trisolve import ilu0, ilu0_apply
from spmv_tpu.ops.registry import spmv


def _dot(a, b):
    return jnp.vdot(a, b, precision=jax.lax.Precision.HIGHEST)


def _matvec(A: CSR, kind: str) -> Callable:
    return lambda v: spmv(kind, A, v)


def _preconditioner(A: CSR, M) -> Callable:
    """None | 'jacobi' | 'ilu0' | callable -> apply function."""
    if M is None:
        return lambda r: r
    if callable(M):
        return M
    if M == "jacobi":
        Ap = np.asarray(A.Ap, np.int64)
        Aj = np.asarray(A.Aj, np.int64)
        Ax = np.asarray(A.Ax)
        rows = np.repeat(np.arange(A.n_rows, dtype=np.int64),
                         Ap[1:] - Ap[:-1])
        d = np.zeros(A.n_rows, dtype=Ax.dtype)
        on_diag = rows == Aj
        d[rows[on_diag]] = Ax[on_diag]
        if (d == 0).any():
            raise ValueError("jacobi preconditioner: zero diagonal entry")
        dinv = jnp.asarray(1.0 / d)
        return lambda r: dinv * r
    if M == "ilu0":
        L, U = ilu0(A)
        return lambda r: ilu0_apply(L, U, r)
    raise ValueError(f"unknown preconditioner {M!r}; use None, 'jacobi', "
                     f"'ilu0', or a callable")


def cg(A: CSR, b, *, x0=None, rtol: float = 1e-6, atol: float = 0.0,
       maxiter: Optional[int] = None, M=None,
       kind: str = "xla"):
    """Conjugate gradients for SPD A. Returns (x, info) with
    info = {"iters", "resnorm", "converged"}.

    Matches scipy.sparse.linalg.cg semantics: stop when
    ||r|| <= max(rtol*||b||, atol). `kind` picks the SpMV kernel
    (any registered kind).
    """
    if A.n_rows != A.n_cols:
        raise ValueError("cg requires a square matrix")
    b = jnp.asarray(b)
    if b.shape != (A.n_rows,):
        raise ValueError(f"b has shape {b.shape}, expected ({A.n_rows},)")
    mv = _matvec(A, kind)
    psolve = _preconditioner(A, M)
    n = A.n_rows
    if maxiter is None:
        maxiter = min(10 * n, 10_000)
    x = jnp.zeros_like(b) if x0 is None else jnp.asarray(x0)

    target = jnp.maximum(rtol * jnp.linalg.norm(b), atol)

    r = b - mv(x)
    z = psolve(r)
    p = z
    rz = _dot(r, z)

    def cond(state):
        x, r, z, p, rz, k = state
        return (jnp.linalg.norm(r) > target) & (k < maxiter)

    def body(state):
        x, r, z, p, rz, k = state
        Ap_ = mv(p)
        denom = _dot(p, Ap_)
        alpha = jnp.where(denom != 0, rz / denom, 0.0)
        x = x + alpha * p
        r = r - alpha * Ap_
        z = psolve(r)
        rz_new = _dot(r, z)
        beta = jnp.where(rz != 0, rz_new / rz, 0.0)
        p = z + beta * p
        return (x, r, z, p, rz_new, k + 1)

    x, r, _, _, _, k = jax.lax.while_loop(cond, body, (x, r, z, p, rz, 0))
    resnorm = jnp.linalg.norm(r)
    return x, {"iters": int(k), "resnorm": float(resnorm),
               "converged": bool(resnorm <= target)}


def bicgstab(A: CSR, b, *, x0=None, rtol: float = 1e-6, atol: float = 0.0,
             maxiter: Optional[int] = None, M=None,
             kind: str = "xla"):
    """BiCGSTAB for general square A. Returns (x, info) like `cg`."""
    if A.n_rows != A.n_cols:
        raise ValueError("bicgstab requires a square matrix")
    b = jnp.asarray(b)
    if b.shape != (A.n_rows,):
        raise ValueError(f"b has shape {b.shape}, expected ({A.n_rows},)")
    mv = _matvec(A, kind)
    psolve = _preconditioner(A, M)
    n = A.n_rows
    if maxiter is None:
        maxiter = min(10 * n, 10_000)
    x = jnp.zeros_like(b) if x0 is None else jnp.asarray(x0)

    target = jnp.maximum(rtol * jnp.linalg.norm(b), atol)

    r = b - mv(x)
    rhat = r  # shadow residual, fixed
    rho = _dot(rhat, r)
    p = r

    def cond(state):
        x, r, p, rho, k, brk = state
        return (jnp.linalg.norm(r) > target) & (k < maxiter) & ~brk

    def body(state):
        x, r, p, rho, k, brk = state
        ph = psolve(p)
        v = mv(ph)
        denom = _dot(rhat, v)
        alpha = jnp.where(denom != 0, rho / denom, 0.0)
        s = r - alpha * v
        sh = psolve(s)
        t = mv(sh)
        tt = _dot(t, t)
        omega = jnp.where(tt != 0, _dot(t, s) / tt, 0.0)
        x = x + alpha * ph + omega * sh
        r = s - omega * t
        rho_new = _dot(rhat, r)
        beta = jnp.where((rho != 0) & (omega != 0),
                         (rho_new / rho) * (alpha / omega), 0.0)
        p = r + beta * (p - omega * v)
        # breakdown: rho or omega vanished — r no longer improvable
        brk = (rho_new == 0) | (omega == 0)
        return (x, r, p, rho_new, k + 1, brk)

    x, r, _, _, k, _ = jax.lax.while_loop(
        cond, body, (x, r, p, rho, 0, jnp.asarray(False)))
    resnorm = jnp.linalg.norm(r)
    return x, {"iters": int(k), "resnorm": float(resnorm),
               "converged": bool(resnorm <= target)}


def gmres(A: CSR, b, *, x0=None, rtol: float = 1e-6, atol: float = 0.0,
          restart: int = 32, maxiter: Optional[int] = None, M=None,
          kind: str = "xla"):
    """Restarted GMRES(m) for general square A. Returns (x, info).

    Left-preconditioned: the stopping test is on the preconditioned
    residual ||M^-1 (b - Ax)|| <= max(rtol*||M^-1 b||, atol), matching
    scipy.sparse.linalg.gmres's legacy behavior. Each restart cycle is
    one jitted Arnoldi sweep of `restart` steps (modified Gram-Schmidt
    under `lax.fori_loop`, so the Krylov basis stays device-resident)
    followed by an (m+1)x(m) least-squares solve — tiny, XLA handles
    it on-chip. `maxiter` bounds total inner iterations.

    The basis V is (m+1, n) in device memory; one matvec per inner
    step, one extra matvec per cycle for the true-residual restart.
    No host sync inside the `lax.while_loop` over cycles.
    """
    if A.n_rows != A.n_cols:
        raise ValueError("gmres requires a square matrix")
    b = jnp.asarray(b)
    if b.shape != (A.n_rows,):
        raise ValueError(f"b has shape {b.shape}, expected ({A.n_rows},)")
    mv = _matvec(A, kind)
    psolve = _preconditioner(A, M)
    n = A.n_rows
    m = max(1, min(restart, n))
    if maxiter is None:
        maxiter = min(10 * n, 10_000)
    max_cycles = -(-maxiter // m)
    x = jnp.zeros_like(b) if x0 is None else jnp.asarray(x0)

    pb = psolve(b)
    target = jnp.maximum(rtol * jnp.linalg.norm(pb), atol)

    def cycle(x):
        r = psolve(b - mv(x))
        beta = jnp.linalg.norm(r)
        V = jnp.zeros((m + 1, n), dtype=b.dtype)
        V = V.at[0].set(r / jnp.where(beta > 0, beta, 1.0))
        H = jnp.zeros((m + 1, m), dtype=b.dtype)

        def arnoldi(j, carry):
            V, H = carry
            w = psolve(mv(V[j]))

            def mgs(i, wh):
                w, H = wh
                hij = _dot(V[i], w)
                w = w - hij * V[i]
                return (w, H.at[i, j].set(hij))

            w, H = jax.lax.fori_loop(0, j + 1, mgs, (w, H))
            hnext = jnp.linalg.norm(w)
            H = H.at[j + 1, j].set(hnext)
            V = V.at[j + 1].set(w / jnp.where(hnext > 0, hnext, 1.0))
            return (V, H)

        V, H = jax.lax.fori_loop(0, m, arnoldi, (V, H))
        e1 = jnp.zeros(m + 1, dtype=b.dtype).at[0].set(beta)
        y = jnp.linalg.lstsq(H, e1)[0]
        return x + jnp.matmul(V[:m].T, y,
                              precision=jax.lax.Precision.HIGHEST)

    def cond(state):
        x, resnorm, k = state
        return (resnorm > target) & (k < max_cycles)

    def body(state):
        x, _, k = state
        x = cycle(x)
        resnorm = jnp.linalg.norm(psolve(b - mv(x)))
        return (x, resnorm, k + 1)

    r0 = jnp.linalg.norm(psolve(b - mv(x)))
    x, resnorm, k = jax.lax.while_loop(cond, body, (x, r0, 0))
    return x, {"iters": int(k) * m, "resnorm": float(resnorm),
               "converged": bool(resnorm <= target)}
