"""Solve a 2-D Poisson system with CG + ILU(0), end to end.

Builds the standard 5-point Laplacian on an m x m grid as CSR,
solves A x = b with the library's conjugate-gradient solver (the
matvec dispatches through the kernel registry; pass kind merge for
the merge-path kernel), and reports iterations/residuals
with and without preconditioning.

Run: python examples/solve_poisson.py [m] [kind]
"""

import sys
import time

import numpy as np

from spmv_tpu import cg, coo_to_csr, spmv
from spmv_tpu.formats import COO


def poisson2d(m: int):
    n = m * m
    k = np.arange(n)
    i, j = k // m, k % m
    rows = [k]
    cols = [k]
    vals = [np.full(n, 4.0, np.float32)]
    for di, dj in ((-1, 0), (1, 0), (0, -1), (0, 1)):
        ii, jj = i + di, j + dj
        ok = (ii >= 0) & (ii < m) & (jj >= 0) & (jj < m)
        rows.append(k[ok])
        cols.append((ii * m + jj)[ok])
        vals.append(np.full(ok.sum(), -1.0, np.float32))
    return coo_to_csr(COO(n, n, np.concatenate(rows), np.concatenate(cols),
                          np.concatenate(vals)))


def main(m=64, kind="xla"):
    A = poisson2d(m)
    rng = np.random.default_rng(0)
    b = rng.standard_normal(A.n_rows).astype(np.float32)
    print(f"Poisson {m}x{m}: n={A.n_rows} nnz={A.nnz}, kind={kind}")

    for M in (None, "jacobi", "ilu0"):
        t0 = time.perf_counter()
        x, info = cg(A, b, rtol=1e-6, maxiter=5000, M=M, kind=kind)
        dt = time.perf_counter() - t0
        r = b - np.asarray(spmv(kind, A, np.asarray(x)))
        print(f"  M={M!s:6}: {info['iters']:4d} iters  "
              f"resnorm={info['resnorm']:.3e}  "
              f"true ||r||inf={np.abs(r).max():.3e}  {dt:.2f}s")


if __name__ == "__main__":
    m = int(sys.argv[1]) if len(sys.argv) > 1 else 64
    kind = sys.argv[2] if len(sys.argv) > 2 else "xla"
    main(m, kind)
