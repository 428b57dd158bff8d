"""PageRank as repeated SpMV.

The canonical SpMV application (and the workload class — power-law
web/social graphs — the merge-path kernel is designed for, ref:
include/spmv/merge_based/agent_spmv_orig.cuh:1-27's scale-free
motivation). rank_{t+1} = d * P^T rank_t + teleport, with P the
row-stochastic out-link matrix; dangling mass is redistributed
uniformly so ranks stay a probability distribution.

Every iteration is ONE registry SpMV dispatch (pick the kernel with
--kind); the iteration loop is jit-free host code because each step's
device work is a single fused call.

Usage: python examples/pagerank.py [--kind merge] [--nodes 100000]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def pagerank(A_t, out_deg, kind: str, damping=0.85, tol=1e-8,
             max_iters=200):
    """Ranks of the graph whose TRANSPOSED link matrix is A_t.

    A_t[i, j] = 1/out_deg(j) for each edge j->i (column-stochastic
    after the dangling fixup). Returns (ranks, iterations).
    """
    import jax.numpy as jnp

    from spmv_tpu import spmv

    n = A_t.n_rows
    dangling = (out_deg == 0)
    r = jnp.full((n,), 1.0 / n, dtype=jnp.float32)
    for it in range(1, max_iters + 1):
        # dangling nodes spread their mass uniformly
        d_mass = float(np.asarray(r)[dangling].sum()) if dangling.any() else 0.0
        r_new = damping * spmv(kind, A_t, r) + (
            (1.0 - damping) / n + damping * d_mass / n)
        delta = float(jnp.abs(r_new - r).sum())
        r = r_new
        if delta < tol:
            return r, it
    return r, max_iters


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--kind", default="merge")
    p.add_argument("--nodes", type=int, default=100_000)
    p.add_argument("--edges", type=int, default=1_000_000)
    p.add_argument("--damping", type=float, default=0.85)
    args = p.parse_args()

    from spmv_tpu.formats import CSR
    from spmv_tpu.io.generate import power_law_csr

    # power-law directed graph; edge weights 1/out_deg(src) make the
    # transposed matrix the PageRank operator
    G = power_law_csr(args.nodes, args.nodes, args.edges, alpha=1.6,
                      seed=7)
    out_deg = G.row_lengths()
    inv = np.where(out_deg > 0, 1.0 / np.maximum(out_deg, 1), 0.0)
    W = CSR(G.n_rows, G.n_cols, G.Ap, G.Aj,
            np.repeat(inv, out_deg).astype(np.float32))
    A_t = W.transpose()
    print(f"graph: {args.nodes} nodes, {G.nnz} edges; kind={args.kind}",
          flush=True)

    t0 = time.perf_counter()
    r, iters = pagerank(A_t, out_deg, args.kind, damping=args.damping)
    r = np.asarray(r)
    dt = time.perf_counter() - t0
    print(f"converged in {iters} iterations ({dt:.2f}s, "
          f"{dt/iters*1e3:.1f} ms/iter)")
    print(f"rank sum={r.sum():.6f} (should be ~1)")
    top = np.argsort(r)[::-1][:5]
    print("top nodes:", ", ".join(f"{i}={r[i]:.2e}" for i in top))

    # validate against a dense NumPy power iteration (small graphs only
    # — the dense operator is O(nodes^2) memory)
    if args.nodes <= 4000:
        P = W.to_dense().T
        rd = np.full(args.nodes, 1.0 / args.nodes)
        for _ in range(iters):
            dm = rd[out_deg == 0].sum()
            rd = args.damping * (P @ rd) + (
                (1 - args.damping) / args.nodes
                + args.damping * dm / args.nodes)
        err = np.abs(rd - r).max()
        print(f"dense-oracle max abs diff: {err:.2e}")
        assert err < 1e-5


if __name__ == "__main__":
    main()
