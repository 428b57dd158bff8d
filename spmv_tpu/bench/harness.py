"""Benchmark CLI: the reference's main.cu rebuilt on JAX.

Reference flow (ref: main.cu:21-124): load .mtx → CSR → device copy →
CPU oracle → per-kind correctness delta → per-kind timing → report.
This harness reproduces that report shape: each row names the kind,
the implementation it ran (hopper / plain / dia) and the platform, with
the median of warmed calls (see utils/timing.py) and roofline columns
(Gnnz/s, GFLOP/s, share of the byte floor on a GPU). A kind that fails
is reported and makes the CLI exit non-zero after the report.

Usage:
    python -m spmv_tpu.bench.harness MATRIX [kind ...]
    python -m spmv_tpu.bench.harness --synthetic powerlaw --nnz 4000000 merge xla

MATRIX is a .mtx path, or use --synthetic {banded,random,powerlaw,kron}.
Default kinds = one per implementation: xla (plain), merge (hopper),
dia (ref: main.cu runs the kinds named on the CLI, main.cu:22-25).
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

import spmv_tpu
from spmv_tpu import list_kinds, spmv, spmv_ref
from spmv_tpu.io.generate import banded_csr, kron_graph_csr, power_law_csr, random_csr
from spmv_tpu.io.matrix_market import read_matrix_market
from spmv_tpu.ops.reference import correctness_delta
from spmv_tpu.utils.timing import benchmark_spmv

DEFAULT_KINDS = ["xla", "merge", "dia"]


def load_matrix(args) -> "spmv_tpu.CSR":
    if args.matrix and not args.synthetic:
        return read_matrix_market(args.matrix, as_csr=True)
    kind = args.synthetic or "powerlaw"
    n = args.rows
    if kind == "banded":
        return banded_csr(n, bandwidth=max(args.nnz // max(n, 1) // 2, 1))
    if kind == "random":
        return random_csr(n, n, args.nnz)
    if kind == "powerlaw":
        return power_law_csr(n, n, args.nnz, alpha=args.alpha)
    if kind == "kron":
        import math

        scale = max(int(math.log2(max(n, 2))), 2)
        return kron_graph_csr(scale, edge_factor=max(args.nnz // (1 << scale), 1))
    raise SystemExit(f"unknown synthetic kind {kind}")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("matrix", nargs="?", help=".mtx file path")
    p.add_argument("kinds", nargs="*", help="kernel kinds (default: all)")
    p.add_argument("--synthetic", choices=["banded", "random", "powerlaw", "kron"])
    p.add_argument("--rows", type=int, default=1 << 20)
    p.add_argument("--nnz", type=int, default=1 << 23)
    p.add_argument("--alpha", type=float, default=1.5)
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--no-check", action="store_true")
    p.add_argument("--json", action="store_true", help="emit JSON lines")
    p.add_argument("--trace", metavar="DIR", default=None,
                   help="capture a jax.profiler trace of each kind's "
                        "timing loop into DIR (one subdir per kind; "
                        "view with tensorboard/xprof) — the proper "
                        "replacement for the reference Timer's "
                        "unsynced kernel windows (ref: timer.hpp:27-39, "
                        "BASELINE.md caveats)")
    p.add_argument("--x", choices=["ones", "random"], default="random",
                   help="x vector (reference uses all-ones, main.cu:41; "
                        "random is value-sensitive and the default here)")
    args = p.parse_args(argv)

    # Positional juggling: `harness kinds...` with --synthetic.
    kinds = list(args.kinds)
    if args.matrix and args.synthetic:
        kinds = [args.matrix] + kinds
        args.matrix = None
    if not kinds:
        kinds = DEFAULT_KINDS
    bad = [k for k in kinds if k not in list_kinds(include_aliases=True)]
    if bad:
        raise SystemExit(f"unknown kinds {bad}; valid: {list_kinds(include_aliases=True)}")

    import jax

    A = load_matrix(args)
    dev = jax.devices()[0]
    print(f"matrix: {A.n_rows} x {A.n_cols}, nnz={A.nnz} "
          f"(mean {A.mean_nnz_per_row:.2f}/row)  device={dev.platform} "
          f"{dev.device_kind} x{len(jax.devices())}", file=sys.stderr)

    rng = np.random.default_rng(0)
    x = (np.ones(A.n_cols, np.float32) if args.x == "ones"
         else rng.standard_normal(A.n_cols).astype(np.float32))

    results, failed = [], []
    for kind in kinds:
        try:
            if args.trace:
                import os

                with jax.profiler.trace(os.path.join(args.trace, kind)):
                    r = benchmark_spmv(kind, A, x, iters=args.iters,
                                       check=not args.no_check)
            else:
                r = benchmark_spmv(kind, A, x, iters=args.iters,
                                   check=not args.no_check)
        except Exception as e:  # keep the report going, like the ref CLI
            print(f"{kind:18s} FAILED: {type(e).__name__}: {e}", file=sys.stderr)
            failed.append(kind)
            continue
        results.append(r)
        if args.json:
            print(json.dumps(dataclass_to_dict(r)))
        else:
            print(r.row())
    if failed:
        raise SystemExit(f"failed kinds: {failed}")
    return results


def dataclass_to_dict(r):
    import dataclasses

    return dataclasses.asdict(r)


if __name__ == "__main__":
    from spmv_tpu import config

    config.enable_compile_cache()
    main()
