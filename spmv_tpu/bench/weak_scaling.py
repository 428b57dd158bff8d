"""Weak-scaling benchmark for the distributed SpMV layer.

Per-device problem size is held constant while the device count grows;
efficiency(n) = t(n_min) / t(n). Target: >=70% at the largest mesh
(BASELINE.md north star). Runs on any mesh: the GPUs of one host, or
the simulated CPU mesh (XLA_FLAGS=--xla_force_host_platform_device_count=N
JAX_PLATFORMS=cpu), where the numbers check the mechanism only, since
every virtual device shares the host's cores.

Usage:
    python -m spmv_tpu.bench.weak_scaling [--rows-per-dev 65536]
        [--nnz-per-dev 524288] [--devices 1 2 4 8] [--iters 20]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def run(n_devices: int, rows_per_dev: int, nnz_per_dev: int,
        iters: int, mode: str = "halo", seed: int = 0):
    import jax
    from jax.sharding import Mesh

    from spmv_tpu.io.generate import power_law_csr
    from spmv_tpu.parallel import distribute_csr
    from spmv_tpu.utils.timing import time_calls

    devs = jax.devices()
    if len(devs) < n_devices:
        return None
    mesh = Mesh(np.array(devs[:n_devices]), ("shards",))
    n = rows_per_dev * n_devices
    A = power_law_csr(n, n, nnz_per_dev * n_devices, alpha=1.5, seed=seed)
    x = np.random.default_rng(seed).standard_normal(n).astype(np.float32)

    dist = distribute_csr(A, mesh)
    xs = dist.shard_x(x)
    t = float(np.median(time_calls(
        lambda v: dist.matvec(v, mode=mode), xs, iters=iters)))
    return {
        "n_devices": n_devices,
        "nnz": A.nnz,
        "time_s": t,
        "gnnz_per_s": A.nnz / t / 1e9,
        "comm_bytes_per_shard": dist.comm_bytes_per_shard,
        "allgather_bytes_per_shard": dist.allgather_bytes_per_shard,
    }


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--rows-per-dev", type=int, default=1 << 16)
    p.add_argument("--nnz-per-dev", type=int, default=1 << 19)
    p.add_argument("--devices", type=int, nargs="*", default=[1, 2, 4, 8])
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--mode", choices=["halo", "allgather"], default="halo")
    args = p.parse_args(argv)

    results = []
    base = None
    for n in args.devices:
        r = run(n, args.rows_per_dev, args.nnz_per_dev, args.iters,
                mode=args.mode)
        if r is None:
            print(f"n={n}: not enough devices, skipping", file=sys.stderr)
            continue
        if base is None:
            base = r["time_s"]
        r["weak_scaling_efficiency"] = base / r["time_s"]
        results.append(r)
        print(f"n={r['n_devices']}: {r['time_s']*1e3:.3f} ms/iter  "
              f"{r['gnnz_per_s']:.2f} Gnnz/s  "
              f"eff={r['weak_scaling_efficiency']*100:.0f}%  "
              f"comm {r['comm_bytes_per_shard']/1e6:.2f} MB vs "
              f"allgather {r['allgather_bytes_per_shard']/1e6:.2f} MB",
              file=sys.stderr)
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()
