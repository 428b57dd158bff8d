"""Driver benchmark: one JSON line.

Metric: merge-path SpMV throughput (Gnnz/s) on a power-law synthetic
matrix (the load-imbalance regime the merge kernel targets,
BASELINE.json config 3), on the attached GPU. vs_baseline: the
achieved share of 80% of the byte floor's rate (BASELINE.md), so 1.0
means the north-star target is met exactly.

The line also carries one timed kind per implementation (`merge`: the
merge-path kernel, `xla`: the plain path, `dia` on a banded matrix),
each with the implementation it ran, and the device, card and power
limit the times were taken on. With no GPU the run fails.
"""

import json
import sys

import numpy as np


def main():
    import jax

    from chip_smoke import card_info, check_device
    from spmv_tpu import config
    from spmv_tpu.io.generate import banded_csr, power_law_csr
    from spmv_tpu.utils.roofline import speed_of_light
    from spmv_tpu.utils.timing import benchmark_spmv

    dev = check_device()
    card = card_info().splitlines()[0]
    config.enable_compile_cache()

    n = 1 << 20
    A = power_law_csr(n, n, 3_300_000, alpha=1.5, seed=42)
    x = np.random.default_rng(0).standard_normal(n).astype(np.float32)
    B = banded_csr(n, bandwidth=5, seed=3)  # ~11 nnz/row
    xb = np.random.default_rng(1).standard_normal(n).astype(np.float32)

    kinds = {}
    for kind, M, v in (("merge", A, x), ("xla", A, x), ("dia", B, xb)):
        r = benchmark_spmv(kind, M, v, iters=20, check=True)
        print(r.row(), file=sys.stderr)
        if r.delta["max_rel"] > 1e-3:
            raise SystemExit(f"{kind}: max relative error "
                             f"{r.delta['max_rel']:.3e} > 1e-3")
        kinds[kind] = {"gnnz_per_s": round(r.gnnz_per_s, 3),
                       "implementation": r.implementation,
                       "ms": round(r.seconds * 1e3, 4)}
        if r.sol_fraction is not None:  # none for dia: no byte model yet
            kinds[kind]["floor_share"] = round(r.sol_fraction, 4)

    floor_s = speed_of_light().floor_s(A.nnz, A.n_rows)
    target = 0.8 * A.nnz / floor_s / 1e9
    value = kinds["merge"]["gnnz_per_s"]
    print(json.dumps({
        "metric": "spmv_gnnz_per_s", "value": value, "unit": "Gnnz/s",
        "vs_baseline": round(value / target, 4),
        "kinds": kinds,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices()), "card": card},
    }))


if __name__ == "__main__":
    main()
