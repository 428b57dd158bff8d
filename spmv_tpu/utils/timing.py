"""Benchmark timing: warmed calls, each ending in `block_until_ready`.

The reference times 2000 dispatches with a host timer
(ref: main.cu:102-113, timer.hpp), and for several kinds its "kernel"
window does not synchronize (BASELINE.md notes). Here every timed call
waits for its result, so a time is the caller's wall time of one
`spmv(...)`, dispatch included. The first call compiles and is not
timed; the reported time is the median of the timed calls.
"""

from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np


@dataclasses.dataclass
class BenchResult:
    kind: str
    implementation: str  # what the kind ran: hopper / plain / dia / ...
    platform: str        # jax platform the times were taken on
    seconds: float       # median wall time of one warmed call
    iters: int
    nnz: int
    n_rows: int
    gnnz_per_s: float
    gflops: float
    gbytes_per_s: float
    # share of the CSR byte floor; GPU only, and not for DIA, which reads
    # no column indices and has no byte model of its own yet
    sol_fraction: Optional[float] = None
    delta: Optional[dict] = None

    def row(self) -> str:
        sol = f"{100*self.sol_fraction:6.1f}%" if self.sol_fraction is not None else "   n/a"
        d = f" Δmean={self.delta['mean_abs']:.3e}" if self.delta else ""
        return (
            f"{self.kind:18s} [{self.implementation:6s} on {self.platform}] "
            f"{self.seconds*1e3:9.4f} ms  "
            f"{self.gnnz_per_s:8.2f} Gnnz/s  {self.gflops:8.2f} GFLOP/s  "
            f"SoL {sol}{d}"
        )


def time_calls(fn: Callable, *args, iters: int = 20) -> list:
    """Wall times of `iters` calls of fn(*args) after one warm-up call,
    each ending in `block_until_ready`."""
    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return times


def benchmark_spmv(
    kind: str,
    A,
    x,
    iters: int = 20,
    semiring=None,
    check: bool = True,
) -> BenchResult:
    from spmv_tpu.ops.registry import implementation, spmv
    from spmv_tpu.ops.reference import spmv_ref, correctness_delta
    from spmv_tpu.utils.roofline import speed_of_light

    x = jnp.asarray(x)

    def fn(xv):
        return spmv(kind, A, xv, semiring=semiring)

    delta = None
    if check and semiring is None:
        y_ref = spmv_ref(A, np.asarray(x), y_dtype=np.float64)
        delta = correctness_delta(y_ref, np.asarray(fn(x)))

    seconds = statistics.median(time_calls(fn, x, iters=iters))
    nnz, n_rows = A.nnz, A.n_rows
    bytes_moved = nnz * 12 + n_rows * 8
    platform = jax.devices()[0].platform
    impl = implementation(kind, A, x, semiring)
    sol = None
    if platform == "gpu" and impl != "dia":
        sol = speed_of_light().floor_s(nnz, n_rows) / seconds
    return BenchResult(
        kind=kind,
        implementation=impl,
        platform=platform,
        seconds=seconds,
        iters=iters,
        nnz=nnz,
        n_rows=n_rows,
        gnnz_per_s=nnz / seconds / 1e9,
        gflops=2 * nnz / seconds / 1e9,
        gbytes_per_s=bytes_moved / seconds / 1e9,
        sol_fraction=sol,
        delta=delta,
    )
