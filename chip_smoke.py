"""Proof that the library's main path runs, compiled, on an NVIDIA GPU.

Usage:
    python chip_smoke.py          # one card: phases 1-6 below
    python chip_smoke.py --four   # four cards: the distributed path only

One card, one process. Phases, each of which fails the run:

1. Device: the backend must be `gpu`; prints the device kind, the
   device count, and the card's name and power limit from nvidia-smi.
2. Every device kind on three matrices users call real, each well past
   the 50 MB L2: a Graph500 Kronecker graph (scale 21, edge factor 16),
   a power-law matrix (2^22 rows, 2^25 nnz) and a banded matrix (2^22
   rows). float32 values and a seeded x against the float64 oracle,
   row by row within 1e-4 * sum_j |a_ij x_j| + 1e-6 (float32 sums taken
   in an order atomics change, over rows of up to 1.3e7 terms). A second
   pass draws Ax and x from {-1, 0, 1}: every partial sum is then an
   integer below 2^24, exact in float32 in any order, so y must equal
   the oracle. Then the `SpMV(...)` shim and the harness CLI run once
   on the banded matrix.
3. Semirings: min_plus and or_and through `merge_genl` on the Kronecker
   graph, exactly equal to a vectorised NumPy reference.
4. Solver: `cg` with Jacobi preconditioning and the `merge` kind on the
   2-D Poisson system at m=1024 (1M rows), float32, rtol=1e-4; the host
   float64 true residual must be at most 1e-3 (float32 CG's true
   residual drifts from its recurrence over thousands of iterations).
5. `spmm` at width 128 on the Kronecker graph against SciPy, under the
   row tolerance of phase 2.
6. Kernel decision timings: the plain path, the merge-path kernel and
   cuSPARSE (through jax.experimental.sparse, as a library comparator)
   on the three matrices, in interleaved turns, beside the byte floor.

`--four` runs `distribute_csr` on four cards in one process: a Kronecker
graph at scale 22, `matvec` in halo and allgather modes and min_plus,
against the references of phases 2 and 3; then it times both modes
beside the one-card merge-path SpMV of the same matrix.

The last line of standard output is one JSON object; it is printed only
when every phase passed.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
import traceback

import numpy as np


def check_device(count: int = 1):
    """The first device, which must be a GPU, with at least `count` GPUs."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"no GPU: JAX's default backend is "
                         f"{devs[0].platform!r}")
    if len(devs) < count:
        raise SystemExit(f"needs {count} GPUs, found {len(devs)}")
    return devs[0]


def card_info() -> str:
    """Name and power limit of each card, from a child that stays off JAX."""
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return r.stdout.strip()


def row_sums_abs(A, x) -> np.ndarray:
    """sum_j |a_ij x_j| per row, in float64."""
    Ap = np.asarray(A.Ap, np.int64)
    prod = np.abs(np.asarray(A.Ax, np.float64) * np.asarray(x, np.float64)[
        np.asarray(A.Aj, np.int64)])
    out = np.zeros(A.n_rows)
    ne = np.nonzero(Ap[1:] > Ap[:-1])[0]
    if ne.size:
        out[ne] = np.add.reduceat(prod, Ap[ne])
    return out


def within_rows(y, y_ref, bound) -> bool:
    return bool(np.all(np.abs(np.asarray(y, np.float64) - y_ref) <= bound))


def ring_reference(A, x, ring: str) -> np.ndarray:
    """min_plus / or_and SpMV in NumPy: the float32 combine per nonzero,
    then a reduceat over the rows; empty rows get the identity."""
    Ap = np.asarray(A.Ap, np.int64)
    a = np.asarray(A.Ax, np.float32)
    xj = np.asarray(x, np.float32)[np.asarray(A.Aj, np.int64)]
    ne = np.nonzero(Ap[1:] > Ap[:-1])[0]
    if ring == "min_plus":
        prod, y = a + xj, np.full(A.n_rows, np.inf, np.float32)
        if ne.size:
            y[ne] = np.minimum.reduceat(prod, Ap[ne])
    else:
        prod = ((a != 0) & (xj != 0)).astype(np.float32)
        y = np.zeros(A.n_rows, np.float32)
        if ne.size:
            y[ne] = np.maximum.reduceat(prod, Ap[ne])
    return y


def matrices():
    """The three matrices of phases 2 and 6, made one at a time."""
    from spmv_tpu.io.generate import banded_csr, kron_graph_csr, power_law_csr

    yield "kron21", lambda: kron_graph_csr(21, edge_factor=16, seed=1)
    yield "powerlaw22", lambda: power_law_csr(1 << 22, 1 << 22, 1 << 25,
                                              alpha=1.5, seed=42)
    yield "banded22", lambda: banded_csr(1 << 22, bandwidth=5, seed=3)


def signs(n: int, rng) -> np.ndarray:
    return rng.integers(-1, 2, n).astype(np.float32)


def phase_kinds(mats: dict):
    """Phase 2: every device kind, tolerance pass and exact {-1,0,1} pass."""
    from spmv_tpu import spmv, spmv_ref
    from spmv_tpu.formats import CSR
    from spmv_tpu.ops.registry import implementation

    kinds = [
        "xla", "csr_scalar", "csr_vector", "csr_vector_shfl",
        "csr_vector_shfl2", "csr_vector_ell", "csr_vector_shfl_ell",
        "csr_vector_shfl2_ell", "light_vec", "light_warp", "light_vec_ell",
        "light_warp_ell", "merge", "merge_stock", "merge_genl",
        "merge_tiled", "stream", "dia",
    ]
    bad = []
    for name, A in mats.items():
        rng = np.random.default_rng(7)
        x = rng.standard_normal(A.n_cols).astype(np.float32)
        y_ref = spmv_ref(A, x, y_dtype=np.float64)
        bound = 1e-4 * row_sums_abs(A, x) + 1e-6
        As = CSR(A.n_rows, A.n_cols, A.Ap, A.Aj, signs(A.nnz, rng))
        xs = signs(A.n_cols, rng)
        ys_ref = spmv_ref(As, xs, y_dtype=np.float64)
        for kind in kinds:
            impl = implementation(kind, A, x)
            y = np.asarray(spmv(kind, A, x))
            ok = within_rows(y, y_ref, bound)
            err = float(np.abs(y - y_ref).max())
            ys = np.asarray(spmv(kind, As, xs))
            exact = bool(np.array_equal(ys, ys_ref))
            print(f"phase2 {name} {kind:21s} impl={impl:6s} "
                  f"tolerance={'ok' if ok else 'FAIL'} max|dy|={err:.3e} "
                  f"exact_pm1={'ok' if exact else 'FAIL'}", flush=True)
            if not (ok and exact):
                bad.append((name, kind))
        del As
    if bad:
        raise AssertionError(f"kinds out of tolerance or inexact: {bad}")


def phase_entry_points(A):
    """Phase 2b: the reference-shaped `SpMV(...)` shim and the harness
    CLI, on the banded matrix."""
    from spmv_tpu import SpMV, spmv_ref
    from spmv_tpu.bench import harness

    x = np.random.default_rng(9).standard_normal(A.n_cols).astype(np.float32)
    y = np.asarray(SpMV("merge", A.n_rows, A.n_cols, A.nnz, A.Ap, A.Aj,
                        A.Ax, x))
    ok = within_rows(y, spmv_ref(A, x, y_dtype=np.float64),
                     1e-4 * row_sums_abs(A, x) + 1e-6)
    print(f"phase2b SpMV(merge) banded22 tolerance={'ok' if ok else 'FAIL'}",
          flush=True)
    if not ok:
        raise AssertionError("SpMV shim out of tolerance")
    # the harness regenerates the same banded matrix (bandwidth 5)
    rows = harness.main(["--synthetic", "banded", "--rows", str(A.n_rows),
                         "--nnz", str(A.nnz), "--iters", "5",
                         "xla", "merge", "dia"])
    got = {r.kind: r.implementation for r in rows}
    if got != {"xla": "plain", "merge": "hopper", "dia": "dia"}:
        raise AssertionError(f"harness ran {got}")
    for r in rows:
        if r.delta["max_rel"] > 1e-4:
            raise AssertionError(f"harness {r.kind}: delta {r.delta}")


def phase_semirings(A):
    """Phase 3: min_plus and or_and through merge_genl, exact."""
    from spmv_tpu import MIN_PLUS, OR_AND, spmv
    from spmv_tpu.ops.registry import implementation

    x = np.random.default_rng(3).standard_normal(A.n_cols).astype(np.float32)
    # about a third of x is zero, so or_and sees both truth values
    x_bool = np.where(np.abs(x) < 0.43, 0.0, x).astype(np.float32)
    for ring, sr, xv in (("min_plus", MIN_PLUS, x), ("or_and", OR_AND, x_bool)):
        y = np.asarray(spmv("merge_genl", A, xv, semiring=sr))
        ref = ring_reference(A, xv, ring)
        eq = bool(np.array_equal(y, ref))
        print(f"phase3 kron21 merge_genl {ring} "
              f"impl={implementation('merge_genl', A, xv, sr)} "
              f"exact={'ok' if eq else 'FAIL'}", flush=True)
        if not eq:
            raise AssertionError(f"{ring} differs from the NumPy reference")


def phase_solver():
    """Phase 4: Jacobi-preconditioned CG on 2-D Poisson, m=1024."""
    from examples.solve_poisson import poisson2d
    from spmv_tpu import cg, spmv_ref

    A = poisson2d(1024)
    b = np.random.default_rng(0).standard_normal(A.n_rows).astype(np.float32)
    t0 = time.perf_counter()
    x, info = cg(A, b, rtol=1e-4, M="jacobi", kind="merge")
    dt = time.perf_counter() - t0
    x = np.asarray(x, np.float64)
    rel = float(np.linalg.norm(b - spmv_ref(A, x, y_dtype=np.float64))
                / np.linalg.norm(b))
    print(f"phase4 cg poisson m=1024 n={A.n_rows} kind=merge M=jacobi "
          f"iters={info['iters']} converged={info['converged']} "
          f"true_rel_residual={rel:.3e} wall={dt:.2f}s", flush=True)
    if not rel <= 1e-3:
        raise AssertionError(f"true residual {rel:.3e} > 1e-3")


def phase_spmm(A):
    """Phase 5: spmm at width 128 against SciPy."""
    import scipy.sparse as sp

    from spmv_tpu import spmm

    X = np.random.default_rng(5).standard_normal(
        (A.n_cols, 128)).astype(np.float32)
    Y = np.asarray(spmm(A, X))
    S = sp.csr_matrix((np.asarray(A.Ax, np.float64), np.asarray(A.Aj),
                       np.asarray(A.Ap)), shape=A.shape)
    ref = S @ X.astype(np.float64)
    bound = 1e-4 * (abs(S) @ np.abs(X.astype(np.float64))) + 1e-6
    ok = bool(np.all(np.abs(Y - ref) <= bound))
    print(f"phase5 spmm kron21 B=128 shape={Y.shape} "
          f"max|dY|={float(np.abs(Y - ref).max()):.3e} "
          f"tolerance={'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("spmm out of tolerance")


def phase_timings(mats: dict, card: str):
    """Phase 6: plain vs merge-path kernel vs cuSPARSE, interleaved."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import sparse

    from spmv_tpu import spmv
    from spmv_tpu.utils.roofline import speed_of_light
    from spmv_tpu.utils.timing import time_calls

    @jax.jit
    def cusparse_matvec(data, indices, indptr, v):
        n = indptr.shape[0] - 1
        return sparse.CSR((data, indices, indptr), shape=(n, v.shape[0])) @ v

    model = speed_of_light()
    for name, A in mats.items():
        x = jnp.asarray(np.random.default_rng(11).standard_normal(
            A.n_cols).astype(np.float32))
        csr = [jnp.asarray(np.asarray(a, np.int32) if i else np.asarray(a))
               for i, a in enumerate((A.Ax, A.Aj, A.Ap))]
        impls = {
            "plain": lambda v, A=A: spmv("xla", A, v),
            "hopper": lambda v, A=A: spmv("merge", A, v),
            "cusparse": lambda v, c=csr: cusparse_matvec(*c, v),
        }
        times = {k: [] for k in impls}
        order = list(impls)
        for turn in range(4):  # A B C, C B A, A B C, C B A
            for k in (order if turn % 2 == 0 else order[::-1]):
                times[k] += time_calls(impls[k], x, iters=20)
        floor = model.floor_s(A.nnz, A.n_rows)
        print(f"phase6 {name} nnz={A.nnz} rows={A.n_rows} "
              f"byte_floor={floor*1e3:.4f}ms (12 B/nnz + 8 B/row at "
              f"{model.hbm_gbps:.0f} GB/s) card={card}", flush=True)
        for k, ts in times.items():
            med = statistics.median(ts)
            print(f"phase6 {name} {k:8s} median={med*1e3:.4f}ms "
                  f"of {len(ts)} calls  floor_share={floor/med:.3f}  "
                  f"card={card}", flush=True)
        del csr


def print_memory(A):
    """compiled.memory_analysis() of the merge-path SpMV on A."""
    import jax
    import jax.numpy as jnp

    from spmv_tpu import PLUS_TIMES, config
    from spmv_tpu.kernels.baseline import device_csr
    from spmv_tpu.kernels.merge import merge_path_rows

    d = device_csr(A)
    x = jnp.zeros((A.n_cols,), jnp.float32)
    compiled = merge_path_rows.lower(
        d["rows"], d["Aj"], d["Ax"], x, sr=PLUS_TIMES, n_rows=A.n_rows,
        interpret=config.use_interpret()).compile()
    print(f"memory_analysis merge-path SpMV nnz={A.nnz}: "
          f"{compiled.memory_analysis()}", flush=True)
    print(f"peak_bytes_in_use="
          f"{(jax.devices()[0].memory_stats() or {}).get('peak_bytes_in_use')}",
          flush=True)


def run_one_card(card: str) -> list:
    failed = []

    def phase(label, fn, *args):
        t0 = time.perf_counter()
        try:
            fn(*args)
            print(f"{label} passed in {time.perf_counter() - t0:.1f}s",
                  flush=True)
        except Exception:
            traceback.print_exc()
            print(f"{label} FAILED", flush=True)
            failed.append(label)

    mats = {}
    for name, make in matrices():
        t0 = time.perf_counter()
        mats[name] = make()
        print(f"matrix {name}: {mats[name].n_rows} rows, nnz={mats[name].nnz}"
              f", made in {time.perf_counter() - t0:.1f}s", flush=True)
    phase("phase2 kinds", phase_kinds, mats)
    phase("phase2b entry points", phase_entry_points, mats["banded22"])
    phase("phase3 semirings", phase_semirings, mats["kron21"])
    phase("phase4 solver", phase_solver)
    phase("phase5 spmm", phase_spmm, mats["kron21"])
    phase("phase6 timings", phase_timings, mats, card)
    phase("memory", print_memory, mats["banded22"])
    return failed


def run_four_cards(card: str) -> list:
    """The distributed path on four cards, against phases 2 and 3's
    references."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from spmv_tpu import MIN_PLUS, spmv, spmv_ref
    from spmv_tpu.formats import CSR
    from spmv_tpu.io.generate import kron_graph_csr
    from spmv_tpu.parallel import distribute_csr
    from spmv_tpu.utils.timing import time_calls

    t0 = time.perf_counter()
    A = kron_graph_csr(22, edge_factor=16, seed=1)
    print(f"matrix kron22: {A.n_rows} rows, nnz={A.nnz}, made in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    devices = jax.devices()[:4]
    mesh = Mesh(np.array(devices), ("shards",))
    rng = np.random.default_rng(7)
    x = rng.standard_normal(A.n_cols).astype(np.float32)
    y_ref = spmv_ref(A, x, y_dtype=np.float64)
    bound = 1e-4 * row_sums_abs(A, x) + 1e-6
    As = CSR(A.n_rows, A.n_cols, A.Ap, A.Aj, signs(A.nnz, rng))
    xs = signs(A.n_cols, rng)
    ys_ref = spmv_ref(As, xs, y_dtype=np.float64)
    failed = []
    t0 = time.perf_counter()
    dist = distribute_csr(A, mesh)
    dist_s = distribute_csr(As, mesh)
    print(f"distribute_csr x2 in {time.perf_counter() - t0:.1f}s", flush=True)
    shard_devs = sorted(s.device.id for s in dist.dev["self"]["rows"]
                        .addressable_shards)
    print(f"shards on device ids {shard_devs}", flush=True)
    if len(set(shard_devs)) != 4:
        failed.append("shards not on four distinct cards")
    for mode in ("halo", "allgather"):
        y = np.asarray(dist.matvec(x, mode=mode))
        ys = np.asarray(dist_s.matvec(xs, mode=mode))
        ok = within_rows(y, y_ref, bound)
        exact = bool(np.array_equal(ys, ys_ref))
        print(f"four kron22 matvec mode={mode} tolerance="
              f"{'ok' if ok else 'FAIL'} max|dy|="
              f"{float(np.abs(y - y_ref).max()):.3e} exact_pm1="
              f"{'ok' if exact else 'FAIL'}", flush=True)
        if not (ok and exact):
            failed.append(f"matvec {mode}")
    ym = np.asarray(dist.matvec(x, semiring=MIN_PLUS))
    eq = bool(np.array_equal(ym, ring_reference(A, x, "min_plus")))
    print(f"four kron22 matvec min_plus exact={'ok' if eq else 'FAIL'}",
          flush=True)
    if not eq:
        failed.append("min_plus")
    # times: both modes on four cards, then the one-card merge-path SpMV
    # of the whole matrix on the first card, in interleaved turns
    xd = dist.shard_x(x)
    impls = {
        "halo": (lambda v: dist.matvec(v, mode="halo"), xd),
        "allgather": (lambda v: dist.matvec(v, mode="allgather"), xd),
        "one_card": (lambda v: spmv("merge", A, v), jnp.asarray(x)),
    }
    times = {k: [] for k in impls}
    order = list(impls)
    for turn in range(4):
        for k in (order if turn % 2 == 0 else order[::-1]):
            times[k] += time_calls(*impls[k], iters=20)
    for k, ts in times.items():
        print(f"four kron22 {k:9s} median={statistics.median(ts)*1e3:.4f}ms "
              f"of {len(ts)} calls card={card}", flush=True)
    print(f"four card={card}", flush=True)
    return failed


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--four", action="store_true",
                   help="run only the distributed path, on four cards")
    args = p.parse_args(argv)
    count = 4 if args.four else 1

    dev = check_device(count)
    from spmv_tpu import config

    print(f"cache dir {config.enable_compile_cache()}", flush=True)
    import jax

    card = card_info()
    print(f"device platform={dev.platform} kind={dev.device_kind} "
          f"count={len(jax.devices())}", flush=True)
    print(card, flush=True)
    card = card.splitlines()[0]
    failed = run_four_cards(card) if args.four else run_one_card(card)
    if failed:
        print(f"FAILED: {failed}", file=sys.stderr, flush=True)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
