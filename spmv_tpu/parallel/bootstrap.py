"""Multi-process bootstrap: process-group init + meshes.

The reference is single-process/single-GPU (SURVEY §2: no MPI/NCCL,
`cudaSetDevice(0)` at main.cu:53 is its whole device layer). This
module turns N separate processes into one mesh the rest of
`spmv_tpu.parallel` can shard over:

- `init_distributed()` wraps `jax.distributed.initialize` (idempotent;
  a single-process run never touches it). A process group needs its
  coordinator address, process count and id, given as arguments or
  through JAX's own environment variables.
- `make_mesh()` builds a flat `Mesh` over the global device list. The
  GPUs of one host are joined all to all by NVLink, so the device order
  carries no topology and the mesh follows the algorithm alone.
- `put_global()` places a host-replicated numpy array onto a sharding
  that may span non-addressable devices: every process contributes
  its addressable shards via `jax.make_array_from_callback`. This is
  what lets `distribute_csr`'s plan arrays (built identically on every
  host from the same CSR) become one global sharded array without any
  host-side scatter.
"""

from __future__ import annotations

import os

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding

_initialized = False


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> int:
    """Join (or create) the JAX process group. Returns process_count.

    Idempotent: safe to call from library code. Single-process runs
    (no coordinator configured anywhere) return 1 without touching
    `jax.distributed` at all, so tests and one-chip scripts never pay
    the barrier.
    """
    global _initialized
    if _initialized or jax.process_count() > 1:
        _initialized = True
        return jax.process_count()
    configured = (coordinator_address is not None
                  or (num_processes or 1) > 1
                  or os.environ.get("JAX_COORDINATOR_ADDRESS"))
    if not configured:
        _initialized = True
        return 1
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    _initialized = True
    return jax.process_count()


def make_mesh(axis: str = "shards",
              devices=None,
              shape: tuple[int, ...] | None = None,
              axis_names: tuple[str, ...] | None = None) -> Mesh:
    """A Mesh over the global device list, in device order.

    Default: one flat axis named `axis` over every device in the job
    (the layout dist_spmv's 1-D row partition wants). Pass
    `shape`/`axis_names` for multi-axis meshes.
    """
    devices = list(jax.devices()) if devices is None else list(devices)
    if shape is None:
        shape, axis_names = (len(devices),), (axis,)
    return Mesh(np.array(devices).reshape(shape), axis_names)


def put_global(host_array, sharding: NamedSharding) -> jax.Array:
    """Place a host-replicated array onto a (possibly multi-host)
    sharding. Each process materializes only its addressable shards;
    the result is one global `jax.Array`.

    Requires every process to hold the same `host_array` — true for
    all `spmv_tpu` plan products, which are deterministic functions of
    the (replicated) CSR input.
    """
    host_array = np.asarray(host_array)
    return jax.make_array_from_callback(
        host_array.shape, sharding, lambda idx: host_array[idx])
