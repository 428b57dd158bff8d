"""Global configuration for spmv_tpu.

Compile-time-switch analog of the reference's preprocessor flags
(ref: common.cuh:8, timer.hpp:6, cusp.cuh:13, LightSpMV.cuh:19), done
the JAX way: process-level toggles.
"""

from __future__ import annotations

import os
from typing import Optional

import jax

_interpret_override: Optional[bool] = None


def set_interpret(value: Optional[bool]) -> None:
    """Force the Pallas interpreter on or off (None = by backend).

    The interpreter is how kernels run on the CPU, in tests. A GPU
    backend always runs the compiled kernels, whatever is set here.
    """
    global _interpret_override
    _interpret_override = value


def use_interpret() -> bool:
    """True only off the GPU: when asked for, or on the CPU backend."""
    if jax.default_backend() == "gpu":
        return False
    if _interpret_override is not None:
        return _interpret_override
    return jax.default_backend() == "cpu"


def _default_cache_dir() -> str:
    """`<checkout>/scratch/xla_cache`: anchored to the package's parent
    rather than the cwd, so callers started from other directories
    share one cache (the path is part of the cache's key)."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.join(root, "scratch", "xla_cache")


def enable_compile_cache() -> str:
    """Enable JAX's persistent compilation cache (idempotent).

    Where JAX_COMPILATION_CACHE_DIR is set, JAX already uses it and no
    directory is set here; otherwise the cache goes to
    `<checkout>/scratch/xla_cache`. Every kernel is cached, however
    quick its compile. Returns the cache directory in use.
    """
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = _default_cache_dir()
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return path
