"""Test configuration: run everything on the CPU with 8 virtual devices.

Pallas kernels run in interpreter mode and the multi-device layer runs
on a simulated 8-device mesh (SURVEY §4). Tests marked `gpu` need the
card and skip here; the `gpu` fixture decides, at run time, whether
one is present.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import pytest  # noqa: E402


@pytest.fixture(scope="session", autouse=True)
def _interpret_mode():
    from spmv_tpu import config

    config.set_interpret(True)
    yield


@pytest.fixture
def gpu():
    """The first GPU device; skips the test where there is none."""
    import jax

    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("needs an NVIDIA GPU (run with JAX_PLATFORMS=cuda "
                    "on the card)")
