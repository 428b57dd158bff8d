"""The merge-path kernel (kernels/merge.py) in interpret mode, and the
code around it: which implementation each kind runs, dtype and semiring
routing, interpret mode, the roofline table, the compile cache and the
chip smoke script's device check.

Tests marked `gpu` call what `chip_smoke.py` calls, on the card; here
they skip.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from spmv_tpu import (MAX_TIMES, MIN_PLUS, OR_AND, PLUS_TIMES, Semiring,
                      list_kinds, spmv, spmv_ref)
from spmv_tpu.formats import COO, CSR, coo_to_csr
from spmv_tpu.io.generate import (banded_csr, kron_graph_csr, power_law_csr,
                                  random_csr)
from spmv_tpu.kernels.merge import kernel_serves, merge_path_spmv
from spmv_tpu.ops.reference import spmv_ref_semiring
from spmv_tpu.ops.registry import get_kernel, implementation

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402

TILE = 64  # small, so the test matrices span many tiles


def _coo(n_rows, n_cols, rows, cols, seed=0):
    vals = np.random.default_rng(seed).standard_normal(len(rows))
    return coo_to_csr(COO(n_rows, n_cols, np.asarray(rows, np.int32),
                          np.asarray(cols, np.int32),
                          vals.astype(np.float32)))


def _empty_rows_giant_row():
    rng = np.random.default_rng(3)
    rows = np.concatenate([np.full(500, 100), rng.integers(200, 210, 40)])
    return _coo(257, 64, rows, rng.integers(0, 64, rows.size))


def _hub_row():
    # row 5 holds 3.5 tiles of nonzeros: with TILE=64 its first entry
    # sits mid-tile and a later tile edge falls on a row end
    lens = np.array([3, 7, 20, 1, 0, 225, 0, 8, 64, 64, 2, 30])
    rows = np.repeat(np.arange(lens.size), lens)
    cols = np.random.default_rng(9).integers(0, 40, rows.size)
    A = _coo(lens.size, 40, rows, cols, seed=9)
    starts = np.asarray(A.Ap)[:-1]
    assert (np.asarray(A.Ap) % TILE == 0).sum() >= 2  # edges on row ends
    assert any(s % TILE for s in starts if s)  # and mid-row
    return A


MATRICES = {
    "banded": lambda: banded_csr(300, bandwidth=3, seed=0),
    "random": lambda: random_csr(200, 150, 2000, seed=1),
    "powerlaw": lambda: power_law_csr(400, 300, 5000, seed=2),
    "kron": lambda: kron_graph_csr(8, edge_factor=8, seed=4),
    "empty_rows_giant_row": _empty_rows_giant_row,
    "single_column": lambda: _coo(50, 1, np.arange(0, 50, 2),
                                  np.zeros(25), seed=4),
    "empty": lambda: _coo(10, 10, [], []),
    "rectangular": lambda: random_csr(90, 700, 1500, seed=5),
    "hub_row": _hub_row,
}
RINGS = {"plus_times": PLUS_TIMES, "min_plus": MIN_PLUS,
         "max_times": MAX_TIMES, "or_and": OR_AND}


@pytest.mark.parametrize("ring", sorted(RINGS))
@pytest.mark.parametrize("mat", sorted(MATRICES))
def test_kernel_matches_oracle(mat, ring):
    A = MATRICES[mat]()
    x = np.random.default_rng(1).standard_normal(A.n_cols).astype(np.float32)
    if ring == "or_and":
        x[::3] = 0.0
    sr = RINGS[ring]
    y = np.asarray(merge_path_spmv(A, x, sr, tile=TILE))
    assert y.shape == (A.n_rows,) and y.dtype == np.float32
    if sr is PLUS_TIMES:
        np.testing.assert_allclose(y, spmv_ref(A, x, y_dtype=np.float64),
                                   rtol=2e-5, atol=5e-5)
    else:  # min and max are exact in any order
        np.testing.assert_array_equal(y, spmv_ref_semiring(A, x, sr))


@pytest.mark.parametrize("tile", [32, 128, 1024])
def test_pm1_values_exact(tile):
    """Ax and x in {-1, 0, 1}: every partial sum is a small integer, so
    float32 is exact in any order and y must equal the oracle; a dropped
    or doubled term cannot hide under a tolerance."""
    A = power_law_csr(3000, 2000, 40000, seed=6)
    rng = np.random.default_rng(6)
    As = CSR(A.n_rows, A.n_cols, A.Ap, A.Aj,
             rng.integers(-1, 2, A.nnz).astype(np.float32))
    x = rng.integers(-1, 2, A.n_cols).astype(np.float32)
    y = np.asarray(merge_path_spmv(As, x, tile=tile))
    np.testing.assert_array_equal(y, spmv_ref(As, x, y_dtype=np.float64))


def _check_half_precision(dtype, tile):
    """Half-precision values and x, summed in float32: the reference
    sums the same half inputs exactly, and a float32 sum rounded once to
    `dtype` stays within half an ulp of the row scale."""
    A = power_law_csr(500, 400, 20000, seed=7)  # rows of thousands of terms
    Ah = CSR(A.n_rows, A.n_cols, A.Ap, A.Aj, np.asarray(A.Ax).astype(dtype))
    x = np.random.default_rng(7).standard_normal(400).astype(dtype)
    assert implementation("merge", Ah, x) == "hopper"
    y = np.asarray(merge_path_spmv(Ah, x, tile=tile))
    assert y.dtype == dtype
    A32 = CSR(A.n_rows, A.n_cols, A.Ap, A.Aj,
              np.asarray(Ah.Ax).astype(np.float32))
    ref = spmv_ref(A32, x.astype(np.float32), y_dtype=np.float64)
    scale = chip_smoke.row_sums_abs(A32, x.astype(np.float32))
    half_ulp = 2.0 ** -(jnp.finfo(dtype).nmant + 1)
    assert np.all(np.abs(y.astype(np.float64) - ref)
                  <= half_ulp * scale + 1e-6)


def test_bfloat16_accumulates_in_float32():
    _check_half_precision(jnp.bfloat16, TILE)


def test_float16_accumulates_in_float32():
    _check_half_precision(jnp.float16, TILE)


def test_float64_and_ints_run_the_plain_path():
    A = random_csr(60, 60, 400, seed=8)
    assert not kernel_serves(A, np.float64, PLUS_TIMES)
    assert not kernel_serves(A, np.int32, PLUS_TIMES)
    with jax.enable_x64(True):
        A64 = A.astype(value_dtype=np.float64)
        x = np.random.default_rng(8).standard_normal(60)
        assert implementation("merge", A64, x) == "plain"
        y = np.asarray(spmv("merge", A64, x))
        assert y.dtype == np.float64
        np.testing.assert_allclose(y, spmv_ref(A64, x), rtol=1e-12)
    with pytest.raises(ValueError, match="plain path"):
        with jax.enable_x64(True):
            merge_path_spmv(A64, x)


@pytest.mark.parametrize("delta", [-1, 0, 1])
def test_ragged_last_tile(delta):
    """nnz one short of, equal to, and one past a whole number of
    tiles: the masked loads of the last tile read nothing past nnz."""
    nnz = 4 * TILE + delta
    rng = np.random.default_rng(10)
    A = _coo(37, 29, np.sort(rng.integers(0, 37, nnz)),
             rng.integers(0, 29, nnz), seed=10)
    assert A.nnz == nnz
    x = rng.standard_normal(29).astype(np.float32)
    np.testing.assert_allclose(np.asarray(merge_path_spmv(A, x, tile=TILE)),
                               spmv_ref(A, x, y_dtype=np.float64),
                               rtol=2e-5, atol=5e-5)


_EXPECTED = {"cpu_naive": "host", "dense": "dense", "xla": "plain",
             "dia": "plain"}


@pytest.mark.parametrize("kind", list_kinds(include_aliases=True))
def test_recorded_implementation(kind):
    """Every kind name says which implementation it runs: the merge-path
    kernel for the zoo's names, the plain path for `xla`, DIA only on
    diagonal-sparse input."""
    A = power_law_csr(200, 200, 1500, seed=11)
    x = np.ones(200, np.float32)
    want = _EXPECTED.get(get_kernel(kind).name, "hopper")
    assert implementation(kind, A, x) == want


def test_user_semiring_runs_plain_path():
    max_plus = Semiring("max_plus", lambda: float("-inf"),
                        lambda a, x: a + x, lambda acc, v: jnp.maximum(acc, v))
    A = random_csr(80, 70, 600, seed=12)
    x = np.random.default_rng(12).standard_normal(70).astype(np.float32)
    assert not kernel_serves(A, np.float32, max_plus)
    assert implementation("merge", A, x, max_plus) == "plain"
    y = np.asarray(spmv("merge", A, x, semiring=max_plus))
    np.testing.assert_array_equal(y, spmv_ref_semiring(A, x, max_plus))


def test_use_interpret_never_on_gpu(monkeypatch):
    from spmv_tpu import config

    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    config.set_interpret(True)  # even when asked for
    try:
        assert config.use_interpret() is False
    finally:
        config.set_interpret(True)


def test_roofline_h100_row():
    from spmv_tpu.utils.roofline import device_peaks, speed_of_light

    peaks = device_peaks("NVIDIA H100 80GB HBM3")
    assert peaks == {"hbm_gbps": 3350.0, "hbm_gb": 80.0}
    m = speed_of_light(device_kind="NVIDIA H100 80GB HBM3")
    # 2^25 nnz, 2^22 rows: (12 B/nnz + 8 B/row) / 3.35 TB/s
    assert m.floor_s(1 << 25, 1 << 22) == pytest.approx(
        (12 * 2 ** 25 + 8 * 2 ** 22) / 3.35e12)


def test_roofline_unknown_device_raises():
    from spmv_tpu.utils.roofline import device_peaks, speed_of_light

    with pytest.raises(KeyError, match="no published peaks"):
        device_peaks("cpu")
    with pytest.raises(KeyError):
        speed_of_light(device_kind="an unlisted accelerator")


_CACHE_PROBE = """
import os, jax, jax.numpy as jnp
from spmv_tpu import config
used = config.enable_compile_cache()
jax.jit(lambda v: v * 2 + 1)(jnp.arange(8.0)).block_until_ready()
print(used, jax.config.jax_compilation_cache_dir,
      sum(len(f) for _, _, f in os.walk(used)))
"""


def _cache_probe(env_dir):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    if env_dir:
        env["JAX_COMPILATION_CACHE_DIR"] = env_dir
    r = subprocess.run([sys.executable, "-c", _CACHE_PROBE], env=env,
                       cwd=REPO, capture_output=True, text=True, timeout=120,
                       check=True)
    return r.stdout.split()


def test_compile_cache_honours_env(tmp_path):
    used, cfg, n_files = _cache_probe(str(tmp_path))
    assert used == cfg == str(tmp_path)
    assert int(n_files) > 0


def test_compile_cache_default_in_checkout(tmp_path):
    from spmv_tpu import config

    used, cfg, _ = _cache_probe(None)
    assert used == cfg == config._default_cache_dir()
    assert used == os.path.join(REPO, "scratch", "xla_cache")


def test_chip_smoke_refuses_cpu():
    with pytest.raises(SystemExit, match="no GPU"):
        chip_smoke.check_device()


def test_chip_smoke_script_fails_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "chip_smoke.py"], env=env, cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    for line in r.stdout.splitlines():
        with pytest.raises(json.JSONDecodeError):
            json.loads(line)


@pytest.mark.gpu
def test_gpu_device_check(gpu):
    assert chip_smoke.check_device() == gpu
    assert "," in chip_smoke.card_info()


@pytest.mark.gpu
def test_gpu_kinds(gpu):
    chip_smoke.phase_kinds({"kron16": kron_graph_csr(16, 16, seed=1),
                            "powerlaw": power_law_csr(1 << 16, 1 << 16,
                                                      1 << 20, seed=42)})


@pytest.mark.gpu
def test_gpu_semirings(gpu):
    chip_smoke.phase_semirings(kron_graph_csr(16, 16, seed=1))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_gpu_half_precision(gpu, dtype):
    from spmv_tpu.kernels.merge import TILE as CARD_TILE

    _check_half_precision(jnp.dtype(dtype), CARD_TILE)
