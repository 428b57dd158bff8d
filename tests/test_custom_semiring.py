"""User-defined semirings must run on every DEVICE kernel family.

The reference's merge_genl accepts any static functor_t
(ref: include/spmv/merge_genl/agent_spmv_orig.cuh:98-124,
merge_genl.cuh:22-38); here the analog is any `Semiring` object traced
straight into the jitted kernels. These tests pin
that reach with semirings that are NOT in BUILTIN_SEMIRINGS, plus the
boolean-correctness fix for or_and and the dtype-rigor contract.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from spmv_tpu import spmv, spmv_ref_semiring
from spmv_tpu.formats import COO, coo_to_csr
from spmv_tpu.io.generate import power_law_csr, random_csr
from spmv_tpu.ops.semiring import OR_AND, Semiring

# max-plus: NOT a registered builtin name -> exercises the fully
# generic path everywhere (scans, carries, fixup, epilogues).
MAX_PLUS = Semiring(
    name="max_plus",
    initialize=lambda: float("-inf"),
    combine=lambda a, x: a + x,
    reduce=lambda acc, v: jnp.maximum(acc, v),
)

# saturating-add over (+, x): values clamp at CAP — associative,
# no inverse, nothing like a builtin.
CAP = 4.0
SAT_ADD_TIMES = Semiring(
    name="sat_add_times",
    initialize=lambda: 0.0,
    combine=lambda a, x: a * x,
    reduce=lambda acc, v: jnp.minimum(acc + v, CAP),
)

GENERIC_KINDS = ["merge_genl", "stream", "xla", "csr_vector", "light_vec",
                 "csr_scalar", "merge"]


@pytest.fixture(scope="module")
def posmat():
    A = power_law_csr(180, 180, 1600, seed=5)
    Ax = np.abs(np.asarray(A.Ax)).astype(np.float32) + 0.05
    return coo_to_csr(COO(180, 180, A.row_ids(), np.asarray(A.Aj), Ax))


@pytest.mark.parametrize("kind", GENERIC_KINDS)
def test_custom_max_plus_matches_oracle(posmat, kind):
    x = np.abs(np.random.default_rng(2).standard_normal(180)).astype(np.float32)
    y = np.asarray(spmv(kind, posmat, x, semiring=MAX_PLUS))
    y_ref = spmv_ref_semiring(posmat, x, MAX_PLUS, y_dtype=np.float32)
    np.testing.assert_allclose(y, y_ref, rtol=2e-5, atol=1e-5, err_msg=kind)


@pytest.mark.parametrize("kind", ["merge_genl", "stream"])
def test_custom_saturating_semiring(posmat, kind):
    # Saturating reduce is order-sensitive only at the cap boundary;
    # keep terms tiny so every order saturates identically.
    x = np.full(180, 0.01, np.float32)
    y = np.asarray(spmv(kind, posmat, x, semiring=SAT_ADD_TIMES))
    y_ref = spmv_ref_semiring(posmat, x, SAT_ADD_TIMES, y_dtype=np.float32)
    np.testing.assert_allclose(y, y_ref, rtol=2e-5, atol=1e-5, err_msg=kind)


@pytest.mark.parametrize("kind", GENERIC_KINDS)
def test_or_and_is_boolean_on_arbitrary_data(kind):
    # Arbitrary signed reals: or_and must treat any nonzero as true —
    # a min/max-over-{0,1} shortcut would be silently wrong here.
    A = random_csr(90, 90, 700, seed=13)  # signed values
    rng = np.random.default_rng(3)
    x = rng.standard_normal(90).astype(np.float32)
    x[rng.random(90) < 0.5] = 0.0
    y = np.asarray(spmv(kind, A, x, semiring=OR_AND))
    y_ref = spmv_ref_semiring(A, x, OR_AND, y_dtype=np.float32)
    np.testing.assert_array_equal(y, y_ref, err_msg=kind)


def test_y_dtype_is_independently_selectable():
    A = random_csr(40, 40, 200, seed=1)
    x = np.ones(40, np.float32)
    y = spmv("merge", A, x, y_dtype=jnp.bfloat16)
    assert y.dtype == jnp.bfloat16
    y32 = np.asarray(spmv("merge", A, x)).astype(np.float32)
    np.testing.assert_allclose(np.asarray(y).astype(np.float32), y32,
                               rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("kind", ["merge", "stream", "csr_vector"])
def test_fp64_without_x64_raises_loudly(kind):
    if jax.config.jax_enable_x64:
        pytest.skip("x64 enabled; fp64 is legitimately supported")
    A = random_csr(20, 20, 60, seed=4, value_dtype=np.float64)
    x = np.ones(20, np.float64)
    with pytest.raises(ValueError, match="float64"):
        spmv(kind, A, x)
