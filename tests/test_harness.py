"""Benchmark harness + graft entry smoke tests."""

import json
import subprocess
import sys
import os

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_harness_cli(tmp_path):
    from spmv_tpu.bench import harness

    results = harness.main(
        ["--synthetic", "random", "--rows", "512", "--nnz", "4096",
         "--iters", "3", "xla", "merge"]
    )
    assert len(results) == 2
    for r in results:
        assert r.seconds > 0
        assert r.implementation == {"xla": "plain", "merge": "hopper"}[r.kind]
        assert r.delta is not None and r.delta["max_abs"] < 1e-2


def test_harness_mtx_file(tmp_path):
    from spmv_tpu.bench import harness
    from spmv_tpu.io.generate import banded_csr
    from spmv_tpu.io.matrix_market import write_matrix_market

    p = tmp_path / "m.mtx"
    write_matrix_market(p, banded_csr(200, 2, seed=0))
    results = harness.main([str(p), "xla", "--iters", "2"])
    assert len(results) == 1 and results[0].kind == "xla"


def test_graft_entry():
    sys.path.insert(0, REPO)
    try:
        import __graft_entry__ as g
    finally:
        sys.path.pop(0)
    import jax

    fn, args = g.entry()
    y = jax.jit(fn)(*args)
    assert y.shape == (2048,)
    g.dryrun_multichip(4)
