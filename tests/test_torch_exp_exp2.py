"""The port's exp-vs-exp2 microbenchmark (K6,
``mingpt_distributed_tpu_torch/tools/exp_exp2.py``) against the JAX tool
``tools/exp_exp2.py``, loaded from its path, its ``_kernel`` run through
``pl.pallas_call`` in interpret mode on the CPU.

* ``exp_chain_plain`` against the JAX kernel on a (2, 8, 128) block grid of
  standard-normal inputs, for each op at the tool's REPS = 64 and at reps 1,
  2 and 5, within 1e-6 absolute (outputs lie in (0, 1]; the chain's slope
  is below 1, so it does not amplify rounding). At 64 reps every element
  has reached the chain's fixed point, whatever the input; the small reps
  show that the input is read and that each rep is applied.
* The wrapper takes the plain version on the CPU and launches nothing; it
  raises for what the kernel does not take. Its ctypes argument list
  matches the C entry point in ``ops/csrc/exp_exp2.cu``.
* The bound: the tool's shape needs ~0.257 ms of exponentials at 1980 MHz
  against ~0.040 ms of bytes.
* The tool runs end to end with ``--device cpu``.
"""

import ctypes
import functools
import importlib.util
import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from mingpt_distributed_tpu_torch.ops import _build
from mingpt_distributed_tpu_torch.tools import exp_exp2 as ex
from mingpt_distributed_tpu_torch.training.metrics import (
    SFU_EXPS_PER_CLOCK_PER_SM,
    roofline_ms,
)
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NBLOCKS, ROWS, COLS = 2, 8, 128
TOL = 1e-6
JAX_OPS = {"exp": jnp.exp, "exp2": jnp.exp2,
           "exp2*log2e": lambda y: jnp.exp2(y * 1.4426950408889634)}


@pytest.fixture(scope="module")
def jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_exp_exp2", os.path.join(REPO, "tools", "exp_exp2.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_chain(mod, x, op, reps):
    """The JAX tool's kernel with REPS = reps (read when it is traced)."""
    mod.REPS = reps
    return pl.pallas_call(
        functools.partial(mod._kernel, op=JAX_OPS[op]),
        grid=(NBLOCKS,),
        in_specs=[pl.BlockSpec((1, ROWS, COLS), lambda i: (i, 0, 0))],
        out_specs=pl.BlockSpec((1, ROWS, COLS), lambda i: (i, 0, 0)),
        out_shape=jax.ShapeDtypeStruct(x.shape, x.dtype),
        interpret=True,
    )(jnp.asarray(x))


@pytest.mark.parametrize("reps", [ex.REPS, 1, 2, 5])
@pytest.mark.parametrize("op", sorted(ex.OPS))
def test_exp_chain_plain_matches_the_jax_kernel(jax_tool, op, reps):
    x = np.random.default_rng(61).standard_normal(
        (NBLOCKS, ROWS, COLS)).astype(np.float32)
    want = np.asarray(_jax_chain(jax_tool, x, op, reps))
    got = ex.exp_chain_plain(torch.from_numpy(x), op, reps).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    if reps == 1:  # the input is read: outputs spread over most of (0, 1)
        assert got.max() - got.min() > 0.5


def test_exp_chain_on_the_cpu_is_the_plain_version():
    x = torch.randn((3, 100, 77), generator=torch.Generator().manual_seed(0))
    n0 = ex.exp_chain.launches
    for op in ex.OPS:
        assert torch.equal(ex.exp_chain(x, op, reps=5),
                           ex.exp_chain_plain(x, op, reps=5))
    assert ex.exp_chain.launches == n0


# name: (input, op, reps, exception, message pattern)
REFUSALS = {
    "float64": (torch.zeros(8, dtype=torch.float64), "exp", 4, TypeError,
                "takes float32"),
    "bfloat16": (torch.zeros(8, dtype=torch.bfloat16), "exp2", 4, TypeError,
                 "takes float32"),
    "non_contiguous": (torch.zeros(8, 8).t(), "exp", 4, ValueError, "contiguous"),
    "unknown_op": (torch.zeros(8), "exp10", 4, ValueError, "op must be one of"),
    "zero_reps": (torch.zeros(8), "exp", 0, ValueError, "reps must be"),
    "meta_device": (torch.zeros(8, device="meta"), "exp", 4, ValueError,
                    "runs on cuda or cpu"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_exp_chain_refuses_what_the_kernel_does_not_take(case):
    x, op, reps, exc, pattern = REFUSALS[case]
    with pytest.raises(exc, match=pattern):
        ex.exp_chain(x, op, reps)


def test_argument_types_match_the_c_entry_point():
    text = (_build.CSRC / "exp_exp2.cu").read_text()
    m = re.search(r'extern "C" int exp_chain\(([^)]*)\)', text)
    assert m
    c_types = [" ".join(w for w in p.replace("*", " * ").split()[:-1]
                        if w != "const").replace(" *", "*")
               for p in m.group(1).split(",")]
    names = {ctypes.c_void_p: "void*", ctypes.c_int: "int",
             ctypes.c_longlong: "long long"}
    assert c_types == [names[t] for t in ex.ARGTYPES]
    assert "exp_exp2" in _build.SOURCES


def test_the_tool_bound_is_the_exponentials_at_the_sfu_rate():
    n = 64 * ex.BLOCK * ex.BLOCK
    rate = 132 * SFU_EXPS_PER_CLOCK_PER_SM * 1980e6  # H100 SXM at 1980 MHz
    ms, by = roofline_ms(2 * n * 4, [(n * ex.REPS, rate)])
    assert by == "operations" and ms == pytest.approx(0.2568, abs=1e-4)
    ms, by = roofline_ms(2 * n * 4)
    assert by == "bytes" and ms == pytest.approx(0.04006, abs=1e-5)


def test_the_tool_runs_on_the_cpu(capsys):
    assert ex.main(["--device", "cpu", "--nblocks", "2", "--block", "16"]) == 0
    recs = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [r.get("op") for r in recs[:3]] == list(ex.OPS)
    assert all(r["device"] == "cpu" and r["shape"] == [2, 16, 16]
               and "ms" not in r for r in recs[:3])
    assert recs[3] == {"what": "exp2 vs exp speedup", "ratio": None}
