"""The port's per-head-grid prototype (K5,
``mingpt_distributed_tpu_torch/tools/proto_nh_kernel.py``) against the JAX
tool ``tools/proto_nh_kernel.py``, loaded from its path and run in Pallas
interpret mode on the CPU.

* ``nh_fwd_plain`` against the JAX ``flash_fwd_btd`` (B=2, T=128, H=4,
  hd=32, block 64: two q tiles and two k tiles; plain, and window 40 with
  softcap 5.0): out within 1e-5, lse (B, H, T, 1) within 1e-5.
* ``nh_bwd_plain`` against the JAX ``flash_bwd_btd`` on the same q, k, v,
  dO, lse and delta, within 2e-4 (the JAX flash tests' gradient tolerance).
* The wrappers take the plain versions on the CPU, launch nothing, and
  raise for KV != H; the tool runs end to end with ``--device cpu``.
"""

import importlib.util
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mingpt_distributed_tpu_torch.tools import proto_nh_kernel as nh
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, T, H, HD, BLOCK = 2, 128, 4, 32, 64
SCALE = HD ** -0.5


@pytest.fixture(scope="module")
def jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_proto_nh_kernel", os.path.join(REPO, "tools", "proto_nh_kernel.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _inputs(seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, T, H * HD)).astype(np.float32)
            for _ in range(4)]


@pytest.mark.parametrize("window,softcap", [(None, None), (40, 5.0)],
                         ids=["plain", "window40_softcap5"])
def test_nh_fwd_plain_matches_the_jax_prototype(jax_tool, window, softcap):
    q, k, v, _ = _inputs(51)
    j_out, j_lse = jax_tool.flash_fwd_btd(
        *(jnp.asarray(a) for a in (q, k, v)), H, SCALE, BLOCK, window=window,
        softcap=softcap)
    out, lse = nh.nh_fwd_plain(*(torch.from_numpy(a) for a in (q, k, v)), H,
                               SCALE, window, softcap)
    assert lse.shape == (B, H, T, 1) == j_lse.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(j_lse), rtol=1e-5, atol=1e-5)


def test_nh_bwd_plain_matches_the_jax_prototype(jax_tool):
    q, k, v, do = _inputs(52)
    jq, jk, jv, jdo = (jnp.asarray(a) for a in (q, k, v, do))
    out, lse = jax_tool.flash_fwd_btd(jq, jk, jv, H, SCALE, BLOCK)
    delta = (np.asarray(out).reshape(B, T, H, HD) * do.reshape(B, T, H, HD)).sum(-1)
    delta = np.ascontiguousarray(delta.transpose(0, 2, 1)[..., None])
    want = jax_tool.flash_bwd_btd(jq, jk, jv, jdo, lse, jnp.asarray(delta), H,
                                  SCALE, BLOCK)
    got = nh.nh_bwd_plain(*(torch.from_numpy(a) for a in (q, k, v, do)),
                          torch.from_numpy(np.array(lse)), torch.from_numpy(delta),
                          H, SCALE)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-4, atol=2e-4)


def test_nh_wrappers_on_the_cpu_are_the_plain_versions():
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(53))
    n0 = (nh.nh_fwd.launches, nh.nh_bwd_dq.launches, nh.nh_bwd_dkv.launches)
    out, lse = nh.nh_fwd(q, k, v, H, SCALE, 30, 4.0)
    want = nh.nh_fwd_plain(q, k, v, H, SCALE, 30, 4.0)
    assert torch.equal(out, want[0]) and torch.equal(lse, want[1])
    delta = torch.rand((B, H, T, 1))
    got = nh.nh_bwd(q, k, v, do, lse, delta, H, SCALE)
    want = nh.nh_bwd_plain(q, k, v, do, lse, delta, H, SCALE)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert (nh.nh_fwd.launches, nh.nh_bwd_dq.launches, nh.nh_bwd_dkv.launches) == n0


def _narrow_kv():
    q = torch.zeros((1, 8, 4 * 16))
    return q, torch.zeros((1, 8, 2 * 16))


# name: (call, exception, message pattern)
NH_REFUSALS = {
    "fwd_kv_not_h": (lambda q, kv: nh.nh_fwd(q, kv, kv, 4, 0.25), ValueError,
                     "KV == H"),
    "bwd_kv_not_h": (lambda q, kv: nh.nh_bwd(q, kv, kv, q, torch.zeros(1, 4, 8, 1),
                                             torch.zeros(1, 4, 8, 1), 4, 0.25),
                     ValueError, "KV == H"),
    "bwd_lse_b_h_t": (lambda q, kv: nh.nh_bwd(q, q, q, q, torch.zeros(1, 4, 8),
                                              torch.zeros(1, 4, 8, 1), 4, 0.25),
                      ValueError, "lse must be float32"),
    "fwd_heads_do_not_divide": (lambda q, kv: nh.nh_fwd(q, q, q, 5, 0.25), ValueError,
                                "H = 5"),
    "fwd_meta_device": (lambda q, kv: nh.nh_fwd(*(torch.empty((1, 8, 64), device="meta"),) * 3,
                                                4, 0.25),
                        ValueError, "nh_fwd runs on cuda or cpu"),
    "bwd_meta_device": (lambda q, kv: nh.nh_bwd(
        *(torch.empty((1, 8, 64), device="meta"),) * 4,
        *(torch.empty((1, 4, 8, 1), device="meta"),) * 2, 4, 0.25),
        ValueError, "nh_bwd runs on cuda or cpu"),
}


@pytest.mark.parametrize("case", sorted(NH_REFUSALS))
def test_nh_wrappers_refuse_bad_arguments(case):
    call, exc, pattern = NH_REFUSALS[case]
    with pytest.raises(exc, match=pattern):
        call(*_narrow_kv())


def test_the_tool_runs_on_the_cpu(capsys):
    assert nh.cli(["--device", "cpu", "--batch", "1", "--seq", "48", "--heads", "2",
                   "--head-dim", "16"]) == 0
    recs = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [r["what"] for r in recs] == ["parity max_err", "bwd parity dq",
                                         "bwd parity dk", "bwd parity dv"]
    assert all(r.get("err", r.get("rel_err")) < nh.PARITY_TOL for r in recs)
    assert all(r["device"] == "cpu" for r in recs)
