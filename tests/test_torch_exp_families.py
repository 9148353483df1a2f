"""The port's exp_families tool against the JAX package's train step.

Each of the 4 families (``FAMILIES``) at a cut of its dict: 2 layers,
width 64, T 64, V 256, and, so the kernels' head widths hold, 4 heads (hd
16; GQA families keep 2 KV heads) with the mistral window cut to 16 so it
binds at T 64. The same numpy weights (JAX ``gpt.init`` through
``models/convert.py``) and the same tokens go through the JAX package's
``make_train_step`` (flash in Pallas interpret mode on the CPU) and the
port's ``run(..., dtype="float32", device="cpu")`` (the kernels' plain
versions): 3 losses within 1e-5 relative and the last grad norm within
1e-4, the trainer parity tests' tolerances. The CLI prints one line per
family and exits 1 when one fails.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mingpt_distributed_tpu.config import GPTConfig as JConfig
from mingpt_distributed_tpu.config import OptimizerConfig as JOptConfig
from mingpt_distributed_tpu.models import gpt as j_gpt
from mingpt_distributed_tpu.training import optimizer as j_opt
from mingpt_distributed_tpu.training import trainer as j_trainer
from mingpt_distributed_tpu_torch.tools import exp_families
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

CUT = dict(n_layer=2, n_head=4, n_embd=64, block_size=64, vocab_size=256)


def cut(kw):
    out = dict(kw, **CUT)
    if "attention_window" in out:
        out["attention_window"] = 16
    return out


def jax_run(kw, tree, tokens):
    """The JAX tool's loop at float32 on ``tree`` and ``tokens``."""
    cfg = JConfig.make(embd_pdrop=0.0, resid_pdrop=0.0, attn_pdrop=0.0,
                       dtype="float32", attention="flash", unroll_layers=True, **kw)
    opt = j_opt.make_optimizer(JOptConfig(), grad_norm_clip=1.0)
    step = jax.jit(j_trainer.make_train_step(cfg, opt))
    params = jax.tree.map(jnp.asarray, tree)
    state = {"params": params, "opt_state": opt.init(params),
             "step": jnp.asarray(0, dtype=jnp.int32)}
    toks = jnp.asarray(tokens)
    losses = []
    for _ in range(exp_families.STEPS):
        state, m = step(state, (toks, toks), jax.random.key(2))
        losses.append(float(m["loss"]))
    return losses, float(m["grad_norm"])


def test_families_are_the_jax_tools():
    """FAMILIES verbatim, with the JAX tool's batch and step count."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "tools", "exp_families.py")
    spec = importlib.util.spec_from_file_location("jax_exp_families", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert exp_families.FAMILIES == mod.FAMILIES
    assert (exp_families.BATCH, exp_families.STEPS) == (4, 3)


@pytest.mark.parametrize("name", list(exp_families.FAMILIES))
def test_family_matches_the_jax_train_step(name):
    kw = cut(exp_families.FAMILIES[name])
    jcfg = JConfig.make(dtype="float32", **kw)
    tree = jax.device_get(j_gpt.init(jax.random.key(0), jcfg))
    tokens = np.random.default_rng(1).integers(
        0, kw["vocab_size"], (exp_families.BATCH, kw["block_size"])).astype(np.int32)
    want_losses, want_norm = jax_run(kw, tree, tokens)
    got = exp_families.run(name, kw, dtype="float32", device="cpu", params=tree,
                           tokens=tokens)
    assert set(got) == {"family", "losses", "grad_norm"} and got["family"] == name
    np.testing.assert_allclose(got["losses"], want_losses, rtol=1e-5)
    np.testing.assert_allclose(got["grad_norm"], want_norm, rtol=1e-4)
    assert got["losses"][-1] < got["losses"][0]


def _cli(monkeypatch, capsys, families):
    monkeypatch.setattr(exp_families, "FAMILIES", families)
    rc = exp_families.main(["--device", "cpu"])
    return rc, [json.loads(line) for line in capsys.readouterr().out.splitlines()]


def test_cli_prints_one_line_per_family_and_exits_0(monkeypatch, capsys):
    rc, lines = _cli(monkeypatch, capsys,
                     {n: cut(kw) for n, kw in exp_families.FAMILIES.items()})
    assert rc == 0
    assert [r["family"] for r in lines] == list(exp_families.FAMILIES)
    for r in lines:
        assert set(r) == {"family", "losses", "grad_norm"}
        assert len(r["losses"]) == 3 and r["losses"][-1] < r["losses"][0]
        assert r["losses"] == [round(x, 4) for x in r["losses"]]


def test_cli_exits_1_when_a_family_fails(monkeypatch, capsys):
    families = {n: cut(kw) for n, kw in exp_families.FAMILIES.items()}
    families["gemma"] = dict(families["gemma"], n_head=3)  # 64 does not split into 3 heads
    rc, lines = _cli(monkeypatch, capsys, families)
    assert rc == 1
    assert [r["family"] for r in lines] == list(exp_families.FAMILIES)
    bad = lines[2]
    assert set(bad) == {"family", "error"} and "n_head" in bad["error"]
    assert all("losses" in r for i, r in enumerate(lines) if i != 2)


@pytest.mark.parametrize("losses, error", [
    ([5.0, float("nan"), 4.0], FloatingPointError),
    ([5.0, 4.9, float("inf")], FloatingPointError),
    ([5.0, 5.1, 5.0], RuntimeError),
])
def test_check_losses_refuses_non_finite_or_flat_losses(losses, error):
    with pytest.raises(error, match="fam"):
        exp_families.check_losses("fam", losses)
    exp_families.check_losses("fam", [5.0, 4.9, 4.8])
