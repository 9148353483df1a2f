"""The PyTorch port's generation against the JAX package's.

Greedy decoding must be token-identical to ``generate.generate`` in both
modes (KV-cached while the window holds the sequence, the sliding window
past it), the top-k/top-p filtering must allow exactly the tokens the JAX
sampler can draw, and sampling must be reproducible under a fixed
``torch.Generator`` (the two frameworks draw different random numbers, so
sampled tokens are not compared across them). Float32, small configs.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mingpt_distributed_tpu.config import GPTConfig as JConfig
from mingpt_distributed_tpu.models import generate as j_gen
from mingpt_distributed_tpu.models import gpt as j_gpt
from mingpt_distributed_tpu_torch import sample as t_sample
from mingpt_distributed_tpu_torch.config import DataConfig
from mingpt_distributed_tpu_torch.config import GPTConfig as TConfig
from mingpt_distributed_tpu_torch.data.char_dataset import CharDataset
from mingpt_distributed_tpu_torch.models import convert
from mingpt_distributed_tpu_torch.models import generate as t_gen
from mingpt_distributed_tpu_torch.ops import flash_attention

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS = os.path.join(REPO, "data", "input.txt")
YAML = os.path.join(REPO, "gpt2_config.yaml")

SMALL = dict(n_layer=2, n_head=4, n_embd=64, vocab_size=96, block_size=32,
             dtype="float32", embd_pdrop=0.0, resid_pdrop=0.0, attn_pdrop=0.0)
CONFIGS = {
    "gpt2": dict(SMALL),
    "llama": dict(SMALL, rope=True, swiglu=True, rmsnorm=True, n_kv_head=2,
                  tie_weights=True),
    "window_softcap": dict(SMALL, attention_window=8, attn_logit_softcap=20.0,
                           final_logit_softcap=15.0),
}


def _setup(name, attention="einsum", seed=0):
    jcfg = JConfig.make(**dict(CONFIGS[name], attention="einsum"))
    tcfg = TConfig.make(**dict(CONFIGS[name], attention=attention))
    tree = jax.device_get(j_gpt.init(jax.random.key(seed), jcfg))
    rng = np.random.default_rng(seed)
    # larger weights than init: sharper logits, so greedy paths are not ties
    tree = jax.tree.map(
        lambda a: (a + 0.1 * rng.standard_normal(a.shape)).astype(np.float32),
        tree)
    return jcfg, tcfg, tree, convert.params_from_numpy(tree, tcfg, "cpu")


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_cached_greedy_tokens_match_jax(name):
    jcfg, tcfg, tree, params = _setup(name)
    prompt = np.random.default_rng(1).integers(0, 96, (2, 5)).astype(np.int32)
    want = j_gen.generate(tree, jcfg, prompt, 12)
    got = t_gen.generate(params, tcfg, prompt, 12, device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("attention", ["einsum", "flash"])
def test_sliding_greedy_tokens_match_jax(attention):
    jcfg, tcfg, tree, params = _setup("gpt2", attention)
    prompt = np.random.default_rng(2).integers(0, 96, (2, 28)).astype(np.int32)
    want = j_gen.generate(tree, jcfg, prompt, 10)  # 38 > block_size 32
    n0 = flash_attention.flash_fwd.launches
    got = t_gen.generate(params, tcfg, prompt, 10, device="cpu")
    assert flash_attention.flash_fwd.launches == n0  # CPU: plain version
    assert got.shape == (2, 38)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sliding_window_mode_reforwards_the_window(monkeypatch):
    _, tcfg, _, params = _setup("gpt2", "flash")
    calls = []
    real = t_gen.gpt.forward

    def spy(params, tokens, cfg, **kw):
        calls.append(tuple(tokens.shape))
        return real(params, tokens, cfg, **kw)

    monkeypatch.setattr(t_gen.gpt, "forward", spy)
    t_gen.generate(params, tcfg, np.zeros((3, 30), np.int64), 4, device="cpu")
    assert calls == [(3, 32)] * 4
    calls.clear()
    t_gen.generate(params, tcfg, np.zeros((3, 20), np.int64), 4, device="cpu")
    assert calls == []  # fits the window: KV-cached, no full forward


LOGITS = np.array([
    [2.0, 1.9, 1.9, 1.8, 1.7, 1.6, -5.0, -5.0, -6.0, -7.0, -8.0, -9.0],
    [-9.0, 0.5, 0.4, 3.0, 2.9, 2.95, 2.9, -1.0, -2.0, 0.0, -3.0, -4.0],
], dtype=np.float32)

FILTERS = {  # (temperature, top_k, top_p)
    "top_k_keeps_ties": (1.0, 2, None),
    "top_k4_hot": (2.0, 4, None),
    "top_p": (1.0, None, 0.5),
    "top_p_tiny_is_greedy": (1.0, None, 1e-9),
    "top_k_and_top_p": (0.7, 3, 0.8),
}


@pytest.mark.parametrize("case", sorted(FILTERS))
def test_select_next_filters_like_jax(case):
    temperature, top_k, top_p = FILTERS[case]
    keys = jax.random.split(jax.random.key(0), 2000)
    drawn = jax.vmap(lambda key: j_gen._select_next(
        jnp.asarray(LOGITS), key, temperature, True, top_k, top_p))(keys)
    drawn = np.asarray(drawn)
    filtered = t_gen._filter_logits(torch.from_numpy(LOGITS), temperature,
                                    top_k, top_p)
    for row in range(LOGITS.shape[0]):
        allowed = set(np.flatnonzero(np.isfinite(filtered[row].numpy())))
        assert set(drawn[:, row]) == allowed
        np.testing.assert_allclose(
            filtered[row].numpy()[sorted(allowed)],
            LOGITS[row, sorted(allowed)] / temperature, rtol=1e-6)
    greedy_j = j_gen._select_next(jnp.asarray(LOGITS), keys[0], temperature,
                                  False, top_k, top_p)
    greedy_t = t_gen._select_next(torch.from_numpy(LOGITS), None, temperature,
                                  False, top_k, top_p)
    np.testing.assert_array_equal(greedy_t.numpy(), np.asarray(greedy_j))


@pytest.mark.parametrize("prompt_len", [5, 28])  # cached, sliding
def test_sampling_reproducible_under_a_generator(prompt_len):
    _, tcfg, _, params = _setup("gpt2", "flash")
    prompt = np.zeros((2, prompt_len), np.int64)

    def run(seed):
        return t_gen.generate(params, tcfg, prompt, 8, do_sample=True,
                              temperature=1.5, top_k=20, device="cpu",
                              generator=torch.Generator().manual_seed(seed))

    a, b, c = run(3), run(3), run(4)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)


def test_generate_refuses_params_on_another_device():
    _, tcfg, _, params = _setup("gpt2")
    params = dict(params, wte=params["wte"].to("meta"))
    with pytest.raises(ValueError, match="params live on"):
        t_gen.generate(params, tcfg, np.zeros((1, 3), np.int64), 2,
                       device="cpu")


def test_sample_cli_npz_matches_jax_greedy(tmp_path, capsys):
    """The sample entry point with --params: a flat npz of a JAX pytree,
    the char vocabulary of data/input.txt, greedy decoding past the
    window, against JAX generate on the same weights."""
    data = DataConfig.make(path=CORPUS, block_size=32, truncate=0.05)
    vocab = CharDataset(data)
    dims = dict(n_layer=2, n_head=4, n_embd=64, dtype="float32",
                attention="einsum", embd_pdrop=0.0, resid_pdrop=0.0,
                attn_pdrop=0.0)
    jcfg = JConfig.make(**dims, vocab_size=vocab.vocab_size, block_size=32)
    tree = jax.device_get(j_gpt.init(jax.random.key(5), jcfg))
    tree = jax.tree.map(lambda a: a + np.float32(0.1) * np.sign(a), tree)
    np.savez(tmp_path / "params.npz", **convert.flatten(tree))
    prompt = "the "
    want = j_gen.generate(tree, jcfg, vocab.encode(prompt)[None], 40)
    argv = ["--params", str(tmp_path / "params.npz"), "--device", "cpu",
            "--greedy", "--prompt", prompt, "--max-new-tokens", "40",
            "--config", YAML, "--data", CORPUS,
            "gpt_config.n_layer=2", "gpt_config.n_head=4",
            "gpt_config.n_embd=64", "gpt_config.dtype=float32",
            "data_config.block_size=32"]
    assert t_sample.main(argv) == 0
    assert capsys.readouterr().out == vocab.decode(np.asarray(want)[0]) + "\n"


def test_sample_cli_random_init_runs(capsys):
    argv = ["--random-init", "--seed", "1", "--device", "cpu",
            "--prompt", "the", "--max-new-tokens", "6",
            "--config", YAML, "--data", CORPUS, "gpt_config.n_layer=1",
            "gpt_config.n_head=2", "gpt_config.n_embd=32",
            "gpt_config.dtype=float32", "data_config.block_size=16"]
    assert t_sample.main(argv) == 0
    out = capsys.readouterr().out
    assert out.startswith("the") and len(out) == len("the") + 6 + 1
