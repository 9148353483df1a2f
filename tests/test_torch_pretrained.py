"""The port's HuggingFace loaders against transformers and the JAX package.

tests/test_pretrained.py's cases on the port: small random GPT-2 and Llama
models built locally by ``transformers`` (no download), loaded through
``models/pretrained.py`` and ``models/convert.py``; the port's logits
within 1e-5 of transformers' (fp32, CPU), its loss and greedy generation
equal, and the parameter trees equal to the JAX package's loaders' leaf by
leaf. ``GPT.from_pretrained`` goes through transformers' loader, which
the tests stub (no test fetches weights): it builds the model, and a
loader failure raises RuntimeError.
"""

import jax
import numpy as np
import pytest
import torch
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

transformers = pytest.importorskip("transformers")

from mingpt_distributed_tpu.config import GPTConfig as JConfig  # noqa: E402
from mingpt_distributed_tpu.models import pretrained as j_pre  # noqa: E402
from mingpt_distributed_tpu_torch.config import ConfigError, GPTConfig  # noqa: E402
from mingpt_distributed_tpu_torch.models import convert, gpt  # noqa: E402
from mingpt_distributed_tpu_torch.models import generate as gen  # noqa: E402
from mingpt_distributed_tpu_torch.models import pretrained as t_pre  # noqa: E402
from mingpt_distributed_tpu_torch.models.api import GPT  # noqa: E402

LOGIT_TOL = 1e-5
GPT2_KW = dict(n_layer=3, n_head=3, n_embd=48, vocab_size=97, block_size=32,
               embd_pdrop=0.0, resid_pdrop=0.0, attn_pdrop=0.0, dtype="float32",
               tie_weights=True)
LLAMA_KW = dict(n_layer=2, n_head=4, n_embd=48, vocab_size=97, block_size=64,
                embd_pdrop=0.0, resid_pdrop=0.0, attn_pdrop=0.0, dtype="float32",
                rope=True, swiglu=True, rmsnorm=True, n_kv_head=2,
                ffn_mult=128 / 48, tie_weights=False, norm_eps=1e-5,
                rope_theta=500000.0)


@pytest.fixture(scope="module")
def hf_gpt2():
    hf_cfg = transformers.GPT2Config(
        vocab_size=97, n_positions=32, n_embd=48, n_layer=3, n_head=3,
        resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0)
    torch.manual_seed(0)
    return transformers.GPT2LMHeadModel(hf_cfg).eval()


@pytest.fixture(scope="module")
def hf_llama():
    cfg = transformers.LlamaConfig(
        vocab_size=97, hidden_size=48, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=64, rope_theta=500000.0, rms_norm_eps=1e-5,
        attention_dropout=0.0, tie_word_embeddings=False)
    torch.manual_seed(0)
    return transformers.LlamaForCausalLM(cfg).eval()


def _port(loader, model, kw):
    cfg = GPTConfig.make(**kw)
    return cfg, convert.params_from_numpy(loader(model.state_dict(), cfg), cfg, "cpu")


def _tokens(seed, n=32):
    return torch.tensor(np.random.default_rng(seed).integers(0, 97, (2, n)))


def _assert_trees_equal(got, want, where=""):
    assert set(got) == set(want), where
    for k in want:
        if isinstance(want[k], dict):
            _assert_trees_equal(got[k], want[k], f"{where}/{k}")
        else:
            assert got[k].dtype == np.float32, f"{where}/{k}"
            np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=f"{where}/{k}")


@pytest.mark.parametrize("seed", [1, 2])
def test_gpt2_logits_match_transformers(hf_gpt2, seed):
    cfg, params = _port(t_pre.load_hf_state_dict, hf_gpt2, GPT2_KW)
    tokens = _tokens(seed)
    with torch.no_grad():
        want = hf_gpt2(tokens).logits
        got, _ = gpt.forward(params, tokens, cfg)
    assert (got - want).abs().max().item() <= LOGIT_TOL


def test_gpt2_loss_matches_transformers(hf_gpt2):
    cfg, params = _port(t_pre.load_hf_state_dict, hf_gpt2, GPT2_KW)
    t = _tokens(2)
    with torch.no_grad():
        want = hf_gpt2(t, labels=t).loss  # CE over shifted positions
        _, loss = gpt.forward(params, t[:, :-1], cfg, targets=t[:, 1:])
    assert float(loss) == pytest.approx(float(want), abs=LOGIT_TOL)


def test_gpt2_greedy_generation_matches_transformers(hf_gpt2):
    cfg, params = _port(t_pre.load_hf_state_dict, hf_gpt2, GPT2_KW)
    prompt = torch.tensor([[5, 17, 3]])
    with torch.no_grad():
        want = hf_gpt2.generate(prompt, max_new_tokens=8, do_sample=False,
                                pad_token_id=0)
    got = gen.generate(params, cfg, prompt, 8, device="cpu")
    assert torch.equal(got, want)


@pytest.mark.parametrize("tie", [True, False])
def test_gpt2_tree_equals_the_jax_loader(hf_gpt2, tie):
    kw = dict(GPT2_KW, tie_weights=tie)
    sd = hf_gpt2.state_dict()
    got = t_pre.load_hf_state_dict(sd, GPTConfig.make(**kw))
    want = j_pre.load_hf_state_dict(sd, JConfig.make(**kw))
    _assert_trees_equal(got, jax.tree.map(np.asarray, want))
    if not tie:
        assert got["head"].shape == (48, 97)
        np.testing.assert_array_equal(got["head"], got["wte"].T)


def test_unknown_pretrained_rejected():
    with pytest.raises(ConfigError, match="from_pretrained supports"):
        t_pre.config_for_pretrained("gpt5")
    cfg = t_pre.config_for_pretrained("gpt2", block_size=128)
    assert (cfg.n_layer, cfg.n_embd, cfg.tie_weights, cfg.block_size) == (12, 768, True, 128)


def test_missing_key_and_position_budget_reported(hf_gpt2):
    sd = dict(hf_gpt2.state_dict())
    sd.pop("transformer.h.0.ln_1.weight")
    with pytest.raises(KeyError, match="ln_1.weight"):
        t_pre.load_hf_state_dict(sd, GPTConfig.make(**GPT2_KW))
    with pytest.raises(ValueError, match="positions"):
        t_pre.load_hf_state_dict(hf_gpt2.state_dict(),
                                 GPTConfig.make(**dict(GPT2_KW, block_size=64)))


def test_gpt_facade_over_loaded_weights(hf_gpt2):
    cfg, params = _port(t_pre.load_hf_state_dict, hf_gpt2, GPT2_KW)
    m = GPT(cfg, params, device="cpu")
    logits, loss = m(torch.zeros(1, 8, dtype=torch.long), targets=torch.zeros(1, 8, dtype=torch.long))
    assert logits.shape == (1, 8, 97) and loss is not None
    assert m.generate(torch.tensor([[1, 2, 3]]), 5).shape == (1, 8)


def test_llama_logits_match_transformers(hf_llama):
    cfg, params = _port(t_pre.load_hf_llama_state_dict, hf_llama, LLAMA_KW)
    tokens = _tokens(1)
    with torch.no_grad():
        want = hf_llama(tokens).logits
        got, _ = gpt.forward(params, tokens, cfg)
    assert (got - want).abs().max().item() <= LOGIT_TOL


def test_llama_greedy_generation_matches_transformers(hf_llama):
    cfg, params = _port(t_pre.load_hf_llama_state_dict, hf_llama, LLAMA_KW)
    prompt = torch.tensor([[5, 17, 3, 9]])
    with torch.no_grad():
        want = hf_llama.generate(prompt, max_new_tokens=8, do_sample=False,
                                 pad_token_id=0)
    assert torch.equal(gen.generate(params, cfg, prompt, 8, device="cpu"), want)


def test_llama_tree_equals_the_jax_loader(hf_llama):
    sd = hf_llama.state_dict()
    got = t_pre.load_hf_llama_state_dict(sd, GPTConfig.make(**LLAMA_KW))
    want = j_pre.load_hf_llama_state_dict(sd, JConfig.make(**LLAMA_KW))
    _assert_trees_equal(got, jax.tree.map(np.asarray, want))
    with pytest.raises(ValueError, match="rope"):
        t_pre.load_hf_llama_state_dict(sd, GPTConfig.make(**GPT2_KW))


def test_from_pretrained_without_the_weights_raises_runtime_error(monkeypatch):
    """transformers failing to load the weights (no network, no cache: its
    loader is stubbed to fail as it would, so nothing is fetched) gives
    RuntimeError naming the fix."""
    def unreachable(cls, name):
        raise OSError(f"we could not connect to load the files of {name}")

    monkeypatch.setattr(transformers.GPT2LMHeadModel, "from_pretrained",
                        classmethod(unreachable))
    with pytest.raises(RuntimeError, match="HF_HOME"):
        t_pre.from_pretrained("gpt2")
    with pytest.raises(RuntimeError, match="HF_HOME"):
        GPT.from_pretrained("gpt2", device="cpu")


def test_gpt_from_pretrained_builds_the_model(monkeypatch, hf_gpt2):
    """GPT.from_pretrained wraps the loader: with transformers' loading
    stubbed by the local random model, the facade's logits are
    transformers'."""
    monkeypatch.setattr(transformers.GPT2LMHeadModel, "from_pretrained",
                        classmethod(lambda cls, name: hf_gpt2))
    monkeypatch.setattr(t_pre, "config_for_pretrained",
                        lambda model_type, **kw: GPTConfig.make(**GPT2_KW))
    m = GPT.from_pretrained("gpt2", device="cpu")
    tokens = _tokens(3)
    with torch.no_grad():
        want = hf_gpt2(tokens).logits
    got, _ = m(tokens)
    assert (got - want).abs().max().item() <= LOGIT_TOL
