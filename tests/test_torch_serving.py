"""The port's continuous-batching server against the JAX package's.

Port against JAX: the same requests, on parameters converted from the same
JAX pytree (``models/convert.py``), go through JAX's ``InferenceServer`` and
the port's with buckets, chunked prefill and the prefix cache on: greedy
tokens must be identical per request and equal to both packages' solo
``generate``; the first prefill's logits and a batched decode step's logits
must agree within 1e-5 (fp32). Then the port-side counterparts of
tests/test_serving.py's non-speculative tests (slot pool, queueing,
mid-decode admission, stops, sampling isolation, crop and clamp, metrics,
bounded queue, deadlines, callbacks, bucket ladder, chunked prefill, prefix
reuse, window-edge shift-back, the LRU store, prefill cost, llama mode,
validation, strict window). The JAX tests of the recompile watchdog
(ROADMAP.md Queue 1 item 16) become tests of ``compile_counts()``'s shape
bounds. CPU, tiny configs (JAX's ``cfg_params``: 2 layers, 2 heads, 32
wide, V = 50, block 32, fp32).
"""

import dataclasses
import importlib.util
import io
import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from mingpt_distributed_tpu.config import GPTConfig as JConfig
from mingpt_distributed_tpu.models import generate as j_gen
from mingpt_distributed_tpu.models import gpt as j_gpt
from mingpt_distributed_tpu.serving import InferenceServer as JServer
from mingpt_distributed_tpu.serving import Request as JRequest
from mingpt_distributed_tpu_torch import serve as t_serve
from mingpt_distributed_tpu_torch import train as t_train
from mingpt_distributed_tpu_torch.config import GPTConfig, load_config
from mingpt_distributed_tpu_torch.data.char_dataset import CharDataset
from mingpt_distributed_tpu_torch.models import convert
from mingpt_distributed_tpu_torch.models import generate as gen
from mingpt_distributed_tpu_torch.serving import (
    DecodeEngine,
    InferenceServer,
    PrefixKVStore,
    QueueFullError,
    Request,
    SlotKVPool,
)
from mingpt_distributed_tpu_torch.serving import engine as engine_mod
from mingpt_distributed_tpu_torch.telemetry import SpanTracer
from mingpt_distributed_tpu_torch.training import checkpoint as ckpt

TINY = dict(n_layer=2, n_head=2, n_embd=32, vocab_size=50, block_size=32,
            embd_pdrop=0.0, resid_pdrop=0.0, attn_pdrop=0.0, dtype="float32")
LLAMA = dict(TINY, rope=True, swiglu=True, rmsnorm=True, n_kv_head=1,
             tie_weights=True)


def _both(kw):
    """(JAX cfg, JAX params, port cfg, port params on the CPU)."""
    jcfg, tcfg = JConfig.make(**kw), GPTConfig.make(**kw)
    tree = j_gpt.init(jax.random.key(0), jcfg)
    return jcfg, tree, tcfg, convert.params_from_numpy(
        jax.tree.map(np.array, tree), tcfg, "cpu")


@pytest.fixture(scope="module")
def cfg_params():
    _, _, cfg, params = _both(TINY)
    return cfg, params


def server(params, cfg, **kw):
    return InferenceServer(params, cfg, device="cpu", **kw)


def solo_greedy(params, cfg, prompt, n):
    """The new tokens the port's generate() produces alone on this prompt."""
    out = gen.generate(params, cfg, [prompt], n, device="cpu")
    return out[0, len(prompt):].tolist()


PROMPTS = [[1, 2, 3, 4, 5], [7, 8, 9], [10, 11, 12, 13], [40, 41], [20, 21, 22]]
MIXED_PROMPTS = [
    list(range(1, 4)),                     # 3 tokens  -> bucket 4
    list(range(5, 12)),                    # 7 tokens  -> bucket 8
    list(range(2, 15)),                    # 13 tokens -> bucket 16
    list(range(3, 25)),                    # 22 tokens -> bucket 32
    [9, 8, 7, 6, 5],                       # 5 tokens  -> bucket 8
    list(range(10, 40)),                   # 30 tokens -> bucket 32
]


# ---------------------------------------------------------------------------
# port against JAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [TINY, LLAMA], ids=["gpt2", "llama"])
def test_server_tokens_match_the_jax_server_and_solo_generate(kw):
    """Staggered arrivals through both servers with buckets, chunked
    prefill and the prefix cache: identical greedy tokens per request,
    equal to both packages' solo generate."""
    jcfg, tree, tcfg, params = _both(kw)
    shared = list(range(3, 20))
    prompts = [shared + [25, 26], PROMPTS[0], shared + [27], MIXED_PROMPTS[5],
               PROMPTS[3], MIXED_PROMPTS[2]]
    news = [6, 8, 5, 2, 7, 9]
    opts = dict(n_slots=2, prefill_buckets=(4, 8, 16, 32), prefill_chunk=8,
                prefix_cache_mb=8.0)
    js = JServer(tree, jcfg, **opts)
    ts = server(params, tcfg, **opts)
    jh, th = [], []
    for p, n in zip(prompts, news):
        jh.append(js.submit(JRequest(prompt=p, max_new_tokens=n)))
        th.append(ts.submit(Request(prompt=p, max_new_tokens=n)))
        js.step()
        ts.step()
    js.run_until_drained(max_steps=200)
    ts.run_until_drained(max_steps=200)
    for p, n, a, b in zip(prompts, news, jh, th):
        want = np.asarray(j_gen.generate(tree, jcfg, jnp.asarray([p]), n))[0, len(p):]
        assert b.tokens == a.tokens == want.tolist() == solo_greedy(params, tcfg, p, n)
    assert ts.metrics.prefix_hits == js.metrics.prefix_hits >= 1
    assert ts.metrics.prefill_chunks == js.metrics.prefill_chunks
    assert ts.metrics.bucket_histogram == js.metrics.bucket_histogram
    assert ts.compile_counts()["decode"] == 1


@pytest.mark.parametrize("kw", [TINY, LLAMA], ids=["gpt2", "llama"])
def test_first_prefill_logits_match_jax(kw, monkeypatch):
    """The engine's first prefill logits (a 5-token prompt padded to bucket
    8, read at position 4) against the JAX engine's computation
    (_forward_cached_hidden + _head_logits on the padded chunk)."""
    jcfg, tree, tcfg, params = _both(kw)
    seen = []
    real = engine_mod._select_next_slots
    monkeypatch.setattr(engine_mod, "_select_next_slots",
                        lambda logits, *a: seen.append(logits.clone()) or real(logits, *a))
    eng = DecodeEngine(params, tcfg, n_slots=2, prefill_buckets=(8, 32), device="cpu")
    eng.prefill_chunk_call(1, PROMPTS[0], 0, 1.0, None, None, False, None)
    chunk = jnp.asarray(PROMPTS[0] + [0, 0, 0], jnp.int32)[None]
    x, _ = j_gen._forward_cached_hidden(tree, chunk, j_gen.init_cache(jcfg, 1), 0, jcfg)
    want = np.asarray(j_gen._head_logits(tree, x[:, 4:5], jcfg))[:, 0]
    np.testing.assert_allclose(seen[0].numpy(), want, rtol=0, atol=1e-5)


def _jax_decode_logits(tree, cfg, cache, tokens, positions):
    """The JAX engine's decode step (serving/engine.py _decode_impl: vmap of
    the solo cached forward over the slot axis) up to the logits."""
    def one_slot(tok, cache_slot, pos):
        cache_b = jax.tree.map(lambda a: a[:, None], cache_slot)
        logits, lane = j_gen._forward_cached(tree, tok[None, None], cache_b, pos, cfg)
        return logits[0], jax.tree.map(lambda a: a[:, 0], lane)

    return jax.vmap(one_slot, in_axes=(0, 1, 0), out_axes=(0, 1))(
        tokens, cache, positions)


@pytest.mark.parametrize("kw", [TINY, LLAMA], ids=["gpt2", "llama"])
def test_batched_decode_step_logits_match_jax(kw):
    """Three slots at positions 5, 17 and 30 over the same random cache: the
    port's per-row cached forward against the JAX engine's vmapped decode,
    logits within 1e-5 and the written K/V rows equal."""
    jcfg, tree, tcfg, params = _both(kw)
    rng = np.random.default_rng(3)
    shape = (tcfg.n_layer, 3, tcfg.block_size, tcfg.kv_heads, tcfg.head_dim)
    k0, v0 = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    tokens, positions = np.array([4, 9, 33]), np.array([5, 17, 30])
    want, jcache = _jax_decode_logits(
        tree, jcfg, {"k": jnp.asarray(k0), "v": jnp.asarray(v0)},
        jnp.asarray(tokens, jnp.int32), jnp.asarray(positions, jnp.int32))
    cache = {"k": torch.from_numpy(k0.copy()), "v": torch.from_numpy(v0.copy())}
    got = gen._forward_cached(params, torch.from_numpy(tokens)[:, None], cache,
                              torch.from_numpy(positions), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    for name in ("k", "v"):
        np.testing.assert_allclose(cache[name].numpy(), np.asarray(jcache[name]),
                                   rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# slot pool
# ---------------------------------------------------------------------------


def test_pool_allocate_free_exhaustion(cfg_params):
    cfg, _ = cfg_params
    pool = SlotKVPool(cfg, 3, device="cpu")
    assert pool.cache["k"].shape == (
        cfg.n_layer, 3, cfg.block_size, cfg.kv_heads, cfg.head_dim)
    assert pool.nbytes == 2 * 4 * cfg.n_layer * 3 * cfg.block_size * cfg.n_embd
    assert [pool.allocate() for _ in range(3)] == [0, 1, 2]
    assert pool.free_count == 0 and pool.used_count == 3
    assert pool.allocate() is None  # exhausted, not an error
    pool.free(1)
    assert pool.allocate() == 1  # reuses the freed slot
    with pytest.raises(ValueError):
        pool.free(5)  # out of range
    pool.free(2)
    with pytest.raises(ValueError):
        pool.free(2)  # double free
    with pytest.raises(ValueError):
        SlotKVPool(cfg, 0, device="cpu")


# ---------------------------------------------------------------------------
# scheduler
# ---------------------------------------------------------------------------


def test_requests_queue_when_slots_full(cfg_params):
    cfg, params = cfg_params
    s = server(params, cfg, n_slots=2)
    handles = [s.submit(Request(prompt=p, max_new_tokens=6)) for p in PROMPTS[:4]]
    s.step()
    assert len(s.queue) == 2
    assert s.engine.pool.free_count == 0
    s.run_until_drained(max_steps=100)
    for p, h in zip(PROMPTS[:4], handles):
        assert h.finished and h.finish_reason == "length"
        assert h.tokens == solo_greedy(params, cfg, p, 6)
    assert s.metrics.requests_completed == 4


def test_mid_decode_admission_matches_solo_with_bounded_shapes(cfg_params):
    """>= 3 concurrent requests with staggered arrivals, each greedy output
    token-identical to solo generate(), and one shape per family."""
    cfg, params = cfg_params
    s = server(params, cfg, n_slots=3)
    n = 10
    h1 = s.submit(Request(prompt=PROMPTS[0], max_new_tokens=n))
    s.step()
    s.step()  # h1 mid-decode
    h2 = s.submit(Request(prompt=PROMPTS[1], max_new_tokens=n))
    s.step()  # h2 admitted while h1 decodes
    h3 = s.submit(Request(prompt=PROMPTS[2], max_new_tokens=n))
    s.step()
    assert s.engine.pool.used_count == 3
    s.run_until_drained(max_steps=100)
    for p, h in zip(PROMPTS[:3], (h1, h2, h3)):
        assert h.tokens == solo_greedy(params, cfg, p, n), h.request_id
    h4 = s.submit(Request(prompt=PROMPTS[3], max_new_tokens=4))
    s.run_until_drained(max_steps=100)
    assert h4.tokens == solo_greedy(params, cfg, PROMPTS[3], 4)
    # the default ladder at block_size=32 is a single bucket
    assert s.compile_counts() == {
        "prefill": 1, "decode": 1, "prefix_load": 0, "prefix_save": 0}


def test_per_request_stop_conditions(cfg_params):
    cfg, params = cfg_params
    solo = solo_greedy(params, cfg, PROMPTS[0], 10)
    eos = solo[3]
    s = server(params, cfg, n_slots=3)
    h_len3 = s.submit(Request(prompt=PROMPTS[1], max_new_tokens=3))
    h_len8 = s.submit(Request(prompt=PROMPTS[2], max_new_tokens=8))
    h_eos = s.submit(Request(prompt=PROMPTS[0], max_new_tokens=10, eos_id=eos))
    s.run_until_drained(max_steps=100)
    assert h_len3.finish_reason == "length" and len(h_len3.tokens) == 3
    assert h_len8.finish_reason == "length" and len(h_len8.tokens) == 8
    assert h_eos.finish_reason == "eos"
    assert h_eos.tokens == solo[:solo.index(eos) + 1]


def test_max_new_one_finishes_at_prefill(cfg_params):
    cfg, params = cfg_params
    s = server(params, cfg, n_slots=2)
    h = s.submit(Request(prompt=PROMPTS[0], max_new_tokens=1))
    s.run_until_drained(max_steps=10)
    assert h.finished and h.tokens == solo_greedy(params, cfg, PROMPTS[0], 1)
    assert s.engine.pool.free_count == 2


def test_sampled_tenant_does_not_perturb_greedy_tenant(cfg_params):
    cfg, params = cfg_params
    s = server(params, cfg, n_slots=2)
    h_greedy = s.submit(Request(prompt=PROMPTS[0], max_new_tokens=8))
    h_sampled = s.submit(Request(prompt=PROMPTS[1], max_new_tokens=8,
                                 do_sample=True, temperature=1.5, top_k=10, seed=7))
    s.run_until_drained(max_steps=100)
    assert h_greedy.tokens == solo_greedy(params, cfg, PROMPTS[0], 8)
    assert len(h_sampled.tokens) == 8
    assert all(0 <= t < cfg.vocab_size for t in h_sampled.tokens)


def test_sampled_request_reproducible_by_seed(cfg_params):
    """A sampled request's tokens depend on its seed, not its co-tenants,
    nor on how its prompt was prefilled (chunks, a prefix hit)."""
    cfg, params = cfg_params

    def run(extra, **kw):
        s = server(params, cfg, n_slots=2, **kw)
        if kw:  # warm the prefix store with the same head
            s.generate_batch([Request(prompt=PROMPTS[1] * 5, max_new_tokens=1)])
        h = s.submit(Request(prompt=PROMPTS[1] * 5 + [3], max_new_tokens=8,
                             do_sample=True, temperature=0.9, top_k=12, seed=3))
        if extra:
            s.submit(Request(prompt=PROMPTS[2], max_new_tokens=8,
                             do_sample=True, seed=11))
        s.run_until_drained(max_steps=100)
        return h.tokens

    alone = run(False)
    assert alone == run(True)
    assert alone == run(True, prefill_buckets=(4, 8, 16, 32), prefill_chunk=4,
                        prefix_cache_mb=1.0)


def test_sampling_filters_match_the_solo_sampler():
    """_select_next_slots's per-row top-k/top-p keep exactly the tokens the
    solo _filter_logits keeps, and greedy rows are the argmax."""
    g = torch.Generator().manual_seed(0)
    logits = torch.randn(4, 30, generator=g) * 3
    temps = torch.tensor([1.0, 0.7, 1.3, 2.0])
    ks = torch.tensor([0, 5, 30, 3])
    ps = torch.tensor([1.0, 0.8, 0.5, 1.0])
    got = engine_mod._filter_rows(logits / temps[:, None], ks, ps)
    for r in range(4):
        want = gen._filter_logits(logits[r:r + 1], float(temps[r]),
                                  int(ks[r]) or None, float(ps[r]))
        assert torch.equal(torch.isinf(got[r]), torch.isinf(want[0]))
    gens = [torch.Generator().manual_seed(i) for i in range(4)]
    nxt = engine_mod._select_next_slots(logits, temps, ks, ps,
                                        [False, True, True, False], gens)
    assert nxt[0] == logits[0].argmax() and nxt[3] == logits[3].argmax()
    for r in (1, 2):
        assert not torch.isinf(got[r, nxt[r]])  # drawn from the kept set


def test_long_prompt_cropped_and_max_new_clamped(cfg_params):
    cfg, params = cfg_params
    s = server(params, cfg, n_slots=1)
    h = s.submit(Request(prompt=list(range(1, 41)), max_new_tokens=50))
    assert len(h.prompt_used) == cfg.block_size
    assert h.max_new_effective == 1
    s.run_until_drained(max_steps=10)
    assert h.finished and len(h.tokens) == 1


def test_metrics_counters_add_up(cfg_params):
    cfg, params = cfg_params
    tracer = SpanTracer()
    s = server(params, cfg, n_slots=2, tracer=tracer)
    streamed = []
    s.on_token = lambda h, t: streamed.append((h.request_id, t))
    handles = s.generate_batch(
        [Request(prompt=p, max_new_tokens=5) for p in PROMPTS[:3]])
    m = s.summary()
    total = sum(len(h.tokens) for h in handles)
    assert m["requests_submitted"] == 3 and m["requests_completed"] == 3
    assert m["prefills"] == 3
    assert m["tokens_generated"] == total == 15
    assert len(streamed) == total
    assert m["ttft_mean_s"] >= 0 and m["itl_mean_s"] >= 0
    assert 0 < m["slot_utilization"] <= 1
    assert m["queue_depth"] == 0 and m["slots_active"] == 0
    names = {r["name"] for r in tracer.records()}
    assert {"serve.admit", "serve.prefill_chunk", "serve.decode_round"} <= names


def test_request_validation(cfg_params):
    cfg, params = cfg_params
    s = server(params, cfg, n_slots=1)
    with pytest.raises(ValueError):
        s.submit(Request(prompt=[], max_new_tokens=3))
    with pytest.raises(ValueError):
        s.submit(Request(prompt=[1], max_new_tokens=0))


# ---------------------------------------------------------------------------
# robustness: bounded queue, deadlines, callback isolation
# ---------------------------------------------------------------------------


def test_bounded_queue_rejects_beyond_limit(cfg_params):
    cfg, params = cfg_params
    s = server(params, cfg, n_slots=1, max_queue=2)
    h_ok = [s.submit(Request(prompt=p, max_new_tokens=3)) for p in PROMPTS[:2]]
    with pytest.raises(QueueFullError):
        s.submit(Request(prompt=PROMPTS[2], max_new_tokens=3))
    assert s.metrics.requests_rejected == 1
    assert s.metrics.requests_submitted == 2
    s.run_until_drained(max_steps=100)
    assert all(h.finished and h.finish_reason == "length" for h in h_ok)
    h3 = s.submit(Request(prompt=PROMPTS[2], max_new_tokens=3))
    s.run_until_drained(max_steps=100)
    assert h3.finished
    with pytest.raises(ValueError):
        server(params, cfg, n_slots=1, max_queue=0)


def test_deadline_expires_queued_request_without_taking_a_slot(cfg_params):
    cfg, params = cfg_params
    t = {"now": 0.0}
    s = server(params, cfg, n_slots=1, clock=lambda: t["now"])
    h_busy = s.submit(Request(prompt=PROMPTS[0], max_new_tokens=8))
    h_doomed = s.submit(Request(prompt=PROMPTS[1], max_new_tokens=8, deadline_s=5.0))
    s.step()
    assert h_busy.slot is not None and not h_doomed.finished
    t["now"] = 6.0
    s.step()
    assert h_doomed.finished and h_doomed.finish_reason == "deadline"
    assert h_doomed.tokens == []
    s.run_until_drained(max_steps=100)
    assert h_busy.finish_reason == "length"
    assert s.metrics.requests_expired == 1


def test_deadline_frees_slot_of_abandoned_mid_decode_request(cfg_params):
    cfg, params = cfg_params
    t = {"now": 0.0}
    s = server(params, cfg, n_slots=1, clock=lambda: t["now"],
               default_deadline_s=10.0)
    h = s.submit(Request(prompt=PROMPTS[0], max_new_tokens=1000))
    s.step()
    s.step()
    assert not h.finished and h.slot is not None
    t["now"] = 11.0
    s.step()
    assert h.finished and h.finish_reason == "deadline"
    assert h.slot is None and s.engine.pool.free_count == 1
    h2 = s.submit(Request(prompt=PROMPTS[1], max_new_tokens=4, deadline_s=100.0))
    s.run_until_drained(max_steps=100)
    assert h2.finish_reason == "length"
    assert h2.tokens == solo_greedy(params, cfg, PROMPTS[1], 4)


def test_raising_callback_frees_slot_and_server_keeps_serving(cfg_params):
    cfg, params = cfg_params

    def bad_cb(handle, tok):
        raise RuntimeError("consumer went away")

    s = server(params, cfg, n_slots=2, on_token=bad_cb)
    h_bad = s.submit(Request(prompt=PROMPTS[0], max_new_tokens=8))
    s.step()
    assert h_bad.finished and h_bad.finish_reason == "error"
    assert isinstance(h_bad.error, RuntimeError)
    assert s.engine.pool.free_count == 2
    assert s.metrics.requests_failed == 1
    s.on_token = None
    h_ok = s.submit(Request(prompt=PROMPTS[1], max_new_tokens=6))
    s.run_until_drained(max_steps=100)
    assert h_ok.tokens == solo_greedy(params, cfg, PROMPTS[1], 6)


def test_callback_raising_mid_decode_frees_its_slot_only(cfg_params):
    cfg, params = cfg_params
    calls = {}

    def cb(handle, tok):
        calls[handle.request_id] = calls.get(handle.request_id, 0) + 1
        if handle.request_id == "bad" and calls["bad"] == 3:
            raise RuntimeError("gone")

    s = server(params, cfg, n_slots=2, on_token=cb)
    bad = s.submit(Request(prompt=PROMPTS[0], max_new_tokens=8, request_id="bad"))
    good = s.submit(Request(prompt=PROMPTS[1], max_new_tokens=8))
    s.run_until_drained(max_steps=100)
    assert bad.finish_reason == "error" and len(bad.tokens) == 3
    assert good.tokens == solo_greedy(params, cfg, PROMPTS[1], 8)
    assert s.engine.pool.free_count == 2


def test_cancel_queued_and_in_flight(cfg_params):
    cfg, params = cfg_params
    s = server(params, cfg, n_slots=1)
    a = s.submit(Request(prompt=PROMPTS[0], max_new_tokens=8, request_id="a"))
    b = s.submit(Request(prompt=PROMPTS[1], max_new_tokens=8, request_id="b"))
    s.step()
    assert s.unfinished() == [b, a]
    assert s.cancel("b") and s.cancel("a") and not s.cancel("a")
    assert a.finish_reason == b.finish_reason == "cancelled"
    assert s.engine.pool.free_count == 1 and s.metrics.requests_failed == 2


# ---------------------------------------------------------------------------
# prefill: bucket ladder, chunked prefill, prefix reuse
# ---------------------------------------------------------------------------


def test_bucket_ladder_defaults_and_validation():
    assert engine_mod.bucket_ladder(1024) == (64, 128, 256, 512, 1024)
    assert engine_mod.bucket_ladder(1024, chunk=256) == (64, 128, 256, 512, 1024)
    assert engine_mod.bucket_ladder(32) == (32,)
    assert engine_mod.bucket_ladder(100, chunk=48) == (48, 64, 100)
    assert engine_mod.bucket_ladder(32, buckets=(8, 4)) == (4, 8, 32)
    with pytest.raises(ValueError):
        engine_mod.bucket_ladder(32, buckets=(40,))


def test_bucket_ladder_shape_count_bounded_with_warmup(cfg_params):
    """Warmup runs exactly the ladder; serving prompts of mixed lengths adds
    no shape (<= ladder-size prefill shapes + 1 decode), every greedy output
    stays solo-exact, and short prompts forward at their bucket length."""
    cfg, params = cfg_params
    buckets = (4, 8, 16, 32)
    s = server(params, cfg, n_slots=2, prefill_buckets=buckets, warmup=True)
    assert s.engine.buckets == buckets
    counts = s.compile_counts()
    assert counts == {"prefill": len(buckets), "decode": 1,
                      "prefix_load": 0, "prefix_save": 0}
    n_for = {id(p): min(5, cfg.block_size - len(p)) for p in MIXED_PROMPTS}
    handles = s.generate_batch(
        [Request(prompt=p, max_new_tokens=n_for[id(p)]) for p in MIXED_PROMPTS])
    for p, h in zip(MIXED_PROMPTS, handles):
        assert h.tokens == solo_greedy(params, cfg, p, n_for[id(p)]), h.request_id
    hist = s.metrics.bucket_histogram
    assert hist.get(4) and hist.get(32)
    assert s.compile_counts() == counts


def test_shape_counts_stay_put_after_warmup_with_the_prefix_store(cfg_params):
    """The recompile watchdog's guarantee (no new program after warmup), as
    shape counts: with chunking and the prefix store on, serving a mixed
    batch adds no shape to any family after warmup."""
    cfg, params = cfg_params
    s = server(params, cfg, n_slots=2, prefill_buckets=(4, 8, 16, 32),
               prefill_chunk=8, prefix_cache_mb=4.0, warmup=True)
    before = s.compile_counts()
    assert before == {"prefill": 4, "decode": 1, "prefix_load": 3, "prefix_save": 3}
    n_for = {id(p): min(4, cfg.block_size - len(p)) for p in MIXED_PROMPTS}
    handles = s.generate_batch(
        [Request(prompt=p, max_new_tokens=n_for[id(p)]) for p in MIXED_PROMPTS * 2])
    assert all(h.finished for h in handles)
    assert s.metrics.prefix_hits >= 1
    assert s.compile_counts() == before


def test_cold_server_counts_each_family_once(cfg_params):
    """Without warmup the first request adds one prefill and one decode
    shape, and nothing more however many requests follow."""
    cfg, params = cfg_params
    s = server(params, cfg, n_slots=2)
    assert s.compile_counts() == {"prefill": 0, "decode": 0,
                                  "prefix_load": 0, "prefix_save": 0}
    s.generate_batch([Request(prompt=PROMPTS[0], max_new_tokens=4)])
    first = s.compile_counts()
    assert first == {"prefill": 1, "decode": 1, "prefix_load": 0, "prefix_save": 0}
    s.generate_batch([Request(prompt=p, max_new_tokens=3) for p in PROMPTS])
    assert s.compile_counts() == first


def test_chunked_prefill_staggered_admission_parity(cfg_params):
    """A long prompt admitted mid-decode prefills in chunks across rounds
    while the co-tenant decodes one token EVERY round; both outputs stay
    token-identical to solo generate()."""
    cfg, params = cfg_params
    s = server(params, cfg, n_slots=2, prefill_buckets=(4, 8, 16, 32),
               prefill_chunk=8)
    short, long_p = PROMPTS[0], MIXED_PROMPTS[5]
    h1 = s.submit(Request(prompt=short, max_new_tokens=10))
    s.step()
    s.step()
    h2 = s.submit(Request(prompt=long_p, max_new_tokens=2))
    progress = []
    while not h2.tokens and len(progress) < 50:
        before = len(h1.tokens)
        s.step()
        progress.append(len(h1.tokens) - before)
    assert len(progress) >= 4 and all(d == 1 for d in progress)
    s.run_until_drained(max_steps=100)
    assert h2.tokens == solo_greedy(params, cfg, long_p, 2)
    assert h1.tokens == solo_greedy(params, cfg, short, 10)
    assert s.metrics.prefill_chunks >= 4 + 1


def test_prefix_reuse_hits_and_stays_token_identical(cfg_params):
    cfg, params = cfg_params
    system = list(range(1, 17))
    a, b = system + [20, 21, 22], system + [30, 31]
    s = server(params, cfg, n_slots=1, prefill_buckets=(4, 8, 16, 32),
               prefix_cache_mb=8.0)
    ha = s.submit(Request(prompt=a, max_new_tokens=4))
    s.run_until_drained(max_steps=100)
    tokens_after_a = s.metrics.prefill_tokens
    hb = s.submit(Request(prompt=b, max_new_tokens=4))
    s.run_until_drained(max_steps=100)
    assert ha.tokens == solo_greedy(params, cfg, a, 4)
    assert hb.tokens == solo_greedy(params, cfg, b, 4)
    m = s.metrics
    assert m.prefix_lookups == 2 and m.prefix_hits == 1
    assert m.prefix_rows_reused == 16 == hb.prefix_rows
    assert m.prefill_tokens - tokens_after_a == len(b) - 16
    assert 0 < m.prefix_hit_rate < 1
    hc = s.generate_batch([Request(prompt=system + [41], max_new_tokens=3)])[0]
    assert hc.prefix_rows == 16
    assert hc.tokens == solo_greedy(params, cfg, system + [41], 3)


def test_all_three_mechanisms_combined_parity(cfg_params):
    cfg, params = cfg_params
    buckets = (4, 8, 16, 32)
    s = server(params, cfg, n_slots=2, prefill_buckets=buckets, prefill_chunk=8,
               prefix_cache_mb=8.0)
    shared = list(range(3, 20))
    reqs = [
        Request(prompt=shared + [25, 26], max_new_tokens=6),
        Request(prompt=PROMPTS[0], max_new_tokens=8, do_sample=True,
                temperature=1.3, top_k=9, seed=5),
        Request(prompt=shared + [27], max_new_tokens=5),
        Request(prompt=MIXED_PROMPTS[5], max_new_tokens=2),
    ]
    handles = []
    for r in reqs:
        handles.append(s.submit(r))
        s.step()
    s.run_until_drained(max_steps=200)
    for r, h in zip(reqs, handles):
        if not r.do_sample:
            assert h.tokens == solo_greedy(params, cfg, list(r.prompt),
                                           r.max_new_tokens), h.request_id
    assert s.metrics.prefix_hits >= 1
    counts = s.compile_counts()
    assert counts["decode"] == 1
    assert counts["prefill"] <= len(s.engine.buckets)
    assert counts["prefix_load"] <= len(buckets)
    assert counts["prefix_save"] <= len(buckets)


def test_final_chunk_shift_back_at_window_edge(cfg_params):
    """Ladder (5, 32) + chunk 5 on a 32-token prompt: the last chunk (2
    tokens at offset 30) pads to bucket 5, which would overrun the window
    (35 > 32), so it shifts back to offset 27; the output stays exact."""
    cfg, params = cfg_params
    prompt = list(range(1, 33))
    s = server(params, cfg, n_slots=1, prefill_buckets=(5, 32), prefill_chunk=5)
    h = s.submit(Request(prompt=prompt, max_new_tokens=1))
    s.run_until_drained(max_steps=50)
    assert h.tokens == solo_greedy(params, cfg, prompt, 1)
    with pytest.raises(ValueError, match="overruns"):
        s.engine.prefill_chunk_call(0, [1, 2], 30, 1.0, None, None, False, None)


def test_prefix_store_lru_and_byte_bounds():
    def entry(rows):
        a = torch.zeros(rows, dtype=torch.float32)
        return {"k": a, "v": a}  # 8 bytes per row

    store = PrefixKVStore(capacity_bytes=80)
    assert store.insert((1, 2, 3), entry(3))
    assert store.insert((1, 2, 3, 4, 5), entry(5))
    assert store.lookup((1, 2, 3, 4, 5, 6))[0] == 5  # longest proper prefix
    assert store.lookup((1, 2, 3, 4, 5))[0] == 3     # not a prefix of itself
    assert store.lookup((9, 9, 9)) is None
    assert store.insert((7, 8, 9, 10), entry(4))    # evicts the LRU entry
    assert not store.contains((1, 2, 3, 4, 5))
    assert store.contains((1, 2, 3))
    assert not store.insert((5,) * 20, entry(20))   # bigger than the budget
    assert not store.insert((1, 2, 3), entry(3))    # present: refreshed only
    assert store.used_bytes <= store.capacity_bytes and len(store) == 2
    with pytest.raises(ValueError):
        PrefixKVStore(0)


def test_prefill_flops_scale_with_bucket(cfg_params):
    """Admission cost tracks prompt length: the 4-token bucket's prefill
    costs a fraction of the full-window one (FlopCounterMode)."""
    cfg, params = cfg_params
    eng = DecodeEngine(params, cfg, n_slots=1, prefill_buckets=(4, 32), device="cpu")

    def flops(n):
        with FlopCounterMode(display=False) as fc:
            eng.prefill_chunk_call(0, [1] * n, 0, 1.0, None, None, False, None)
        return fc.get_total_flops()

    small, full = flops(3), flops(30)
    assert 0 < small < full / 4


def test_llama_mode_serving_parity():
    _, _, cfg, params = _both(LLAMA)
    s = server(params, cfg, n_slots=2)
    handles = s.generate_batch([Request(prompt=p, max_new_tokens=6) for p in PROMPTS[:3]])
    for p, h in zip(PROMPTS[:3], handles):
        assert h.tokens == solo_greedy(params, cfg, p, 6)


def test_window_softcap_serving_parity():
    _, _, cfg, params = _both(dict(TINY, attention_window=6,
                                   attn_logit_softcap=20.0,
                                   final_logit_softcap=15.0))
    s = server(params, cfg, n_slots=2, prefill_buckets=(4, 8, 16, 32),
               prefill_chunk=4)
    handles = s.generate_batch([Request(prompt=p, max_new_tokens=9)
                                for p in MIXED_PROMPTS[:4]])
    for p, h in zip(MIXED_PROMPTS[:4], handles):
        assert h.tokens == solo_greedy(params, cfg, p, 9)


# ---------------------------------------------------------------------------
# validation, typed backpressure, mid-prefill expiry, unported options
# ---------------------------------------------------------------------------


def test_validation_rejects_malformed_sampling_params(cfg_params):
    cfg, params = cfg_params
    s = server(params, cfg, n_slots=1)
    bad = [
        Request(prompt=[1], max_new_tokens=3, temperature=float("nan")),
        Request(prompt=[1], max_new_tokens=3, temperature=float("inf")),
        Request(prompt=[1], max_new_tokens=3, temperature=-0.5),
        Request(prompt=[1], max_new_tokens=3, top_k=0),
        Request(prompt=[1], max_new_tokens=3, top_p=0.0),
        Request(prompt=[1], max_new_tokens=3, top_p=1.5),
        Request(prompt=[1], max_new_tokens=3, top_p=float("nan")),
        Request(prompt=[1], max_new_tokens=-2),
        Request(prompt=[1], max_new_tokens=3, deadline_s=-1.0),
        Request(prompt=[1], max_new_tokens=3, deadline_s=float("inf")),
    ]
    for r in bad:
        with pytest.raises(ValueError):
            s.submit(r)
    assert s.metrics.requests_submitted == 0


def test_strict_window_rejects_instead_of_cropping(cfg_params):
    cfg, params = cfg_params
    strict = server(params, cfg, n_slots=1, strict_window=True)
    with pytest.raises(ValueError):
        strict.submit(Request(prompt=list(range(1, 41)), max_new_tokens=2))
    with pytest.raises(ValueError):
        strict.submit(Request(prompt=list(range(1, 31)), max_new_tokens=4))
    h = strict.submit(Request(prompt=PROMPTS[0], max_new_tokens=4))
    strict.run_until_drained(max_steps=100)
    assert h.tokens == solo_greedy(params, cfg, PROMPTS[0], 4)


def test_queue_full_error_carries_backpressure_payload(cfg_params):
    cfg, params = cfg_params
    s = server(params, cfg, n_slots=1, max_queue=1)
    s.submit(Request(prompt=PROMPTS[0], max_new_tokens=3))
    with pytest.raises(QueueFullError) as ei:
        s.submit(Request(prompt=PROMPTS[1], max_new_tokens=3))
    assert ei.value.queue_depth == 1
    assert ei.value.retry_after_s is not None and ei.value.retry_after_s >= 0.05
    assert s.metrics.rejected_by_reason["queue_full"] == 1
    s.run_until_drained(max_steps=100)


def test_deadline_expiry_mid_prefill_frees_slot_and_counts(cfg_params):
    cfg, params = cfg_params
    t = {"now": 0.0}
    s = server(params, cfg, n_slots=1, prefill_chunk=4, prefix_cache_mb=1.0,
               clock=lambda: t["now"])
    prompt = list(range(1, 21))
    h = s.submit(Request(prompt=prompt, max_new_tokens=4, deadline_s=5.0))
    s.step()
    assert h.slot is not None and h.prefilling
    assert 0 < h.prefill_pos < len(prompt)
    assert s.engine.pool.free_count == 0
    t["now"] = 6.0
    s.step()
    assert h.finished and h.finish_reason == "deadline"
    assert h.slot is None and not h.prefilling and h.tokens == []
    assert s.engine.pool.free_count == 1
    assert s.metrics.requests_expired == 1
    h2 = s.submit(Request(prompt=PROMPTS[1], max_new_tokens=4))
    s.run_until_drained(max_steps=100)
    assert h2.tokens == solo_greedy(params, cfg, PROMPTS[1], 4)


@pytest.mark.parametrize("option, error, message", [
    # the ids the cases had beside the three item-16 options, which run now;
    # the mesh (item 9) runs too, and refuses what is not a serving mesh
    pytest.param(dict(mesh=object()), ValueError, "Mesh.serving", id="option3-item 9"),
])
def test_unported_options_raise_naming_their_item(cfg_params, option, error, message):
    cfg, params = cfg_params
    with pytest.raises(error, match=message):
        server(params, cfg, n_slots=1, **option)


@pytest.mark.parametrize("option", ["spec_k", "draft_params", "kv_dtype=int8",
                                    "kv_dtype=fp8"])
def test_speculation_and_quantized_pool_options_run(cfg_params, option):
    """The options that raised naming item 14 run: speculation (a 1-layer
    draft, k = 2) and the int8 and fp8 pools, each serving the requests to
    the end; speculation keeps the greedy tokens solo generate's."""
    cfg, params = cfg_params
    if option.startswith("kv_dtype"):
        kw = dict(kv_dtype=option.split("=")[1])
    else:
        kw = dict(draft_params=t_serve.first_layers(params, 1),
                  draft_cfg=dataclasses.replace(cfg, n_layer=1), spec_k=2)
    s = server(params, cfg, n_slots=2, **kw)
    handles = s.generate_batch([Request(prompt=p, max_new_tokens=6) for p in PROMPTS])
    assert all(h.finished and len(h.tokens) == 6 for h in handles)
    if "spec_k" in kw:
        assert s.metrics.spec_rounds > 0
        for p, h in zip(PROMPTS, handles):
            assert h.tokens == solo_greedy(params, cfg, p, 6)
    else:
        assert s.engine.kv_dtype == kw["kv_dtype"]
        assert sorted(s.engine.pool.cache) == ["k", "k_scale", "v", "v_scale"]


def test_engine_refuses_attribution_and_foreign_devices(cfg_params):
    """Attribution registers one row per shape (the decode step and each
    ladder bucket), and the audit contracts cover every family it
    registers (tests/test_torch_graftaudit.py runs them)."""
    from mingpt_distributed_tpu_torch.telemetry import MetricsRegistry, ProgramLedger

    cfg, params = cfg_params
    eng = DecodeEngine(params, cfg, n_slots=1, device="cpu")
    ledger = ProgramLedger(registry=MetricsRegistry())
    eng.register_attrib(ledger)
    assert {(r["family"], r["variant"]) for r in ledger.rows()} == {
        ("decode", "")} | {("prefill", f"b{b}") for b in eng.buckets}
    contracts = eng.audit_contracts()
    assert {r["family"] for r in ledger.rows()} <= set(contracts)
    assert contracts["decode"]["allowed_collectives"] == ()
    assert contracts["decode"]["donated"] == len(eng.pool.cache)
    assert contracts["prefix_save"]["donated"] == 0
    assert contracts["decode"]["kv_local_heads"] == cfg.kv_heads
    with pytest.raises(ValueError, match="unknown kv_dtype"):
        DecodeEngine(params, cfg, n_slots=1, kv_dtype="int4", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            InferenceServer(params, cfg, n_slots=1)  # cuda unless asked


# ---------------------------------------------------------------------------
# serve.py and restore_inference_params
# ---------------------------------------------------------------------------

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAML = os.path.join(REPO, "gpt2_config.yaml")
CORPUS = os.path.join(REPO, "data", "input.txt")
CLI_MODEL = ["--config", YAML, "gpt_config.n_layer=2", "gpt_config.n_head=4",
             "gpt_config.n_embd=64", "gpt_config.dtype=float32",
             "gpt_config.attn_pdrop=0", f"data_config.path={CORPUS}",
             "data_config.block_size=32", "data_config.truncate=0.2"]
CLI_PROMPTS = ["the king ", "and so ", "Unknown Capital", "what is "]


@pytest.fixture(scope="module")
def snapshot_argv(tmp_path_factory):
    """The model arguments and the snapshot of a 3-step CPU run of the
    port's train entry point (char vocabulary)."""
    snap = tmp_path_factory.mktemp("serve") / "snap.pt"
    argv = CLI_MODEL + [f"trainer_config.snapshot_path={snap}"]
    assert t_train.main(["--device", "cpu", *argv, "trainer_config.batch_size=8",
                         "trainer_config.max_steps=3",
                         "trainer_config.eval_batches=1"]) == 0
    return argv


def _solo_text(argv, prompt, n):
    exp = load_config(argv[1], argv[2:])
    ds = CharDataset(exp.data_config)
    cfg = dataclasses.replace(exp.gpt_config, vocab_size=ds.vocab_size,
                              block_size=ds.block_size, embd_pdrop=0.0,
                              resid_pdrop=0.0, attn_pdrop=0.0)
    snap = ckpt.restore_inference_params(exp.trainer_config.snapshot_path, cfg, "cpu")
    out = gen.generate(snap.params, cfg, ds.encode(prompt)[None], n, device="cpu")
    return ds.decode(out[0].numpy())



def test_serve_selftest_passes_on_the_cpu(capsys):
    assert t_serve.main(["--selftest", "--device", "cpu", "--log-every", "0"]) == 0
    out = capsys.readouterr().out
    assert out.count(": OK") == 3 and "selftest PASSED" in out


def test_serve_selftest_with_chunks_buckets_prefix_and_warmup(tmp_path, capsys):
    path = tmp_path / "m.json"
    assert t_serve.main(["--selftest", "--device", "cpu", "--prefix-cache-mb", "1",
                         "--prefill-chunk", "8", "--prefill-buckets", "8,16,48",
                         "--warmup", "--log-every", "0",
                         "--metrics-json", str(path)]) == 0
    out = capsys.readouterr().out
    assert out.count(": OK") == 5 and "selftest PASSED" in out
    summary = json.loads(path.read_text())
    assert summary["prefix_hits"] >= 1 and summary["requests_completed"] == 5
    assert summary["bucket_histogram"] == {"8": summary["prefill_chunks"]}


def test_serve_prompts_file_over_a_trained_snapshot(snapshot_argv, tmp_path, capsys):
    """Offline batch over the trainer's snapshot: every prompt in the
    vocabulary is served (the one outside it is skipped with its error),
    each greedy completion equals solo generate on the restored params."""
    prompts = tmp_path / "prompts.txt"
    prompts.write_text("\n".join(CLI_PROMPTS) + "\n\n")
    assert t_serve.main(["--prompts-file", str(prompts), "--device", "cpu",
                         "--greedy", "--max-new-tokens", "7", "--slots", "2",
                         *snapshot_argv]) == 0
    cap = capsys.readouterr()
    assert "skipped (KeyError" in cap.err and "loaded snapshot step 3" in cap.err
    blocks = re.split(r"^=== req-\d+ \(length\) ===\n", cap.out, flags=re.M)[1:]
    last, summary = blocks[-1].rsplit("\n{", 1)
    blocks[-1], summary = last + "\n", json.loads("{" + summary)
    served = [p for p in CLI_PROMPTS if p[0].islower()]
    assert [b[:-1] for b in blocks] == [_solo_text(snapshot_argv, p, 7)
                                        for p in served]
    assert summary["requests_completed"] == 3 and summary["tokens_generated"] == 21


def test_serve_prompts_file_through_the_fleet(snapshot_argv, tmp_path, capsys):
    """--replicas 2 over the trainer's snapshot: the router in front of two
    replicas on the wall clock, with a crash injected into replica0's
    first round; every greedy completion equals solo generate, the fleet
    summary is printed and --metrics-json writes it."""
    prompts = tmp_path / "prompts.txt"
    prompts.write_text("the king \nand so \nwhat is \n")
    metrics = tmp_path / "fleet.json"
    assert t_serve.main(["--prompts-file", str(prompts), "--device", "cpu",
                         "--greedy", "--max-new-tokens", "7", "--slots", "2",
                         "--replicas", "2", "--isolation", "thread",
                         "--shed-watermark", "64", "--chaos-spec",
                         "crash:nth=1:match=replica0", "--metrics-json", str(metrics),
                         *snapshot_argv]) == 0
    cap = capsys.readouterr()
    assert "fleet: 2 replicas x 2 slots" in cap.err
    blocks = re.split(r"^=== fleet-\d+ \(length\) ===\n", cap.out, flags=re.M)[1:]
    last, summary = blocks[-1].rsplit("\n{", 1)
    blocks[-1], summary = last + "\n", json.loads("{" + summary)
    assert [b[:-1] for b in blocks] == [_solo_text(snapshot_argv, p, 7)
                                        for p in ("the king ", "and so ", "what is ")]
    assert summary["requests_by_outcome"]["completed"] == 3
    assert set(summary["replicas"]) == {"replica0", "replica1"}
    assert summary["replicas"]["replica0"]["crashes"] == summary["retries_by_reason"]["crash"] > 0
    assert json.loads(metrics.read_text()) == summary


def test_engine_migration_seam_matches_jax(cfg_params):
    """The engine's migration seam against the JAX engine's, fp32: the same
    bucket from ``migratable_rows`` for every (prompt, frontier), the
    extracted rows within 1e-5 of JAX's, and an adopted prefix entry hit by
    the next request, which continues as solo generate does."""
    cfg, params = cfg_params
    jcfg = JConfig.make(**TINY)
    tree = j_gpt.init(jax.random.key(0), jcfg)
    from mingpt_distributed_tpu.serving.engine import DecodeEngine as JEngine

    ours = DecodeEngine(params, cfg, n_slots=2, prefill_buckets=(4, 8, 16), device="cpu")
    theirs = JEngine(tree, jcfg, n_slots=2, prefill_buckets=(4, 8, 16))
    for n in range(1, 33):
        for frontier in (0, 3, 8, n):
            assert ours.migratable_rows(n, frontier) == theirs.migratable_rows(n, frontier)
    prompt = list(range(1, 18))
    ours.prefill_chunk_call(1, prompt, 0, 1.0, None, None, False, None)
    theirs.prefill_chunk_call(1, prompt, 0, 1.0, None, None, False, jax.random.key(0))
    rows = ours.migratable_rows(len(prompt), len(prompt))
    assert rows == 16
    entry = ours.extract_slot_rows(1, rows)
    for leaf, a in theirs.extract_slot_rows(1, rows).items():
        np.testing.assert_allclose(entry[leaf].numpy(), np.asarray(a), atol=1e-5)
    with pytest.raises(ValueError, match="bucket ladder"):
        ours.extract_slot_rows(1, 12)
    dst = server(params, cfg, n_slots=2, prefill_buckets=(4, 8, 16, 32),
                 prefix_cache_mb=1.0)
    assert not server(params, cfg, n_slots=1).engine.adopt_prefix_entry(prompt[:rows], entry)
    assert dst.engine.adopt_prefix_entry(prompt[:rows], entry)
    assert not dst.engine.adopt_prefix_entry(prompt[:rows], entry)  # held already
    h = dst.generate_batch([Request(prompt=prompt, max_new_tokens=6)])[0]
    assert h.prefix_rows == 16 and dst.metrics.prefix_hits == 1
    assert h.tokens == solo_greedy(params, cfg, prompt, 6)


def test_serve_repl_streams_each_completion(snapshot_argv, monkeypatch, capsys):
    monkeypatch.setattr("sys.stdin", io.StringIO("the king \n\nwhat is \n"))
    assert t_serve.main(["--device", "cpu", "--greedy", "--max-new-tokens", "5",
                         *snapshot_argv]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines == [_solo_text(snapshot_argv, "the king ", 5),
                     _solo_text(snapshot_argv, "what is ", 5)]


def test_serve_params_npz_matches_jax_generate(tmp_path, capsys):
    """--params: a flat npz of a JAX pytree, served greedy, against JAX
    generate on the same weights."""
    exp = load_config(YAML, CLI_MODEL[2:])
    ds = CharDataset(exp.data_config)
    jcfg = JConfig.make(n_layer=2, n_head=4, n_embd=64, dtype="float32",
                        attention="einsum", embd_pdrop=0.0, resid_pdrop=0.0,
                        attn_pdrop=0.0, vocab_size=ds.vocab_size, block_size=32)
    tree = jax.device_get(j_gpt.init(jax.random.key(5), jcfg))
    tree = jax.tree.map(lambda a: a + np.float32(0.1) * np.sign(a), tree)
    np.savez(tmp_path / "params.npz", **convert.flatten(tree))
    prompts = tmp_path / "prompts.txt"
    prompts.write_text("the \nand so \n")
    assert t_serve.main(["--prompts-file", str(prompts), "--params",
                         str(tmp_path / "params.npz"), "--device", "cpu",
                         "--greedy", "--max-new-tokens", "12", *CLI_MODEL]) == 0
    out = capsys.readouterr().out
    for p in ("the ", "and so "):
        want = j_gen.generate(tree, jcfg, ds.encode(p)[None], 12)
        assert ds.decode(np.asarray(want)[0]) in out.splitlines()


def test_serve_without_weights_says_so(tmp_path, capsys):
    assert t_serve.main(["--device", "cpu", "--prompts-file", CORPUS, *CLI_MODEL,
                         f"trainer_config.snapshot_path={tmp_path / 'none.pt'}"]) == 1
    assert "no snapshot at" in capsys.readouterr().err


def test_serve_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: this checks the CPU-only behaviour")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_serve.main(["--selftest"])


def _jax_serve_flags():
    spec = importlib.util.spec_from_file_location("jax_serve_cli",
                                                  os.path.join(REPO, "serve.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)  # serve.py imports jax only inside functions
    return {o for a in mod.build_argparser()._actions for o in a.option_strings
            if o.startswith("--")}


def test_every_jax_serve_flag_is_ported_or_refused():
    port = {o for a in t_serve.build_argparser()._actions for o in a.option_strings
            if o.startswith("--")}
    jax_flags = _jax_serve_flags()
    assert jax_flags <= port
    ported = port - set(t_serve.UNPORTED_FLAGS)
    assert ported - jax_flags == {"--params", "--device", "--dist-backend"}
    assert {"--slots", "--max-new-tokens", "--temperature", "--top-k", "--top-p",
            "--greedy", "--eos-text", "--seed", "--metrics-json", "--log-every",
            "--queue-limit", "--deadline-s", "--prefill-buckets",
            "--prefill-chunk", "--prefix-cache-mb", "--warmup", "--selftest",
            "--prompts-file"} <= ported


@pytest.mark.parametrize("flag", ["--autoscale", "--control-log", "--mesh",
                                  "--selftest-sharded", "--slo-target"])
def test_unported_serve_flags_exit_naming_their_item(flag, capsys):
    """Every flag here is ported now and parses: the autoscaler's (item
    15c) and serving tensor parallelism's (item 9b; ``--selftest-sharded``
    is a switch, so its "2" is an override); a flag still refused would
    exit 2 naming its item."""
    if flag not in t_serve.UNPORTED_FLAGS:
        args = t_serve.parse_args([flag, "2"])
        assert capsys.readouterr().err == ""
        if flag == "--selftest-sharded":
            assert args.selftest_sharded is True and args.overrides == ["2"]
        else:
            assert getattr(args, flag[2:].replace("-", "_")) in ("2", 2.0)
        return
    with pytest.raises(SystemExit) as e:
        t_serve.parse_args([flag, "2"])
    assert e.value.code == 2
    item = t_serve.UNPORTED_FLAGS[flag]
    assert item == "9b"
    assert f"{flag} is not ported yet (ROADMAP.md Queue 1 item {item})" in \
        capsys.readouterr().err


@pytest.mark.parametrize("argv", [
    ["--isolation", "process", "--replicas", "2"], ["--spill-dir", "d"],
    ["--standby", "2"], ["--hang-deadline", "1.5"], ["--hosts", "3"],
    ["--fleet-secret", "s"], ["--selftest-procfleet"], ["--selftest-standby"],
    ["--selftest-crosshost"],
])
def test_process_fleet_serve_flags_parse(argv, capsys):
    """The process and cross-host fleet's flags run now: they parse, and
    none is refused."""
    args = t_serve.parse_args(argv)
    assert capsys.readouterr().err == ""
    assert not set(argv) & set(t_serve.UNPORTED_FLAGS)
    assert (args.standby, args.hang_deadline, args.hosts) == (
        2 if "--standby" in argv else 0, 1.5 if "--hang-deadline" in argv else None,
        3 if "--hosts" in argv else 1)


def test_kv_dtype_fp32_is_accepted():
    assert t_serve.parse_args(["--kv-dtype", "fp32", "--selftest"]).selftest


@pytest.mark.parametrize("argv, expect", [
    (["--selftest", "--metrics-port", "0"], "selftest scrape:"),
    (["--selftest", "--kv-dtype", "int8"], "selftest PASSED"),
    (["--selftest", "--kv-dtype", "fp8", "--warmup"], "selftest PASSED"),
    (["--selftest-spec"], "selftest-spec PASSED"),
    (["--selftest-spec", "--spec-k", "2", "--kv-dtype", "int8"], "selftest-spec PASSED"),
    (["--selftest-quant"], "selftest-quant PASSED"),
])
def test_ported_serve_flags_run(argv, expect, capsys):
    """The flags that exited naming items 5 and 14 run (the int8 and fp8
    pools through the greedy selftest: its prompts keep their tokens)."""
    assert t_serve.main([*argv, "--device", "cpu", "--log-every", "0"]) == 0
    assert expect in capsys.readouterr().out


@pytest.mark.parametrize("draft", ["self", "self:1", "n_layer=1,n_embd=32"])
def test_serve_prompts_file_with_speculation(snapshot_argv, tmp_path, capsys, draft):
    """--draft-config/--spec-k over the trainer's snapshot: the greedy
    completions equal solo generate's whatever the draft (a random-init
    draft is mostly rejected), and the summary counts the verify rounds."""
    prompts = tmp_path / "prompts.txt"
    prompts.write_text("the king \nwhat is \n")
    assert t_serve.main(["--prompts-file", str(prompts), "--device", "cpu",
                         "--greedy", "--max-new-tokens", "7", "--slots", "2",
                         "--draft-config", draft, "--spec-k", "3",
                         *snapshot_argv]) == 0
    out = capsys.readouterr().out
    blocks = re.split(r"^=== req-\d+ \(length\) ===\n", out, flags=re.M)[1:]
    last, summary = blocks[-1].rsplit("\n{", 1)
    blocks[-1], summary = last + "\n", json.loads("{" + summary)
    assert [b[:-1] for b in blocks] == [_solo_text(snapshot_argv, p, 7)
                                        for p in ("the king ", "what is ")]
    assert summary["spec_rounds"] > 0
    if draft == "self":
        assert summary["spec_accept_rate"] == 1.0


def test_draft_from_takes_the_target_or_its_first_layers(cfg_params):
    cfg, params = cfg_params
    assert t_serve.draft_from("self", params, cfg, "cpu") == (params, cfg)
    dparams, dcfg = t_serve.draft_from("self:1", params, cfg, "cpu")
    assert dcfg.n_layer == 1 and dparams["blocks"]["wq"].shape[0] == 1
    assert dparams["wte"] is params["wte"]
    dparams, dcfg = t_serve.draft_from("n_layer=1,n_embd=16", params, cfg, "cpu")
    assert (dcfg.n_layer, dcfg.n_embd, dcfg.vocab_size) == (1, 16, cfg.vocab_size)
    assert dparams["wte"].shape == (cfg.vocab_size, 16)


@pytest.mark.parametrize("argv, message", [
    (["--spec-k", "2"], "must be given together"),
    (["--draft-config", "self"], "must be given together"),
    (["--draft-config", "self:9", "--spec-k", "2"], "outside"),
    (["--draft-config", "self:x", "--spec-k", "2"], "needs an int"),
    (["--draft-config", "n_layer", "--spec-k", "2"], "is not k=v"),
])
def test_serve_draft_config_errors(snapshot_argv, tmp_path, argv, message):
    prompts = tmp_path / "prompts.txt"
    prompts.write_text("the king \n")
    with pytest.raises(SystemExit, match=message):
        t_serve.main(["--prompts-file", str(prompts), "--device", "cpu", *argv,
                      *snapshot_argv])


def test_serve_metrics_port_serves_the_page(snapshot_argv, tmp_path, monkeypatch):
    """--metrics-port on the batch path: the process registry is served
    while requests run (scraped from the on_token stream's first call) and
    the endpoint closes at shutdown."""
    import urllib.request

    from mingpt_distributed_tpu_torch import telemetry

    seen = {}
    real = telemetry.TelemetryServer

    class Recording(real):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            seen["server"] = self

    monkeypatch.setattr(telemetry, "TelemetryServer", Recording)
    real_close = Recording.close

    def close(self):
        with urllib.request.urlopen(self.url("/metrics"), timeout=10) as resp:
            seen["page"] = resp.read().decode()
        with urllib.request.urlopen(self.url("/healthz"), timeout=10) as resp:
            seen["health"] = json.loads(resp.read().decode())
        real_close(self)

    monkeypatch.setattr(Recording, "close", close)
    prompts = tmp_path / "prompts.txt"
    prompts.write_text("the king \n")
    assert t_serve.main(["--prompts-file", str(prompts), "--device", "cpu",
                         "--greedy", "--max-new-tokens", "3", "--metrics-port", "0",
                         *snapshot_argv]) == 0
    parsed = telemetry.parse_prometheus(seen["page"])
    assert parsed["types"]["mingpt_serve_ttft_seconds"] == "histogram"
    assert seen["health"]["status"] == "ok"


@pytest.fixture(scope="module")
def dir_snapshot_argv(snapshot_argv, tmp_path_factory):
    """``snapshot_argv``'s 3-step run with a directory for its snapshot (the
    sharded backend)."""
    dirsnap = tmp_path_factory.mktemp("serve_dir") / "snapdir"
    argv = [a for a in snapshot_argv if not a.startswith("trainer_config.snapshot_path")]
    argv.append(f"trainer_config.snapshot_path={dirsnap}")
    assert t_train.main(["--device", "cpu", *argv, "trainer_config.batch_size=8",
                         "trainer_config.max_steps=3", "trainer_config.eval_batches=1"]) == 0
    return argv


def _dir_snapshot(argv):
    return next(a.split("=", 1)[1] for a in argv
                if a.startswith("trainer_config.snapshot_path="))


def test_sample_cli_restores_either_snapshot_format(snapshot_argv, dir_snapshot_argv,
                                                   capsys):
    """sample.py with neither --params nor --random-init loads the
    trainer's snapshot, as the JAX sample.py does: the one-file and the
    directory snapshot of the same run give the same greedy text; no
    snapshot exits 1."""
    from mingpt_distributed_tpu_torch import sample as t_sample

    texts = []
    for argv in (snapshot_argv, dir_snapshot_argv):
        assert t_sample.main(["--device", "cpu", "--greedy", "--prompt", "the ",
                              "--max-new-tokens", "8", *argv]) == 0
        out = capsys.readouterr()
        assert "loaded snapshot step 3" in out.err
        texts.append(out.out)
    assert texts[0] == texts[1] and texts[0].startswith("the ")
    none = [a for a in snapshot_argv if not a.startswith("trainer_config.snapshot_path")]
    assert t_sample.main(["--device", "cpu", "--max-new-tokens", "2", *none,
                          "trainer_config.snapshot_path=/nonexistent/snap.pt"]) == 1
    assert "no snapshot at" in capsys.readouterr().err


def test_restore_inference_params(snapshot_argv, dir_snapshot_argv, tmp_path):
    exp = load_config(snapshot_argv[1], snapshot_argv[2:])
    ds = CharDataset(exp.data_config)
    cfg = dataclasses.replace(exp.gpt_config, vocab_size=ds.vocab_size,
                              block_size=ds.block_size)
    snap = ckpt.restore_inference_params(exp.trainer_config.snapshot_path, cfg, "cpu")
    assert snap.step == 3 and snap.params["wte"].shape == (ds.vocab_size, 64)
    assert ckpt.restore_inference_params(str(tmp_path / "none.pt"), cfg, "cpu") is None
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore_inference_params(exp.trainer_config.snapshot_path,
                                      dataclasses.replace(cfg, n_embd=32), "cpu")
    # a directory is the sharded backend: an empty one holds no snapshot, and
    # the same 3-step run saved there restores the same parameters
    assert ckpt.restore_inference_params(str(tmp_path), cfg, "cpu") is None
    dirsnap = _dir_snapshot(dir_snapshot_argv)
    got = ckpt.restore_inference_params(dirsnap, cfg, "cpu")
    assert got.step == 3
    from mingpt_distributed_tpu_torch.models import convert

    want = convert.flatten(snap.params)
    assert set(convert.flatten(got.params)) == set(want)
    for name, p in convert.flatten(got.params).items():
        assert torch.equal(p, want[name]), name
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore_inference_params(dirsnap, dataclasses.replace(cfg, n_embd=32), "cpu")
