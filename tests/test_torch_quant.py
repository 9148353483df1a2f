"""The port's quantized KV pool against the JAX package's.

* ``quantize``/``dequantize`` payloads and scales bit-equal to JAX's on
  seeded data at int8 and fp8, over the exponent range where XLA's CPU
  ``exp2`` is exact at integers ([-12, 12]: amax from ~3e-2 to ~5e5 at
  int8); outside it, and where ``amax / qmax`` is exactly a power of two
  that XLA's ``log2`` misses, the tests state what each package gives;
* three dequantize/quantize round trips bit-identical (int8), and fp8's
  one-time renormalisation of a row whose largest payload rounds to
  ``qmax / 2``, the same in both packages;
* the port's engine quantizes only the rows a call writes, the JAX engine
  requantizes the whole slot lane after every prefill, decode and verify
  forward: the pools are compared after each, bit for bit at int8;
* the int8 server of tests/test_quant.py:127 (chunked prefill, prefix
  reuse and a 1-layer draft) against the fp32 server and against the JAX
  int8 server; ``serve.py --selftest-quant`` and two planted faults.

CPU, fp32, tiny configs.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mingpt_distributed_tpu.config import GPTConfig as JConfig
from mingpt_distributed_tpu.models import gpt as j_gpt
from mingpt_distributed_tpu.serving import InferenceServer as JServer
from mingpt_distributed_tpu.serving import Request as JRequest
from mingpt_distributed_tpu.serving import quant as jq
from mingpt_distributed_tpu.serving.engine import DecodeEngine as JEngine
from mingpt_distributed_tpu.serving.speculative import SpeculativeDecoder as JSpec
from mingpt_distributed_tpu_torch import serve as t_serve
from mingpt_distributed_tpu_torch.config import GPTConfig
from mingpt_distributed_tpu_torch.models import convert
from mingpt_distributed_tpu_torch.models import generate as gen
from mingpt_distributed_tpu_torch.serving import InferenceServer, Request
from mingpt_distributed_tpu_torch.serving import quant as tq
from mingpt_distributed_tpu_torch.serving.engine import DecodeEngine
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

TINY = dict(n_layer=2, n_head=2, n_embd=32, vocab_size=50, block_size=32,
            embd_pdrop=0.0, resid_pdrop=0.0, attn_pdrop=0.0, dtype="float32")
DTYPES = ["int8", "fp8"]
# XLA's CPU exp2 returns exactly 2^k for integer k in [-12, 12] (and some
# others); outside it the JAX scale is not a power of two
JAX_EXACT_EXP2 = range(-12, 13)


@pytest.fixture(scope="module")
def both():
    jcfg, tcfg = JConfig.make(**TINY), GPTConfig.make(**TINY)
    tree = j_gpt.init(jax.random.key(0), jcfg)
    return jcfg, tree, tcfg, convert.params_from_numpy(
        jax.tree.map(np.array, tree), tcfg, "cpu")


def seeded(seed, shape=(3, 4, 16, 2, 16)):
    """Rows of standard normals, each scaled by 10^u with u uniform in
    [-1, 3]: amax / qmax spans exponents -12 .. 5 at int8 and fp8."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape)
    return (x * 10.0 ** rng.uniform(-1, 3, shape[:-1] + (1,))).astype(np.float32)


def jax_quantize(x, name):
    p, s = jq.quantize(jnp.asarray(x), jq.resolve_kv_dtype(name))
    return np.asarray(p.astype(jnp.float32)), np.asarray(s)


def port_quantize(x, name):
    p, s = tq.quantize(torch.from_numpy(np.asarray(x)), tq.resolve_kv_dtype(name))
    return p.float().numpy(), s.numpy()


# ---------------------------------------------------------------------------
# units
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", DTYPES)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantize_and_dequantize_bit_equal_to_jax(name, seed):
    x = seeded(seed)
    exps = np.log2(port_quantize(x, name)[1][port_quantize(x, name)[1] > 0])
    assert set(exps.astype(int)) <= set(JAX_EXACT_EXP2) and len(set(exps)) > 10
    jp, js = jax_quantize(x, name)
    tp, ts = port_quantize(x, name)
    assert np.array_equal(tp, jp) and np.array_equal(ts, js)
    q = tq.resolve_kv_dtype(name)
    payload, scale = tq.quantize(torch.from_numpy(x), q)
    jpay, jsc = jq.quantize(jnp.asarray(x), jq.resolve_kv_dtype(name))
    assert np.array_equal(tq.dequantize(payload, scale).numpy(),
                          np.asarray(jq.dequantize(jpay, jsc)))
    assert payload.dtype == q.qdtype and scale.dtype == torch.float32
    assert scale.shape == x.shape[:-1] + (1,)


def test_int8_three_round_trips_bit_identical():
    q = tq.resolve_kv_dtype("int8")
    p, s = tq.quantize(torch.from_numpy(seeded(3)), q)
    for _ in range(3):
        p2, s2 = tq.quantize(tq.dequantize(p, s), q)
        assert torch.equal(p2, p) and torch.equal(s2, s)
        p, s = p2, s2
    nz = s[s > 0]
    assert torch.equal(torch.exp2(torch.round(torch.log2(nz))), nz)


def test_fp8_round_trips_keep_values_and_renormalise_once_like_jax():
    """fp8 rounds (224, 232] to 224 = qmax / 2: such a row re-derives half
    the scale on its first requantization (payload doubled, the same
    values) and is stable from then on, in both packages."""
    x = seeded(4)
    q, jqq = tq.resolve_kv_dtype("fp8"), jq.resolve_kv_dtype("fp8")
    p0, s0 = tq.quantize(torch.from_numpy(x), q)
    p1, s1 = tq.quantize(tq.dequantize(p0, s0), q)
    assert torch.equal(tq.dequantize(p1, s1), tq.dequantize(p0, s0))
    moved = (s1 != s0)[..., 0]
    assert moved.any() and bool((s1[moved] == s0[moved] / 2).all())
    assert bool((p0.float().abs().amax(-1)[moved] == q.qmax / 2).all())
    assert not (p0.float().abs().amax(-1)[~moved] == q.qmax / 2).any()
    for _ in range(2):
        p2, s2 = tq.quantize(tq.dequantize(p1, s1), q)
        assert torch.equal(p2.float(), p1.float()) and torch.equal(s2, s1)
    jp0, js0 = jq.quantize(jnp.asarray(x), jqq)
    jp1, js1 = jq.quantize(jq.dequantize(jp0, js0), jqq)
    assert np.array_equal(np.asarray(js1), s1.numpy())
    assert np.array_equal(np.asarray(jp1.astype(jnp.float32)), p1.float().numpy())


@pytest.mark.parametrize("k", [-30, -27, -26, -15, -13])
def test_power_of_two_ratio_each_package(k):
    """amax / qmax exactly 2^k where XLA's CPU log2 returns k - 2e-6: the
    port's scale is 2^k and the row's largest payload 127; the JAX
    package's scale is about 2^(k+1) (its ceil lands one up) and that
    payload 64, so its round trip is not the exact fixed point."""
    amax = np.float32(127.0 * 2.0 ** k)
    x = np.zeros((1, 16), np.float32)
    x[0, 0], x[0, 1] = amax, -amax / 3
    tp, ts = port_quantize(x, "int8")
    jp, js = jax_quantize(x, "int8")
    assert ts[0, 0] == 2.0 ** k and tp[0, 0] == 127
    assert js[0, 0] == pytest.approx(2.0 ** (k + 1), rel=1e-5) and jp[0, 0] == 64
    assert float(np.log2(np.float32(2.0 ** k))) == k  # numpy's log2 is exact


@pytest.mark.parametrize("k", [13, 15, 17, 21, -16, -20])
def test_scale_outside_the_exact_exp2_range_each_package(k):
    """Where XLA's CPU exp2 is not exact at the integer exponent the JAX
    scale is not a power of two (within 1e-5 of it); the port's is."""
    x = np.zeros((1, 16), np.float32)
    x[0, 0] = np.float32(127.0 * 2.0 ** k * 0.75)  # exponent k exactly
    _, ts = port_quantize(x, "int8")
    _, js = jax_quantize(x, "int8")
    assert ts[0, 0] == 2.0 ** k
    assert js[0, 0] != 2.0 ** k and js[0, 0] == pytest.approx(2.0 ** k, rel=1e-5)


def test_quantize_error_bounded_by_half_scale_and_zero_rows():
    x = torch.from_numpy(seeded(5))
    q = tq.resolve_kv_dtype("int8")
    p, s = tq.quantize(x, q)
    assert bool(((tq.dequantize(p, s) - x).abs() <= s / 2).all())
    z = torch.zeros(2, 5, 16)
    pz, sz = tq.quantize(z, q)
    assert not pz.any() and not sz.any() and not tq.dequantize(pz, sz).any()


@pytest.mark.parametrize("name", DTYPES)
def test_quantize_weight_per_output_channel_like_jax(name):
    w = (np.random.default_rng(6).standard_normal((3, 8, 24)) * 0.1).astype(np.float32)
    p, s = tq.quantize_weight(torch.from_numpy(w), tq.resolve_kv_dtype(name))
    jp, js = jq.quantize_weight(jnp.asarray(w), jq.resolve_kv_dtype(name))
    assert p.shape == w.shape and s.shape == (1, 1, 24)
    assert np.array_equal(p.float().numpy(), np.asarray(jp.astype(jnp.float32)))
    assert np.array_equal(s.numpy(), np.asarray(js))


def test_resolve_kv_dtype_vocabulary():
    assert tq.resolve_kv_dtype(None) is None and tq.resolve_kv_dtype("fp32") is None
    q = tq.resolve_kv_dtype("int8")
    assert q.name == "int8" and q.qmax == 127.0 and tq.resolve_kv_dtype(q) is q
    f = tq.resolve_kv_dtype("fp8")
    assert f.qdtype == torch.float8_e4m3fn and f.qmax == 448.0
    with pytest.raises(ValueError, match="unknown kv_dtype"):
        tq.resolve_kv_dtype("int4")


def test_fp8_raises_without_float8(monkeypatch):
    monkeypatch.setattr(tq, "fp8_dtype", lambda: None)
    with pytest.raises(ValueError, match="float8_e4m3fn"):
        tq.resolve_kv_dtype("fp8")


def test_int8_pool_bytes_at_head_dim_64():
    """int8 payload + fp32 scales = (hd + 4) / (4 hd) = 0.2656x the fp32
    pool at head_dim 64; the scale planes are exactly scale_bytes."""
    cfg = GPTConfig.make(n_layer=2, n_head=4, n_embd=256, vocab_size=96,
                         block_size=48, dtype="float32")
    fp32 = gen.init_cache(cfg, 2, torch.device("cpu"))
    q = tq.init_quant_cache(cfg, 2, tq.resolve_kv_dtype("int8"))
    data, scales = tq.split_scales(q)
    assert sorted(data) == ["k", "v"] and sorted(scales) == ["k_scale", "v_scale"]
    assert tq.data_names(q) == ("k", "v")
    assert t_serve.pool_bytes(q) / t_serve.pool_bytes(fp32) == pytest.approx(68 / 256)
    assert t_serve.pool_bytes(scales) == tq.scale_bytes(cfg, 2)


@pytest.mark.parametrize("name", DTYPES)
def test_max_abs_logit_error_matches_jax(both, name):
    jcfg, tree, tcfg, params = both
    toks = [3, 9, 14, 2, 7, 30, 11, 5, 22]
    got = tq.max_abs_logit_error(params, tcfg, toks, tq.resolve_kv_dtype(name))
    want = jq.max_abs_logit_error(tree, jcfg, toks, jq.resolve_kv_dtype(name))
    assert 0 < got < 0.5 and got == pytest.approx(want, abs=1e-5)


# ---------------------------------------------------------------------------
# the pool: rows-only quantization against JAX's whole-lane requantization
# ---------------------------------------------------------------------------


def _pools(jeng, teng):
    return ({n: np.asarray(a.astype(jnp.float32)) for n, a in jeng.pool.cache.items()},
            {n: a.float().numpy() for n, a in teng.pool.cache.items()})


def _row_diffs(jp, tp):
    """(layer, slot, row, head) of every stored row whose payload or scale
    differs between the two pools."""
    out = set()
    for n in ("k", "v"):
        bad = (jp[n] != tp[n]).any(-1) | (jp[n + "_scale"] != tp[n + "_scale"])[..., 0]
        out |= {tuple(int(i) for i in r) for r in np.argwhere(bad)}
    return out


def _jax_scale_hits_the_log2_case(jp, row):
    """Whether JAX's scale of ``row`` is not the exact power of two the
    payload's amax asks for (the log2/exp2 differences above)."""
    for n in ("k", "v"):
        s = jp[n + "_scale"][row][0]
        if s > 0 and float(np.log2(s)) != round(float(np.log2(s))):
            return True
    return False


@pytest.mark.parametrize("name", DTYPES)
def test_pool_after_prefill_decode_and_verify_against_jax(both, name):
    """Chunked prefills at offsets, batched decode steps over 3 slots and
    two verify calls, through both engines on the same weights: after each
    phase the int8 pools are bit-equal (a differing row is reported and
    allowed only where JAX's scale is hit by the log2/exp2 case); the fp8
    pools hold equal values, and a row whose bits differ is one that JAX's
    whole-lane requantization renormalised (its largest payload is 224 in
    the port's pool)."""
    jcfg, tree, tcfg, params = both
    kw = dict(prefill_buckets=(4, 8, 16, 32), kv_dtype=name)
    jeng = JEngine(tree, jcfg, 3, **kw)
    teng = DecodeEngine(params, tcfg, 3, device="cpu", **kw)
    key = jax.random.key(0)
    rng = np.random.default_rng(7)
    reported = []

    def compare(phase):
        jp, tp = _pools(jeng, teng)
        diffs = _row_diffs(jp, tp)
        for n in ("k", "v"):
            jv = jp[n] * jp[n + "_scale"]
            tv = tp[n] * tp[n + "_scale"]
            assert np.array_equal(jv, tv), (phase, n)
        for row in sorted(diffs):
            if name == "int8":
                assert _jax_scale_hits_the_log2_case(jp, row), (phase, row)
            else:
                assert any(np.abs(tp[n][row]).max() == 224.0 for n in ("k", "v")), row
            reported.append((phase, row))

    chunks = [(0, rng.integers(0, 50, 8).tolist(), 0), (0, rng.integers(0, 50, 5).tolist(), 8),
              (1, rng.integers(0, 50, 16).tolist(), 0), (2, rng.integers(0, 50, 3).tolist(), 0)]
    for slot, ids, off in chunks:
        a, _ = jeng.prefill_chunk_call(slot, ids, off, 1.0, None, None, False, key)
        b, _ = teng.prefill_chunk_call(slot, ids, off, 1.0, None, None, False, None)
        assert a == b
    compare("prefill")
    toks = np.array([5, 9, 11])
    pos = np.array([13, 16, 3])
    for _ in range(4):
        s = 3
        a = jeng.decode_step(toks.astype(np.int32), pos.astype(np.int32),
                             np.ones(s, np.float32), np.zeros(s, np.int32),
                             np.ones(s, np.float32), np.zeros(s, bool),
                             jnp.stack([key] * s))
        b = teng.decode_step(toks, pos, np.ones(s, np.float32), np.zeros(s, np.int64),
                             np.ones(s, np.float32), np.zeros(s, bool), [None] * s)
        assert np.array_equal(np.asarray(a), b)
        toks, pos = b, pos + 1
    compare("decode")
    jspec = JSpec(jeng, tree, jcfg, 3)
    for slot, off in ((0, int(pos[0])), (2, int(pos[2]))):
        rows = rng.integers(0, 50, 4).tolist()
        a = jspec.verify(slot, rows, off, 1.0, None, None, key)
        b = teng.verify_call(slot, rows, off, 1.0, None, None)
        assert np.array_equal(np.asarray(a), b)
    compare("verify")
    assert teng.compile_counts() == {"prefill": 3, "decode": 1, "prefix_load": 0,
                                     "prefix_save": 0}
    assert teng.verify_shapes == {4}
    print(f"{name}: rows differing from JAX's whole-lane pool: {reported}")
    if name == "int8":
        assert not reported  # none of this run's scales hit the log2 case


def test_fp32_default_pool_is_the_plain_cache(both):
    _, _, tcfg, params = both
    for kv in (None, "fp32"):
        eng = DecodeEngine(params, tcfg, 2, kv_dtype=kv, device="cpu")
        assert eng.kv_quant is None and eng.kv_dtype == "fp32"
        assert sorted(eng.pool.cache) == ["k", "v"]


# ---------------------------------------------------------------------------
# servers
# ---------------------------------------------------------------------------


def _draft(tree, jcfg, params, tcfg):
    jd = dict(tree)
    jd["blocks"] = jax.tree.map(lambda a: a[:1], tree["blocks"])
    return (jd, dataclasses.replace(jcfg, n_layer=1),
            t_serve.first_layers(params, 1), dataclasses.replace(tcfg, n_layer=1))


SHARED = list(range(3, 20))  # 17 tokens: a 16-row storable prefix
REQS = [(SHARED + [25, 26], 6), ([1, 2, 3, 4, 5], 8), (SHARED + [27], 5)]
OPTS = dict(n_slots=2, prefill_buckets=(4, 8, 16, 32), prefill_chunk=8,
            prefix_cache_mb=8.0, warmup=True, spec_k=3)


@pytest.mark.parametrize("name", DTYPES)
def test_quantized_server_chunked_prefix_and_speculative(both, name):
    """tests/test_quant.py:127's server (chunked prefill, prefix reuse, a
    1-layer draft at k = 3) at int8 and fp8: its tokens equal the JAX
    quantized server's on the same weights; against the fp32 server the
    common greedy prefix is JAX's tolerance (>= 0.6 at head_dim 16), the
    shape counts are equal, both mechanisms run, the pool and its prefix
    entries carry four leaves and the draft mirrors the dtype."""
    jcfg, tree, tcfg, params = both
    jd, jdc, td, tdc = _draft(tree, jcfg, params, tcfg)

    def port(kv):
        srv = InferenceServer(params, tcfg, device="cpu", draft_params=td,
                              draft_cfg=tdc, kv_dtype=kv, **OPTS)
        hs = [srv.submit(Request(prompt=p, max_new_tokens=n)) for p, n in REQS]
        srv.run_until_drained(max_steps=200)
        return srv, [h.tokens for h in hs]

    js = JServer(tree, jcfg, draft_params=jd, draft_cfg=jdc, kv_dtype=name, **OPTS)
    jh = [js.submit(JRequest(prompt=p, max_new_tokens=n)) for p, n in REQS]
    js.run_until_drained(max_steps=200)
    s32, t32 = port("fp32")
    sq, tqk = port(name)
    assert tqk == [h.tokens for h in jh]
    matched = sum(t_serve.common_prefix(a, b) for a, b in zip(t32, tqk))
    assert matched / sum(len(a) for a in t32) >= 0.6
    assert sq.compile_counts() == s32.compile_counts()
    assert sq.metrics.prefix_hits >= 1 and sq.metrics.spec_rounds >= 1
    pool = sq.engine.pool.cache
    assert sorted(pool) == ["k", "k_scale", "v", "v_scale"]
    assert pool["k"].dtype == tq.resolve_kv_dtype(name).qdtype
    assert pool["k_scale"].dtype == torch.float32
    entries = sq.engine.prefix_store.entries()
    assert entries and all(sorted(e) == ["k", "k_scale", "v", "v_scale"]
                           for _, e in entries)
    assert sq.spec.draft.engine.kv_dtype == name
    assert sq.engine.prefix_store.used_bytes == sum(
        t_serve.pool_bytes(e) for _, e in entries)


def test_quantized_server_gauges(both):
    from mingpt_distributed_tpu_torch import telemetry as t_tel

    _, _, tcfg, params = both
    reg = t_tel.MetricsRegistry()
    srv = InferenceServer(params, tcfg, n_slots=1, registry=reg, kv_dtype="int8",
                          device="cpu")
    srv.observe_quant_logit_error(0.125)
    vals = {(n, tuple(sorted(lb.items()))): v for n, lb, v in
            t_tel.parse_prometheus(t_tel.render_prometheus(reg))["samples"]}
    assert vals[("mingpt_serve_kv_dtype", (("kv_dtype", "int8"),))] == 1.0
    assert vals[("mingpt_serve_quant_logit_err_max", ())] == 0.125
    reg32 = t_tel.MetricsRegistry()
    s32 = InferenceServer(params, tcfg, n_slots=1, registry=reg32, device="cpu")
    s32.observe_quant_logit_error(1.0)  # a no-op on an fp32 server
    assert "mingpt_serve_quant_logit_err_max" not in t_tel.render_prometheus(reg32)


def test_selftest_quant_passes(capsys):
    assert t_serve.main(["--selftest-quant", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "selftest-quant PASSED" in out
    assert "[int8] bytes" in out and "[fp8] bytes" in out and "ratio=0.2656" in out


def test_selftest_quant_fails_on_a_non_pow2_scale(monkeypatch, capsys):
    """A scale of amax / qmax (not a power of two) must fail the gate."""
    monkeypatch.setattr(tq, "_pow2_scale",
                        lambda amax, qmax: amax.float() / qmax)
    assert t_serve.main(["--selftest-quant", "--device", "cpu"]) != 0
    assert "not a power of two" in capsys.readouterr().out


def test_selftest_quant_fails_when_the_engine_stores_wrong_rows(monkeypatch, capsys):
    """The engine storing its rows at twice their scale (a fault in the
    serving path, not in the round-trip probe) must fail the parity gate."""
    real = tq.write_layer_rows

    def doubled(cache, layer, offset, k, v, dtype):
        out = real(cache, layer, offset, k, v, dtype)
        for n in ("k_scale", "v_scale"):
            cache[n][layer] *= 2
        return out

    monkeypatch.setattr(tq, "write_layer_rows", doubled)
    assert t_serve.main(["--selftest-quant", "--device", "cpu"]) != 0
    assert "selftest-quant FAILED" in capsys.readouterr().out


@pytest.mark.parametrize("name", DTYPES)
def test_migrated_quantized_rows_resume_bit_identical(both, name):
    """tests/test_quant.py:217 on the port, and at fp8 too: prefill a
    quantized slot, pull its rows through extract_slot_rows (payloads and
    scale planes), install them into a FRESH engine, then decode the same
    tokens on both: the token streams are identical and the final pools
    bit-identical leaf for leaf — migration moves bytes, it never
    requantizes. At int8 the extracted rows also equal the JAX engine's
    bit for bit."""
    jcfg, tree, tcfg, params = both
    if name == "fp8" and tq.fp8_dtype() is None:
        pytest.skip("this torch has no float8_e4m3fn")
    prompt = list(range(5, 21))  # 16 tokens: a ladder bucket

    def engine():
        return DecodeEngine(params, tcfg, n_slots=1, prefill_buckets=(8, 16, 32),
                            kv_dtype=name, device="cpu")

    def decode(eng, tok):
        toks = []
        for i in range(6):
            tok = int(eng.decode_step(np.asarray([tok]), np.asarray([len(prompt) + i]),
                                      np.ones(1, np.float32), np.zeros(1, np.int64),
                                      np.ones(1, np.float32), np.zeros(1, bool), [None])[0])
            toks.append(tok)
        return toks

    src = engine()
    first, _ = src.prefill_chunk_call(0, prompt, 0, 1.0, None, None, False, None)
    entry = src.extract_slot_rows(0, 16)
    assert sorted(entry) == ["k", "k_scale", "v", "v_scale"]
    assert entry["k"].dtype == src.pool.cache["k"].dtype != torch.float32
    dst = engine()
    assert dst.install_slot_rows(0, {n: a.clone() for n, a in entry.items()}) == 16
    assert decode(dst, first) == decode(src, first)
    for leaf in sorted(src.pool.cache):
        assert torch.equal(src.pool.cache[leaf], dst.pool.cache[leaf]), leaf
    if name == "int8":
        jeng = JEngine(tree, jcfg, n_slots=1, prefill_buckets=(8, 16, 32), kv_dtype="int8")
        jeng.prefill_chunk_call(0, prompt, 0, 1.0, None, None, False, jax.random.key(7))
        for leaf, a in jeng.extract_slot_rows(0, 16).items():
            np.testing.assert_array_equal(entry[leaf].numpy(), np.asarray(a))
    with pytest.raises(ValueError, match="recast"):
        dst.install_slot_rows(0, {n: a.float() for n, a in entry.items()})
