"""The port's speculative decoding against the JAX package's.

The cases of tests/test_serving.py's speculation block on the port's
``InferenceServer``, each on parameters converted from the same JAX pytree:
the identical draft (every proposal accepted, one verify shape), a
1-layer draft whose rejections roll back, EOS and a deadline landing
mid-burst (both pools freed), sampled lanes and the window tail taking the
plain step, chunked prefill with prefix reuse, a broken slot mirror and
the constructor's validation. Where the JAX server can run the same
traffic, the port's greedy tokens and per-request ``spec_proposed`` /
``spec_accepted`` must equal JAX's exactly. CPU, tiny config (2 layers, 2
heads, 32 wide, V = 50, block 32, fp32).
"""

import dataclasses

import jax
import numpy as np
import pytest

from mingpt_distributed_tpu.config import GPTConfig as JConfig
from mingpt_distributed_tpu.models import gpt as j_gpt
from mingpt_distributed_tpu.serving import InferenceServer as JServer
from mingpt_distributed_tpu.serving import Request as JRequest
from mingpt_distributed_tpu_torch.config import GPTConfig
from mingpt_distributed_tpu_torch.models import convert
from mingpt_distributed_tpu_torch.models import generate as gen
from mingpt_distributed_tpu_torch.serve import first_layers
from mingpt_distributed_tpu_torch.serving import InferenceServer, Request
from mingpt_distributed_tpu_torch.serving.speculative import SpeculativeDecoder
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

TINY = dict(n_layer=2, n_head=2, n_embd=32, vocab_size=50, block_size=32,
            embd_pdrop=0.0, resid_pdrop=0.0, attn_pdrop=0.0, dtype="float32")
PROMPTS = [[1, 2, 3, 4, 5], [7, 8, 9], [10, 11, 12, 13], [40, 41], [20, 21, 22]]


@pytest.fixture(scope="module")
def both():
    """(JAX cfg, JAX params, port cfg, port params on the CPU)."""
    jcfg, tcfg = JConfig.make(**TINY), GPTConfig.make(**TINY)
    tree = j_gpt.init(jax.random.key(0), jcfg)
    return jcfg, tree, tcfg, convert.params_from_numpy(
        jax.tree.map(np.array, tree), tcfg, "cpu")


def solo_greedy(params, cfg, prompt, n):
    out = gen.generate(params, cfg, [prompt], n, device="cpu")
    return out[0, len(prompt):].tolist()


def drafts(both, n_layer=None):
    """(JAX draft params, JAX draft cfg, port draft params, port draft cfg):
    the targets themselves, or their first ``n_layer`` layers."""
    jcfg, tree, tcfg, params = both
    if n_layer is None:
        return tree, jcfg, params, tcfg
    jd = dict(tree)
    jd["blocks"] = jax.tree.map(lambda a: a[:n_layer], tree["blocks"])
    return (jd, dataclasses.replace(jcfg, n_layer=n_layer),
            first_layers(params, n_layer), dataclasses.replace(tcfg, n_layer=n_layer))


def servers(both, n_layer=None, **opts):
    """The JAX and the port's speculative servers on the same weights."""
    jcfg, tree, tcfg, params = both
    jd, jdc, td, tdc = drafts(both, n_layer)
    js = JServer(tree, jcfg, draft_params=jd, draft_cfg=jdc, **opts)
    ts = InferenceServer(params, tcfg, draft_params=td, draft_cfg=tdc,
                         device="cpu", **opts)
    return js, ts


def run_both(js, ts, reqs, stagger=False):
    """Submit ``(prompt, max_new)`` pairs to both servers (one round apart
    with ``stagger``) and drain them; the handles of each."""
    jh, th = [], []
    for p, n in reqs:
        jh.append(js.submit(JRequest(prompt=p, max_new_tokens=n)))
        th.append(ts.submit(Request(prompt=p, max_new_tokens=n)))
        if stagger:
            js.step()
            ts.step()
    js.run_until_drained(max_steps=200)
    ts.run_until_drained(max_steps=200)
    return jh, th


def assert_same_as_jax(jh, th):
    for a, b in zip(jh, th):
        assert b.tokens == a.tokens, b.request_id
        assert (b.spec_proposed, b.spec_accepted) == (a.spec_proposed, a.spec_accepted)


def test_identical_draft_parity_and_one_verify_shape(both):
    """Draft == target: every proposal is accepted, every burst is k+1
    tokens, tokens equal solo generate and the JAX server's, and the run
    has one verify shape and one draft decode shape."""
    _, _, tcfg, params = both
    js, ts = servers(both, n_slots=3, warmup=True, spec_k=3)
    reqs = [(p, 10) for p in PROMPTS[:3]]
    jh, th = run_both(js, ts, reqs, stagger=True)
    assert_same_as_jax(jh, th)
    for (p, n), h in zip(reqs, th):
        assert h.tokens == solo_greedy(params, tcfg, p, n)
        assert h.spec_proposed > 0 and h.spec_accepted == h.spec_proposed
    counts = ts.compile_counts()
    assert set(counts) == {"prefill", "decode", "prefix_load", "prefix_save",
                           "verify", "draft_prefill", "draft_decode"}
    assert counts["prefill"] == counts["decode"] == counts["verify"] == 1
    assert counts["draft_prefill"] == counts["draft_decode"] == 1
    m = ts.metrics
    assert m.spec_rounds > 0 and m.spec_accept_rate == 1.0
    assert m.spec_tokens_per_verify_mean == 4.0
    assert m.spec_rounds == js.metrics.spec_rounds


def test_distinct_draft_rejections_roll_back_exactly(both):
    """The target's first layer as draft: proposals are rejected, the
    rejected rows go stale on both engines, and the tokens still equal solo
    generate and the JAX server's, with the same counts per request."""
    _, _, tcfg, params = both
    js, ts = servers(both, n_layer=1, n_slots=4, warmup=True, spec_k=3)
    reqs = [(p, 8) for p in PROMPTS[:4]]
    jh, th = run_both(js, ts, reqs)
    assert_same_as_jax(jh, th)
    for (p, n), h in zip(reqs, th):
        assert h.tokens == solo_greedy(params, tcfg, p, n)
    m = ts.metrics
    assert 0 < m.spec_accepted < m.spec_proposed
    assert m.spec_accepted == js.metrics.spec_accepted
    counts = ts.compile_counts()
    assert counts["verify"] == 1 and counts["draft_decode"] == 1


@pytest.mark.parametrize("k", [1, 2, 4])
def test_greedy_tokens_equal_the_plain_server_at_every_k(both, k):
    """The speculative server's greedy tokens equal the port's plain greedy
    server's whatever k (the 1-layer draft), and the JAX speculative
    server's with the same proposed/accepted counts per request."""
    _, _, tcfg, params = both
    reqs = [(p, 9) for p in PROMPTS]
    plain = InferenceServer(params, tcfg, n_slots=3, device="cpu")
    want = plain.generate_batch([Request(prompt=p, max_new_tokens=n) for p, n in reqs])
    js, ts = servers(both, n_layer=1, n_slots=3, spec_k=k)
    jh, th = run_both(js, ts, reqs)
    assert_same_as_jax(jh, th)
    assert [h.tokens for h in th] == [h.tokens for h in want]


def test_eos_mid_burst_truncates_and_frees_both_pools(both):
    """EOS inside an accepted burst: the tail after it is never streamed,
    the request retires as "eos" and both the target and the draft slot
    free."""
    _, _, tcfg, params = both
    solo = solo_greedy(params, tcfg, PROMPTS[0], 12)
    # bursts of k + 1 = 4 emit indices 1-4, 5-8, 9-12 after the prefill's
    # index 0: an EOS whose first occurrence is not a burst's last index
    idx = next(i for i in (1, 2, 3, 5, 6, 7, 9, 10, 11) if solo.index(solo[i]) == i)
    js, ts = servers(both, n_slots=2, warmup=True, spec_k=3)
    jh = js.submit(JRequest(prompt=PROMPTS[0], max_new_tokens=12, eos_id=solo[idx]))
    th = ts.submit(Request(prompt=PROMPTS[0], max_new_tokens=12, eos_id=solo[idx]))
    js.run_until_drained(max_steps=100)
    ts.run_until_drained(max_steps=100)
    assert th.finish_reason == jh.finish_reason == "eos"
    assert th.tokens == jh.tokens == solo[:idx + 1]
    assert ts.engine.pool.free_count == 2
    assert ts.spec.draft.engine.pool.free_count == 2


def test_deadline_mid_burst_frees_both_pools(both):
    """A deadline passing between two tokens of one burst: the burst's tail
    is dropped, the request expires and both pools free in that round."""
    _, _, tcfg, params = both
    solo = solo_greedy(params, tcfg, PROMPTS[0], 12)
    t = {"now": 0.0}

    def on_token(handle, tok):
        # the clock jumps past the deadline after the 3rd token: the burst
        # of indices 1-4 is cut after index 2 by the mid-burst check
        if len(handle.tokens) == 3:
            t["now"] = 100.0

    ts = InferenceServer(params, tcfg, n_slots=2, warmup=True, device="cpu",
                         clock=lambda: t["now"], on_token=on_token,
                         draft_params=params, draft_cfg=tcfg, spec_k=3)
    h = ts.submit(Request(prompt=PROMPTS[0], max_new_tokens=12, deadline_s=5.0))
    ts.run_until_drained(max_steps=100)
    assert h.finish_reason == "deadline"
    assert h.tokens == solo[:3]
    assert ts.engine.pool.free_count == 2
    assert ts.spec.draft.engine.pool.free_count == 2
    assert ts.metrics.requests_expired == 1


def test_sampled_lane_takes_the_plain_step(both):
    """Sampled lanes never speculate and share rounds with speculating
    greedy lanes: the sampled stream equals the plain server's for its
    seed, the greedy one solo generate's."""
    _, _, tcfg, params = both
    sampled = Request(prompt=PROMPTS[1], max_new_tokens=8, do_sample=True,
                      temperature=0.9, top_k=20, seed=7)
    plain = InferenceServer(params, tcfg, n_slots=2, device="cpu")
    want = plain.generate_batch([dataclasses.replace(sampled)])[0]
    ts = InferenceServer(params, tcfg, n_slots=2, warmup=True, device="cpu",
                         draft_params=params, draft_cfg=tcfg, spec_k=3)
    h_greedy = ts.submit(Request(prompt=PROMPTS[0], max_new_tokens=8))
    h_sampled = ts.submit(dataclasses.replace(sampled))
    ts.run_until_drained(max_steps=100)
    assert h_greedy.tokens == solo_greedy(params, tcfg, PROMPTS[0], 8)
    assert h_sampled.tokens == want.tokens
    assert h_sampled.spec_proposed == 0 and h_greedy.spec_proposed > 0


def test_window_tail_falls_back_to_the_plain_step(both):
    """Without room for k+1 verify rows near the window's end the lane
    takes the plain step; tokens equal solo generate and the JAX server's,
    one decode shape and one verify shape."""
    _, _, tcfg, params = both
    prompt = list(range(1, 26))  # positions from 25, block 32
    js, ts = servers(both, n_slots=1, spec_k=2)
    jh, th = run_both(js, ts, [(prompt, 8)])
    assert_same_as_jax(jh, th)
    assert th[0].tokens == solo_greedy(params, tcfg, prompt, 8)
    counts = ts.compile_counts()
    assert counts["prefill"] == counts["decode"] == counts["verify"] == 1
    assert counts["draft_prefill"] == counts["draft_decode"] == 1
    assert 0 < th[0].spec_accepted <= th[0].spec_proposed


def test_chunked_prefill_and_prefix_reuse(both):
    """Speculation with chunked prefill and shared-prefix reuse: tokens
    equal solo generate and the JAX server's, one verify shape."""
    _, _, tcfg, params = both
    js, ts = servers(both, n_slots=2, prefill_chunk=4, prefix_cache_mb=1.0,
                     prefill_buckets=(4, 8, 16, 32), warmup=True, spec_k=3)
    shared = [5, 6, 7, 8, 9, 10, 11, 12]
    prompts = [shared + [13], shared + [14], PROMPTS[0]]
    # the first twin's prefix is saved before the second's lookup
    jh0, th0 = run_both(js, ts, [(prompts[0], 6)])
    jh, th = run_both(js, ts, [(p, 6) for p in prompts[1:]])
    assert_same_as_jax(jh0 + jh, th0 + th)
    for p, h in zip(prompts, th0 + th):
        assert h.tokens == solo_greedy(params, tcfg, p, 6)
    assert ts.metrics.prefix_hits == js.metrics.prefix_hits >= 1
    counts = ts.compile_counts()
    assert counts["verify"] == 1 and counts["draft_decode"] == 1
    assert counts["prefill"] <= 4 and counts["draft_prefill"] <= 4


def test_slot_mirror_breakage_fails_loudly(both):
    """A draft pool whose indices drifted from the target's raises instead
    of attending the wrong lane."""
    _, _, tcfg, params = both
    ts = InferenceServer(params, tcfg, n_slots=2, device="cpu",
                         draft_params=params, draft_cfg=tcfg, spec_k=2)
    ts.spec.draft.engine.pool.allocate()  # steal draft slot 0
    with pytest.raises(RuntimeError, match="mirror"):
        ts.generate_batch([Request(prompt=PROMPTS[0], max_new_tokens=2)])


def test_constructor_validation(both):
    _, _, tcfg, params = both
    with pytest.raises(ValueError):  # spec_k without a draft model
        InferenceServer(params, tcfg, spec_k=2, device="cpu")
    with pytest.raises(ValueError):  # draft params without their config
        InferenceServer(params, tcfg, draft_params=params, spec_k=2, device="cpu")
    with pytest.raises(ValueError):  # k = 0 is "off", not a tiny burst
        InferenceServer(params, tcfg, draft_params=params, draft_cfg=tcfg,
                        spec_k=0, device="cpu")
    small = dataclasses.replace(tcfg, block_size=16)
    with pytest.raises(ValueError):  # the draft's window must cover the target's
        InferenceServer(params, tcfg, draft_params=params, draft_cfg=small,
                        spec_k=2, device="cpu")
    with pytest.raises(ValueError):  # no room for the bonus row
        InferenceServer(params, tcfg, draft_params=params, draft_cfg=tcfg,
                        spec_k=32, device="cpu")


def test_migration_and_attribution_raise_naming_their_items(both):
    """The draft-row migration seam runs now (the tests below), and the
    audit contracts cover every family ``register_attrib`` registers:
    verify with the target prefill's contract, the draft engine's under
    the ``draft_`` prefix."""
    _, _, tcfg, params = both
    ts = InferenceServer(params, tcfg, n_slots=1, device="cpu",
                         draft_params=params, draft_cfg=tcfg, spec_k=2)
    spec: SpeculativeDecoder = ts.spec
    assert spec.pending_draft == {} and spec.pending_draft_cap == 32
    from mingpt_distributed_tpu_torch.telemetry import MetricsRegistry, ProgramLedger

    ledger = ProgramLedger(registry=MetricsRegistry())
    spec.register_attrib(ledger)
    contracts = spec.audit_contracts()
    assert {r["family"] for r in ledger.rows()} <= set(contracts)
    assert contracts["verify"]["donated"] == len(ts.engine.pool.cache)
    assert contracts["verify"]["host_transfers"] == 2
    assert contracts["draft_decode"] == spec.draft.engine.audit_contracts()["decode"]


MIGRATE = list(range(3, 20))  # 17 tokens: target rows 16, draft rows 16


def _migrate(server_cls, request_cls, params, cfg, dparams, dcfg, **place):
    """A request primed on a source server, its target rows adopted into a
    fresh server's prefix store and its draft rows parked on that server's
    speculative decoder; the request then served there. Returns the
    source's and the destination's tokens, the rows moved, the entries and
    the destination's speculation counters."""
    opts = dict(n_slots=2, prefill_buckets=(8, 16, 32), draft_params=dparams,
                draft_cfg=dcfg, spec_k=3, **place)
    src = server_cls(params, cfg, **opts)
    h = src.submit(request_cls(prompt=MIGRATE, max_new_tokens=8))
    while h.prefilling or h.slot is None:
        src.step()
    rows = src.engine.migratable_rows(len(MIGRATE), h.prefill_pos)
    drows = src.spec.migratable_draft_rows(len(MIGRATE))
    entry = src.engine.extract_slot_rows(h.slot, rows)
    dentry = src.spec.extract_draft_rows(h.slot, drows)
    src.run_until_drained()
    dst = server_cls(params, cfg, prefix_cache_mb=1.0, **opts)
    adopted = (dst.engine.adopt_prefix_entry(MIGRATE[:rows], entry),
               dst.spec.adopt_draft_rows(MIGRATE[:drows], dentry),
               dst.spec.adopt_draft_rows(MIGRATE[:drows], dentry))  # parked once
    h2 = dst.generate_batch([request_cls(prompt=MIGRATE, max_new_tokens=8)])[0]
    return dict(tokens=(h.tokens, h2.tokens), rows=(rows, drows), adopted=adopted,
                entry={n: np.asarray(a) for n, a in entry.items()},
                dentry={n: np.asarray(a) for n, a in dentry.items()},
                prefix_rows=h2.prefix_rows, spec=(h2.spec_proposed, h2.spec_accepted),
                prime=(dst.spec.prime_adopted, dst.spec.prime_full,
                       len(dst.spec.pending_draft)))


@pytest.mark.parametrize("n_layer", [None, 1], ids=["self", "self:1"])
def test_draft_rows_migrate_and_prime_adopted_like_jax(both, n_layer):
    """The migration seam in-process, draft rows included: the same buckets
    chosen by both packages (target 16 = one short of 17 tokens on the
    ladder, draft 16 = the ladder bucket <= 17), rows within 1e-5 of JAX's,
    the adopted prefix hit, the parked draft rows consumed by an "adopted"
    prime, and the same greedy continuation and speculation counters as the
    source server and as JAX's destination."""
    jcfg, tree, tcfg, params = both
    jd, jdc, td, tdc = drafts(both, n_layer)
    ours = _migrate(InferenceServer, Request, params, tcfg, td, tdc, device="cpu")
    theirs = _migrate(JServer, JRequest, tree, jcfg, jd, jdc)
    assert ours["rows"] == theirs["rows"] == (16, 16)
    assert ours["adopted"] == theirs["adopted"] == (True, True, False)
    for name in ("entry", "dentry"):
        assert sorted(ours[name]) == sorted(theirs[name]) == ["k", "v"]
        for leaf in ours[name]:
            np.testing.assert_allclose(ours[name][leaf], theirs[name][leaf], atol=1e-5)
    src_tokens, dst_tokens = ours["tokens"]
    assert src_tokens == dst_tokens == solo_greedy(params, tcfg, MIGRATE, 8)
    assert ours["tokens"] == theirs["tokens"]
    assert ours["prefix_rows"] == theirs["prefix_rows"] == 16
    assert ours["spec"] == theirs["spec"]
    assert ours["prime"] == theirs["prime"] == (1, 0, 0)


def test_pending_draft_is_a_bounded_fifo(both):
    _, _, tcfg, params = both
    ts = InferenceServer(params, tcfg, n_slots=1, device="cpu", draft_params=params,
                         draft_cfg=tcfg, spec_k=2, prefill_buckets=(8, 16, 32))
    spec = ts.spec
    entry = spec.extract_draft_rows(0, 8)
    for i in range(spec.pending_draft_cap + 3):
        assert spec.adopt_draft_rows([i] * 8, entry)
    assert len(spec.pending_draft) == spec.pending_draft_cap
    assert (0,) * 8 not in spec.pending_draft  # the oldest left first
    assert (spec.pending_draft_cap + 2,) * 8 in spec.pending_draft
    with pytest.raises(ValueError, match="bucket ladder"):
        spec.extract_draft_rows(0, 7)
    with pytest.raises(ValueError, match="recast"):
        spec.adopt_draft_rows([99] * 8, {n: a.double() for n, a in entry.items()})


def test_spec_gate_off_is_token_exact(both):
    """``spec_enabled = False`` sends every lane to the plain step; the
    tokens are unchanged and no verify round runs while it is off."""
    _, _, tcfg, params = both
    ts = InferenceServer(params, tcfg, n_slots=2, device="cpu",
                         draft_params=params, draft_cfg=tcfg, spec_k=3)
    ts.spec_enabled = False
    h = ts.generate_batch([Request(prompt=PROMPTS[2], max_new_tokens=7)])[0]
    assert h.tokens == solo_greedy(params, tcfg, PROMPTS[2], 7)
    assert ts.metrics.spec_rounds == 0 and h.spec_proposed == 0


def test_spec_metrics_page_matches_the_jax_server(both):
    """The same traffic through both speculative servers gives the same
    mingpt_serve_spec_* samples on the exposition page."""
    from mingpt_distributed_tpu import telemetry as j_tel
    from mingpt_distributed_tpu_torch import telemetry as t_tel

    jcfg, tree, tcfg, params = both
    jreg, treg = j_tel.MetricsRegistry(), t_tel.MetricsRegistry()
    jd, jdc, td, tdc = drafts(both, 1)
    js = JServer(tree, jcfg, n_slots=2, registry=jreg, draft_params=jd,
                 draft_cfg=jdc, spec_k=2)
    ts = InferenceServer(params, tcfg, n_slots=2, registry=treg, device="cpu",
                         draft_params=td, draft_cfg=tdc, spec_k=2)
    run_both(js, ts, [(p, 6) for p in PROMPTS[:3]])

    def spec_samples(page, parse):
        return {(n, tuple(sorted(lb.items()))): v for n, lb, v in parse(page)["samples"]
                if "_spec_" in n}

    got = spec_samples(t_tel.render_prometheus(treg), t_tel.parse_prometheus)
    want = spec_samples(j_tel.render_prometheus(jreg), j_tel.parse_prometheus)
    assert got == pytest.approx(want) and got
