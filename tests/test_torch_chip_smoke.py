"""chip_smoke.py's pieces that run without a card: the forward's and the
backward's ring cases cover what the bf16 kernels' pipelines must survive,
the build log parsers read ptxas's resource lines, and the SASS check
expects every bf16 backward instantiation the entry points name."""

import os
import re
import sys
from pathlib import Path

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402

KEYS_PER_TILE = 128  # the bf16 forward's k/v tile (flash_fwd.cu kWgK)
STAGES = 2           # its ring (Tiles<HD>::kStages)


@pytest.mark.parametrize("hd", [16, 32, 64, 128])
def test_ring_cases_cover_every_head_width(hd):
    fwd = [c for c in chip_smoke.FWD_RING_CASES if c[5] == hd]
    lse = [c for c in chip_smoke.LSE_RING_CASES if c[5] == hd]
    tiles = {-(-c[2] // KEYS_PER_TILE) for c in fwd}
    assert {1, 63, 65, 4096} <= {c[2] for c in fwd}
    assert max(tiles) > 2 * STAGES and any(t % 2 for t in tiles if t > STAGES)
    assert any(c[8] == "qkv_view" for c in fwd) and any(c[10] == "qkv_view" for c in lse)
    assert any(c[3] == 12 and c[4] == 4 for c in fwd)  # GQA 12/4
    assert any(c[6] is not None and c[6] < KEYS_PER_TILE for c in fwd)  # a narrow window
    assert any(c[6] and c[9] > 0 for c in lse)  # a causal offset band
    assert any(c[2] > STAGES * KEYS_PER_TILE for c in lse)


def test_ring_cases_have_unique_names():
    for cases in (chip_smoke.KERNEL_CASES + chip_smoke.FWD_RING_CASES,
                  chip_smoke.LSE_CASES + chip_smoke.LSE_RING_CASES,
                  chip_smoke.NH_CASES):
        names = [(c[0], c[-1]) if cases is chip_smoke.NH_CASES else c[0] for c in cases]
        assert len(names) == len(set(names))


def test_fwd_ptxas_reads_registers_spills_and_shared_memory(capsys):
    log = """ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_121flash_fwd_bf16_kernelILi64ELb0ELb0EEEv14CUtensorMap_stS1_S1_NS_6ParamsE' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_121flash_fwd_bf16_kernelILi64ELb0ELb0EEEv14CUtensorMap_stS1_S1_NS_6ParamsE
    8 bytes stack frame, 4 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 1056 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_120flash_fwd_f32_kernelILi16ELb1ELb0EEEvNS_6ParamsE' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_120flash_fwd_f32_kernelILi16ELb1ELb0EEEvNS_6ParamsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, used 1 barriers, 464 bytes cmem[0]
"""
    rows = chip_smoke.fwd_ptxas(log)
    assert [(r["registers"], r["stack"], r["spill_stores"], r["spill_loads"]) for r in rows] == \
        [(168, 8, 4, 12), (40, 0, 0, 0)]
    # Q + two stages of K and V (128 rows x 128 bytes each) + 6 barriers + slack
    assert rows[0]["dynamic_smem_bytes"] == 16384 + 4 * 16384 + 48 + 1024
    assert "dynamic_smem_bytes" not in rows[1]
    assert capsys.readouterr().out.count('"phase": "fwd_ptxas"') == 2


DQ_KEYS = 64      # the bf16 dq kernel's k/v tile (flash_bwd.cu kDqKeys)
DQ_ROWS = 128     # its work item's query rows (kDqRows)
DKV_ROWS = 64     # the bf16 dk/dv kernel's q/dO tile (kDkvRows)


@pytest.mark.parametrize("hd", [16, 32, 64, 128])
def test_bwd_ring_cases_cover_every_head_width(hd):
    cases = [c for c in chip_smoke.BWD_RING_CASES if c[5] == hd]
    ts = {c[2] for c in cases}
    assert {1, 63, 65, 1000, 4096, 1100, 640, 300} <= ts
    # both rings wrap many times at T = 4096 and walk an odd count at 1100
    assert 4096 // DQ_KEYS > 2 * STAGES and 4096 // DKV_ROWS > 2 * STAGES
    assert any(-(-c[2] // DQ_ROWS) % 2 and c[3] == 12 and c[4] == 4 for c in cases)
    assert any(c[8] == "qkv_view" and c[2] == 1000 for c in cases)
    assert any(c[6] == 50 and c[2] == 640 for c in cases)  # a narrow window
    assert any(c[7] == 30.0 and c[2] == 300 for c in cases)  # softcap
    assert all(len(c) == 9 for c in cases)


def test_bwd_ring_cases_have_unique_names_beside_the_kernel_cases():
    names = [c[0] for c in chip_smoke.KERNEL_CASES + chip_smoke.BWD_RING_CASES]
    assert len(names) == len(set(names))


def _ptxas_entry(kernel, stack, stores, loads, regs):
    return (f"ptxas info    : Compiling entry function '{kernel}' for 'sm_90a'\n"
            f"ptxas info    : Function properties for {kernel}\n"
            f"    {stack} bytes stack frame, {stores} bytes spill stores, {loads} bytes spill loads\n"
            f"ptxas info    : Used {regs} registers, used 1 barriers, 1088 bytes cmem[0]\n")


def _dkv(hd, lse=0, nat=0, fused=0):
    return (f"_ZN12_GLOBAL__N_121flash_dkv_bf16_kernelILi{hd}ELb{lse}ELb{nat}ELb{fused}EEEv"
            "14CUtensorMap_stS1_S1_S1_NS_6ParamsE")


def test_bwd_ptxas_reads_registers_spills_and_shared_memory(capsys):
    log = (_ptxas_entry("_ZN12_GLOBAL__N_120flash_dq_bf16_kernelILi64ELb0ELb0EEEv14CUtensorMap"
                        "_stS1_S1_S1_NS_6ParamsE", 0, 0, 0, 168)
           + _ptxas_entry(_dkv(128, lse=1), 24, 36, 36, 168)
           + _ptxas_entry(_dkv(64, fused=1), 8, 12, 16, 168)
           + _ptxas_entry(_dkv(64), 8, 12, 16, 168)
           + _ptxas_entry("_ZN12_GLOBAL__N_121flash_bwd_prep_kernelI13__nv_bfloat16Li8EEEvNS_"
                          "10PrepParamsE", 0, 0, 0, 24))
    rows, fails = chip_smoke.bwd_ptxas(log)
    assert [(r["registers"], r["stack"], r["spill_stores"], r["spill_loads"]) for r in rows] == \
        [(168, 0, 0, 0), (168, 24, 36, 36), (168, 8, 12, 16), (168, 8, 12, 16), (24, 0, 0, 0)]
    # dq: Q and dO of 128 rows + two stages of 64-key K and V + barriers + slack
    assert rows[0]["dynamic_smem_bytes"] == 2 * 16384 + 4 * 8192 + 48 + 1024
    # dk/dv: K and V of 128 keys + two stages of 64-row Q and dO + lse/delta
    assert rows[1]["dynamic_smem_bytes"] == 2 * 32768 + 4 * 16384 + 1024 + 48 + 1024
    # K2c: the same at hd 64, two warpgroups' 64 x 64 bf16 dS^T tiles and
    # the dq exchange (2 warpgroups x 2 parities x 4 float4 x 128 threads)
    assert rows[2]["dynamic_smem_bytes"] == (2 * 16384 + 4 * 8192 + 1024 + 2 * 8192
                                             + 2 * 2 * 4 * 16 * 128 + 48 + 1024)
    assert rows[3]["dynamic_smem_bytes"] == rows[2]["dynamic_smem_bytes"] - 2 * 8192 - 32768
    assert "dynamic_smem_bytes" not in rows[4]  # the prep kernel takes none
    assert fails == []
    assert capsys.readouterr().out.count('"phase": "bwd_ptxas"') == 5


@pytest.mark.parametrize("stores, loads, caught", [(12, 16, False), (16, 16, True),
                                                   (12, 20, True), (0, 0, False)])
def test_bwd_ptxas_fails_k2c_spilling_more_than_dkv_at_hd_64(stores, loads, caught):
    log = (_ptxas_entry(_dkv(64), 8, 12, 16, 168)
           + _ptxas_entry(_dkv(64, fused=1), 8, stores, loads, 168)
           # hd 128 is recorded, not held
           + _ptxas_entry(_dkv(128), 24, 36, 36, 168)
           + _ptxas_entry(_dkv(128, fused=1), 32, 80, 80, 168))
    _, fails = chip_smoke.bwd_ptxas(log)
    assert fails == ([f"K2c at hd 64 spills {stores}/{loads} bytes, dk/dv 12/16"]
                     if caught else [])


def _entry_instantiations():
    """(template, kLse, kNat, kFused) of every bf16 dq/dk-dv kernel the C
    entry points of flash_bwd.cu launch, read from the source."""
    src = (Path(REPO) / "mingpt_distributed_tpu_torch/ops/csrc/flash_bwd.cu").read_text()
    found = set()
    for body in re.findall(r'extern "C" int \w+\(.*?\n}\n', src, re.S):
        for kind, args in re.findall(r"run_(dq|dkv)<([^>]*)>", body):
            flags = tuple(a.strip() == "true" for a in args.split(","))
            found.add((f"flash_{kind}_bf16_kernel", *flags))
    return found


def test_bwd_sass_expects_every_instantiation_the_entry_points_name():
    from mingpt_distributed_tpu_torch.ops.flash_attention import SUPPORTED_HEAD_DIMS

    found = _entry_instantiations()
    widths = len(SUPPORTED_HEAD_DIMS)
    for name, want in chip_smoke.BWD_BF16_KERNELS.items():
        assert want == widths * sum(k == name for k, *_ in found)
    # K2a, K4a, K5 dq; K2b, K4b, K5 dkv and K2c (kFused), at 4 head widths
    assert chip_smoke.BWD_BF16_KERNELS == {"flash_dq_bf16_kernel": 12,
                                           "flash_dkv_bf16_kernel": 16}
    assert ("flash_dkv_bf16_kernel", False, False, True) in found
    src = (Path(REPO) / "mingpt_distributed_tpu_torch/ops/csrc/flash_bwd.cu").read_text()
    assert "mma.sync" not in src and "mma_bf16(" not in src


def test_bwd_sass_check_passes_wgmma_kernels_and_refuses_hmma_in_them():
    def name(kind, hd, *flags):
        return (f"_ZN12_GLOBAL__N_1{kind}ILi{hd}E" + "".join(f"Lb{f}E" for f in flags)
                + "EEv14CUtensorMap_st")

    good = {name("flash_dq_bf16_kernel", hd, lse, nat): {"HGMMA.64x64x16.F32.BF16": 4,
                                                         "UTMALDG.4D": 2}
            for hd in (16, 32, 64, 128) for lse, nat in ((0, 0), (1, 0), (0, 1))}
    good.update({name("flash_dkv_bf16_kernel", hd, lse, nat, fused):
                 {"HGMMA.64x64x16.F32.BF16": 4, "UTMALDG.4D": 2}
                 for hd in (16, 32, 64, 128)
                 for lse, nat, fused in ((0, 0, 0), (1, 0, 0), (0, 1, 0), (0, 0, 1))})
    good["_ZN12_GLOBAL__N_119flash_dq_f32_kernelILi64ELb0ELb0EEEvNS_6ParamsE"] = {"FFMA": 9}
    good["_ZN12_GLOBAL__N_121flash_bwd_prep_kernelIfLi8EEEvNS_10PrepParamsE"] = {"FFMA": 8}
    _, fails = chip_smoke.bwd_sass_check(good)
    assert fails == []
    bad = dict(good)
    bad[name("flash_dkv_bf16_kernel", 64, 0, 0, 1)] = {"HMMA.16816.F32.BF16": 8,
                                                       "UTMALDG.4D": 2}
    del bad[name("flash_dq_bf16_kernel", 16, 0, 0)]
    _, fails = chip_smoke.bwd_sass_check(bad)
    assert len(fails) == 2
    assert any("flash_dq_bf16_kernel: 11 instantiations" in f for f in fails)
    assert any("ELb1E" in f and "HMMA 8" in f for f in fails)


def test_attention_work_bounds_k2c_by_its_function_and_counts_its_float32_dq_apart():
    import torch

    from mingpt_distributed_tpu_torch.tools import bwd_times

    b, t, h, hd = 16, 1024, 12, 64
    elems = b * t * h * hd
    bf16 = torch.bfloat16
    dkv, _, _ = chip_smoke.attention_work(b, t, h, hd, None, bf16, "flash_bwd_dkv")
    fused, flops, _ = chip_smoke.attention_work(b, t, h, hd, None, bf16,
                                                "flash_bwd_fused")
    # K2c's function writes dq once in bf16 beside K2b's; its float32 buffer
    # is not the function's
    assert fused - dkv == elems * 2
    assert flops == 2 * 5 * b * h * hd * (t * (t + 1) // 2)
    bound, by = chip_smoke.roofline_ms(fused, [(flops, chip_smoke.PEAK_FLOPS[bf16])])
    assert by == "operations" and bound == pytest.approx(0.0652, abs=5e-5)
    for kernel in ("flash_bwd_dq", "flash_bwd_dkv", "flash_bwd_fused"):
        assert bwd_times.work(kernel, b, t, h, hd, True) == chip_smoke.attention_work(
            b, t, h, hd, None, bf16, kernel)
    # 72 (64-query tile, 128-key item) cells per (batch, head) in the causal
    # band at T = 1024; every cell of a row without the mask
    dq32 = bwd_times.dq_f32_bytes(b, t, h, hd, True)
    assert dq32 == {"read": elems * 4, "write": elems * 4,
                    "atomic_add": b * h * 72 * 64 * hd * 4}
    assert bwd_times.dq_f32_bytes(2, 200, 3, 16, False)["atomic_add"] == 2 * 3 * 4 * 2 * 64 * 16 * 4
    assert bwd_times.dq_f32_bytes(1, 65, 1, 16, True)["atomic_add"] == 2 * 64 * 16 * 4
    split, ops = chip_smoke.prep_work(b, t, h, hd, bf16)
    zero, _ = chip_smoke.prep_work(b, t, h, hd, bf16, zero_dq=True)
    assert split == 2 * elems * 2 + b * h * t * 4 and zero - split == elems * 4
    assert ops == 2 * elems
    assert chip_smoke.attention_work(b, t, h, hd, None, bf16,
                                     "flash_bwd_prep") == (split, ops, 0)


def test_served_texts_reads_multiline_completions():
    out = ("=== req-0 (length) ===\nthe king ab\ncd\n"
           "=== req-1 (eos) ===\nand so x\n"
           '{"requests_completed": 2}\n')
    assert chip_smoke.served_texts(out) == ["the king ab\ncd", "and so x"]
    assert chip_smoke.served_texts('{"requests_completed": 0}\n') == []


def test_serve_prompts_share_their_head():
    import numpy as np

    rng = np.random.default_rng(0)
    head = [7] * 4
    out = chip_smoke._serve_prompts(rng, [6, 9, 5], head, [True, False, True])
    assert [len(p) for p in out] == [6, 9, 5]
    assert out[0][:4] == out[2][:4] == head and out[1][:4] != head


# ---------------------------------------------------------------------------
# the speculative and quantized serving phases, the trainer's telemetry run
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kv_dtype, want", [("fp32", 301_989_888),
                                            ("int8", 160_432_128),
                                            ("fp8", 160_432_128)])
def test_serve_pool_bytes_at_gpt2_width(kv_dtype, want):
    """serve's pool: 8 slots x 12 layers x 1024 rows x 768 of K and V in
    bf16, or one byte each plus an fp32 scale per row and head (0.531x)."""
    cfg = chip_smoke.gpt2_config("flash", "bfloat16")
    assert chip_smoke.pool_bytes_want(cfg, 8, kv_dtype) == want


def test_serve_traffic_prefixes_the_serve_phase():
    """serve_spec's 16 requests are the first 16 of serve's 32: the same
    prompts, samplers and seeds."""
    reqs32, lengths32, sampled32 = chip_smoke.serve_traffic(32)
    reqs16, lengths16, sampled16 = chip_smoke.serve_traffic(16)
    assert [r.prompt for r in reqs16] == [r.prompt for r in reqs32[:16]]
    assert list(lengths16) == list(lengths32[:16]) and sampled16 == sampled32[:16]
    assert sum(sampled32) == 8 and all(32 <= n <= 896 for n in lengths32)
    assert all(r.max_new_tokens == chip_smoke.SERVE_NEW for r in reqs32)
    prompts, lengths = chip_smoke.parity_prompts()
    assert list(lengths[:2]) == [5, 700] and prompts[2][:128] == prompts[4][:128]


def _tiny_spec_server(draft_layers):
    import dataclasses

    import torch

    from mingpt_distributed_tpu_torch.config import GPTConfig
    from mingpt_distributed_tpu_torch.models import gpt
    from mingpt_distributed_tpu_torch.serve import first_layers
    from mingpt_distributed_tpu_torch.serving import InferenceServer

    cfg = GPTConfig.make(n_layer=2, n_head=2, n_embd=32, vocab_size=50, block_size=32,
                         embd_pdrop=0.0, resid_pdrop=0.0, attn_pdrop=0.0,
                         dtype="float32")
    params = gpt.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    server = InferenceServer(
        params, cfg, n_slots=2, device="cpu", prefill_chunk=4,
        draft_params=first_layers(params, draft_layers),
        draft_cfg=dataclasses.replace(cfg, n_layer=draft_layers), spec_k=3)
    return server, params, cfg


@pytest.mark.parametrize("draft_layers", [1, 2])
def test_logit_tap_records_the_logits_of_every_emitted_token(draft_layers):
    """Through prefill, plain decode (a sampled lane) and verify rounds,
    the tap keeps for each emitted token the logits it was chosen from
    (greedy: their argmax), none of the draft's; and it restores the
    engine."""
    from mingpt_distributed_tpu_torch.serving import Request
    from mingpt_distributed_tpu_torch.serving import engine as engine_mod

    server, _, _ = _tiny_spec_server(draft_layers)
    real = engine_mod._select_next_slots
    reqs = [Request(prompt=[1, 2, 3, 4, 5, 6], max_new_tokens=9),
            Request(prompt=[7, 8, 9], max_new_tokens=7, do_sample=True, seed=3),
            Request(prompt=[10, 11], max_new_tokens=8)]
    with chip_smoke.logit_tap(server) as rows:
        handles = server.generate_batch(reqs)
    assert engine_mod._select_next_slots is real
    assert "verify_call" not in vars(server.engine)
    assert server.metrics.spec_rounds > 0
    for h in handles:
        got = [rows[(h.request_id, i)] for i in range(len(h.tokens))]
        assert all(r.shape == (50,) for r in got)
        if not h.request.do_sample:
            assert [int(r.argmax()) for r in got] == h.tokens


def test_tie_rule_allows_divergences_only_at_near_ties():
    import torch

    ref = torch.tensor([[3.0, 1.0, 0.0], [2.0, 1.99, 0.0]])
    solo = [([0, 0], ref)]

    class H:
        request_id, tokens = "r", [0, 1]

    rows = {("r", 0): ref[0] + 1e-3, ("r", 1): ref[1]}
    res = chip_smoke.tie_rule([H], solo, rows, 2)
    assert res["compared_steps"] == 1 and res["max_logit_err"] == pytest.approx(1e-3, rel=1e-3)
    assert res["divergences"][0]["top2_gap"] == pytest.approx(0.01)
    with pytest.raises(chip_smoke.SmokeFailure, match="top-2 gap"):
        chip_smoke.check_tie_rule("x", res, 2)  # 0.01 > 3 x 1e-3
    rows[("r", 0)] = ref[0] + 4e-3
    res = chip_smoke.tie_rule([H], solo, rows, 2)
    with pytest.raises(chip_smoke.SmokeFailure, match="compared"):
        chip_smoke.check_tie_rule("x", res, 2)  # a tie, but 1 of 2 compared
    chip_smoke.check_tie_rule("x", res, 1)


def test_train_telemetry_readers(tmp_path):
    """step_spans reads the train.step spans of a spans_jsonl file, one
    list of host ms per step; trace_kernel_names the kernel events of a
    Chrome trace."""
    import json

    spans = tmp_path / "s.jsonl"
    spans.write_text("\n".join(json.dumps(r) for r in [
        {"schema": "mingpt-telemetry/1", "kind": "span", "name": "train.step",
         "step": 1, "dur_s": 0.5},
        {"kind": "span", "name": "train.eval", "dur_s": 1.0},
        {"kind": "event", "name": "log", "message": "x"},
        {"kind": "span", "name": "train.step", "step": 2, "dur_s": 0.25}]) + "\n")
    assert chip_smoke.step_spans(spans) == {1: [500.0], 2: [250.0]}
    trace = tmp_path / "t.json"
    trace.write_text(json.dumps({"traceEvents": [
        {"name": "_ZN12_GLOBAL__N_121flash_fwd_bf16_kernelILi64E", "cat": "kernel"},
        {"name": "aten::mm", "cat": "cpu_op"},
        {"name": "flash_bwd_prep_kernel", "cat": "kernel"},
        {"name": "flash_bwd_prep_kernel", "cat": "kernel"}]}))
    assert chip_smoke.trace_kernel_names(trace) == [
        "_ZN12_GLOBAL__N_121flash_fwd_bf16_kernelILi64E", "flash_bwd_prep_kernel"]
    assert chip_smoke.TRACE_KERNELS == ("flash_fwd", "flash_bwd_prep", "flash_dq", "flash_dkv")


def test_diff_paths_names_every_differing_leaf():
    """The traffic phase's comparison of the card's report with the CPU's:
    every differing leaf by its path, nothing for equal documents."""
    a = {"mix": {"vocab_size": 96}, "rungs": [{"x": 1, "y": [1, 2]}], "k": None}
    b = {"mix": {"vocab_size": 50257}, "rungs": [{"x": 1, "y": [1, 3]}], "k": None}
    assert chip_smoke._diff_paths(a, a) == []
    assert chip_smoke._diff_paths(a, b) == [".mix.vocab_size", ".rungs[0].y[1]"]
    assert chip_smoke._diff_paths({"a": [1]}, {"a": [1, 2]}) == [".a"]


def test_fleet_prompts_land_on_each_replica_by_affinity():
    """fleet_parity's prompts: seeded, 5-300 tokens, n per replica by the
    router's own prefix hash, so the chaos spec's named replicas get work."""
    from types import SimpleNamespace

    from mingpt_distributed_tpu_torch.serving import Router

    router = SimpleNamespace(supervisor=SimpleNamespace(replicas=[0, 1, 2]), affinity_len=16)
    router._affinity_index = lambda p: Router._affinity_index(router, p)
    prompts = chip_smoke.fleet_prompts(router, 2)
    assert [router._affinity_index(p) for p in prompts] == [0, 0, 1, 1, 2, 2]
    assert all(5 <= len(p) <= 300 and max(p) < 50257 for p in prompts)
    assert prompts == chip_smoke.fleet_prompts(router, 2)
