"""chip_smoke.py's pieces that run without a card: the forward's and the
backward's ring cases cover what the bf16 kernels' pipelines must survive,
the build log parsers read ptxas's resource lines, and the SASS check
expects every bf16 backward instantiation the entry points name."""

import math
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
                  chip_smoke.LSE_CASES + chip_smoke.LSE_RING_CASES
                  + chip_smoke.LSE_SP_TP_CASES,
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


def test_served_texts_reads_fleet_headers():
    """serve --replicas N names its requests fleet-N: serve_cli_process
    reads the thread and process fleets' completions alike."""
    out = ("=== fleet-0 (length) ===\nthe king ab\n"
           "=== fleet-1 (length) ===\nwhat is x\ny\n"
           '{"requests_by_outcome": {"completed": 2}}\n')
    assert chip_smoke.served_texts(out) == ["the king ab", "what is x\ny"]


def test_migrate_prompts_ship_rows_on_each_replica():
    """The migration legs' prompts: 130-300 tokens (128 or 256 rows on the
    default bucket ladder, so a migration ships rows), three per replica,
    drawn apart from fleet_prompts' seed."""
    from types import SimpleNamespace

    from mingpt_distributed_tpu_torch.serving import Router, bucket_ladder

    router = SimpleNamespace(supervisor=SimpleNamespace(replicas=[0, 1]), affinity_len=16)
    router._affinity_index = lambda p: Router._affinity_index(router, p)
    prompts = chip_smoke.migrate_prompts(router)
    assert [router._affinity_index(p) for p in prompts] == [0, 0, 0, 1, 1, 1]
    ladder = bucket_ladder(1024)
    assert all(130 <= len(p) <= 300 for p in prompts)
    assert all(max(b for b in ladder if b <= len(p) - 1) in (128, 256) for p in prompts)
    assert not set(map(tuple, prompts)) & set(map(tuple, chip_smoke.fleet_prompts(router, 3)))


def test_worker_spec_round_trips_the_gpt2_config():
    """A worker rebuilds the parent's GPT-2 config from the spec's JSON."""
    import json

    from mingpt_distributed_tpu_torch.config import GPTConfig

    cfg = chip_smoke.gpt2_config("flash", "bfloat16")
    spec = json.loads(json.dumps(chip_smoke.worker_spec(cfg, n_slots=4, warmup=True)))
    back = GPTConfig.make(**spec["cfg"])
    assert back.n_layer == 12 and back.n_embd == 768 and back.dtype == "bfloat16"
    assert {f: getattr(back, f) for f in spec["cfg"]} == {
        f: getattr(cfg, f) for f in spec["cfg"]}
    assert (spec["init_seed"], spec["device"], spec["server"]) == (
        0, "cuda", {"n_slots": 4, "warmup": True})


# -- the autoscaler, the controller axis and fsdp x tp -----------------------


def test_autoscale_arrivals_burst_then_pace():
    at = chip_smoke.autoscale_arrivals(32)
    assert at[:16] == [0] * 16 and at[16:] == [3 * (i + 1) for i in range(16)]
    assert chip_smoke.autoscale_arrivals(4) == [0] * 4


def test_autoscale_controllers_parse_to_one_or_two_replicas():
    from mingpt_distributed_tpu_torch.control import parse_controller_spec

    for text in (chip_smoke.AUTOSCALE_SPEC, chip_smoke.SERVE_CLI_AUTOSCALE):
        cfg = parse_controller_spec(text)
        assert (cfg.metric, cfg.min_replicas, cfg.max_replicas) == ("queue_depth", 1, 2)
    cfg = parse_controller_spec(chip_smoke.AUTOSCALE_SPEC)
    # the burst breaches at the first tick: 16 requests on 4 slots leave 12 queued
    assert chip_smoke.AUTOSCALE_BURST - 4 > cfg.target and cfg.up_after == 1


def test_autoscale_later_arrivals_reach_the_new_replica_by_affinity():
    """The paced half of serve's traffic holds prompts whose affinity hash
    lands on the second replica, so the newcomer is routed work even while
    the first replica stays healthy."""
    import zlib

    import numpy as np

    reqs, _, _ = chip_smoke.serve_traffic(32)
    late = reqs[chip_smoke.AUTOSCALE_BURST:]
    idx = [zlib.crc32(np.asarray(r.prompt[:16], np.uint32).tobytes()) % 2 for r in late]
    assert 1 in idx and 0 in idx


def _control_log(rows):
    import json

    return "".join(json.dumps(r, sort_keys=True) + "\n" for r in rows)


def _row(tick, now, actuator="none", direction="hold", value=0.5):
    return {"schema": "mingpt-control/1", "tick": tick, "now": now, "signals": "ab" * 8,
            "metric": "queue_depth", "value": value, "queue_per_replica": 0.5,
            "replicas_ready": 1, "action": {"actuator": actuator, "direction": direction},
            "reason": "queue_depth=0.5 in deadband"}


def test_control_log_validator_accepts_a_log_and_refuses_tampering():
    good = [_row(1, 0.0), _row(2, 0.05, "replicas", "up"), _row(3, 0.1, value=None),
            _row(1, 0.0)]  # an appended second run starts at tick 1
    rows, problems = chip_smoke.control_rows(_control_log(good))
    assert len(rows) == 4 and problems == []
    for bad in ([_row(1, 0.0), _row(3, 0.1)],                       # a tick skipped
                [_row(1, 0.2), _row(2, 0.1)],                       # time runs back
                [dict(_row(1, 0.0), schema="mingpt-control/0")],
                [_row(1, 0.0, "replicas", "hold")],                 # an actuator on a hold
                [_row(1, 0.0, "none", "up")],
                [_row(1, 0.0, "gpu", "up")],
                [dict(_row(1, 0.0), extra=1)],
                [dict(_row(1, 0.0), tick="1")],
                [dict(_row(1, 0.0), metric="ttft_p50")]):
        assert chip_smoke.control_rows(_control_log(bad))[1], bad
    assert chip_smoke.control_rows("")[1] == ["no rows"]
    assert chip_smoke.control_rows("{not json\n")[1]


def test_budget_record_arithmetic():
    rec = chip_smoke.budget_record({"graftaudit": 20.0, "moe_sp_kernels": 1.0,
                                    "moe_sp_train_step": 25.0, "moe_sp_narrow_fp32": 5.0},
                                   900.0, {"pp_train_step": 41.0})
    assert rec["added_total_s"] == 51.0 and rec["added_within_budget"]
    assert rec["smoke_within_budget"] and rec["moe_sp_train_step_s"] == 25.0
    assert rec["earlier_slice_s"] == {"pp_train_step": 41.0}
    over = chip_smoke.budget_record({"moe_sp_train_step": 61.0}, 1050.1)
    assert not over["added_within_budget"] and not over["smoke_within_budget"]
    assert (chip_smoke.ADDED_PHASES_BUDGET_S, chip_smoke.SMOKE_BUDGET_S) == (60.0, 1050.0)


def test_fsdp_tp_geometry_and_rule_bytes_at_gpt2():
    """The fsdp 2 x tp 2 main path at GPT-2 124M: 6 local heads over 8 rows
    (the kernel case of that shape is checked against its plain version),
    one launch of each attention kernel per layer, and the bytes a rank
    holds by the rules: a quarter of every block matrix, half of wte and
    head (vocab 50257 does not split over fsdp)."""
    import math

    from mingpt_distributed_tpu_torch.config import GPTConfig
    from mingpt_distributed_tpu_torch.models import convert, gpt

    assert ("fsdp_tp_local", 8, 1024, 6, 6, 64, None, None) in chip_smoke.KERNEL_CASES
    cfg = GPTConfig.make(model_type="gpt2", vocab_size=50257, block_size=1024)
    assert chip_smoke.FT_PER_STEP == cfg.n_layer
    assert (chip_smoke.FT_BATCH // chip_smoke.FT_MESH["fsdp"],
            cfg.n_head // chip_smoke.FT_MESH["tp"]) == (8, 6)
    shapes = {n: tuple(s) for n, (s, _) in convert.flatten(gpt.param_spec(cfg)).items()}
    whole = sum(4 * math.prod(s) for s in shapes.values())
    held = chip_smoke.ft_rule_bytes(shapes)
    vocab = 4 * 50257 * 768
    small = sum(4 * math.prod(s) for n, s in shapes.items()
                if n.split("/")[-1] in ("wpe", "lnf_scale", "lnf_bias", "bo", "b_proj",
                                         "ln1_scale", "ln1_bias", "ln2_scale", "ln2_bias"))
    halves = sum(4 * math.prod(s) for n, s in shapes.items()
                 if n.split("/")[-1] in ("bq", "bk", "bv", "b_fc"))
    assert held == (whole - 2 * vocab - small - halves) // 4 + vocab + small + halves // 2
    assert 0.25 < held / whole < 0.5


def test_main_runs_the_added_phases_and_reports_their_seconds():
    """_main drives the earlier slices' phases (the autoscaler, fsdp x tp
    and its times, tensor-parallel serving, sp x tp and its hop times,
    zero and moe_ep with their kernel checks and times,
    serve_moe_tp_parity, the pipeline and checkpoint legs) and this
    slice's (MoE beside sp, checked by phase_moe_sp after its kernel
    checks, and the graftaudit phase), each with its seconds in the budget
    line, and lists the sharded steps' and the tp servers' launches among
    the paths."""
    import ast
    import inspect

    tree = ast.parse(inspect.getsource(chip_smoke._main))
    called = [n.func.id for n in ast.walk(tree)
              if isinstance(n, ast.Call) and isinstance(n.func, ast.Name)]
    for phase in ("phase_traffic_controller", "phase_autoscale", "phase_serve_cli_autoscale",
                  "phase_fsdp_tp", "phase_fsdp_tp_times", "budget_record",
                  "phase_serve_tp_parity", "phase_serve_tp", "phase_serve_cli_tp",
                  "phase_sp", "phase_sp_tp_times", "phase_serve_moe_tp_parity",
                  "phase_zero_moe", "phase_moe_ep_kernels", "phase_zero_moe_times",
                  "phase_pp", "phase_moe_sp", "phase_moe_sp_kernels", "phase_graftaudit"):
        assert phase in called, phase

    def keys(name):
        return {k.value for n in ast.walk(tree) if isinstance(n, ast.Subscript)
                and isinstance(n.value, ast.Name) and n.value.id == name
                for k in [n.slice] if isinstance(k, ast.Constant)}

    assert keys("earlier_seconds") == {"traffic_controller", "autoscale",
                                       "serve_cli_autoscale", "fsdp_tp", "fsdp_tp_times",
                                       "serve_tp_parity+serve_tp", "serve_cli_tp", "sp_tp",
                                       "sp_tp_times", "serve_moe_tp_parity",
                                       "moe_ep_kernels", "zero_moe_times"}
    # this slice's seconds: its kernel checks and the audit in this process,
    # the rest from the ranks (phase_moe_sp)
    assert keys("added_seconds") == {"moe_sp_kernels", "graftaudit"}
    src = inspect.getsource(chip_smoke._main)
    for path in ("fsdp_tp_train_step_rank0", "sp_tp_train_step_rank0", '"serve_tp"',
                 '"serve_tp_follower"', "zero_train_step_rank0", "moe_ep_train_step_rank0",
                 '"serve_moe_tp_parity"', "earlier_seconds.update(zm_seconds)",
                 "pp_train_step_rank0", "pp_1f1b_train_step_rank0",
                 "earlier_seconds.update(pp_seconds)", "moe_sp_train_step_rank0",
                 "added_seconds.update(ms_seconds)"):
        assert path in src, path
    # serve_tp holds its tokens/s against serve's from the same call, and
    # serve_cli_tp its completions against serve_cli's
    assert called.index("phase_serve") < called.index("phase_serve_tp")
    assert called.index("phase_serve_cli") < called.index("phase_serve_cli_tp")
    # the autoscale phase compares with procfleet's record from the same call
    assert called.index("phase_procfleet") < called.index("phase_autoscale")
    assert called.index("phase_serve_cli") < called.index("phase_serve_cli_autoscale")


def test_sp_tp_launch_counts_per_rank_per_step_at_gpt2():
    """dp 1 x sp 2 x tp 2: the zigzag ring makes 3 + (2 - 1) K3 launches per
    layer (and as many of the prep pass, K4a and K4b), 48 per rank per step
    at 12 layers, on 6 of 12 heads over half-chunks of 1024 rows."""
    assert chip_smoke.SP_TP_PER_LAYER == 4 and chip_smoke.SP_TP_PER_LAYER * 12 == 48
    ranks = [_sp_tp_rank(sp, tp) for tp in range(2) for sp in range(2)]
    recs, fails = chip_smoke.sp_tp_checks(ranks, card="c")
    assert not fails, fails
    main = recs[0]
    assert main["phase"] == "sp_tp_train_step" and main["main_path"]
    assert main["launches_per_rank_per_step"] == {
        "flash_lse_fwd": 48.0, "flash_bwd_prep": 48.0, "flash_lse_bwd_dq": 48.0,
        "flash_lse_bwd_dkv": 48.0}
    assert main["k3_q_shapes_want"] == [[4, 1024, 6, 64], [8, 1024, 6, 64]]
    assert [r["phase"] for r in recs[1:]] == ["sp_tp_parity_fp32", "sp_fsdp_parity_fp32"]
    assert main["legs_seconds"] == 3.0


def test_the_sp_spawn_has_the_ranks_fsdp_tp_needs():
    """phase_sp's ranks also run the fsdp x tp slice (ft_rank)."""
    import math

    assert chip_smoke.FT_RANKS == chip_smoke.SP == math.prod(chip_smoke.FT_MESH.values())


def test_lse_checks_cover_the_sp_tp_main_path_shapes():
    """K3/K4a/K4b are held against their plain versions at each q shape the
    sp x tp main path gives them: the causal own block at the batch, the
    non-causal hop at twice the batch (its two half-chunks stacked)."""
    b, c, h = chip_smoke.SP_BATCH, chip_smoke.SP_T // chip_smoke.SP_TP_MESH["sp"], \
        12 // chip_smoke.SP_TP_MESH["tp"]
    cases = {(cb, ct, ch, chd): causal
             for _, cb, ct, ch, ckv, chd, causal, window, cap, off in chip_smoke.LSE_SP_TP_CASES
             if ckv == ch and window is None and cap is None and off == 0}
    assert cases == {(b, c // 2, h, 64): True, (2 * b, c // 2, h, 64): False}


@pytest.mark.parametrize("fault, message", [
    ("launch", "sp_tp launches"), ("shape", "K3 saw q shapes"), ("loss", "vs dense"),
    ("parity", "sp_tp parity: loss rel err")])
def test_sp_tp_checks_fail_a_wrong_count_shape_loss_or_leg(fault, message):
    ranks = [_sp_tp_rank(sp, tp) for tp in range(2) for sp in range(2)]
    if fault == "launch":
        ranks[3]["sp_tp"]["launches"]["flash_lse_fwd"] -= 1
    elif fault == "shape":
        for r in ranks:
            r["sp_tp"]["q_shapes"] = [(4, 1024, 12, 64), (8, 1024, 12, 64)]
    elif fault == "loss":
        ranks[0]["sp_tp"]["dense_loss"] = 11.0
    else:
        ranks[0]["sp_tp_parity"]["ref_losses"] = [10.0, 9.0]
    _, fails = chip_smoke.sp_tp_checks(ranks, card="c")
    assert any(message in f for f in fails), fails


def _sp_tp_rank(sp, tp):
    per = {k: 96 if k in ("flash_lse_fwd", "flash_bwd_prep", "flash_lse_bwd_dq",
                          "flash_lse_bwd_dkv") else 0 for k in chip_smoke.COUNTERS}
    par = {"losses": [10.98, 10.19], "ref_losses": [10.98, 10.19],
           "grad_rel_err": {"blocks/wq": 2e-6, "blocks/bk": 0.5}, "grad_total_rel_err": 1e-6,
           "param_max_abs_err_steady": 1e-8, "param_max_abs_err_all": 3e-5,
           "steady_share": 0.6, "update_max_abs": 3e-4, "leg_s": 1.0}
    return {"sp_tp": {"losses": [10.9811, 10.7382], "seconds": [5.0, 4.0],
                      "collective_s": 7.0, "collective_calls": 254, "launches": per,
                      "q_shapes": [(4, 1024, 6, 64), (8, 1024, 6, 64)],
                      "dense_loss": 10.9812, "coords": {"sp": sp, "tp": tp}, "leg_s": 1.0},
            "sp_tp_parity": dict(par), "sp_fsdp_parity": dict(par)}


class _FakeEngine:
    def __init__(self, reports):
        self.reports = reports

    def local_report(self):
        return self.reports[0]

    def follower_reports(self):
        return self.reports[1:]


def _tp_report(rank, **kw):
    rep = dict(rank=rank, kv_heads=6, kv_shard_count=2, prefix_heads=[6, 6],
               pool_alloc_bytes=150994944, launches={"flash_fwd": 0},
               compile_counts={"prefill": 5, "decode": 1, "prefix_load": 4, "prefix_save": 4})
    rep.update(kw)
    return rep


@pytest.mark.parametrize("bad, message", [
    (None, None), (dict(kv_heads=12), "pool heads"), (dict(prefix_heads=[12]), "prefix"),
    (dict(pool_alloc_bytes=301989888), "pool took"), (dict(launches={"flash_fwd": 1}),
                                                       "launched flash"),
    (dict(compile_counts={"prefill": 4, "decode": 1, "prefix_load": 4, "prefix_save": 4}),
     "shapes")])
def test_tp_rank_checks_hold_every_rank(bad, message):
    """Each rank of a tp = 2 server: 6 of 12 heads in its pool and prefix
    entries, its pool at the tp = 1 pool's bytes over 2 within 1% by the
    allocator, no flash launch, the driver's shapes."""
    from types import SimpleNamespace

    counts = {"prefill": 5, "decode": 1, "prefix_load": 4, "prefix_save": 4, "verify": 1}
    srv = SimpleNamespace(engine=_FakeEngine([_tp_report(0), _tp_report(1, **(bad or {}))]))
    if bad is None:
        reports = chip_smoke.tp_rank_checks("x", srv, 6, 301989888, counts)
        assert [r["rank"] for r in reports] == [0, 1]
        return
    with pytest.raises(chip_smoke.SmokeFailure, match=message):
        chip_smoke.tp_rank_checks("x", srv, 6, 301989888, counts)


def test_parity_checks_name_their_leg():
    good = _sp_tp_rank(0, 0)["sp_tp_parity"]
    rec, fails = chip_smoke.parity_checks([good, good], "fsdp_tp_parity_fp32", "c", mesh={})
    assert not fails and rec["grad_worst_param"] == "blocks/wq"  # blocks/bk: total only
    bad = dict(good, param_max_abs_err_all=2e-4)
    _, fails = chip_smoke.parity_checks([bad], "sp_fsdp_parity_fp32", "c")
    assert fails == ["sp_fsdp parity: post-update params 0.0002"]


def test_zero_and_moe_ep_geometry():
    """zero's ranks see (4, 1024, 12, 64), a kernel case checked against its
    plain version; moe_ep's ranks hold 4096 rows each, 4 whole routing
    groups of the global batch's 1024, 2 of 8 experts, and its attention
    shape is checked first; the narrow MoE's 1024 tokens are one group that
    spans every rank of distinct data, with capacity binding."""
    from mingpt_distributed_tpu_torch.ops import moe

    assert ("gpt2_main", 4, 1024, 12, 12, 64, None, None) in chip_smoke.KERNEL_CASES
    assert chip_smoke.ZERO_BATCH // chip_smoke.ZERO_MESH["dp"] == 4
    ep = chip_smoke.MOE_EP_MESH["ep"]
    rows = chip_smoke.MOE_EP_BATCH * chip_smoke.MOE_EP_T // ep
    gs = moe._group_size(chip_smoke.MOE_EP_BATCH * chip_smoke.MOE_EP_T)
    assert (rows, gs, rows // gs) == (4096, 1024, 4)
    assert chip_smoke.MOE_EP_KERNEL_CASE[1:6] == (1, 4096, 32, 8, 128)
    narrow = chip_smoke.MOE_NARROW
    tokens = chip_smoke.MOE_NARROW_ROWS * narrow["block_size"]
    assert moe._group_size(tokens) == tokens == 1024
    for mesh in chip_smoke.MOE_NARROW_MESHES.values():
        data_ranks = mesh.get("dp", 1) * mesh.get("fsdp", 1) * mesh.get("ep", 1)
        assert data_ranks > 1 and tokens // data_ranks < 1024
    cap = moe.capacity(tokens, narrow["n_experts"], narrow["moe_top_k"],
                       narrow["moe_capacity_factor"])
    assert cap * narrow["n_experts"] < tokens * narrow["moe_top_k"]


def test_moe_sp_geometry():
    """moe_sp's ranks hold 1 row x 4096 columns each (sp 2 x ep 2 at T 8192,
    global batch 2): 4 whole routing groups of the global batch's 1024, so
    local routing is exact; 4 of 8 experts; the zigzag ring's 3 + (2 - 1)
    K3 launches per layer, at the hop's and the own block's shapes, which
    the kernel checks cover. The narrow legs' one group of 1024 tokens
    interleaves every rank's sp chunk (chunks of 128 columns)."""
    from mingpt_distributed_tpu_torch.ops import moe

    mesh = chip_smoke.MOE_SP_MESH
    cols = chip_smoke.MOE_SP_T // mesh["sp"]
    rows = chip_smoke.MOE_SP_BATCH // (mesh.get("dp", 1) * mesh["ep"])
    gs = moe._group_size(chip_smoke.MOE_SP_BATCH * chip_smoke.MOE_SP_T)
    assert (rows, cols, gs, cols % gs, rows * cols // gs) == (1, 4096, 1024, 0, 4)
    assert chip_smoke.MOE_SP_PER_STEP == 4
    assert sorted(c[1:7] for c in chip_smoke.MOE_SP_KERNEL_CASES) == [
        (1, 2048, 32, 8, 128, True), (2, 2048, 32, 8, 128, False)]
    assert set(chip_smoke.MOE_SP_KERNELS) == {"flash_lse_fwd", "flash_bwd_prep",
                                              "flash_lse_bwd_dq", "flash_lse_bwd_dkv"}
    narrow = chip_smoke.MOE_NARROW
    tokens = chip_smoke.MOE_NARROW_ROWS * narrow["block_size"]
    assert moe._group_size(tokens) == tokens == 1024
    for mesh_kw, attention in chip_smoke.MOE_NARROW_SP_MESHES.values():
        assert mesh_kw["sp"] == 2 and attention in ("ring", "ulysses")
        assert narrow["block_size"] // mesh_kw["sp"] < 1024
        assert math.prod(mesh_kw.values()) == chip_smoke.SP


def _moe_sp_rank():
    per = {k: (4 if k in chip_smoke.MOE_SP_KERNELS else 0) for k in chip_smoke.COUNTERS}
    par = {"losses": [8.4, 8.3], "ref_losses": [8.4, 8.3],
           "grad_rel_err": {"blocks/wq": 2e-6}, "grad_total_rel_err": 1e-6,
           "param_max_abs_err_steady": 1e-8, "param_max_abs_err_all": 3e-6,
           "steady_share": 0.6, "update_max_abs": 3e-4, "leg_s": 1.0}
    out = {f"moe_{k}": dict(par) for k in chip_smoke.MOE_NARROW_SP_MESHES}
    out["moe_sp"] = {"losses": [10.4, 10.4], "grad_norms": [3.0, 3.0], "seconds": [2.0],
                     "launches": per, "q_shapes": [(1, 2048, 32, 128), (2, 2048, 32, 128)],
                     "one_process": {"loss": 10.4001, "grad_norm": 3.001},
                     "local_experts": 4, "param_bytes": 4 << 30,
                     "all_to_all_calls_per_step": 4.0, "all_to_all_ms_per_step": 50.0,
                     "peak_allocated_bytes": 13 << 30, "leg_s": 60.0}
    return out


@pytest.mark.parametrize("fault, message", [
    (None, None), ("launch", "moe_sp: launches"), ("experts", "experts, want 4"),
    ("a2a", "all-to-alls"), ("shape", "K3 saw"), ("loss", "vs one process"),
    ("norm", "grad_norm"), ("narrow", "moe_sp2_ep2_ring parity")])
def test_moe_sp_checks(fault, message):
    """moe_sp on every rank: exactly 4 K3, prep, K4a and K4b per step, 4 of
    8 experts, 4 all-to-alls, K3 at the hop's and own block's shapes, the
    first loss within 5e-4 relative and the gradient norm within 0.5% of
    one process's; the narrow legs by the parity rule."""
    ranks = [_moe_sp_rank() for _ in range(chip_smoke.SP)]
    m = ranks[2]["moe_sp"]
    if fault == "launch":
        m["launches"]["flash_lse_bwd_dkv"] = 3
    elif fault == "experts":
        m["local_experts"] = 8
    elif fault == "a2a":
        m["all_to_all_calls_per_step"] = 2.0
    elif fault == "shape":
        ranks[0]["moe_sp"]["q_shapes"] = [(1, 4096, 32, 128)]
    elif fault == "loss":
        ranks[0]["moe_sp"]["one_process"]["loss"] = 10.41
    elif fault == "norm":
        ranks[0]["moe_sp"]["one_process"]["grad_norm"] = 3.1
    elif fault == "narrow":
        ranks[0]["moe_sp2_ep2_ring"]["ref_losses"] = [8.5, 8.3]
    records, fails = chip_smoke.moe_sp_checks(ranks, card="c")
    if fault is None:
        assert not fails, fails
        main = records[-1]
        assert main["phase"] == "moe_sp_train_step" and main["main_path"]
        assert main["launches_want"]["flash_lse_fwd"] == 4
        assert [r["phase"] for r in records[:-1]] == [
            f"moe_{k}_parity_fp32" for k in chip_smoke.MOE_NARROW_SP_MESHES]
        return
    assert any(message in f for f in fails), fails


def test_graftaudit_phase_audits_the_committed_sweep():
    """The smoke's graftaudit phase holds serve's families to the budgets
    section that the committed file names for it."""
    import json
    import os

    from mingpt_distributed_tpu_torch.tools import graftaudit

    with open(graftaudit.DEFAULT_BUDGETS) as f:
        doc = json.load(f)
    section = doc["sweeps"][chip_smoke.GRAFTAUDIT_SWEEP]
    ladder = (64, 128, 256, 512, 1024)
    want = {"decode", "draft_decode", "verify:k2"}
    want |= {f"{f}:b{b}" for f in ("prefill", "draft_prefill") for b in ladder}
    want |= {f"{f}:b{b}" for f in ("prefix_save", "prefix_load") for b in ladder[:-1]}
    assert set(section) == want
    assert os.path.basename(graftaudit.DEFAULT_BUDGETS) == "program_budgets.json"
