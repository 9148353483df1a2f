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


def test_bwd_ptxas_reads_registers_spills_and_shared_memory(capsys):
    log = """ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_120flash_dq_bf16_kernelILi64ELb0ELb0EEEv14CUtensorMap_stS1_S1_S1_NS_6ParamsE' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_120flash_dq_bf16_kernelILi64ELb0ELb0EEEv14CUtensorMap_stS1_S1_S1_NS_6ParamsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 1088 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_121flash_dkv_bf16_kernelILi128ELb1ELb0EEEv14CUtensorMap_stS1_S1_S1_NS_6ParamsE' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_121flash_dkv_bf16_kernelILi128ELb1ELb0EEEv14CUtensorMap_stS1_S1_S1_NS_6ParamsE
    24 bytes stack frame, 36 bytes spill stores, 36 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 1088 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_123flash_fused_bf16_kernelILi64EEEvNS_6ParamsE' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_123flash_fused_bf16_kernelILi64EEEvNS_6ParamsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 464 bytes cmem[0]
"""
    rows = chip_smoke.bwd_ptxas(log)
    assert [(r["registers"], r["stack"], r["spill_stores"], r["spill_loads"]) for r in rows] == \
        [(168, 0, 0, 0), (168, 24, 36, 36), (128, 0, 0, 0)]
    # dq: Q and dO of 128 rows + two stages of 64-key K and V + barriers + slack
    assert rows[0]["dynamic_smem_bytes"] == 2 * 16384 + 4 * 8192 + 48 + 1024
    # dk/dv: K and V of 128 keys + two stages of 64-row Q and dO + lse/delta
    assert rows[1]["dynamic_smem_bytes"] == 2 * 32768 + 4 * 16384 + 1024 + 48 + 1024
    # K2c: K, V, Q, dO rows padded to hd + 8, lse, delta, the cell's dS
    assert rows[2]["dynamic_smem_bytes"] == 4 * 64 * 72 * 2 + 512 + 64 * 72 * 2
    assert capsys.readouterr().out.count('"phase": "bwd_ptxas"') == 3


def _entry_instantiations():
    """(template, kLse, kNat) of every bf16 dq/dk-dv kernel the C entry
    points of flash_bwd.cu launch, and the K2c ones, read from the source."""
    src = (Path(REPO) / "mingpt_distributed_tpu_torch/ops/csrc/flash_bwd.cu").read_text()
    wgmma, fused = set(), set()
    for body in re.findall(r'extern "C" int \w+\(.*?\n}\n', src, re.S):
        for kind, args in re.findall(r"run_(dq|dkv)<([^>]*)>", body):
            flags = tuple(a.strip() == "true" for a in args.split(","))
            if kind == "dkv" and flags[2]:
                fused.add(flags[:2])
            else:
                wgmma.add((f"flash_{kind}_bf16_kernel", *flags[:2]))
    return wgmma, fused


def test_bwd_sass_expects_every_instantiation_the_entry_points_name():
    from mingpt_distributed_tpu_torch.ops.flash_attention import SUPPORTED_HEAD_DIMS

    wgmma, fused = _entry_instantiations()
    widths = len(SUPPORTED_HEAD_DIMS)
    for name, want in chip_smoke.BWD_BF16_KERNELS.items():
        assert want == widths * sum(k == name for k, *_ in wgmma)
    assert sum(chip_smoke.BWD_BF16_KERNELS.values()) == 24
    assert chip_smoke.FUSED_BF16_KERNELS == {"flash_fused_bf16_kernel": widths * len(fused)}


def test_bwd_sass_check_passes_wgmma_kernels_and_refuses_hmma_in_them():
    def name(kind, hd, lse=0, nat=0):
        return f"_ZN12_GLOBAL__N_1{kind}ILi{hd}ELb{lse}ELb{nat}EEEv14CUtensorMap_st"

    good = {name(k, hd, lse, nat): {"HGMMA.64x64x16.F32.BF16": 4, "UTMALDG.4D": 2}
            for k in chip_smoke.BWD_BF16_KERNELS for hd in (16, 32, 64, 128)
            for lse, nat in ((0, 0), (1, 0), (0, 1))}
    good.update({f"_ZN12_GLOBAL__N_123flash_fused_bf16_kernelILi{hd}EEEvNS_6ParamsE":
                 {"HMMA.16816.F32.BF16": 40} for hd in (16, 32, 64, 128)})
    good["_ZN12_GLOBAL__N_119flash_dq_f32_kernelILi64ELb0ELb0EEEvNS_6ParamsE"] = {"FFMA": 9}
    _, fails = chip_smoke.bwd_sass_check(good)
    assert fails == []
    bad = dict(good)
    bad[name("flash_dkv_bf16_kernel", 64)] = {"HMMA.16816.F32.BF16": 8, "UTMALDG.4D": 2}
    del bad[name("flash_dq_bf16_kernel", 16)]
    _, fails = chip_smoke.bwd_sass_check(bad)
    assert len(fails) == 2
    assert any("flash_dq_bf16_kernel: 11 instantiations" in f for f in fails)
