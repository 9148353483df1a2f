"""chip_smoke.py's pieces that run without a card: the forward's ring
cases cover what the bf16 kernel's pipeline must survive, and the build log
parser reads ptxas's resource lines."""

import os
import sys

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
