"""The PyTorch port stands alone: it imports no jax and nothing of the JAX
package (not even its jax-free modules), neither do chip_smoke.py and the
rank bodies of the multi-process tests (tests/torch_sp_workers.py and
tests/torch_pp_workers.py, run in fresh processes), and its entry points refuse to fall back to the CPU when
no GPU is present."""

import ast
import os
import pkgutil
import subprocess
import sys

import pytest
import torch

import mingpt_distributed_tpu_torch
from mingpt_distributed_tpu_torch.utils.device import resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "mingpt_distributed_tpu_torch")
JAX_PACKAGE = "mingpt_distributed_tpu"


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        mingpt_distributed_tpu_torch.__path__, "mingpt_distributed_tpu_torch."))


def _sources():
    out = [os.path.join(REPO, "chip_smoke.py"),
           os.path.join(REPO, "tests", "torch_sp_workers.py"),
           os.path.join(REPO, "tests", "torch_pp_workers.py"),
           os.path.join(REPO, "tests", "torch_moe_sp_workers.py")]
    for root, _, files in os.walk(PORT):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top == "jax" or top == "jaxlib" or top == JAX_PACKAGE


def test_importing_every_port_module_loads_no_jax():
    mods = _port_modules()
    assert "mingpt_distributed_tpu_torch.ops.flash_attention" in mods
    for name in ("distributed", "mesh", "ring_attention", "ulysses", "spawn"):
        assert f"mingpt_distributed_tpu_torch.parallel.{name}" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        f"('jax', 'jaxlib', {JAX_PACKAGE!r}))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_source_imports_jax_or_the_jax_package(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if _forbidden(node.module or ""):
                bad.append(node.module)
    assert not bad, f"{path} imports {bad}"


def test_resolve_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: this checks the CPU-only behaviour")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: this checks the CPU-only behaviour")
    from mingpt_distributed_tpu_torch.config import GPTConfig
    from mingpt_distributed_tpu_torch.models import GPT, generate, gpt
    from mingpt_distributed_tpu_torch.sample import main

    cfg = GPTConfig.make(n_layer=1, n_head=2, n_embd=16, vocab_size=8,
                         block_size=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GPT(cfg)
    params = gpt.init(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        generate.generate(params, cfg, [[1, 2]], 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--random-init", "--config",
              os.path.join(REPO, "gpt2_config.yaml"),
              "--data", os.path.join(REPO, "data", "input.txt")])
