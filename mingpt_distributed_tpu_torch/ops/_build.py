"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each source ``csrc/<name>.cu`` exposes a plain C interface and becomes one
shared library, compiled for Hopper (``sm_90a``) at first use into
``ops/_build/`` (listed in .gitignore) under a name keyed by a hash of the
source, the sources it includes (``flash_fwd_f16.cu`` is ``flash_fwd.cu``
built for float16, ``flash_bwd_f16.cu`` likewise), the shared headers
(``csrc/*.cuh``) and the flags, so an edited source is rebuilt and an
unchanged one is reused. No PyTorch headers are compiled, which keeps a
build to seconds; ``build_all`` runs one nvcc per source, all at once.

A failed build raises; nothing falls back to another implementation.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
# the float16 instances build in sources of their own, beside the others
SOURCES: Tuple[str, ...] = ("flash_fwd", "flash_bwd", "flash_fwd_f16", "flash_bwd_f16",
                            "exp_exp2")
# --split-compile=0: nvcc optimises and assembles a source's kernels on
# every core (flash_bwd.cu's ~100 kernels: 39 s against 91 s in one thread
# on the H100 machine's 8 cores)
NVCC_FLAGS: Tuple[str, ...] = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--split-compile=0", "-shared", "-Xcompiler", "-fPIC",
)

_loaded: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, then PATH, then the toolkit's usual
    install prefix. Raises when there is none."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH, /usr/local/cuda/bin):"
        " the CUDA kernels are compiled from ops/csrc at first use"
    )


def included_sources(name: str) -> Tuple[str, ...]:
    """The ``.cu`` files that ``csrc/<name>.cu`` includes (``#include
    "x.cu"``), by name without the suffix."""
    text = (CSRC / f"{name}.cu").read_text()
    return tuple(re.findall(r'^#include "(\w+)\.cu"', text, flags=re.M))


def library_path(name: str) -> Path:
    """Where the shared library built from ``csrc/<name>.cu`` lives."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for src in included_sources(name):
        h.update((CSRC / f"{src}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(name: str, ptxas_verbose: bool = False) -> str:
    """Compile ``csrc/<name>.cu`` unless it is built already. Returns the
    compiler's output (with ``ptxas_verbose`` it lists registers, shared
    memory and spills per kernel; empty when nothing was compiled). Raises
    if the build fails."""
    out = library_path(name)
    if out.exists():
        return ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, *(("-Xptxas", "-v") if ptxas_verbose else ()),
           "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"CUDA kernel build failed: {name}.cu "
                           f"(exit {proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, out)  # atomic: a reader never sees a partial file
    return proc.stdout


def build_all(ptxas_verbose: bool = False) -> Dict[str, str]:
    """Build every source in ``SOURCES`` concurrently (one nvcc each);
    returns each source's compiler output. Raises if any build fails."""
    with ThreadPoolExecutor(max_workers=len(SOURCES)) as pool:
        futures = {n: pool.submit(build, n, ptxas_verbose) for n in SOURCES}
        return {n: f.result() for n, f in futures.items()}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build(name)
            lib = ctypes.CDLL(str(library_path(name)))
            _loaded[name] = lib
        return lib
