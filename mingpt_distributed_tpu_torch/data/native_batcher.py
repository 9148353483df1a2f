"""The C batch gather (``csrc/native_batcher.c``), built with gcc at first
use and bound with ctypes.

The shared library is compiled (``gcc -O2 -shared -fPIC``) into
``data/_build/`` (listed in .gitignore) under a name keyed by a hash of the
source and the flags, so an edited source is rebuilt and an unchanged one
reused. A failed build raises; nothing falls back to numpy. The numpy
gather in ``char_dataset.py`` is the plain version the tests hold this
against.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE = Path(__file__).resolve().parent / "csrc" / "native_batcher.c"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
CFLAGS = ("-O2", "-shared", "-fPIC", "-std=c99")

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CFLAGS).encode())
    return BUILD_DIR / f"libnative_batcher-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the source unless it is built already; raises if gcc is
    missing or the build fails."""
    out = library_path()
    if out.exists():
        return out
    cc = shutil.which("gcc")
    if cc is None:
        raise RuntimeError("gcc not found on PATH: the C batch gather "
                           "(data/csrc/native_batcher.c) is built at first use")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run([cc, *CFLAGS, "-o", str(tmp), str(SOURCE)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"C batch gather build failed (exit {proc.returncode}):\n"
                           f"{proc.stdout}")
    os.replace(tmp, out)  # atomic: a reader never sees a partial file
    return out


def load() -> ctypes.CDLL:
    """The loaded library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            fn = lib.gather_windows
            fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                           ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p]
            fn.restype = ctypes.c_int64
            _lib = lib
        return _lib


def gather_windows(data: np.ndarray, starts: np.ndarray, block_size: int) -> np.ndarray:
    """(len(starts), block_size + 1) int32 windows ``data[s : s + block_size
    + 1]``: the C loop, without the GIL. Raises IndexError for a window that
    leaves the corpus."""
    if data.dtype != np.int32 or not data.flags.c_contiguous:
        raise ValueError("data must be a contiguous int32 array")
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    out = np.empty((len(starts), block_size + 1), dtype=np.int32)
    bad = load().gather_windows(data.ctypes.data, len(data), starts.ctypes.data,
                                len(starts), int(block_size), out.ctypes.data)
    if bad:
        raise IndexError(f"window start {int(starts[bad - 1])} out of range "
                         f"(corpus {len(data)}, window {block_size + 1})")
    return out
