"""Deterministic fault injection for the durability layer's file I/O.

Counterpart of the file-system half of
``mingpt_distributed_tpu/training/faults.py``, kept as the port's own copy.
``FaultInjectionFileSystem`` wraps a file system (local files by default)
and, by a list of :class:`FaultSpec` rules, sabotages its reads and writes:

* fail the **nth** write or read, or **every** kth one, with a transient
  ``OSError`` (EIO): the retry and backoff path;
* **truncate** a write (half the bytes land, the call succeeds): the digest
  check and the fallback to the previous good snapshot;
* **delay** an operation, through an injectable ``sleep``;
* report an object as **missing** on read: the missing-vs-transient
  classification.

A whole-object open for writing or reading is one operation, and each
rule's counter advances on every operation it matches, so a spec gives the
same schedule on every run. Spec grammar (``;``-separated):
``op[:field=value]...`` with fields ``nth`` (1-based, once), ``every``
(periodic), ``mode`` (``error`` | ``truncate`` | ``delay`` | ``missing``),
``match`` (a substring of the path) and ``delay`` (seconds), e.g.
``"write:every=3;read:nth=2:mode=truncate"``.

The JAX package registers its injector as an fsspec ``faulty://`` protocol;
the port's durability layer takes its file system as an argument instead,
so the injector is passed in (``save_snapshot(..., fs=...)``). The serving
fault points wait for the fleet (ROADMAP.md Queue 1 item 15).
"""

from __future__ import annotations

import errno
import io
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional

from mingpt_distributed_tpu_torch.training.durability import LOCAL, LocalFileSystem

IO_OPS = ("write", "read")


@dataclass
class FaultSpec:
    """One rule. ``count`` is the number of operations of ``op`` that
    matched ``match`` so far: the clock its faults fire against."""

    op: str                 # "write" | "read"
    nth: int = 0            # fire on exactly this matching operation (1-based)
    every: int = 0          # fire on every k-th matching operation
    mode: str = "error"     # "error" | "truncate" | "delay" | "missing"
    match: str = ""         # substring filter on the path
    delay_s: float = 0.0
    count: int = field(default=0, compare=False)

    def __post_init__(self):
        if self.op not in IO_OPS:
            raise ValueError(f"fault op must be one of {IO_OPS}, got {self.op!r}")
        if self.mode not in ("error", "truncate", "delay", "missing"):
            raise ValueError(f"unknown fault mode {self.mode!r}")
        if not self.nth and not self.every:
            raise ValueError("fault spec needs nth=N or every=K")

    def fires(self, op: str, path: str) -> bool:
        """Advance the clock if (op, path) matches; True when the fault
        triggers on this operation."""
        if op != self.op or (self.match and self.match not in path):
            return False
        self.count += 1
        if self.nth and self.count == self.nth:
            return True
        return bool(self.every and self.count % self.every == 0)


def parse_faults(text: str) -> List[FaultSpec]:
    """``"write:every=3;read:nth=2:mode=truncate"`` -> [FaultSpec, ...]."""
    specs: List[FaultSpec] = []
    for part in text.split(";"):
        part = part.strip()
        if not part:
            continue
        fields = part.split(":")
        kwargs: dict = {"op": fields[0].strip()}
        for f in fields[1:]:
            if "=" not in f:
                raise ValueError(f"malformed fault field {f!r} in {part!r}")
            k, v = f.split("=", 1)
            k = k.strip()
            if k in ("nth", "every"):
                kwargs[k] = int(v)
            elif k == "delay":
                kwargs["delay_s"] = float(v)
            elif k in ("mode", "match"):
                kwargs[k] = v.strip()
            else:
                raise ValueError(f"unknown fault field {k!r} in {part!r}")
        specs.append(FaultSpec(**kwargs))
    return specs


def _injected_error(op: str, path: str) -> OSError:
    # EIO, not a FileNotFoundError: classified transient, so retries engage
    return OSError(errno.EIO, f"injected transient {op} failure", path)


class _FaultyWriteFile(io.BytesIO):
    """Buffers the whole object; the fault lands at close(), as on an
    object store's PUT: ``error`` writes nothing and raises, ``truncate``
    writes half the bytes and reports success, ``delay`` sleeps first."""

    def __init__(self, target: LocalFileSystem, path: str, mode: Optional[str],
                 delay_s: float, sleep: Callable[[float], None]):
        super().__init__()
        self._target = target
        self._path = path
        self._fault = mode
        self._delay_s = delay_s
        self._sleep = sleep
        self._done = False

    def close(self):
        if self._done or self.closed:
            return
        self._done = True
        blob = self.getvalue()
        super().close()
        if self._fault == "error":
            raise _injected_error("write", self._path)
        if self._fault == "delay":
            self._sleep(self._delay_s)
        if self._fault == "truncate":
            blob = blob[: len(blob) // 2]
        with self._target.open(self._path, "wb") as f:
            f.write(blob)


class FaultInjectionFileSystem(LocalFileSystem):
    """``target`` (local files by default) with the rules of ``faults``
    applied to whole-object reads and writes; ``exists``, ``remove``,
    ``makedirs`` and ``replace`` pass through untouched."""

    def __init__(self, faults: str = "", target: LocalFileSystem = LOCAL,
                 sleep: Callable[[float], None] = time.sleep):
        self.target = target
        self.sleep = sleep  # injectable: delay faults become instantaneous
        self.specs: List[FaultSpec] = parse_faults(faults)

    def set_faults(self, text: str) -> None:
        """Replace the rules; every counter starts at 0."""
        self.specs = parse_faults(text)

    def clear_faults(self) -> None:
        self.specs = []

    def _fault_for(self, op: str, path: str) -> Optional[FaultSpec]:
        for s in self.specs:
            if s.fires(op, path):
                return s
        return None

    def open(self, path: str, mode: str = "rb"):
        if any(c in mode for c in "wax"):
            spec = self._fault_for("write", path)
            return _FaultyWriteFile(self.target, path, spec.mode if spec else None,
                                    spec.delay_s if spec else 0.0, self.sleep)
        spec = self._fault_for("read", path)
        if spec is not None:
            if spec.mode == "missing":
                raise FileNotFoundError(errno.ENOENT, "injected missing object", path)
            if spec.mode == "error":
                raise _injected_error("read", path)
            if spec.mode == "delay":
                self.sleep(spec.delay_s)
            if spec.mode == "truncate":
                with self.target.open(path, "rb") as f:
                    blob = f.read()
                return io.BytesIO(blob[: len(blob) // 2])
        return self.target.open(path, mode)

    def exists(self, path: str) -> bool:
        return self.target.exists(path)

    def remove(self, path: str) -> None:
        self.target.remove(path)

    def makedirs(self, path: str, exist_ok: bool = True) -> None:
        self.target.makedirs(path, exist_ok=exist_ok)

    def replace(self, src: str, dst: str) -> None:
        self.target.replace(src, dst)
