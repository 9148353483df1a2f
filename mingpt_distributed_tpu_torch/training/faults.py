"""Deterministic fault injection: the durability layer's file I/O and the
serving fleet's scheduling loop.

Counterpart of the file-system and serving halves of
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
so the injector is passed in (``save_snapshot(..., fs=...)``).

Serving fault points: the same grammar and counters drive
:class:`ServingFaultInjector`, whose ops sabotage the fleet's scheduling
loop instead of the file system: ``crash`` (a replica dies mid-round; its
in-flight requests retry on survivors), ``poison`` (one scheduling round
raises after the decode step, before emission), ``slow`` (the replica's
clock is skewed; nothing ever sleeps) and ``admit`` (submission raises).
``match`` filters on the replica name; the environment knob is
``MINGPT_SERVING_FAULTS``::

    MINGPT_SERVING_FAULTS="crash:nth=6:match=replica0;slow:every=1:delay=0.25:match=replica1" \\
        python -m mingpt_distributed_tpu_torch.serve --replicas 3 ...

The process fault points (``kill``, ``hang``, ``slow_socket``,
``stuck_step``) belong to the process fleet, ROADMAP.md Queue 1 item 15b.
"""

from __future__ import annotations

import errno
import io
import os
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional

from mingpt_distributed_tpu_torch.training.durability import LOCAL, LocalFileSystem

SERVING_ENV_VAR = "MINGPT_SERVING_FAULTS"

#: file-system fault points and the fleet's serving fault points: one
#: FaultSpec grammar covers both; which set an injector accepts is checked
#: at construction
IO_OPS = ("write", "read")
SERVING_OPS = ("crash", "poison", "slow", "admit")


@dataclass
class FaultSpec:
    """One rule. ``count`` is the number of operations of ``op`` that
    matched ``match`` so far: the clock its faults fire against."""

    op: str                 # an IO_OPS or SERVING_OPS name
    nth: int = 0            # fire on exactly this matching operation (1-based)
    every: int = 0          # fire on every k-th matching operation
    mode: str = "error"     # "error" | "truncate" | "delay" | "missing"
    match: str = ""         # substring filter on the path
    delay_s: float = 0.0
    count: int = field(default=0, compare=False)

    def __post_init__(self):
        known = IO_OPS + SERVING_OPS
        if self.op not in known:
            raise ValueError(f"fault op must be one of {known}, got {self.op!r}")
        if self.op == "slow" and self.mode == "error":
            # slowness is only ever a delay ("slow:every=1:delay=0.25")
            self.mode = "delay"
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


# -- the serving chaos harness -------------------------------------------------

class InjectedServingFault(RuntimeError):
    """Base of every fault the serving injector raises: the fleet treats
    them as it treats real replica failures, and tests assert the type."""


class ReplicaCrashed(InjectedServingFault):
    """The replica died mid-round: its server is never reused (host-side
    slot state may be mid-update); the supervisor spawns a fresh one."""


class InjectedAdmissionError(InjectedServingFault):
    """submit() failed on this replica: the router retries the request
    elsewhere instead of failing it."""


class ServingFaultInjector:
    """A deterministic fault schedule over the fleet's serving fault points,
    with :class:`FaultSpec`'s grammar and counters; ``match`` filters on the
    replica name. The fault points:

    * ``step_delay(replica)`` — before a replica's scheduling round: raises
      :class:`ReplicaCrashed` for a due ``crash``, else returns the virtual
      seconds of a due ``slow`` (added to the replica's clock skew; nothing
      sleeps);
    * ``round_hook(replica)`` — an ``InferenceServer.fault_hook``: a due
      ``poison`` raises :class:`InjectedServingFault` after the round's
      decode step and before any token is emitted;
    * ``check_admit(replica)`` — inside a replica's submit: a due ``admit``
      raises :class:`InjectedAdmissionError`.

    Each matching spec's counter advances once per visit of its fault point,
    so a (spec, request schedule) pair gives the same chaos on every run."""

    def __init__(self, faults: Optional[str] = None):
        text = faults if faults is not None else os.environ.get(SERVING_ENV_VAR, "")
        self.specs = parse_faults(text)
        for s in self.specs:
            if s.op not in SERVING_OPS:
                raise ValueError(
                    f"serving fault op must be one of {SERVING_OPS}, got "
                    f"{s.op!r} (file-system ops belong to FaultInjectionFileSystem)")
        self.fired: List[str] = []  # "op:replica", in firing order

    def _fire(self, op: str, replica: str) -> Optional[FaultSpec]:
        for s in self.specs:
            if s.fires(op, replica):
                self.fired.append(f"{op}:{replica}")
                return s
        return None

    def reset_counters(self) -> None:
        for s in self.specs:
            s.count = 0
        self.fired = []

    def step_delay(self, replica: str) -> float:
        """The crash or slow verdict for one scheduling round of
        ``replica``: raises ReplicaCrashed, or returns the injected virtual
        delay in seconds (0.0 when healthy)."""
        if self._fire("crash", replica) is not None:
            raise ReplicaCrashed(f"injected crash: replica {replica} died mid-round")
        spec = self._fire("slow", replica)
        return spec.delay_s if spec is not None else 0.0

    def round_hook(self, replica: str) -> Callable[[str], None]:
        """An ``InferenceServer.fault_hook`` poisoning ``replica``'s rounds
        at the named fault point."""
        def hook(where: str) -> None:
            if self._fire("poison", replica) is not None:
                raise InjectedServingFault(
                    f"injected poison: replica {replica} raised at {where}")
        return hook

    def check_admit(self, replica: str) -> None:
        if self._fire("admit", replica) is not None:
            raise InjectedAdmissionError(
                f"injected admission failure on replica {replica}")
