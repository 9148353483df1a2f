"""Training snapshots in the port's own format, committed durably.

A snapshot holds params, optimizer state, step, epoch, the data iterator's
state, the dropout generator's state and the config dict (what the JAX
package's ``training/checkpoint.py`` ``Snapshot`` holds). Its bytes are a
header line, ``FORMAT`` and the sha256 of the payload, then the payload
written by ``torch.save``.

Saves go through the durability layer (``training/durability.py``), as in
the JAX package: the bytes land in a step-suffixed object
(``<path>.step-00000040``), then the manifest ``<path>.manifest.json``
commits it, keeping the last ``keep`` snapshots; transient I/O errors are
retried with backoff. ``load_snapshot`` walks the manifest from newest to
oldest and restores the first snapshot whose digest matches and whose
payload loads, so a torn or corrupt latest snapshot falls back to the one
before; when every one is bad it raises. Without a manifest it reads the
legacy single file at the bare ``path`` (the layout of the port's earlier
snapshots). A missing snapshot means a fresh start (None); a transient
error is retried, then raised, never taken for "missing".
"""

from __future__ import annotations

import hashlib
import io
import os
from typing import Any, Dict, NamedTuple, Optional

import torch

from mingpt_distributed_tpu_torch.models import convert
from mingpt_distributed_tpu_torch.training import durability
from mingpt_distributed_tpu_torch.training.durability import (
    LOCAL,
    LocalFileSystem,
    RetryPolicy,
    SnapshotIntegrityError,
)

FORMAT = b"mingpt-torch-snapshot/1"
DEFAULT_SNAPSHOT_PATH = "gpt_snapshot.pt"
DEFAULT_KEEP = 3  # snapshots the manifest keeps (keep-last-K)


class SnapshotError(SnapshotIntegrityError):
    """Bytes that are not a whole snapshot of this format: torn, corrupt or
    foreign."""


def encode(snapshot: Dict[str, Any]) -> bytes:
    """A snapshot's bytes: the header line, then the ``torch.save`` payload."""
    buf = io.BytesIO()
    torch.save(snapshot, buf)
    payload = buf.getvalue()
    return FORMAT + b" " + hashlib.sha256(payload).hexdigest().encode() + b"\n" + payload


def decode(blob: bytes, source: str) -> Dict[str, Any]:
    """The snapshot in ``blob`` with tensors on the CPU; SnapshotError when
    it is not a whole snapshot of this format."""
    header, sep, payload = blob.partition(b"\n")
    fmt, _, digest = header.partition(b" ")
    if not sep or fmt != FORMAT:
        raise SnapshotError(f"{source} is not a snapshot of the PyTorch port "
                            f"({FORMAT.decode()})")
    if hashlib.sha256(payload).hexdigest().encode() != digest:
        raise SnapshotError(f"{source}: payload digest mismatch (torn or "
                            "corrupt file)")
    try:
        return torch.load(io.BytesIO(payload), map_location="cpu", weights_only=True)
    except Exception as e:
        raise SnapshotError(f"{source}: payload does not load: {e}") from e


def save_snapshot(path: str, snapshot: Dict[str, Any], keep: int = DEFAULT_KEEP,
                  retry: Optional[RetryPolicy] = None,
                  fs: LocalFileSystem = LOCAL) -> None:
    """Commit ``snapshot`` (tensors, dicts, lists and scalars, with ``step``
    and ``epoch``) as the newest of the last ``keep`` snapshots at
    ``path``."""
    durability.commit_blob(path, encode(snapshot), step=int(snapshot["step"]),
                           epoch=int(snapshot.get("epoch", 0)), keep=keep,
                           policy=retry, fs=fs)


def load_snapshot(path: str, retry: Optional[RetryPolicy] = None,
                  fs: LocalFileSystem = LOCAL) -> Optional[Dict[str, Any]]:
    """The newest good snapshot at ``path`` with tensors on the CPU, or None
    when there is none. Raises SnapshotIntegrityError when every snapshot
    the manifest names is bad (or the legacy file is), and a transient I/O
    error once its retries are spent."""
    manifest = durability.load_manifest(path, retry, fs)
    if manifest is not None and manifest.entries:
        snapshot, _ = durability.read_verified(path, manifest, retry, load=decode, fs=fs)
        return snapshot
    try:
        blob = durability.read_bytes(path, retry, fs)
    except BaseException as e:  # noqa: BLE001 (classified, not blanket)
        if durability.is_missing_error(e):
            return None
        raise
    return decode(blob, path)


class InferenceSnapshot(NamedTuple):
    """A snapshot's params (checked against the config, on the device) and
    the step they were saved at."""

    params: Dict[str, Any]
    step: int


def restore_inference_params(path: str, gpt_cfg, device=None
                             ) -> Optional[InferenceSnapshot]:
    """Restore a snapshot of the port's trainer for inference: params only,
    no optimizer state, checked key by key and shape by shape against
    ``gpt_cfg`` and put on ``device`` (cuda unless asked). The counterpart
    of the JAX package's ``restore_inference_params``, which the sample and
    serve entry points share. None when no snapshot exists at ``path``; a
    directory (a sharded Orbax checkpoint of the JAX package) raises."""
    if os.path.isdir(path):
        raise NotImplementedError(
            f"{path} is a directory: sharded (Orbax) checkpoints are not "
            "ported yet (ROADMAP.md Queue 1 item 12b)")
    snap = load_snapshot(path)
    if snap is None:
        return None
    params = convert.params_from_numpy(snap["params"], gpt_cfg, device)
    return InferenceSnapshot(params, int(snap["step"]))
