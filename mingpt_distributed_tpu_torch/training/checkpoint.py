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

``save_snapshot(shards=n)`` (ZeRO runs pass their dp extent, as the JAX
trainer does) writes ``n`` objects behind one manifest entry (schema v2,
``durability.commit_shards``): every tensor of ``params`` and
``opt_state`` is flattened and cut into ``n`` contiguous near-equal chunks,
shard i holding chunk i of each, and shard 0 also the rest of the snapshot
and every tensor's shape. The contents do not depend on the layout, so any
shard count restores; ``shards=1`` is the one-object save, byte for byte.
"""

from __future__ import annotations

import hashlib
import io
import math
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
#: the ``version`` of one shard's payload in a sharded snapshot
SHARDED_SNAPSHOT_VERSION = 2
#: the tensor-holding parts of a snapshot that a sharded save splits
SPLIT_KEYS = ("params", "opt_state")
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


def _chunk(tree: Any, i: int, n: int) -> Any:
    """Shard ``i`` of a tree: every tensor flattened and cut into ``n``
    contiguous chunks (a 0-d tensor lands in shard 0); anything else whole
    in shard 0."""
    if isinstance(tree, dict):
        return {k: _chunk(v, i, n) for k, v in tree.items()}
    if torch.is_tensor(tree):
        return tree.detach().reshape(-1).tensor_split(n)[i].clone()
    return tree if i == 0 else None


def _shapes(tree: Any) -> Any:
    """Each tensor's shape (an int64 tensor) where the tree holds one."""
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if torch.is_tensor(tree):
        return torch.tensor(list(tree.shape), dtype=torch.int64)
    return None


def _assemble(shapes: Any, parts: list, source: str) -> Any:
    """Inverse of ``_chunk`` over the shards' parts, against shard 0's
    shapes."""
    if isinstance(shapes, dict):
        try:
            return {k: _assemble(v, [p[k] for p in parts], source)
                    for k, v in shapes.items()}
        except (KeyError, TypeError) as e:
            raise SnapshotError(f"{source}: a shard lacks {e}") from None
    if torch.is_tensor(shapes):
        flat = torch.cat([p.reshape(-1) for p in parts])
        want = [int(d) for d in shapes.tolist()]
        if flat.numel() != math.prod(want):
            raise SnapshotError(f"{source}: chunks of {flat.numel()} elements for "
                                f"shape {want}")
        return flat.reshape(want)
    return parts[0]


def save_snapshot(path: str, snapshot: Dict[str, Any], keep: int = DEFAULT_KEEP,
                  retry: Optional[RetryPolicy] = None,
                  fs: LocalFileSystem = LOCAL, shards: int = 1) -> None:
    """Commit ``snapshot`` (tensors, dicts, lists and scalars, with ``step``
    and ``epoch``) as the newest of the last ``keep`` snapshots at
    ``path``; ``shards > 1`` writes that many objects (schema v2)."""
    step, epoch = int(snapshot["step"]), int(snapshot.get("epoch", 0))
    if shards <= 1:
        durability.commit_blob(path, encode(snapshot), step=step, epoch=epoch,
                               keep=keep, policy=retry, fs=fs)
        return
    rest = {k: v for k, v in snapshot.items() if k not in SPLIT_KEYS}
    blobs = []
    for i in range(shards):
        payload = {"version": SHARDED_SNAPSHOT_VERSION, "shard": i, "n_shards": shards,
                   "step": step, "epoch": epoch,
                   "state": {k: _chunk(snapshot[k], i, shards)
                             for k in SPLIT_KEYS if k in snapshot}}
        if i == 0:  # the rest rides in shard 0 only
            payload["rest"] = rest
            payload["shapes"] = {k: _shapes(snapshot[k]) for k in SPLIT_KEYS
                                 if k in snapshot}
        blobs.append(encode(payload))
    durability.commit_shards(path, blobs, step=step, epoch=epoch, keep=keep,
                             policy=retry, fs=fs)


def _load_entry(blobs, entry) -> Dict[str, Any]:
    """A committed entry's snapshot: one object's, or a sharded entry's
    shards joined (any shard count)."""
    if entry.shards is None:
        return decode(blobs[0], entry.key)
    parts = [decode(b, ref.key) for b, ref in zip(blobs, entry.shards)]
    n = len(parts)
    framing = [(p.get("version"), p.get("shard"), p.get("n_shards")) for p in parts]
    if framing != [(SHARDED_SNAPSHOT_VERSION, i, n) for i in range(n)]:
        raise SnapshotError(f"sharded snapshot at step {entry.step} has "
                            f"inconsistent framing {framing}")
    head = parts[0]
    snapshot = dict(head["rest"])
    for k, shapes in head["shapes"].items():
        snapshot[k] = _assemble(shapes, [p["state"][k] for p in parts],
                                f"sharded snapshot at step {entry.step}")
    return snapshot


def load_snapshot(path: str, retry: Optional[RetryPolicy] = None,
                  fs: LocalFileSystem = LOCAL) -> Optional[Dict[str, Any]]:
    """The newest good snapshot at ``path`` with tensors on the CPU, or None
    when there is none. Raises SnapshotIntegrityError when every snapshot
    the manifest names is bad (or the legacy file is), and a transient I/O
    error once its retries are spent."""
    manifest = durability.load_manifest(path, retry, fs)
    if manifest is not None and manifest.entries:
        snapshot, _ = durability.read_verified_shards(path, manifest, retry,
                                                      load=_load_entry, fs=fs)
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
    serve entry points share: a path ending in ``.pt`` or ``.msgpack`` is a
    one-file snapshot, any other a sharded directory
    (``training/checkpoint_sharded.py``), read whole in this process with
    no process group. None when no snapshot exists at ``path``."""
    from mingpt_distributed_tpu_torch.training import checkpoint_sharded

    if checkpoint_sharded.is_sharded_path(path):
        from mingpt_distributed_tpu_torch.models import gpt

        shapes = {n: shape for n, (shape, _) in convert.flatten(gpt.param_spec(gpt_cfg)).items()}
        snap = checkpoint_sharded.read_params(path, shapes)
        if snap is None:
            return None
        snap["params"] = convert.unflatten(snap["params"])
    else:
        snap = load_snapshot(path)
        if snap is None:
            return None
    params = convert.params_from_numpy(snap["params"], gpt_cfg, device)
    return InferenceSnapshot(params, int(snap["step"]))
