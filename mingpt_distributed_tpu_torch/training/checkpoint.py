"""Training snapshots in the port's own format.

A snapshot holds params, optimizer state, step, epoch, the data iterator's
state, the dropout generator's state and the config dict (what the JAX
package's ``training/checkpoint.py`` ``Snapshot`` holds). The file is a
header line, ``FORMAT`` and the sha256 of the payload, then the payload
written by ``torch.save``. It is written to a temporary file and moved into
place with ``os.replace``, so a reader sees the old snapshot or the new one;
``load_snapshot`` checks the digest and raises on a torn or foreign file.
The JAX package's manifest, retry and keep-last-K machinery
(``training/durability.py``) is queued (ROADMAP.md Queue 1 item 1).
"""

from __future__ import annotations

import hashlib
import io
import os
from typing import Any, Dict, Optional

import torch

FORMAT = b"mingpt-torch-snapshot/1"
DEFAULT_SNAPSHOT_PATH = "gpt_snapshot.pt"


class SnapshotError(RuntimeError):
    """A snapshot file that is torn, corrupt or not of this format."""


def save_snapshot(path: str, snapshot: Dict[str, Any]) -> None:
    """Write ``snapshot`` (tensors, dicts, lists and scalars) atomically."""
    buf = io.BytesIO()
    torch.save(snapshot, buf)
    payload = buf.getvalue()
    header = FORMAT + b" " + hashlib.sha256(payload).hexdigest().encode() + b"\n"
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        f.write(header)
        f.write(payload)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def load_snapshot(path: str) -> Optional[Dict[str, Any]]:
    """The snapshot at ``path`` with tensors on the CPU, or None when there
    is no file. Raises SnapshotError when the file is not a whole snapshot
    of this format."""
    if not os.path.exists(path):
        return None
    with open(path, "rb") as f:
        blob = f.read()
    header, sep, payload = blob.partition(b"\n")
    fmt, _, digest = header.partition(b" ")
    if not sep or fmt != FORMAT:
        raise SnapshotError(f"{path} is not a snapshot of the PyTorch port "
                            f"({FORMAT.decode()})")
    if hashlib.sha256(payload).hexdigest().encode() != digest:
        raise SnapshotError(f"{path}: payload digest mismatch (torn or "
                            "corrupt file)")
    return torch.load(io.BytesIO(payload), map_location="cpu", weights_only=True)
