"""Durable snapshot I/O: error classification, retry with backoff and
seeded jitter, SHA-256 digests, and the commit manifest that keeps the
last K snapshots crash-consistent.

Counterpart of ``mingpt_distributed_tpu/training/durability.py``, kept as
the port's own copy, on local files. What it guards against:

* **transient I/O**: a read or write fails with an error that retrying can
  fix (EIO, a timeout, a reset connection): back off and retry;
* **a missing object**: ``FileNotFoundError`` or an ``ENOENT`` OSError,
  classified in one place so "fresh start" and "retry" are never confused;
* **torn or corrupt objects**: every committed object carries its SHA-256
  in the manifest, and restore checks it before trusting the bytes.

The commit protocol (``commit_blob``): the snapshot's bytes are written to
a step-suffixed object that nothing references yet (a temporary file,
fsynced, then ``os.replace``), then a small JSON manifest (the ``latest``
pointer and each snapshot's step, epoch, digest and size) is written last,
as the one commit point, and objects rotated out of the last ``keep`` are
deleted after it. A crash in between leaves the previous manifest, and
every object it names, intact. Restore (``read_verified``) walks the
manifest from newest to oldest and returns the first snapshot whose digest
matches and whose payload loads.

All I/O goes through one small file-system object (``LocalFileSystem``:
``open``, ``exists``, ``remove``, ``makedirs``, ``replace``), which
``training/faults.py`` wraps to inject faults. The manifest schema is the
JAX package's (version 2; snapshots of one object serialise as version 1
wrote them, and version 1 manifests load). A sharded entry (schema v2,
``commit_shards``: ZeRO runs write one object per dp shard) names its
shard objects (``ShardRef``: key, digest, size); every shard is written
before the one manifest write that commits them, and restore
(``read_verified_shards``) takes an entry only when every shard reads back
with its digest: one torn shard fails the whole entry, which falls back to
the one before.
"""

from __future__ import annotations

import dataclasses
import errno
import hashlib
import json
import os
import random
import time
from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional, Tuple

from mingpt_distributed_tpu_torch.telemetry import log_event

MANIFEST_VERSION = 2
#: versions ``Manifest.from_json`` accepts
SUPPORTED_MANIFEST_VERSIONS = (1, 2)
MANIFEST_SUFFIX = ".manifest.json"

MISSING = "missing"
TRANSIENT = "transient"
PERMANENT = "permanent"

# errno values that mean "the object is not there", not "the store hiccuped"
_MISSING_ERRNOS = {errno.ENOENT}
# errors that retrying cannot fix
_PERMANENT_OSERRORS = (PermissionError, IsADirectoryError, NotADirectoryError)


def classify_io_error(exc: BaseException) -> str:
    """``missing`` | ``transient`` | ``permanent``: one verdict shared by the
    retry loop (which retries only ``transient``) and restore (where only
    ``missing`` means a fresh start)."""
    if isinstance(exc, _PERMANENT_OSERRORS):
        return PERMANENT
    if isinstance(exc, FileNotFoundError):
        return MISSING
    if isinstance(exc, OSError):
        if exc.errno in _MISSING_ERRNOS:
            return MISSING
        return TRANSIENT  # EIO, TimeoutError, ConnectionError, ...
    return PERMANENT


def is_missing_error(exc: BaseException) -> bool:
    return classify_io_error(exc) == MISSING


class SnapshotIntegrityError(RuntimeError):
    """A snapshot that failed its digest or its deserialisation; from
    restore: every snapshot the manifest names did. Restoring would load
    corrupt state, and a fresh start would let the next save overwrite the
    evidence."""


# -- retry ---------------------------------------------------------------------


@dataclass
class RetryPolicy:
    """Exponential backoff with jitter: delay i is base * multiplier^i
    (capped at ``max_delay_s``), less up to ``jitter`` of it at random from
    a generator seeded with ``seed``. ``sleep`` is injectable, so tests run
    with no wall-clock delay."""

    attempts: int = 4
    base_delay_s: float = 0.5
    max_delay_s: float = 8.0
    multiplier: float = 2.0
    jitter: float = 0.25
    seed: Optional[int] = None
    sleep: Callable[[float], None] = time.sleep

    def delays(self):
        rng = random.Random(self.seed)
        d = self.base_delay_s
        for _ in range(max(self.attempts - 1, 0)):
            yield d * (1.0 - self.jitter * rng.random())
            d = min(d * self.multiplier, self.max_delay_s)


#: no sleeping: for tests
NO_WAIT = RetryPolicy(attempts=4, base_delay_s=0.0, seed=0, sleep=lambda _: None)


def with_retries(fn: Callable[[], Any], policy: Optional[RetryPolicy] = None,
                 op: str = "io") -> Any:
    """``fn()``, retrying transient failures as ``policy`` says. Missing and
    permanent errors raise at once; the last transient error raises when
    the attempts are spent."""
    policy = policy or RetryPolicy()
    delays = policy.delays()
    attempt = 1
    while True:
        try:
            return fn()
        except BaseException as e:  # noqa: BLE001 (classified below)
            if classify_io_error(e) != TRANSIENT:
                raise
            try:
                delay = next(delays)
            except StopIteration:
                raise e
            log_event(f"[durability] transient {op} error (attempt {attempt}/"
                      f"{policy.attempts}): {e!r}; retrying in {delay:.2f}s")
            policy.sleep(delay)
            attempt += 1


def sha256_hex(blob: bytes) -> str:
    return hashlib.sha256(blob).hexdigest()


# -- the file system -------------------------------------------------------------


class LocalFileSystem:
    """Local files: the durability layer's default file system."""

    def open(self, path: str, mode: str = "rb"):
        return open(path, mode)

    def exists(self, path: str) -> bool:
        return os.path.exists(path)

    def remove(self, path: str) -> None:
        os.remove(path)

    def makedirs(self, path: str, exist_ok: bool = True) -> None:
        os.makedirs(path, exist_ok=exist_ok)

    def replace(self, src: str, dst: str) -> None:
        os.replace(src, dst)


LOCAL = LocalFileSystem()


def _fsync(f) -> None:
    """Force a written file's bytes to disk; a file object with no
    descriptor (an in-memory wrapper) has none to sync."""
    try:
        fd = f.fileno()
    except (AttributeError, OSError, ValueError):
        return
    os.fsync(fd)


def write_bytes(path: str, blob: bytes, policy: Optional[RetryPolicy] = None,
                fs: LocalFileSystem = LOCAL) -> None:
    """Write ``blob`` to ``path`` with retries: a temporary file, fsynced,
    then moved into place, so a killed writer never leaves a torn file
    under the final name."""
    def put():
        fs.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        with fs.open(tmp, "wb") as f:
            f.write(blob)
            f.flush()
            _fsync(f)
        fs.replace(tmp, path)
    with_retries(put, policy, op=f"write {path}")


def read_bytes(path: str, policy: Optional[RetryPolicy] = None,
               fs: LocalFileSystem = LOCAL) -> bytes:
    """The bytes at ``path``, retrying transient errors; a missing file
    raises at once (the caller decides what missing means)."""
    def get():
        with fs.open(path, "rb") as f:
            return f.read()
    return with_retries(get, policy, op=f"read {path}")


def delete_quiet(path: str, fs: LocalFileSystem = LOCAL) -> None:
    """Best-effort delete (rotation): a leftover rotated-out object is
    garbage, not a fault, so this never raises."""
    try:
        fs.remove(path)
    except BaseException:  # noqa: BLE001
        pass


# -- the commit manifest -----------------------------------------------------------


@dataclass
class ShardRef:
    """One object of a sharded snapshot entry (schema v2)."""

    key: str      # object key, relative to the manifest's directory
    sha256: str
    size: int


@dataclass
class ManifestEntry:
    key: str      # object key, relative to the manifest's directory
    step: int
    epoch: int
    sha256: str   # the object's digest; a sharded entry's: of its shards' digests
    size: int     # the object's size; a sharded entry's: its shards' total
    #: schema v2: the shard objects of a sharded snapshot; ``key`` then
    #: names shard 0
    shards: Optional[List[ShardRef]] = None

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        if self.shards is None:
            del d["shards"]  # one-object entries serialise as schema v1 wrote them
        return d

    @classmethod
    def from_dict(cls, raw: dict) -> "ManifestEntry":
        raw = dict(raw)
        shards = raw.pop("shards", None)
        if shards is not None:
            shards = [ShardRef(**r) for r in shards]
        return cls(shards=shards, **raw)

    def shard_refs(self) -> List[ShardRef]:
        """The entry's objects; a one-object entry is its own one shard."""
        if self.shards is not None:
            return list(self.shards)
        return [ShardRef(key=self.key, sha256=self.sha256, size=self.size)]


@dataclass
class Manifest:
    """The ``latest`` pointer and the snapshot history, oldest first,
    committed as one small JSON write."""

    entries: List[ManifestEntry] = field(default_factory=list)

    @property
    def latest(self) -> Optional[ManifestEntry]:
        return self.entries[-1] if self.entries else None

    def to_json(self) -> str:
        return json.dumps({
            "version": MANIFEST_VERSION,
            "latest": self.latest.key if self.latest else None,
            "checkpoints": [e.to_dict() for e in self.entries],
        }, indent=2)

    @classmethod
    def from_json(cls, text: str) -> "Manifest":
        raw = json.loads(text)
        if raw.get("version") not in SUPPORTED_MANIFEST_VERSIONS:
            raise ValueError(f"manifest version {raw.get('version')} not in "
                             f"{SUPPORTED_MANIFEST_VERSIONS}")
        return cls(entries=[ManifestEntry.from_dict(e)
                            for e in raw.get("checkpoints", [])])


def manifest_path(snapshot_path: str) -> str:
    return snapshot_path + MANIFEST_SUFFIX


def object_key(snapshot_path: str, step: int) -> str:
    """The step-suffixed object next to ``snapshot_path`` (never the bare
    path, which is left to the legacy single-file layout)."""
    return f"{snapshot_path}.step-{step:08d}"


def shard_key(snapshot_path: str, step: int, i: int, n: int) -> str:
    """The object of shard ``i`` of an ``n``-shard snapshot (schema v2)."""
    return f"{object_key(snapshot_path, step)}.shard-{i:04d}-of-{n:04d}"


def _sibling(snapshot_path: str, key: str) -> str:
    """A manifest-relative key as a path next to the snapshot path."""
    return os.path.join(os.path.dirname(snapshot_path), key)


def load_manifest(snapshot_path: str, policy: Optional[RetryPolicy] = None,
                  fs: LocalFileSystem = LOCAL) -> Optional[Manifest]:
    """The manifest, or None when there is none (legacy layout or a fresh
    run). Transient errors retry, then raise: never taken for "none"."""
    try:
        text = read_bytes(manifest_path(snapshot_path), policy, fs)
    except BaseException as e:  # noqa: BLE001
        if is_missing_error(e):
            return None
        raise
    return Manifest.from_json(text.decode("utf-8"))


def _commit_entry(snapshot_path: str, entry: ManifestEntry, keep: int,
                  policy: Optional[RetryPolicy], fs: LocalFileSystem) -> ManifestEntry:
    """Replace any entry of the same step, append, keep the last ``keep``,
    write the manifest (the commit point), then delete the objects rotated
    out, only once the manifest no longer names them."""
    if keep < 1:
        raise ValueError(f"keep must be >= 1, got {keep}")
    manifest = load_manifest(snapshot_path, policy, fs) or Manifest()
    manifest.entries = [e for e in manifest.entries if e.step != entry.step]
    manifest.entries.append(entry)
    dropped = manifest.entries[:-keep]
    manifest.entries = manifest.entries[-keep:]
    write_bytes(manifest_path(snapshot_path), manifest.to_json().encode(), policy, fs)
    for old in dropped:
        for ref in old.shard_refs():
            delete_quiet(_sibling(snapshot_path, ref.key), fs)
    return entry


def commit_blob(snapshot_path: str, blob: bytes, step: int, epoch: int,
                keep: int = 3, policy: Optional[RetryPolicy] = None,
                fs: LocalFileSystem = LOCAL) -> ManifestEntry:
    """The durable write: the object first (under a key nothing references
    yet), the manifest second (the commit point), rotation last (best
    effort). Returns the committed entry."""
    if keep < 1:
        raise ValueError(f"keep must be >= 1, got {keep}")
    key_path = object_key(snapshot_path, step)
    write_bytes(key_path, blob, policy, fs)
    entry = ManifestEntry(key=os.path.basename(key_path), step=int(step),
                          epoch=int(epoch), sha256=sha256_hex(blob), size=len(blob))
    return _commit_entry(snapshot_path, entry, keep, policy, fs)


def commit_shards(snapshot_path: str, blobs: List[bytes], step: int, epoch: int,
                  keep: int = 3, policy: Optional[RetryPolicy] = None,
                  fs: LocalFileSystem = LOCAL) -> ManifestEntry:
    """Commit one snapshot as ``len(blobs)`` objects (schema v2): every
    shard is written (each under its own uncommitted key, each write
    retried) before the one manifest write commits them as a unit, so a
    crash or spent retries midway leave the previous snapshot whole. One
    blob is ``commit_blob``'s entry, byte for byte."""
    if keep < 1:
        raise ValueError(f"keep must be >= 1, got {keep}")
    if not blobs:
        raise ValueError("commit_shards needs at least one shard")
    if len(blobs) == 1:
        return commit_blob(snapshot_path, blobs[0], step, epoch, keep, policy, fs)
    refs = []
    for i, blob in enumerate(blobs):
        key_path = shard_key(snapshot_path, step, i, len(blobs))
        write_bytes(key_path, blob, policy, fs)
        refs.append(ShardRef(key=os.path.basename(key_path), sha256=sha256_hex(blob),
                             size=len(blob)))
    entry = ManifestEntry(key=refs[0].key, step=int(step), epoch=int(epoch),
                          sha256=sha256_hex("".join(r.sha256 for r in refs).encode()),
                          size=sum(r.size for r in refs), shards=refs)
    return _commit_entry(snapshot_path, entry, keep, policy, fs)


def read_verified_shards(snapshot_path: str, manifest: Manifest,
                         policy: Optional[RetryPolicy] = None,
                         load: Callable[[List[bytes], ManifestEntry], Any]
                         = lambda blobs, entry: blobs,
                         fs: LocalFileSystem = LOCAL) -> Tuple[Any, ManifestEntry]:
    """Walk the manifest from newest to oldest and return ``(load(blobs,
    entry), entry)`` for the first snapshot whose every object reads back
    with its digest and whose payload loads (``load`` raises
    SnapshotIntegrityError for one it cannot take). A one-object entry is
    a one-shard snapshot. Any unreadable, torn or corrupt shard fails the
    whole entry, which falls back to the one before; a permanent I/O error
    raises; when none is good, SnapshotIntegrityError."""
    failures = []
    for entry in reversed(manifest.entries):
        blobs = []
        for ref in entry.shard_refs():
            try:
                blob = read_bytes(_sibling(snapshot_path, ref.key), policy, fs)
            except BaseException as e:  # noqa: BLE001
                if classify_io_error(e) == PERMANENT:
                    raise
                failures.append(f"{ref.key}: unreadable ({e!r})")
                break
            digest = sha256_hex(blob)
            if digest != ref.sha256:
                failures.append(f"{ref.key}: digest mismatch (manifest "
                                f"{ref.sha256[:12]}..., got {digest[:12]}..., "
                                f"{len(blob)}/{ref.size} bytes)")
                break
            blobs.append(blob)
        else:
            try:
                loaded = load(blobs, entry)
            except SnapshotIntegrityError as e:
                failures.append(f"{entry.key}: {e}")
                continue
            if failures:
                log_event(f"[durability] fell back to checkpoint step {entry.step} "
                          "after: " + "; ".join(failures))
            return loaded, entry
    raise SnapshotIntegrityError(
        f"no checkpoint in {manifest_path(snapshot_path)} passed verification: "
        + "; ".join(failures))


def read_verified(snapshot_path: str, manifest: Manifest,
                  policy: Optional[RetryPolicy] = None,
                  load: Callable[[bytes, str], Any] = lambda blob, key: blob,
                  fs: LocalFileSystem = LOCAL) -> Tuple[Any, ManifestEntry]:
    """``read_verified_shards`` for one payload: ``load(bytes, key)`` of the
    first good snapshot's bytes (a sharded entry's shards joined, which only
    a loader of that framing can take)."""
    return read_verified_shards(snapshot_path, manifest, policy,
                                lambda blobs, entry: load(b"".join(blobs), entry.key), fs)
