"""Sharded directory snapshots: each rank writes its own slices, nothing is
gathered.

Counterpart of ``mingpt_distributed_tpu/training/checkpoint_orbax.py``,
built on ``torch.distributed.checkpoint`` (DCP) where the JAX package uses
Orbax. The one-file snapshot (``training/checkpoint.py``) gathers the whole
state onto one writer, which is refused above
``msgpack_gather_limit_mb``; this backend has no such limit.

* **Save** is collective: every rank calls it. Each leaf (the parameters
  and the two Adam moments) goes to DCP as a ``DTensor`` over a
  ``DeviceMesh`` of the job's axes above 1, whose placements come from the
  leaf's effective spec (``PARAM_RULES`` after ``shard_by_rule``'s
  downgrades, ``Mesh.specs``): DCP records each slice's offset in the
  whole leaf, writes each slice once (a slice several ranks hold is
  written by one of them) and can reshard on load. The rest (step, epoch,
  the Adam count, the generator state, the data iterator's state, the
  config, and each data file's size) is JSON beside it, ``META``.
* **Commit** is atomic: the ranks write ``<path>.tmp``, rank 0 writes the
  JSON last, then, after a barrier, moves the old directory aside, renames
  the new one into place and deletes the old one (the Orbax
  tmp-dir-and-rename). Saving overwrites in place, as ``force=True`` does
  in JAX; a crash between the two renames leaves ``<path>.old``, which a
  load takes.
* **Load** restores each rank's slices at the *current* mesh, whatever mesh
  saved them, in place into the trainer's tensors (``restore``); in one
  process with no process group it reads whole leaves (``read_params``:
  ``sample.py`` and ``serve.py``). A missing or empty directory means a
  fresh start; transient I/O errors are retried (``training/durability``).
  A directory without ``META`` raises ``ForeignCheckpointError`` naming
  what it found (a JAX Orbax checkpoint, a DCP directory of another
  program), and a torn ``META`` or data file raises
  ``SnapshotIntegrityError``.
* Transient-I/O retries of a save run only in a one-process job, as in
  ``checkpoint_orbax.py``: ranks retrying a collective save on their own
  would fall out of step.

``save`` and ``restore`` take the trainer's parameter tree (this rank's
slices), its ``AdamW`` and its ``Mesh`` (None in one process); the JSON
fields are the caller's.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import shutil
import warnings
from typing import Any, Dict, Optional

import torch

from mingpt_distributed_tpu_torch.parallel import distributed as D
from mingpt_distributed_tpu_torch.parallel import mesh as mesh_lib
from mingpt_distributed_tpu_torch.training import durability
from mingpt_distributed_tpu_torch.training.durability import (
    LOCAL,
    LocalFileSystem,
    RetryPolicy,
    SnapshotIntegrityError,
)

FORMAT = "mingpt-torch-sharded/1"
META = "mingpt_snapshot.json"


class ForeignCheckpointError(SnapshotIntegrityError):
    """A directory that is not a sharded snapshot of the port."""


def is_sharded_path(path: str) -> bool:
    """The backend rule: a path ending in ``.pt`` or ``.msgpack`` is a
    one-file snapshot (``training/checkpoint.py``); any other path is a
    sharded directory."""
    return not path.endswith((".pt", ".msgpack"))


def _tmp(path: str) -> str:
    return path.rstrip(os.sep) + ".tmp"


def _old(path: str) -> str:
    return path.rstrip(os.sep) + ".old"


def _flat(tree: Dict, prefix: str = "") -> Dict[str, torch.Tensor]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _device_mesh(mesh, device_type: str):
    """The DCP view of ``mesh``: a DeviceMesh over its axes above 1 (the
    ranks in the mesh's row-major order), made once per mesh and device
    type (making one is collective)."""
    from torch.distributed.device_mesh import init_device_mesh

    cache = mesh.__dict__.setdefault("_dcp_meshes", {})
    if device_type not in cache:
        names = tuple(a for a in mesh_lib.AXES if mesh.shape[a] > 1)
        cache[device_type] = (init_device_mesh(
            device_type, tuple(mesh.shape[a] for a in names), mesh_dim_names=names), names)
    return cache[device_type]


def _dtensor(mesh, path: str, local: torch.Tensor):
    """``local`` (this rank's slice of the leaf at ``path``) as a DTensor
    whose placements follow the leaf's effective spec."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    dmesh, names = _device_mesh(mesh, local.device.type)
    spec = mesh.specs.get(path, ())
    placements = [Shard(spec.index(a)) if a in spec else Replicate() for a in names]
    shape = mesh.full_shapes.get(path, tuple(local.shape))
    stride = tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))
    return DTensor.from_local(local, dmesh, placements, run_check=False,
                              shape=torch.Size(shape), stride=stride)


def _state_dict(params: Dict, mu: Optional[Dict], nu: Optional[Dict], mesh
                ) -> Dict[str, Dict]:
    """The DCP state dict over the live tensors (shared storage, so a load
    writes into them): every leaf and, given, both Adam moments by leaf
    path, each a DTensor in a job of several ranks."""
    groups = {"params": {n: p.detach() for n, p in _flat(params).items()}}
    if mu is not None:
        groups["exp_avg"], groups["exp_avg_sq"] = mu, nu
    if mesh is None or mesh.world_size == 1:
        return groups
    return {g: {n: _dtensor(mesh, n, t) for n, t in leaves.items()}
            for g, leaves in groups.items()}


@contextlib.contextmanager
def _one_process_quiet():
    """DCP warns on every call that it runs in one process, which is what
    ``no_dist`` asks for."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="torch.distributed is disabled")
        yield


def _file_sizes(root: str) -> Dict[str, int]:
    return {f: os.path.getsize(os.path.join(root, f)) for f in sorted(os.listdir(root))
            if f != META}


def save(path: str, params: Dict, optimizer, mesh, meta: Dict[str, Any],
         retry: Optional[RetryPolicy] = None, fs: LocalFileSystem = LOCAL) -> None:
    """Collective save of this rank's slices of ``params`` and of
    ``optimizer``'s moments to the directory ``path``, with ``meta`` (JSON:
    step, epoch, generator, data_state, config) beside them. Every rank
    calls it."""
    import torch.distributed.checkpoint as dcp

    ranks = 1 if mesh is None else mesh.world_size
    main = D.rank() == 0
    tmp = _tmp(path)
    adam = optimizer.adam_state() if optimizer is not None else {"count": 0}
    shapes = {n: list(mesh.full_shapes.get(n, p.shape) if mesh is not None else p.shape)
              for n, p in _flat(params).items()}

    def write():
        if main and os.path.exists(tmp):
            shutil.rmtree(tmp)
        D.barrier()
        moments = (adam["mu"], adam["nu"]) if adam["count"] else (None, None)
        with _one_process_quiet():
            dcp.save(_state_dict(params, *moments, mesh), checkpoint_id=tmp,
                     no_dist=ranks == 1)
        D.barrier()
        if main:
            body = dict(meta, format=FORMAT, adam_count=int(adam["count"]),
                        ranks=ranks, shapes=shapes, files=_file_sizes(tmp))
            # retried with the whole save, in one process only
            durability.write_bytes(os.path.join(tmp, META), json.dumps(body).encode(),
                                   RetryPolicy(attempts=1), fs)

    if ranks == 1:
        durability.with_retries(write, retry, op=f"sharded save {path}")
    else:
        write()
    D.barrier()
    if main:
        old = _old(path)
        if os.path.exists(old):
            shutil.rmtree(old)
        if os.path.exists(path):
            fs.replace(path, old)
        fs.replace(tmp, path)
        if os.path.exists(old):
            shutil.rmtree(old)
    D.barrier()


def _found(root: str) -> str:
    """What a directory without ``META`` holds, in words."""
    names = set(os.listdir(root))
    if "_CHECKPOINT_METADATA" in names or {"state", "meta"} <= names:
        return "a JAX Orbax checkpoint (mingpt_distributed_tpu's sharded backend)"
    if ".metadata" in names:
        return "a torch.distributed.checkpoint directory of another program"
    shown = ", ".join(sorted(names)[:5])
    return f"an unknown layout ({shown}{', ...' if len(names) > 5 else ''})"


def committed(path: str) -> Optional[str]:
    """The committed directory for ``path`` (``<path>.old`` after a crash
    between the commit's renames), or None when there is none (missing or
    empty: a fresh start)."""
    for root in (path, _old(path)):
        if os.path.isdir(root) and os.listdir(root):
            return root
    return None


def read_meta(path: str, retry: Optional[RetryPolicy] = None,
              fs: LocalFileSystem = LOCAL) -> Optional[Dict[str, Any]]:
    """The ``META`` of the snapshot committed at ``path`` (with ``root``,
    the directory read), None when there is none. Raises
    ``ForeignCheckpointError`` for a directory of another format and
    ``SnapshotIntegrityError`` for a torn one."""
    root = committed(path)
    if root is None:
        one_file = [p for p in (path, durability.manifest_path(path)) if os.path.isfile(p)]
        if one_file:  # never a fresh start over a snapshot of the other backend
            raise ForeignCheckpointError(
                f"{one_file[0]} is a one-file snapshot, but {path!r} names the sharded "
                "directory backend: give its path a .pt or .msgpack suffix")
        return None
    meta_path = os.path.join(root, META)
    try:
        blob = durability.read_bytes(meta_path, retry, fs)
    except BaseException as e:  # noqa: BLE001 (classified, not blanket)
        if durability.is_missing_error(e):
            raise ForeignCheckpointError(
                f"{root} is not a sharded snapshot of the PyTorch port (no {META}): "
                f"it holds {_found(root)}, which the port cannot read") from None
        raise
    try:
        meta = json.loads(blob.decode())
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise SnapshotIntegrityError(f"{meta_path} is torn or corrupt: {e}") from None
    if meta.get("format") != FORMAT:
        raise ForeignCheckpointError(f"{meta_path}: format {meta.get('format')!r}, "
                                     f"want {FORMAT!r}")
    sizes = _file_sizes(root)
    if sizes != meta["files"]:
        raise SnapshotIntegrityError(
            f"{root}: data files {sizes} differ from the committed {meta['files']} "
            "(torn or partial write)")
    return dict(meta, root=root)


def _load(root: str, state: Dict, retry: Optional[RetryPolicy],
          one_process: bool = False) -> None:
    """DCP's load into ``state``; ``one_process``: this process alone,
    even inside a job (no collective)."""
    import torch.distributed.checkpoint as dcp

    no_dist = one_process or D.world_size() == 1

    def load():
        with _one_process_quiet():
            dcp.load(state, checkpoint_id=root, no_dist=no_dist)

    durability.with_retries(load, retry, op=f"sharded load {root}")


def restore(path: str, params: Dict, optimizer, mesh,
            retry: Optional[RetryPolicy] = None,
            fs: LocalFileSystem = LOCAL) -> Optional[Dict[str, Any]]:
    """Collective load of the snapshot at ``path`` into this rank's slices
    of ``params`` and of ``optimizer``'s moments (at the current mesh) ->
    its ``META``, or None when there is no snapshot (the tensors are left
    as they are). Every rank calls it."""
    meta = read_meta(path, retry, fs)
    if meta is None:
        return None
    count = int(meta["adam_count"])
    mu = nu = None
    if count and optimizer is not None:
        optimizer.init_moments()
        adam = optimizer.adam_state()
        mu, nu = adam["mu"], adam["nu"]
        for st in optimizer.opt.state.values():
            st["step"] = torch.tensor(float(count))
    with torch.no_grad():
        _load(meta["root"], _state_dict(params, mu, nu, mesh), retry)
    return meta


def read_params(path: str, like: Dict[str, torch.Tensor],
                retry: Optional[RetryPolicy] = None) -> Optional[Dict[str, Any]]:
    """One process, no process group: the whole parameters of the snapshot
    at ``path`` into new float32 CPU tensors shaped like ``like`` ({path:
    shape}) -> {"params": {path: tensor}, "step": int}, or None when there
    is no snapshot."""
    meta = read_meta(path, retry)
    if meta is None:
        return None
    saved = {n: tuple(s) for n, s in meta["shapes"].items()}
    want = {n: tuple(s) for n, s in like.items()}
    if saved != want:
        wrong = sorted(set(saved) ^ set(want)) or [n for n in want if saved[n] != want[n]]
        raise ValueError(f"sharded snapshot {meta['root']}: leaves or shape of {wrong[:4]} "
                         f"do not match the config's (saved {[saved.get(n) for n in wrong[:4]]}, "
                         f"want {[want.get(n) for n in wrong[:4]]})")
    state = {"params": {n: torch.empty(s, dtype=torch.float32) for n, s in want.items()}}
    _load(meta["root"], state, retry, one_process=True)
    return {"params": state["params"], "step": int(meta["step"])}


def written_bytes(path: str) -> Dict[str, int]:
    """The tensor bytes each data file of the snapshot at ``path`` holds
    (``__<rank>_0.distcp``: the rank that wrote it), from DCP's metadata."""
    from torch.distributed.checkpoint import FileSystemReader

    md = FileSystemReader(committed(path) or path).read_metadata()
    out: Dict[str, int] = {}
    for index, info in md.storage_data.items():
        tmd = md.state_dict_metadata[index.fqn]
        chunk = next(c for c in tmd.chunks if tuple(c.offsets) == tuple(index.offset))
        itemsize = torch.empty((), dtype=tmd.properties.dtype).element_size()
        out[info.relative_path] = (out.get(info.relative_path, 0)
                                   + math.prod(chunk.sizes) * itemsize)
    return out
