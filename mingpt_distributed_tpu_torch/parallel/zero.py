"""ZeRO-style cross-replica weight-update sharding over the ``dp`` axis.

Counterpart of ``mingpt_distributed_tpu/parallel/zero.py`` ("Automatic
Cross-Replica Sharding of Weight Update in Data-Parallel Training",
arXiv 2004.13336). Without it every dp replica holds the whole Adam
moments and computes the same whole update. With it (``zero_dp``) each dp
rank

  reduce-scatters the gradients over dp  ->  clips them by the global norm
  ->  runs Adam, decay and the learning rate on its 1/dp of every leaf  ->
  all-gathers the updated parameters,

so its moments are 1/dp of the dense ones (``training/optimizer.py`` runs
the phase). A static per-leaf ``ZeroPlan`` decides the layout, as in JAX:

* **dim mode**: the largest dimension whose size the dp extent (times the
  extent of the axes already sharding it) divides is split over dp; the
  plan's spec appends ``"dp"`` to that dimension's entry.
* **flat mode**: a leaf no dimension of which divides is flattened and
  zero-padded to a multiple of dp. Pad gradients are zero, so their
  moments and updates stay zero and they add nothing to the norm;
  ``from_local_view`` drops them.
* **noop**: dp is 1.

``make_plan`` picks the same mode, dimension and pad as the JAX package's
over the spec ``mesh.shard_by_rule`` leaves after downgrades, so ``dp``
composes with fsdp, tp and ep as there. Each rank applies the plan to its
own fsdp/tp/ep slice of a leaf (``local_view``): a dimension the plan
splits over dp divides in the slice too. A flat-mode leaf is flattened
from the slice the rank holds (the JAX package flattens the whole leaf and
replicates the flat view over fsdp and tp): the same numbers in each
moment, padded per slice.

Snapshots keep the **canonical** layout (``AdamW.canonical_state_dict``
gathers each moment's shards over dp and drops the pad;
``load_canonical_state_dict`` cuts a restored moment to the restoring
rank's shard): a snapshot is the same with ``zero_dp`` on or off, and
restores at any dp extent, since the view is a function of the restoring
mesh.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Iterator, Optional, Tuple, Union

import torch

from mingpt_distributed_tpu_torch.parallel import mesh as mesh_lib

DIM = "dim"    # split one dp-divisible dimension over dp
FLAT = "flat"  # flatten, zero-pad to a multiple of dp, split over dp
NOOP = "noop"  # dp 1: the view is the identity

Entry = Union[None, str, Tuple[str, ...]]


@dataclass(frozen=True)
class LeafPlan:
    """The update-view layout of one parameter leaf."""

    name: str                      # the leaf's path, e.g. "blocks/wq"
    mode: str
    shape: Tuple[int, ...]         # canonical (model) shape
    view_shape: Tuple[int, ...]    # shape of the whole update view
    spec: Tuple[Entry, ...]        # partition spec of the update view
    dim: int = -1                  # the dimension split over dp (dim mode)
    pad: int = 0                   # zero slots appended (flat mode)


@dataclass(frozen=True)
class ZeroPlan:
    """Every leaf's plan by path, and the mesh extents it was made for."""

    shape: Dict[str, int]
    dp: int
    by_name: Dict[str, LeafPlan]


def leaves(tree: Dict, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(path, leaf) of a nested dict, depth first in insertion order."""
    for name, leaf in tree.items():
        if isinstance(leaf, dict):
            yield from leaves(leaf, f"{prefix}{name}/")
        else:
            yield f"{prefix}{name}", leaf


def _axes(entry: Entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def _shape_of(leaf) -> Tuple[int, ...]:
    return tuple(int(d) for d in (leaf.shape if hasattr(leaf, "shape") else leaf))


def make_plan(mesh, params: Dict) -> ZeroPlan:
    """The static per-leaf plan from the parameter tree (tensors, or shape
    tuples) and a mesh (a ``parallel.mesh.Mesh`` or a dict of axis
    extents). The base spec is the PARAM_RULES spec after
    ``shard_by_rule``'s downgrades."""
    shape = dict(getattr(mesh, "shape", mesh))
    dp = int(shape["dp"])
    by_name: Dict[str, LeafPlan] = {}
    for path, leaf in leaves(params):
        name = path.rsplit("/", 1)[-1]
        dims = _shape_of(leaf)
        entries = list(mesh_lib.shard_by_rule(shape, dims, mesh_lib.PARAM_RULES[name],
                                              name=name))
        if dp <= 1:
            by_name[path] = LeafPlan(path, NOOP, dims, dims, tuple(entries))
            continue
        best, best_size = -1, 0
        for i, size in enumerate(dims):
            n = math.prod(shape[a] for a in _axes(entries[i]))
            if size % (n * dp) == 0 and size > best_size:
                best, best_size = i, size
        if best >= 0:
            held = _axes(entries[best])
            entries[best] = held + ("dp",) if held else "dp"
            by_name[path] = LeafPlan(path, DIM, dims, dims, tuple(entries), dim=best)
        else:
            total = math.prod(dims)
            pad = (-total) % dp
            by_name[path] = LeafPlan(path, FLAT, dims, (total + pad,), ("dp",), pad=pad)
    return ZeroPlan(shape=shape, dp=dp, by_name=by_name)


# -- one leaf: canonical or local layout <-> update view ----------------------

def local_view(lp: LeafPlan, t: torch.Tensor, dp: int) -> torch.Tensor:
    """``t`` (the whole leaf, or this rank's fsdp/tp/ep slice of it) in the
    update view: flattened and zero-padded to a multiple of ``dp`` in flat
    mode, itself otherwise."""
    if lp.mode != FLAT:
        return t
    flat = t.reshape(-1)
    pad = (-flat.numel()) % dp
    return torch.nn.functional.pad(flat, (0, pad)) if pad else flat


def from_local_view(lp: LeafPlan, view: torch.Tensor, shape) -> torch.Tensor:
    """Inverse of ``local_view``: the pad dropped, ``shape`` restored."""
    if lp.mode != FLAT:
        return view
    return view[:math.prod(shape)].reshape(shape)


def split_dim(lp: LeafPlan) -> int:
    """The dimension of the view that dp splits (0 in flat mode)."""
    return lp.dim if lp.mode == DIM else 0


def shard_of(lp: LeafPlan, view: torch.Tensor, dp: int, dp_rank: int) -> torch.Tensor:
    """Rank ``dp_rank``'s 1/dp of a view."""
    if lp.mode == NOOP:
        return view
    return view.chunk(dp, split_dim(lp))[dp_rank]


# -- measurement ---------------------------------------------------------------

def opt_moment_bytes(params: Dict, plan: Optional[ZeroPlan] = None) -> int:
    """Analytic bytes of the Adam moments (mu + nu) over ``params`` from
    shapes and dtypes alone: 1/dp of each leaf's update view under a plan
    (flat-mode pad slots included), the whole leaf without one. Given the
    whole leaves it is the JAX package's dp-axis count; given this rank's
    fsdp/tp/ep slices, the bytes the rank holds."""
    total = 0
    for path, leaf in leaves(params):
        itemsize = torch.empty((), dtype=leaf.dtype).element_size()
        elems = math.prod(_shape_of(leaf))
        if plan is not None and plan.dp > 1:
            lp = plan.by_name.get(path)
            if lp is not None and lp.mode != NOOP:
                elems = (elems + (-elems) % plan.dp) // plan.dp
        total += 2 * elems * itemsize
    return total
