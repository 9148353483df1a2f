"""The device mesh of a job of processes: each rank's coordinates, the
process groups of its axes, and the parameter-sharding rules.

Counterpart of ``mingpt_distributed_tpu/parallel/mesh.py``: the same six
axes in the same order (``AXES``), the same shape resolution
(``resolve_mesh_shape``, -1 absorbs the remaining ranks) and the same
``PARAM_RULES``, so a config's ``trainer_config.mesh`` means here what it
means there. A rank's coordinates follow the JAX mesh's device order: the
rank is the row-major index of its (pp, dp, fsdp, ep, tp, sp) coordinates.

Every axis runs, in any mix. The batch is split over dp,
fsdp and ep (``BATCH_AXES``, dp major; every tp rank of a group reads the
same rows) and the sequence over sp: under sp x tp each sp rank's attention
runs the ring (or Ulysses) on its tp rank's heads, which are just batch to
the ring. ep is a batch axis that also splits the experts of a
mixture-of-experts model (``w_e1``, ``w_e2``, ``w_eg``): a dense model runs
it as more data parallelism.

Pipeline parallelism (pp, ``parallel/pipeline.py``): the stacked layer axis
of every block leaf is split over pp (``PARAM_RULES``' leading "pp"), so
each stage holds ``n_layer / pp`` contiguous layers; ``pp_group`` is the
ranks of this rank's coordinates on every other axis, in stage order, over
which the activations and their gradients move. pp is not a data axis:
every stage of a pipeline reads the same rows. The leaves replicated over
pp (``wte``, ``wpe``, ``head``, the final norm) get their gradients on the
first or the last stage only, so ``grad_axes`` sums them over pp too.

Serving tensor parallelism (``Mesh.serving``): a mesh of tp = N over a
group of N ranks (dp, fsdp and sp 1), whose group rank 0 drives the
engine. Its ``tp_group`` carries the forward's collectives and fails a
collective after ``timeout_s``; its ``cmd_group`` (always gloo, on the
host) carries the driver's command broadcasts, with a long timeout, since a
follower waits there for as long as the server idles. One process may
drive several such groups (a fleet of tp replicas): ``serving_meshes``
builds them all, on every rank, in one order.

Parameter sharding (pp, fsdp, ep and tp): ``Mesh.shard_params`` keeps this
rank's slice of every leaf, cut by its ``PARAM_RULES`` spec. A spec axis
whose extent does not divide the dimension is downgraded to replication,
logged once and counted once in
``mingpt_train_sharding_downgrades_total{param}`` (GPT-2's vocabulary of
50257 downgrades the fsdp split of ``wte`` and ``head``). ``Mesh.gather``
rebuilds a leaf for use: over fsdp with ``distributed.all_gather`` (its
backward a reduce-scatter: the fsdp ranks hold different rows), over tp
with ``distributed.gather_replicated`` (its backward keeps this rank's
slice: the computation is replicated over tp). The model gathers one
layer's weights just before the layer runs; under Megatron tensor
parallelism (``tp_manual``) the tp dimensions stay local, and an ep rank
keeps its experts (``ops/moe.py`` sends it their tokens).

Under ``zero_dp`` (``parallel/zero.py``) each dp rank holds 1/dp of the
Adam moments: ``training/optimizer.py`` keeps them beside the rank's 1/dp
of each leaf's update view (the counterpart of JAX ``state_shardings(...,
zero_plan=)``).
"""

from __future__ import annotations

import datetime
import itertools
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from mingpt_distributed_tpu_torch.config import MeshConfig
from mingpt_distributed_tpu_torch.parallel import distributed

AXES = ("pp", "dp", "fsdp", "ep", "tp", "sp")
BATCH_AXES = ("dp", "fsdp", "ep")
#: mesh axes the port does not run yet, by ROADMAP item (none is left)
UNPORTED_AXES: Dict[str, str] = {}
#: the axes whose ranks hold different tokens of a global batch
DATA_AXES = ("dp", "fsdp", "ep", "sp")

Spec = Tuple[Optional[str], ...]

#: how long a serving mesh's forward collective waits for a peer before it
#: raises (a follower that died or hangs fails the driver's call)
TP_TIMEOUT_S = 60.0
#: how long a follower waits for the driver's next command: a server may
#: idle for days (a spawned follower also leaves when its driver process
#: dies: ``serving/lockstep.py``)
CMD_TIMEOUT_S = 7 * 24 * 3600.0

# name -> axes per dimension, the JAX package's rules (trailing dimensions
# not named replicate). Block leaves carry a leading layer axis ("pp").
# Column-parallel (d_model -> wide): input dim fsdp, output dim tp;
# row-parallel (wide -> d_model): input dim tp, output dim fsdp.
PARAM_RULES: Dict[str, Spec] = {
    "wte": ("fsdp", "tp"),
    "wpe": (),
    "head": ("tp", "fsdp"),
    "lnf_scale": (),
    "lnf_bias": (),
    "wq": ("pp", "fsdp", "tp"),
    "wk": ("pp", "fsdp", "tp"),
    "wv": ("pp", "fsdp", "tp"),
    "wo": ("pp", "tp", "fsdp"),
    "w_fc": ("pp", "fsdp", "tp"),
    "w_gate": ("pp", "fsdp", "tp"),
    "w_up": ("pp", "fsdp", "tp"),
    "w_proj": ("pp", "tp", "fsdp"),
    "w_down": ("pp", "tp", "fsdp"),
    "bq": ("pp", "tp"),
    "bk": ("pp", "tp"),
    "bv": ("pp", "tp"),
    "bo": ("pp",),
    "b_fc": ("pp", "tp"),
    "b_proj": ("pp",),
    "ln1_scale": ("pp",),
    "ln1_bias": ("pp",),
    "ln2_scale": ("pp",),
    "ln2_bias": ("pp",),
    "w_router": ("pp",),
    "w_e1": ("pp", "ep", "fsdp", "tp"),
    "w_e2": ("pp", "ep", "tp", "fsdp"),
    "w_eg": ("pp", "ep", "fsdp", "tp"),
}


def resolve_mesh_shape(cfg: MeshConfig, n_devices: int) -> tuple[int, ...]:
    """Resolve -1 entries ("absorb remaining devices") and validate."""
    dims = [cfg.pp, cfg.dp, cfg.fsdp, cfg.ep, cfg.tp, cfg.sp]
    if dims.count(-1) > 1:
        raise ValueError(f"at most one mesh axis may be -1, got {dims}")
    known = math.prod(d for d in dims if d != -1)
    if -1 in dims:
        if n_devices % known != 0:
            raise ValueError(
                f"{n_devices} devices not divisible by fixed axes product {known}"
            )
        dims[dims.index(-1)] = n_devices // known
    if math.prod(dims) != n_devices:
        raise ValueError(
            f"mesh {dict(zip(AXES, dims))} needs {math.prod(dims)} devices, "
            f"have {n_devices}"
        )
    return tuple(dims)


def check_axes(shape: Dict[str, int]) -> None:
    """Raise NotImplementedError for an axis above 1 that the port does not
    run yet (``UNPORTED_AXES``: every axis runs since pp was ported)."""
    for ax, item in UNPORTED_AXES.items():
        if shape[ax] > 1:
            raise NotImplementedError(
                f"mesh axis {ax}={shape[ax]} is not ported yet (ROADMAP.md "
                f"{item})")


def param_specs(params: Dict, prefix: str = "") -> Dict:
    """The PARAM_RULES spec of every leaf, as a tree like ``params``;
    ValueError for a leaf no rule covers."""
    out = {}
    for name, leaf in params.items():
        if isinstance(leaf, dict):
            out[name] = param_specs(leaf, f"{prefix}{name}/")
        elif name in PARAM_RULES:
            out[name] = PARAM_RULES[name]
        else:
            raise ValueError(f"no sharding rule for parameter {prefix}{name!r}")
    return out


# (param, axes) pairs already logged and counted in this process: each
# downgrade is reported once, not once per mesh or per moment tree
_DOWNGRADES_SEEN: set = set()


def _note_downgrade(name: str, axes: str, size: int, n: int) -> None:
    key = (name, axes)
    if key in _DOWNGRADES_SEEN:
        return
    _DOWNGRADES_SEEN.add(key)
    from mingpt_distributed_tpu_torch import telemetry

    telemetry.get_registry().counter(
        "mingpt_train_sharding_downgrades_total",
        help="Parameter-sharding rules silently downgraded to replication "
             "because the mesh axis extent does not divide the dimension.",
        labels=("param",),
    ).labels(param=name).inc()
    telemetry.log_event(
        f"sharding downgrade: {name} dim of size {size} not divisible by "
        f"mesh extent {n} of axes {axes!r} — replicating that dimension",
        param=name,
    )


def shard_by_rule(shape: Dict[str, int], dims: Sequence[int], spec: Spec,
                  name: Optional[str] = None) -> Spec:
    """The spec one array of dimensions ``dims`` gets on a mesh of
    ``shape``: ``spec`` padded with None to the rank, every axis whose
    extent does not divide its dimension downgraded to None (replicated).
    With ``name``, each downgrade is logged and counted once."""
    fixed = []
    for i, size in enumerate(dims):
        axis = spec[i] if i < len(spec) else None
        if axis is None or size % shape[axis] == 0:
            fixed.append(axis)
            continue
        if name is not None:
            _note_downgrade(name, axis, size, shape[axis])
        fixed.append(None)
    return tuple(fixed)


def tp_manual(cfg, tp: int) -> bool:
    """Whether the blocks run the Megatron recipe at ``tp``: tp > 1 and the
    query heads, the KV heads and the FFN width (each expert's, under MoE)
    all divide by tp. Otherwise tp falls back to gathered weights, as in
    the JAX package."""
    ffn = int(cfg.ffn_mult * cfg.n_embd)
    return (tp > 1 and cfg.n_head % tp == 0 and cfg.kv_heads % tp == 0
            and ffn % tp == 0)


def check_stages(n_layer: int, pp: int) -> None:
    """The JAX pipeline's ValueError when the layers do not split evenly
    over the stages."""
    if n_layer % pp:
        raise ValueError(f"n_layer {n_layer} not divisible by pp={pp}")


class Mesh:
    """This rank's place in a job of ``world_size`` ranks.

    ``sp_group``, ``dp_group``, ``ep_group`` and ``pp_group`` are its ring's,
    its replica set's, its expert exchange's and its pipeline's process
    groups (None when the axis is 1). With pp, fsdp, ep or tp above 1
    (``sharded``): ``fsdp_group`` and ``tp_group``; ``batch_group``, the
    ranks of its pp and tp coordinates that hold different tokens (loss
    terms are summed there); ``model_group``, the ranks of its dp and sp
    coordinates (together they hold one copy of the model: the gradient
    norm). ``grad_group(path)`` is the group a leaf's
    gradient is summed over; ``group_over(axes)`` any other, made once
    (every rank must ask for the same groups in the same order: making one
    is collective). ``batch_group`` is None, the world, when unsharded."""

    def __init__(self, cfg: Optional[MeshConfig] = None):
        cfg = cfg or MeshConfig()
        self.world_size = distributed.world_size()
        self.rank = distributed.rank()
        self._place(resolve_mesh_shape(cfg, self.world_size), self.rank)
        # every rank creates every group, in the same order
        self.sp_group = self.group_over(("sp",)) if self.sp > 1 else None
        self.dp_group = self.group_over(("dp",)) if self.dp > 1 else None
        self.ep_group = self.group_over(("ep",)) if self.ep > 1 else None
        self.pp_group = self.group_over(("pp",)) if self.pp > 1 else None
        if self.sharded:
            self.fsdp_group = self.group_over(("fsdp",))
            self.tp_group = self.group_over(("tp",))
            self.batch_group = self.group_over(DATA_AXES)
            self.model_group = self.group_over(("pp", "fsdp", "ep", "tp"))

    def _place(self, dims: Sequence[int], index: int) -> None:
        """The fields of the rank at row-major ``index`` of the grid ``dims``
        (one extent per axis of AXES), its groups all None."""
        self.shape = dict(zip(AXES, dims))
        check_axes(self.shape)
        self.coords = dict(zip(AXES, (int(c) for c in np.unravel_index(index, dims))))
        self.dp, self.sp = self.shape["dp"], self.shape["sp"]
        self.fsdp, self.tp, self.ep = self.shape["fsdp"], self.shape["tp"], self.shape["ep"]
        self.dp_rank, self.sp_rank = self.coords["dp"], self.coords["sp"]
        self.fsdp_rank, self.tp_rank = self.coords["fsdp"], self.coords["tp"]
        self.ep_rank = self.coords["ep"]
        self.pp, self.stage = self.shape["pp"], self.coords["pp"]
        self.sharded = self.pp * self.fsdp * self.tp * self.ep > 1
        # the data shard: rows over (dp, fsdp, ep), dp-major as BATCH_AXES
        self.batch_index = (self.dp_rank * self.fsdp + self.fsdp_rank) * self.ep + self.ep_rank
        self.batch_count = self.dp * self.fsdp * self.ep
        # this rank's index among the ranks of distinct data (tp and pp
        # dropped: the stages of a pipeline read the same rows): the seed of
        # its replicated dropout draws
        self.data_rank = int(np.ravel_multi_index(
            [self.coords[a] for a in DATA_AXES], [self.shape[a] for a in DATA_AXES]))
        self.sp_group = self.dp_group = self.fsdp_group = self.tp_group = None
        self.ep_group = self.model_group = self.batch_group = self.pp_group = None
        self._groups: Dict[Tuple[str, ...], object] = {}
        self.specs: Dict[str, Spec] = {}
        self.full_shapes: Dict[str, Tuple[int, ...]] = {}

    def group_over(self, varying: Sequence[str]):
        """The process group of the ranks that share this rank's coordinates
        on every axis but ``varying`` (made on first use, on every rank)."""
        key = tuple(a for a in AXES if a in varying)
        if key not in self._groups:
            self._groups[key] = self._group_over(key)
        return self._groups[key]

    def _group_over(self, varying: Tuple[str, ...]):
        grid = np.arange(self.world_size).reshape([self.shape[a] for a in AXES])
        fixed = [a for a in AXES if a not in varying]
        mine = None
        for combo in itertools.product(*(range(self.shape[a]) for a in fixed)):
            index = [slice(None)] * len(AXES)
            for a, c in zip(fixed, combo):
                index[AXES.index(a)] = c
            members = sorted(int(r) for r in grid[tuple(index)].ravel())
            group = dist.new_group(members)
            if self.rank in members:
                mine = group
        return mine

    def spec_axes(self, path: str) -> Tuple[str, ...]:
        """The mesh axes above 1 that split the leaf at ``path``."""
        return tuple(a for a in self.specs.get(path, ()) if a is not None
                     and self.shape[a] > 1)

    def grad_axes(self, path: str) -> Tuple[str, ...]:
        """The axes a leaf's gradient is summed over: the ranks of distinct
        tokens (``DATA_AXES``) that hold the same slice of it, and pp for a
        leaf the stages replicate (its gradient comes from the first or the
        last stage alone). An fsdp- or ep-split leaf's gradient is already
        summed over that axis (the gather's reduce-scatter, the expert
        exchange's return)."""
        held = self.spec_axes(path)
        return tuple(a for a in ("pp",) + DATA_AXES
                     if self.shape[a] > 1 and a not in held)

    def grad_group(self, path: str):
        """The group of ``grad_axes(path)`` (None: the world, unsharded)."""
        if not self.sharded:
            return None
        return self.group_over(self.grad_axes(path))

    def group(self, axis: str):
        return {"fsdp": self.fsdp_group, "tp": self.tp_group, "ep": self.ep_group,
                "dp": self.dp_group, "pp": self.pp_group}[axis]

    # -- parameters ----------------------------------------------------------
    def tp_manual(self, cfg) -> bool:
        """``tp_manual(cfg, self.tp)``."""
        return tp_manual(cfg, self.tp)

    def shard_params(self, params: Dict, prefix: str = "") -> Dict:
        """This rank's slice of every leaf of the whole tree ``params``,
        recording each leaf's spec (downgrades counted) and whole shape.
        ValueError when the stages cannot hold equal layer counts (the
        pp split of the layer axis would downgrade to replication)."""
        if not prefix and self.pp > 1 and "blocks" in params:
            n_layer = next(iter(params["blocks"].values())).shape[0]
            check_stages(n_layer, self.pp)
        out = {}
        for name, leaf in params.items():
            path = f"{prefix}{name}"
            if isinstance(leaf, dict):
                out[name] = self.shard_params(leaf, path + "/")
                continue
            if name not in PARAM_RULES:
                raise ValueError(f"no sharding rule for parameter {path!r}")
            self.full_shapes[path] = tuple(leaf.shape)
            self.specs[path] = shard_by_rule(self.shape, leaf.shape, PARAM_RULES[name],
                                             name=name)
            out[name] = self.shard(path, leaf)
        return out

    def shard(self, path: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's slice of the whole leaf at ``path`` (a copy)."""
        t = full
        for dim, axis in enumerate(self.specs[path]):
            if axis is not None and self.shape[axis] > 1:
                t = t.chunk(self.shape[axis], dim)[self.coords[axis]]
        return t.contiguous().clone()

    def gather(self, path: str, local: torch.Tensor, keep_tp: bool = False,
               layer: bool = False) -> torch.Tensor:
        """The leaf at ``path`` rebuilt for use, differentiably: gathered
        over fsdp, and over tp unless ``keep_tp``. ``layer``: ``local`` is
        one layer of a stacked block leaf (its leading axis dropped)."""
        spec = self.specs[path][1:] if layer else self.specs[path]
        t = local
        for dim, axis in enumerate(spec):
            if axis == "fsdp" and self.fsdp > 1:
                t = distributed.all_gather(t, self.fsdp_group, dim)
        for dim, axis in enumerate(spec):
            if axis == "tp" and self.tp > 1 and not keep_tp:
                t = distributed.gather_replicated(t, self.tp_group, dim)
        return t

    def gather_full(self, path: str, local: torch.Tensor) -> torch.Tensor:
        """The whole leaf at ``path`` from every rank's slice, a new tensor
        that shares no storage with ``local`` (no gradient): what a snapshot
        stores."""
        t = local.detach()
        for dim, axis in enumerate(self.specs[path]):
            if axis is not None and self.shape[axis] > 1:
                t = distributed.gather_tensor(t, self.group(axis), dim)
        return t.clone() if t.data_ptr() == local.data_ptr() else t

    def copies(self, path: str) -> int:
        """How many ranks of ``model_group`` hold the same slice of the
        leaf at ``path``: its weight in a sum over that group is 1/copies
        (a leaf the stages replicate counts once, not pp times)."""
        n = self.pp * self.fsdp * self.ep * self.tp
        for axis in self.specs[path]:
            if axis in ("pp", "fsdp", "ep", "tp"):
                n //= self.shape[axis]
        return n

    def ep_split(self, path: str) -> bool:
        """Whether this rank holds only its experts of the leaf at ``path``."""
        return "ep" in self.spec_axes(path)

    # -- serving -------------------------------------------------------------
    @classmethod
    def serving(cls, timeout_s: float = TP_TIMEOUT_S) -> "Mesh":
        """The world as one tp group serving one engine: rank 0 drives,
        the others follow. Every rank calls it."""
        return serving_meshes([list(range(distributed.world_size()))],
                               timeout_s)[0]

    @classmethod
    def _serving_group(cls, ranks: List[int], me: int, tp_group, cmd_group,
                       timeout_s: float) -> "Mesh":
        """Rank ``me``'s mesh of tp = len(ranks) over the global ``ranks``
        (the first drives), with the groups ``serving_meshes`` made."""
        mesh = cls.__new__(cls)
        n = len(ranks)
        mesh.world_size, mesh.rank = n, me
        mesh._place((1, 1, 1, 1, n, 1), ranks.index(me))
        mesh.tp_group = tp_group if n > 1 else None
        mesh.cmd_group = cmd_group
        mesh.ranks = list(ranks)
        mesh.driver = ranks[0]
        mesh.timeout_s = float(timeout_s)
        return mesh


def serving_meshes(groups: Sequence[Sequence[int]],
                   timeout_s: float = TP_TIMEOUT_S) -> Dict[int, Mesh]:
    """One serving mesh (tp = len(ranks)) per rank list of ``groups``; the
    first rank of each list drives it. Every rank of the world calls this
    with the same lists (``new_group`` is collective); returns {index of
    the group: this rank's mesh} for the groups this rank belongs to."""
    me = distributed.rank()
    out: Dict[int, Mesh] = {}
    for i, ranks in enumerate(groups):
        ranks = [int(r) for r in ranks]
        if len(set(ranks)) != len(ranks) or len(ranks) < 1:
            raise ValueError(f"tp group {ranks} must list distinct ranks")
        tp_group = dist.new_group(ranks, timeout=datetime.timedelta(seconds=timeout_s))
        cmd_group = dist.new_group(ranks, backend="gloo",
                                   timeout=datetime.timedelta(seconds=CMD_TIMEOUT_S))
        if me in ranks:
            out[i] = Mesh._serving_group(ranks, me, tp_group, cmd_group, timeout_s)
    return out
