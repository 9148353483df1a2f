"""The device mesh of a job of processes: each rank's (dp, sp) coordinates
and the process groups of its sequence ring and its data-parallel replicas.

Counterpart of ``mingpt_distributed_tpu/parallel/mesh.py``: the same six
axes in the same order (``AXES``) and the same shape resolution
(``resolve_mesh_shape``, -1 absorbs the remaining ranks), so a config's
``trainer_config.mesh`` means here what it means there. A rank's
coordinates follow the JAX mesh's device order: rank = dp_index * sp +
sp_index. Only dp and sp run in the port so far; fsdp, tp, pp and ep above
1 raise NotImplementedError naming their ROADMAP item, and the parameters
stay replicated (``PARAM_RULES`` has no counterpart yet).
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch.distributed as dist

from mingpt_distributed_tpu_torch.config import MeshConfig
from mingpt_distributed_tpu_torch.parallel import distributed

AXES = ("pp", "dp", "fsdp", "ep", "tp", "sp")
BATCH_AXES = ("dp", "fsdp", "ep")
UNPORTED_AXES = {
    "pp": "Queue 1 item 12b (parallel/pipeline.py)",
    "fsdp": "Queue 1 item 9 (parameter sharding)",
    "ep": "Queue 1 item 12b (expert parallelism)",
    "tp": "Queue 1 item 9 (tensor parallelism)",
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
    """Raise NotImplementedError for an axis the port does not run yet."""
    for ax, item in UNPORTED_AXES.items():
        if shape[ax] > 1:
            raise NotImplementedError(
                f"mesh axis {ax}={shape[ax]} is not ported yet (ROADMAP.md "
                f"{item}); the port runs dp x sp")


class Mesh:
    """This rank's place in a dp x sp job. ``sp_group`` and ``dp_group``
    are its ring's and its replica set's process groups (None when the axis
    is 1); ``world_size`` ranks in all."""

    def __init__(self, cfg: Optional[MeshConfig] = None):
        cfg = cfg or MeshConfig()
        self.world_size = distributed.world_size()
        self.rank = distributed.rank()
        dims = resolve_mesh_shape(cfg, self.world_size)
        self.shape = dict(zip(AXES, dims))
        check_axes(self.shape)
        coords = dict(zip(AXES, (int(c) for c in np.unravel_index(self.rank, dims))))
        self.dp, self.sp = self.shape["dp"], self.shape["sp"]
        self.dp_rank, self.sp_rank = coords["dp"], coords["sp"]
        self.sp_group = self.dp_group = None
        # every rank creates every group, in the same order
        if self.sp > 1:
            for d in range(self.dp):
                g = dist.new_group([d * self.sp + s for s in range(self.sp)])
                if d == self.dp_rank:
                    self.sp_group = g
        if self.dp > 1:
            for s in range(self.sp):
                g = dist.new_group([d * self.sp + s for d in range(self.dp)])
                if s == self.sp_rank:
                    self.dp_group = g
