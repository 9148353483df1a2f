"""Convert parameters between the JAX package's pytree and the port.

Both sides use the same tree: ``{"wte", "wpe", "lnf_scale", "lnf_bias",
"head", "blocks": {"wq": (L, in, out), ...}}`` with every block leaf stacked
on a leading n_layer axis, weights stored (in, out), optional biases, and no
``head`` when the LM head is tied to ``wte``. ``params_from_numpy`` checks
the tree against ``gpt.param_spec(cfg)`` key by key and shape by shape, so a
snapshot of another configuration is refused rather than misread.

``flatten``/``unflatten`` map the tree to and from the flat ``"blocks/wq"``
keys of an ``.npz`` file (see the README for writing one from a JAX
snapshot).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from mingpt_distributed_tpu_torch.config import GPTConfig
from mingpt_distributed_tpu_torch.models import gpt
from mingpt_distributed_tpu_torch.utils.device import Device, resolve_device


def _match(tree: Mapping[str, Any], spec: Mapping[str, Any], where: str,
           dev: torch.device) -> Dict[str, Any]:
    if set(tree) != set(spec):
        raise ValueError(
            f"{where or 'params'}: keys {sorted(tree)} do not match the "
            f"config's {sorted(spec)}"
        )
    out: Dict[str, Any] = {}
    for name, want in spec.items():
        path = f"{where}/{name}" if where else name
        if isinstance(want, dict):
            out[name] = _match(tree[name], want, path, dev)
            continue
        arr = np.asarray(tree[name])
        if arr.shape != tuple(want[0]):
            raise ValueError(f"{path}: shape {arr.shape}, config wants {want[0]}")
        out[name] = torch.from_numpy(
            np.ascontiguousarray(arr, dtype=np.float32)).to(dev)
    return out


def params_from_numpy(tree: Mapping[str, Any], cfg: GPTConfig,
                      device: Optional[Device] = None) -> gpt.Params:
    """The JAX parameter pytree (numpy arrays, e.g. ``jax.device_get``) ->
    the port's float32 tensors on ``device`` (cuda unless asked)."""
    return _match(tree, gpt.param_spec(cfg), "", resolve_device(device))


def params_to_numpy(params: gpt.Params) -> Dict[str, Any]:
    """The port's parameters -> the same tree of float32 numpy arrays."""
    return {k: params_to_numpy(v) if isinstance(v, dict)
            else v.detach().float().cpu().numpy() for k, v in params.items()}


def flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    """{"blocks": {"wq": a}} -> {"blocks/wq": a}."""
    flat: Dict[str, Any] = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, Mapping):
            flat.update(flatten(v, key + "/"))
        else:
            flat[key] = v
    return flat


def unflatten(flat: Mapping[str, Any]) -> Dict[str, Any]:
    """{"blocks/wq": a} -> {"blocks": {"wq": a}}."""
    tree: Dict[str, Any] = {}
    for key, v in flat.items():
        *parents, leaf = key.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree
