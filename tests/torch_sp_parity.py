"""Parent-side helpers of the port's sequence-parallel tests: spawn the
ranks once per file, put the ranks' chunks back together, and run the JAX
sp wrappers on the conftest's 8 host devices for the same numpy inputs."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from mingpt_distributed_tpu.config import MeshConfig as JMeshConfig
from mingpt_distributed_tpu.ops import attention as j_attn
from mingpt_distributed_tpu.parallel import mesh as j_mesh
from mingpt_distributed_tpu.parallel.ring_attention import ring_causal_attention
from mingpt_distributed_tpu.parallel.ulysses import ulysses_causal_attention
from mingpt_distributed_tpu_torch.parallel.spawn import run_ranks
from tests import torch_sp_workers as W

OUT_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=2e-4, atol=2e-4)
JAX_IMPLS = {"ring": ring_causal_attention, "ulysses": ulysses_causal_attention}


def case(impl, dp, sp, b=2, t=64, h=4, kv=None, hd=16, seed=0, **kw):
    return dict(impl=impl, dp=dp, sp=sp, b=b, t=t, h=h, kv=kv or h, hd=hd,
                seed=seed, kw=kw)


def spawn_cases(cases: dict, world: int) -> dict:
    """Run every case of this world size on ``world`` gloo CPU ranks:
    {case: [rank results]}."""
    per_rank = run_ranks(W.attention_cases, world, (cases,), timeout_s=120)
    return {name: [r[name] for r in per_rank] for name in per_rank[0]}


def assemble(ranks: list, key: str, dp: int, sp: int) -> np.ndarray:
    """The global (B, T, ...) array from every rank's chunk, rank = dp_index
    * sp + sp_index."""
    rows = [np.concatenate([ranks[d * sp + s][key] for s in range(sp)], axis=1)
            for d in range(dp)]
    return np.concatenate(rows, axis=0)


def jax_sp(c: dict):
    """The JAX sp wrapper's output and q/k/v gradients of sum(out * dO)."""
    q, k, v, do = W.global_qkv(c["b"], c["t"], c["h"], c["kv"], c["hd"], c["seed"])
    mesh = j_mesh.make_mesh(JMeshConfig(dp=c["dp"], fsdp=1, tp=1, sp=c["sp"]),
                            devices=jax.devices()[: c["dp"] * c["sp"]])
    fn = JAX_IMPLS[c["impl"]]
    kw = c["kw"]

    @jax.jit
    def run(q, k, v, do):
        out, vjp = jax.vjp(lambda q, k, v: fn(q, k, v, mesh, **kw), q, k, v)
        return out, vjp(do)

    out, grads = run(*(jnp.asarray(a) for a in (q, k, v, do)))
    return np.asarray(out), [np.asarray(g) for g in grads]


def jax_dense(c: dict):
    """The JAX dense oracle's output and q/k/v gradients, which the JAX sp
    wrappers equal in the JAX package's own tests: the cheaper reference
    where the JAX wrapper's interpreted kernels would cost seconds."""
    q, k, v, do = W.global_qkv(c["b"], c["t"], c["h"], c["kv"], c["hd"], c["seed"])

    @jax.jit
    def run(q, k, v, do):
        out, vjp = jax.vjp(
            lambda q, k, v: j_attn.causal_attention(q, k, v, **c["kw"]), q, k, v)
        return out, vjp(do)

    out, grads = run(*(jnp.asarray(a) for a in (q, k, v, do)))
    return np.asarray(out), [np.asarray(g) for g in grads]


def check_against_jax(name: str, c: dict, ranks: list, dense: bool = False) -> None:
    want, want_grads = (jax_dense if dense else jax_sp)(c)
    got = {key: assemble(ranks, key, c["dp"], c["sp"])
           for key in ("out", "dq", "dk", "dv")}
    np.testing.assert_allclose(got["out"], want, err_msg=f"{name} out", **OUT_TOL)
    for key, w in zip(("dq", "dk", "dv"), want_grads):
        np.testing.assert_allclose(got[key], w, err_msg=f"{name} {key}", **GRAD_TOL)
