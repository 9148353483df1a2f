"""The training loop, on one device or on a job of processes (pp x dp x fsdp x
ep x tp x sp).

Counterpart of ``mingpt_distributed_tpu/training/trainer.py``:
``make_train_step`` (forward, backward, clip, AdamW update, with gradient
accumulation), ``make_eval_step`` and ``GPTTrainer`` (fresh init or restore,
the epoch loop with logging, eval and snapshots, preemption on
SIGTERM/SIGINT). The JAX package compiles a step into one program with
donated state; here the step runs eagerly and updates the parameters in
place. The loop reads metrics from the card only at logged steps, so the
host enqueues the next step while the card runs this one.

Across processes (``python -m torch.distributed.run``, a ``Mesh``): each
rank holds its data shard's rows (over dp and fsdp; every tp rank of a
group reads the same rows) and its sp chunk of the columns of every global
batch. The loss is the global token mean (the token sums and counts of the
ranks that hold distinct tokens, ``mesh.batch_group``, summed with
``all_reduce``). Under dp x sp the parameters are replicated and the
gradients summed over the world. Under fsdp, ep or tp each rank keeps its
slices of the parameters and of the Adam moments (``Mesh.shard_params``):
the model gathers each layer over fsdp as it runs and reduce-scatters its
gradient, and ``all_reduce_grads`` sums a sliced leaf's gradient only over
the ranks that hold the same slice (``Mesh.grad_group``: the data axes that
do not split it; never over tp, where every rank's gradient is already
whole for its slice). A mixture-of-experts model adds its aux loss once
per rank (``gpt.loss_terms(with_aux=True)``). Under pp each rank holds its
stage's layers and the step runs the stage's schedule
(``gpt.pipeline_terms``: forward and backward per microbatch, GPipe or
1F1B) inside each ``grad_accum`` split; the loss is summed over the stages
and the data ranks, so every rank logs the same, and the leaves the stages
replicate have their gradients summed over pp. Rank 0 alone logs.

Two snapshot backends, chosen by ``snapshot_path`` (the port's rule beside
the JAX package's ``.msgpack`` one): a path ending in ``.pt`` or
``.msgpack`` is one file, whose save has every rank join the gather of the
whole tree and rank 0 write it, the layout an unsharded run writes, so it
restores at any mesh (one that would gather more than
``msgpack_gather_limit_mb`` is refused, as in the JAX package); any other
path is a sharded directory (``training/checkpoint_sharded.py``), written
collectively, each rank its own slices, and restored at any mesh.
``async_save`` and ``zero_dp`` with a directory raise ``ConfigError``, as
the JAX trainer refuses them with its Orbax directories. A stop request
(SIGTERM) is agreed on by all ranks at a step boundary, over a host-side
group, so none leaves while the others wait in a collective.

Snapshots are committed through ``training/checkpoint.py``'s manifest:
the last ``keep_snapshots`` are kept, transient I/O is retried
``io_retries`` times from ``io_retry_delay_s`` (jitter seeded from
``seed``), and a resume falls back past a torn or corrupt snapshot to the
newest good one. ``async_save`` writes in a background thread: the
parameters and optimizer state are copied to host memory first (the next
step updates them in place), a new save first joins the previous write and
re-raises its failure, and ``train()`` joins the last write before it
returns, re-raising a failure there too.

Telemetry (rank 0): ``spans_jsonl`` streams a span per step
(``train.step``), eval and snapshot; ``metrics_port`` serves the process
registry's ``/metrics`` (the ``mingpt_train_*`` gauges) and ``/healthz``;
``tensorboard_dir`` adds a TensorBoard sink; ``profile_dir`` writes a
``torch.profiler`` Chrome trace of the steps after ``profile_steps[0]`` up
to ``profile_steps[1]``. ``debug_nans`` stops the step whose loss or
gradients are not finite with ``FloatingPointError``, before its update
(one read from the card per step).

ZeRO (``zero_dp`` with dp > 1, ``parallel/zero.py``): the optimizer holds
this rank's 1/dp of every leaf's update view; the step reduce-scatters the
gradients over dp instead of all-reducing them, clips by the global norm,
updates the shard and all-gathers the parameters (``AdamW.reduce_grads``,
``AdamW.step``). Snapshots keep the canonical layout, so they restore at
any dp extent, with ``zero_dp`` on or off, and are written as dp shard
objects behind one manifest entry (``checkpoint.save_snapshot(shards=)``).
"""

from __future__ import annotations

import dataclasses
import math
import os
import signal
import threading
import time
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from mingpt_distributed_tpu_torch.config import (
    ConfigError,
    ExperimentConfig,
    GPTConfig,
    OptimizerConfig,
    TrainerConfig,
)
from mingpt_distributed_tpu_torch.data.char_dataset import (
    CharView,
    IteratorState,
    ShardedBatchIterator,
)
from mingpt_distributed_tpu_torch.data.prefetch import PrefetchIterator
from mingpt_distributed_tpu_torch.models import gpt
from mingpt_distributed_tpu_torch.parallel import distributed as D
from mingpt_distributed_tpu_torch.parallel import mesh as mesh_lib
from mingpt_distributed_tpu_torch.parallel import zero as zero_lib
from mingpt_distributed_tpu_torch.parallel.mesh import Mesh
from mingpt_distributed_tpu_torch.telemetry import (
    SpanTracer,
    TelemetryServer,
    get_registry,
    log_event,
)
from mingpt_distributed_tpu_torch.training import checkpoint as ckpt_lib
from mingpt_distributed_tpu_torch.training import checkpoint_sharded
from mingpt_distributed_tpu_torch.training.durability import RetryPolicy
from mingpt_distributed_tpu_torch.training.metrics import MetricsLogger, peak_flops
from mingpt_distributed_tpu_torch.training.optimizer import (
    AdamW,
    _global_norm,
    _leaves,
    lr_schedule,
    make_optimizer,
)
from mingpt_distributed_tpu_torch.utils.device import Device, resolve_device

# Exit code after a preemption-triggered stop and snapshot: EX_TEMPFAIL,
# "transient, requeue me"; the restarted run resumes from the snapshot.
REQUEUE_EXIT_CODE = 75

Batch = Tuple[torch.Tensor, torch.Tensor]


@dataclasses.dataclass
class TrainState:
    """What a step reads and updates: the parameter tree (leaves require
    grad), its optimizer, and the number of updates applied."""

    params: gpt.Params
    optimizer: AdamW
    step: int = 0


def trainable(params: gpt.Params) -> gpt.Params:
    """The tree with every leaf a detached copy that requires grad."""
    return {k: trainable(v) if isinstance(v, dict)
            else v.detach().clone().requires_grad_() for k, v in params.items()}


def deterministic(cfg: GPTConfig) -> bool:
    """True iff every dropout rate is 0: the step then draws no masks."""
    return cfg.embd_pdrop == 0.0 and cfg.resid_pdrop == 0.0 and cfg.attn_pdrop == 0.0


def _distributed(mesh: Optional[Mesh]) -> bool:
    return mesh is not None and mesh.world_size > 1


def rank_generator(generator: torch.Generator, rank: int) -> torch.Generator:
    """A generator of this rank's own, seeded from one draw of the shared
    ``generator`` (which every rank advances alike, so a snapshot of rank
    0's holds for all): data shards and sp chunks draw different masks. The
    trainer passes ``mesh.data_rank``, so the tp ranks of a group draw the
    same (their activations are replicated)."""
    return torch.Generator(device=generator.device).manual_seed(
        D.mix_seed(D.dropout_base(generator), rank))


def all_reduce_grads(params, mesh: Optional[Mesh] = None) -> None:
    """Sum every parameter's gradient over the ranks that hold the same
    slice of it: the world, unless the mesh shards the parameters; then
    ``mesh.grad_group`` of each leaf (an fsdp- or ep-split leaf's gradient
    is already summed over that axis). One collective per group."""
    named = list(_leaves(params))
    if mesh is None or not mesh.sharded:
        _sum_grads([p for _, p in named], None)
        return
    by_axes: Dict[tuple, list] = {}
    for n, p in named:
        by_axes.setdefault(mesh.grad_axes(n), []).append(p)
    for axes, leaves in by_axes.items():
        _sum_grads(leaves, mesh.group_over(axes))


def _sum_grads(leaves, group) -> None:
    if not leaves:
        return
    flat = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p))
                      .reshape(-1) for p in leaves])
    D.all_reduce(flat, group)
    for p, g in zip(leaves, flat.split([p.numel() for p in leaves])):
        p.grad = g.view_as(p)


def check_finite(loss: torch.Tensor, grads, step: int) -> None:
    """``debug_nans``: raise FloatingPointError naming ``step`` when the
    loss or any of ``grads`` is not finite (one read from the card)."""
    norm = _global_norm(grads) if grads else loss.new_zeros(())
    if not bool(torch.isfinite(loss) & torch.isfinite(norm)):
        raise FloatingPointError(
            f"debug_nans: non-finite loss or gradient at step {step} (loss "
            f"{loss.item()}, gradient norm {norm.item()}); the update was "
            "not applied")


def _host_copy(obj):
    """A copy of a snapshot tree in host memory that shares no storage with
    the live tensors."""
    if torch.is_tensor(obj):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _host_copy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_host_copy(v) for v in obj)
    return obj


def make_train_step(cfg: GPTConfig, grad_accum: int = 1,
                    lr_fn: Optional[Callable[[int], float]] = None,
                    mesh: Optional[Mesh] = None, debug_nans: bool = False):
    """(state, (x, y), generator) -> metrics: forward and backward (loss-only
    mode, chunked head), clip, AdamW, ``state.step += 1``. Metrics are
    device scalars: ``loss``, pre-clip ``grad_norm``, ``update_norm`` (the
    applied update), and ``lr`` (the rate of this update) when ``lr_fn`` is
    given.

    ``grad_accum > 1`` splits the batch into that many micro-batches and
    sums their gradients before the single update; each micro-batch mean
    counts with equal weight (the JAX step's mean of means).

    With a ``mesh`` of several processes, ``(x, y)`` is this rank's share of
    the global batch and the step is ``_distributed_step``'s.

    ``debug_nans`` checks the loss and the gradients before the update
    (``check_finite``)."""
    det = deterministic(cfg)
    if _distributed(mesh):
        return _distributed_step(cfg, grad_accum, lr_fn, mesh, debug_nans)

    def loss_of(params, x, y, generator):
        _, loss = gpt.forward(params, x, cfg, targets=y,
                              generator=None if det else generator,
                              deterministic=det, return_logits=False)
        return loss

    def train_step(state: TrainState, batch: Batch,
                   generator: Optional[torch.Generator] = None
                   ) -> Dict[str, torch.Tensor]:
        x, y = batch
        state.optimizer.zero_grad()
        if grad_accum > 1:
            loss = x.new_zeros((), dtype=torch.float32)
            for xm, ym in _split(x, y, grad_accum):
                loss_i = loss_of(state.params, xm, ym, generator)
                (loss_i / grad_accum).backward()
                loss = loss + loss_i.detach()
            loss = loss / grad_accum
        else:
            loss = loss_of(state.params, x, y, generator)
            loss.backward()
            loss = loss.detach()
        if debug_nans:
            check_finite(loss, state.optimizer.grads(), state.step + 1)
        metrics = {"loss": loss, **state.optimizer.step(state.step)}
        if lr_fn is not None:
            metrics["lr"] = torch.tensor(float(lr_fn(state.step)))
        state.step += 1
        return metrics

    return train_step


def _split(x, y, grad_accum):
    if x.shape[0] % grad_accum:
        raise ValueError(f"batch {x.shape[0]} not divisible by grad_accum={grad_accum}")
    return zip(x.chunk(grad_accum), y.chunk(grad_accum))


def _distributed_step(cfg, grad_accum, lr_fn, mesh, debug_nans=False):
    """The train step of one rank of a job: each micro-batch's loss is its
    global token mean (this rank's sum over the count of ``batch_group``)
    plus, for MoE, the aux term, the gradients are summed
    (``all_reduce_grads``; under ZeRO reduce-scattered over dp,
    ``AdamW.reduce_grads``), then clip and AdamW run on every rank (on its
    slices under fsdp, ep or tp; on its 1/dp under ZeRO). Dropout draws
    from ``rank_generator``. Under pp each split runs the stage's schedule
    (``gpt.pipeline_terms``) in place of the one ``.backward()``; the loss
    is then summed over ``loss_group`` (the stages and the data ranks)."""
    det = deterministic(cfg)
    # made here, on every rank: making a group is collective
    loss_group = (mesh.group_over(("pp",) + mesh_lib.DATA_AXES) if mesh.pp > 1
                  else None)

    def split_terms(state, xm, ym, gen, count):
        """One split's (cross-entropy mean share, aux share), backpropagated."""
        if loss_group is not None:
            total, aux, _, _ = gpt.pipeline_terms(
                state.params, xm, ym, cfg, generator=gen, deterministic=det, mesh=mesh,
                loss_scale=1.0 / (count * grad_accum), aux_scale=1.0 / grad_accum)
            return total / count, aux
        total, _, aux = gpt.loss_terms(state.params, xm, ym, cfg, generator=gen,
                                       deterministic=det, mesh=mesh, with_aux=True)
        ((total / count + aux) / grad_accum).backward()
        return total.detach() / count, aux.detach()

    def train_step(state: TrainState, batch: Batch,
                   generator: Optional[torch.Generator] = None
                   ) -> Dict[str, torch.Tensor]:
        x, y = batch
        state.optimizer.zero_grad()
        gen = None if det else rank_generator(generator, mesh.data_rank)
        loss = x.new_zeros((), dtype=torch.float32)
        extra = x.new_zeros((), dtype=torch.float32)
        for xm, ym in _split(x, y, grad_accum):
            count = D.all_reduce((ym != -1).sum().float(),
                                 mesh.batch_group).clamp_min(1)
            ce, aux = split_terms(state, xm, ym, gen, count)
            loss = loss + ce
            extra = extra + aux
        if loss_group is not None:
            loss = D.all_reduce(loss + extra, loss_group) / grad_accum
        else:
            loss = (D.all_reduce(loss, mesh.batch_group) + extra) / grad_accum
        if state.optimizer.zero is not None:
            state.optimizer.reduce_grads()
        else:
            all_reduce_grads(state.params, mesh)
        if debug_nans:
            check_finite(loss, state.optimizer.grads(), state.step + 1)
        metrics = {"loss": loss, **state.optimizer.step(state.step)}
        if lr_fn is not None:
            metrics["lr"] = torch.tensor(float(lr_fn(state.step)))
        state.step += 1
        return metrics

    return train_step


def make_eval_step(cfg: GPTConfig, mesh: Optional[Mesh] = None):
    """(state, (x, y)) -> mean loss (device scalar), no gradient; the
    global token mean across a mesh's ranks."""

    @torch.no_grad()
    def eval_step(state: TrainState, batch: Batch) -> torch.Tensor:
        x, y = batch
        if _distributed(mesh):
            total, count, aux = gpt.loss_terms(state.params, x, y, cfg, mesh=mesh,
                                               with_aux=True)
            return (D.all_reduce(total, mesh.batch_group)
                    / D.all_reduce(count.float(), mesh.batch_group).clamp_min(1) + aux)
        _, loss = gpt.forward(state.params, x, cfg, targets=y,
                              return_logits=False)
        return loss

    return eval_step


# The profiler keeps only device records whose times, converted from the
# card's clock, fall inside its window; on an H100 they read 2-5 ms earlier
# than the host's launch, so a kernel launched within that of the window's
# opening lost its record (23 flash_fwd events against 24 launches). The
# window opens this long before the next step starts.
PROFILE_PAD_S = 0.02


class GPTTrainer:
    """Trains a GPT on this process's device: ``GPTTrainer(trainer_config,
    gpt_config, optimizer_config, train_view, test_view)``, then
    ``train()``. In a job of several processes (``distributed.initialize``
    first) it is one rank of ``trainer_config.mesh``."""

    def __init__(
        self,
        config: TrainerConfig,
        gpt_config: GPTConfig,
        optimizer_config: OptimizerConfig,
        train_dataset: CharView,
        test_dataset: Optional[CharView] = None,
        experiment_config: Optional[ExperimentConfig] = None,
        device: Optional[Device] = None,
    ):
        world = D.world_size()
        config.check_ported(world)
        shape = dict(zip(mesh_lib.AXES, mesh_lib.resolve_mesh_shape(config.mesh, world)))
        gpt.check_supported(gpt_config, shape)
        gpt.check_pipeline(gpt_config, shape, train_dataset.block_size)
        self.config = config
        self.gpt_config = gpt_config
        self.experiment_config = experiment_config
        self.device = resolve_device(device)
        self.mesh = Mesh(config.mesh) if world > 1 else None
        self.process_count = world
        self.is_main = D.rank() == 0
        shard = {}
        if self.mesh is not None:
            shard = dict(process_index=self.mesh.batch_index,
                         process_count=self.mesh.batch_count,
                         seq_index=self.mesh.sp_rank, seq_count=self.mesh.sp)
        self.train_iter = ShardedBatchIterator(
            train_dataset, config.batch_size, shuffle=True, seed=config.seed,
            **shard)
        self.test_iter = (
            ShardedBatchIterator(test_dataset, config.batch_size, shuffle=False,
                                 seed=config.seed, **shard)
            if test_dataset is not None and len(test_dataset) >= config.batch_size
            else None)
        self.snapshot_path = config.snapshot_path or ckpt_lib.DEFAULT_SNAPSHOT_PATH
        # the backend: .pt or .msgpack = one file (a gather to one writer);
        # any other path = a sharded directory (collective, no gather)
        self.sharded_snapshot = checkpoint_sharded.is_sharded_path(self.snapshot_path)
        if config.async_save and self.sharded_snapshot:
            # refuse rather than silently run sync: the user asked for
            # overlap they would not be getting
            raise ConfigError(
                "async_save=True only applies to the one-file backend; sharded "
                "directory saves run synchronously (collective write). Set "
                "async_save=False, or use a .pt or .msgpack snapshot_path.")
        # transient-I/O retries shared by save and restore, the jitter seeded
        # from config.seed (JAX trainer.py:320)
        self._retry = RetryPolicy(attempts=config.io_retries,
                                  base_delay_s=config.io_retry_delay_s,
                                  seed=config.seed)
        self._stop_requested = False
        self.preempted = False
        # async_save: the writer thread in flight and a failure it left
        self._save_thread: Optional[threading.Thread] = None
        self._save_exc: Optional[BaseException] = None
        # telemetry on rank 0 (the single writer, like MetricsLogger)
        self.tracer = SpanTracer(enabled=self.is_main)
        if config.spans_jsonl and self.is_main:
            self.tracer.attach_jsonl(config.spans_jsonl)
        self.telemetry_server: Optional[TelemetryServer] = None
        registry = None
        if config.metrics_port and self.is_main:
            registry = get_registry()
            self.telemetry_server = TelemetryServer(registry, port=config.metrics_port)
            log_event(f"telemetry: serving /metrics and /healthz on "
                      f"{self.telemetry_server.url('')}", tracer=self.tracer)
        self._profiler = None

        self._lr_fn = lr_schedule(optimizer_config)
        params = gpt.init(gpt_config, torch.Generator().manual_seed(config.seed),
                          device=self.device)
        size_report = gpt.model_size_report(params, gpt_config)
        # ZeRO: the plan is static per (mesh, model); dp 1 keeps it None, so
        # the step is the replicated one
        self.zero_plan = None
        if config.zero_dp:
            if self.sharded_snapshot:
                # the directory backend writes each rank's tensors as they
                # are: a zero_dp snapshot would bake in this run's dp view
                raise ConfigError(
                    "zero_dp=True requires the one-file backend (a .pt or "
                    ".msgpack snapshot_path): its save path canonicalises the "
                    "dp-sharded optimizer state so snapshots restore at any dp "
                    "extent. The sharded directory backend would persist the "
                    "view layout.")
            if self.mesh is not None and self.mesh.dp > 1:
                self.zero_plan = zero_lib.make_plan(self.mesh, params)
        if self.sharded:
            params = self.mesh.shard_params(params)
        params = trainable(params)
        self.state = TrainState(params, make_optimizer(
            optimizer_config, params, config.grad_norm_clip, self._lr_fn,
            mesh=self.mesh, zero=self.zero_plan))
        # performance attribution: set by register_attrib()
        self._attrib = self._attrib_clock = None
        self._attrib_variant = ""
        self.generator = torch.Generator(device=self.device).manual_seed(config.seed)
        self.start_epoch = 0
        if self.sharded_snapshot:
            restored = checkpoint_sharded.restore(self.snapshot_path, self.state.params,
                                                  self.state.optimizer, self.mesh,
                                                  self._retry)
            if restored is not None:
                self._restore_meta(restored)
        else:
            restored = ckpt_lib.load_snapshot(self.snapshot_path, self._retry)
            if restored is not None:
                self._restore(restored)
        if restored is None:
            self._print("Snapshot not found. Training model from scratch")
        else:
            self._print(f"Resuming training from snapshot at epoch "
                        f"{restored['epoch']}, step {restored['step']}")

        self._train_step = make_train_step(
            gpt_config, grad_accum=config.grad_accum_steps, lr_fn=self._lr_fn,
            mesh=self.mesh, debug_nans=config.debug_nans)
        self._eval_step = make_eval_step(gpt_config, self.mesh)
        name = (torch.cuda.get_device_name(self.device)
                if self.device.type == "cuda" else "cpu")
        # tokens/s counts the global batch, so MFU is against every card the
        # job runs on (gloo ranks may share one)
        cards = (world if D.backend() == "nccl"
                 else min(world, max(1, torch.cuda.device_count())))
        peak = peak_flops(name, gpt_config.dtype)
        self.metrics = MetricsLogger(gpt_config, jsonl_path=config.metrics_jsonl,
                                     peak=peak and peak * cards,
                                     enabled=self.is_main,
                                     tensorboard_dir=config.tensorboard_dir,
                                     registry=registry)
        self._print(size_report)

    def register_attrib(self, ledger, clock, hbm=None) -> None:
        """Register the train step with a ``telemetry.attribution``
        ``ProgramLedger``: family ``train_step``, variant ``zero`` (the
        dp-sharded update) or ``dense``, with analytic costs (three forward
        passes' products and bytes, ``attribution.forward_cost``, over this
        rank's rows). Each step's host-visible time then goes to
        ``observe_call``, read on the injected ``clock``. With an
        ``HBMLedger`` the resident state is accounted too: ``params`` and
        ``opt_state`` at the bytes this rank holds (``zero.opt_moment_bytes``
        over its fsdp/tp/ep slices: 1/dp of each under a ZeRO plan)."""
        from mingpt_distributed_tpu_torch.telemetry import attribution

        self._attrib, self._attrib_clock = ledger, clock
        self._attrib_variant = "zero" if self.zero_plan is not None else "dense"
        rows = self.config.batch_size // (self.mesh.batch_count if self.mesh else 1)
        block = self.train_iter.view.block_size
        weights = attribution.tree_bytes(self.state.params)
        flops, nbytes = attribution.forward_cost(
            self.gpt_config, rows, block, block, weights, 0, head_rows=rows * block)
        ledger.observe_compile("train_step", 0.0, 3 * flops, 3 * nbytes,
                               variant=self._attrib_variant)
        if hbm is not None:
            hbm.account("params", weights)
            hbm.account("opt_state", zero_lib.opt_moment_bytes(
                self.state.params, self.zero_plan))

    def audit_contracts(self) -> Dict[str, dict]:
        """The program audit's contract for the ``train_step`` family that
        ``register_attrib`` registers, as the JAX trainer's: in one process
        no collective; in a job of several every parallel form may appear
        (gradient sums, fsdp's gathers and reduce-scatters, the ring's and
        the pipeline's permutes, the expert exchange). AdamW writes every
        parameter leaf in place (``donated_min``: one per leaf, the JAX
        contract's floor). Its copies on a card: the batch's two arrays up."""
        multi = D.world_size() > 1
        return {"train_step": {
            "allowed_collectives": (("all-gather", "all-reduce", "all-to-all",
                                     "collective-permute", "reduce-scatter")
                                    if multi else ()),
            "donated_min": sum(1 for _ in gpt._leaves(self.state.params)),
            "host_transfers": 2,
        }}

    @property
    def sharded(self) -> bool:
        """Whether this rank holds slices of the parameters (fsdp or tp)."""
        return self.mesh is not None and self.mesh.sharded

    def _print(self, msg: str) -> None:
        if self.is_main:
            log_event(msg)

    def _restore(self, snap: Dict[str, Any]) -> None:
        """Load a snapshot (whole tensors, whatever mesh wrote it), each
        leaf and moment cut to this rank's slice under fsdp or tp."""
        part = self.mesh.shard if self.sharded else (lambda _name, t: t)
        with torch.no_grad():
            def load(dst, src, where=""):
                if set(dst) != set(src):
                    raise ValueError(f"snapshot params{where}: keys {sorted(src)} "
                                     f"do not match the config's {sorted(dst)}")
                for k, v in dst.items():
                    path = f"{where}/{k}".lstrip("/")
                    if isinstance(v, dict):
                        load(v, src[k], f"{where}/{k}")
                        continue
                    want = (self.mesh.full_shapes[path] if self.sharded
                            else tuple(v.shape))
                    if want != tuple(src[k].shape):
                        raise ValueError(f"snapshot params{where}/{k}: shape "
                                         f"{tuple(src[k].shape)}, config wants "
                                         f"{want}")
                    v.copy_(part(path, src[k].to(v.device)))
            load(self.state.params, snap["params"])
        self.state.optimizer.load_canonical_state_dict(snap["opt_state"], part)
        self._restore_meta(snap)

    def _restore_meta(self, snap: Dict[str, Any]) -> None:
        """The step, epoch, data iterator and generator of a snapshot."""
        self.state.step = int(snap["step"])
        self.start_epoch = int(snap["epoch"])
        self.train_iter.state = IteratorState.from_dict(snap["data_state"])
        self.generator.set_state(torch.as_tensor(snap["generator"], dtype=torch.uint8))

    @property
    def step(self) -> int:
        return self.state.step

    def _put_batch(self, xy: Tuple[np.ndarray, np.ndarray]) -> Batch:
        def put(a):
            t = torch.from_numpy(a)
            if self.device.type == "cuda":
                # pinned + non_blocking: the copy does not wait for the card
                return t.pin_memory().to(self.device, non_blocking=True).long()
            return t.long()
        return put(xy[0]), put(xy[1])

    # -- preemption ------------------------------------------------------------
    def request_stop(self, signum: Optional[int] = None) -> None:
        """Stop at the next step boundary, snapshot, set ``preempted``."""
        self._stop_requested = True

    def _on_signal(self, signum, frame) -> None:
        if self._stop_requested and signum == signal.SIGINT:
            raise KeyboardInterrupt  # a second Ctrl-C means now
        log_event(f"[trainer] {signal.Signals(signum).name} received: stopping at "
                  f"the next step boundary, snapshotting, then exiting with code "
                  f"{REQUEUE_EXIT_CODE} (requeue)")
        self.request_stop(signum)

    def _stop_agreed(self) -> bool:
        """Whether any rank was asked to stop: every rank stops at the same
        step boundary. The flag goes over the host group, so the host does
        not wait here for the step it has just enqueued."""
        if self.mesh is None:
            return self._stop_requested
        return D.any_rank(self._stop_requested)

    def _install_signal_handlers(self):
        if not self.config.handle_signals:
            return None
        if threading.current_thread() is not threading.main_thread():
            return None
        return {sig: signal.signal(sig, self._on_signal)
                for sig in (signal.SIGTERM, signal.SIGINT)}

    # -- the loop ----------------------------------------------------------------
    def train(self) -> Dict[str, Any]:
        """Epochs from ``start_epoch``: train, log, eval and snapshot.
        Returns the last logged metrics (with ``eval_loss`` after an eval)."""
        prev = self._install_signal_handlers()
        try:
            return self._train_loop()
        finally:
            if prev is not None:
                for sig, handler in prev.items():
                    signal.signal(sig, handler)

    def _train_loop(self) -> Dict[str, Any]:
        cfg = self.config
        last: Dict[str, Any] = {}
        block = self.train_iter.view.block_size
        tokens_per_step = cfg.batch_size * block
        stop = False
        self._profile(self.state.step)  # a window opening after step 1 warms up now
        for epoch in range(self.start_epoch, cfg.max_epochs):
            # the prefetch thread runs ahead of the iterator's position;
            # `consumed` is what was trained on, the truth for resume
            consumed = self.train_iter.state.step_in_epoch
            source = self.train_iter.epoch_batches()
            if cfg.prefetch > 0:
                source = PrefetchIterator(source, depth=cfg.prefetch)
            for xy in source:
                # host-visible step time: the step's enqueue (and, at logged
                # steps, the wait for the card)
                ta0 = self._attrib_clock() if self._attrib is not None else 0.0
                with self.tracer.span("train.step", step=self.state.step + 1):
                    m = self._train_step(self.state, self._put_batch(xy),
                                         self.generator)
                if self._attrib is not None:
                    self._attrib.observe_call("train_step", self._attrib_clock() - ta0,
                                              variant=self._attrib_variant)
                step = self.state.step
                consumed += 1
                self._profile(step)
                if step % cfg.log_every == 0 or (cfg.max_steps and step >= cfg.max_steps):
                    scalars = {k: v.item() for k, v in m.items()}
                    scalars["epoch"] = epoch
                    last = self.metrics.log_step(step, tokens_per_step, block, scalars)
                if self._stop_agreed():
                    self.preempted = stop = True
                if cfg.max_steps and step >= cfg.max_steps:
                    stop = True
                if stop:
                    break
            if stop:
                # stop the producer before touching the iterator's state,
                # then set it to the batches actually trained on
                if cfg.prefetch > 0:
                    source.close()
                self.train_iter.state = IteratorState(
                    epoch=epoch, step_in_epoch=consumed,
                    seed=self.train_iter.state.seed)
            epoch_done = epoch + (0 if stop else 1)
            if self.test_iter is not None and not self.preempted and (
                    stop or (epoch + 1) % cfg.eval_every == 0):
                last["eval_loss"] = self.evaluate()
                self._print(f"epoch {epoch} | eval_loss {last['eval_loss']:.4f}")
            if stop or (epoch + 1) % cfg.save_every == 0:
                self.save_snapshot(epoch_done)
            if stop:
                break
        self._join_pending_save()
        return last

    def _profile(self, step: int) -> None:
        """``profile_dir``: a torch.profiler trace from the end of step
        ``profile_steps[0]`` to the end of step ``profile_steps[1]``,
        written as ``trace_steps_<a>-<b>.json`` (Chrome trace format). The
        tracer starts one step earlier and records from the window's edge
        (torch.profiler's warmup): a tracer started at the edge drops the
        first device records of the window, more of them after earlier
        profiler sessions in the process (seen on an H100). On a card the
        window opens on an idle device and PROFILE_PAD_S before the next
        step's first launch (see PROFILE_PAD_S)."""
        cfg = self.config
        if not (cfg.profile_dir and self.is_main):
            return
        first, last = cfg.profile_steps
        if step == first - 1 and self._profiler is None:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self._profiler = torch.profiler.profile(
                activities=acts, schedule=torch.profiler.schedule(
                    wait=0, warmup=1, active=max(1, last - first)))
            self._profiler.__enter__()
        elif step == first and self._profiler is not None:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self._profiler.step()  # warmup -> recording
            if self.device.type == "cuda":
                time.sleep(PROFILE_PAD_S)
        elif step == last and self._profiler is not None:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self._profiler.__exit__(None, None, None)
            os.makedirs(cfg.profile_dir, exist_ok=True)
            path = os.path.join(cfg.profile_dir, f"trace_steps_{first}-{last}.json")
            self._profiler.export_chrome_trace(path)
            self._profiler = None
            log_event(f"profiler trace written to {path}", tracer=self.tracer,
                      step=step)

    def evaluate(self) -> float:
        """Mean loss over the eval set (``eval_batches`` caps it); read from
        the card once, at the end."""
        with self.tracer.span("train.eval"):
            return self._evaluate()

    def _evaluate(self) -> float:
        losses = []
        self.test_iter.state = IteratorState(seed=self.config.seed)
        for i, xy in enumerate(self.test_iter.epoch_batches()):
            if self.config.eval_batches and i >= self.config.eval_batches:
                break
            losses.append(self._eval_step(self.state, self._put_batch(xy)))
        return float(torch.stack(losses).mean().item())

    def save_snapshot(self, epoch: int) -> None:
        """A sharded directory: every rank writes its slices
        (``checkpoint_sharded.save``). One file: rank 0 writes; under a
        sharded mesh every rank first joins the gather of the whole tree.
        The others wait for the write. In a job of several processes a
        state above ``msgpack_gather_limit_mb`` is refused before any
        collective, with the JAX package's message."""
        if self.sharded_snapshot:
            with self.tracer.span("train.snapshot", epoch=epoch):
                checkpoint_sharded.save(self.snapshot_path, self.state.params,
                                        self.state.optimizer, self.mesh,
                                        self._snapshot_meta(epoch), self._retry)
            self._print(f"Snapshot saved to {self.snapshot_path} (epoch {epoch}, "
                        f"step {self.state.step}, sharded)")
            return
        if self.process_count > 1:
            self._check_gather_limit()
        whole = (self._gather_state()
                 if self.sharded or self.zero_plan is not None else None)
        if not self.is_main:
            D.barrier()
            return
        with self.tracer.span("train.snapshot", epoch=epoch):
            self._save(epoch, whole)
        D.barrier()

    def _check_gather_limit(self) -> None:
        """The JAX trainer's guard on its multi-host msgpack save: the whole
        state (parameters and Adam moments, at their whole shapes) gathered
        to a writer must fit ``msgpack_gather_limit_mb``."""
        opt = self.state.optimizer
        state_bytes = 0
        for name, p in zip(opt.names, opt.params):
            shape = self.mesh.full_shapes[name] if self.sharded else p.shape
            copies = 3 if opt.opt.state else 1
            state_bytes += copies * math.prod(shape) * p.element_size()
        state_mb = state_bytes / 2**20
        limit_mb = self.config.msgpack_gather_limit_mb
        if state_mb > limit_mb:
            raise RuntimeError(
                f"multi-host one-file save would allgather {state_mb:.0f} MB of "
                f"state to one writer (limit {limit_mb} MB). Use the sharded "
                f"directory backend (the port's counterpart of the Orbax "
                f"backend) — a snapshot_path that ends in neither .pt nor "
                f".msgpack — for sharded collective writes with no gather, or "
                f"raise trainer_config.msgpack_gather_limit_mb if your hosts "
                f"have the RAM.")

    def _gather_state(self) -> Tuple[gpt.Params, Dict]:
        """The whole parameter tree and optimizer state dict, gathered from
        every rank's slices (every rank takes part)."""
        mesh = self.mesh
        full = ((lambda name, t: mesh.gather_full(name, t).cpu()) if self.sharded
                else (lambda name, t: t.detach().cpu()))

        def whole(tree, prefix=""):
            return {k: whole(v, f"{prefix}{k}/") if isinstance(v, dict)
                    else full(f"{prefix}{k}", v) for k, v in tree.items()}

        opt_state = self.state.optimizer.canonical_state_dict(full)
        return whole(self.state.params), opt_state

    def _snapshot_meta(self, epoch: int) -> Dict[str, Any]:
        """What a snapshot holds beside the tensors (JSON-ready)."""
        return {"step": self.state.step, "epoch": epoch,
                "data_state": self.train_iter.state.to_dict(),
                "generator": self.generator.get_state().tolist(),
                "config": (self.experiment_config.to_dict()
                           if self.experiment_config else {})}

    def _save(self, epoch: int, whole=None) -> None:
        cpu = lambda t: {k: cpu(v) if isinstance(v, dict)  # noqa: E731
                         else v.detach().cpu() for k, v in t.items()}
        params, opt_state = whole or (cpu(self.state.params),
                                      self.state.optimizer.opt.state_dict())
        snap = {"params": params, "opt_state": opt_state, **self._snapshot_meta(epoch),
                "generator": self.generator.get_state()}
        if not self.config.async_save:
            self._write(snap, "")
            return
        # the next step updates parameters and moments in place: copy them
        # whole before the writer starts (a .cpu() of a CPU tensor aliases)
        snap = _host_copy(snap)
        self._join_pending_save()
        self._save_thread = threading.Thread(
            target=self._write_async, args=(snap,), name="snapshot-writer")
        self._save_thread.start()

    def _write(self, snap: Dict[str, Any], how: str) -> None:
        ckpt_lib.save_snapshot(self.snapshot_path, snap,
                               keep=self.config.keep_snapshots, retry=self._retry,
                               shards=self.zero_plan.dp if self.zero_plan else 1)
        log_event(f"Snapshot saved to {self.snapshot_path} (epoch {snap['epoch']}, "
                  f"step {snap['step']}{how})")

    def _write_async(self, snap: Dict[str, Any]) -> None:
        try:
            self._write(snap, ", async")
        except BaseException as e:  # noqa: BLE001 (re-raised at the next join)
            self._save_exc = e

    def _join_pending_save(self) -> None:
        """Wait for an in-flight async snapshot write and re-raise its
        failure: a swallowed one would resume from a stale snapshot."""
        if self._save_thread is not None:
            self._save_thread.join()
            self._save_thread = None
        exc, self._save_exc = self._save_exc, None
        if exc is not None:
            raise RuntimeError(
                f"async snapshot write to {self.snapshot_path} failed") from exc

    def close(self) -> None:
        if self._profiler is not None:  # the run ended inside the window
            self._profiler.__exit__(None, None, None)
            self._profiler = None
        self.metrics.close()
        self.tracer.close()
        if self.telemetry_server is not None:
            self.telemetry_server.close()
            self.telemetry_server = None
