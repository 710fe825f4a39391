"""Survival training on one device or a mesh: the step and the fold loop.

Counterpart of ``healnet_tpu/train/loop.py``. The step
(``SurvivalTrainer._surv_loss``, ``_forward`` and the ``train_step`` /
``eval_step`` of ``_build_steps`` there): forward with dropout, the survival loss
divided by ``gc_compat`` plus ``l1`` times the L1 norm of the parameters,
backward, gradient norms per top-level module, then Adam with the OneCycle
lr and beta1 written for the step (:mod:`healnet_tpu_torch.train.schedule`).
``accum_steps`` splits a batch into micro-batches whose gradients are
averaged.

Static batch shapes as in the JAX package: :func:`iterate_batches` pads the
trailing batch by repeating its last row and masks the padding through
``sample_mask``.

Feature arena (``feature_arena=``): every slide's patch features packed into
one array uploaded to the device once, as plain values or, with
``arena_quant``, as per-token int8 values and f32 scales (quantized on the
host). Batches then carry ``patch_offsets`` / ``patch_lengths`` instead of
the slide tensor, and each step gathers its bags on the device
(:func:`healnet_tpu_torch.parallel.arena.gather_bag`), appending the slide
as the last modality.

The fold loop (``fit`` and ``evaluate`` there): epochs of shuffled batches
(``np.random.default_rng(seed + fold + 977 * epoch)``, as in JAX) through a
:class:`healnet_tpu_torch.etl.DevicePrefetcher`, the train loss weighted by
valid rows (events for cox), the censored c-index on the host
(:mod:`healnet_tpu_torch.train.metrics`), validation every
``eval_interval`` epochs, the tracker's ``log`` / ``watch``, a checkpoint a
epoch (:class:`healnet_tpu_torch.train.checkpoint.Checkpointer`) with
resume, early stopping with the best weights restored, and the test split
with the missing-modality ablations. Each epoch reseeds the dropout
generators from ``(seed + 1000 * fold, epoch)``, so a resumed run draws
what an uninterrupted one would have.

Fused epochs (``fused_epochs=True``, with a feature arena only, as in JAX):
an epoch's batches are grouped by bucket width (the order becomes
contiguous within each bucket, still shuffled within it), each bucket's
batches and its attention seeds (drawn from the seed generator in the
order the stepwise path draws them) go to the device in one copy
(:class:`healnet_tpu_torch.train.fused.StepTable`), and the step runs from
there: captured as one CUDA graph per bucket shape on the card and
replayed once a step, eagerly on the CPU. Validation runs the same way.
Losses, risks and gradient norms come back once a bucket.

Any module of the port trains here: HealNet and the baselines
(:mod:`healnet_tpu_torch.models.baselines`). A module is called with the
keywords its ``forward`` takes: ``kv_masks``, and in training the
trainer's ``generator`` (on the device: every dropout mask, feed-forward
and baseline alike), ``seed_generator`` and ``seeds`` (HealNet's attention
hash seeds). With ``aux_loss`` (MultiModN) the module also takes the
one-hot targets, ``presence`` and ``sample_weights`` and returns
``(model_loss, logits)``; the model loss joins the total (and, in
evaluation, the loss), as in JAX.

Meshes (``mesh=``, a :class:`healnet_tpu_torch.parallel.mesh.Mesh`; one
process a device): every rank iterates the same host batches (the same
seeds) and places its block (:func:`healnet_tpu_torch.parallel.train.
put_batch`: its ``data`` rows, and a context's tokens split over ``seq``,
a gathered arena bag's too); the module's weights are sharded at
construction by the tensor-parallel rules (``tensor_parallel``; the
baselines stay replicated and split the batch only); the step's loss is
the global batch's, as the sharded step's
(:func:`healnet_tpu_torch.parallel.train.sharded_loss`), its gradients are
summed over ``data``, and every rank takes the same update of its shards. ``arena_sharded`` splits the feature arena's rows
over ``seq`` with a halo of ``arena_halo`` rows
(:class:`healnet_tpu_torch.parallel.arena.ShardedArena`), widened to the
first batch's gather width where that is wider. Fused epochs need a mesh
of one device. Only the ranks with ``data`` and ``seq`` coordinates 0
write checkpoints (under a ``model`` split each of them its own shards, in
``model_<m>/`` of the checkpoint directory), and only rank 0 calls the
tracker: no two ranks write one file.
"""

from __future__ import annotations

import itertools
import time
from typing import Any, Dict, Iterator, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from healnet_tpu_torch.device import DeviceLike, resolve_device
from healnet_tpu_torch.etl.prefetch import DevicePrefetcher
from healnet_tpu_torch.ops.quantize import QuantizedContext, quantize_context_host
from healnet_tpu_torch.parallel.arena import build_device_arena, gather_bag, place_arena
from healnet_tpu_torch.parallel.data import local_batch_rows
from healnet_tpu_torch.parallel.mesh import AXIS_DATA, AXIS_MODEL, AXIS_SEQ, Mesh
from healnet_tpu_torch.parallel.train import (
    full_shapes,
    global_batch,
    put_batch,
    sharded_loss,
    shard_module,
    split_sq_norms,
    splits_tokens,
    sync_grads,
    unshard_shapes_,
)
from healnet_tpu_torch.train.checkpoint import Checkpointer
from healnet_tpu_torch.train.fused import (
    StepTable,
    bucket_groups,
    padded_steps,
    run_steps,
    table_signature,
)
from healnet_tpu_torch.train.losses import (
    CoxPHSurvLoss,
    ce_loss,
    hazards_survival_risk,
    nll_loss,
)
from healnet_tpu_torch.train.metrics import concordance_index_native
from healnet_tpu_torch.train.schedule import make_optimizer, progress_hyperparams
from healnet_tpu_torch.utils.train_utils import EarlyStopping, calc_reg_loss, forward_keywords

_META = ("censorship", "event_time", "sample_mask")


def iterate_batches(
    data,
    batch_size: int,
    shuffle: bool = False,
    rng: Optional[np.random.Generator] = None,
    bucket_boundaries: Optional[Sequence[int]] = None,
) -> Iterator[Dict[str, Any]]:
    """Yield static-shape numpy batches from a dict of whole-split arrays
    (``tensors``, ``y_disc``, ``censorship``, ``event_time``, optional
    ``presence`` and ``kv_masks``, and for arena-indexed data
    ``patch_offsets`` / ``patch_lengths``, carried as int32); the trailing
    batch is padded and masked.

    ``data`` may instead be a streaming source with ``iter_batches(
    batch_size, shuffle=, rng=[, bucket_boundaries=])``, whose batches are
    passed on; ``bucket_boundaries`` only applies to such a source."""
    if hasattr(data, "iter_batches"):
        kw = {"bucket_boundaries": bucket_boundaries} if bucket_boundaries else {}
        yield from data.iter_batches(batch_size, shuffle=shuffle, rng=rng, **kw)
        return
    n = data["y_disc"].shape[0]
    idx = np.arange(n)
    if shuffle:
        (rng or np.random.default_rng()).shuffle(idx)
    for start in range(0, n, batch_size):
        sel = idx[start:start + batch_size]
        pad = batch_size - sel.shape[0]
        mask = np.ones(batch_size, dtype=np.float32)
        if pad > 0:
            sel = np.concatenate([sel, np.repeat(sel[-1:], pad)])
            mask[batch_size - pad:] = 0.0
        batch = {
            "tensors": tuple(np.asarray(t)[sel] for t in data["tensors"]),
            "y_disc": np.asarray(data["y_disc"])[sel].astype(np.int32),
            "censorship": np.asarray(data["censorship"])[sel].astype(np.float32),
            "event_time": np.asarray(data["event_time"])[sel].astype(np.float32),
            "sample_mask": mask,
        }
        if data.get("presence") is not None:
            batch["presence"] = np.asarray(data["presence"])[sel].astype(np.float32)
        if data.get("kv_masks") is not None:
            batch["kv_masks"] = tuple(
                None if m is None else np.asarray(m)[sel] for m in data["kv_masks"]
            )
        for key in ("patch_offsets", "patch_lengths"):  # arena-indexed data
            if key in data:
                batch[key] = np.asarray(data[key])[sel].astype(np.int32)
        yield batch


def place_batch(batch: Mapping[str, Any], device: torch.device,
                non_blocking: bool = False) -> Dict[str, Any]:
    """Host batch (numpy or tensors) -> tensors on ``device``; float64
    arrives as float32, as in JAX, and integers (labels, arena offsets)
    keep their type. ``non_blocking`` copies pinned arrays asynchronously
    (the prefetcher's side stream)."""
    def put(x):
        if x is None:
            return None
        x = torch.as_tensor(x).to(device, non_blocking=non_blocking)
        return x.float() if x.dtype == torch.float64 else x

    out = {k: put(v) for k, v in batch.items() if k not in ("tensors", "kv_masks")}
    out["tensors"] = tuple(put(t) for t in batch["tensors"])
    if batch.get("kv_masks") is not None:
        out["kv_masks"] = tuple(put(m) for m in batch["kv_masks"])
    return out


def _micro_batches(batch: Mapping[str, Any], a: int) -> List[Dict[str, Any]]:
    """Split every per-sample entry of a placed batch into ``a`` equal parts."""
    def split(x):
        if x is None:
            return [None] * a
        if isinstance(x, (tuple, list)):
            return list(zip(*(split(t) for t in x)))
        return list(torch.chunk(x, a, dim=0))

    parts = {k: split(v) for k, v in batch.items()}
    return [{k: v[i] for k, v in parts.items()} for i in range(a)]


class SurvivalTrainer:
    """Trains a HealNet-style module for discrete-time survival, one device.

    Args:
        module: an ``nn.Module`` whose ``forward(tensors, presence=...)``
            returns (b, n_bins) logits, taking ``kv_masks``, ``generator``,
            ``seed_generator`` and ``seeds`` where its signature has them
            (:class:`~healnet_tpu_torch.models.healnet.HealNetModule`, the
            baselines).
        loss_type: "nll" | "ce_survival" | "cox".
        l1: L1 regularisation weight.
        gc_compat: divisor of the survival loss before the backward (the
            reference's gradient-accumulation quirk).
        accum_steps: micro-batches per batch; gradients are averaged.
        seed: seeds the trainer's generators: one on the device for the
            dropout masks (HealNet's feed-forward, every baseline's), one on
            the host for the attention hash seeds (so drawing them needs no
            device read).
        device: the GPU unless ``"cpu"`` is asked for.
        feature_arena: the packed feature arena, as ``(arena, offsets,
            lengths)`` or the bare arena (numpy, tensor, or a
            ``QuantizedContext``); uploaded to the device once, on first use.
        arena_quant: store the arena as per-token int8 values and f32 scales
            (quantized on the host): half the device bytes and half the
            context bytes each step reads.
        arena_device: an arena already on the device, used as it is.
        batch_size, epochs, patience, early_stopping, eval_interval: the
            fold loop's (:meth:`fit`); validation runs every
            ``eval_interval`` epochs and on the last.
        tracker: an object with ``log(metrics, step=)`` and ``watch(params=,
            grad_stats=, step=, prefix=)``, called once an epoch.
        checkpoint_dir, resume, keep_checkpoints: a checkpoint each epoch
            (the newest ``keep_checkpoints`` kept; None keeps all), and
            whether :meth:`fit` resumes from the newest.
        prefetch: host batches produced ahead on a background thread (0:
            none), copied to the device one batch ahead.
        bucket_boundaries: length buckets of a streaming ragged-bag source.
        fused_epochs: with ``feature_arena`` (ignored without one, as in
            JAX), each epoch's steps and each evaluation's run bucket by
            bucket from static device buffers, captured as CUDA graphs on
            the card (see the module's docstring).
        aux_loss: the module's ``forward(tensors, targets=, presence=,
            sample_weights=)`` returns ``(model_loss, logits)``
            (:class:`~healnet_tpu_torch.models.baselines.MultiModNModule`);
            the targets are one-hot over ``n_bins`` and the padded rows'
            ``sample_mask`` is 0.
        mesh: a :class:`~healnet_tpu_torch.parallel.mesh.Mesh`; the steps
            run sharded over it (see the module's docstring), on its device.
        tensor_parallel: split the weights over the mesh's ``model`` axis
            (else replicated).
        arena_sharded, arena_halo: with ``mesh``, the feature arena's rows
            split over ``seq``, each shard with ``arena_halo`` rows of the
            next (default: the widest bucket or bag).
    """

    def __init__(
        self,
        module: torch.nn.Module,
        *,
        loss_type: str = "nll",
        alpha: float = 0.4,
        l1: float = 0.0,
        class_weights: Optional[np.ndarray] = None,
        gc_compat: int = 16,
        batch_size: int = 4,
        epochs: int = 50,
        max_lr: float = 8e-3,
        patience: int = 5,
        early_stopping: bool = True,
        eval_interval: int = 1,
        cycle_momentum: bool = True,
        seed: int = 0,
        tracker=None,
        reg_topo: str = "healnet",
        sources: Optional[List[str]] = None,
        accum_steps: int = 1,
        device: DeviceLike = None,
        feature_arena: Optional[Any] = None,
        arena_quant: bool = False,
        arena_device: Optional[Any] = None,
        aux_loss: bool = False,
        n_bins: Optional[int] = None,
        checkpoint_dir=None,
        resume: bool = False,
        keep_checkpoints: Optional[int] = 3,
        mesh=None,
        tensor_parallel: bool = True,
        prefetch: int = 2,
        bucket_boundaries: Optional[Sequence[int]] = None,
        fused_epochs: bool = False,
        arena_sharded: bool = False,
        arena_halo: Optional[int] = None,
    ):
        if loss_type not in ("nll", "ce_survival", "cox"):
            raise ValueError(f"unknown loss_type {loss_type}")
        if accum_steps < 1 or batch_size % accum_steps != 0:
            raise ValueError("batch_size must be divisible by accum_steps")
        if aux_loss and n_bins is None:
            raise ValueError("aux_loss models need n_bins")
        if mesh is not None and not isinstance(mesh, Mesh):
            raise TypeError(f"mesh must be a healnet_tpu_torch.parallel.mesh.Mesh, got "
                            f"{type(mesh).__name__}")
        sharded = mesh is not None and mesh.size > 1
        if mesh is not None and batch_size % mesh.shape[AXIS_DATA]:
            raise ValueError(f"batch_size {batch_size} does not divide over the mesh's data "
                             f"axis of {mesh.shape[AXIS_DATA]}")
        if sharded and (aux_loss or accum_steps > 1):
            raise ValueError("aux_loss and accum_steps > 1 train on a mesh of one device")
        if mesh is not None:
            dev = None if device is None else resolve_device(device)
            if dev is not None and (dev.type != mesh.device.type or dev.index not in (
                    None, mesh.device.index)):
                raise ValueError(f"device {device} is not the mesh's {mesh.device}")
            device = mesh.device
        self.device = resolve_device(device)
        self.mesh, self.tensor_parallel = mesh, bool(tensor_parallel)
        self.module = module.to(self.device)
        # the mesh's layout of the weights (HealNet's; the baselines take
        # the batch split only, their weights replicated)
        self._mesh_module = mesh is not None and hasattr(module, "set_mesh")
        if self._mesh_module:
            shard_module(self.module, mesh, self.tensor_parallel)
        self.loss_type, self.alpha = loss_type, alpha
        self.l1 = float(l1)
        self.class_weights = (
            None if class_weights is None
            else torch.as_tensor(np.asarray(class_weights), dtype=torch.float32,
                                 device=self.device)
        )
        self.gc_compat = gc_compat
        self.batch_size, self.epochs, self.max_lr = batch_size, epochs, max_lr
        self.patience, self.early_stopping = patience, early_stopping
        self.eval_interval = max(1, int(eval_interval))
        self.cycle_momentum = cycle_momentum
        self.seed, self.tracker = seed, tracker
        self.reg_topo, self.sources = reg_topo, sources
        self.accum_steps = accum_steps
        self.checkpoint_dir, self.resume = checkpoint_dir, resume
        self.keep_checkpoints = keep_checkpoints  # None keeps every epoch
        self.prefetch = prefetch
        self.bucket_boundaries = (
            tuple(int(b) for b in bucket_boundaries) if bucket_boundaries else None)
        self.aux_loss, self.n_bins = bool(aux_loss), n_bins
        self._forward_keys = forward_keywords(module)
        self.optimizer = make_optimizer(self.module.parameters(), cycle_momentum)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.seed_generator = torch.Generator().manual_seed(seed + 1)
        self._norm_groups = None  # (names, group names, group index) of grad_stats
        if feature_arena is not None and not isinstance(feature_arena, (tuple, list)):
            feature_arena = (feature_arena, None, None)
        self._arena_host = None if feature_arena is None else feature_arena[0]
        self._arena = arena_device  # placed on first use when None
        self.arena_quant = bool(arena_quant) or isinstance(self._arena_host, QuantizedContext)
        # fused epochs: the schedule's horizon on the device (the captured
        # step reads it), and the step tables by (kind, width, steps, layout)
        self.fused_epochs = bool(fused_epochs) and self._arena_host is not None
        if self.fused_epochs and sharded:
            raise ValueError("fused_epochs with a mesh of more than one process is not "
                             "supported (the step tables are one device's); use stepwise steps")
        self.arena_sharded = bool(arena_sharded) and mesh is not None
        if arena_halo is None:
            candidates = list(self.bucket_boundaries or [])
            if feature_arena is not None and feature_arena[2] is not None:
                candidates.append(int(np.max(feature_arena[2])))
            arena_halo = max(candidates) if candidates else None
        self.arena_halo = arena_halo
        self._horizon = torch.ones((), dtype=torch.float32, device=self.device)
        self._tables: Dict[tuple, StepTable] = {}
        self._capture_stream = None

    def set_fold(self, *, seed: int, class_weights=None, checkpoint_dir=None):
        """Point the trainer at a new fold: the seed, class weights and
        checkpoint directory; the module's weights drawn anew from a
        generator seeded with ``seed`` and a fresh optimizer."""
        self.seed = seed
        self.class_weights = (
            None if class_weights is None
            else torch.as_tensor(np.asarray(class_weights), dtype=torch.float32,
                                 device=self.device)
        )
        self.checkpoint_dir = checkpoint_dir
        # drawn on the host at full size, as a new module's weights are
        unshard_shapes_(self.module)
        self.module.to("cpu")
        self.module.reset_parameters(torch.Generator().manual_seed(seed))
        self.module.to(self.device)
        if self._mesh_module:
            shard_module(self.module, self.mesh, self.tensor_parallel)
        self._new_optimizer()
        self.generator.manual_seed(seed)
        self.seed_generator.manual_seed(seed + 1)
        return self

    def _new_optimizer(self) -> None:
        """A fresh optimizer; the captured steps, which point at the old
        one's state, are dropped (the next fused epoch captures anew)."""
        self.optimizer = make_optimizer(self.module.parameters(), self.cycle_momentum)
        for table in self._tables.values():
            table.graph = None

    def _seed_epoch(self, fold: int, epoch: int) -> None:
        """Reseed the dropout generators from ``(seed + 1000 * fold,
        epoch)``: an epoch draws the same masks whether or not the run
        before it was interrupted."""
        ff, seeds = np.random.SeedSequence([self.seed + 1000 * fold, epoch]).generate_state(2)
        self.generator.manual_seed(int(ff))
        self.seed_generator.manual_seed(int(seeds))

    def _device_arena(self):
        """The feature arena on the device, uploaded on the first call (int8
        values and scales when ``arena_quant``; this rank's halo'd rows when
        ``arena_sharded``), or None without one."""
        if self._arena is None and self._arena_host is not None:
            host = self._arena_host
            if self.arena_quant and not isinstance(host, QuantizedContext):
                host = QuantizedContext(*quantize_context_host(np.asarray(host)))
            if self.arena_sharded:
                if self.arena_halo is None:
                    raise ValueError("arena_sharded needs arena_halo (the widest gather "
                                     "window): pass bucket_boundaries or the bag lengths")
                self._arena = build_device_arena(host, self.mesh, halo=self.arena_halo)
            else:
                self._arena = place_arena(host, self.device)
        return self._arena

    def _widen_halo(self, batch: Mapping[str, Any]) -> None:
        """Before the halo'd shards are built: a batch source that pads every
        gather to ``max_patches`` may pass the halo's candidates (buckets and
        bag lengths); the halo takes the batch's gather width then."""
        if (self.arena_sharded and self._arena is None and batch.get("kv_masks") is not None
                and batch.get("patch_offsets") is not None):
            width = int(np.shape(batch["kv_masks"][-1])[1])
            if self.arena_halo is None or width > self.arena_halo:
                self.arena_halo = width

    # ------------------------------------------------------------ pieces
    def _place(self, batch: Mapping[str, Any], non_blocking: bool = False) -> Dict[str, Any]:
        """The batch on the device; on a mesh this rank's block of it."""
        if self.mesh is None:
            return place_batch(batch, self.device, non_blocking)
        if "seq_sharded" in batch:  # this rank's block already
            return batch
        self._widen_halo(batch)
        return put_batch(batch, self.mesh, split_tokens=self._mesh_module)

    def _mesh_split(self) -> bool:
        return self.mesh is not None and self.mesh.size > 1

    def _surv_loss(self, logits, batch):
        hazards, survival, risk = hazards_survival_risk(logits)
        sw = batch["sample_mask"]
        if self.loss_type == "nll":
            loss = nll_loss(hazards, survival, batch["y_disc"], batch["censorship"],
                            weights=self.class_weights, alpha=self.alpha, sample_weights=sw)
        elif self.loss_type == "ce_survival":
            loss = ce_loss(hazards, survival, batch["y_disc"], batch["censorship"],
                           alpha=0.15, sample_weights=sw)
        else:  # cox
            loss = CoxPHSurvLoss()(hazards, survival, batch["censorship"],
                                   event_time=batch["event_time"], sample_weights=sw)
        return loss, risk

    def _forward(self, batch, train: bool, seeds: Optional[torch.Tensor] = None):
        """``(logits, the module's own loss)``; the loss is None without
        ``aux_loss``."""
        if batch.get("patch_offsets") is not None and self._device_arena() is not None:
            # the slide modality comes from the arena: (b, width, dim) bags,
            # width fixed by the last KV mask (rows outside a bag zero, as
            # the bag baselines pool every token)
            slide = gather_bag(self._arena, batch["patch_offsets"], batch["kv_masks"][-1],
                               mesh=self.mesh)
            batch = dict(batch, tensors=tuple(batch["tensors"]) + (slide,))
            if "seq_sharded" in batch:
                batch["seq_sharded"] = tuple(batch["seq_sharded"]) + (self._split_bag(batch),)
                if batch["seq_sharded"][-1]:
                    batch["tensors"] = batch["tensors"][:-1] + (self._local_tokens(slide),)
        keys = self._forward_keys
        kwargs = {}
        if batch.get("seq_sharded") and any(batch["seq_sharded"]):
            kwargs["seq_sharded"] = batch["seq_sharded"]
        if batch.get("kv_masks") is not None and "kv_masks" in keys:
            kwargs["kv_masks"] = batch["kv_masks"]
        if train:
            for name, gen in (("generator", self.generator),
                              ("seed_generator", self.seed_generator)):
                if name in keys:
                    kwargs[name] = gen
            if seeds is not None:
                kwargs["seeds"] = seeds
        if self.aux_loss:
            # one-hot by comparison: out-of-range labels give zero rows, as
            # jax.nn.one_hot, and nothing is read back from the device
            y = batch["y_disc"].long()
            targets = (y[:, None] == torch.arange(self.n_bins, device=y.device)).float()
            model_loss, logits = self.module(
                batch["tensors"], targets=targets, presence=batch.get("presence"),
                sample_weights=batch.get("sample_mask"), **kwargs)
            return logits, model_loss
        return self.module(batch["tensors"], presence=batch.get("presence"), **kwargs), None

    def _split_bag(self, batch) -> bool:
        """Whether a gathered bag's tokens split over ``seq``: the batch
        placement's rule, for a HealNet module."""
        return self._mesh_module and splits_tokens(batch["kv_masks"][-1].shape[1], self.mesh)

    def _local_tokens(self, slide):
        """This rank's block of a gathered bag's tokens."""
        n = slide.shape[1] // self.mesh.shape[AXIS_SEQ]
        sl = slice(self.mesh.coord(AXIS_SEQ) * n, (self.mesh.coord(AXIS_SEQ) + 1) * n)
        if isinstance(slide, QuantizedContext):
            return QuantizedContext(slide.data[:, sl], slide.scale[:, sl])
        return slide[:, sl]

    def _reg(self, module) -> torch.Tensor:
        return calc_reg_loss(module, self.l1, self.reg_topo, self.sources)

    def _loss(self, batch, seeds: Optional[torch.Tensor] = None):
        """(total loss to differentiate, survival loss, risk): the global
        batch's on a mesh (:func:`~healnet_tpu_torch.parallel.train.
        sharded_loss`)."""
        logits, model_loss = self._forward(batch, train=True, seeds=seeds)
        total, surv_loss, risk = sharded_loss(self.module, logits, batch, self.mesh,
                                              self._surv_loss, l1=self.l1,
                                              gc_compat=self.gc_compat, reg=self._reg)
        if model_loss is not None:
            total = total + model_loss
        return total, surv_loss, risk

    def _eval_loss(self, batch):
        """(survival loss plus the module's own, risk, logits) without
        dropout or gradients."""
        self.module.eval()
        with torch.no_grad():
            logits, model_loss = self._forward(batch, train=False)
            logits, batch = global_batch(logits, batch, self.mesh)
            loss, risk = self._surv_loss(logits, batch)
        return (loss if model_loss is None else loss + model_loss), risk, logits

    def grad_stats(self) -> Dict[str, torch.Tensor]:
        """Gradient L2 norms per top-level submodule (or parameter) and in
        total, as device scalars."""
        tops, grads = [], []
        for name, p in self.module.named_parameters():
            if p.grad is not None:
                tops.append(name.split(".")[0])
                grads.append(p.grad)
        # one multi-tensor norm and one scatter, not two launches a tensor;
        # the scatter index is built once (a host-to-device copy waits for
        # the device)
        sq = torch.stack(torch._foreach_norm(grads)).float() ** 2
        if self._mesh_module:
            sq = split_sq_norms(self.module, self.mesh, sq)
        if self._norm_groups is None or self._norm_groups[0] != tops:
            keys = list(dict.fromkeys(tops))
            index = torch.tensor([keys.index(t) for t in tops], device=sq.device)
            self._norm_groups = (tops, keys, index)
        _, keys, index = self._norm_groups
        norms = torch.zeros(len(keys), device=sq.device).index_add_(0, index, sq).sqrt()
        stats = dict(zip(keys, norms.unbind()))
        stats["global"] = torch.sqrt(torch.sum(sq))
        return stats

    # ------------------------------------------------------------- steps
    def train_step(self, batch: Mapping[str, Any], horizon: Optional[float] = None):
        """One update: returns ``(surv_loss, risk, grad_stats)`` as device
        tensors (nothing is read back to the host). ``horizon`` is the
        schedule's length in steps (default 1: the schedule's end)."""
        batch = self._place(batch)
        self._horizon.fill_(1.0 if horizon is None else float(horizon))
        return self._update(batch)

    def _update(self, batch: Mapping[str, Any], seeds: Optional[torch.Tensor] = None):
        """One update from a placed batch, the schedule at ``self._horizon``;
        ``seeds``: the step's attention seeds, one row of ``attention_calls``
        seeds a micro-batch (drawn from the seed generator when None)."""
        self.module.train()
        self.optimizer.zero_grad(set_to_none=True)
        a = self.accum_steps
        rows = [None] * a if seeds is None else seeds.view(a, -1).unbind(0)
        if a == 1:
            total, surv_loss, risk = self._loss(batch, rows[0])
            total.backward()
        else:
            losses, risks = [], []
            for mb, row in zip(_micro_batches(batch, a), rows):
                total, loss, r = self._loss(mb, row)
                (total / a).backward()
                losses.append(loss.detach())
                risks.append(r.detach())
            surv_loss, risk = sum(losses) / a, torch.cat(risks)
        if self._mesh_split():
            sync_grads(self.module, self.mesh)
        gstats = self.grad_stats()
        progress_hyperparams(self.optimizer, self._horizon, self.max_lr,
                             cycle_momentum=self.cycle_momentum)
        self.optimizer.step()
        return surv_loss.detach(), risk.detach(), gstats

    def eval_step(self, batch: Mapping[str, Any]):
        """``(loss, risk, logits)`` without dropout or gradients."""
        return self._eval_loss(self._place(batch))

    # ------------------------------------------------------------- fused epochs
    def _step_table(self, kind: str, blist, out_width: int) -> StepTable:
        """The static buffers of a bucket's batches (made on first use and
        kept: a table's captured step replays in every later epoch)."""
        width = int(blist[0]["kv_masks"][-1].shape[1])
        key = (kind, width, padded_steps(len(blist)), table_signature(blist[0]))
        table = self._tables.get(key)
        if table is None:
            table = StepTable(blist[0], key[2], out_width, self.device)
            self._tables[key] = table
        return table

    def _run_table(self, table: StepTable, body, n_real: int, generator=None) -> None:
        if self.device.type == "cuda" and self._capture_stream is None:
            self._capture_stream = torch.cuda.Stream(self.device)
        run_steps(table, body, n_real, generator, self._capture_stream)

    def _attention_seeds(self) -> int:
        """Hash seeds a fused train step takes: the module's attention calls
        for each micro-batch, or 0 without attention dropout."""
        module = self.module
        if getattr(module, "attn_dropout", 0.0) > 0 and hasattr(module, "attention_calls"):
            return self.accum_steps * module.attention_calls()
        return 0

    def _fused_train_body(self, table: StepTable) -> None:
        """One step from slot ``counter``: the update, then its loss, risks
        and gradient norms (in ``grad_stats`` order) into the output slot."""
        table.select()
        batch = dict(table.batch)
        seeds = batch.pop("seeds", None)
        loss, risk, gstats = self._update(batch, seeds)
        row = torch.cat([loss.float().reshape(1), risk.float().reshape(-1),
                         torch.stack(list(gstats.values())).float()])
        table.emit(F.pad(row, (0, table.out.shape[1] - row.numel())))

    def _fused_eval_body(self, table: StepTable) -> None:
        table.select()
        loss, risk, _ = self._eval_loss(table.batch)
        table.emit(torch.cat([loss.float().reshape(1), risk.float().reshape(-1)]))

    @staticmethod
    def _collect(blist, cens, times, masks) -> None:
        for hb in blist:
            cens.append(np.asarray(hb["censorship"]))
            times.append(np.asarray(hb["event_time"]))
            masks.append(np.asarray(hb["sample_mask"]))

    def _fused_train_bucket(self, blist):
        """One bucket's steps (JAX's ``scan_train``): its batches and its
        seed table (drawn in the order the stepwise path draws them) in one
        upload, one replay a step, one read-back. Returns ``(losses (n,),
        risks (n, b), the last step's gradient norms by name)`` on the host."""
        self._widen_halo(blist[0])
        self._device_arena()
        n_real, b = len(blist), int(np.asarray(blist[0]["sample_mask"]).shape[0])
        calls = self._attention_seeds()
        if calls:
            seeds = torch.randint(0, 2**32, (n_real, calls), generator=self.seed_generator,
                                  device=self.seed_generator.device, dtype=torch.int64)
            blist = [dict(hb, seeds=row) for hb, row in zip(blist, seeds.cpu().numpy())]
        n_top = len({name.split(".")[0] for name, _ in self.module.named_parameters()})
        table = self._step_table("train", blist, 2 + b + n_top)
        table.upload(blist)
        self._run_table(table, lambda: self._fused_train_body(table), n_real, self.generator)
        out = table.out[:n_real].cpu()
        keys = list(self._norm_groups[1]) + ["global"]
        norms = out[-1, 1 + b:1 + b + len(keys)]
        return out[:, 0], out[:, 1:1 + b], {k: float(v) for k, v in zip(keys, norms)}

    def _fused_train_epoch(self, batches, losses, risks, cens, times, masks):
        """An epoch's steps bucket by bucket; returns the last step's
        gradient norms."""
        gstats = None
        for blist in bucket_groups(batches).values():
            loss, risk, gstats = self._fused_train_bucket(blist)
            losses.append(loss)
            risks.append(risk.reshape(-1))
            self._collect(blist, cens, times, masks)
        return gstats

    def _fused_evaluate(self, batches, losses, risks, cens, times, masks) -> None:
        """Evaluation bucket by bucket (JAX's ``scan_eval``)."""
        self._widen_halo(batches[0])
        self._device_arena()
        for blist in bucket_groups(batches).values():
            n_real, b = len(blist), int(np.asarray(blist[0]["sample_mask"]).shape[0])
            table = self._step_table("eval", blist, 1 + b)
            table.upload(blist)
            self._run_table(table, lambda: self._fused_eval_body(table), n_real)
            out = table.out[:n_real].cpu()
            losses.append(out[:, 0])
            risks.append(out[:, 1:].reshape(-1))
            self._collect(blist, cens, times, masks)

    # ------------------------------------------------------------- fold loop
    def _put(self, host_batch, non_blocking: bool = False):
        """(the batch on the device, its survival metadata on the host)."""
        meta = {k: np.asarray(host_batch[k]) for k in _META}
        return self._place(host_batch, non_blocking=non_blocking), meta

    def _weighted_loss(self, losses: List[torch.Tensor], cens, masks) -> float:
        """Batch losses (device scalars, or a fused bucket's host vector)
        weighted by the count each one's normaliser used: events for cox,
        valid rows otherwise."""
        losses = torch.cat([x.reshape(-1) for x in losses]).float().cpu().numpy()
        if self.loss_type == "cox":
            valid = np.asarray([((1.0 - c) * m).sum() for c, m in zip(cens, masks)])
        else:
            valid = np.asarray([m.sum() for m in masks])
        return float((np.asarray(losses) * valid).sum() / max(float(valid.sum()), 1.0))

    @staticmethod
    def _c_index(cens, times, risks: List[torch.Tensor], masks, what: str) -> float:
        """The censored c-index over a split's valid rows (one host read of
        the risks)."""
        mask = np.concatenate(masks) > 0
        risk = local_batch_rows(torch.cat(risks))
        try:
            return concordance_index_native(
                (1 - np.concatenate(cens)[mask]).astype(bool), np.concatenate(times)[mask],
                risk[mask], tied_tol=1e-8)[0]
        except ValueError as exc:  # an all-censored or pair-free split
            print(f"{what} c-index undefined: {exc}")
            return float("nan")

    def _steps_per_epoch(self, train_data) -> int:
        """Exact optimizer steps an epoch (each bucket pads its own
        remainder), so the OneCycle horizon matches the steps taken."""
        if hasattr(train_data, "parent") and hasattr(train_data.parent, "count_batches"):
            return train_data.parent.count_batches(train_data.indices, self.batch_size,
                                                   self.bucket_boundaries)
        if hasattr(train_data, "count_batches"):
            return train_data.count_batches(None, self.batch_size, self.bucket_boundaries)
        n = len(train_data) if hasattr(train_data, "iter_batches") else \
            train_data["y_disc"].shape[0]
        return int(np.ceil(n / self.batch_size))

    def fit(
        self,
        train_data,
        val_data,
        test_data=None,
        fold: int = 1,
        missing_ablation: bool = False,
        missing_semantics: str = "semantic",
        verbose: bool = True,
    ) -> Dict[str, Any]:
        """Train one fold for ``epochs`` epochs (or until early stopping);
        returns the last epoch's train and val loss and c-index,
        ``stopped_epoch``, ``history`` (one dict an epoch), ``params`` (the
        module's ``state_dict``), and with ``test_data`` the test loss and
        c-index (and ``missing_performance``: the test c-index with modality
        "50" / "omic" / "wsi" missing, with ``missing_ablation``)."""
        horizon = float(self._steps_per_epoch(train_data) * self.epochs)
        self._new_optimizer()
        self._horizon.fill_(horizon)
        stopper = EarlyStopping(patience=self.patience, mode="min", verbose=verbose)

        ckpt, start_epoch = None, 1
        if self.checkpoint_dir is not None:
            ckpt = Checkpointer(self._checkpoint_dir())
            latest = ckpt.latest_step() if self.resume else None
            if latest is not None:
                restored = ckpt.restore(step=latest, map_location=self.device)
                self.module.load_state_dict(restored["params"])
                self.optimizer.load_state_dict(restored["opt_state"])
                start_epoch = latest + 1
                if verbose:
                    print(f"Resumed from checkpoint epoch {latest}")

        history: List[Dict[str, Any]] = []
        train_loss = train_c = val_loss = val_c = float("nan")
        if start_epoch > self.epochs:
            # the fold finished in an earlier run: evaluate the restored
            # weights rather than report an empty loop
            if verbose:
                print(f"Fold already complete at epoch {start_epoch - 1}; "
                      "re-evaluating restored checkpoint")
            train_loss, train_c = self.evaluate(train_data)
            val_loss, val_c = self.evaluate(val_data)
            history.append(dict(epoch=start_epoch - 1, train_loss=train_loss,
                                train_c_index=train_c, val_loss=val_loss, val_c_index=val_c,
                                seconds=0.0, resumed_complete=True))
        epoch = start_epoch - 1
        for epoch in range(start_epoch, self.epochs + 1):
            t0 = time.time()
            self._seed_epoch(fold, epoch)
            batches = iterate_batches(
                train_data, self.batch_size, shuffle=True,
                rng=np.random.default_rng(self.seed + fold + 977 * epoch),
                bucket_boundaries=self.bucket_boundaries)
            losses, risks, cens, times, masks = [], [], [], [], []
            if self.fused_epochs:
                gstats = self._fused_train_epoch(batches, losses, risks, cens, times, masks)
            else:
                gstats = self._stepwise_epoch(batches, horizon, losses, risks, cens, times,
                                              masks)
            train_loss = self._weighted_loss(losses, cens, masks)
            train_c = self._c_index(cens, times, risks, masks, "train")

            do_eval = epoch % self.eval_interval == 0 or epoch == self.epochs
            val_loss, val_c = self.evaluate(val_data) if do_eval else (float("nan"),) * 2
            history.append(dict(epoch=epoch, train_loss=train_loss, train_c_index=train_c,
                                val_loss=val_loss, val_c_index=val_c, seconds=time.time() - t0))
            if verbose:
                val_str = f"val_loss {val_loss:.4f} c {val_c:.4f}" if do_eval else "val skipped"
                print(f"Epoch {epoch}: train_loss {train_loss:.4f} c {train_c:.4f} | "
                      f"{val_str} | {history[-1]['seconds']:.1f}s")
            if self.tracker is not None and self._rank() == 0:
                step = epoch if fold == 1 else None
                metrics_log = {f"fold_{fold}_train_loss": train_loss,
                               f"fold_{fold}_train_c_index": train_c}
                if do_eval:
                    metrics_log[f"fold_{fold}_val_loss"] = val_loss
                    metrics_log[f"fold_{fold}_val_c_index"] = val_c
                self.tracker.log(metrics_log, step=step)
                self.tracker.watch(
                    params={k: v.detach().cpu().numpy()
                            for k, v in self.module.state_dict().items()},
                    grad_stats=None if gstats is None else {k: float(v)
                                                            for k, v in gstats.items()},
                    step=step, prefix=f"fold_{fold}_")
            if ckpt is not None and self._writes_checkpoints():
                ckpt.save(step=epoch, params=self.module.state_dict(),
                          opt_state=self.optimizer.state_dict(),
                          metrics={"val_loss": val_loss, "val_c_index": val_c} if do_eval
                          else None,
                          keep_last=self.keep_checkpoints)
            # patience counts evaluations
            if do_eval and self.early_stopping and stopper.step(val_loss, self.module):
                if verbose:
                    print(f"Early stopping at epoch {epoch}")
                best = stopper.load_best_weights()
                if best is not None:
                    self.module.load_state_dict(best)
                break

        results: Dict[str, Any] = {
            "params": self.module.state_dict(),
            "train_loss": train_loss, "train_c_index": train_c,
            "val_loss": val_loss, "val_c_index": val_c,
            "stopped_epoch": epoch,  # the last epoch run
            "history": history,
        }
        if test_data is not None:
            test_loss, test_c = self.evaluate(test_data)
            results.update(test_loss=test_loss, test_c_index=test_c)
            if self.tracker is not None and self._rank() == 0:
                self.tracker.log({f"fold_{fold}_test_loss": test_loss,
                                  f"fold_{fold}_test_c_index": test_c})
            if missing_ablation:
                results["missing_performance"] = tuple(
                    self.evaluate(test_data, missing_mode=m,
                                  missing_semantics=missing_semantics)[1]
                    for m in ("50", "omic", "wsi"))
        return results

    def _rank(self) -> int:
        return 0 if self.mesh is None else self.mesh.rank

    def _writes_checkpoints(self) -> bool:
        """The ranks with ``data`` and ``seq`` coordinates 0 (one a ``model``
        shard)."""
        return self.mesh is None or (self.mesh.coord(AXIS_DATA) == 0
                                     and self.mesh.coord(AXIS_SEQ) == 0)

    def _checkpoint_dir(self):
        """The checkpoint directory, and under a ``model`` split of the
        weights its ``model_<m>`` directory for this rank's shards."""
        if self._mesh_module and full_shapes(self.module) is not None \
                and self.mesh.shape[AXIS_MODEL] > 1:
            from pathlib import Path

            return str(Path(self.checkpoint_dir) / f"model_{self.mesh.coord(AXIS_MODEL)}")
        return self.checkpoint_dir

    def _stepwise_epoch(self, batches, horizon, losses, risks, cens, times, masks):
        """An epoch one step a batch, through the prefetcher; returns the
        last step's gradient norms (device scalars)."""
        if self.prefetch > 0:
            placed = DevicePrefetcher(
                batches, depth=2, buffer_size=self.prefetch, device=self.device,
                put_fn=lambda hb: self._put(hb, non_blocking=True))
        else:
            placed = (self._put(hb) for hb in batches)
        gstats = None
        try:
            for device_batch, meta in placed:
                loss, risk, gstats = self.train_step(device_batch, horizon=horizon)
                losses.append(loss)
                risks.append(risk)
                cens.append(meta["censorship"])
                times.append(meta["event_time"])
                masks.append(meta["sample_mask"])
        finally:
            # a failed step must not leave the producer thread holding batches
            if hasattr(placed, "close"):
                placed.close()
        return gstats

    def _ablate(self, batch: Dict[str, Any], drop: int, n_mod: int,
                missing_semantics: str) -> Dict[str, Any]:
        """The batch with modality ``drop`` missing.

        "semantic": its presence column is zero. "reference": what the
        reference's evaluation runs, a one-element modality list: the kept
        tensor goes through modality 0's tower with presence (1, 0, ...),
        or, where its shape does not fit that tower (the reference's tower
        raises inside a blanket ``except``), every presence is zero and the
        latents are never updated."""
        presence = np.ones((self.batch_size, n_mod), dtype=np.float32)
        if missing_semantics == "reference":
            if batch.get("patch_offsets") is not None:
                raise ValueError("reference ablation semantics are defined on dense "
                                 "tensor batches (the reference has no arena mode)")
            kept = np.asarray(batch["tensors"][1 - drop])
            dims, axes = self.module.channel_dims, self.module.num_spatial_axes
            if kept.shape[-1] == dims[0] and kept.ndim - 2 == axes[0]:
                b = kept.shape[0]
                tensors = [kept] + [np.zeros((b,) + (1,) * axes[i] + (dims[i],), kept.dtype)
                                    for i in range(1, len(dims))]
                batch = dict(batch, tensors=tuple(tensors))
                presence[:, 1:] = 0.0
            else:
                presence[:] = 0.0
        else:
            presence[:, drop] = 0.0
        return dict(batch, presence=presence)

    def evaluate(self, data, missing_mode: Optional[str] = None,
                 missing_semantics: str = "semantic") -> Tuple[float, float]:
        """(loss, c-index) over a split, the loss weighted as in training.

        ``missing_mode``: "50" drops the omic and the WSI modality in turn
        from batch to batch, "omic" drops modality 0, "wsi" modality 1,
        under ``missing_semantics`` "semantic" or "reference"
        (:meth:`_ablate`)."""
        if missing_mode not in (None, "50", "omic", "wsi"):
            raise ValueError(f"unknown missing_mode {missing_mode!r}")
        if missing_semantics not in ("semantic", "reference"):
            raise ValueError(f"unknown missing_semantics {missing_semantics!r}")
        losses, risks, cens, times, masks = [], [], [], [], []
        use_omic = True
        batches = iterate_batches(data, self.batch_size, bucket_boundaries=self.bucket_boundaries)
        if self.fused_epochs and missing_mode is None:
            # fused evaluation needs the split's (index-only) arena batches on
            # the host; peek at one so that a stream of feature tensors stays
            # a stream, as in JAX
            first = next(batches, None)
            if first is not None and first.get("patch_offsets") is not None:
                self._fused_evaluate([first, *batches], losses, risks, cens, times, masks)
                batches = iter(())
            else:
                batches = itertools.chain([] if first is None else [first], batches)
        for batch in batches:
            n_mod = len(batch["tensors"]) + (1 if batch.get("patch_offsets") is not None else 0)
            if missing_mode is not None and n_mod >= 2:
                if missing_mode == "50":
                    drop, use_omic = (1 if use_omic else 0), not use_omic
                else:
                    drop = 0 if missing_mode == "omic" else 1
                batch = self._ablate(batch, drop, n_mod, missing_semantics)
            loss, risk, _ = self.eval_step(batch)
            losses.append(loss)
            risks.append(risk)
            cens.append(np.asarray(batch["censorship"]))
            times.append(np.asarray(batch["event_time"]))
            masks.append(np.asarray(batch["sample_mask"]))
        c_index = self._c_index(cens, times, risks, masks, "split")
        return self._weighted_loss(losses, cens, masks), c_index
