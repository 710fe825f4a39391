"""Survival training step on one device.

Counterpart of the step body of ``healnet_tpu/train/loop.py``
(``SurvivalTrainer._surv_loss``, ``_forward`` and the ``train_step`` /
``eval_step`` of ``_build_steps``): forward with dropout, the survival loss
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

Not ported yet: ``fit`` / ``evaluate`` and metrics, checkpoints, streaming
datasets, fused epochs, meshes with row-sharded arenas, and modules with
their own auxiliary loss.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List, Mapping, Optional

import numpy as np
import torch

from healnet_tpu_torch.device import DeviceLike, resolve_device
from healnet_tpu_torch.ops.quantize import QuantizedContext, quantize_context_host
from healnet_tpu_torch.parallel.arena import gather_bag, place_arena
from healnet_tpu_torch.train.losses import (
    CoxPHSurvLoss,
    ce_loss,
    hazards_survival_risk,
    nll_loss,
)
from healnet_tpu_torch.train.schedule import make_optimizer, progress_hyperparams
from healnet_tpu_torch.utils.train_utils import accepts_kv_masks, calc_reg_loss


def iterate_batches(
    data: Mapping[str, Any],
    batch_size: int,
    shuffle: bool = False,
    rng: Optional[np.random.Generator] = None,
) -> Iterator[Dict[str, Any]]:
    """Yield static-shape numpy batches from a dict of whole-split arrays
    (``tensors``, ``y_disc``, ``censorship``, ``event_time``, optional
    ``presence`` and ``kv_masks``, and for arena-indexed data
    ``patch_offsets`` / ``patch_lengths``, carried as int32); the trailing
    batch is padded and masked."""
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
        module: an ``nn.Module`` whose ``forward(tensors, presence=...,
            generator=..., seed_generator=...)`` returns (b, n_bins) logits
            (:class:`healnet_tpu_torch.models.healnet.HealNetModule`).
        loss_type: "nll" | "ce_survival" | "cox".
        l1: L1 regularisation weight.
        gc_compat: divisor of the survival loss before the backward (the
            reference's gradient-accumulation quirk).
        accum_steps: micro-batches per batch; gradients are averaged.
        seed: seeds the trainer's generators: one on the device for the
            feed-forward dropout masks, one on the host for the attention
            hash seeds (so drawing them needs no device read).
        device: the GPU unless ``"cpu"`` is asked for.
        feature_arena: the packed feature arena, as ``(arena, offsets,
            lengths)`` or the bare arena (numpy, tensor, or a
            ``QuantizedContext``); uploaded to the device once, on first use.
        arena_quant: store the arena as per-token int8 values and f32 scales
            (quantized on the host): half the device bytes and half the
            context bytes each step reads.
        arena_device: an arena already on the device, used as it is.

    ``batch_size``, ``epochs``, ``patience``, ``early_stopping``,
    ``eval_interval`` and ``tracker`` are kept for ``fit``, which is not
    ported yet.
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
    ):
        if loss_type not in ("nll", "ce_survival", "cox"):
            raise ValueError(f"unknown loss_type {loss_type}")
        if accum_steps < 1 or batch_size % accum_steps != 0:
            raise ValueError("batch_size must be divisible by accum_steps")
        self.device = resolve_device(device)
        self.module = module.to(self.device)
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
        self._accepts_kv_masks = accepts_kv_masks(module)
        self.optimizer = make_optimizer(self.module.parameters(), cycle_momentum)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.seed_generator = torch.Generator().manual_seed(seed + 1)
        self._norm_groups = None  # (names, group names, group index) of grad_stats
        if feature_arena is not None and not isinstance(feature_arena, (tuple, list)):
            feature_arena = (feature_arena, None, None)
        self._arena_host = None if feature_arena is None else feature_arena[0]
        self._arena = arena_device  # placed on first use when None
        self.arena_quant = bool(arena_quant) or isinstance(self._arena_host, QuantizedContext)

    def _device_arena(self):
        """The feature arena on the device, uploaded on the first call (int8
        values and scales when ``arena_quant``), or None without one."""
        if self._arena is None and self._arena_host is not None:
            host = self._arena_host
            if self.arena_quant and not isinstance(host, QuantizedContext):
                host = QuantizedContext(*quantize_context_host(np.asarray(host)))
            self._arena = place_arena(host, self.device)
        return self._arena

    # ------------------------------------------------------------ pieces
    def _place(self, batch: Mapping[str, Any]) -> Dict[str, Any]:
        """Host batch (numpy or tensors) -> tensors on the trainer's device;
        float64 arrives as float32, as in JAX, and integers (labels, arena
        offsets) keep their type."""
        def put(x):
            if x is None:
                return None
            x = torch.as_tensor(x, device=self.device)
            return x.float() if x.dtype == torch.float64 else x

        out = {k: put(v) for k, v in batch.items() if k not in ("tensors", "kv_masks")}
        out["tensors"] = tuple(put(t) for t in batch["tensors"])
        if batch.get("kv_masks") is not None:
            out["kv_masks"] = tuple(put(m) for m in batch["kv_masks"])
        return out

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

    def _forward(self, batch, train: bool) -> torch.Tensor:
        if batch.get("patch_offsets") is not None and self._device_arena() is not None:
            # the slide modality comes from the arena: (b, width, dim) bags,
            # width fixed by the last KV mask
            slide = gather_bag(self._arena, batch["patch_offsets"], batch["kv_masks"][-1])
            batch = dict(batch, tensors=tuple(batch["tensors"]) + (slide,))
        kwargs = {}
        if batch.get("kv_masks") is not None and self._accepts_kv_masks:
            kwargs["kv_masks"] = batch["kv_masks"]
        if train:
            kwargs.update(generator=self.generator, seed_generator=self.seed_generator)
        return self.module(batch["tensors"], presence=batch.get("presence"), **kwargs)

    def _loss(self, batch):
        """(total loss to differentiate, survival loss, risk)."""
        logits = self._forward(batch, train=True)
        surv_loss, risk = self._surv_loss(logits, batch)
        total = surv_loss / float(self.gc_compat)
        if self.l1 > 0:
            total = total + calc_reg_loss(self.module, self.l1, self.reg_topo, self.sources)
        return total, surv_loss, risk

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
        self.module.train()
        self.optimizer.zero_grad(set_to_none=True)
        a = self.accum_steps
        if a == 1:
            total, surv_loss, risk = self._loss(batch)
            total.backward()
        else:
            losses, risks = [], []
            for mb in _micro_batches(batch, a):
                total, loss, r = self._loss(mb)
                (total / a).backward()
                losses.append(loss.detach())
                risks.append(r.detach())
            surv_loss, risk = sum(losses) / a, torch.cat(risks)
        gstats = self.grad_stats()
        progress_hyperparams(self.optimizer, 1.0 if horizon is None else horizon,
                             self.max_lr, cycle_momentum=self.cycle_momentum)
        self.optimizer.step()
        return surv_loss.detach(), risk.detach(), gstats

    def eval_step(self, batch: Mapping[str, Any]):
        """``(loss, risk, logits)`` without dropout or gradients."""
        batch = self._place(batch)
        self.module.eval()
        with torch.no_grad():
            logits = self._forward(batch, train=False)
            surv_loss, risk = self._surv_loss(logits, batch)
        return surv_loss, risk, logits
