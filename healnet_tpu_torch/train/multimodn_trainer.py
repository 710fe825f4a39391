"""MultiModN's own trainer.

Counterpart of ``healnet_tpu/train/multimodn_trainer.py``: MultiModN's
multi-task classification protocol, with per (encoder stage x decoder)
loss and accuracy matrices (stage 0: the decoders on the initial state),
binary confusion counts (sensitivity, specificity, balanced accuracy), a
:class:`~healnet_tpu_torch.models.baselines.MultiModNHistory`, and
``train_epoch`` / ``test`` / ``predict`` / ``fit``. The optimizer is the
port's :class:`~healnet_tpu_torch.train.schedule.Adam` at a constant rate
(optax's ``adam(lr)``); batches come from
:func:`~healnet_tpu_torch.train.loop.iterate_batches`, padded and masked.
An epoch's metrics stay on the device until its end.

The survival pipeline trains MultiModN through
:class:`~healnet_tpu_torch.train.loop.SurvivalTrainer` with ``aux_loss``;
this trainer serves MultiModN's own protocol. It runs on the GPU unless
``device="cpu"`` is asked for.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from healnet_tpu_torch.device import DeviceLike, resolve_device
from healnet_tpu_torch.models.baselines.multimodn import MultiModNHistory, _softmax_ce
from healnet_tpu_torch.train.loop import iterate_batches, place_batch
from healnet_tpu_torch.train.schedule import Adam


def _stage_metrics(stages, targets_onehot: torch.Tensor,
                   sample_mask: torch.Tensor) -> Dict[str, torch.Tensor]:
    """(n_stages, n_dec) loss and accuracy matrices, and for two-class
    decoders the confusion counts tp / tn / fp / fn over the valid rows
    (zero for other decoders)."""
    n_stage, n_dec = len(stages), len(stages[0])
    target_cls = torch.argmax(targets_onehot, dim=-1)
    w = sample_mask.to(torch.float32)
    valid = w > 0
    denom = torch.clamp(torch.sum(w), min=1.0)
    zero = torch.zeros((), device=w.device)
    cells: Dict[str, List[torch.Tensor]] = {k: [] for k in ("loss", "accuracy", "tp", "tn",
                                                             "fp", "fn")}
    for s in range(n_stage):
        for d in range(n_dec):
            logits = stages[s][d]
            pred = torch.argmax(logits, dim=-1)
            cells["loss"].append(_softmax_ce(logits, targets_onehot, w))
            cells["accuracy"].append(torch.sum((pred == target_cls) * w) / denom)
            if logits.shape[-1] == 2:
                pos, ppos = target_cls == 1, pred == 1
                for key, hit in (("tp", pos & ppos), ("tn", ~pos & ~ppos),
                                 ("fp", ~pos & ppos), ("fn", pos & ~ppos)):
                    cells[key].append(torch.sum(hit & valid).to(torch.float32))
            else:
                for key in ("tp", "tn", "fp", "fn"):
                    cells[key].append(zero)
    return {k: torch.stack(v).reshape(n_stage, n_dec) for k, v in cells.items()}


def compute_binary_rates(m: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Sensitivity, specificity and balanced accuracy from confusion counts
    (NaN where a rate has no denominator)."""
    tp, tn, fp, fn = (np.asarray(m[k], np.float64) for k in ("tp", "tn", "fp", "fn"))
    with np.errstate(divide="ignore", invalid="ignore"):
        sens = np.where(tp + fn > 0, tp / (tp + fn), np.nan)
        spec = np.where(tn + fp > 0, tn / (tn + fp), np.nan)
    return {"sensitivity": sens, "specificity": spec, "balanced_accuracy": (sens + spec) / 2.0}


class MultiModNTrainer:
    """Trainer for :class:`~healnet_tpu_torch.models.baselines.MultiModNModule`'s
    own protocol. ``data`` dicts carry ``tensors`` (one array per encoder),
    ``y_disc`` (int class labels), ``censorship`` and ``event_time``
    (carried by the batches, unused)."""

    def __init__(self, module: torch.nn.Module, *, n_classes: int, lr: float = 1e-3,
                 batch_size: int = 8, seed: int = 0, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.module = module.to(self.device)
        self.n_classes, self.batch_size, self.seed = n_classes, batch_size, seed
        # optax.adam(lr): beta1 0.9, beta2 0.999, eps 1e-8, a constant rate
        self.optimizer = Adam(self.module.parameters(), betas=(0.9, 0.999), eps=1e-8)
        self.optimizer.lr.fill_(lr)

    # ------------------------------------------------------------- plumbing
    def _batches(self, data: Dict[str, Any], shuffle: bool = False, rng=None):
        for batch in iterate_batches(data, self.batch_size, shuffle=shuffle, rng=rng):
            yield place_batch(batch, self.device)

    def _forward_metrics(self, batch: Dict[str, Any]):
        y = batch["y_disc"].long()
        targets = (y[:, None] == torch.arange(self.n_classes, device=y.device)).float()
        stages, state_changes, loss = self.module(
            batch["tensors"], targets, return_stages=True, sample_weights=batch["sample_mask"])
        metrics = _stage_metrics(stages, targets, batch["sample_mask"])
        metrics["state_change"] = state_changes
        return loss, metrics

    @staticmethod
    def _mean(sums: Optional[Dict[str, torch.Tensor]], count: int, what: str):
        if sums is None:
            raise ValueError(f"{what} received an empty dataset (0 batches)")
        return {k: (v / count).cpu().numpy() for k, v in sums.items()}

    # ------------------------------------------------------------- protocol
    def train_epoch(self, data: Dict[str, Any], epoch: int = 0,
                    history: Optional[MultiModNHistory] = None,
                    rng: Optional[np.random.Generator] = None) -> Dict[str, np.ndarray]:
        # a fresh generator per epoch by default: one seed every call would
        # replay the same batch order each epoch
        rng = rng or np.random.default_rng(self.seed + epoch)
        self.module.train()
        sums, count = None, 0
        for batch in self._batches(data, shuffle=True, rng=rng):
            self.optimizer.zero_grad(set_to_none=True)
            loss, metrics = self._forward_metrics(batch)
            loss.backward()
            self.optimizer.step()
            metrics = {k: v.detach() for k, v in metrics.items()}
            sums = metrics if sums is None else {k: sums[k] + metrics[k] for k in sums}
            count += 1
        epoch_metrics = self._mean(sums, count, "train_epoch")
        if history is not None:
            self._log_history(history, epoch, epoch_metrics, prefix="train")
        return epoch_metrics

    def test(self, data: Dict[str, Any], epoch: int = 0,
             history: Optional[MultiModNHistory] = None) -> Dict[str, np.ndarray]:
        self.module.eval()
        sums, count = None, 0
        with torch.no_grad():
            for batch in self._batches(data):
                _, metrics = self._forward_metrics(batch)
                sums = metrics if sums is None else {k: sums[k] + metrics[k] for k in sums}
                count += 1
        out = self._mean(sums, count, "test")
        out.update(compute_binary_rates(out))
        if history is not None:
            self._log_history(history, epoch, out, prefix="val")
        return out

    def predict(self, data: Dict[str, Any]) -> np.ndarray:
        """Final-stage class predictions of decoder 0, one a sample."""
        self.module.eval()
        preds: List[np.ndarray] = []
        with torch.no_grad():
            for batch in self._batches(data):
                stages, _, _ = self.module(batch["tensors"], None, return_stages=True)
                pred = torch.argmax(stages[-1][0], dim=-1).cpu().numpy()
                preds.append(pred[batch["sample_mask"].cpu().numpy() > 0])
        return np.concatenate(preds)

    def fit(self, train_data: Dict[str, Any], val_data: Dict[str, Any], epochs: int = 10,
            history: Optional[MultiModNHistory] = None
            ) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
        rng = np.random.default_rng(self.seed)
        train_m = val_m = None
        for epoch in range(1, epochs + 1):
            train_m = self.train_epoch(train_data, epoch, history, rng=rng)
            val_m = self.test(val_data, epoch, history)
        return train_m, val_m

    @staticmethod
    def _log_history(history, epoch, metrics, prefix):
        loss, acc = metrics["loss"], metrics["accuracy"]
        for s in range(loss.shape[0]):
            for d in range(loss.shape[1]):
                history.log(epoch, s, d,
                            **{f"{prefix}_loss": loss[s, d], f"{prefix}_accuracy": acc[s, d]})
