"""The system under test: a ``healnet_tpu_torch`` module, built by
``portbench/models/<the config's model>.py``, and the port's survival
trainer in the mode the mix's ``trainer`` states, built as the port's
pipeline builds them; and the calls of its k-fold loop (``set_fold``, then
``fit``).

The benchmark takes the port from here, from the model builders and from
the kernels' roofline readers (``portbench/metrics/*_roofline.*.py``), which
time the port's own entries; no other module of it imports the port.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from healnet_tpu_torch.ops.quantize import QuantizedContext
from healnet_tpu_torch.train.loop import SurvivalTrainer

from portbench import HERE, load_file
from portbench.traffic import ArenaSplit, StepFeed, class_weights


def build_module(cfg: dict, device) -> torch.nn.Module:
    builder = load_file(HERE / "models" / f"{cfg['model']}.py", f"portbench_model_{cfg['model']}")
    return builder.build(cfg, device)


def twin(module: torch.nn.Module, cfg: dict, device) -> torch.nn.Module:
    """A new module holding ``module``'s weights: its parameters have not
    been through the trainer's captured steps (whose autograd streams they
    keep), so a measurement can capture them on a stream of its own."""
    copy = build_module(cfg, device)
    copy.load_state_dict(module.state_dict())
    return copy


def build_trainer(module: torch.nn.Module, cfg: dict, mix: dict, cohort, device) -> SurvivalTrainer:
    """The trainer in the mix's mode (``trainer``: ``fused_epochs``, the
    ``arena``, ``"int8"`` on the device or ``"none"``, and ``prefetch``),
    with the config's loss and schedule; no checkpoints."""
    mode = mix["trainer"]
    arena = QuantizedContext(*cohort.arena) if mode["arena"] == "int8" else None
    return SurvivalTrainer(
        module, loss_type=cfg["loss"], l1=cfg["l1"], gc_compat=cfg["gc_compat"],
        batch_size=mix["batch_size"], epochs=mix["epochs"], max_lr=cfg["max_lr"],
        early_stopping=False, eval_interval=mix["eval_interval"], reg_topo="healnet",
        sources=["omic", "slides"], device=device, feature_arena=arena,
        arena_quant=arena is not None, arena_device=arena,
        bucket_boundaries=mix["bucket_boundaries"], fused_epochs=bool(mode["fused_epochs"]),
        prefetch=int(mode["prefetch"]))


def draw_weights(module: torch.nn.Module, seed: int, device) -> Dict[str, torch.Tensor]:
    """Initial weights drawn on the device from ``seed`` in two calls: the
    latents N(0, 1); a matrix and its bias U(+-1/sqrt(fan_in)); LayerNorm
    scales 1 + U(+-0.1) and shifts U(+-0.1)."""
    named = dict(module.named_parameters())
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.rand(sum(p.numel() for p in named.values()), generator=gen,
                      device=device) * 2.0 - 1.0
    out, at = {}, 0
    for name, p in named.items():
        u = flat[at:at + p.numel()].view(p.shape)
        at += p.numel()
        matrix = named.get(name[:-len("bias")] + "weight") if name.endswith(".bias") else p
        if name == "latents":
            out[name] = torch.randn(p.shape, generator=gen, device=device)
        elif matrix is not None and matrix.dim() == 2:
            out[name] = u / math.sqrt(matrix.shape[1])
        else:
            out[name] = (1.0 if name.endswith("weight") else 0.0) + 0.1 * u
    return out


class StateTap:
    """A tracker that keeps the weights after each epoch and, after the
    first, the gradient the optimizer took: its first moment over (1 -
    beta1)."""

    def __init__(self, trainer: SurvivalTrainer):
        self.trainer, self.params, self.grad1 = trainer, {}, None

    def log(self, metrics, step=None):
        pass

    def watch(self, params=None, grad_stats=None, step=None, prefix=""):
        self.params[step] = {k: np.array(v, np.float32, copy=True) for k, v in params.items()}
        if step == 1:
            opt = self.trainer.optimizer
            b1 = float(opt.param_groups[0]["betas"][0])
            self.grad1 = {k: (opt.state[p]["exp_avg"].float() / (1.0 - b1)).cpu().numpy()
                          for k, p in self.trainer.module.named_parameters()}


def check_steps(trainer: SurvivalTrainer, case) -> dict:
    """The program's side of the check (:class:`portbench.check.Case`): from
    ``case.w0``, one fold of one step an epoch over ``case.batches`` through
    ``fit``, validating on ``case.val`` after the epochs
    ``case.eval_epochs`` names; its losses, validation losses, first
    gradient and the weights after the last step, on the host."""
    trainer.set_fold(seed=case.seed, class_weights=case.cw)
    trainer.module.load_state_dict(case.w0)
    tap = StateTap(trainer)
    saved = trainer.tracker, trainer.epochs, trainer.eval_interval
    trainer.tracker, trainer.epochs = tap, len(case.batches)
    trainer.eval_interval = case.eval_every
    try:
        hist = trainer.fit(StepFeed(case.batches), case.val, fold=1, verbose=False)["history"]
    finally:
        trainer.tracker, trainer.epochs, trainer.eval_interval = saved
    return {"loss": [h["train_loss"] for h in hist],
            "val_loss": [hist[e - 1]["val_loss"] for e in case.eval_epochs],
            "grad1": tap.grad1, "params": tap.params[len(case.batches)]}


def run_fold(trainer: SurvivalTrainer, cohort, split, fold: int, seed: int, n_bins: int) -> dict:
    """One fold of the k-fold loop: fresh weights and optimizer from
    ``seed``, then ``fit`` on the split's train and validation patients."""
    train_idx, _, val_idx = split
    trainer.set_fold(seed=seed, class_weights=class_weights(cohort.y_disc[train_idx], n_bins))
    res = trainer.fit(ArenaSplit(cohort, train_idx), ArenaSplit(cohort, val_idx), fold=fold,
                      verbose=False)
    losses = [h["train_loss"] for h in res["history"]]
    return {"epochs": len(losses), "nonfinite": int(sum(not np.isfinite(x) for x in losses)),
            "epoch_s": [h["seconds"] for h in res["history"]]}
