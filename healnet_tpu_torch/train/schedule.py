"""Optimiser and OneCycle schedule.

Counterpart of ``healnet_tpu/train/schedule.py``'s horizon-free schedules:
Adam whose learning rate and beta1 follow torch's OneCycleLR shapes
(cosine, ``pct_start`` 0.3, ``div_factor`` 25, ``final_div_factor`` 1e4,
beta1 cycling 0.95 -> 0.85 -> 0.95) as functions of the progress fraction
``step / horizon``. The trainer writes them into the optimizer before each
update (:func:`progress_hyperparams`).

optax's Adam (``eps`` outside the square root, bias correction with the
beta1 of the current step) is the same update as ``torch.optim.Adam``; the
tests hold the two against each other.
"""

from __future__ import annotations

import math
from typing import Iterable, Optional, Union

import torch


def _frac(frac) -> torch.Tensor:
    return torch.clamp(torch.as_tensor(frac, dtype=torch.float32), 0.0, 1.0)


def _phases(frac: torch.Tensor, pct_start: float):
    t1 = torch.clamp(frac / pct_start, 0.0, 1.0)
    t2 = torch.clamp((frac - pct_start) / max(1.0 - pct_start, 1e-9), 0.0, 1.0)
    return t1, t2


def onecycle_lr_at(
    frac,
    max_lr: float,
    pct_start: float = 0.3,
    div_factor: float = 25.0,
    final_div_factor: float = 1e4,
) -> torch.Tensor:
    """OneCycle LR at progress fraction ``frac`` (clipped to [0, 1]), in
    float32 as the JAX package computes it."""
    frac = _frac(frac)
    init = max_lr / div_factor
    final = init / final_div_factor
    t1, t2 = _phases(frac, pct_start)
    up = init + (max_lr - init) * 0.5 * (1.0 - torch.cos(math.pi * t1))
    down = max_lr + (final - max_lr) * 0.5 * (1.0 - torch.cos(math.pi * t2))
    return torch.where(frac < pct_start, up, down)


def onecycle_beta1_at(
    frac,
    pct_start: float = 0.3,
    max_momentum: float = 0.95,
    base_momentum: float = 0.85,
) -> torch.Tensor:
    """OneCycle beta1 cycling at progress fraction ``frac``."""
    frac = _frac(frac)
    t1, t2 = _phases(frac, pct_start)
    phase1 = max_momentum + (base_momentum - max_momentum) * 0.5 * (1.0 - torch.cos(math.pi * t1))
    phase2 = base_momentum + (max_momentum - base_momentum) * 0.5 * (1.0 - torch.cos(math.pi * t2))
    return torch.where(frac < pct_start, phase1, phase2)


def optimizer_step_count(optimizer: torch.optim.Optimizer) -> int:
    """Updates the optimizer has taken (0 before the first)."""
    for group in optimizer.param_groups:
        for p in group["params"]:
            state = optimizer.state.get(p)
            if state and "step" in state:
                return int(state["step"])
    return 0


def progress_hyperparams(
    optimizer: torch.optim.Optimizer,
    horizon: Union[int, float],
    max_lr: float,
    cycle_momentum: bool = True,
    pct_start: float = 0.3,
) -> None:
    """Write lr (and beta1 when cycling) for the update about to be taken.

    The step index is the optimizer's count before the update; horizons
    below ``ceil(1/pct_start) + 1`` are floored there, as the JAX package
    does, so a short run's first step stays in the warm-up phase.
    """
    floor = float(int(math.ceil(1.0 / pct_start)) + 1)
    count = torch.tensor(optimizer_step_count(optimizer), dtype=torch.float32)
    frac = count / max(float(horizon), floor)
    lr = float(onecycle_lr_at(frac, max_lr, pct_start=pct_start))
    beta1 = float(onecycle_beta1_at(frac, pct_start=pct_start)) if cycle_momentum else None
    for group in optimizer.param_groups:
        group["lr"] = lr
        if beta1 is not None:
            group["betas"] = (beta1, group["betas"][1])


def make_optimizer(
    params: Iterable[torch.nn.Parameter],
    cycle_momentum: bool = True,
    weight_decay: Optional[Union[float, str]] = None,
) -> torch.optim.Adam:
    """Adam (beta2 0.999, eps 1e-8) whose lr and beta1 are set before each
    update by :func:`progress_hyperparams`. ``weight_decay`` is added to the
    gradient (optax's ``add_decayed_weights`` before Adam); configs may give
    it as a string, ``"None"`` meaning none."""
    if isinstance(weight_decay, str):
        weight_decay = None if weight_decay.lower() in ("none", "null", "") else float(weight_decay)
    b1 = 0.95 if cycle_momentum else 0.9
    return torch.optim.Adam(params, lr=0.0, betas=(b1, 0.999), eps=1e-8,
                            weight_decay=float(weight_decay or 0.0))
