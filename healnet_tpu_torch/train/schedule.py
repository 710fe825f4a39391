"""Optimiser and OneCycle schedule.

Counterpart of ``healnet_tpu/train/schedule.py``: Adam whose learning rate
and beta1 follow torch's OneCycleLR shapes (cosine, ``pct_start`` 0.3,
``div_factor`` 25, ``final_div_factor`` 1e4, beta1 cycling 0.95 -> 0.85 ->
0.95), as step-indexed schedules over a fixed horizon (:func:`onecycle_lr`,
:func:`onecycle_beta1`, with their short-run floor) and as functions of the
progress fraction ``step / horizon`` (:func:`onecycle_lr_at`,
:func:`onecycle_beta1_at`). The trainer writes the latter into the
optimizer before each update (:func:`progress_hyperparams`), from the
optimizer's step count on the device, so nothing of an update is read on
the host and a captured step replays with the schedule moving.

:class:`Adam` is optax's Adam (``eps`` outside the square root, bias
correction with the beta1 of the current step) over multi-tensor ops, its
lr, beta1 and step count held as device tensors, one code path on the CPU
and the card; the tests hold it against optax and ``torch.optim.Adam``.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, Optional, Union

import numpy as np
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


def _floored(total_steps: int, pct_start: float) -> int:
    """The step-indexed schedules' horizon, floored at ``ceil(1 / pct_start)
    + 1`` so that every interval of a short run is non-empty."""
    return max(int(total_steps), int(np.ceil(1.0 / pct_start)) + 1)


def onecycle_lr(
    max_lr: float,
    total_steps: int,
    pct_start: float = 0.3,
    div_factor: float = 25.0,
    final_div_factor: float = 1e4,
) -> Callable:
    """Step-indexed OneCycle LR (optax's ``cosine_onecycle_schedule``): a
    function of the step count (an int or a tensor, on any device) giving
    float32 values: cosine from ``max_lr / div_factor`` up to ``max_lr``
    over ``int(pct_start * T)`` steps, then down to the initial value over
    ``final_div_factor`` until step T, where it holds. T is the floored
    horizon."""
    total = _floored(total_steps, pct_start)
    bounds = (0, int(pct_start * total), total)
    values = np.cumprod([max_lr / div_factor, div_factor, 1.0 / (div_factor * final_div_factor)])

    def schedule(step) -> torch.Tensor:
        count = torch.as_tensor(step).to(torch.float32)
        out = torch.zeros_like(count) + float(values[-1]) * (count >= bounds[-1])
        for i in range(2):
            lo, hi, start, end = bounds[i], bounds[i + 1], float(values[i]), float(values[i + 1])
            pct = (count - lo) / float(hi - lo)
            interp = end + (start - end) / 2.0 * (torch.cos(math.pi * pct) + 1.0)
            out = out + torch.where((count >= lo) & (count < hi), interp, torch.zeros_like(interp))
        return out

    return schedule


def onecycle_beta1(
    total_steps: int,
    pct_start: float = 0.3,
    max_momentum: float = 0.95,
    base_momentum: float = 0.85,
) -> Callable:
    """Step-indexed OneCycle beta1: :func:`onecycle_beta1_at` at ``step /
    T`` with the warm-up ending at ``max(int(pct_start * T), 1) / T``, T
    the floored horizon of :func:`onecycle_lr`, so both move over the same
    phases."""
    total = _floored(total_steps, pct_start)
    warmup = max(int(pct_start * total), 1)

    def schedule(step) -> torch.Tensor:
        frac = torch.as_tensor(step).to(torch.float32) / float(total)
        return onecycle_beta1_at(frac, pct_start=warmup / total, max_momentum=max_momentum,
                                 base_momentum=base_momentum)

    return schedule


def progress_schedule(
    count: torch.Tensor,
    horizon: Union[int, float, torch.Tensor],
    max_lr: float,
    pct_start: float = 0.3,
):
    """``(lr, beta1)`` as float32 tensors on ``count``'s device for the update
    about to be taken: ``count`` the updates taken so far (a device tensor),
    ``horizon`` the schedule's length in steps (a number, or a tensor on that
    device), floored at ``ceil(1/pct_start) + 1`` as the JAX package does,
    so a short run's first step stays in the warm-up phase. Nothing is read
    on the host."""
    floor = float(int(math.ceil(1.0 / pct_start)) + 1)
    if isinstance(horizon, torch.Tensor):
        denominator = torch.clamp(horizon.to(torch.float32), min=floor)
    else:
        denominator = max(float(horizon), floor)
    frac = count.to(torch.float32) / denominator
    return onecycle_lr_at(frac, max_lr, pct_start=pct_start), onecycle_beta1_at(
        frac, pct_start=pct_start)


def _step_tensor(optimizer: torch.optim.Optimizer) -> torch.Tensor:
    """The optimizer's update count as a tensor (its first parameter's
    ``step`` state, else :class:`Adam`'s count, else a zero)."""
    for group in optimizer.param_groups:
        for p in group["params"]:
            state = optimizer.state.get(p)
            if state and "step" in state:
                return state["step"]
    return getattr(optimizer, "count", torch.zeros(()))


def optimizer_step_count(optimizer: torch.optim.Optimizer) -> int:
    """Updates the optimizer has taken (0 before the first); a host read."""
    return int(_step_tensor(optimizer))


def progress_hyperparams(
    optimizer: torch.optim.Optimizer,
    horizon: Union[int, float, torch.Tensor],
    max_lr: float,
    cycle_momentum: bool = True,
    pct_start: float = 0.3,
) -> None:
    """Write lr (and beta1 when cycling) for the update about to be taken
    into an :class:`Adam`'s device tensors, from its step count on the
    device (:func:`progress_schedule`); no host read, so it may be captured."""
    lr, beta1 = progress_schedule(_step_tensor(optimizer), horizon, max_lr, pct_start)
    optimizer.lr.copy_(lr)
    if cycle_momentum:
        optimizer.beta1.copy_(beta1)


class Adam(torch.optim.Optimizer):
    """Adam with optax's update over multi-tensor ops, for the trainer.

    The learning rate and beta1 are 0-d float32 tensors on the parameters'
    device (``lr``, ``beta1``; also the first group's ``lr`` and
    ``betas[0]``), written before each update by :func:`progress_hyperparams`;
    the update count is one such tensor (``count``, each parameter's
    ``step`` state). An update reads nothing on the host, so it can be
    captured in a CUDA graph and replayed with the schedule moving, and the
    CPU runs the same code. The state dict has ``torch.optim.Adam``'s
    layout, and either loads into the other.
    """

    def __init__(self, params, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0):
        super().__init__(params, dict(lr=0.0, betas=tuple(betas), eps=eps,
                                      weight_decay=weight_decay))
        device = self.param_groups[0]["params"][0].device
        self.lr = torch.zeros((), dtype=torch.float32, device=device)
        self.beta1 = torch.full((), float(betas[0]), dtype=torch.float32, device=device)
        self.count = torch.zeros((), dtype=torch.float32, device=device)
        self._bind()

    def _bind(self) -> None:
        """Point every group's lr and beta1 at the device tensors, and every
        parameter's ``step`` state at the count."""
        for group in self.param_groups:
            group["lr"], group["betas"] = self.lr, (self.beta1, float(group["betas"][1]))
        for state in self.state.values():
            if "step" in state:
                state["step"] = self.count

    def load_state_dict(self, state_dict) -> None:
        """Load a state dict of this class or of ``torch.optim.Adam``: the
        values are copied into the device tensors the updates read."""
        super().load_state_dict(state_dict)
        group = self.param_groups[0]
        with torch.no_grad():
            self.lr.copy_(torch.as_tensor(group["lr"], dtype=torch.float32))
            self.beta1.copy_(torch.as_tensor(group["betas"][0], dtype=torch.float32))
            steps = [s["step"] for s in self.state.values() if "step" in s]
            self.count.copy_(torch.as_tensor(steps[0] if steps else 0.0, dtype=torch.float32))
        self._bind()

    @torch.no_grad()
    def reset_(self) -> None:
        """Back to a new optimizer's state in place: every moment, the
        count and lr zero, beta1 its initial value. Each state tensor keeps
        its address, so a captured update replays from the new state; a
        zero moment takes the first update a new optimizer's does."""
        moments = [state[key] for state in self.state.values()
                   for key in ("exp_avg", "exp_avg_sq") if key in state]
        if moments:
            torch._foreach_zero_(moments)
        self.count.zero_()
        self.lr.zero_()
        self.beta1.fill_(float(self.defaults["betas"][0]))

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("Adam takes no closure")
        self.count.add_(1.0)
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            grads = [p.grad for p in params]
            if group["weight_decay"]:
                grads = torch._foreach_add(grads, params, alpha=group["weight_decay"])
            for p in params:
                state = self.state[p]
                if not state:
                    state["step"] = self.count
                    state["exp_avg"] = torch.zeros_like(p, memory_format=torch.preserve_format)
                    state["exp_avg_sq"] = torch.zeros_like(p,
                                                           memory_format=torch.preserve_format)
            exp_avgs = [self.state[p]["exp_avg"] for p in params]
            exp_avg_sqs = [self.state[p]["exp_avg_sq"] for p in params]
            b1, b2 = self.beta1, float(group["betas"][1])
            # mu = b1 mu + (1 - b1) g; nu = b2 nu + (1 - b2) g^2
            torch._foreach_mul_(exp_avgs, b1)
            torch._foreach_add_(exp_avgs, torch._foreach_mul(grads, 1.0 - b1))
            torch._foreach_mul_(exp_avg_sqs, b2)
            torch._foreach_addcmul_(exp_avg_sqs, grads, grads, value=1.0 - b2)
            # p -= lr / (1 - b1^t) * mu / (sqrt(nu) / sqrt(1 - b2^t) + eps)
            step_size = self.lr / (1.0 - torch.pow(b1, self.count))
            denom = torch._foreach_sqrt(exp_avg_sqs)
            torch._foreach_div_(denom, torch.sqrt(1.0 - torch.pow(b2, self.count)))
            torch._foreach_add_(denom, group["eps"])
            torch._foreach_div_(denom, -step_size)
            torch._foreach_addcdiv_(params, exp_avgs, denom)
        return None


def make_optimizer(
    params: Iterable[torch.nn.Parameter],
    cycle_momentum: bool = True,
    weight_decay: Optional[Union[float, str]] = None,
) -> Adam:
    """:class:`Adam` (beta2 0.999, eps 1e-8) whose lr and beta1 are set
    before each update by :func:`progress_hyperparams`. ``weight_decay`` is
    added to the gradient (optax's ``add_decayed_weights`` before Adam);
    configs may give it as a string, ``"None"`` meaning none."""
    if isinstance(weight_decay, str):
        weight_decay = None if weight_decay.lower() in ("none", "null", "") else float(weight_decay)
    b1 = 0.95 if cycle_momentum else 0.9
    return Adam(params, betas=(b1, 0.999), eps=1e-8, weight_decay=float(weight_decay or 0.0))
