"""Survival losses: discrete-time NLL, CE-survival, Cox PH.

Counterpart of ``healnet_tpu/train/losses.py``: the same formulas, clips
and reductions, in PyTorch, differentiable by autograd.
"""

from __future__ import annotations

from typing import Mapping, Optional, Tuple

import torch


def survival_product(one_minus_hazards: torch.Tensor) -> torch.Tensor:
    """``cumprod`` over the bins (dim 1), as a chain of products in bin
    order: the same values, and a gradient that reads nothing on the host
    (``torch.cumprod``'s backward reads whether its input holds a zero,
    which a captured step cannot do)."""
    cols = [one_minus_hazards[:, 0]]
    for j in range(1, one_minus_hazards.shape[1]):
        cols.append(cols[-1] * one_minus_hazards[:, j])
    return torch.stack(cols, dim=1)


def hazards_survival_risk(logits: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """hazards = sigmoid(logits); survival = cumprod(1 - h); risk = -sum(S)."""
    hazards = torch.sigmoid(logits)
    survival = survival_product(1.0 - hazards)
    risk = -torch.sum(survival, dim=1)
    return hazards, survival, risk


def _gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Row-wise gather: x (b, k), idx (b, 1) -> (b, 1)."""
    return torch.gather(x, 1, idx)


def _labels(hazards, y_disc, censorship):
    b = hazards.shape[0]
    y = y_disc.reshape(b, 1).to(device=hazards.device, dtype=torch.int64)
    c = censorship.reshape(b, 1).to(device=hazards.device, dtype=hazards.dtype)
    return y, c


def _padded_survival(survival, c):
    return torch.cat([torch.ones_like(c), survival], dim=1)


def _reduce_mean(per_sample: torch.Tensor, sample_weights: Optional[torch.Tensor]) -> torch.Tensor:
    """Mean over the batch, or over the rows with ``sample_weights`` > 0
    (the padded rows of a static batch weigh 0)."""
    if sample_weights is None:
        return torch.mean(per_sample)
    w = sample_weights.to(per_sample.device).reshape(
        per_sample.shape[0], *([1] * (per_sample.ndim - 1)))
    return torch.sum(per_sample * w) / torch.clamp(torch.sum(w), min=1.0)


def nll_loss(
    hazards: torch.Tensor,
    survival: Optional[torch.Tensor],
    y_disc: torch.Tensor,
    censorship: torch.Tensor,
    weights: Optional[torch.Tensor] = None,
    alpha: float = 0.4,
    eps: float = 1e-7,
    sample_weights: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Discrete-time survival NLL with censoring, optional class weights
    (normalised here) and the alpha blend with the uncensored term."""
    y, c = _labels(hazards, y_disc, censorship)
    if survival is None:
        survival = survival_product(1.0 - hazards)
    s_padded = _padded_survival(survival, c)

    uncensored = -(1.0 - c) * (
        torch.log(torch.clamp(_gather(s_padded, y), min=eps))
        + torch.log(torch.clamp(_gather(hazards, y), min=eps))
    )
    censored = -c * torch.log(torch.clamp(_gather(s_padded, y + 1), min=eps))
    neg_l = censored + uncensored
    if weights is not None:
        w = weights.to(hazards.device) / torch.sum(weights)
        neg_l = neg_l * _gather(w.reshape(1, -1).expand(hazards.shape), y)

    loss = (1.0 - alpha) * neg_l + alpha * uncensored
    return _reduce_mean(loss, sample_weights)


def nll_loss_from_logits(
    logits: torch.Tensor,
    y_disc: torch.Tensor,
    censorship: torch.Tensor,
    alpha: float = 0.0,
    eps: float = 1e-7,
    reduction: str = "mean",
) -> torch.Tensor:
    """Zadeh & Schmid (2020) discrete NLL from raw logits."""
    y, c = _labels(logits, y_disc, censorship)
    hazards = torch.sigmoid(logits)
    survival = survival_product(1.0 - hazards)
    s_padded = _padded_survival(survival, c)

    s_prev = torch.clamp(_gather(s_padded, y), min=eps)
    h_this = torch.clamp(_gather(hazards, y), min=eps)
    s_this = torch.clamp(_gather(s_padded, y + 1), min=eps)

    uncensored = -(1.0 - c) * (torch.log(s_prev) + torch.log(h_this))
    censored = -c * torch.log(s_this)
    loss = (1.0 - alpha) * (censored + uncensored) + alpha * uncensored
    if reduction == "mean":
        return torch.mean(loss)
    if reduction == "sum":
        return torch.sum(loss)
    raise ValueError(f"Bad input for reduction: {reduction}")


def ce_loss(
    hazards: torch.Tensor,
    survival: Optional[torch.Tensor],
    y_disc: torch.Tensor,
    censorship: torch.Tensor,
    alpha: float = 0.4,
    eps: float = 1e-7,
    sample_weights: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Cross-entropy survival loss."""
    y, c = _labels(hazards, y_disc, censorship)
    if survival is None:
        survival = survival_product(1.0 - hazards)
    s_padded = _padded_survival(survival, c)

    # the first log adds eps (no clamp), as the reference does
    reg = -(1.0 - c) * (
        torch.log(_gather(s_padded, y) + eps)
        + torch.log(torch.clamp(_gather(hazards, y), min=eps))
    )
    # two-sided clip: s_y == 1 would make log(1 - s_y) = -inf
    s_y = torch.clamp(_gather(survival, y), min=eps, max=1.0 - eps)
    ce_l = -c * torch.log(s_y) - (1.0 - c) * torch.log(1.0 - s_y)
    loss = (1.0 - alpha) * ce_l + alpha * reg
    return _reduce_mean(loss, sample_weights)


class CrossEntropySurvLoss:
    """Callable wrapper of :func:`ce_loss` with a default alpha."""

    def __init__(self, alpha: float = 0.15):
        self.alpha = alpha

    def __call__(self, hazards, survival, y_disc, censorship, alpha=None):
        a = self.alpha if alpha is None else alpha
        return ce_loss(hazards, survival, y_disc, censorship, alpha=a)


def cox_ph_loss(
    risk_scores: torch.Tensor,
    order_values: torch.Tensor,
    censorship: torch.Tensor,
    sample_weights: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Cox proportional-hazards partial likelihood, normalised by the event
    count: risk set ``R_i = {j : order_values[j] >= order_values[i]}`` as
    one broadcast comparison, the normaliser a masked log-sum-exp."""
    theta = risk_scores.reshape(-1)
    ov = order_values.reshape(-1).to(theta.device)
    events = (1.0 - censorship.reshape(-1).to(theta.device)).to(theta.dtype)

    in_risk_set = ov[None, :] >= ov[:, None]  # (b, b): j in R_i
    if sample_weights is not None:
        sw = sample_weights.to(theta.device)
        in_risk_set = in_risk_set & (sw[None, :] > 0)
        events = events * sw

    neg_inf = torch.finfo(theta.dtype).min / 2
    masked_theta = torch.where(in_risk_set, theta[None, :], torch.full_like(theta, neg_inf)[None, :])
    log_denom = torch.logsumexp(masked_theta, dim=1)
    per_sample = -(theta - log_denom) * events
    return torch.sum(per_sample) / torch.clamp(torch.sum(events), min=1.0)


class CoxPHSurvLoss:
    """Cox loss on survival outputs: ``theta = -sum(survival)``, risk sets
    ordered by ``event_time`` when given, else by total survival."""

    def __call__(self, hazards, survival, censorship, event_time=None,
                 sample_weights=None, **_):
        total_survival = torch.sum(survival, dim=1)
        theta = -total_survival
        order_values = event_time if event_time is not None else total_survival
        return cox_ph_loss(theta, order_values, censorship, sample_weights=sample_weights)


def survival_loss(
    logits: torch.Tensor,
    batch: Mapping,
    loss_type: str = "nll",
    alpha: float = 0.4,
    class_weights: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The train loops' loss switch: ``(scalar loss, per-sample risk)``.

    batch: "y_disc", "censorship", "event_time" and optional "sample_mask"
    (the padded-row mask), as tensors.
    """
    hazards, survival, risk = hazards_survival_risk(logits)
    sw = batch.get("sample_mask")
    if loss_type == "nll":
        loss = nll_loss(hazards, survival, batch["y_disc"], batch["censorship"],
                        weights=class_weights, alpha=alpha, sample_weights=sw)
    elif loss_type == "ce_survival":
        loss = ce_loss(hazards, survival, batch["y_disc"], batch["censorship"],
                       alpha=0.15, sample_weights=sw)
    elif loss_type == "cox":
        loss = cox_ph_loss(risk, batch["event_time"], batch["censorship"], sample_weights=sw)
    else:
        raise ValueError(f"unknown loss_type {loss_type}")
    return loss, risk
