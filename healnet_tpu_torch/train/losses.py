"""Survival head outputs.

Counterpart of ``healnet_tpu/train/losses.py::hazards_survival_risk``; the
losses themselves come with the training slice.
"""

from __future__ import annotations

from typing import Tuple

import torch


def hazards_survival_risk(logits: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """hazards = sigmoid(logits); survival = cumprod(1 - h); risk = -sum(S)."""
    hazards = torch.sigmoid(logits)
    survival = torch.cumprod(1.0 - hazards, dim=1)
    risk = -torch.sum(survival, dim=1)
    return hazards, survival, risk
