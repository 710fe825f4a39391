"""Training utilities: L1 regularisation, early stopping, parameter
counting, and the probes of a module's ``forward`` signature.

Counterpart of ``healnet_tpu/utils/train_utils.py``. Parameters are given
as a module, a mapping of name -> tensor, or an iterable of tensors.
"""

from __future__ import annotations

import functools
import inspect
import math
from typing import Any, Dict, List, Optional

import torch


def forward_keywords(module) -> frozenset:
    """The parameter names of the module's ``forward``: the trainer passes
    ``kv_masks``, ``generator``, ``seed_generator`` and ``seeds`` only to a
    module that takes them."""
    fn = getattr(type(module), "forward", None) or type(module).__call__
    return frozenset(inspect.signature(fn).parameters)


def accepts_kv_masks(module) -> bool:
    """True when the module's forward takes a ``kv_masks`` keyword.

    HealNet-family modules mask ragged padded contexts; modules that pool
    zero-padded tokens without masks do not take one. Shared by the trainer
    and the serving Predictor so both gate the same way.
    """
    try:
        return "kv_masks" in forward_keywords(module)
    except (TypeError, ValueError):
        return True


def _leaves(params) -> List[torch.Tensor]:
    if isinstance(params, torch.nn.Module):
        return list(params.parameters())
    if isinstance(params, dict):
        return list(params.values())
    return list(params)


def _abs(x: torch.Tensor) -> torch.Tensor:
    """|x| whose gradient at 0 is +1, as JAX's (torch's ``abs`` gives 0
    there, which would leave zero-initialised biases out of the L1 step)."""
    return torch.where(x >= 0, x, -x)


def l1_norm(params, flat: bool = True) -> torch.Tensor:
    """Sum of absolute values over every parameter.

    ``flat`` takes it as one sum over the concatenated values, promoted to
    the widest dtype among them (never narrowed); otherwise one sum per
    tensor, added. The gradient is the same either way; only the value's
    last bits differ with the summation order.
    """
    leaves = _leaves(params)
    if not leaves:
        return torch.tensor(0.0)
    if flat and len(leaves) > 1:
        dtype = functools.reduce(torch.promote_types, (p.dtype for p in leaves))
        return torch.sum(_abs(torch.cat([p.reshape(-1).to(dtype) for p in leaves])))
    return sum(torch.sum(_abs(p)) for p in leaves)


def calc_reg_loss(params, l1: float, model_topo: str, sources: Optional[List[str]] = None):
    """L1 penalty, skipped for ``fcnn`` and for omic-only ``mcat``."""
    if model_topo == "fcnn" or (model_topo == "mcat" and sources == ["omic"]):
        return torch.tensor(0.0)
    return float(l1) * l1_norm(params)


def count_parameters(params) -> int:
    return sum(int(p.numel()) for p in _leaves(params))


class EarlyStopping:
    """Early stopping on a validation metric, keeping a copy of the best
    parameters (a state dict, cloned)."""

    def __init__(self, patience: int = 5, verbose: bool = False, mode: str = "min"):
        if mode not in ("min", "max"):
            raise ValueError("Mode must be 'min' or 'max'")
        self.patience = patience
        self.verbose = verbose
        self.mode = mode
        self.counter = 0
        self.best_metric = math.inf if mode == "min" else -math.inf
        self.best_params: Optional[Dict[str, Any]] = None
        self.should_stop = False

    def _improved(self, metric: float) -> bool:
        return metric < self.best_metric if self.mode == "min" else metric > self.best_metric

    def step(self, metric: float, params) -> bool:
        """Record a new metric; returns True once patience is exhausted.
        ``params``: a module or a mapping of name -> tensor."""
        metric = float(metric)
        if self._improved(metric):
            if self.verbose:
                print(f"Validation metric improved from {self.best_metric:.4f} to "
                      f"{metric:.4f}. Capturing parameters.")
            self.best_metric = metric
            self.counter = 0
            state = params.state_dict() if isinstance(params, torch.nn.Module) else params
            # a copy: the optimizer updates the live tensors in place
            self.best_params = {k: v.detach().clone() for k, v in state.items()}
        else:
            self.counter += 1
            if self.verbose:
                print(f"Validation metric did not improve. "
                      f"Patience: {self.counter}/{self.patience}.")
            if self.counter >= self.patience:
                self.should_stop = True
        return self.should_stop

    def load_best_weights(self, fallback: Any = None) -> Any:
        if self.best_params is None:
            return fallback
        if self.verbose:
            print(f"Restoring best parameters (metric {self.best_metric:.4f}).")
        return self.best_params
