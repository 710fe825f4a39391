"""Experiment tracking: wandb when available, local JSONL otherwise.

Counterpart of ``healnet_tpu/utils/tracking.py``. ``Tracker`` forwards to
wandb if ``wandb`` is importable *and* the caller enables it; either way
metrics are appended to ``<log_dir>/<name>/metrics.jsonl`` and the run's
summary (the latest value of every metric) goes to ``summary.json`` on
``finish``, so sweeps and aggregation stay scriptable offline.
"""

from __future__ import annotations

import json
import time
import uuid
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

try:  # pragma: no cover - exercised only where wandb is installed
    import wandb as _wandb

    _WANDB_AVAILABLE = True
except Exception:  # pragma: no cover
    _wandb = None
    _WANDB_AVAILABLE = False


def wandb_available() -> bool:
    return _WANDB_AVAILABLE


class Tracker:
    """Minimal tracking facade with wandb-compatible surface."""

    def __init__(
        self,
        project: str = "healnet_tpu",
        name: Optional[str] = None,
        config: Optional[Dict[str, Any]] = None,
        log_dir: Optional[str] = None,
        use_wandb: bool = False,
    ):
        self.project = project
        self.name = name or f"run-{time.strftime('%Y%m%d-%H%M%S')}-{uuid.uuid4().hex[:6]}"
        self.config = dict(config or {})
        self.use_wandb = bool(use_wandb and _WANDB_AVAILABLE)
        self.summary: Dict[str, Any] = {}
        self._step = 0

        if self.use_wandb:  # pragma: no cover
            _wandb.init(project=project, name=name, config=self.config, resume=True)
            # a per-run subdirectory in wandb mode too, so runs never share
            # metrics.jsonl or summary.json
            self.log_dir = (
                Path(log_dir) / self.name if log_dir else Path(_wandb.run.dir)
            )
        else:
            base = Path(log_dir) if log_dir else Path("logs")
            self.log_dir = base / self.name
        self.log_dir.mkdir(parents=True, exist_ok=True)
        self._metrics_path = self.log_dir / "metrics.jsonl"

    def log(self, metrics: Dict[str, Any], step: Optional[int] = None) -> None:
        if self.use_wandb:  # pragma: no cover
            _wandb.log(metrics, step=step)
        step = self._step if step is None else step
        self._step = max(self._step, step) + 1
        record = {"step": int(step), "time": time.time()}
        record.update({k: _to_py(v) for k, v in metrics.items()})
        with open(self._metrics_path, "a") as f:
            f.write(json.dumps(record) + "\n")
        self.summary.update({k: _to_py(v) for k, v in metrics.items()})

    def watch(
        self,
        params: Optional[Dict[str, Any]] = None,
        grad_stats: Optional[Dict[str, Any]] = None,
        step: Optional[int] = None,
        prefix: str = "",
    ) -> None:
        """``wandb.watch`` parity: the global L2 norm of the parameters and
        one per top-level module, plus the trainer's gradient-norm stats.

        ``params`` is a ``state_dict`` (dotted names; the norms group by
        the name's first part, the module the JAX package's Flax tree keys
        by) or a nested mapping of arrays or tensors.
        """
        metrics: Dict[str, Any] = {}
        if params is not None:
            groups: Dict[str, list] = {}
            for key, value in params.items():
                groups.setdefault(str(key).split(".")[0], []).append(value)
            total_sq = 0.0
            for key, values in groups.items():
                sq = _tree_sq_norm(values)
                metrics[f"{prefix}param_norm/{key}"] = float(sq) ** 0.5
                total_sq += sq
            metrics[f"{prefix}param_norm/global"] = float(total_sq) ** 0.5
        if grad_stats:
            for key, value in grad_stats.items():
                metrics[f"{prefix}grad_norm/{key}"] = float(value)
        if metrics:
            self.log(metrics, step=step)

    def finish(self) -> None:
        if self.use_wandb:  # pragma: no cover
            _wandb.finish()
        with open(self.log_dir / "summary.json", "w") as f:
            json.dump(self.summary, f, indent=2, default=str)


def _tree_sq_norm(tree: Any) -> float:
    """Sum of squared entries over a nested dict / sequence of arrays or
    tensors, in float64."""
    if isinstance(tree, dict):
        return sum(_tree_sq_norm(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_tree_sq_norm(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        tree = tree.detach().to("cpu", torch.float64).numpy()
    arr = np.asarray(tree, dtype=np.float64)
    return float(np.vdot(arr, arr).real)


def _to_py(value: Any) -> Any:
    """Convert numpy scalars and one-element tensors to plain Python for JSON."""
    if hasattr(value, "item") and getattr(value, "ndim", 1) == 0:
        try:
            return value.item()
        except Exception:
            return str(value)
    if isinstance(value, (list, tuple)):
        return [_to_py(v) for v in value]
    return value
