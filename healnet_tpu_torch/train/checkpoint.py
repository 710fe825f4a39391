"""Durable checkpoints of the training state, as torch files.

Counterpart of ``healnet_tpu/train/checkpoint.py::Checkpointer`` (Orbax
there): one file a step (``step_00000003.pt``: the model's ``state_dict``
and the optimizer's, Adam's step counts and moments included), a
``latest.json`` beside them naming the newest step and its metrics, and a
``best.pt`` / ``best.json`` pair for the weights a trainer keeps. Saves go
to a temporary file renamed into place, so a crash mid-save leaves the
previous checkpoints whole; leftovers of such a crash are not counted as
steps. ``keep_last`` prunes all but the newest steps, as JAX's does.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Any, Dict, Optional, Union

import torch


class Checkpointer:
    """Save and restore the training state under a run directory."""

    def __init__(self, directory: Union[str, Path]):
        self.directory = Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)

    def step_path(self, step: int) -> Path:
        """The file of a saved step."""
        return self.directory / f"step_{step:08d}.pt"

    def _step_numbers(self) -> list:
        """Sorted step numbers of finished step files."""
        steps = []
        for p in self.directory.glob("step_*.pt"):
            digits = p.name[len("step_"):-len(".pt")]
            if digits.isdigit():
                steps.append(int(digits))
        return sorted(steps)

    @staticmethod
    def _write(obj: Any, path: Path) -> None:
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        torch.save(obj, tmp)
        os.replace(tmp, path)

    @staticmethod
    def _write_json(obj: Dict[str, Any], path: Path) -> None:
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        tmp.write_text(json.dumps(obj, default=str))
        os.replace(tmp, path)

    def save(
        self,
        step: int,
        params: Dict[str, torch.Tensor],
        opt_state: Optional[Dict[str, Any]] = None,
        metrics: Optional[Dict[str, Any]] = None,
        keep_tag: str = "latest",
        keep_last: Optional[int] = None,
    ) -> Path:
        """Save ``params`` (a ``state_dict``) and ``opt_state`` (an
        optimizer's ``state_dict``) as step ``step``; with ``keep_last``,
        delete all but the newest ``keep_last`` steps."""
        path = self.step_path(step)
        state = {"params": params}
        if opt_state is not None:
            state["opt_state"] = opt_state
        self._write(state, path)
        self._write_json({"step": step, "metrics": metrics or {}},
                         self.directory / f"{keep_tag}.json")
        if keep_last is not None and keep_last > 0:
            for old in self._step_numbers()[:-keep_last]:
                self.step_path(old).unlink(missing_ok=True)
        return path

    def save_best(self, params: Dict[str, torch.Tensor],
                  metrics: Optional[Dict[str, Any]] = None) -> Path:
        path = self.directory / "best.pt"
        self._write({"params": params}, path)
        self._write_json({"metrics": metrics or {}}, self.directory / "best.json")
        return path

    def restore(self, step: Optional[int] = None, tag: str = "latest",
                map_location: Any = "cpu") -> Dict[str, Any]:
        """``{"params", "opt_state" (if saved), "step"}`` of ``step`` (default:
        the one ``tag``'s json names), tensors on ``map_location``."""
        if step is None:
            step = json.loads((self.directory / f"{tag}.json").read_text())["step"]
        restored = torch.load(self.step_path(step), map_location=map_location,
                              weights_only=True)
        restored["step"] = step
        return restored

    def restore_best(self, map_location: Any = "cpu") -> Dict[str, torch.Tensor]:
        return torch.load(self.directory / "best.pt", map_location=map_location,
                          weights_only=True)["params"]

    def latest_step(self) -> Optional[int]:
        steps = self._step_numbers()
        return steps[-1] if steps else None
