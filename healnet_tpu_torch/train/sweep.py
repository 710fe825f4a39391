"""Local hyperparameter sweep engine (wandb-sweep-schema compatible): the
port's counterpart of ``healnet_tpu/train/sweep.py``, numpy only.

It runs the wandb YAML sweep schema (``config/sweep_*.yaml``) locally, and
draws the same trials as the JAX package for the same seed:

- ``method: grid`` — full cartesian product over ``values`` lists;
- ``method: random`` — uniform / log-uniform / int / categorical draws;
- ``method: bayes`` — Gaussian-ish sequential model-based search: after a
  random warmup, candidates are scored by a k-nearest-neighbour surrogate
  over the normalised parameter space (expected improvement via best-of-k
  neighbours).

Trial parameters are applied onto the flattened config (dotted keys), the
objective (e.g. ``mean_test_c_index``) is read from the run's returned
metrics, and the full trial table is persisted as CSV (written with
:mod:`csv`, laid out as pandas' ``DataFrame(rows).to_csv(index=False)``).
"""

from __future__ import annotations

import csv
import itertools
import math
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from healnet_tpu_torch.etl.table import csv_cell


class SweepSpec:
    """Parsed wandb-style sweep config."""

    def __init__(self, spec: Dict[str, Any]):
        self.method = spec.get("method", "grid")
        metric = spec.get("metric", {}) or {}
        self.metric_name = metric.get("name", "mean_test_c_index")
        self.maximize = metric.get("goal", "maximize") == "maximize"
        self.parameters: Dict[str, Dict[str, Any]] = dict(spec.get("parameters", {}))
        self.early_terminate = spec.get("early_terminate")

    # -------------------------------------------------------------- sampling
    def grid(self) -> List[Dict[str, Any]]:
        keys, choices = [], []
        for key, p in self.parameters.items():
            if "values" in p:
                keys.append(key)
                choices.append(list(p["values"]))
            elif "value" in p:
                keys.append(key)
                choices.append([p["value"]])
            else:
                raise ValueError(f"grid sweeps need 'values' for parameter {key}")
        return [dict(zip(keys, combo)) for combo in itertools.product(*choices)]

    def sample(self, rng: np.random.Generator) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for key, p in self.parameters.items():
            out[key] = _sample_param(p, rng)
        return out

    def normalize(self, trial: Dict[str, Any]) -> np.ndarray:
        """Map a trial into [0, 1]^d for the surrogate distance metric."""
        coords = []
        for key, p in self.parameters.items():
            v = trial[key]
            if "values" in p:
                values = list(p["values"])
                coords.append(values.index(v) / max(len(values) - 1, 1))
            elif "min" in p and "max" in p:
                lo, hi = float(p["min"]), float(p["max"])
                if _is_log(p):
                    coords.append(
                        (math.log(v) - math.log(lo)) / (math.log(hi) - math.log(lo))
                    )
                else:
                    coords.append((float(v) - lo) / (hi - lo + 1e-12))
            else:
                coords.append(0.0)
        return np.asarray(coords)


def _is_log(p: Dict[str, Any]) -> bool:
    return "log" in str(p.get("distribution", ""))


def _sample_param(p: Dict[str, Any], rng: np.random.Generator):
    if "value" in p:
        return p["value"]
    if "values" in p:
        return p["values"][int(rng.integers(len(p["values"])))]
    lo, hi = p["min"], p["max"]
    dist = str(p.get("distribution", ""))
    if _is_log(p):
        value = math.exp(rng.uniform(math.log(lo), math.log(hi)))
    else:
        value = rng.uniform(lo, hi)
    if "int" in dist or (isinstance(lo, int) and isinstance(hi, int) and "uniform" not in dist):
        return int(round(value))
    return float(value)


class Sweep:
    """Run a sweep: objective(params_dict) -> metrics_dict."""

    def __init__(self, spec: Dict[str, Any], seed: int = 0):
        self.spec = SweepSpec(spec)
        self.rng = np.random.default_rng(seed)
        self.trials: List[Dict[str, Any]] = []

    def _score(self, metrics: Dict[str, Any]) -> float:
        value = float(metrics.get(self.spec.metric_name, float("nan")))
        return value if self.spec.maximize else -value

    def _propose(self, n_candidates: int = 32, warmup: int = 8) -> Dict[str, Any]:
        if self.spec.method == "random" or len(self.trials) < warmup:
            return self.spec.sample(self.rng)
        # bayes: kNN surrogate — pick the candidate whose nearest evaluated
        # neighbours scored best (exploitation) plus distance bonus (exploration)
        evaluated = [
            (self.spec.normalize(t["params"]), t["score"])
            for t in self.trials
            if np.isfinite(t["score"])
        ]
        if not evaluated:
            return self.spec.sample(self.rng)
        xs = np.stack([e[0] for e in evaluated])
        ys = np.asarray([e[1] for e in evaluated])
        ys_n = (ys - ys.mean()) / (ys.std() + 1e-9)
        best_cand, best_acq = None, -np.inf
        for _ in range(n_candidates):
            cand = self.spec.sample(self.rng)
            z = self.spec.normalize(cand)
            d = np.linalg.norm(xs - z, axis=1)
            k = min(3, len(d))
            nearest = np.argsort(d)[:k]
            mean_score = float(ys_n[nearest].mean())
            explore = float(d.min())
            acq = mean_score + 0.5 * explore
            if acq > best_acq:
                best_acq, best_cand = acq, cand
        return best_cand

    def run(
        self,
        objective: Callable[[Dict[str, Any]], Dict[str, Any]],
        n_trials: Optional[int] = None,
        csv_path=None,
    ) -> Dict[str, Any]:
        if self.spec.method == "grid":
            plan = self.spec.grid()
            n_trials = len(plan) if n_trials is None else min(n_trials, len(plan))
            proposals = plan[:n_trials]
        else:
            n_trials = n_trials or 20
            proposals = None

        best = None
        for i in range(n_trials):
            params = proposals[i] if proposals is not None else self._propose()
            metrics = objective(params)
            score = self._score(metrics)
            record = {"params": params, "metrics": metrics, "score": score}
            self.trials.append(record)
            # a non-finite incumbent (e.g. NaN first trial) is always replaceable
            if (
                best is None
                or not np.isfinite(best["score"])
                or (np.isfinite(score) and score > best["score"])
            ):
                best = record
            if csv_path is not None:
                self.save_csv(csv_path)
        return best

    def save_csv(self, path) -> None:
        """The trial table: one row a trial, the columns ``param.<key>``,
        ``metric.<key>`` and ``score`` in order of first appearance, empty
        where a trial lacks one (and for NaN)."""
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        rows = []
        for t in self.trials:
            row = {f"param.{k}": v for k, v in t["params"].items()}
            row.update({f"metric.{k}": v for k, v in t["metrics"].items()})
            row["score"] = t["score"]
            rows.append(row)
        columns = list(dict.fromkeys(k for row in rows for k in row))
        with open(path, "w", newline="") as f:
            writer = csv.writer(f, lineterminator="\n")
            writer.writerow(columns)
            for row in rows:
                writer.writerow([csv_cell(row.get(c)) for c in columns])

