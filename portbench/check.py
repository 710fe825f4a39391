"""The comparison that decides ``correct``.

The program trains from the benchmark's weights ``w0`` for as many
epochs of one step each as the check has batches
(:func:`portbench.program.check_steps`): the mix's ``check`` names
``rounds`` rounds of one batch in each of its ``buckets``, so that the
first round runs each bucket's first step and its capture and the later
ones replay every bucket's captured step; validation follows each round.
The reference (the file the config's ``reference`` names, such as
:mod:`portbench.reference.healnet`) follows the same steps from the same
weights, batches and dropout draws, which it works out again from the
trainer's seed as the trainer's recipe states: epoch ``e`` of fold ``f`` seeds the feed-forward masks' device
generator and the attention seeds' host generator from
``SeedSequence([seed + 1000 f, e])``, and a step's attention seeds are
``torch.randint(0, 2**32, (1, calls))`` from the latter.

The numbers, each compared against its limit where the cell's limits
file names it:

- ``loss``: the widest relative gap of a step's survival loss;
- ``loss_first``: the relative gap of the first step's survival loss: the
  forward from the same weights, before any update has carried the
  rounding of one step into the next (which Adam turns into a full step in
  a small gradient element, so that the later steps' gaps are wider);
- ``val_loss``: the widest relative gap of a validation pass's loss;
- ``grad1``: over leaves, the gap between the program's and the
  reference's norm of the first gradient, over the larger of the
  reference's norm of that leaf and of the median leaf;
- ``change``: the same of each leaf's change after the last step, over the
  leaves whose first reference gradient is at least a thousandth of the
  median leaf's (the others move under Adam by round-off alone);
- ``grad1_err``: over those leaves, the median leaf's relative error of the
  first gradient, ``|g - g_ref| / |g_ref|``: the number that tells a
  lower precision from the configured one (a gap of norms barely moves
  under rounding noise, which is mostly orthogonal to the gradient).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from portbench import HERE, load_file
from portbench.traffic import ArenaSplit, check_batches, class_weights, fold_seed

NAMES = ("loss", "loss_first", "val_loss", "grad1", "change", "grad1_err")
EXCLUDE_BELOW = 1e-3


@dataclass
class Case:
    """The check's inputs, the same to both sides: the weights ``w0`` (on
    the device), the training batches (host), the validation split, the
    class weights, the trainer's seed and the validation cadence."""
    batches: List[dict]
    val: ArenaSplit
    w0: Dict[str, torch.Tensor]
    cw: np.ndarray
    seed: int
    eval_every: int

    @property
    def eval_epochs(self) -> List[int]:
        """The epochs after which both sides validate (as ``fit`` does)."""
        n = len(self.batches)
        return [e for e in range(1, n + 1) if e % self.eval_every == 0 or e == n]


def make_case(cfg: dict, mix: dict, cohort, split, w0: Dict[str, torch.Tensor],
              seed: int) -> Case:
    """The check's case of ``--seed`` on a fold ``split`` (train, test, val)."""
    train_idx, _, val_idx = split
    return Case(batches=check_batches(cohort, train_idx, mix, seed),
                val=ArenaSplit(cohort, val_idx), w0=w0,
                cw=class_weights(cohort.y_disc[train_idx], int(cfg["output_dims"])),
                seed=fold_seed(seed, 1), eval_every=len(mix["check"]["buckets"]))


def reference_of(cfg: dict):
    """The plain reference the config names (``reference``: a file of the
    benchmark)."""
    path = HERE.parent / cfg["reference"]
    return load_file(path, "portbench_reference_" + path.stem)


def reference_run(cohort, cfg: dict, mix: dict, case: Case, mm: Optional[Callable] = None,
                  alter: float = 0.0, half_batch: bool = False) -> dict:
    """The reference's readings of the check's steps, shaped as the
    program's (:func:`portbench.program.check_steps`); ``mm`` (the
    reference's own product by default) stands the control in."""
    ref_mod = reference_of(cfg)
    ref_mod.strict_float32()
    calls = ref_mod.attention_calls(cfg)
    ref = ref_mod.Trainer({k: v.float() for k, v in case.w0.items()}, cfg,
                          horizon=float(len(case.batches)),
                          class_weights=torch.as_tensor(case.cw, dtype=torch.float32,
                                                        device=cohort.device),
                          mm=mm or torch.matmul, alter=alter, half_batch=half_batch)
    out = {"loss": [], "val_loss": []}
    for epoch, hb in enumerate(case.batches, start=1):
        ff, seeds = np.random.SeedSequence([case.seed + 1000, epoch]).generate_state(2)
        draws = torch.randint(0, 2**32, (1, calls), dtype=torch.int64,
                              generator=torch.Generator().manual_seed(int(seeds)))[0].tolist()
        loss, grads = ref.step(cohort.device_batch(hb), draws, int(ff))
        if epoch == 1:
            out["grad1"] = {k: g.detach().cpu().numpy() for k, g in grads.items()}
        out["loss"].append(loss)
        if epoch in case.eval_epochs:
            out["val_loss"].append(ref.val_loss(
                cohort.device_batch(b) for b in case.val.iter_batches(
                    mix["batch_size"], bucket_boundaries=mix["bucket_boundaries"])))
    out["params"] = {k: v.detach().cpu().numpy() for k, v in ref.p.items()}
    return out


def _rel(a: float, b: float) -> float:
    if not (np.isfinite(a) and np.isfinite(b)):
        return float("inf")
    return abs(a - b) / max(abs(b), 1e-30)


def _leaf_gap(prog: Dict[str, float], ref: Dict[str, float], keep) -> tuple:
    med = float(np.median([ref[k] for k in keep]))
    gaps = {k: (abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) if np.isfinite(prog[k])
                else float("inf")) for k in keep}
    worst = max(gaps, key=gaps.get)
    return gaps[worst], worst


def compare(prog: dict, ref: dict, w0: Dict[str, np.ndarray]) -> Dict[str, dict]:
    """Each number compared, with the leaf it was worst on."""
    norm = lambda a: float(np.linalg.norm(np.asarray(a, np.float64)))
    if prog.get("grad1") is None or prog.get("params") is None:
        return {name: {"value": float("inf"), "where": "no reading"} for name in NAMES}
    g_ref = {k: norm(v) for k, v in ref["grad1"].items()}
    g_med = float(np.median(list(g_ref.values())))
    moved = [k for k in g_ref if g_ref[k] >= EXCLUDE_BELOW * g_med]
    grad, g_where = _leaf_gap({k: norm(v) for k, v in prog["grad1"].items()}, g_ref, list(g_ref))
    change, c_where = _leaf_gap({k: norm(prog["params"][k] - w0[k]) for k in moved},
                                {k: norm(ref["params"][k] - w0[k]) for k in moved}, moved)
    err = float(np.median([norm(prog["grad1"][k] - ref["grad1"][k]) / max(g_ref[k], 1e-30)
                           for k in moved]))
    steps = lambda key: max((_rel(a, b), i + 1) for i, (a, b) in
                            enumerate(zip(prog[key], ref[key])))
    loss, val_loss = steps("loss"), steps("val_loss")
    return {"loss": {"value": loss[0], "where": f"step {loss[1]}"},
            "loss_first": {"value": _rel(prog["loss"][0], ref["loss"][0]), "where": "step 1"},
            "val_loss": {"value": val_loss[0], "where": f"pass {val_loss[1]}"},
            "grad1": {"value": grad, "where": g_where},
            "change": {"value": change, "where": c_where},
            "grad1_err": {"value": err if np.isfinite(err) else float("inf"),
                          "where": "median leaf"}}


def verdict(readings: Dict[str, dict], limits: Dict[str, float]) -> tuple:
    """(correct, {name: {value, limit}}) of the numbers the limits name."""
    shown = {k: {"value": readings[k]["value"], "limit": float(limits[k])}
             for k in NAMES if k in limits}
    return all(v["value"] <= v["limit"] for v in shown.values()), shown


def host_weights(w0: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {k: v.detach().float().cpu().numpy() for k, v in w0.items()}

