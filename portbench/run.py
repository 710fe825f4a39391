"""Run one cell of the port's benchmark once.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell (an entry of ``workloads`` in ``BENCHMARK.json``) names a config
(``portbench/configs/<config>.json``) and a traffic mix
(``portbench/traffic/<traffic>.json``); its limits are
``portbench/limits/<cell>.json`` and its per-layer metrics
``portbench/metrics/<metric>.py``, all found by name.

Set-up makes the cohort and its int8 arena on the card from the seed,
builds the port's module and trainer, runs the correctness check's steps
(:func:`portbench.program.check_steps`) and one warm-up fold, which
captures the cell's buckets. The window then runs whole folds of the k-fold
loop (``set_fold``, ``fit``) until ``--seconds`` have passed. With
``--trace 1`` the window's first fold runs under the profiler and the
per-layer metrics are read. Then the program is freed and the plain
reference follows the check's steps (:mod:`portbench.check`). The last
line of standard output is the result, as JSON.
"""

from __future__ import annotations

import os
import time

T_START = time.perf_counter()
if __name__ == "__main__":
    # one process with few threads: idle OpenMP workers of the host's small
    # tensor and array work otherwise spin beside the launching thread
    os.environ["OMP_NUM_THREADS"] = "1"

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from portbench import HERE, load_file  # noqa: E402

MANIFEST = HERE.parent / "BENCHMARK.json"
FORBIDDEN = ("jax", "jaxlib", "flax", "healnet_tpu")


def load(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_files(cell_name: str, manifest: dict):
    """(cell, config, mix, limits) of a cell, by name."""
    cells = {c["name"]: c for c in manifest["workloads"]}
    if cell_name not in cells:
        raise SystemExit(f"unknown workload {cell_name!r}; known: {sorted(cells)}")
    cell = cells[cell_name]
    config = next(c for c in manifest["configs"] if c["name"] == cell["config"])
    return (cell, load(HERE.parent / config["file"]), load(HERE / "traffic" / f"{cell['traffic']}.json"),
            load(HERE / "limits" / f"{cell_name}.json"))


def metric_readers(cell_name: str, manifest: dict):
    """(spec, module) of each per-layer metric the cell reports."""
    out = []
    for spec in manifest["per_layer"]:
        if cell_name in spec.get("workloads", [c["name"] for c in manifest["workloads"]]):
            out.append((spec, load_file(HERE / "metrics" / f"{spec['name']}.py",
                                        "portbench_metric_" + spec["name"].replace(".", "_"))))
    return out


def finite(x):
    """``x`` with every non-finite float replaced by 1e300 (JSON has no inf)."""
    if isinstance(x, float):
        return x if np.isfinite(x) else 1e300
    if isinstance(x, dict):
        return {k: finite(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [finite(v) for v in x]
    return x


def forbidden_modules():
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def build_cell(cfg: dict, mix: dict, seed: int, dev, mark=lambda name: None):
    """Set-up up to the window: the cohort and its arena, the fold splits,
    the module and trainer, and the check's steps through that trainer.
    Returns ``(cohort, splits, module, trainer, case, prog)``: the check's
    case (:class:`portbench.check.Case`) and the program's readings."""
    from portbench import check, program, traffic

    cohort = traffic.Cohort(cfg, mix, seed, dev)
    mark("cohort")
    splits = [traffic.train_val_test_split(cohort.n, mix["split"]["train"], mix["split"]["test"],
                                           seed=k) for k in range(1, mix["n_folds"] + 1)]
    module = program.build_module(cfg, dev)
    mark("module")
    trainer = program.build_trainer(module, cfg, mix, cohort, dev)
    mark("trainer")
    w0 = program.draw_weights(module, traffic.fold_seed(seed, 0), dev)
    case = check.make_case(cfg, mix, cohort, splits[0], w0, seed)
    prog = program.check_steps(trainer, case)
    mark("check steps")
    return cohort, splits, module, trainer, case, prog


def fold_state(dev) -> str:
    """The process after a fold: its CPU seconds, the device memory in use
    and held, and the device allocations made so far."""
    line = f"cpu {time.process_time():.3f} s"
    if dev.type == "cuda":
        stats = torch.cuda.memory_stats(dev)
        line += (f", allocated {stats['allocated_bytes.all.current'] / 2**30:.3f} GiB"
                 f", reserved {stats['reserved_bytes.all.current'] / 2**30:.3f} GiB"
                 f", cudaMalloc {stats['num_device_alloc']}")
    return line + f", gc {sum(g['collections'] for g in gc.get_stats())}"


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool, device="cuda",
             manifest: dict = None, files=None, readers=None, t_start: float = T_START) -> dict:
    """One run of a cell; returns the result line's object, with the
    numbers compared under ``compared``."""
    from portbench import check, counts, program, traffic
    from portbench import trace as tracing

    marks = [("start", t_start)]
    mark = lambda name: marks.append((name, time.perf_counter()))
    mark("imports")
    manifest = manifest or load(MANIFEST)
    cell, cfg, mix, limits = files or cell_files(cell_name, manifest)
    seed = int(seed) % 2**63
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(dev)) if on_card else (lambda: None)

    if on_card:
        torch.cuda.init()
        torch.empty(1, device=dev)
        sync()
        mark("cuda")
    cohort, splits, module, trainer, case, prog = build_cell(cfg, mix, seed, dev, mark)
    n_bins = int(cfg["output_dims"])
    program.run_fold(trainer, cohort, splits[0], 1, traffic.fold_seed(seed, 2), n_bins)
    sync()
    mark("warm-up fold")
    setup_s = marks[-1][1] - t_start
    print("set-up: " + ", ".join(f"{name} {b - a:.3f} s" for (_, a), (name, b)
                                  in zip(marks, marks[1:])), file=sys.stderr)
    print(f"after set-up: {fold_state(dev)}", file=sys.stderr)
    setup_peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)

    # the window: whole folds until the time is up
    eval_epochs = sum(1 for e in range(1, mix["epochs"] + 1)
                      if e % mix["eval_interval"] == 0 or e == mix["epochs"])
    win = dict(folds=0, samples=0, failed=0, fold_walls=[], fold_flops=[],
               traced_folds=1 if trace else 0)
    prof, summary, traced_steps = None, None, 0
    t0 = time.perf_counter()
    while True:
        k = win["folds"]
        split = splits[k % len(splits)]
        run = lambda: program.run_fold(trainer, cohort, split, k % len(splits) + 1,
                                       traffic.fold_seed(seed, 3 + k), n_bins)
        t_fold = time.perf_counter()
        if trace and k == 0:
            out, prof = tracing.traced(run)
        else:
            out = run()
        win["fold_walls"].append(time.perf_counter() - t_fold)
        print(f"fold {k} (split {k % len(splits) + 1}): {win['fold_walls'][-1]:.4f} s, epochs "
              + " ".join(f"{e:.3f}" for e in out["epoch_s"]) + f" s, {fold_state(dev)}",
              file=sys.stderr)
        train_idx, _, val_idx = split
        steps = mix["epochs"] * traffic.ArenaSplit(cohort, train_idx).count_batches(
            None, mix["batch_size"], mix["bucket_boundaries"])
        traced_steps = traced_steps or steps
        win["folds"] += 1
        win["samples"] += mix["epochs"] * len(train_idx)
        win["failed"] += out["nonfinite"] * len(train_idx)
        win["fold_flops"].append(counts.fold_flops(cfg, cohort.lengths[train_idx],
                                                   cohort.lengths[val_idx], mix["epochs"],
                                                   eval_epochs))
        if time.perf_counter() - t0 >= seconds:
            break
    sync()
    win["wall_s"] = time.perf_counter() - t0
    if prof is not None:
        summary = tracing.reduce(prof)
        del prof
    window_peak = torch.cuda.max_memory_allocated(dev) if on_card else 0

    if trace:
        ctx = SimpleNamespace(summary=summary, window=win, traced_steps=traced_steps,
                              peak_window_bytes=window_peak, module=module, cohort=cohort,
                              cfg=cfg, mix=mix, device=dev, seed=seed)
        metrics = {}
        for spec, reader in readers if readers is not None else metric_readers(cell_name,
                                                                                manifest):
            value = reader.read(ctx)
            if value is not None:
                metrics[spec["name"]] = {"value": float(value), "unit": spec["unit"]}
    else:
        metrics = {"train_samples_per_s": {"value": win["samples"] / win["wall_s"],
                                           "unit": "samples/s"},
                   "setup_s": {"value": setup_s, "unit": "s"}}

    # the reference, once the program is gone
    del trainer, module
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref = check.reference_run(cohort, cfg, mix, case)
    print(f"reference: {time.perf_counter() - t_ref:.3f} s", file=sys.stderr)
    readings = check.compare(prog, ref, check.host_weights(case.w0))
    correct, shown = check.verdict(readings, limits)
    result = {"correct": bool(correct), "attempted": win["samples"], "failed": win["failed"],
              "metrics": metrics,
              "device": {"platform": "gpu" if on_card else "cpu",
                         "kind": torch.cuda.get_device_name(dev) if on_card else "cpu",
                         "count": 1, "memory_peak_bytes": int(max(setup_peak, window_peak))}}
    if trace:
        result["device"].update(busy_s=summary.busy_s, window_s=summary.window_s)
        result["breakdown"] = {"device_ops": [list(r) for r in summary.device_ops],
                               "idle_gaps": [list(r) for r in summary.idle_gaps]}
    result["where"] = {k: v["where"] for k, v in readings.items()}
    result["compared"] = shown
    return result


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    manifest = load(MANIFEST)
    cell = next((c for c in manifest["workloads"] if c["name"] == args.workload), None)
    chips = cell["chips"] if cell else 1
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {found}", file=sys.stderr)
        return 3
    for name, v in result["compared"].items():
        print(f"{name} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(finite(result)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
