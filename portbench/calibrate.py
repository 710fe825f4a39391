"""The readings that a cell's limits are set from, on the card.

    python3 -m portbench.calibrate --workload <cell> --seeds <n> [--controls <k>] [--out <file>]

For each of ``--seeds`` seeds, the program's check steps at the cell's own
size, made by the run's own set-up (:func:`portbench.run.build_cell`),
against the float32 reference: the sound runs' readings, whose largest is
a limit's lower reading. For the first ``--controls`` seeds also, in the
program's place: the control (the reference with every product in the
reference's ``control_mm``, fp8 for a bf16 config), and two planted
faults, half of each training batch left out of the mean and an answer
altered where it is produced (row 0's logits plus 1). A step that returns its state unchanged reads 1 on ``change``
by that number's definition and needs no run. Each reading is one JSON
line; the last line holds each number's lower reading and its smallest
control and fault readings.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys

import numpy as np
import torch

from portbench import check
from portbench.run import MANIFEST, build_cell, cell_files, load


def readings_for_seed(cfg, mix, seed: int, dev, controls: bool) -> dict:
    cohort, _, module, trainer, case, prog = build_cell(cfg, mix, seed, dev)
    del trainer, module
    gc.collect()
    torch.cuda.empty_cache()
    host_w0 = check.host_weights(case.w0)
    ref_of = lambda **kw: check.reference_run(cohort, cfg, mix, case, **kw)
    ref = ref_of()
    runs = {"program": prog}
    if controls:
        runs["control"] = ref_of(mm=check.reference_of(cfg).control_mm)
        runs["fault_half_batch"] = ref_of(half_batch=True)
        runs["fault_answer_altered"] = ref_of(alter=1.0)
    out = {"seed": seed}
    for kind, run in runs.items():
        out[kind] = check.compare(run, ref, host_w0)
        out[kind]["loss_steps"] = [check._rel(a, b) for a, b in zip(run["loss"], ref["loss"])]
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, default=12)
    parser.add_argument("--controls", type=int, default=3)
    parser.add_argument("--first-seed", type=int, default=1000003)
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    _, cfg, mix, _ = cell_files(args.workload, load(MANIFEST))
    dev = torch.device("cuda")
    rows = []
    sink = open(args.out, "w") if args.out else None
    for i in range(args.seeds):
        row = readings_for_seed(cfg, mix, args.first_seed + 7919 * i, dev, i < args.controls)
        rows.append(row)
        line = json.dumps(row)
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()
    summary = {"workload": args.workload, "seeds": len(rows)}
    for name in check.NAMES:
        summary[name] = {
            "lower": max(r["program"][name]["value"] for r in rows),
            "median": float(np.median([r["program"][name]["value"] for r in rows])),
            **{kind: min(r[kind][name]["value"] for r in rows if kind in r)
               for kind in ("control", "fault_half_batch", "fault_answer_altered")
               if any(kind in r for r in rows)}}
    print(json.dumps(summary), flush=True)
    if sink:
        sink.write(json.dumps(summary) + "\n")
        sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
