#!/usr/bin/env python3
"""Registers and spills of the flash kernels, this tree against another
commit's.

    python3 scripts/compare_ptxas.py --parent DIR

Needs nvcc. ``DIR`` is the root of an unpacked ``git archive`` of the other
commit (at least its ``healnet_tpu_torch/``). Builds ``flash_attention``,
``flash_attention_bwd`` and ``flash_wide`` of both trees (each into its own
``build/kernels-<hash>/``, in a process of its own), reads ptxas's report
of each kernel and prints the kernels whose registers or spill bytes
differ, then how many are the same.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SOURCES = ("flash_attention", "flash_attention_bwd", "flash_wide")
CODE = ("import json; from healnet_tpu_torch.ops import cuda_build; "
        f"cuda_build.build({SOURCES!r}); "
        "print(json.dumps({k: v['ptxas'] for k, v in cuda_build.BUILD_LOG.items()}))")


def report(root: Path) -> dict:
    """{(source, kernel): {"regs": n, "spill": (stores, loads)}} of a tree."""
    out = subprocess.run([sys.executable, "-c", CODE], cwd=root, capture_output=True, text=True,
                         env={**os.environ, "PYTHONPATH": str(root)})
    if out.returncode:
        raise SystemExit(out.stderr[-3000:])
    rows: dict = {}
    for lib, text in json.loads(out.stdout.strip().splitlines()[-1]).items():
        name = None
        for line in text.splitlines():
            m = re.search(r"entry function '([^']+)'", line)
            if m:
                name = m.group(1).split("_cu_")[-1][8:]
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m and name:
                rows.setdefault((lib, name), {})["spill"] = (int(m.group(1)), int(m.group(2)))
            m = re.search(r"Used (\d+) registers", line)
            if m and name:
                rows.setdefault((lib, name), {})["regs"] = int(m.group(1))
    return rows


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", required=True, help="root of the other commit's tree")
    this, parent = report(ROOT), report(Path(parser.parse_args().parent).resolve())
    keys = sorted(set(this) | set(parent))
    for key in keys:
        if this.get(key) != parent.get(key):
            print(f"{key}: parent {parent.get(key)} this tree {this.get(key)}")
    print(f"{sum(this.get(k) == parent.get(k) for k in keys)} of {len(keys)} kernels with the "
          "same registers and spills")
    return 0


if __name__ == "__main__":
    sys.exit(main())
