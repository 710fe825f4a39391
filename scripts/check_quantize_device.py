#!/usr/bin/env python3
"""Hold the arena quantization on the GPU against the host's.

    python3 scripts/check_quantize_device.py [--rows 40000]

Quantizes random float16 rows of 2,048 channels (scales spread 0.1-9) per
row to int8 three ways: ``quantize_context_host`` (numpy, the JAX
package's arithmetic), ``parallel/arena.py::place_quantized`` (the
pipeline's: on the card, scales from the host's arithmetic) and
``ops/quantize.py::quantize_context`` on a CUDA tensor; prints whether the
device results equal the host's and how many row scales differ. Exits
non-zero when ``place_quantized`` differs. Needs one CUDA GPU.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from healnet_tpu_torch.ops.quantize import quantize_context, quantize_context_host  # noqa: E402
from healnet_tpu_torch.parallel.arena import place_quantized  # noqa: E402


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--rows", type=int, default=40000)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("check_quantize_device: no CUDA device is available", file=sys.stderr)
        return 1
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((args.rows, 2048), dtype=np.float32)
         * rng.uniform(0.1, 9, (args.rows, 1))).astype(np.float16)
    q, s = quantize_context_host(x)
    got = place_quantized(x, torch.device("cuda"))
    same = (np.array_equal(got.data.cpu().numpy(), q)
            and np.array_equal(got.scale.cpu().numpy(), s))
    old = quantize_context(torch.as_tensor(x, device="cuda"))
    differ = int((old.scale.cpu().numpy() != s).sum())
    print(f"{torch.cuda.get_device_name(0)}: place_quantized equal to the host: {same}; "
          f"quantize_context row scales differing from the host: {differ} of {args.rows}")
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
