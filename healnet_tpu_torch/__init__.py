"""PyTorch + CUDA port of healnet_tpu for NVIDIA Hopper GPUs.

Mirrors the JAX package's layout (``ops/``, ``models/``, ``train/``,
``etl/``, ``utils/``, ``runtime/``, ``cli/``, ``serving.py``). Entry points
run on the GPU unless the caller passes ``device="cpu"`` (the CLI:
``--device cpu``); the hand-written CUDA kernels under ``ops/csrc/`` are
built with nvcc on first use.
"""

from healnet_tpu_torch.device import resolve_device, round_up
from healnet_tpu_torch.models.healnet import HealNet, HealNetModule
from healnet_tpu_torch.serving import Predictor

__all__ = ["HealNet", "HealNetModule", "Predictor", "resolve_device", "round_up"]
