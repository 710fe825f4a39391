"""Batches placed from each process's own rows.

Counterpart of ``healnet_tpu/parallel/data.py``. In the JAX package a
process is a host with several devices and passes its host's slice of the
global batch. In the port a process is one device: it passes the rows of
its ``data`` coordinate (global batch / data size), and ranks that differ
only in their ``seq`` or ``model`` coordinate pass the same rows. The
trainer takes the other contract (every rank iterates the whole host batch
and :func:`~healnet_tpu_torch.parallel.train.put_batch` keeps its block).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from healnet_tpu_torch.parallel.mesh import AXIS_DATA, Mesh
from healnet_tpu_torch.parallel.train import put_batch


def global_batch_from_host_local(batch: Mapping[str, Any], mesh: Mesh) -> Dict[str, Any]:
    """This process's rows (its ``data`` coordinate's block of the global
    batch) -> its block of every leaf on the mesh's device: the rows as
    they are, a modality's tokens split over ``seq``
    (:func:`~healnet_tpu_torch.parallel.train.batch_shardings`, judged on
    the global batch of ``data`` times these rows)."""
    return put_batch(batch, mesh, batch_axis_factor=mesh.shape[AXIS_DATA])


def local_batch_rows(arr) -> np.ndarray:
    """A step output's rows this process reports, on the host, in global
    order. The sharded step gathers the logits over ``data`` (the loss needs
    every row), so its per-sample outputs (the risks) hold every row of the
    batch, which is what a process that iterated the whole host batch
    reports its c-index over."""
    if isinstance(arr, torch.Tensor):
        return arr.detach().float().cpu().numpy()
    return np.asarray(arr)
