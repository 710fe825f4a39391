"""Fused epochs: a bucket's steps run from static device buffers, captured
as one CUDA graph on the card.

Counterpart of the ``fused_epochs`` scans of ``healnet_tpu/train/loop.py``
(``_bucket_groups``, ``_stack_for_scan``, ``scan_train`` / ``scan_eval``).
There an epoch's arena batches (indices and labels only) upload in one
transfer per bucket width and one jitted ``lax.scan`` runs the bucket's
steps. Here a :class:`StepTable` holds a bucket's batches, one slot a step
and every field of a slot (the omic tensors, KV masks, offsets, labels,
censoring, sample masks, presence, the step's attention seeds) at a fixed
byte offset, in one ``(steps, slot bytes)`` device buffer filled by one
copy. A step body reads slot ``counter`` into a fixed slot buffer (one
gather), runs the step on views of it, writes its outputs into slot
``counter`` of an output buffer and adds one to the counter: every address
it touches is fixed, so on the card the body is captured once in a
``torch.cuda.CUDAGraph`` and replayed once a step. The step count is
rounded up to :data:`SCAN_QUANTUM` as in JAX, so folds whose buckets
differ by a few steps share a table; only the real steps run.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

#: a bucket's steps are rounded up to a multiple of this (JAX's SCAN_QUANTUM)
SCAN_QUANTUM = 8

_ALIGN = 16  # byte alignment of a field in a slot
# the dtypes a host batch's fields come in
_TORCH_DTYPES = {np.dtype(n): getattr(torch, n) for n in
                 ("bool", "uint8", "int32", "int64", "float16", "float32")}


def bucket_groups(batches: Iterable[Dict[str, Any]]) -> Dict[int, List[Dict[str, Any]]]:
    """Host batches grouped by their static KV width (the last KV mask's),
    in order of first appearance; each group keeps its batches' order."""
    groups: Dict[int, List[Dict[str, Any]]] = {}
    for hb in batches:
        groups.setdefault(int(hb["kv_masks"][-1].shape[1]), []).append(hb)
    return groups


def padded_steps(n_real: int) -> int:
    """``n_real`` rounded up to :data:`SCAN_QUANTUM` (at least one quantum)."""
    return max(-(-n_real // SCAN_QUANTUM), 1) * SCAN_QUANTUM


def _host(x) -> np.ndarray:
    """A host value as the trainer places it: float64 becomes float32."""
    a = np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)
    return a.astype(np.float32) if a.dtype == np.float64 else a


def _fields(batch: Dict[str, Any]) -> List[Tuple[Tuple, np.ndarray]]:
    """(path, host array) of every tensor of a host batch, in a fixed order;
    a path is a key, or (key, index) inside ``tensors`` / ``kv_masks``
    (None entries are kept as None and take no bytes)."""
    out = []
    for key in sorted(batch):
        value = batch[key]
        if isinstance(value, (tuple, list)):
            out += [((key, i), None if v is None else _host(v)) for i, v in enumerate(value)]
        elif value is not None:
            out.append(((key,), _host(value)))
    return out


def table_signature(example: Dict[str, Any]) -> tuple:
    """What a table of ``example``'s batches is laid out by: each field's
    path, dtype and shape."""
    return tuple((path, None if arr is None else (str(arr.dtype), arr.shape))
                 for path, arr in _fields(example))


class StepTable:
    """The static device buffers of one bucket shape: ``steps`` slots of a
    batch's fields, the slot a step reads, the step counter, and an
    ``(steps, width)`` float32 output buffer.

    ``layout`` is the fields' (path, dtype, shape, byte offset); ``graph``
    holds the captured step (None until captured, or after it is dropped).
    """

    def __init__(self, example: Dict[str, Any], steps: int, out_width: int,
                 device: torch.device):
        self.steps, self.device = steps, device
        # empty tuples (a slides-only arena batch's ``tensors``) take no
        # bytes but stay in the batch a step sees
        self.empty = [k for k, v in example.items() if isinstance(v, (tuple, list)) and not v]
        self.layout, offset = [], 0
        for path, arr in _fields(example):
            if arr is None:
                self.layout.append((path, None, None, None))
                continue
            self.layout.append((path, arr.dtype, arr.shape, offset))
            offset += -(-arr.nbytes // _ALIGN) * _ALIGN
        self.slot_bytes = max(offset, _ALIGN)
        self.table = torch.zeros((steps, self.slot_bytes), dtype=torch.uint8, device=device)
        self.slot = torch.zeros((1, self.slot_bytes), dtype=torch.uint8, device=device)
        self.counter = torch.zeros((1,), dtype=torch.int64, device=device)
        self.out = torch.zeros((steps, out_width), dtype=torch.float32, device=device)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.batch = self._views()

    def _views(self) -> Dict[str, Any]:
        """The batch a step sees: views of the slot buffer."""
        flat, batch = self.slot[0], {k: [] for k in self.empty}
        for path, dtype, shape, offset in self.layout:
            view = None
            if dtype is not None:
                nbytes = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
                view = flat[offset:offset + nbytes].view(_TORCH_DTYPES[dtype]).view(shape)
            if len(path) == 1:
                batch[path[0]] = view
            else:
                batch.setdefault(path[0], []).append(view)
        return {k: tuple(v) if isinstance(v, list) else v for k, v in batch.items()}

    def upload(self, batches: List[Dict[str, Any]]) -> None:
        """Every batch into its slot, in order, with one host-to-device copy
        (from pinned memory on the card; the rest of the slots stay as they
        are and are never run)."""
        if len(batches) > self.steps:
            raise ValueError(f"{len(batches)} batches for a table of {self.steps} steps")
        host = np.zeros((len(batches), self.slot_bytes), np.uint8)
        for i, hb in enumerate(batches):
            for (path, arr), (want, dtype, shape, offset) in zip(_fields(hb), self.layout):
                if path != want or (arr is None) != (dtype is None) or (
                        arr is not None and (arr.dtype != dtype or arr.shape != shape)):
                    raise ValueError(f"batch {i} does not fit the table at {path}")
                if arr is not None:
                    raw = np.ascontiguousarray(arr).view(np.uint8).reshape(-1)
                    host[i, offset:offset + raw.size] = raw
        src = torch.from_numpy(host)
        if self.device.type == "cuda":
            src = src.pin_memory()
        self.table[:len(batches)].copy_(src, non_blocking=True)

    def select(self) -> None:
        """Slot ``counter`` of the table into the slot buffer (one gather)."""
        torch.index_select(self.table, 0, self.counter, out=self.slot)

    def emit(self, row: torch.Tensor) -> None:
        """``row`` into output slot ``counter``, then the next step."""
        self.out.index_copy_(0, self.counter, row.reshape(1, -1))
        self.counter.add_(1)


def run_steps(table: StepTable, body: Callable[[], None], n_real: int,
              generator: Optional[torch.Generator] = None,
              stream: Optional[torch.cuda.Stream] = None) -> None:
    """Run ``body`` for the table's first ``n_real`` slots.

    On the CPU the body runs eagerly. On the card it is replayed from the
    table's graph; without one, the first step runs eagerly on ``stream``
    (the warm-up, which fills the wrappers' plans and caches and the
    optimizer's state at fixed addresses), then the body is captured on
    that stream, with ``generator``'s state registered so that each replay
    draws the next masks, and the other steps replay it. A failed capture
    or replay raises: there is no stepwise fallback."""
    table.counter.zero_()
    if table.device.type != "cuda":
        for _ in range(n_real):
            body()
        return
    done = 0
    if table.graph is None:
        current = torch.cuda.current_stream(table.device)
        stream.wait_stream(current)
        with torch.cuda.stream(stream):
            body()
        current.wait_stream(stream)
        done = 1
        graph = torch.cuda.CUDAGraph()
        if generator is not None:
            graph.register_generator_state(generator)
        with torch.cuda.graph(graph, stream=stream):
            body()
        table.graph = graph
    for _ in range(n_real - done):
        table.graph.replay()
