"""Host-to-device input pipeline: a producer thread and device prefetch.

Counterpart of ``healnet_tpu/etl/prefetch.py``. :class:`BackgroundIterator`
runs a batch iterator in a daemon thread with a bounded queue;
:class:`DevicePrefetcher` keeps ``depth`` batches already copied to the
device ahead of the consumer. On a GPU the producer thread also copies each
batch's arrays into pinned host memory, the copies to the device run on a
side CUDA stream, and the consumer's stream waits on an event recorded after
them, so the copy of batch N+1 overlaps the step of batch N. On the CPU the
batches are placed as they come. ``close()`` frees the producer thread
(required when the consumer stops early, as after a failed step).
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Iterable, Optional

import numpy as np
import torch

_SENTINEL = object()


def pin_tree(tree: Any) -> Any:
    """numpy arrays and CPU tensors of a batch (nested dicts, tuples,
    lists) copied into pinned host memory; anything else as it is."""
    if isinstance(tree, dict):
        return {k: pin_tree(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(pin_tree(v) for v in tree)
    if isinstance(tree, np.ndarray):
        tree = torch.from_numpy(np.ascontiguousarray(tree))
    if isinstance(tree, torch.Tensor) and tree.device.type == "cpu":
        return tree.pin_memory()
    return tree


def _tensors(tree: Any):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (dict, tuple, list)):
        for v in (tree.values() if isinstance(tree, dict) else tree):
            yield from _tensors(v)


class BackgroundIterator:
    """Runs an iterator in a daemon thread with a bounded buffer; an
    exception in the producer is raised in the consumer."""

    def __init__(self, iterable: Iterable, buffer_size: int = 4):
        self._queue: "queue.Queue" = queue.Queue(maxsize=max(1, buffer_size))
        self._error: Optional[BaseException] = None
        self._exhausted = False
        self._stop = threading.Event()

        def put(item) -> bool:
            # a bounded put that notices close(): an abandoned consumer must
            # not leave this thread blocked holding batches
            while not self._stop.is_set():
                try:
                    self._queue.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for item in iterable:
                    if not put(item):
                        return
            except BaseException as exc:  # raised again in the consumer
                self._error = exc
            finally:
                put(_SENTINEL)

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    @property
    def alive(self) -> bool:
        return self._thread.is_alive()

    def close(self) -> None:
        """Release the producer thread and the buffered items."""
        self._stop.set()
        self._exhausted = True
        while True:
            try:
                self._queue.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout=2.0)

    def __iter__(self):
        return self

    def __next__(self):
        if self._exhausted:
            raise StopIteration
        item = self._queue.get()
        if item is _SENTINEL:
            self._exhausted = True
            if self._error is not None:
                raise self._error
            raise StopIteration
        return item


class DevicePrefetcher:
    """Keep ``depth`` batches on the device ahead of the consumer.

    ``put_fn`` places one host batch (default: every array of it on
    ``device``); on a GPU it runs on a side stream over pinned arrays, so
    its copies should be ``non_blocking``.
    """

    def __init__(
        self,
        batches: Iterable,
        depth: int = 2,
        put_fn: Optional[Callable[[Any], Any]] = None,
        buffer_size: int = 4,
        device: Optional[torch.device] = None,
    ):
        self._device = torch.device("cpu" if device is None else device)
        cuda = self._device.type == "cuda"
        self._src = BackgroundIterator(map(pin_tree, batches) if cuda else batches,
                                       buffer_size=buffer_size)
        self._depth = depth
        self._put = put_fn or self._put_default
        self._stream = torch.cuda.Stream(self._device) if cuda else None
        self._ready: list = []  # (placed batch, event or None)

    def _put_default(self, batch):
        def put(x):
            if isinstance(x, dict):
                return {k: put(v) for k, v in x.items()}
            if isinstance(x, (tuple, list)):
                return type(x)(put(v) for v in x)
            if isinstance(x, (np.ndarray, torch.Tensor)):
                t = torch.as_tensor(x)
                return t.to(self._device, non_blocking=t.is_pinned())
            return x
        return put(batch)

    def __iter__(self):
        self._fill()
        while self._ready:
            item, event = self._ready.pop(0)
            if event is not None:
                consumer = torch.cuda.current_stream(self._device)
                consumer.wait_event(event)
                for t in _tensors(item):  # allocated on the side stream
                    if t.is_cuda:
                        t.record_stream(consumer)
            self._fill()
            yield item

    def _fill(self) -> None:
        while len(self._ready) < self._depth:
            try:
                host = next(self._src)
            except StopIteration:
                return
            if self._stream is None:
                self._ready.append((self._put(host), None))
                continue
            self._stream.wait_stream(torch.cuda.current_stream(self._device))
            with torch.cuda.stream(self._stream):
                item = self._put(host)
                event = torch.cuda.Event()
                event.record(self._stream)
            self._ready.append((item, event))

    def close(self) -> None:
        """Release the producer thread and the buffered batches (safe after
        exhaustion; required after leaving the iteration early)."""
        self._src.close()
        self._ready.clear()
