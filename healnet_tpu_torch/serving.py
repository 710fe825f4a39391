"""Batched inference: the serving path.

Counterpart of ``healnet_tpu/serving.py::Predictor``: requests of any size
are split into fixed micro-batches (the last one padded by repeating its
last row), missing modalities become zero tensors with their presence
column zeroed, ragged patch bags pad to length buckets with KV masks built
automatically, and the outputs are the survival head: logits, hazards,
survival curves and risk. Outputs are float32 numpy arrays. Arena mode
(``feature_arena=``, :meth:`Predictor.predict_from_arena`) serves from the
training-time feature arena, plain or int8, uploaded to the device once: a
request carries bag offsets and lengths, and no patch features.

Parameters may come from a checkpoint directory: its ``best`` entry
(:class:`healnet_tpu_torch.train.checkpoint.Checkpointer`). Not ported
yet: artifact export.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Any, Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from healnet_tpu_torch.compat.flax_params import is_flax_tree, state_dict_from_flax
from healnet_tpu_torch.device import DeviceLike, resolve_device, round_up
from healnet_tpu_torch.parallel.arena import gather_bag, place_arena
from healnet_tpu_torch.train.checkpoint import Checkpointer
from healnet_tpu_torch.train.losses import hazards_survival_risk
from healnet_tpu_torch.utils.train_utils import accepts_kv_masks


class Predictor:
    """Fixed-micro-batch survival predictor."""

    def __init__(
        self,
        module: torch.nn.Module,
        params: Optional[Mapping] = None,
        batch_size: int = 8,
        compute_dtype: Optional[torch.dtype] = None,
        bucket_boundaries: Optional[Sequence[int]] = None,
        device: DeviceLike = None,
        feature_arena: Optional[Any] = None,
    ):
        """
        Args:
            module: a module with the HealNet call convention.
            params: a port ``state_dict``, a Flax ``params`` tree (nested
                mappings of arrays) converted on load, or a checkpoint
                directory whose ``best`` entry is loaded; None keeps the
                module's own weights.
            batch_size: micro-batch; requests are padded/split to it.
            compute_dtype: dtype the input tensors are cast to (default
                float32); the module's own ``dtype`` governs its compute.
            bucket_boundaries: sorted token-length boundaries for ragged
                patch bags; each bag pads to the smallest boundary >= its
                length.
            device: the GPU unless ``"cpu"`` is asked for.
            feature_arena: the training-time packed feature arena (numpy,
                tensor, or a ``QuantizedContext`` of int8 rows and scales);
                enables :meth:`predict_from_arena`. Uploaded once.
        """
        self.device = resolve_device(device)
        if isinstance(params, (str, Path)):
            params = Checkpointer(params).restore_best()
        if params is not None:
            module.load_state_dict(
                state_dict_from_flax(params) if is_flax_tree(params) else params
            )
        self.module = module.to(self.device).eval()
        self.batch_size = batch_size
        self.compute_dtype = compute_dtype
        self.bucket_boundaries = (
            sorted(int(b) for b in bucket_boundaries) if bucket_boundaries else None
        )
        self._accepts_kv_masks = accepts_kv_masks(module)
        self._arena = None if feature_arena is None else place_arena(feature_arena, self.device)
        # distinct micro-batch input signatures served so far
        self._signatures: set = set()

    def _predict(self, tensors, presence, kv_masks) -> Dict[str, torch.Tensor]:
        kwargs = (
            {} if (kv_masks is None or not self._accepts_kv_masks)
            else {"kv_masks": kv_masks}
        )
        self._signatures.add((
            tuple(tuple(t.shape) for t in tensors),
            None if kv_masks is None else tuple(m is not None for m in kv_masks),
        ))
        with torch.inference_mode():
            logits = self.module(tensors, presence=presence, **kwargs).float()
            hazards, survival, risk = hazards_survival_risk(logits)
        return {"logits": logits, "hazards": hazards, "survival": survival, "risk": risk}

    def __call__(
        self,
        tensors: Sequence[Optional[np.ndarray]],
        presence: Optional[np.ndarray] = None,
        kv_masks: Optional[Sequence[Optional[np.ndarray]]] = None,
    ) -> Dict[str, np.ndarray]:
        """Predict for n samples; entries of ``tensors`` may be None (missing).

        kv_masks: optional per-modality bool masks ``(n, tokens_i)`` for
        padded contexts (True = attend). Returns (n, ...) arrays for
        logits/hazards/survival and (n,) for risk.
        """
        n_mod = len(tensors)
        n = next(
            (np.asarray(t).shape[0] for t in tensors if t is not None),
            None if presence is None else np.asarray(presence).shape[0],
        )
        if n is None:
            raise ValueError("at least one modality tensor (or a presence matrix) is required")
        if n == 0:  # empty request: empty, well-shaped outputs
            zero = lambda *tail: np.zeros((0, *tail), np.float32)
            nb = int(self.module.out_dims)
            return {
                "logits": zero(nb), "hazards": zero(nb),
                "survival": zero(nb), "risk": zero(),
            }
        pres = (
            np.ones((n, n_mod), np.float32)
            if presence is None
            else np.asarray(presence, np.float32).copy()
        )
        full = self._materialize(tensors, n, pres)
        masks = (
            [None] * n_mod
            if kv_masks is None
            else [None if m is None else np.asarray(m, bool) for m in kv_masks]
        )
        return self._microbatched(n, full, pres, masks, kv_masks is None)

    def _materialize(self, tensors, n: int, pres: np.ndarray) -> List[np.ndarray]:
        """None entries (missing modalities) -> zero-filled arrays, with the
        matching presence column zeroed."""
        full = []
        for i, t in enumerate(tensors):
            if t is None:
                pres[:, i] = 0.0
                tail = (1,) * self.module.num_spatial_axes[i] + (int(self.module.channel_dims[i]),)
                full.append(np.zeros((n,) + tail, np.float32))
            else:
                full.append(np.asarray(t, np.float32))
        return full

    def _bucket_width(self, length: int) -> int:
        """Smallest boundary >= length (overlong bags truncate to the cap);
        multiples of 128 when no boundaries are configured."""
        if self.bucket_boundaries:
            for b in self.bucket_boundaries:
                if length <= b:
                    return b
            return self.bucket_boundaries[-1]
        return max(128, round_up(int(length), 128))

    def predict_ragged(
        self,
        tensors: Sequence[Any],
        presence: Optional[np.ndarray] = None,
    ) -> Dict[str, np.ndarray]:
        """Predict for ragged patch bags without caller-side padding.

        ``tensors[-1]`` is a list of per-sample ``(tokens_i, d)`` arrays (or
        None for a missing bag); earlier entries are stacked arrays as in
        ``__call__``. Samples are grouped by bucket width, padded, KV-masked,
        and the results come back in request order.
        """
        bags = list(tensors[-1])
        n = len(bags)
        pres = (
            np.ones((n, len(tensors)), np.float32)
            if presence is None
            else np.asarray(presence, np.float32).copy()
        )
        lead = self._materialize(tensors[:-1], n, pres)
        dim = next((np.asarray(b).shape[-1] for b in bags if b is not None), None)
        if dim is None:
            raise ValueError("at least one sample must carry a patch bag")

        groups: Dict[int, List[int]] = {}
        for i, b in enumerate(bags):
            groups.setdefault(self._bucket_width(0 if b is None else len(b)), []).append(i)

        slot_outs: Dict[int, Dict[str, np.ndarray]] = {}
        for width, idxs in groups.items():
            m = len(idxs)
            padded = np.zeros((m, width, dim), np.float32)
            mask = np.zeros((m, width), bool)
            grp_pres = pres[idxs].copy()
            for j, i in enumerate(idxs):
                if bags[i] is None:
                    grp_pres[j, -1] = 0.0
                    continue
                bag = np.asarray(bags[i], np.float32)
                ln = min(len(bag), width)
                padded[j, :ln] = bag[:ln]
                mask[j, :ln] = True
            grp_tensors = [t[idxs] for t in lead] + [padded]
            kv = [None] * len(lead) + [mask]
            res = self._microbatched(m, grp_tensors, grp_pres, kv, False)
            for j, i in enumerate(idxs):
                slot_outs[i] = {k: v[j] for k, v in res.items()}
        return {
            k: np.stack([slot_outs[i][k] for i in range(n)])
            for k in next(iter(slot_outs.values()))
        }

    def predict_from_arena(
        self,
        tensors: Sequence[Optional[np.ndarray]],
        patch_offsets: np.ndarray,
        patch_lengths: np.ndarray,
        presence: Optional[np.ndarray] = None,
    ) -> Dict[str, np.ndarray]:
        """Arena-mode prediction: no per-request feature upload.

        ``tensors`` carries the modalities other than the slide (as in
        training's arena batches); each sample's bag is gathered on the
        device from the resident arena by (offset, length). Samples are
        grouped by bucket width, each micro-batch is padded by repeating its
        last row, and the slide's KV mask comes from the lengths. Needs
        ``feature_arena`` at construction.
        """
        if self._arena is None:
            raise ValueError("predict_from_arena needs Predictor(feature_arena=...)")
        offsets = np.asarray(patch_offsets, np.int32)
        lengths = np.asarray(patch_lengths, np.int32)
        n = offsets.shape[0]
        pres = (
            np.ones((n, len(tensors) + 1), np.float32)
            if presence is None
            else np.asarray(presence, np.float32).copy()
        )
        lead = self._materialize(list(tensors), n, pres)
        dtype = self.compute_dtype or torch.float32
        to_dev = lambda a, dt: torch.as_tensor(a, dtype=dt, device=self.device)

        groups: Dict[int, List[int]] = {}
        for i, ln in enumerate(lengths):
            groups.setdefault(self._bucket_width(int(ln)), []).append(i)
        bs = self.batch_size
        slot_outs: Dict[int, Dict[str, np.ndarray]] = {}
        for width, idxs in groups.items():
            for start in range(0, len(idxs), bs):
                sel = idxs[start:start + bs]
                rows = sel + [sel[-1]] * (bs - len(sel))
                mask = to_dev(np.arange(width)[None, :]
                              < np.minimum(lengths[rows], width)[:, None], torch.bool)
                slide = gather_bag(self._arena, to_dev(offsets[rows], torch.int32), mask)
                cur = tuple(to_dev(t[rows], dtype) for t in lead) + (slide,)
                kv = tuple([None] * len(lead) + [mask])
                res = self._predict(cur, to_dev(pres[rows], torch.float32), kv)
                res = {k: v.cpu().numpy() for k, v in res.items()}
                for j, i in enumerate(sel):
                    slot_outs[i] = {k: v[j] for k, v in res.items()}
        return {
            k: np.stack([slot_outs[i][k] for i in range(n)])
            for k in next(iter(slot_outs.values()))
        }

    def warmup(
        self,
        example_shapes: Sequence[Sequence[int]],
        widths: Optional[Sequence[int]] = None,
        arena: Optional[bool] = None,
    ) -> Dict[str, float]:
        """Run every serving shape once before live traffic: the mask-free
        dense micro-batch at the declared shapes, one masked micro-batch per
        bucket width (which also builds the CUDA kernels on first use), and
        with an arena (``arena``: default, iff ``feature_arena`` was given)
        one arena micro-batch per width.

        ``example_shapes`` are per-sample trailing shapes, one per modality,
        e.g. ``[(1, 2000), (4096, 2048)]``. Returns ``{"programs": distinct
        micro-batch signatures served, "seconds": wall time}``.
        """
        t0 = time.perf_counter()
        bs = self.batch_size
        shapes = [tuple(int(d) for d in s) for s in example_shapes]
        n_mod = len(shapes)
        lead = [np.zeros((bs,) + s, np.float32) for s in shapes[:-1]]
        pres = np.ones((bs, n_mod), np.float32)
        if widths is not None:
            widths = [int(w) for w in widths]
        elif self.bucket_boundaries:
            widths = list(self.bucket_boundaries)
        else:
            widths = [shapes[-1][0]]
        dim = shapes[-1][-1]
        dense = np.zeros((bs,) + shapes[-1], np.float32)
        self._microbatched(bs, lead + [dense], pres, [None] * n_mod, True)
        for w in widths:
            bag = np.zeros((bs, w, dim), np.float32)
            masks = [None] * (n_mod - 1) + [np.ones((bs, w), bool)]
            self._microbatched(bs, lead + [bag], pres, masks, False)
        warm_arena = (self._arena is not None) if arena is None else arena
        if warm_arena:
            for w in widths:
                self.predict_from_arena(lead, np.zeros(bs, np.int32), np.full(bs, w, np.int32),
                                        presence=pres)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return {"programs": len(self._signatures), "seconds": time.perf_counter() - t0}

    def _microbatched(self, n, full, pres, masks, masks_absent):
        return serve_microbatched(
            self._predict, n, full, pres, masks, masks_absent,
            self.batch_size, self.compute_dtype, self.device,
        )


def serve_microbatched(
    predict_fn, n, full, pres, masks, masks_absent, batch_size, compute_dtype, device,
):
    """Pad/split n requests into fixed micro-batches and reassemble outputs.

    The last micro-batch is padded by repeating its last row; padded rows
    are dropped from the outputs.
    """
    outs: List[Dict[str, np.ndarray]] = []
    bs = batch_size
    dtype = compute_dtype or torch.float32
    to_dev = lambda a, dt: torch.as_tensor(a).to(device=device).to(dt)
    for start in range(0, n, bs):
        sel = slice(start, min(start + bs, n))
        cur = [t[sel] for t in full]
        cur_pres = pres[sel]
        cur_masks = [None if m is None else m[sel] for m in masks]
        pad = bs - cur[0].shape[0]
        if pad > 0:
            cur = [np.concatenate([t, np.repeat(t[-1:], pad, 0)]) for t in cur]
            cur_pres = np.concatenate([cur_pres, np.repeat(cur_pres[-1:], pad, 0)])
            cur_masks = [
                None if m is None else np.concatenate([m, np.repeat(m[-1:], pad, 0)])
                for m in cur_masks
            ]
        batch_tensors = tuple(to_dev(t, dtype) for t in cur)
        jm = (
            None if masks_absent
            else tuple(None if m is None else to_dev(m, torch.bool) for m in cur_masks)
        )
        result = predict_fn(batch_tensors, to_dev(cur_pres, torch.float32), jm)
        keep = bs - pad if pad else bs
        outs.append({k: v[:keep].cpu().numpy() for k, v in result.items()})
    return {k: np.concatenate([o[k] for o in outs]) for k in outs[0]}
