"""The general generator of fold-training traffic: a synthetic cohort, its
int8 patch-feature arena on the device, and the splits a k-fold run trains
and validates on, all from a mix file's parameters and ``--seed``.

Bag lengths are the same for every seed: ``n`` stratified quantiles of
the mix's length distribution (``log_normal``: a median and a sigma, as
``scripts/gen_dress_data.py`` draws the full-scale run's bags;
``log_uniform``), clipped to [min, max] and dealt to the patients in one
fixed order, so that with the pipeline's fold splits every seed carries
the same work; the seed changes the batches' order (the trainer's
shuffles), the features, the labels and the weights. Survival labels
(event times, censoring, discrete bins) and omic vectors are drawn on the
host; the arena (every bag's per-token int8 values and f32 scales back to
back, then ``max`` zero rows, as the port's arena layout has it) is drawn
on the device with a ``torch.Generator``.

The mix's ``trainer.arena`` says how the trainer sees the bags:
``"int8"``, the arena resident on the device (batches carry offsets into
it); ``"none"``, host float16 bags in every batch, as the pipeline streams
them from feature files (the dequantized arena, copied to the host once).

:class:`ArenaSplit` hands a split to the trainer as a streaming source
with ``iter_batches``: batches grouped by bucket boundary, padded to the
batch size by repeating the last patient under a zero ``sample_mask``,
shuffled within buckets and across batches (the arithmetic of the port's
TCGA dataset). :func:`train_val_test_split` and :func:`class_weights` are
the pipeline's.
"""

from __future__ import annotations

from statistics import NormalDist
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

#: the trainer's views of the bags (a mix's ``trainer.arena``)
ARENA_MODES = ("int8", "none")


def bag_lengths(n: int, mix: dict) -> np.ndarray:
    """``n`` stratified quantiles of the mix's bag-length distribution,
    clipped to [min, max], ascending, int32."""
    spec = mix["bag_patches"]
    u = (np.arange(n) + 0.5) / n
    if spec["distribution"] == "log_normal":
        z = np.array([NormalDist().inv_cdf(float(x)) for x in u])
        raw = np.exp(np.log(spec["median"]) + spec["sigma"] * z)
    elif spec["distribution"] == "log_uniform":
        lo, hi = np.log(spec["min"]), np.log(spec["max"])
        raw = np.exp(lo + u * (hi - lo))
    else:
        raise ValueError(f"unknown bag-length distribution {spec['distribution']!r}")
    return np.clip(np.round(raw), spec["min"], spec["max"]).astype(np.int32)


def fold_seed(seed: int, k: int) -> int:
    """The ``k``-th seed drawn from a run's ``--seed`` (weights, the check's
    trainer seed, each fold's)."""
    return int(np.random.SeedSequence([seed, 7, k]).generate_state(1)[0])


def train_val_test_split(n: int, train: float = 0.7, test: float = 0.15, seed: int = 0):
    """The pipeline's split: (train, test, val) index arrays of a seeded permutation."""
    idx = np.random.default_rng(seed).permutation(n)
    n_train, n_test = int(round(train * n)), int(round(test * n))
    return idx[:n_train], idx[n_train:n_train + n_test], idx[n_train + n_test:]


def class_weights(y: np.ndarray, n_bins: int) -> np.ndarray:
    """Inverse class frequencies (an absent bin takes the rarest count)."""
    counts = np.bincount(np.asarray(y, np.int64), minlength=n_bins)[:n_bins].astype(np.float64)
    missing = counts == 0
    if missing.any():
        counts[missing] = max(counts[~missing].min(), 1.0) if (~missing).any() else 1.0
    return 1.0 / counts


class Cohort:
    """Patients' host data and the device arena of their bags."""

    def __init__(self, cfg: dict, mix: dict, seed: int, device):
        n, rng = int(cfg["cohort"]), np.random.default_rng([seed, 0])
        self.n, self.mix, self.device = n, mix, torch.device(device)
        self.lengths = bag_lengths(n, mix)[np.random.default_rng(0).permutation(n)]
        self.offsets = np.concatenate([[0], np.cumsum(self.lengths)[:-1]]).astype(np.int64)
        if self.offsets[-1] + self.lengths[-1] >= 2**31:
            raise ValueError("arena offsets exceed int32")
        self.offsets = self.offsets.astype(np.int32)
        self.omic = rng.standard_normal((n, 1, int(cfg["omic_dim"])), dtype=np.float32)
        self.event_time = rng.uniform(1.0, float(cfg["follow_up_months"]), n).astype(np.float32)
        self.censorship = (rng.uniform(size=n) < float(cfg["censored_share"])).astype(np.float32)
        bins = int(cfg["output_dims"])
        events = self.event_time[self.censorship == 0]
        edges = np.quantile(events if events.size else self.event_time,
                            np.arange(1, bins) / bins)
        self.y_disc = np.digitize(self.event_time, edges).astype(np.int32)
        rows = int(self.lengths.sum()) + int(mix["bag_patches"]["max"])
        gen = torch.Generator(device=self.device).manual_seed(int(seed) + 1)
        data = torch.empty((rows, int(cfg["wsi_dim"])), dtype=torch.int8, device=self.device)
        data.random_(0, 128, generator=gen)
        scale = torch.empty((rows,), dtype=torch.float32, device=self.device)
        scale.uniform_(*cfg["feature_scale"], generator=gen)
        tail = int(self.lengths.sum())
        data[tail:] = 0
        scale[tail:] = 0.0
        self.arena = (data, scale)
        mode = mix["trainer"]["arena"]
        if mode not in ARENA_MODES:
            raise ValueError(f"unknown trainer.arena {mode!r}; known: {ARENA_MODES}")
        self.host_bags = None
        if mode == "none":  # the dequantized arena as float16, once, in blocks of rows
            self.host_bags = np.empty(tuple(data.shape), np.float16)
            for at in range(0, rows, 1 << 16):
                block = data[at:at + (1 << 16)].float() * scale[at:at + (1 << 16), None]
                self.host_bags[at:at + (1 << 16)] = block.half().cpu().numpy()

    def bucket(self, length: int, boundaries: Sequence[int]) -> int:
        return next((b for b in boundaries if length <= b), boundaries[-1])

    def arena_batch(self, sel: Sequence[int], width: int, batch_size: int) -> dict:
        """The trainer's host batch of patients ``sel`` in arena form (offsets
        into the arena), padded to the batch size and the gather width
        ``width``."""
        sel = [int(i) for i in sel]
        mask = np.ones(batch_size, np.float32)
        mask[len(sel):] = 0.0
        sel = np.asarray(sel + [sel[-1]] * (batch_size - len(sel)))
        n_valid = np.minimum(self.lengths[sel], width).astype(np.int32)
        return {"tensors": (self.omic[sel],),
                "kv_masks": (None, np.arange(width)[None, :] < n_valid[:, None]),
                "patch_offsets": self.offsets[sel], "patch_lengths": n_valid,
                "y_disc": self.y_disc[sel], "censorship": self.censorship[sel],
                "event_time": self.event_time[sel], "sample_mask": mask}

    def batch(self, sel: Sequence[int], width: int, batch_size: int) -> dict:
        """The trainer's host batch of patients ``sel``: in arena form, or
        with the float16 bags themselves (zero past each) when streamed."""
        out = self.arena_batch(sel, width, batch_size)
        if self.host_bags is None:
            return out
        bags = np.zeros((batch_size, width, self.host_bags.shape[1]), np.float16)
        for row, (at, k) in enumerate(zip(out.pop("patch_offsets"), out.pop("patch_lengths"))):
            bags[row, :k] = self.host_bags[at:at + k]
        out["tensors"] = out["tensors"] + (bags,)
        return out

    def widest_batch(self) -> dict:
        """The arena batch of the first patients in the widest bucket."""
        bounds, b = sorted(self.mix["bucket_boundaries"]), int(self.mix["batch_size"])
        sel = [i for i in range(self.n)
               if self.bucket(int(self.lengths[i]), bounds) == bounds[-1]][:b]
        return self.arena_batch(sel, bounds[-1], b)

    def gather(self, hb: dict):
        """(omic, int8 values, scales zeroed past each bag, key mask) of an
        arena batch's patients, on the device."""
        data, scale = self.arena
        mask = torch.as_tensor(hb["kv_masks"][-1], device=self.device)
        index = (torch.as_tensor(hb["patch_offsets"], device=self.device).long()[:, None]
                 + torch.arange(mask.shape[1], device=self.device))
        omic = torch.as_tensor(hb["tensors"][0], device=self.device).float()
        return omic, data[index], scale[index] * mask, mask

    def device_batch(self, hb: dict) -> Dict[str, torch.Tensor]:
        """A host batch as the reference reads it: omic, the slide as the
        trainer is given it (the dequantized arena rows, or the streamed
        float16 bag), zero past each bag, its mask and the labels, on the
        device."""
        put = lambda k: torch.as_tensor(hb[k], device=self.device)
        if "patch_offsets" in hb:
            omic, values, scales, mask = self.gather(hb)
            slide = values.float() * scales[..., None]
        else:
            omic, slide = (torch.as_tensor(t, device=self.device).float() for t in hb["tensors"])
            mask = torch.as_tensor(hb["kv_masks"][-1], device=self.device)
        return {"omic": omic, "slide": slide, "mask": mask, "y_disc": put("y_disc"),
                "censorship": put("censorship"), "sample_mask": put("sample_mask")}


class ArenaSplit:
    """A split of the cohort as a streaming source of arena batches."""

    def __init__(self, cohort: Cohort, indices: Sequence[int]):
        self.cohort, self.indices = cohort, np.asarray(indices)

    def _chunks(self, idx, batch_size: int, boundaries) -> List[Tuple[int, List[int]]]:
        buckets: Dict[int, List[int]] = {b: [] for b in boundaries}
        for i in idx:
            buckets[self.cohort.bucket(int(self.cohort.lengths[i]), boundaries)].append(int(i))
        return [(b, members[s:s + batch_size]) for b, members in buckets.items()
                for s in range(0, len(members), batch_size)]

    def count_batches(self, indices, batch_size: int, bucket_boundaries) -> int:
        return len(self._chunks(self.indices, batch_size, sorted(bucket_boundaries)))

    def iter_batches(self, batch_size: int, shuffle: bool = False,
                     rng: Optional[np.random.Generator] = None,
                     bucket_boundaries: Sequence[int] = ()) -> Iterator[dict]:
        idx = np.array(self.indices)
        rng = rng or np.random.default_rng()
        if shuffle:
            rng.shuffle(idx)
        chunks = self._chunks(idx, batch_size, sorted(bucket_boundaries))
        if shuffle:
            rng.shuffle(chunks)
        for width, sel in chunks:
            yield self.cohort.batch(sel, width, batch_size)


class StepFeed:
    """The correctness check's source: epoch ``e`` is one step on batch ``e``."""

    def __init__(self, batches: List[dict]):
        self.batches, self.epoch = batches, 0

    def count_batches(self, indices, batch_size: int, bucket_boundaries) -> int:
        return 1

    def iter_batches(self, batch_size: int, shuffle: bool = False, rng=None,
                     bucket_boundaries=()) -> Iterator[dict]:
        self.epoch += 1
        yield self.batches[self.epoch - 1]


def check_batches(cohort: Cohort, train_idx: np.ndarray, mix: dict, seed: int) -> List[dict]:
    """The check's batches: ``rounds`` rounds of one batch in each of the
    check's ``buckets``, in that order, of distinct patients drawn from the
    seed among the training split's bags of each bucket. The first round
    runs each bucket's first step (eager, then the capture), the later ones
    replay each bucket's captured step."""
    spec, bounds = mix["check"], sorted(mix["bucket_boundaries"])
    bs, rounds = int(mix["batch_size"]), int(spec["rounds"])
    rng = np.random.default_rng([seed, 1])
    picks = {}
    for width in spec["buckets"]:
        pool = [int(i) for i in train_idx
                if cohort.bucket(int(cohort.lengths[i]), bounds) == width]
        if len(pool) < rounds * bs:
            raise ValueError(f"the check needs {rounds * bs} patients in bucket {width}, the "
                             f"split has {len(pool)}")
        picks[width] = rng.choice(pool, size=rounds * bs, replace=False)
    return [cohort.batch(picks[w][r * bs:(r + 1) * bs], w, bs)
            for r in range(rounds) for w in spec["buckets"]]
