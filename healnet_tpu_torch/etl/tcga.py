"""TCGA multimodal survival dataset: omics tables and WSI patch features.

Counterpart of ``healnet_tpu/etl/tcga.py``, with the same tree layout,
batches and arena, and no pandas or h5py:

- the omics CSV (``omic/tcga_<ds>_all_clean.csv.zip``) is read with
  :mod:`zipfile` and :mod:`csv` (:class:`~healnet_tpu_torch.etl.table.Table`);
  missing values take their column's mean, rows are filtered by modality
  overlap with the JAX package's row-count rule, survival is discretised
  (:func:`~healnet_tpu_torch.etl.datasets.discretize_survival`), and with
  ``log_dir`` set the overlap table is written back as a zipped CSV;
- the omic tensor is ``(n, 1, feat)`` (features as channels of one token)
  or ``(n, feat, 1)`` per ``omic_attention``;
- the slides are the names of the ``.h5`` files under ``patches/`` (only
  the names are read); their features come from
  ``patch_features/<slide_id>.npy`` or ``.pt`` (``torch.load(...,
  weights_only=True)``), as ``(n_patches, dim)`` tokens with
  ``patch_attention`` or ``(dim, n_patches)`` channels without;
- bag sizes are scanned from the ``.npy`` headers; length buckets
  (``suggest_bucket_boundaries``, rounded up to 128 as in JAX, so both
  packages pick the same buckets), ``count_batches``, ``iter_batches`` and
  ``_build_batch`` in both layouts, the packed ``feature_arena`` with
  ``adopt_device_arena`` (the Pipeline hands it the arena on the device,
  from :func:`healnet_tpu_torch.parallel.arena.place_arena`), ``take`` and
  ``materialize``.

Raw slides (``load_wsi``, ``get_resize_dims``) need the OpenSlide binding,
which comes with ``etl/slides.py`` (``ROADMAP.md``, Queue 1 item 9); they
raise until then.
"""

from __future__ import annotations

import os
import warnings
from collections import OrderedDict
from pathlib import Path
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from healnet_tpu_torch.etl.base import Dataset
from healnet_tpu_torch.etl.datasets import discretize_survival
from healnet_tpu_torch.etl.table import Table
from healnet_tpu_torch.utils.config import flatten_config

_NON_FEATURE_COLS = [
    "site", "oncotree_code", "case_id", "slide_id", "train",
    "censorship", "survival_months", "y_disc",
]
_SLIDES_ITEM = ("raw whole-slide images need the OpenSlide binding, which comes with "
                "etl/slides.py (ROADMAP.md, Queue 1 item 9)")


class LRUCache:
    """Single-process LRU for decoded patch-feature tensors."""

    def __init__(self, capacity: int = 256):
        self.capacity = capacity
        self._store: "OrderedDict[Any, np.ndarray]" = OrderedDict()

    def get(self, key):
        if key in self._store:
            self._store.move_to_end(key)
            return self._store[key]
        return None

    def set(self, key, value) -> None:
        if key in self._store:
            self._store.move_to_end(key)
        self._store[key] = value
        while len(self._store) > self.capacity:
            self._store.popitem(last=False)

    def __contains__(self, key) -> bool:
        return key in self._store

    def __len__(self) -> int:
        return len(self._store)


class DatasetView:
    """Index-subset view over a dataset exposing the streaming batch API."""

    def __init__(self, parent, indices: np.ndarray):
        self.parent = parent
        self.indices = np.asarray(indices)

    def __len__(self) -> int:
        return len(self.indices)

    def __getitem__(self, i: int):
        return self.parent[int(self.indices[i])]

    def iter_batches(self, batch_size: int, shuffle: bool = False, rng=None, **kw):
        return self.parent.iter_batches(
            batch_size, indices=self.indices, shuffle=shuffle, rng=rng, **kw
        )

    def materialize(self):
        return self.parent.materialize(self.indices)


class TCGADataset(Dataset):
    """TCGA omics + WSI-patch survival dataset."""

    def __init__(
        self,
        dataset: str,
        config,
        level: int = 2,
        filter_overlap: bool = True,
        survival_analysis: bool = True,
        num_classes: int = 2,
        n_bins: int = 4,
        sources: Sequence[str] = ("omic", "slides"),
        log_dir=None,
        cache_capacity: int = 256,
        native_cache_mb: Optional[int] = 2048,
        max_patches: Optional[int] = None,
    ):
        # max_patches: pad / truncate ragged bags to this static width and
        # emit per-sample KV masks; None: the largest bag of the header scan
        valid_sources = ("omic", "slides")
        if not all(s in valid_sources for s in sources):
            raise ValueError(f"Invalid source specified. Valid sources are {list(valid_sources)}")
        self.config = config
        # configs come nested ({"survival": {"subset": ...}}) or dotted
        # ("survival.subset"); read dotted keys (flattening is idempotent)
        cfg = flatten_config(config) if hasattr(config, "items") else flatten_config({})
        self.dataset = dataset
        self.level = level
        self.sources = list(sources)
        self.filter_overlap = filter_overlap
        self.survival_analysis = survival_analysis
        self.num_classes = num_classes
        self.n_bins = n_bins
        self.log_dir = log_dir
        self.subset = cfg.get("survival.subset", "uncensored")

        tcga_path = Path(config["tcga_path"])
        self.raw_path = tcga_path / "wsi" / dataset
        self.prep_path = tcga_path / "wsi" / f"{dataset}_preprocessed_level{level}"
        (self.prep_path / "patch_features").mkdir(parents=True, exist_ok=True)

        patches_dir = self.prep_path / "patches"
        self.slide_ids = [
            p.rsplit(".", 1)[0] for p in sorted(os.listdir(patches_dir))
        ] if patches_dir.exists() else []

        model = cfg.get("model", "healnet")
        self.concat = model in ("fcnn", "healnet_early") and len(self.sources) > 1
        self.model = model
        self.omic_attention = bool(cfg.get("omic_attention", True))
        # patch_attention=True: patches are context tokens (n_patches, dim)
        # with per-sample KV masks for ragged bags; False (the reference's
        # layout): (dim, n_patches), patches as channels zero-padded to a
        # static width
        self.patch_attention = bool(cfg.get("patch_attention", False))
        # device_cache=True: batches carry (patch_offsets, patch_lengths)
        # into the feature arena on the device instead of the slide tensors
        # (see feature_arena); it needs the token layout and a slide source
        dc_requested = bool(cfg.get("data.device_cache", False))
        self.device_cache = (
            dc_requested and self.patch_attention and "slides" in self.sources
            and not self.concat
        )
        if dc_requested and not self.device_cache:
            warnings.warn(
                "data.device_cache requested but disabled: it requires "
                "patch_attention=true, a 'slides' source, and a non-concat "
                "model — this run will stream features host->device every "
                "epoch",
                stacklevel=2,
            )

        self.omic_df = self.load_omic()
        feature_cols = [c for c in self.omic_df.columns if c not in _NON_FEATURE_COLS]
        self.feature_columns = feature_cols
        omic = self.omic_df.matrix(feature_cols).astype(np.float32)
        if model in ("healnet", "healnet_early"):
            # (n, 1, feat) vs (n, feat, 1)
            self.omic_tensor = omic[:, None, :] if self.omic_attention else omic[:, :, None]
        else:
            self.omic_tensor = omic

        self.censorship = self.omic_df["censorship"].astype(np.float32)
        self.survival_months = self.omic_df["survival_months"].astype(np.float32)
        self.y_disc = self.omic_df["y_disc"].astype(np.int32)
        self._cache = LRUCache(cache_capacity)
        fd = cfg.get("data.feature_dtype", "float32")
        self.feature_dtype = np.dtype(str(fd or "float32"))
        self.max_patches = max_patches
        if "slides" in self.sources:
            # always scan: it reads only npy headers and records the bag
            # sizes that bucketing keys on, also under an explicit max_patches
            scanned = self._scan_max_patches()
            if self.max_patches is None:
                self.max_patches = scanned
            if self.patch_attention and self.max_patches is None:
                raise ValueError(
                    "patch_attention needs a static bag width, but no .npy "
                    "patch features were found to scan (a .pt-only tree?). "
                    "Either set data.max_patches explicitly or convert the "
                    "features to .npy (np.save(torch.load(f).numpy()))."
                )
        # the native cache for .npy feature files: a byte-bounded LRU with a
        # prefetch thread pool (cpp/healnet_runtime.cc)
        self._native = None
        if native_cache_mb:
            from healnet_tpu_torch.runtime import NativeFeatureCache, native_available

            if native_available():
                self._native = NativeFeatureCache(capacity_mb=native_cache_mb)

    # ----------------------------------------------------------------- omic
    def load_omic(self, eps: float = 1e-6) -> Table:
        """Load the omics table, impute, overlap-filter, and discretise."""
        data_path = (
            Path(self.config["tcga_path"]) / "omic" / f"tcga_{self.dataset}_all_clean.csv.zip"
        )
        df = Table.read_csv(data_path).fill_missing_with_means()

        if self.filter_overlap and "slide_id" in df:
            # a row-count comparison, as the reference's: omic_available is
            # the list of rows, so duplicate slide_ids count as rows
            slides_available = self.slide_ids
            omic_available = [sid[:-4] for sid in df["slide_id"]]
            overlap = set(slides_available) & set(omic_available)
            if len(slides_available) < len(omic_available):
                keep = {sid + ".svs" for sid in overlap}
                df = df.rows(np.asarray([s in keep for s in df["slide_id"]], dtype=bool))
            elif len(slides_available) > len(omic_available):
                self.slide_ids = sorted(overlap)

        df["y_disc"] = discretize_survival(df, n_bins=self.n_bins, subset=self.subset, eps=eps)
        if self.log_dir is not None:
            df.to_csv(Path(self.log_dir) / f"{self.dataset}_omic_overlap.csv.zip")
        return df

    # --------------------------------------------------------------- slides
    def _npy_path(self, slide_id: str) -> Path:
        return self.prep_path / "patch_features" / f"{slide_id}.npy"

    @property
    def _row_sids(self) -> np.ndarray:
        """Per-row slide ids without their extension (an object array)."""
        cached = getattr(self, "_row_sids_arr", None)
        if cached is None or len(cached) != len(self.omic_df):
            cached = np.asarray(
                [s.rsplit(".", 1)[0] for s in self.omic_df["slide_id"].tolist()], dtype=object
            )
            self._row_sids_arr = cached
        return cached

    def _scan_max_patches(self) -> Optional[int]:
        """Largest bag length across the dataset (reads only npy headers).

        Also records per-slide bag sizes for length-bucketed batching.
        """
        largest = 0
        base = self.prep_path / "patch_features"
        self._bag_sizes: Dict[str, int] = {}
        for sid in self.slide_ids:
            npy = base / f"{sid}.npy"
            if not npy.exists():
                # a .pt (or mixed) tree: no sizes, so no bucketing on a
                # biased subset of them
                self._bag_sizes = {}
                return None
            with open(npy, "rb") as f:
                version = np.lib.format.read_magic(f)
                reader = (
                    np.lib.format.read_array_header_1_0
                    if version == (1, 0)
                    else np.lib.format.read_array_header_2_0
                )
                shape, _, _ = reader(f)
            self._bag_sizes[sid] = int(shape[0])
            self._feature_dim = int(shape[1])  # the arena's width, no data read
            largest = max(largest, shape[0])
        return largest or None

    def _resolve_bucket_boundaries(self, bucket_boundaries) -> List[int]:
        """Sorted, deduped boundaries clamped to ``max_patches``.

        In arena mode a gather wider than the arena's trailing zero rows
        would clamp its start and read other slides' rows.
        """
        boundaries = sorted(set(int(b) for b in bucket_boundaries))
        if self.max_patches is not None:
            boundaries = sorted({min(b, int(self.max_patches)) for b in boundaries})
            if not boundaries or boundaries[-1] < self.max_patches:
                boundaries.append(int(self.max_patches))
        return boundaries

    def _assign_buckets(
        self, idx: np.ndarray, boundaries: List[int], batch_size: int
    ) -> List[Tuple[int, List[int]]]:
        """(boundary, member-chunk) pairs; oversize bags land in the largest
        bucket (and are truncated to it by ``_slide_tensor``)."""
        buckets: Dict[int, List[int]] = {b: [] for b in boundaries}
        for i in idx:
            size = self.bag_size(int(i)) or boundaries[-1]
            boundary = next((b for b in boundaries if size <= b), boundaries[-1])
            buckets[boundary].append(int(i))
        chunks: List[Tuple[int, List[int]]] = []
        for boundary, members in buckets.items():
            for start in range(0, len(members), batch_size):
                chunks.append((boundary, members[start : start + batch_size]))
        return chunks

    def count_batches(
        self,
        indices: Optional[np.ndarray],
        batch_size: int,
        bucket_boundaries: Optional[Sequence[int]] = None,
    ) -> int:
        """Exact batches per epoch: each bucket pads its own remainder, so
        bucketing gives more than ceil(n / batch_size) (the schedule's
        horizon counts these)."""
        idx = np.arange(len(self)) if indices is None else np.asarray(indices)
        if bucket_boundaries and self.patch_attention and getattr(self, "_bag_sizes", None):
            boundaries = self._resolve_bucket_boundaries(bucket_boundaries)
            return len(self._assign_buckets(idx, boundaries, batch_size))
        return int(np.ceil(len(idx) / batch_size))

    def _prefetch_feature_files(self, ids) -> None:
        """Queue feature-file reads on the native cache's thread pool, where
        the load path reads through it (f32 features, no arena)."""
        if (
            self._native is None
            or self.device_cache
            or "slides" not in self.sources
            or self.feature_dtype != np.float32
            or len(ids) == 0
        ):
            return
        paths = [self._npy_path(self._row_sids[int(i)]) for i in ids]
        paths = [p for p in paths if p.exists()]
        if paths:
            self._native.prefetch(paths)

    def suggest_bucket_boundaries(
        self, n_buckets: int = 4, align: int = 128
    ) -> Optional[List[int]]:
        """Bucket boundaries from the bag-size histogram: quantiles of the
        scanned sizes rounded up to multiples of ``align`` (128, as in JAX,
        so both packages choose the same buckets) and capped at
        ``max_patches``; None without bag sizes or without patch_attention."""
        sizes = getattr(self, "_bag_sizes", None)
        if not sizes or not self.patch_attention:
            return None
        arr = np.asarray(sorted(sizes.values()))
        qs = np.quantile(arr, np.linspace(0, 1, n_buckets + 1)[1:])
        cap = self.max_patches or int(arr[-1])
        return sorted({min(int(np.ceil(q / align)) * align, cap) for q in qs})

    def bag_size(self, index: int) -> Optional[int]:
        sizes = getattr(self, "_bag_sizes", None)
        if not sizes:
            return None
        return sizes.get(self._row_sids[index])

    def load_patch_features(self, slide_id: str) -> np.ndarray:
        """A slide's patch features, (n_patches, feat_dim), in
        ``feature_dtype`` (config ``data.feature_dtype``, default float32;
        float16 halves the host-to-device stream; the model casts on the
        device)."""
        base = self.prep_path / "patch_features"
        npy = base / f"{slide_id}.npy"
        if npy.exists():
            # the native cache decodes to f32; use it only when f32 is wanted
            if self._native is not None and self.feature_dtype == np.float32:
                try:
                    feats = self._native.load(npy)
                except IOError:
                    # its parser takes little-endian f4 / f8 in C order only
                    feats = np.load(npy)
            else:
                feats = np.load(npy)
        else:
            import torch

            with open(base / f"{slide_id}.pt", "rb") as f:
                feats = torch.load(f, weights_only=True).numpy()
        return np.asarray(feats, dtype=self.feature_dtype)

    # ---------------------------------------------------- device-side arena
    def _arena_index(self) -> Tuple[np.ndarray, np.ndarray]:
        """(offsets, lengths) int32 per dataset index, from the header scan
        (no feature IO); lengths capped at ``max_patches`` as
        :meth:`_slide_tensor` truncates."""
        if getattr(self, "_arena_offsets", None) is not None:
            return self._arena_offsets, self._arena_lengths
        sizes = getattr(self, "_bag_sizes", None)
        if not sizes:
            raise ValueError("device_cache needs .npy patch features (bag sizes scanned "
                             "from headers); the .pt-only layout is not supported")
        # duplicate slide_ids share one arena segment
        lengths = np.empty(len(self), dtype=np.int32)
        offsets = np.empty(len(self), dtype=np.int32)
        seg_offset: Dict[str, int] = {}
        cursor = 0
        row_sids = self._row_sids
        for i in range(len(self)):
            sid = row_sids[i]
            if sid not in sizes:
                raise ValueError(f"device_cache: no .npy patch features for slide {sid} "
                                 "(mixed .npy/.pt trees are not supported)")
            n = int(sizes[sid])
            lengths[i] = min(n, self.max_patches) if self.max_patches else n
            if sid not in seg_offset:
                seg_offset[sid] = cursor
                cursor += int(lengths[i])
            offsets[i] = seg_offset[sid]
        self._arena_rows = cursor
        self._arena_offsets, self._arena_lengths = offsets, lengths
        return offsets, lengths

    def feature_arena(self) -> Tuple[Any, np.ndarray, np.ndarray]:
        """(arena, offsets, lengths): every slide's patch features, packed.

        ``arena`` is ``(sum(lengths) + max_patches, feature_dim)`` in
        ``feature_dtype``: the trailing ``max_patches`` zero rows keep a
        fixed-width gather window starting at any offset in bounds (rows
        outside a bag are masked by the KV masks). The trainer uploads it
        once; epochs then stream only indices. Built lazily and kept, so
        k-fold views share one copy; after :meth:`adopt_device_arena` it is
        the device copy.
        """
        if getattr(self, "_arena", None) is not None:
            return self._arena, self._arena_offsets, self._arena_lengths
        offsets, lengths = self._arena_index()
        pad = int(self.max_patches or 0)
        total = self._arena_rows + pad
        dim = int(self._feature_dim)  # recorded by the npy-header scan
        arena = np.zeros((total, dim), dtype=self.feature_dtype)
        written = set()
        row_sids = self._row_sids
        for i in range(len(self)):
            sid = row_sids[i]
            if sid in written:
                continue  # duplicate omic rows share the segment
            written.add(sid)
            feats = self.load_patch_features(sid)[: lengths[i]]
            arena[offsets[i] : offsets[i] + lengths[i]] = feats
        self._arena = arena
        return arena, offsets, lengths

    def adopt_device_arena(self, device_arena) -> None:
        """Swap the kept host arena for another copy: the Pipeline hands it
        the arena on the device (a tensor or a ``QuantizedContext``) after
        the one upload, and the host pack is released."""
        self._arena = device_arena

    def _slide_tensor(self, index: int, pad_to: Optional[int] = None) -> Tuple[np.ndarray, int]:
        """(static-shape slide tensor, n_valid_patches): a ragged bag padded
        to ``pad_to`` (default ``max_patches``). The LRU keeps the raw
        features by index; padding and transposing happen per emit."""
        pad_to = pad_to if pad_to is not None else self.max_patches
        feats = self._cache.get(index)
        if feats is None:
            feats = self.load_patch_features(self._row_sids[index])  # (n_patches, dim)
            self._cache.set(index, feats)
        n_valid = feats.shape[0]
        if pad_to is not None:
            if n_valid > pad_to:
                feats = feats[:pad_to]
                n_valid = pad_to
            elif n_valid < pad_to:
                feats = np.pad(feats, ((0, pad_to - n_valid), (0, 0)))
        if self.patch_attention:
            tensor = np.ascontiguousarray(feats)      # (tokens, channels)
        else:
            tensor = np.ascontiguousarray(feats.T)    # (dim, n_patches)
        return tensor, n_valid

    # ------------------------------------------------------------- indexing
    def __len__(self) -> int:
        if self.sources == ["omic"]:
            return len(self.omic_df)
        return len(self.slide_ids)

    def __getitem__(self, index: int):
        tensors, censorship, event_time, y_disc, _ = self._sample(index)
        return tensors, censorship, event_time, y_disc

    def _sample(self, index: int, pad_to: Optional[int] = None):
        """([tensors], censorship, event_time, y_disc, n_valid_patches|None)."""
        y_disc = self.y_disc[index]
        censorship = self.censorship[index]
        event_time = self.survival_months[index]

        if self.sources == ["omic"]:
            return [self.omic_tensor[index]], censorship, event_time, y_disc, None

        if self.sources == ["slides"]:
            slide, n_valid = self._slide_tensor(index, pad_to)
            if self.model == "fcnn":
                slide = slide.reshape(-1)
            return [slide], censorship, event_time, y_disc, n_valid

        omic = self.omic_tensor[index]
        slide, n_valid = self._slide_tensor(index, pad_to)
        if self.concat:  # early fusion
            concat = np.concatenate([omic.reshape(-1), slide.reshape(-1)])
            if self.model == "healnet_early":
                concat = concat[None, :]
            return [concat], censorship, event_time, y_disc, None
        return [omic, slide], censorship, event_time, y_disc, n_valid

    # ------------------------------------------------------------- batching
    def iter_batches(
        self,
        batch_size: int,
        indices: Optional[np.ndarray] = None,
        shuffle: bool = False,
        rng: Optional[np.random.Generator] = None,
        drop_remainder: bool = False,
        bucket_boundaries: Optional[Sequence[int]] = None,
    ) -> Iterator[Dict[str, Any]]:
        """Static-shape trainer batches (pad + mask), streaming from disk.

        ``bucket_boundaries`` (patch_attention only): samples grouped by bag
        size, each batch padded only to its bucket's boundary.
        """
        # a copy: shuffling never mutates the caller's indices
        idx = np.arange(len(self)) if indices is None else np.array(indices)
        rng = rng or np.random.default_rng()
        if shuffle:
            rng.shuffle(idx)

        if bucket_boundaries and self.patch_attention and getattr(self, "_bag_sizes", None):
            boundaries = self._resolve_bucket_boundaries(bucket_boundaries)
            chunks = self._assign_buckets(idx, boundaries, batch_size)
            if shuffle:
                rng.shuffle(chunks)
            for j, (boundary, sel) in enumerate(chunks):
                if drop_remainder and len(sel) < batch_size:
                    continue
                # overlap the next chunk's feature-file IO with this one
                if j + 1 < len(chunks):
                    self._prefetch_feature_files(chunks[j + 1][1])
                yield self._build_batch(np.asarray(sel), batch_size, pad_to=boundary)
            return

        for start in range(0, len(idx), batch_size):
            sel = idx[start : start + batch_size]
            if drop_remainder and sel.shape[0] < batch_size:
                return
            self._prefetch_feature_files(idx[start + batch_size : start + 2 * batch_size])
            yield self._build_batch(sel, batch_size, pad_to=None)

    def _build_batch(
        self, sel: np.ndarray, batch_size: int, pad_to: Optional[int]
    ) -> Dict[str, Any]:
        pad = batch_size - sel.shape[0]
        mask = np.ones(batch_size, dtype=np.float32)
        if pad > 0:
            sel = np.concatenate([sel, np.repeat(sel[-1:], pad)])
            mask[batch_size - pad :] = 0.0

        if self.device_cache:
            # arena mode: no feature IO; the batch carries indices into the
            # arena on the device and the trainer gathers the bags there.
            # The KV mask's width is the bucket boundary.
            offsets, lengths = self._arena_index()
            width = int(pad_to if pad_to is not None else self.max_patches)
            n_valid = np.minimum(lengths[sel], width).astype(np.int32)
            batch = {
                "tensors": (
                    (np.stack([self.omic_tensor[int(i)] for i in sel]),)
                    if "omic" in self.sources
                    else ()
                ),
                "censorship": self.censorship[sel].astype(np.float32),
                "event_time": self.survival_months[sel].astype(np.float32),
                "y_disc": self.y_disc[sel].astype(np.int32),
                "sample_mask": mask,
                "patch_offsets": offsets[sel].astype(np.int32),
                "patch_lengths": n_valid,
            }
            kv_masks: List[Optional[np.ndarray]] = [None] * (len(batch["tensors"]) + 1)
            kv_masks[-1] = np.arange(width)[None, :] < n_valid[:, None]
            batch["kv_masks"] = tuple(kv_masks)
            return batch

        samples = [self._sample(int(i), pad_to=pad_to) for i in sel]
        n_mod = len(samples[0][0])
        batch = {
            "tensors": tuple(np.stack([s[0][m] for s in samples]) for m in range(n_mod)),
            "censorship": np.asarray([s[1] for s in samples], np.float32),
            "event_time": np.asarray([s[2] for s in samples], np.float32),
            "y_disc": np.asarray([s[3] for s in samples], np.int32),
            "sample_mask": mask,
        }
        if self.patch_attention and samples[0][4] is not None:
            # ragged bags: per-sample token masks over the patch axis
            width = pad_to if pad_to is not None else self.max_patches
            n_valid = np.asarray([s[4] for s in samples])
            kv_masks = [None] * n_mod
            kv_masks[-1] = np.arange(width)[None, :] < n_valid[:, None]
            batch["kv_masks"] = tuple(kv_masks)
        return batch

    def materialize(self, indices: Optional[np.ndarray] = None) -> Dict[str, Any]:
        """Whole-split arrays for in-memory training (small datasets only)."""
        idx = np.arange(len(self)) if indices is None else np.asarray(indices)
        samples = [self._sample(int(i)) for i in idx]
        n_mod = len(samples[0][0])
        out = {
            "tensors": tuple(np.stack([s[0][m] for s in samples]) for m in range(n_mod)),
            "censorship": np.asarray([s[1] for s in samples], np.float32),
            "event_time": np.asarray([s[2] for s in samples], np.float32),
            "y_disc": np.asarray([s[3] for s in samples], np.int32),
        }
        if self.patch_attention and samples[0][4] is not None:
            n_valid = np.asarray([s[4] for s in samples])
            kv_masks = [None] * n_mod
            kv_masks[-1] = np.arange(self.max_patches)[None, :] < n_valid[:, None]
            out["kv_masks"] = tuple(kv_masks)
        return out

    def take(self, indices: np.ndarray) -> "DatasetView":
        """Lightweight split view sharing this dataset's cache (fold splits)."""
        return DatasetView(self, np.asarray(indices))

    # ------------------------------------------------------------- raw WSIs
    def get_slide_paths(self) -> Dict[str, Path]:
        """{slide filename: path} over the gdc download tree."""
        return {p.name: p for p in self.raw_path.glob("**/*.svs")}

    def get_resize_dims(self, level: int, patch_height: int = 128, patch_width: int = 128,
                        override: bool = False, slide=None):
        """Level dims rounded to patch multiples; not ported yet."""
        raise NotImplementedError(_SLIDES_ITEM)

    def load_wsi(self, slide_id: str, level: Optional[int] = None):
        """A whole slide at a pyramid level; not ported yet."""
        raise NotImplementedError(_SLIDES_ITEM)

    # ---------------------------------------------------------------- info
    def get_info(self, full_detail: bool = False) -> Dict[str, Any]:
        """Dataset summary, printed and returned."""
        bins, counts = np.unique(self.omic_df["y_disc"], return_counts=True)
        info = {
            "dataset": self.dataset.upper(),
            "molecular_shape": tuple(self.omic_df.shape),
            "n_slides": len(self.slide_ids),
            "sources": self.sources,
            "censored_share": float(np.round((self.omic_df["censorship"] == 1).mean(), 3)),
            "survival_bin_sizes": {int(b): int(c) for b, c in zip(bins, counts)},
        }
        for key, value in info.items():
            print(f"{key}: {value}")
        return info
