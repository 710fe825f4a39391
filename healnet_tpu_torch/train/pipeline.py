"""Experiment pipeline: config validation, k-fold training, model factory.

Counterpart of ``healnet_tpu/train/pipeline.py``:

- config whitelisting, dotted-key flattening, per-dataset hyperparameters
  under ``model_params``;
- the k-fold loop with per-fold seeds and splits, the cross-fold mean and
  std of the c-indices, the best fold and the missing-modality means;
- the model factory, shaped from the first batch: ``healnet`` and
  ``healnet_early`` (:class:`healnet_tpu_torch.models.healnet.HealNetModule`,
  ``precision: bf16`` computing in ``torch.bfloat16``) and the baselines
  (:mod:`healnet_tpu_torch.models.baselines`: ``fcnn``, ``mcat`` as MCAT,
  SNN or MILAttentionNet by the sources, ``mm_prognosis``, ``motcat``,
  ``multimodn``, trained with the trainer's ``aux_loss``), the bag
  baselines told the slide layout by ``patch_attention``;
- explainer artifacts: the best fold's weights
  (:class:`~healnet_tpu_torch.train.checkpoint.Checkpointer`),
  ``config.pkl`` and ``test_data_indices.pkl``;
- one :class:`~healnet_tpu_torch.train.loop.SurvivalTrainer` reused across
  folds (``set_fold``), with ``data.device_cache`` (the feature arena
  uploaded to the device once a run), ``data.quantize_arena`` (int8 rows and
  f32 scales, quantized on the device as the rows arrive, bit-equal to the
  JAX package's host quantization; the HealNet pair only, ignored with
  JAX's message for the baselines) and ``train_loop.fused_epochs``;
- per-fold checkpoint directories under the run's log directory, so a
  relaunch with the same ``run_name`` resumes (``train_loop.resume``);
- logging through :class:`healnet_tpu_torch.utils.Tracker`.

The pipeline runs on the GPU unless ``device="cpu"`` is asked for.

``spmd: true``: the trainer runs on :func:`healnet_tpu_torch.parallel.mesh.
make_mesh` over the world's processes, one a device (launch with
``torchrun --nproc_per_node=N -m healnet_tpu_torch.cli.main ...``; NCCL on
the cards, gloo with ``--device cpu``); ``data.shard_arena: true`` with it
splits the feature arena's rows over the mesh's ``seq`` axis, built once a
run (and kept in ``_DATASET_CACHE``) under the mesh's shape and the halo
(the widest bucket, ``data.max_patches`` or bag). Rank 0 writes the logs,
the tracker's files and the explainer's artifacts; every rank agrees on the
run's name. ``explainer: true`` is refused on a mesh with a ``model`` axis
above 1: its weights are split there, and the explainer reloads whole ones.
"""

from __future__ import annotations

import time
from datetime import datetime
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from healnet_tpu_torch.constants import VALID_DATASETS
from healnet_tpu_torch.device import DeviceLike, resolve_device
from healnet_tpu_torch.etl import TCGADataset, class_weights, train_val_test_split
from healnet_tpu_torch.models.baselines import (
    MCAT,
    MOTCAT,
    SNN,
    ClassDecoder,
    MILAttentionNet,
    MLPEncoder,
    MMPrognosis,
    MultiModNModule,
    PatchEncoder,
    RegularizedFCNN,
)
from healnet_tpu_torch.models.healnet import HealNetModule
from healnet_tpu_torch.ops.quantize import QuantizedContext, quantize_context_host
from healnet_tpu_torch.parallel.arena import build_device_arena, place_arena, place_quantized
from healnet_tpu_torch.parallel.mesh import AXIS_MODEL, make_mesh
from healnet_tpu_torch.train.checkpoint import Checkpointer
from healnet_tpu_torch.train.loop import SurvivalTrainer, iterate_batches
from healnet_tpu_torch.utils import Box, Tracker, flatten_config, pickle_obj

# Cross-run dataset cache: a sweep builds a Pipeline per trial, but the
# dataset (the omics join, the survival bins, the bag-size scan and the
# feature arena with its one upload) depends only on the data side of the
# config. Keyed on those fields and the device; holds the most recent
# dataset. `data.cache_dataset: false` turns it off for a run.
_DATASET_CACHE: Dict[str, Any] = {"key": None, "dataset": None, "arena_device": None}

VALID_SOURCES = ["omic", "slides"]
VALID_LOSSES = ["nll", "ce_survival", "cox"]
VALID_MODELS = [
    "healnet", "fcnn", "healnet_early", "mcat", "mm_prognosis", "multimodn", "motcat",
]
VALID_CLASS_WEIGHTS = ["inverse", "inverse_root", "None"]


class Pipeline:
    """Main experimental pipeline for training/evaluating models."""

    def __init__(self, config: Box, args=None, wandb_name: Optional[str] = None,
                 device: DeviceLike = None):
        self.config = flatten_config(config)
        self.dataset = self.config["dataset"]
        self.args = args
        self._check_config()
        self.device = resolve_device(device)
        # spmd: the mesh over the world's processes, before the tracker, so
        # that every rank takes rank 0's run name
        self.mesh = make_mesh(device=self.device) if self.config.get("spmd", False) else None
        if self.config.get("explainer") and self.mesh is not None \
                and self.mesh.shape[AXIS_MODEL] > 1:
            raise ValueError(
                f"explainer: true on a mesh {self.mesh.shape} that splits the weights over "
                "model: the explainer reloads whole weights; run it without spmd, or in a "
                "world whose mesh has no model axis")
        self.output_dims = int(self.config["model_params.output_dims"])
        self.sources = list(self.config["sources"])
        self.local_run_id = datetime.now().strftime("%d-%m-%Y_%H-%M-%S")

        if self.config.get("compilation_cache", True):
            from healnet_tpu_torch.utils.profiling import enable_compilation_cache

            enable_compilation_cache()  # the kernels' builds stay under build/

        self.tracker = Tracker(
            project="healnet_tpu",
            # run_name pins the log and checkpoint directory, so a relaunched
            # process finds the per-fold checkpoints (train_loop.resume)
            name=self._shared(wandb_name or self.config.get("run_name")),
            config=dict(self.config),
            log_dir=self.config.get("log_path", "logs"),
            use_wandb=bool(self.config.get("wandb", False)),
        )
        self.log_dir = self.tracker.log_dir if self.config.get("explainer") else None
        # the dataset is fold-independent (only the split indices differ):
        # built once a run, its arena uploaded once, shared by every fold
        self._dataset = None
        self._arena_device = None
        self._sharded = None  # (key, this rank's block of the sharded arena)
        self._trainer = None
        # seconds spent building the dataset, packing its arena on the host
        # and uploading (and quantizing) it (0.0 when a cached one was
        # reused), and each fold's fit results without the weights
        self.timings: Dict[str, float] = {}
        self.fold_results: List[Dict[str, Any]] = []

    def _check_config(self) -> None:
        """Whitelist validation."""
        if not all(s in VALID_SOURCES for s in self.config["sources"]):
            raise ValueError(f"Invalid source specified. Valid sources are {VALID_SOURCES}")
        if self.config["survival.loss"] not in VALID_LOSSES:
            raise ValueError(f"Invalid survival loss specified. Valid losses are {VALID_LOSSES}")
        if self.config["dataset"] not in VALID_DATASETS:
            raise ValueError(f"Invalid dataset specified. Valid datasets are {VALID_DATASETS}")
        if self.config["model"] not in VALID_MODELS:
            raise ValueError(f"Invalid model specified. Valid models are {VALID_MODELS}")
        if str(self.config["model_params.class_weights"]) not in VALID_CLASS_WEIGHTS:
            raise ValueError(
                f"Invalid class weight specified. Valid weights are {VALID_CLASS_WEIGHTS}")

    def _shared(self, name: Optional[str]) -> Optional[str]:
        """The run's name: on a mesh of several processes, rank 0's (it
        names the log and checkpoint directories)."""
        if self.mesh is None or self.mesh.size == 1 or name is not None:
            return name
        name = [f"run-{datetime.now().strftime('%Y%m%d-%H%M%S')}-{np.random.randint(1 << 24):06x}"]
        dist.broadcast_object_list(name, src=int(self.mesh.devices.flat[0]))
        return name[0]

    def _rank0(self) -> bool:
        return self.mesh is None or self.mesh.rank == int(self.mesh.devices.flat[0])

    # -------------------------------------------------------------- running
    def main(self, sweep_overrides: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        if sweep_overrides:
            for key, value in sweep_overrides.items():
                # every override applies; a new key is created (consumers
                # read config.get) but named, in case it is a typo
                if key not in self.config:
                    print(f"sweep override creates new config key: {key!r}")
                self.config[key] = value
            self.tracker.config.update(sweep_overrides)
            # the trainer was built from the previous hyperparameters, and
            # overrides of the data config invalidate the dataset and arena
            self._trainer = None
            if any(
                k == "dataset" or k == "sources" or k == "model"
                or k.startswith("data.") or k.startswith("survival.")
                or k in ("patch_attention", "omic_attention", "tcga_path")
                for k in sweep_overrides
            ):
                self._dataset = None
                self._arena_device = None
                self._sharded = None

        fold_metrics: Dict[str, List[float]] = {
            "train_c_index": [], "val_c_index": [], "test_c_index": [],
        }
        missing_perfs, fold_params, test_indices = [], [], []

        for fold in range(1, int(self.config["n_folds"]) + 1):
            print(f"*****FOLD {fold}*****")
            np.random.seed(fold)

            train_view, val_view, test_view, cw = self.load_data(fold=fold)
            test_indices.append(np.asarray(test_view.indices))
            trainer = self.make_trainer(train_view, fold=fold, cw=cw)
            res = trainer.fit(
                train_view, val_view, test_view, fold=fold,
                missing_ablation=bool(self.config.get("missing_ablation", False)),
                missing_semantics=str(
                    self.config.get("train_loop.missing_semantics", "semantic")),
            )
            for key in fold_metrics:
                fold_metrics[key].append(res[key])
            if res.get("missing_performance") is not None:
                missing_perfs.append(res["missing_performance"])
            # the trainer keeps training these tensors in the next fold
            fold_params.append({k: v.detach().to("cpu", copy=True)
                                for k, v in res["params"].items()})
            self.fold_results.append({k: v for k, v in res.items() if k != "params"})

        summary = {}
        for key, values in fold_metrics.items():
            # an all-censored split has no c-index (NaN): left out of the mean
            finite = [v for v in values if np.isfinite(v)]
            summary[f"mean_{key}"] = float(np.mean(finite)) if finite else float("nan")
            summary[f"std_{key}"] = float(np.std(finite)) if finite else float("nan")
        if self._rank0():
            self.tracker.log(summary)

        test_c = np.asarray(fold_metrics["test_c_index"], dtype=float)
        best_fold = int(np.nanargmax(test_c)) if np.isfinite(test_c).any() else 0
        if missing_perfs and self._rank0():
            m50, momic, mwsi = np.mean(missing_perfs, axis=0)
            self.tracker.log({
                "missing_50_c_index": float(m50),
                "missing_omic_c_index": float(momic),
                "missing_wsi_c_index": float(mwsi),
            })

        if self.config.get("explainer") and self._rank0():
            ckpt = Checkpointer(Path(self.log_dir) / "checkpoints")
            ckpt.save_best(fold_params[best_fold], metrics=summary)
            pickle_obj(dict(self.config), Path(self.log_dir) / "config.pkl")
            pickle_obj(test_indices[best_fold], Path(self.log_dir) / "test_data_indices.pkl")

        if self._rank0():
            self.tracker.finish()
        summary["best_fold"] = best_fold
        return summary

    # ----------------------------------------------------------------- data
    def _dataset_cache_key(self) -> str:
        """Every config field the dataset's contents depend on, and the
        device its arena lives on."""
        fields = sorted(
            (k, str(v))
            for k, v in self.config.items()
            if k in ("dataset", "sources", "model", "omic_attention", "patch_attention",
                     "tcga_path")
            or k.startswith("data.") or k.startswith("survival.")
        )
        return repr(fields) + f"|bins={self.output_dims}|device={self.device}"

    def load_data(self, fold: int = 1):
        if self._dataset is None:
            key = self._dataset_cache_key()
            # explainer runs write the omic overlap table into this run's
            # log dir while the dataset is built: never from the cache
            use_cache = bool(self.config.get("data.cache_dataset", True)) and not \
                self.config.get("explainer")
            if use_cache and _DATASET_CACHE["key"] == key:
                self._dataset = _DATASET_CACHE["dataset"]
                self._arena_device = _DATASET_CACHE["arena_device"]
                self.timings["dataset_s"] = 0.0
            else:
                max_patches = self.config.get("data.max_patches")
                t0 = time.perf_counter()
                self._dataset = TCGADataset(
                    self.config["dataset"],
                    self.config,
                    level=int(self.config["data.wsi_level"]),
                    survival_analysis=True,
                    sources=self.sources,
                    n_bins=self.output_dims,
                    log_dir=self.log_dir,
                    max_patches=None if max_patches in (None, "None", "null")
                    else int(max_patches),
                )
                self.timings["dataset_s"] = time.perf_counter() - t0
                if use_cache:
                    _DATASET_CACHE.update(key=key, dataset=self._dataset, arena_device=None)
        data = self._dataset
        train_idx, test_idx, val_idx = train_val_test_split(len(data), seed=fold)
        print(
            f"Train samples: {len(train_idx)}, Val samples: {len(val_idx)}, "
            f"Test samples: {len(test_idx)}"
        )
        scheme = str(self.config["model_params.class_weights"])
        cw = class_weights(data.y_disc[train_idx], scheme, n_bins=self.output_dims)
        return data.take(train_idx), data.take(val_idx), data.take(test_idx), cw

    def _compute_dtype(self) -> Optional[torch.dtype]:
        """``precision: bf16`` computes the contexts in bfloat16 (the
        weights stay float32)."""
        precision = str(self.config.get("precision", "fp32")).lower()
        return {"bf16": torch.bfloat16, "bfloat16": torch.bfloat16}.get(precision)

    # ---------------------------------------------------------------- model
    def make_model(self, example_batch: Dict[str, Any], seed: int = 0) -> torch.nn.Module:
        """The configured model, shaped from a batch; its weights drawn from
        a generator seeded with ``seed`` (the fold, as ``set_fold`` draws)."""
        feat = example_batch["tensors"]
        model_name = self.config["model"]
        if model_name not in ("healnet", "healnet_early"):
            return self._make_baseline(example_batch, torch.Generator().manual_seed(seed))

        def mp(key):
            return self.config[f"model_params.{key}"]

        # arena-mode batches carry indices instead of the slide tensor; the
        # feature dim comes from the arena itself (always the last modality)
        slide_dim = example_batch.get("arena_dim")
        if slide_dim is None and len(feat) > 1:
            slide_dim = feat[1].shape[2]
        if model_name == "healnet" and len(self.sources) == 2:
            input_channels = (feat[0].shape[2], slide_dim)
            input_axes, modalities = (1, 1), 2
        else:  # one source, or the early-fusion concat (slides-only arena
            # batches carry no tensors at all: the modality is the arena)
            input_channels = (feat[0].shape[2] if len(feat) > 0 else slide_dim,)
            input_axes, modalities = (1,), 1
        return HealNetModule(
            n_modalities=modalities,
            channel_dims=input_channels,
            num_spatial_axes=input_axes,
            out_dims=self.output_dims,
            num_freq_bands=int(mp("num_freq_bands")),
            depth=int(mp("depth")),
            max_freq=float(mp("max_freq")),
            l_c=int(mp("num_latents")),
            l_d=int(mp("latent_dim")),
            cross_dim_head=int(mp("cross_dim_head")),
            latent_dim_head=int(mp("latent_dim_head")),
            x_heads=int(mp("cross_heads")),
            l_heads=int(mp("latent_heads")),
            attn_dropout=float(mp("attn_dropout")),
            ff_dropout=float(mp("ff_dropout")),
            weight_tie_layers=bool(mp("weight_tie_layers")),
            fourier_encode_data=bool(mp("fourier_encode_data")),
            self_per_cross_attn=int(mp("self_per_cross_attn")),
            final_classifier_head=True,
            snn=bool(mp("snn")),
            attention_impl=str(self.config.get("attention_impl", "auto")),
            projection_impl=str(self.config.get("projection_impl", "auto")),
            dtype=self._compute_dtype(),
            device=self.device,
            generator=torch.Generator().manual_seed(seed),
        )

    def _make_baseline(self, example_batch: Dict[str, Any], generator: torch.Generator):
        """A baseline (``healnet_tpu/train/pipeline.py``'s factory), shaped
        by the per-sample shapes of the batch's tensors; in arena mode the
        slide, gathered on the device, is the last tensor, (bag width,
        arena width)."""
        model_name, out = self.config["model"], self.output_dims
        shapes = [tuple(np.shape(t)[1:]) for t in example_batch["tensors"]]
        if example_batch.get("arena_dim") is not None:
            shapes.append((int(np.shape(example_batch["kv_masks"][-1])[1]),
                           int(example_batch["arena_dim"])))
        kw = dict(input_shapes=shapes, device=self.device, generator=generator)
        if model_name == "fcnn":
            return RegularizedFCNN(output_dim=out, **kw)
        if model_name == "multimodn":
            if len(shapes) != 2:
                raise ValueError("multimodn takes two modalities (omic and slides), got "
                                 f"{len(shapes)}")
            state_size = 2000
            return MultiModNModule(
                state_size=state_size,
                encoders=[
                    MLPEncoder(state_size=state_size, hidden_layers=(1024, 256, 128, 64),
                               input_shape=shapes[0]),
                    PatchEncoder(state_size=state_size, hidden_layers=(512, 256, 128, 64),
                                 input_shape=shapes[1]),
                ],
                decoders=[ClassDecoder(n_classes=out, activation=torch.sigmoid,
                                       state_size=state_size)],
                device=self.device, generator=generator,
            )
        # patch_attention feeds bags as (b, patches, dim) tokens, the
        # reference layout is (b, dim, patches): the bag baselines are told
        # which they get, or their FC stacks run over the wrong axis
        tokens = bool(self.config.get("patch_attention", False))
        if model_name == "mm_prognosis":
            return MMPrognosis(output_dims=out, tokens_layout=tokens, **kw)
        if model_name == "motcat":
            return MOTCAT(n_classes=out, tokens_layout=tokens, **kw)
        if model_name == "mcat":
            if len(self.sources) == 2:
                return MCAT(n_classes=out, tokens_layout=tokens, **kw)
            if self.sources[0] == "omic":
                return SNN(n_classes=out, **kw)
            return MILAttentionNet(n_classes=out, tokens_layout=tokens, **kw)
        raise ValueError(f"unknown model {model_name}")

    def _device_arena(self, parent):
        """(the arena on the device, offsets, lengths): the parent's packed
        arena (int8 values and f32 scales with ``data.quantize_arena``)
        uploaded once a run, or reused from the dataset cache."""
        t0 = time.perf_counter()
        arena, offsets, lengths = parent.feature_arena()
        self.timings.setdefault("arena_pack_s", time.perf_counter() - t0)
        if self._arena_device is None:
            # data.quantize_arena: per-token int8 values and f32 scales, half
            # the device bytes and half the context bytes a step reads;
            # quantized on the device as the rows arrive (bit-equal to the
            # JAX package's host quantization)
            quantize = bool(self.config.get("data.quantize_arena", False))
            if quantize and self.config["model"] not in ("healnet", "healnet_early"):
                print("data.quantize_arena ignored: model "
                      f"{self.config['model']!r} does not route QuantizedContext")
                quantize = False
            t0 = time.perf_counter()
            if quantize and not isinstance(arena, QuantizedContext):
                self._arena_device = place_quantized(arena, self.device)
            else:
                self._arena_device = place_arena(arena, self.device)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.timings["arena_upload_s"] = time.perf_counter() - t0
            # the host pack goes; the device copy serves every later probe
            parent.adopt_device_arena(self._arena_device)
            if _DATASET_CACHE["dataset"] is parent:
                _DATASET_CACHE["arena_device"] = self._arena_device
        else:
            self.timings.setdefault("arena_upload_s", 0.0)
        return self._arena_device, offsets, lengths

    def _sharded_arena(self, parent):
        """(this rank's halo'd block of the arena, offsets, lengths) for
        ``data.shard_arena``: the rows split over the mesh's ``seq`` axis,
        int8 quantized on the host first with ``data.quantize_arena``, built
        once a run and kept across pipelines (sweeps) under the mesh's shape
        and the halo: the widest gather the batches can ask for (bucket
        boundaries, ``data.max_patches``, the longest bag)."""
        arena, offsets, lengths = parent.feature_arena()
        quantize = bool(self.config.get("data.quantize_arena", False)) and \
            self.config["model"] in ("healnet", "healnet_early")
        halo = [int(b) for b in (self._resolve_buckets(parent) or [])]
        if getattr(parent, "max_patches", None):
            halo.append(int(parent.max_patches))
        halo = max(halo + [int(np.max(lengths))])
        key = (self._dataset_cache_key(), tuple(sorted(self.mesh.shape.items())), halo, quantize)
        if self._sharded is not None and self._sharded[0] == key:
            device_arena = self._sharded[1]
        elif _DATASET_CACHE.get("arena_sharded_key") == key:
            device_arena = _DATASET_CACHE["arena_sharded"]
        else:
            t0 = time.perf_counter()
            if quantize and not isinstance(arena, QuantizedContext):
                host = arena.cpu().numpy() if isinstance(arena, torch.Tensor) else arena
                arena = QuantizedContext(*quantize_context_host(np.asarray(host)))
            device_arena = build_device_arena(arena, self.mesh, halo=halo)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.timings["arena_upload_s"] = time.perf_counter() - t0
        self.timings.setdefault("arena_upload_s", 0.0)
        self._sharded = (key, device_arena)
        if _DATASET_CACHE["dataset"] is parent:
            _DATASET_CACHE.update(arena_sharded_key=key, arena_sharded=device_arena)
        return device_arena, offsets, lengths

    def make_trainer(self, train_view, fold: int, cw) -> SurvivalTrainer:
        # one trainer across folds: the module and loss are fold-independent,
        # so fold 2 on only redraws the weights (seeded by the fold) and
        # drops the optimizer and captured steps
        if self._trainer is not None:
            self._trainer.set_fold(
                seed=fold, class_weights=cw, checkpoint_dir=self._fold_checkpoint_dir(fold))
            return self._trainer

        example_batch = next(
            iterate_batches(train_view, int(self.config["train_loop.batch_size"])))
        # data.device_cache: every patch feature packed into one arena on the
        # device; epochs stream only indices (the folds share the arena)
        feature_arena = None
        parent = getattr(train_view, "parent", train_view)
        shard_arena = self.mesh is not None and bool(self.config.get("data.shard_arena", False))
        if getattr(parent, "device_cache", False):
            feature_arena = (self._sharded_arena(parent) if shard_arena
                             else self._device_arena(parent))
            example_batch = dict(example_batch, arena_dim=int(feature_arena[0].shape[1]))

        model = self.make_model(example_batch, seed=fold)
        model_name = self.config["model"]
        self._trainer = SurvivalTrainer(
            model,
            loss_type=self.config["survival.loss"],
            l1=float(self.config["model_params.l1"]),
            class_weights=cw,
            batch_size=int(self.config["train_loop.batch_size"]),
            epochs=int(self.config["train_loop.epochs"]),
            max_lr=float(self.config["optimizer.max_lr"]),
            patience=int(self.config["train_loop.patience"]),
            early_stopping=bool(self.config["train_loop.early_stopping"]),
            eval_interval=int(self.config.get("train_loop.eval_interval", 1)),
            gc_compat=int(self.config.get("train_loop.gc_compat", 16)),
            seed=fold,
            tracker=self.tracker,
            reg_topo=model_name,
            sources=self.sources,
            aux_loss=model_name == "multimodn",
            n_bins=self.output_dims,
            bucket_boundaries=self._resolve_buckets(parent),
            checkpoint_dir=self._fold_checkpoint_dir(fold),
            resume=bool(self.config.get("train_loop.resume", False)),
            keep_checkpoints=self.config.get("train_loop.keep_checkpoints", 3),
            feature_arena=feature_arena,
            arena_device=None if feature_arena is None else feature_arena[0],
            fused_epochs=bool(self.config.get("train_loop.fused_epochs", False)),
            device=self.device,
            mesh=self.mesh,
            arena_sharded=shard_arena and feature_arena is not None,
        )
        return self._trainer

    def _resolve_buckets(self, parent):
        """train_loop.bucket_boundaries: a list, "auto", or absent.

        "auto" takes the dataset's bag-size quantiles rounded up to
        multiples of 128 (:meth:`TCGADataset.suggest_bucket_boundaries`).
        """
        boundaries = self.config.get("train_loop.bucket_boundaries")
        if isinstance(boundaries, str) and boundaries.lower() == "auto":
            boundaries = (
                parent.suggest_bucket_boundaries()
                if hasattr(parent, "suggest_bucket_boundaries") else None
            )
            if boundaries:
                print(f"auto bucket boundaries: {boundaries}")
        return boundaries

    def _fold_checkpoint_dir(self, fold: int):
        """Durable per-fold checkpoints (train_loop.checkpoint: true); with
        train_loop.resume a relaunched run restores the last finished epoch
        of an interrupted fold and continues."""
        if not self.config.get("train_loop.checkpoint", False):
            return None
        base = Path(self.tracker.log_dir if self.tracker is not None else "logs")
        return str(base / f"fold_{fold}_checkpoints")
