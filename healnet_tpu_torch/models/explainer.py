"""Explainability: omic feature rankings and WSI patch-attention heatmaps.

Counterpart of ``healnet_tpu/models/explainer.py``, with the same names:
reload a finished run's artifacts (``config.pkl``, ``test_data_indices.pkl``
and the best weights, written by
:class:`~healnet_tpu_torch.train.pipeline.Pipeline` with ``explainer:
true``), rebuild the dataset and the model, run the model on the highest-
and lowest-risk test patients, and turn its attention into:

- a ranking of the omic features (the layer of largest attention std),
  which needs the ``omic_attention: false`` layout, where each feature is a
  context token;
- a per-patch attention vector, painted as a heatmap over the slide image
  when the raw slide can be read (libopenslide), else over the CLAM patch
  coordinates (read by :mod:`healnet_tpu_torch.etl.h5`), with the top
  patches highlighted and cropped.

The capture is dense (:meth:`HealNet.get_attention_weights`), or streamed
in KV chunks (:meth:`HealNet.get_attention_stats`) once a bag passes 4,096
tokens. The model runs on the card unless ``device="cpu"`` is asked for.

Every array is written as ``.npy`` (``<name>_omic_attention``,
``_attention``, ``_heatmap``, ``_mask``). The PNG figures need matplotlib;
where it cannot be imported each skipped figure prints one line and the
arrays and return values are produced all the same. The ranking is a
:class:`~healnet_tpu_torch.etl.table.Table` with the columns ``feature``,
``attention`` and ``attention_scaled``, indexed by feature position.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from healnet_tpu_torch.device import DeviceLike, resolve_device
from healnet_tpu_torch.etl import TCGADataset
from healnet_tpu_torch.etl.h5 import read_dataset
from healnet_tpu_torch.etl.table import Table
from healnet_tpu_torch.models.healnet import HealNet
from healnet_tpu_torch.train.checkpoint import Checkpointer
from healnet_tpu_torch.utils import Box, unpickle

# a bag longer than this streams its capture by default
STREAMING_TOKENS = 4096
_NOT_FEATURES = re.compile("age|is_female")


def _pyplot():
    """``matplotlib.pyplot`` on the Agg backend, or None without matplotlib."""
    try:
        import matplotlib
    except ImportError:
        return None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


class Explainer:
    def __init__(self, log_dir, show: bool = False, device: DeviceLike = None):
        self.log_dir = Path(log_dir)
        self.show = show
        self.device = resolve_device(device)
        self.expl_dir = Path("explanations") / self.log_dir.name
        self.expl_dir.mkdir(parents=True, exist_ok=True)

        self.config = Box(unpickle(self.log_dir / "config.pkl"))
        self.test_data_indices = np.asarray(unpickle(self.log_dir / "test_data_indices.pkl"))
        self.dataset = self.config["dataset"]
        self.level = int(self.config["data.wsi_level"])
        self.prep_path = (Path(self.config["tcga_path"]) / "wsi"
                          / f"{self.dataset}_preprocessed_level{self.level}")
        self.raw_path = Path(self.config["tcga_path"]) / "wsi" / self.dataset

        print("Initializing dataset...")
        max_patches = self.config.get("data.max_patches")
        self.data = TCGADataset(
            dataset=self.dataset,
            config=self.config,
            level=self.level,
            sources=list(self.config["sources"]),
            n_bins=int(self.config["model_params.output_dims"]),
            log_dir=None,
            # the run's bag width: a larger one would not fit the weights
            max_patches=None if max_patches in (None, "None", "null") else int(max_patches),
        )
        self.omic_df = self.data.omic_df
        print("Loading model...")
        self.model = self.load_model()

    # ------------------------------------------------------------- restore
    def load_model(self) -> HealNet:
        """The run's HealNet (plain attention, f32) with the best weights."""
        feat = self.data[0][0]
        if len(self.config["sources"]) == 1:
            channels, axes, modalities = [feat[0].shape[-1]], [1], 1
        else:
            channels, axes, modalities = [feat[0].shape[-1], feat[1].shape[-1]], [1, 1], 2

        def mp(key):
            return self.config[f"model_params.{key}"]

        model = HealNet(
            n_modalities=modalities,
            channel_dims=channels,
            num_spatial_axes=axes,
            out_dims=int(mp("output_dims")),
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
            snn=bool(mp("snn")),
            device=self.device,
        )
        model.module.load_state_dict(Checkpointer(self.log_dir / "checkpoints").restore_best())
        return model

    # --------------------------------------------------------------- select
    def get_patients(self, n: int = 5, risk: str = "high") -> List[Tuple[str, str]]:
        """The ``n`` highest- or lowest-risk test patients by (``y_disc``,
        ``survival_months``), ascending for high risk: ``(index label,
        slide id without its extension)`` pairs. The sort is stable, ties
        in the order of the test indices."""
        if risk not in ("high", "low"):
            raise ValueError("Invalid risk type")
        idx = self.test_data_indices
        bins = np.asarray(self.omic_df["y_disc"])[idx]
        months = np.asarray(self.omic_df["survival_months"])[idx]
        if risk == "low":
            bins, months = -bins, -months
        order = idx[np.lexsort((months, bins))][:n]
        return [(str(self.omic_df.index[i]), str(self.omic_df["slide_id"][i])[:-4])
                for i in order]

    # ------------------------------------------------------------------ run
    def run(
        self,
        n_high: int = 3,
        n_low: int = 0,
        downsample: Optional[float] = None,
        run_omic: bool = True,
        run_slides: bool = True,
        heatmap: bool = True,
        highlight_patches: bool = True,
        save_patches: bool = True,
        streaming: Optional[bool] = None,
    ) -> List[Dict]:
        results = []
        high = self.get_patients(risk="high", n=n_high)
        low = self.get_patients(risk="low", n=n_low)
        for label, patients in (("high_risk", high), ("low_risk", low)):
            for rank, (idx, slide_id) in enumerate(patients):
                results.append(self.run_sample_explanation(
                    idx, slide_id, run_omic=run_omic, run_slides=run_slides,
                    heatmap=heatmap, highlight_patches=highlight_patches,
                    save_patches=save_patches, downsample=downsample,
                    save_name=f"{label}_{rank}", streaming=streaming,
                ))
        return results

    def run_sample_explanation(
        self,
        idx,
        slide_id: str,
        run_omic: bool = True,
        run_slides: bool = True,
        heatmap: bool = True,
        highlight_patches: bool = True,
        save_patches: bool = True,
        downsample: Optional[float] = None,
        save_name: Optional[str] = None,
        streaming: Optional[bool] = None,
    ) -> Dict:
        """Explain one sample (``idx``: its index label, as a string or an
        int). ``streaming``: reduce the attention in KV chunks
        (:meth:`HealNet.get_attention_stats`) instead of capturing the
        whole maps; None streams once a modality passes
        :data:`STREAMING_TOKENS` tokens. Artifacts are named ``save_name``,
        by default the slide id."""
        self.save_name = str(slide_id) if save_name is None else save_name
        # the first row of a duplicated label, as the JAX package
        hits = np.flatnonzero(np.asarray([str(v) for v in self.omic_df.index]) == str(idx))
        if hits.size == 0:
            raise KeyError(f"sample {idx!r} not found in the omic index")
        tensors, _, _, _, n_valid = self.data._sample(int(hits[0]))
        batched = [np.asarray(t)[None] for t in tensors]
        # the training-time KV mask: padded patch rows take no attention
        mask = None
        if self.data.patch_attention and n_valid is not None:
            mask = [None] * len(batched)
            mask[-1] = (np.arange(batched[-1].shape[1]) < n_valid)[None, :]
        logits = self.model(batched, mask=mask).float().cpu().numpy()

        n_omic_tokens = batched[0].shape[1]
        n_patch_tokens = batched[1].shape[1] if len(batched) > 1 else -1
        result: Dict = {"slide_id": slide_id, "logits": logits}
        if streaming is None:
            streaming = max(t.shape[1] for t in batched) > STREAMING_TOKENS
        omic_wanted = run_omic and n_omic_tokens == len(self.data.feature_columns)

        omic_scores = slide_scores = None
        if streaming:
            stats = self.model.get_attention_stats()
            omic_stats = [s for s in stats if s["tokens"] == n_omic_tokens]
            if omic_stats:
                # the dense path's np.std layer choice, from the chunked sums
                layer = int(np.argmax([s["std"] for s in omic_stats]))
                omic_scores = omic_stats[layer]["col_mean"].mean(axis=0)
            slide_stats = [s for s in stats if s["tokens"] == n_patch_tokens]
            if slide_stats:
                slide_scores = np.mean([s["col_mean"].mean(axis=0) for s in slide_stats], axis=0)
        else:
            weights = self.model.get_attention_weights()
            omic_attn = [w for w in weights if w.shape[2] == n_omic_tokens]
            slide_attn = [w for w in weights if w.shape[2] == n_patch_tokens]
            if omic_attn:
                layer = int(np.argmax([np.std(w) for w in omic_attn]))
                omic_scores = omic_attn[layer].mean(axis=(0, 1))
            if slide_attn:
                slide_scores = np.stack(slide_attn).mean(axis=(0, 1, 2)).squeeze()

        if omic_wanted and omic_scores is not None:
            result["omic_ranking"] = self._plot_omic_scores(omic_scores)
        if run_slides and slide_scores is not None:
            coords = self.load_patch_coords(slide_id)
            result["heatmap"] = self._plot_slide_scores(
                slide_id, slide_scores, coords, heatmap=heatmap,
                highlight_patches=highlight_patches, save_patches=save_patches,
                downsample=downsample,
            )
        return result

    def _skipped(self, name: str) -> None:
        print(f"matplotlib is not available: skipped {self.expl_dir / name}")

    # ------------------------------------------------------------ omic plot
    def plot_omic_attn(self, omic_attn: List[np.ndarray], k: int = 20) -> Table:
        """Top-k features from the layer of largest attention std."""
        layer = int(np.argmax([np.std(w) for w in omic_attn]))
        return self._plot_omic_scores(omic_attn[layer].mean(axis=(0, 1)), k=k)

    def _plot_omic_scores(self, scores: np.ndarray, k: int = 20) -> Table:
        """The ranking (and its bar chart) from a per-feature score vector:
        sorted by attention, descending and stable; ``age`` / ``is_female``
        features dropped; scaled by the min and max of the features kept,
        then cut to ``k``."""
        np.save(self.expl_dir / f"{self.save_name}_omic_attention.npy", scores)
        feats = np.asarray(self.data.feature_columns, dtype=object)
        order = np.argsort(-np.asarray(scores), kind="stable")
        order = order[[not _NOT_FEATURES.search(f) for f in feats[order]]]
        attention = np.asarray(scores)[order]
        lo, hi = attention.min(), attention.max()
        top = order[:k]
        ranking = Table({"feature": feats[top], "attention": attention[:k],
                         "attention_scaled": (attention[:k] - lo) / max(hi - lo, 1e-12) / k},
                        index=top)

        name = f"{self.save_name}_omic_attn.png"
        plt = _pyplot()
        if plt is None:
            self._skipped(name)
            return ranking
        fig, ax = plt.subplots(figsize=(6, 10))
        ax.barh(list(ranking["feature"][::-1]), ranking["attention_scaled"][::-1])
        ax.set_xlabel("Attention Scaled")
        ax.set_ylabel("Feature")
        fig.tight_layout()
        fig.savefig(self.expl_dir / name)
        plt.close(fig)
        return ranking

    # ----------------------------------------------------------- slide plot
    def load_patch_coords(self, slide_id: str) -> Optional[np.ndarray]:
        """The slide's CLAM ``coords`` (level-0 pixels), or None where its
        ``.h5`` file or the dataset is missing."""
        path = self.prep_path / "patches" / f"{slide_id}.h5"
        if not path.exists():
            return None
        return read_dataset(path, "coords")

    def plot_slide_attn(
        self,
        slide_id: str,
        slide_attn: List[np.ndarray],
        coords: Optional[np.ndarray],
        patch_size: Tuple[int, int] = (256, 256),
        heatmap: bool = True,
        highlight_patches: bool = True,
        save_patches: bool = True,
        downsample: Optional[float] = None,
    ) -> Optional[np.ndarray]:
        """The heatmap from dense maps, averaged over layers, heads and latents."""
        attn = np.stack(slide_attn).mean(axis=(0, 1, 2)).squeeze()
        return self._plot_slide_scores(
            slide_id, attn, coords, patch_size=patch_size, heatmap=heatmap,
            highlight_patches=highlight_patches, save_patches=save_patches,
            downsample=downsample,
        )

    def _plot_slide_scores(
        self,
        slide_id: str,
        attn: np.ndarray,
        coords: Optional[np.ndarray],
        patch_size: Tuple[int, int] = (256, 256),
        heatmap: bool = True,
        highlight_patches: bool = True,
        save_patches: bool = True,
        downsample: Optional[float] = None,
    ) -> Optional[np.ndarray]:
        """The heatmap (and figures) from a per-patch score vector: over
        the slide image at ``self.level`` where it can be read, else over
        a canvas of 16-pixel cells in patch-coordinate space."""
        np.save(self.expl_dir / f"{self.save_name}_attention.npy", attn)
        if coords is None or len(coords) == 0:
            print(f"No patch coords for {slide_id}; saved raw attention only.")
            return None
        attn = attn[: len(coords)]
        scaled = (attn - attn.min()) / max(attn.max() - attn.min(), 1e-12)

        slide_img, scale_factor = self._read_slide_image(slide_id)
        if slide_img is not None:
            canvas_h, canvas_w = slide_img.shape[:2]
            # coords are level 0; patch_size is at the pyramid level
            xs = (coords[:, 0] / scale_factor).astype(int)
            ys = (coords[:, 1] / scale_factor).astype(int)
            ph = pw = int(patch_size[0])
        else:
            cell = 16
            xs = ((coords[:, 0] - coords[:, 0].min()) // patch_size[0]).astype(int) * cell
            ys = ((coords[:, 1] - coords[:, 1].min()) // patch_size[1]).astype(int) * cell
            canvas_w, canvas_h = xs.max() + cell, ys.max() + cell
            ph = pw = cell

        heat = np.zeros((canvas_h, canvas_w), np.float32)
        # painted apart from heat: the lowest patch scales to 0.0 exactly
        painted = np.zeros((canvas_h, canvas_w), bool)
        for x, y, a in zip(xs, ys, scaled):
            heat[y:y + ph, x:x + pw] = a
            painted[y:y + ph, x:x + pw] = True
        np.save(self.expl_dir / f"{self.save_name}_heatmap.npy", heat)
        np.save(self.expl_dir / f"{self.save_name}_mask.npy", ~painted)

        plt = _pyplot()
        top = np.argsort(scaled)[::-1][:5]
        if heatmap:
            name = f"{self.save_name}_heatmap.png"
            if plt is None:
                self._skipped(name)
            else:
                fig, ax = plt.subplots(figsize=(10, 10))
                if slide_img is not None:
                    ax.imshow(slide_img)
                    ax.imshow(heat, cmap="Blues", alpha=0.7)
                else:
                    im = ax.imshow(heat, cmap="Blues")
                    fig.colorbar(im, ax=ax, shrink=0.5, label="Attention")
                ax.axis("off")
                fig.savefig(self.expl_dir / name, dpi=150)
                plt.close(fig)
        if highlight_patches and slide_img is not None:
            name = f"{self.save_name}_patch_highlights.png"
            if plt is None:
                self._skipped(name)
            else:
                import matplotlib.patches as patches

                fig, ax = plt.subplots(figsize=(10, 10))
                ax.imshow(slide_img)
                for i in top:
                    ax.add_patch(patches.Rectangle((xs[i], ys[i]), pw, ph, linewidth=2,
                                                   edgecolor="lime", facecolor="none"))
                ax.axis("off")
                fig.savefig(self.expl_dir / name, dpi=150)
                plt.close(fig)
        if save_patches and slide_img is not None:
            # the top patches cropped from the rendered level, and read at
            # level 0 where the raw slide opens
            for rank, i in enumerate(top):
                x, y = int(xs[i]), int(ys[i])
                crop = slide_img[y:y + ph, x:x + pw]
                if crop.size == 0:
                    continue
                name = f"{self.save_name}_patch_{rank}.png"
                if plt is None:
                    self._skipped(name)
                else:
                    plt.imsave(self.expl_dir / name,
                               np.ascontiguousarray(crop.astype(np.uint8)))
            self._save_high_res_patches(slide_id, coords[top], patch_size, scale_factor)
        return heat

    def _save_high_res_patches(
        self,
        slide_id: str,
        level0_coords: np.ndarray,
        patch_size: Tuple[int, int],
        scale_factor: float,
    ) -> None:
        """Crops of the top patches read at level 0 from the raw slide."""
        from healnet_tpu_torch.etl.slides import OpenSlide, openslide_available

        if not openslide_available():
            return
        path = self.raw_path / f"{slide_id}.svs"
        if not path.exists():
            return
        plt = _pyplot()
        slide = OpenSlide(path)
        try:
            size0 = (int(patch_size[0] * scale_factor), int(patch_size[1] * scale_factor))
            for rank, (x, y) in enumerate(np.asarray(level0_coords, dtype=int)):
                name = f"{self.save_name}_patch_{rank}_high_res.png"
                if plt is None:
                    self._skipped(name)
                    continue
                crop = slide.read_region((int(x), int(y)), 0, size0)[:, :, :3]
                plt.imsave(self.expl_dir / name, crop.astype(np.uint8))
        finally:
            slide.close()

    def _read_slide_image(self, slide_id: str):
        """(the slide's RGB at ``self.level``, level 0 -> level scale), or
        (None, 1.0) where libopenslide or the raw slide is missing."""
        try:
            from healnet_tpu_torch.etl.slides import OpenSlide, openslide_available

            if not openslide_available():
                return None, 1.0
            path = self.raw_path / f"{slide_id}.svs"
            if not path.exists():
                return None, 1.0
            slide = OpenSlide(path)
            level = min(self.level, slide.level_count - 1)
            size = slide.level_dimensions[level]
            img = slide.read_region((0, 0), level, size)[:, :, :3]
            scale = slide.dimensions[0] / size[0]
            return img, scale
        except Exception as exc:  # a slide that fails to open or read
            print(f"slide render unavailable ({exc}); using coords-space fallback")
            return None, 1.0
