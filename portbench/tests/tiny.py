"""A tiny cell for the CPU tests: the brca config and the fold mix cut to
a few channels, latents and patches, on the CPU."""

import json
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def tiny_files(precision: str = "f32", limits_of: str = "brca.train", **trainer):
    cfg = json.loads((HERE / "configs" / "brca.json").read_text())
    cfg.update(depth=2, num_latents=5, latent_dim=12, cross_dim_head=7, omic_dim=20,
               wsi_dim=16, cohort=80, precision=precision)
    mix = json.loads((HERE / "traffic" / "fold_1k-8k.json").read_text())
    mix.update(bag_patches={"min": 16, "max": 64, "median": 30, "sigma": 0.55,
                            "distribution": "log_normal"},
               bucket_boundaries=[32, 64], batch_size=4, epochs=2, n_folds=2,
               check={"buckets": [32, 64], "rounds": 2})
    mix["trainer"] = dict(mix["trainer"], **trainer)
    limits = json.loads((HERE / "limits" / f"{limits_of}.json").read_text())
    cell = {"name": "tiny", "config": "brca", "traffic": "fold_1k-8k", "chips": 1}
    return cell, cfg, mix, limits


def run_tiny(seed: int = 20240611, precision: str = "f32", seconds: float = 0.5, **trainer):
    from portbench import run

    files = tiny_files(precision, **trainer)
    manifest = {"workloads": [files[0]], "configs": [], "per_layer": []}
    return run.run_cell("tiny", seed, seconds, False, device="cpu", manifest=manifest,
                        files=files, readers=[])
