"""Data-ops CLI: download, flatten, patch and feature-extract TCGA WSIs.

The port's counterpart of ``healnet_tpu/cli/tasks.py``, with the same
tasks, flags and printed lines:

    python -m healnet_tpu_torch.cli.tasks install --system linux
    python -m healnet_tpu_torch.cli.tasks download --dataset brca [--samples 10]
    python -m healnet_tpu_torch.cli.tasks flatten --dataset brca
    python -m healnet_tpu_torch.cli.tasks preprocess --dataset brca --step patch
    python -m healnet_tpu_torch.cli.tasks preprocess --dataset brca --step features \\
        [--device {cuda,cpu}] [--weights resnet50.pt]

- patching segments tissue on the slide's most downsampled level (Otsu on
  the HSV saturation, median blur and a morphological close, each as
  OpenCV computes it on 8-bit images, in numpy: the mask equals the JAX
  package's bit for bit) and writes the grid of tissue patches as CLAM
  coords (``patches/<slide_id>.h5``, dataset ``coords`` with the
  ``patch_size`` / ``patch_level`` attributes) through
  :mod:`healnet_tpu_torch.etl.h5`;
- feature extraction reads each patch through the OpenSlide binding,
  resizes it to 224 with :func:`~healnet_tpu_torch.etl.transforms.resize_linear_uint8`
  (OpenCV's bilinear arithmetic, within 1 of ``cv2.resize``) and embeds it
  with the port's ResNet-50 on the card (``--device cpu`` for the CPU),
  writing ``patch_features/<slide_id>.npy`` (or ``.pt``). Without
  ``--weights`` the ResNet's weights are random.

``--device`` (``preprocess`` only, default ``cuda``) is the one flag the
JAX CLI lacks. No cv2, h5py, pandas or PyYAML is needed.
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from healnet_tpu_torch.constants import VALID_DATASETS
from healnet_tpu_torch.etl import h5
from healnet_tpu_torch.etl.manifests import read_manifest, write_manifest
from healnet_tpu_torch.etl.slides import OpenSlide
from healnet_tpu_torch.etl.transforms import resize_linear_uint8
from healnet_tpu_torch.ops.resnet import PatchFeatureExtractor
from healnet_tpu_torch.utils import Config

GDC_URLS = {
    "linux": "https://gdc.cancer.gov/files/public/file/gdc-client_v1.6.1_Ubuntu_x64.zip",
    "mac": "https://gdc.cancer.gov/files/public/file/gdc-client_v1.6.1_OSX_x64.zip",
}


def install(system: str) -> None:
    """Fetch the gdc-client download binary."""
    assert system in GDC_URLS, "system must be 'linux' or 'mac'"
    url = GDC_URLS[system]
    print(f"Installing gdc-client for {system}...")
    subprocess.run(["curl", "-L", url, "--output", "gdc-client.zip"], check=True)
    subprocess.run(["unzip", "-o", "gdc-client.zip"], check=True)
    os.remove("gdc-client.zip")
    print(f"Installed gdc-client at {os.getcwd()}")


def download(
    dataset: str, config_path: str = "config/main.yml", samples: Optional[int] = None
) -> None:
    """gdc-client download against the filtered manifest; ``samples`` draws
    that many rows as pandas' ``sample(n=samples, random_state=42)`` does
    (``RandomState(42).choice`` without replacement, in its order)."""
    assert dataset in VALID_DATASETS, f"dataset must be one of {VALID_DATASETS}"
    conf = Config(config_path).read()
    download_dir = Path(conf["tcga_path"]) / "wsi" / dataset
    download_dir.mkdir(parents=True, exist_ok=True)
    manifest_path = Path(
        f"data/tcga/gdc_manifests/filtered/{dataset}_wsi_manifest_filtered.txt"
    )
    if samples is not None:
        manifest = read_manifest(manifest_path)
        manifest = manifest.rows(
            np.random.RandomState(42).choice(len(manifest), int(samples), replace=False))
        tmp = manifest_path.parent / f"{dataset}_tmp.txt"
        write_manifest(manifest, tmp)
        manifest_path = tmp
    try:
        subprocess.run(
            [str(conf["gdc_client"]), "download", "-m", str(manifest_path),
             "-d", str(download_dir)],
            check=True,
        )
    finally:
        if samples is not None:
            manifest_path.unlink(missing_ok=True)


def flatten(dataset: str, config_path: str = "config/main.yml") -> None:
    """Move .svs files out of per-file gdc directories."""
    conf = Config(config_path).read()
    wsi_dir = Path(conf["tcga_path"]) / "wsi" / dataset
    moved = 0
    for svs in list(wsi_dir.glob("*/*.svs")):
        target = wsi_dir / svs.name
        if not target.exists():
            shutil.move(str(svs), str(target))
            moved += 1
        if svs.parent != wsi_dir and not any(svs.parent.iterdir()):
            svs.parent.rmdir()
    print(f"Flattened {moved} slides into {wsi_dir}")


# ---------------------------------------------------------------- patching

_HSV_SHIFT = 12
# OpenCV's RGB2HSV_b table: round((255 << 12) / v), 0 at v = 0
_SDIV = np.concatenate([[0], np.rint((255 << _HSV_SHIFT) / np.arange(1, 256))]).astype(np.int64)


def hsv_saturation(rgb: np.ndarray) -> np.ndarray:
    """The S channel of ``cv2.cvtColor(rgb, cv2.COLOR_RGB2HSV)`` for uint8
    input: ``(diff * sdiv[v] + 2**11) >> 12`` with ``v`` the channels' max
    and ``diff`` their max minus min."""
    rgb = np.asarray(rgb, np.uint8)
    v = rgb.max(axis=-1).astype(np.int64)
    diff = v - rgb.min(axis=-1)
    return ((diff * _SDIV[v] + (1 << (_HSV_SHIFT - 1))) >> _HSV_SHIFT).astype(np.uint8)


def _windows(img: np.ndarray, k: int, pad_mode: str, **pad) -> np.ndarray:
    r = k // 2
    padded = np.pad(img, r, mode=pad_mode, **pad)
    return np.lib.stride_tricks.sliding_window_view(padded, (k, k))


def median_blur(img: np.ndarray, k: int = 7) -> np.ndarray:
    """``cv2.medianBlur(img, k)`` for a uint8 image: the median of each
    k x k window, the border replicated."""
    win = _windows(img, k, "edge").reshape(*img.shape, k * k)
    return np.partition(win, k * k // 2, axis=-1)[..., k * k // 2]


def otsu_threshold(img: np.ndarray) -> int:
    """The threshold ``cv2.threshold(img, 0, 255, THRESH_BINARY +
    THRESH_OTSU)`` picks for a uint8 image: OpenCV's loop over the 256-bin
    histogram in float64, step for step (bins where either class holds less
    than FLT_EPSILON of the pixels are skipped; the first maximum of the
    between-class variance wins; 0 when none is found, as on a flat
    image)."""
    hist = np.bincount(np.asarray(img).ravel(), minlength=256)
    scale = 1.0 / img.size
    mu = 0.0
    for i in range(256):
        mu += i * float(hist[i])
    mu *= scale
    eps = float(np.finfo(np.float32).eps)
    mu1 = q1 = max_sigma = 0.0
    max_val = 0
    for i in range(256):
        p_i = float(hist[i]) * scale
        mu1 *= q1
        q1 += p_i
        q2 = 1.0 - q1
        if min(q1, q2) < eps or max(q1, q2) > 1.0 - eps:
            continue
        mu1 = (mu1 + i * p_i) / q1
        mu2 = (mu - q1 * mu1) / q2
        sigma = q1 * q2 * (mu1 - mu2) * (mu1 - mu2)
        if sigma > max_sigma:
            max_sigma = sigma
            max_val = i
    return max_val


def close_mask(mask: np.ndarray, k: int = 7) -> np.ndarray:
    """``cv2.morphologyEx(mask, cv2.MORPH_CLOSE, ones((k, k)))`` for a
    boolean mask: a dilation then an erosion by the k x k square, the
    pixels outside the image taking part in neither."""
    dilated = _windows(mask, k, "constant", constant_values=False).any(axis=(-2, -1))
    return _windows(dilated, k, "constant", constant_values=True).all(axis=(-2, -1))


def segment_tissue(thumbnail: np.ndarray, close_kernel: int = 7) -> np.ndarray:
    """Otsu tissue mask on a low-res RGB thumbnail (CLAM-style segmentation),
    equal to the JAX package's (OpenCV's) bit for bit."""
    blur = median_blur(hsv_saturation(thumbnail), 7)
    mask = blur > otsu_threshold(blur)
    return close_mask(mask, close_kernel)


def patch_slide(
    slide,
    level: int,
    patch_size: int = 256,
    step: Optional[int] = None,
    tissue_threshold: float = 0.25,
    thumb_max: int = 1024,
) -> np.ndarray:
    """Grid tissue-patch coordinates (level-0 space, CLAM h5 convention):
    each grid patch whose centre's 5 x 5 mask window (clipped at the
    mask's edges) is at least ``tissue_threshold`` tissue, row by row,
    with the JAX package's float arithmetic."""
    step = step or patch_size
    level = min(level, slide.level_count - 1)
    w, h = slide.level_dimensions[level]
    w0, h0 = slide.dimensions
    # per-axis scales: level dimensions are floored independently per axis
    scale_x = w0 / w  # level -> level0
    scale_y = h0 / h

    # tissue mask from the most downsampled level, resized to a thumbnail
    thumb_level = slide.level_count - 1
    tw, th = slide.level_dimensions[thumb_level]
    shrink = max(1, int(max(tw, th) / thumb_max))
    thumb = slide.read_region((0, 0), thumb_level, (tw, th))[:, :, :3]
    thumb = thumb[::shrink, ::shrink]
    mask = segment_tissue(thumb)

    mask_h, mask_w = mask.shape
    ys = np.arange(0, h - patch_size + 1, step, dtype=np.int64)
    xs = np.arange(0, w - patch_size + 1, step, dtype=np.int64)
    # map patch centres into mask space (int() truncates toward zero)
    cx = ((xs + patch_size / 2) / w * mask_w).astype(np.int64)
    cy = ((ys + patch_size / 2) / h * mask_h).astype(np.int64)
    x0m, x1m = np.maximum(cx - 2, 0), np.minimum(cx + 3, mask_w)
    y0m, y1m = np.maximum(cy - 2, 0), np.minimum(cy + 3, mask_h)
    # tissue pixels of each window from the mask's summed-area table
    sat = np.zeros((mask_h + 1, mask_w + 1), np.int64)
    sat[1:, 1:] = mask.cumsum(0).cumsum(1)
    count = (sat[y1m[:, None], x1m[None, :]] - sat[y0m[:, None], x1m[None, :]]
             - sat[y1m[:, None], x0m[None, :]] + sat[y0m[:, None], x0m[None, :]])
    size = (y1m - y0m)[:, None] * (x1m - x0m)[None, :]
    keep = (size > 0) & (count / np.maximum(size, 1) >= tissue_threshold)
    iy, ix = np.nonzero(keep)  # row-major: y, then x
    coords = np.stack([(xs[ix] * scale_x).astype(np.int64),
                       (ys[iy] * scale_y).astype(np.int64)], axis=1)
    return coords.reshape(-1, 2)


def read_patches(slide, coords: np.ndarray, level: int, patch_size: int) -> np.ndarray:
    """The ``patch_size`` squares at ``coords`` (level 0) of ``level``, RGB,
    each resized to 224 x 224: ``(n, 224, 224, 3)`` uint8."""
    patches = np.zeros((len(coords), 224, 224, 3), np.uint8)
    level = min(level, slide.level_count - 1)
    for i, (x0, y0) in enumerate(coords):
        region = slide.read_region((int(x0), int(y0)), level, (patch_size, patch_size))
        patches[i] = resize_linear_uint8(region[:, :, :3], 224, 224)
    return patches


def preprocess(
    dataset: str,
    config_path: str = "config/main.yml",
    level: int = 2,
    step: str = "patch",
    patch_size: int = 256,
    max_patches: Optional[int] = None,
    weights: Optional[str] = None,
    save_format: str = "npy",
    device: str = "cuda",
) -> Dict[str, float]:
    """Patch or feature-extract all slides of a dataset. Returns the step's
    timings in seconds (``patch``: ``"seconds"``; ``features``: also
    ``"read_s"``, region reading and resizing on the host, and
    ``"extract_s"``, the ResNet) and ``"patches"``, the patches written."""
    t_step = time.perf_counter()
    conf = Config(config_path).read()
    raw_dir = Path(conf["tcga_path"]) / "wsi" / dataset
    prep = Path(conf["tcga_path"]) / "wsi" / f"{dataset}_preprocessed_level{level}"
    (prep / "patches").mkdir(parents=True, exist_ok=True)
    (prep / "patch_features").mkdir(parents=True, exist_ok=True)
    slides = sorted(raw_dir.glob("**/*.svs"))
    print(f"{len(slides)} slides found in {raw_dir}")

    if step == "patch":
        total = 0
        for path in slides:
            slide = OpenSlide(path)
            if slide.level_count - 1 < level:
                print(f"skipping {path.name}: no pyramid level {level}")
                continue
            coords = patch_slide(slide, level=level, patch_size=patch_size)
            h5.write_coords(prep / "patches" / f"{path.stem}.h5", coords, patch_size, level)
            print(f"{path.stem}: {len(coords)} tissue patches")
            slide.close()
            total += len(coords)
        return {"seconds": time.perf_counter() - t_step, "patches": total}

    if step == "features":
        extractor = PatchFeatureExtractor(weights_path=weights, device=device)
        if not extractor.pretrained:
            print(
                "WARNING: no --weights provided; extracting with randomly "
                "initialised ResNet-50 (fixed random projections)."
            )
        done = skipped_missing = resumed = total = 0
        read_s = extract_s = 0.0
        for path in slides:
            h5_path = prep / "patches" / f"{path.stem}.h5"
            if not h5_path.exists():
                skipped_missing += 1
                continue
            out = prep / "patch_features" / f"{path.stem}.{save_format}"
            if out.exists():
                resumed += 1  # interrupted runs restart where they stopped
                continue
            coords = h5.read_dataset(h5_path, "coords")
            # the grid geometry lives in the h5 attrs written at patch time:
            # trust those over the CLI flags, per slide, never mutating them
            attrs = h5.read_attrs(h5_path, "coords")
            ps = int(attrs.get("patch_size", patch_size))
            lv = int(attrs.get("patch_level", level))
            if ps != patch_size:
                print(
                    f"{path.stem}: using patch_size {ps} "
                    f"from the patches h5 (CLI said {patch_size})"
                )
            if lv != level:
                print(
                    f"{path.stem}: using level {lv} "
                    f"from the patches h5 (CLI said {level})"
                )
            if max_patches is not None:
                coords = coords[:max_patches]
            slide = OpenSlide(path)
            t0 = time.perf_counter()
            patches = read_patches(slide, coords, lv, ps)
            t1 = time.perf_counter()
            features = extractor(patches)  # (n, 2048) on the device
            read_s, extract_s = read_s + t1 - t0, extract_s + time.perf_counter() - t1
            if max_patches is not None and len(features) < max_patches:
                features = np.pad(
                    features, ((0, max_patches - len(features)), (0, 0))
                )
            if save_format == "npy":
                np.save(out, features)
            else:
                torch.save(torch.tensor(features), out)
            print(f"{path.stem}: {features.shape} features -> {out}")
            slide.close()
            done += 1
            total += len(coords)
        print(
            f"features: {done} extracted, {resumed} already present, "
            f"{skipped_missing} without a patches h5"
        )
        if done == 0 and resumed == 0 and skipped_missing > 0:
            print(
                "WARNING: no slide had a patches h5 under "
                f"{prep / 'patches'} — did you run --step patch at the same "
                "--level?"
            )
        return {"seconds": time.perf_counter() - t_step, "read_s": read_s,
                "extract_s": extract_s, "patches": total}

    raise ValueError("step must be 'patch' or 'features'")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="healnet_tpu data-ops (PyTorch port)")
    sub = parser.add_subparsers(dest="task", required=True)

    p = sub.add_parser("install")
    p.add_argument("--system", default="linux", choices=["linux", "mac"])

    p = sub.add_parser("download")
    p.add_argument("--dataset", required=True)
    p.add_argument("--config", default="config/main.yml")
    p.add_argument("--samples", type=int, default=None)

    p = sub.add_parser("flatten")
    p.add_argument("--dataset", required=True)
    p.add_argument("--config", default="config/main.yml")

    p = sub.add_parser("preprocess")
    p.add_argument("--dataset", required=True)
    p.add_argument("--config", default="config/main.yml")
    p.add_argument("--level", type=int, default=2)
    p.add_argument("--step", default="patch", choices=["patch", "features"])
    p.add_argument("--patch_size", type=int, default=256)
    p.add_argument("--max_patches", type=int, default=None)
    p.add_argument("--weights", default=None, help="local torchvision resnet50 .pt")
    p.add_argument("--save_format", default="npy", choices=["npy", "pt"])
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return parser


def main(argv: Optional[List[str]] = None):
    """Run the task ``argv`` names; returns what it returns (``preprocess``'s
    timings, None for the others)."""
    args = build_parser().parse_args(argv)
    if args.task == "install":
        return install(args.system)
    if args.task == "download":
        return download(args.dataset, args.config, args.samples)
    if args.task == "flatten":
        return flatten(args.dataset, args.config)
    return preprocess(
        args.dataset, args.config, args.level, args.step,
        args.patch_size, args.max_patches, args.weights, args.save_format,
        args.device,
    )


if __name__ == "__main__":
    main()
