#!/usr/bin/env python3
"""Smoke test of the PyTorch port (healnet_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit code:

1. build the CUDA kernels from ``healnet_tpu_torch/ops/csrc`` (nvcc, one
   process per source, started together);
2. hold the fused KV projection kernels against their plain PyTorch version:
   the Hopper kernel at the bf16 shapes of ``PROJECT_SHAPES`` (brca's and
   kirp's WSI bag, F 252 and 270, the trimodal third bag, the omic vector),
   the generic route (rows at any byte offset) at bf16 rows of 203 channels
   through ``fused_kv_project`` and at ``GENERIC_EDGES`` (bases 2, 6 and 14
   bytes off 16, C % 64 of 0, 1 and 63, a context that ends where its
   storage ends; many rows on the Hopper kernel's hull kinds, few on the
   split kernel), and the f32 kernel at small ragged f32 shapes (C
   200 and 203, F 70 to 600) and at the merged KV of a 576-wide head (F
   2304, both contexts at full size); each plan's shared memory against the
   kernel's own; profile one call of each bf16 shape, of ``GENERIC_SHAPES``
   (the parity-layout slide (8, 2048, 4095) and omic vector (8, 1, 2001),
   the README's image modality (8, 50176, 3), int8 rows of 2040, and brca,
   kirp and the aligned omic vector forced onto the generic route) and of
   brca, kirp and the omic vector in f32 (one launch on the route's
   counter; two calls bit-identical) and time kernel, plain version, the
   library GEMM alone (``torch.matmul`` f32 for f32) and the bound;
3. the same for the flash cross-attention kernel at (8, 17, 4096, 63) bf16:
   unmasked, masked with ragged lengths and one fully masked row, and with
   hash dropout, at kirp's (8, 17, 4096, 27) with its dropout, plus a small
   f32 case; the FMA variant at full size: f32 (8, 17, 4096, 63) and kirp's
   d 27, masked with a fully masked sample and dropout, and bf16 d 160 (the
   tensor cores take bf16 up to 128), two calls bit-identical; heads wider
   than 256 (``wide_cases``: d 257, 320 and 512 at lq 17 and 40 and d 320
   with K and V rows at odd offsets, the one-pass wide kernels; d 576, past
   them, the panel kernels (two panels of 288 over a cluster); and the
   one-token omic context at d 320, 512 and 576; f32 and bf16, masked,
   dropout 0.083), one launch a call counted by the kernel's own counter,
   two calls bit-identical, the wide and panel kernels' shared memory
   against the wrapper's reckoning (``wide_smem``); then at brca and kirp
   in bf16 (the tensor-core variant) and f32 (the FMA variant), at d 320
   and 512 in f32 and bf16 (the wide kernels) and at d 576 and 1024 in f32
   and bf16 (the panel kernels), unmasked: each call must be one kernel
   launch on the profiler, and the times of kernel, plain version, SDPA
   and the bound; the brca rows (tensor-core and FMA variant) timed again
   with dropout 0.083, every block reading the seed from a device word;
   and, at those rows, a forward and backward captured in a CUDA graph and
   replayed with two seeds in its seed word: each replay equal to the
   eager call with its seed, the two dropping different entries;
4. serve the full-width BRCA-tuned HealNet (bf16, batch 8, flash attention,
   random weights from a seeded generator) through ``Predictor``: a dense
   4096-token request of 20 samples, a request without the omic modality,
   and ragged bags across the 1024/2048/4096/8192 buckets; check the outputs
   against the same weights on the plain path, and that both kernels were
   launched by that run; then the kirp row (depth 5, l_d 62, inner 27) and
   the trimodal row (a third 1024 x 1024 bag) on one dense micro-batch of
   8, kernel path against plain path in bf16 and f32;
5. hold the flash cross-attention backward kernel against its plain version
   at (8, 17, 4096, 63) bf16 (unmasked, masked with a fully masked row,
   dropout 0.083), at the one-token omic context, at kirp's shape, at a
   small f32 shape and at phase 3's full-size FMA and wide-head cases (two
   calls bit-identical); profile and time it as phase 3 does the forward, with
   SDPA's backward as the library call; then forward and backward at latent
   counts past a block's query chunk (lq 33, 64, 128, 130, 256 at d 27, 63,
   96, 113, 128, bf16 and f32, masked with a fully masked row, dropout);
   the brca rows' backward timed with dropout as phase 3 times the forward;
6. the same for the projection backward (cotangent pass) kernel at
   (8, 4096, 252) bf16 and f32, kirp's F 270, a small f32 shape, the
   one-token omic context and batch 5000 of one token: one launch a call,
   two calls bit-identical, the full-size ones timed; each row of the
   column sums held column by column against an f64 sum, and the check
   shown to refuse them with the second row zeroed or one block's partial
   left out;
7. train the full-width BRCA model through ``SurvivalTrainer.train_step``
   (dropout 0.083 / 0.473, NLL/16 + L1, Adam under OneCycle): step-1 loss and
   gradients of the kernel path against the plain path with the same weights
   and dropout draws, in f32 (the run of the flash kernels' FMA variants)
   and bf16 (the f32 step also runs the f32 projection kernel; its wall,
   device busy and the f32 projection and flash FMA kernels' shares of it); then 5
   bf16 steps on the kernel path, the main path's run,
   which must launch all four kernels (the flash kernels' tensor-core
   variants) and give finite losses; step time, samples/s, peak memory and
   the flash kernels' share of the step's device time, and one step with
   plain attention for comparison; then one step of the brca model with a
   320-wide cross head in f32 and in bf16 (the runs of the one-pass wide
   kernels, FMA and tensor-core) and one step with a 576-wide head in f32
   and in bf16 (the runs of the panel kernels; only the head width is
   synthetic), kernel path against a reference step, with
   each flash call of the step (WSI and omic contexts, forward and
   backward) held against the plain version on its inputs; then the
   reference-parity layout (``patch_attention: false``): the brca model
   over an omic vector of 2,001 columns and a slide of (dim, n_patches) =
   (2048, 4095), one bf16 step through ``SurvivalTrainer.train_step`` on
   each of three draws of data, the kernel path's and the bf16 plain
   path's gradients against the plain path in f64 (the kernel path's worst
   within 1.5x the plain path's worst over the draws, as phase 10 holds
   its bf16 step), and one served batch through ``Predictor`` against the
   plain path: the main path's run of the generic route (both kernels),
   with its launches per step, wall, device busy and idle share;
8. hold ``quantize_context`` on the card bit-equal to the host's
   ``quantize_context_host`` at (40000, 2048) float16 and (8, 4096, 2048)
   bf16; the int8 branch of the projection kernels against its plain version
   at (8, 4096, 2048) int8 with per-token scales and the encoding, in bf16
   (the Hopper kernel) and f32 compute (the f32 kernel), kv, s1, s2, and at
   kirp's F 270 in bf16; time kernel, plain version, the library GEMM on the
   dequantized context and the bound at brca and kirp in bf16 and at brca
   in f32 compute, and fail if the int8 brca call is more than
   ``INT8_MARGIN`` slower than phase 2's bf16 one;
9. the same for the scaled cotangent pass with its batch-sum at
   (8, 4096, 252) bf16 (one launch, bit-identical, timed), and a small f32
   shape; and the time of the d_W_c GEMM that follows it (the int8 context
   cast to bf16, then the GEMM);
10. the feature-arena path at full width: 48 bags of 1024-4096 patches
   packed into an arena, quantized to int8 on the host by the trainer and
   uploaded once; step-1 gradients of the kernel path against the plain
   projection (same flash attention) in f32 (the run of the f32 kernel's
   int8 variant), and both paths' bf16 gradients
   against those f32 ones; then 5 arena steps in f32 and in bf16 on two
   trainers from the same weights, batches and seeds: stepwise
   (``train_step``) and fused (the bucket uploaded once with its seed
   table, the step captured as a CUDA graph and replayed): losses and
   weights after the 5 steps held to 1e-5 relative in f32 and to 2e-2 in
   bf16 (and whether they are bit-identical), with both ways' wall per
   step, device busy, idle share, host launch calls and peak memory; then
   5 bf16 training steps from the arena, which
   must launch both int8 kernel variants and give finite losses, with wall,
   device busy, idle share and the largest device items per step; then
   ``Predictor.predict_from_arena`` over the 48 bags (buckets 1024/2048/
   4096) against the kernel-free path and against ``predict_ragged`` on the
   dequantized bags, with wall per micro-batch and per request from the
   arena and from host arrays;
11. the fused latent chain at the brca, kirp and trimodal rows: the
   served model's merged KV (``project_contexts``) and stacked weights, a
   ragged WSI mask with a fully masked row, presence zeros, the row's
   attention dropout and FF keep multipliers; the chain's entry point once
   per row (the run whose launches count), held against the plain version
   in bf16 (in ulps of the output) and f32, one launch a call and two
   calls bit-identical, with each row's launch plan (cluster, keys per
   block), and the f32 chain's logits against ``module(x)``; times of
   kernel (also on the profiler), plain version and the module path's
   latent loop (device time and launches), and each row's bound;
12. the wrapper, remat, fit, resume and serving from a checkpoint, at the
   brca row in f32 (full width, flash attention, dropout 0.083 / 0.473; 24
   training, 8 validation and 8 test patients from the seed): ``HealNet``
   on ``[omic, wsi]`` and ``[omic, None]`` against ``HealNetModule`` on the
   plain path, with its lazy ``get_attention_weights``; one training step
   with and without ``remat`` from the same weights, dropout off and on
   (gradients, device time, peak memory); ``SurvivalTrainer.fit`` for 2
   epochs with prefetch and checkpoints (epoch and step wall, val and test
   c-index, the kernels it launched); a resumed trainer on the finished
   fold (the same val loss and c-index); ``Predictor`` from the checkpoint
   directory against the trained module; the idle share of one step;
   then a fused fold: the train and val patients' bags cut to 1024-4096
   patches in a host arena, batches in two bucket widths (2048, 4096),
   ``fit`` with ``fused_epochs=True`` for 2 epochs (each bucket's train and
   eval step captured once, a checkpoint an epoch), a fold stopped in epoch
   2 and resumed from epoch 1's checkpoint held against the uninterrupted
   one (1e-5 relative), and the captured and stepwise step's wall, busy,
   idle share and launches on one bucket's batches; which
   c-index implementation ran;
13. the pipeline and CLI at full width: a synthetic TCGA tree written to a
   temporary directory with numpy, ``zipfile`` and ``csv`` only (48 cases,
   2,000 genes, ragged float16 bags of 1,024-4,096 patches 2,048 wide, ~30%
   censored, the survival signal in both modalities, empty ``.h5`` files
   under ``patches/``); ``config/dress_rehearsal.yml`` pointed at it and cut
   to 2 folds of 2 epochs, buckets (2048, 4096) and bags of at most 4,096
   (bf16, the int8 arena on the card, fused epochs, checkpoints and resume
   kept; the ``brca`` row of ``config/best_hyperparams.yml`` at full width
   and depth); ``healnet_tpu_torch.cli.main.main`` in this process (the
   int8 and bf16 projection forward and backward counters above 0, every
   fold's summary metrics finite), with the dataset build and arena upload
   times, each fold's epoch walls, peak memory, and a captured step of the
   last fold replayed under the profiler (wall, busy, idle share); then
   ``python3 -m healnet_tpu_torch.cli.main`` again with the same run name in
   a second process, which finds both folds complete and evaluates their
   checkpoints: its test c-indices equal the first run's bit for bit;
14. the serving artifact at brca's full width and depth, in bf16 and f32,
   each under ``attention_impl="auto"`` (plain attention) and ``"flash"``:
   ``Predictor.export`` with ``example_shapes`` (1, 2000) and (4096, 2048)
   and widths 1024, 2048 and 4096 (each program's export seconds, the
   artifact's bytes), ``ExportedPredictor`` loaded and warmed in this
   process; every program's graph calls the registered projection op once
   a modality (and the flash forward op depth x modalities times under
   "flash"); 20 dense samples (as they are, without the omic modality,
   with a KV mask on the slide) and 24 ragged bags of 500-4096 patches
   served live and from the artifact: equal bit for bit (else the first
   ATen op where the graph leaves the live ops, and the logits within 2
   bf16 ulps / 1e-5 relative), the projection counters up by one a
   modality a program call and the flash ones by depth x modalities under
   "flash", no backward kernel; wall per micro-batch live and exported, and
   one micro-batch's wall, device busy and idle share on each; then a fresh
   ``python3 -c`` process that imports only
   ``healnet_tpu_torch.serving_export`` serves the ragged bags from all
   four artifacts (equal bit for bit, its counters above 0, no JAX
   imported); and the host time the registered ops add a call;
15. the explainer at full width: a TCGA tree (phase 13's, with CLAM coords
   files written by ``etl/h5.py::write_coords`` as a patch grid) of 24
   cases with bags of 1,024-4,096 patches and 2 of 50,176 (the README image
   modality's token count, 411 MB of float16 features); ``Pipeline`` with
   ``explainer: true`` and ``omic_attention: false`` (each of the 2,000
   genes a context token) trains one fold for one epoch (bf16, the int8
   arena, fused epochs, buckets 2048 / 4096 / 50176; the projection
   forward and backward counters above 0); ``Explainer(log_dir).run(n_high=2,
   n_low=1)`` on the card; then one 50,176-patch case explained twice,
   streamed (the default past 4,096 tokens: no dense capture called) and
   dense: omic and slide scores, heatmap and mask within the CPU tests'
   tolerances, every ``.npy`` of the JAX package's shapes, the projection
   counter above 0, and each explanation's wall time and peak memory;
16. the baselines at full width on phase 13's tree (48 cases, bags of
   1,024-4,096 x 2,048 float16): ``Pipeline`` trains one fold of two
   epochs of each model the JAX pipeline builds (fcnn, MCAT, SNN,
   MILAttentionNet, MMPrognosis, MOTCAT, MultiModN with ``aux_loss``) from
   ``config/dress_rehearsal.yml`` (fused epochs from the arena where the
   model takes one, ``quantize_arena`` ignored as in JAX; fcnn and SNN
   stream stepwise): finite metrics, epoch walls, peak memory, parameter
   counts, one width-4096 step under the profiler (the captured one where
   there is one: it must exist), an eval batch of 8 through the trained
   module on the card and on a CPU copy in f32 (``BASE_TOL``), and no
   projection, flash or chain counter moving; then
   ``MultiModNTrainer.fit`` for 2 epochs on 32 samples at the pipeline's
   widths, its history CSV and one prediction a sample;
17. multi-device on ``torch.distributed`` at brca's full width (bf16,
   flash attention): (a) a world of one over NCCL, 3 steps of
   ``SurvivalTrainer(mesh=make_mesh())`` stepwise and 3 fused (captured)
   from the int8 arena, against the mesh-free trainer on the same weights,
   batches and seeds: it runs no collective, so its losses and weights must
   be bit-identical; (b) worlds of 2 and 4 processes sharing the card over
   gloo (NCCL refuses two ranks on one device), one step in each of the
   layouts (2, 1, 1), (1, 2, 1), (1, 1, 2) and (1, 2, 2) against the
   single-process step (loss 6e-3 relative, every rank's gradient blocks
   0.04 relative L2: three times the worst of the sound runs), each rank's
   projection counters (and
   flash ones where seq is 1) above 0, the wall of a step (gloo stages
   through the host: not an NCCL time); (c) the int8 arena of 12 bags
   sharded over seq with a halo of 4,096 rows, gathered bit-equal to the
   replicated gather; (d) the CLI with phase 13's config, spmd and
   ``data.shard_arena`` (one fold of one epoch) in the world of one;
18. the data-ops CLI at full width: four synthetic slides of 131,072 x
   131,072 pixels (a large 40x TCGA slide; five levels at a downsample of
   4, stained tissue on white) drawn by a numpy stand-in for libopenslide
   (:class:`SyntheticSlideLib`, put in ``etl/slides.py``'s ``_LIB``);
   ``tasks.main(["preprocess", ..., "--step", "patch"])`` at level 2
   (a 32 x 32 grid of 256-pixel patches), then ``--step features`` with
   the ResNet-50 on the card (f32, TF32 off, batch 64, random weights from
   a seeded ``torch.Generator``): (a) the first 64 patches of a slide on
   the card against a CPU copy of the extractor, 1e-4 of the largest
   feature, with the two ``log_compile_time`` lines and a batch's device
   time under the profiler; (b) the coords read back through ``etl/h5.py``
   equal a second ``patch_slide``; (c) ``TCGADataset`` reads every bag as
   ``(n_coords, 2048)``, sized from the ``.npy`` header; (d) no projection,
   flash or chain counter moves during extraction; then one slide again
   through ``python3 -m healnet_tpu_torch.cli.tasks`` in a fresh process;
   the patches per slide, the walls of the patch step, of region reading
   and resizing on the host and of extraction, patches per second and peak
   memory;
19. print how many profiler windows saw no device kernel (each window
   stays open 50 ms before its first call and after its closing
   synchronise; one that still saw none is logged and taken again with
   three times the margin; a call whose six windows all saw none fails)
   and the windows' gaps from first launch to first kernel, the
   kernels line (every kernel variant, with its launches in the run of its
   path, and that count), then the device line.

Needs one CUDA GPU, nvcc, and the repository around this file.
"""

from __future__ import annotations

import contextlib
import copy
import csv
import io
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import zipfile
import zlib
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from healnet_tpu_torch.etl.h5 import write_coords
from healnet_tpu_torch.models import explainer as explainer_module
from healnet_tpu_torch.models.explainer import Explainer
from healnet_tpu_torch.models.baselines import (
    ClassDecoder,
    MLPEncoder,
    MultiModNHistory,
    MultiModNModule,
    PatchEncoder,
)
from healnet_tpu_torch.models.healnet import HealNet, HealNetModule
from healnet_tpu_torch.ops import cuda_build
from healnet_tpu_torch.ops.attention import multihead_attention
from healnet_tpu_torch.ops.fused_chain import (
    chain_launch_plan,
    chain_reference,
    chain_spec,
    fused_chain_kernel,
    fused_latent_chain,
    stack_chain_weights,
)
from healnet_tpu_torch.ops.flash_attention import (
    LAUNCH_COUNTERS,
    FlashAttentionFunction,
    flash_attention_bwd_kernel,
    flash_attention_kernel,
    flash_backward_plain,
    flash_fwd_op,
    flash_lse_plain,
    flash_panels,
    launch_counter,
    seed_word,
    wide_smem,
    _wide_lib,
)
from healnet_tpu_torch.ops.fourier import positional_encoding
from healnet_tpu_torch.ops.fused_project import (
    F32_WIDTHS,
    PROJECT_WIDTHS,
    SPLIT_SMEM,
    _f32_lib,
    _gemm_f32,
    _mu_inv,
    _prep,
    _project_launch,
    _project_plain,
    _split_lib,
    _tma_lib,
    _project_op_cuda,
    fused_kv_project,
    fused_project_bwd_kernel,
    fused_project_kernel,
    project_bwd_plain,
    project_bwd_plan,
    project_f32_smem,
    project_generic_plan,
    project_op,
    project_plain,
    project_smem,
)
from healnet_tpu_torch.ops.hash_dropout import dense_keep_mask
from healnet_tpu_torch.ops.quantize import (
    QuantizedContext,
    quantize_context,
    quantize_context_host,
)
from healnet_tpu_torch.parallel.arena import gather_bag
from healnet_tpu_torch.serving import Predictor
from healnet_tpu_torch.serving_export import ExportedPredictor
from healnet_tpu_torch.train.checkpoint import Checkpointer
from healnet_tpu_torch.train.loop import SurvivalTrainer, iterate_batches
from healnet_tpu_torch.train.multimodn_trainer import MultiModNTrainer
from healnet_tpu_torch.cli.main import main as cli_main
from healnet_tpu_torch.etl import train_val_test_split
from healnet_tpu_torch.train.metrics import cindex_implementation
from healnet_tpu_torch.train.pipeline import _DATASET_CACHE, Pipeline
from healnet_tpu_torch.utils import Config, count_parameters

REPO = Path(__file__).resolve().parent

# kernel variant -> (its wrapper, the wrapper's launch counter for it)
KERNELS = {"fused_project": (fused_project_kernel, "launches"),
           "fused_project_generic": (fused_project_kernel, "launches_generic"),
           "fused_project_generic_split": (fused_project_kernel, "launches_generic_split"),
           "fused_project_f32": (fused_project_kernel, "launches_f32"),
           "fused_project_f32_int8": (fused_project_kernel, "launches_f32_int8"),
           "fused_project_bwd": (fused_project_bwd_kernel, "launches"),
           "flash_attention": (flash_attention_kernel, "launches"),
           "flash_attention_bwd": (flash_attention_bwd_kernel, "launches"),
           "flash_attention_fma": (flash_attention_kernel, "launches_fma"),
           "flash_attention_bwd_fma": (flash_attention_bwd_kernel, "launches_fma"),
           "flash_attention_wide_fma": (flash_attention_kernel, "launches_wide_fma"),
           "flash_attention_bwd_wide_fma": (flash_attention_bwd_kernel, "launches_wide_fma"),
           "flash_attention_wide_tc": (flash_attention_kernel, "launches_wide_tc"),
           "flash_attention_bwd_wide_tc": (flash_attention_bwd_kernel, "launches_wide_tc"),
           "flash_attention_panel_fma": (flash_attention_kernel, "launches_panel_fma"),
           "flash_attention_bwd_panel_fma": (flash_attention_bwd_kernel, "launches_panel_fma"),
           "flash_attention_panel_tc": (flash_attention_kernel, "launches_panel_tc"),
           "flash_attention_bwd_panel_tc": (flash_attention_bwd_kernel, "launches_panel_tc"),
           "fused_project_int8": (fused_project_kernel, "launches_int8"),
           "fused_project_bwd_int8": (fused_project_bwd_kernel, "launches_int8"),
           "fused_chain": (fused_chain_kernel, "launches")}
FLOAT_KERNELS = ("fused_project", "fused_project_bwd", "flash_attention", "flash_attention_bwd")

# H100 SXM data-sheet peaks (dense): bytes/s of HBM3, FLOP/s per type
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

# the BRCA-tuned model of bench.py, at full width and depth
BRCA = dict(
    n_modalities=2, channel_dims=(2000, 2048), num_spatial_axes=(1, 1), out_dims=4,
    depth=2, l_c=17, l_d=126, x_heads=1, cross_dim_head=63, l_heads=8,
    latent_dim_head=20, self_per_cross_attn=0, snn=True, num_freq_bands=2, max_freq=2.0,
    attn_dropout=0.083, ff_dropout=0.473,
)
BATCH, TOKENS, OMIC, PATCH = 8, 4096, 2000, 2048
BUCKETS = [1024, 2048, 4096, 8192]
# bench.py's rows (bench.py:55-69) at full width: brca is the dict above,
# kirp the tuned depth-5 model, trimodal brca with a third 1024 x 1024 bag
EXTRA = (1024, 1024)
ROWS = {
    "brca": {},
    "kirp": dict(depth=5, l_d=62, cross_dim_head=27, latent_dim_head=113,
                 attn_dropout=0.31789955176609086, ff_dropout=0.04735283995174411),
    "trimodal": dict(n_modalities=3, channel_dims=(OMIC, PATCH, EXTRA[1]),
                     num_spatial_axes=(1, 1, 1)),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def wall_ms(fn, reps: int = 5) -> float:
    """Median wall milliseconds of single synchronised calls (after one
    warm-up call), launch cost included."""
    fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return statistics.median(walls) * 1e3


def time_ms(fn, reps: int = 20):
    """(device ms per call, wall ms per synchronous call).

    Device: the median of ``reps`` per-call CUDA-event timings, the calls
    queued back to back behind a sleep kernel with an event between each,
    so the host's launch cost is hidden as long as the queue stays ahead
    (a note is printed when it does not). Wall: :func:`wall_ms`.
    """
    wall = wall_ms(fn) / 1e3
    events = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
    sleep_s = 0.005 + 2 * wall * reps
    torch.cuda._sleep(int(2e9 * sleep_s))  # clock64 cycles at ~2 GHz
    t0 = time.perf_counter()
    events[0].record()
    for event in events[1:]:
        fn()
        event.record()
    queued = time.perf_counter() - t0 < sleep_s
    events[-1].synchronize()
    if not queued:
        log("  (timing: the host fell behind the device; device time includes launch gaps)")
    per_call = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    return statistics.median(per_call), wall * 1e3


def device_us(evt) -> float:
    return float(getattr(evt, "self_device_time_total", 0.0)
                 or getattr(evt, "self_cuda_time_total", 0.0))


# profiler windows that saw no device kernel: (the host's events, its kernel
# launch calls), each logged where it happens and counted at the end
EMPTY_WINDOWS = []
# the host's launch calls per call (kernel launches, graph launches) in the
# last window of device_profile
HOST_LAUNCHES = [0.0]
# each window's first device event start minus its first launch call start,
# on the profiler's clock, in us (a kernel cannot start before its launch:
# a negative or growing value is an offset between the device's and the
# host's clocks, which moves a short window's kernels out of its range)
WINDOW_GAPS = []
# how long a window stays open before its first call and after its closing
# synchronise; a window that saw no device kernel is taken again with three
# times the margin
SETTLE_S = 0.05


def device_profile(fn, reps: int = 3):
    """``torch.profiler`` over ``reps`` calls after three warm-up calls:
    (wall ms per call with the profiler on, device busy ms per call,
    kernels and copies per call, their averaged events); the host's launch
    calls per call (``cudaLaunchKernel`` and its kin, ``cudaGraphLaunch``)
    go to ``HOST_LAUNCHES[0]``. Busy time sums the kernels' and copies' own
    device times; annotation ranges (such as ``Optimizer.step``) span
    kernels already counted and are left out.

    The profiler keeps only device events that fall inside its window on
    the host's clock. Each window therefore stays open ``SETTLE_S`` before
    the first call and after the closing synchronise, and each records the
    gap between its first device event and its first launch call
    (``WINDOW_GAPS``). A window that saw no device kernel is logged with
    what the host saw (its events, its kernel launch calls) and the gaps of
    the windows before it, counted (the kernels line gives the count), and
    taken again with three times the margin; a call whose six windows all
    saw no device kernel fails."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for attempt in range(6):
        margin = SETTLE_S * 3**attempt
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(margin)
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / reps
            time.sleep(margin)
        events = prof.events()
        rows = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA and device_us(e) > 0
                and not getattr(e, "is_user_annotation", False)]
        calls = [e for e in events if e.name.startswith(("cudaLaunch", "cuLaunch",
                                                          "cudaGraphLaunch"))]
        if rows:
            kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
            if kernels and calls:
                WINDOW_GAPS.append(min(e.time_range.start for e in kernels)
                                   - min(e.time_range.start for e in calls))
            break
        EMPTY_WINDOWS.append((len(events), len(calls)))
        log(f"  profiler window {attempt + 1} ({margin:.2f} s margins) saw no device kernel "
            f"({len(events)} host events, {len(calls)} launch calls; the last windows' first "
            f"kernel - first launch: {[round(g, 1) for g in WINDOW_GAPS[-5:]]} us); profiled "
            "again")
    if not rows:
        raise AssertionError("six profiler windows in a row saw no device kernel")
    HOST_LAUNCHES[0] = len(calls) / reps
    busy = sum(device_us(e) for e in rows) / 1e3 / reps
    return wall, busy, sum(e.count for e in rows) / reps, rows


def bound_ms(nbytes: float, flops: float, dtype: torch.dtype):
    """Least time for the work on an H100 SXM, and what bounds it."""
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bf16_ulp(x: float) -> float:
    """Spacing of bf16 numbers at magnitude ``x`` (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(max(abs(x), 2.0**-126))) - 7)


def check(name: str, err: float, tol: float) -> None:
    log(f"  {name}: max|d| = {err:.6g} (tolerance {tol:.6g})")
    if not err <= tol:
        raise AssertionError(f"{name}: max|d| {err} exceeds {tol}")


def reset_launches() -> None:
    for fn, counter in KERNELS.values():
        setattr(fn, counter, 0)


def read_launches(run: str, names) -> dict:
    """The named kernel variants' launch counts since
    :func:`reset_launches`; fails if one of them was never launched."""
    launches = {name: getattr(*KERNELS[name]) for name in names}
    log(f"  launches in {run}: {launches}")
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"{run} never launched {name}")
    return launches


# ---------------------------------------------------------------- phase 2


def projection_case(gen, b, t, c, f, dtype, enc_on=True):
    dev = "cuda"
    dat = torch.randn((b, t, c), generator=gen, device=dev).to(dtype)
    enc = positional_encoding((t,), 2.0, 2, dtype=dtype, device=dev) if enc_on else None
    e = 0 if enc is None else enc.shape[-1]
    w_all = torch.randn((c + e, f), generator=gen, device=dev) * 0.02
    b_all = torch.randn((f,), generator=gen, device=dev) * 0.1
    ops = _prep(dat, enc, w_all, b_all, dtype)
    run = lambda: fused_project_kernel(dat, *ops, w_all.shape[0], 1e-5)
    plain = lambda: project_plain(dat, enc, w_all, b_all)
    return dat, enc, w_all, b_all, ops, run, plain


# the projection's timed shapes: (b, t, C, F, context dtype), int8 computing
# in bf16: brca's and kirp's WSI bag (the merged F of the row), the trimodal
# row's third bag and the omic vector
PROJECT_SHAPES = {"brca": (BATCH, TOKENS, PATCH, 252, torch.bfloat16),
                  "kirp": (BATCH, TOKENS, PATCH, 270, torch.bfloat16),
                  "trimodal bag": (BATCH, *EXTRA, 252, torch.bfloat16),
                  "omic": (BATCH, 1, OMIC, 252, torch.bfloat16),
                  "brca int8": (BATCH, TOKENS, PATCH, 252, torch.int8),
                  "kirp int8": (BATCH, TOKENS, PATCH, 270, torch.int8)}


def projection_case_at(gen, b, t, c, f, dtype, int8_cdt=torch.bfloat16, offset=None):
    """A seeded projection call: the context (int8 with per-token scales and
    a zero row, computing in ``int8_cdt``; with ``offset``, placed that many
    bytes past a 16-byte aligned base in a storage that ends where the
    context ends), the encoding and merged weights. Returns (dat, scale, cdt, ops,
    w_all, a2d: the context as the GEMM's bf16 or f32 operand, plain: the
    plain version's ``(kv, s1, s2)`` as a function)."""
    x = torch.randn((b, t, c), generator=gen, device="cuda")
    scale, cdt = None, dtype
    if dtype == torch.int8:
        qc = quantize_context(x)
        qc.scale[0, 0] = 0.0
        qc.data[0, 0] = 0
        dat, scale, cdt = qc.data, qc.scale, int8_cdt
        a2d = qc.dequantize(cdt).reshape(-1, c)
    else:
        dat = x.to(dtype)
        a2d = dat.reshape(-1, c)
    if offset is not None:
        lead = offset // dat.element_size()
        store = torch.empty((lead + dat.numel(),), dtype=dat.dtype, device="cuda")
        store[lead:] = dat.reshape(-1)
        dat = store[lead:].view(b, t, c)
        if dat.data_ptr() % 16 != offset % 16:
            raise AssertionError(f"the context lies {dat.data_ptr() % 16} bytes off 16")
    enc = positional_encoding((t,), 2.0, 2, dtype=cdt, device="cuda")
    w_all = torch.randn((c + enc.shape[-1], f), generator=gen, device="cuda") * 0.02
    b_all = torch.randn((f,), generator=gen, device="cuda") * 0.1
    ops = _prep(dat, enc, w_all, b_all, cdt)
    plain = lambda: _project_plain(dat, enc, w_all, b_all, 1e-5, scale, cdt)
    return dat, scale, cdt, ops, w_all, a2d, plain


def projection_timing(gen, b, t, c, f, dtype, int8_cdt=torch.bfloat16, route=None):
    """(times, run) of one projection shape (:func:`projection_case_at`) on
    ``route`` (the call's own, or ``"generic"`` forced); ``run()``
    launches the kernel. Times: the kernel, the plain version,
    ``torch.matmul`` of the GEMM alone (on the dequantized bf16 context for
    int8) and the bound (every input read once, the weights as the (C, F)
    the function needs and not the kernel's padded layout, the output
    written once; 2 C F operations a row at the compute dtype's rate). Also the kernel's
    largest difference from the plain version (``err``), the plain output's
    largest magnitude (``ref_max``) and the row statistics' largest
    relative differences (``stat_err``)."""
    dat, scale, cdt, ops, w_all, a2d, plain = projection_case_at(gen, b, t, c, f, dtype,
                                                                int8_cdt)
    run = lambda: _project_launch(dat, *ops, w_all.shape[0], 1e-5, scale, route)
    kv, s1, s2 = run()
    ref, r1, r2 = plain()
    err = (kv.float() - ref.float()).abs().max().item()
    stat_err = max(((s - r).abs().max() / r.abs().max().clamp_min(1.0)).item()
                   for s, r in ((s1, r1), (s2, r2)))
    w = w_all[:c].to(cdt)
    (t_kernel, w_kernel), (t_plain, _) = time_ms(run), time_ms(lambda: plain()[0])
    t_library, _ = time_ms(lambda: torch.matmul(a2d, w))
    moved = nbytes(dat, w, *ops[1:], kv, s1, s2) + (0 if scale is None else nbytes(scale))
    bound, by = bound_ms(moved, 2.0 * b * t * c * f, cdt)
    return dict(ms=t_kernel, wall_ms=w_kernel, plain_ms=t_plain, library_ms=t_library,
                bound_ms=bound, bound_by=by, mb=moved / 1e6, err=err, stat_err=stat_err,
                ref_max=ref.float().abs().max().item()), run


def time_projection(gen, label, shape=None, int8_cdt=torch.bfloat16, route=None):
    """Profile one call of a ``PROJECT_SHAPES`` entry (or of ``shape``; a
    call must be one launch) on ``route`` and time it; two calls must give
    the same bits. Returns its times."""
    b, t, c, f, dtype = shape or PROJECT_SHAPES[label]
    timing, run = projection_timing(gen, b, t, c, f, dtype, int8_cdt, route)
    kinds, prof = launch_profile(run)
    log(f"  {label} ({b}, {t}, {c}) {str(dtype)[6:]} -> F {f}: kernels on the profiler: {prof}")
    if kinds != 1:
        raise AssertionError(f"{label}: a projection call launched {kinds} kernels, not 1")
    one, two = run(), run()
    if not all(torch.equal(x, y) for x, y in zip(one, two)):
        raise AssertionError(f"{label}: two calls differ")
    log(f"  {label}: device time kernel {timing['ms']:.4f} ms, plain {timing['plain_ms']:.4f} "
        f"ms, torch.matmul of the GEMM alone {timing['library_ms']:.4f} ms, bound "
        f"{timing['bound_ms']:.4f} ms ({timing['bound_by']}; {timing['mb']:.1f} MB, "
        f"{2.0 * b * t * c * f / 1e9:.1f} GFLOP); two calls bit-identical; wall per call "
        f"{timing['wall_ms']:.4f} ms")
    return timing


def projection_entry(name, source, replaces, err, timing) -> dict:
    return dict(name=name, route="cuda", source=source, replaces=replaces, max_abs_err=err,
                ms=timing["ms"], plain_ms=timing["plain_ms"], bound_ms=timing["bound_ms"],
                bound_by=timing["bound_by"], library_ms=timing["library_ms"])


# the f32 route's timed shapes: brca's and kirp's WSI bag and the omic
# vector in f32
F32_SHAPES = {"brca f32": (BATCH, TOKENS, PATCH, 252, torch.float32),
              "kirp f32": (BATCH, TOKENS, PATCH, 270, torch.float32),
              "omic f32": (BATCH, 1, OMIC, 252, torch.float32)}


# the generic route's timed shapes: (b, t, C, F, context dtype, forced onto
# the route): the reference-parity layout's slide (dim, n_patches) with a
# largest bag of 4,095 patches and its omic vector of 2,001 columns, the
# README's image modality (224 x 224 tokens of 3 channels), int8 rows of
# 2040 channels (8 bytes off 16), and brca's and kirp's bag and the aligned
# omic vector, whose own route is the Hopper kernel's, forced onto it
GENERIC_SHAPES = {"parity wsi": (BATCH, 2048, 4095, 252, torch.bfloat16, False),
                  "parity omic": (BATCH, 1, 2001, 252, torch.bfloat16, False),
                  "image": (BATCH, 224 * 224, 3, 252, torch.bfloat16, False),
                  "int8 2040": (BATCH, TOKENS, 2040, 252, torch.int8, False),
                  "brca forced": (BATCH, TOKENS, PATCH, 252, torch.bfloat16, True),
                  "kirp forced": (BATCH, TOKENS, PATCH, 270, torch.bfloat16, True),
                  "omic forced": (BATCH, 1, OMIC, 252, torch.bfloat16, True)}
# the generic route's edges: (b, t, C, dtype, base offset in bytes); each
# context ends where its storage ends. Many rows (the hull kinds) and few
# (the split kernel); bases 2, 6 and 14 bytes off 16 (1, 3, 7 int8); C % 64
# of 0, 1 and 63 (the k-tail); C 1 and 3
GENERIC_EDGES = [(2, 300, c, dtype, off) for dtype, offs in
                 ((torch.bfloat16, (2, 6, 14)), (torch.int8, (1, 3, 7)))
                 for c in (2048, 2049, 2047) for off in offs]
GENERIC_EDGES += [(BATCH, 1, c, torch.bfloat16, off) for c in (2048, 2049, 2047, 1, 3)
                  for off in (2, 14)]
GENERIC_EDGES += [(2, 300, c, torch.bfloat16, 0) for c in (1, 3, 203)]


def generic_kernel(m, c, f, dtype):
    """The ``KERNELS`` name of the generic route's kernel that the plan
    picks for a call of ``m`` rows."""
    counter = project_generic_plan(m, c, f, dtype.itemsize).counter
    return next(name for name, (fn, attr) in KERNELS.items()
                if fn is fused_project_kernel and attr == counter)


def check_generic(label, got, ref, dtype):
    """A generic call against the plain version: kv within 4 bf16 ulps of
    the largest output; s1, s2 as f32 sums in another order, or (int8) the
    exact integer sums scaled against the plain version's f32 sums."""
    (kv, s1, s2), (r, r1, r2) = got, ref
    check(f"{label} kv", (kv.float() - r.float()).abs().max().item(),
          4 * bf16_ulp(r.float().abs().max().item()))
    for name, a, b in (("s1", s1, r1), ("s2", s2, r2)):
        check(f"{label} {name} (relative to max(1, |{name}|))",
              ((a - b).abs() / b.abs().clamp_min(1.0)).max().item(),
              2e-6 if dtype == torch.int8 else 1e-5)


def phase_projection(gen):
    """Returns the kernels-line entries of the Hopper kernel (bf16
    contexts), the f32 kernel (f32 contexts at the brca shape) and the
    generic route's two kernels (the Hopper kernel's hull kinds at the
    parity layout's slide, the split kernel at its omic vector), each with
    its error at the shape it is timed at, and the timings of every
    ``GENERIC_SHAPES`` entry and of the Hopper kernel's bf16 shapes."""
    log("phase 2: fused KV projection kernels vs plain version")
    # bf16 tolerance: the kernel and the plain version round the product to
    # bf16 at the same place but sum it in another order, so a raw value may
    # round one bf16 ulp apart, and the output rounds once more: 4 ulps of
    # the largest output leaves a margin of two
    worst = 0.0
    for label, (b, t, c, f, dtype) in PROJECT_SHAPES.items():
        if dtype != torch.bfloat16:
            continue
        reset_launches()
        *_, ops, run, plain = projection_case(gen, b, t, c, f, dtype)
        kv, s1, s2 = run()
        ref = plain()
        torch.cuda.synchronize()
        err = (kv.float() - ref.float()).abs().max().item()
        check(f"bf16 {label} {(b, t, c)} F={f}", err, 4 * bf16_ulp(ref.float().abs().max().item()))
        read_launches(f"the bf16 {label} call", ("fused_project",))
        if label == "brca":
            worst = err
    # the generic route through the entry point: bf16 rows of 203 channels
    # (406 bytes, which TMA cannot describe)
    dat, enc, w_all, b_all, *_ = projection_case(gen, 2, 300, 203, 252, torch.bfloat16)
    reset_launches()
    kv = fused_kv_project(dat, enc, w_all, b_all)
    read_launches("the bf16 C=203 call (rows TMA cannot describe)", ("fused_project_generic",))
    ref = project_plain(dat, enc, w_all, b_all)
    check("bf16 generic (2, 300, 203) F=252", (kv.float() - ref.float()).abs().max().item(),
          4 * bf16_ulp(ref.float().abs().max().item()))
    # the generic route's edges: one launch a call on the plan's kernel
    for b, t, c, dtype, off in GENERIC_EDGES:
        dat, scale, cdt, ops, w_all, _, plain = projection_case_at(gen, b, t, c, 252, dtype,
                                                                   offset=off)
        name = generic_kernel(b * t, c, 252, dtype)
        reset_launches()
        got = _project_launch(dat, *ops, w_all.shape[0], 1e-5, scale)
        counts = {k: getattr(*KERNELS[k]) for k in KERNELS}
        if counts[name] != 1 or sum(counts.values()) != 1:
            raise AssertionError(f"generic ({b}, {t}, {c}) {dtype} +{off} B: launches {counts}")
        check_generic(f"generic ({b}, {t}, {c}) {str(dtype)[6:]} {off} B off 16 [{name}]", got,
                      plain(), dtype)
    # f32 (the f32 kernel): full f32 products summed in another order than
    # cuBLAS's full-f32 GEMM agree to ~1e-6 of values ~1; C = 200 rows are
    # staged by 16-byte copies, C = 203 element by element; F 600 takes
    # three column passes
    for c in (200, 203):
        for f in (70, 252, 270, 600):
            *_, ops, run, plain = projection_case(gen, 2, 300, c, f, torch.float32)
            err = (run()[0] - plain()).abs().max().item()
            check(f"f32 ragged (2, 300, {c}) F={f}", err, 1e-4)
    # the merged KV of phase 7's step with a PANEL_D-wide head (F 4 d over
    # its two layers), both contexts at full size, as that step runs them
    for b, t, c in ((BATCH, TOKENS, PATCH), (BATCH, 1, OMIC)):
        *_, ops, run, plain = projection_case(gen, b, t, c, 4 * PANEL_D, torch.float32)
        err = (run()[0] - plain()).abs().max().item()
        check(f"f32 {(b, t, c)} F={4 * PANEL_D} (a {PANEL_D}-wide head)", err, 1e-4)
        del ops, run, plain

    # each kernel's shared memory as its plan reckons it
    for nb in F32_WIDTHS:
        for itemsize in (4, 1):
            got = _f32_lib().healnet_fused_project_f32_smem(nb, int(itemsize == 1))
            want = project_f32_smem(nb, itemsize)
            if got != want:
                raise AssertionError(f"f32 kernel nb={nb} itemsize={itemsize}: {got} B of "
                                     f"shared memory, the plan reckons {want}")
    for nb in PROJECT_WIDTHS:
        for itemsize in (2, 1):
            for hull in (False, True):
                for stages, held in ((2, False), (3, False), (4, True)):
                    got = _tma_lib().healnet_fused_project_tma_smem(nb, itemsize, stages, nb,
                                                                    int(held), int(hull))
                    want = project_smem(nb, itemsize, stages, nb, held, hull)
                    if got != want:
                        raise AssertionError(f"Hopper kernel nb={nb} itemsize={itemsize} "
                                             f"hull={hull}: {got} B, the plan reckons {want}")
    for is_int8 in (0, 1):
        got = _split_lib().healnet_fused_project_split_smem(is_int8)
        if got != SPLIT_SMEM:
            raise AssertionError(f"split kernel: {got} B of shared memory, the plan reckons "
                                 f"{SPLIT_SMEM}")
    log("  shared memory: every plan's reckoning is the kernels' own")

    timings = {label: time_projection(gen, label)
               for label, shape in PROJECT_SHAPES.items() if shape[-1] == torch.bfloat16}
    brca = timings["brca"]
    log(f"  kirp (F 270) against brca (F 252): {timings['kirp']['ms'] / brca['ms']:.3f}x the "
        f"time; brca against torch.matmul of the GEMM alone: "
        f"{brca['ms'] / brca['library_ms']:.3f}x")
    generic = {}
    for label, (b, t, c, f, dtype, forced) in GENERIC_SHAPES.items():
        name = generic_kernel(b * t, c, f, dtype)
        reset_launches()
        generic[label] = time_projection(gen, label, (b, t, c, f, dtype),
                                         route="generic" if forced else None)
        counts = {k: getattr(*KERNELS[k]) for k in KERNELS}
        if counts[name] == 0 or sum(counts.values()) != counts[name]:
            raise AssertionError(f"{label}: the generic calls launched {counts}")
        timing = generic[label]
        check(f"{label} generic [{name}] kv", timing["err"], 4 * bf16_ulp(timing["ref_max"]))
        check(f"{label} generic s1, s2 (relative)", timing["stat_err"],
              2e-6 if dtype == torch.int8 else 1e-5)
    for label, ref in (("brca forced", "brca"), ("kirp forced", "kirp"),
                       ("omic forced", "omic")):
        log(f"  {label} on the generic route: {generic[label]['ms'] / timings[ref]['ms']:.3f}x "
            f"the Hopper kernel's time on its own route ({generic[label]['ms']:.4f} against "
            f"{timings[ref]['ms']:.4f} ms)")
    for label, timing in generic.items():
        log(f"  {label}: generic {timing['ms']:.4f} ms, {timing['ms'] / timing['library_ms']:.3f}x "
            f"torch.matmul's {timing['library_ms']:.4f} ms, {timing['ms'] / timing['bound_ms']:.2f}x "
            f"the bound {timing['bound_ms']:.4f} ms ({timing['bound_by']})")
    reset_launches()
    f32 = {label: time_projection(gen, label, shape)
           for label, shape in F32_SHAPES.items()}
    read_launches("the f32 brca, kirp and omic calls (checks and timing)", ("fused_project_f32",))
    for label, timing in f32.items():
        # sums of 2000-2048 products in another order than cuBLAS's
        # full-f32 GEMM, outputs of magnitude ~1-5 (as phase 8's f32 case)
        check(f"{label} {F32_SHAPES[label][:3]}", timing["err"], 1e-4)
    log(f"  f32 kernel at brca: {f32['brca f32']['ms'] / f32['brca f32']['library_ms']:.3f}x "
        f"torch.matmul f32's time, {f32['brca f32']['bound_ms'] / f32['brca f32']['ms']:.3f} of "
        f"the bound; kirp against brca {f32['kirp f32']['ms'] / f32['brca f32']['ms']:.3f}x")
    source = "healnet_tpu_torch/ops/csrc/"
    replaces = "healnet_tpu/ops/fused_project.py:162"
    return (projection_entry("fused_project", source + "fused_project_tma.cu", replaces, worst,
                             brca),
            projection_entry("fused_project_f32", source + "fused_project_f32.cu", replaces,
                             f32["brca f32"]["err"], f32["brca f32"]),
            projection_entry("fused_project_generic", source + "fused_project_tma.cu", replaces,
                             generic["parity wsi"]["err"], generic["parity wsi"]),
            projection_entry("fused_project_generic_split", source + "fused_project.cu",
                             replaces, generic["parity omic"]["err"], generic["parity omic"]),
            )


# ---------------------------------------------------------------- phase 3


def attention_inputs(gen, b, lq, lkv, d, dtype, width=None):
    """q (b, 1, lq, d), and k/v as the column slices at element offsets d
    and 2 d of a merged KV buffer (b, lkv, width), 4 d wide unless given
    (brca's is 252 = 4 x 63, kirp's 270), as the model hands them over."""
    q = torch.randn((b, lq, d), generator=gen, device="cuda").to(dtype)[:, None]
    kv = torch.randn((b, lkv, width or 4 * d), generator=gen, device="cuda").to(dtype)
    return q, kv[..., d:2 * d][:, None], kv[..., 2 * d:3 * d][:, None]



def launch_profile(fn):
    """(device kernels a call launches, a line naming each with its mean
    device microseconds per launch and its launches per call), from
    :func:`device_profile` over 3 calls (the profiler may drop an event,
    so times are per launch seen)."""
    _, _, _, rows = device_profile(fn)
    parts = [f"{e.key.replace('void ', '').replace('(anonymous namespace)::', '')[:48]} "
             f"{device_us(e) / e.count:.2f} us per launch ({e.count / 3:.2f} per call)"
             for e in rows]
    return len(rows), "; ".join(parts)


# the flash kernels' timed shapes: (8, 17, 4096, d), K and V slices of a
# merged KV buffer of the row's width, unmasked
FLASH_SHAPES = {"brca": (63, 252, torch.bfloat16), "kirp": (27, 270, torch.bfloat16),
                "brca f32": (63, 252, torch.float32), "kirp f32": (27, 270, torch.float32)}


def flash_entry(name, source, replaces, err, timing) -> dict:
    t_kernel, t_plain, t_library, bound, by = timing
    return dict(name=name, route="cuda", source=source, replaces=replaces, max_abs_err=err,
                ms=t_kernel, plain_ms=t_plain, bound_ms=bound, bound_by=by,
                library_ms=t_library)


def time_flash(label, run, plain, library, moved, flops, dtype, library_name):
    """Profile one call (it must be one kernel launch, in either variant),
    then time kernel, plain version and library call; returns the
    kernels-line times."""
    kinds, prof = launch_profile(run)
    log(f"  {label}: kernels on the profiler: {prof}")
    if kinds != 1:
        raise AssertionError(f"{label}: a call launched {kinds} kernels, not 1")
    (t_kernel, w_kernel), (t_plain, w_plain) = time_ms(run), time_ms(plain)
    t_library, _ = time_ms(library)
    bound, by = bound_ms(moved, flops, dtype)
    log(f"  {label}: device time kernel {t_kernel:.4f} ms, plain {t_plain:.4f} ms, "
        f"{library_name} {t_library:.4f} ms, bound {bound:.5f} ms ({by}; {moved / 1e6:.2f} MB, "
        f"{flops / 1e9:.3f} GFLOP); wall per call: kernel {w_kernel:.4f} ms, plain "
        f"{w_plain:.4f} ms")
    return t_kernel, t_plain, t_library, bound, by


def fma_cases(mask) -> dict:
    """The FMA variant's full-size cases of phases 3 and 5: (head dim, KV
    width, dtype, mask, dropout rate) at (8, 17, 4096, d); the mask has a
    fully masked sample, and the bf16 case's odd width puts its K and V rows
    at 2-byte offsets."""
    return {"f32 (8, 17, 4096, 63) masked, dropout 0.083": (63, 252, torch.float32, mask, 0.083),
            "f32 kirp (8, 17, 4096, 27) masked, dropout 0.318": (
                27, 270, torch.float32, mask, ROWS["kirp"]["attn_dropout"]),
            "bf16 (8, 17, 4096, 160) masked, dropout 0.083": (
                160, 641, torch.bfloat16, mask, 0.083)}


WIDE_D = 320  # the timed wide head (and the wide steps' cross head)
WIDE_MAX_D = 512  # the widest head of the one-pass wide kernels, also timed
PANEL_D = 576  # a head past them: two panels of 288 (and the panel steps' cross head)
PANEL_FULL_D = 1024  # two full panels of 512, also timed


def wide_cases() -> dict:
    """Heads wider than 256 at (8, lq, lkv, d): (head dim, dtype, lq, KV
    width, lkv, masked) with K and V slices of a merged KV buffer of width
    4 d (1283 in the odd-pitch case, whose rows sit at odd 2-byte (bf16) or
    4-byte (f32) offsets), dropout 0.083, masked with a fully masked sample
    (the first ``lkv`` columns of the phase's mask) or unmasked. lkv 1 is
    the omic context, half of a step's wide launches: one partial key tile
    on a cluster of 1."""
    cases = {}
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt)[6:]
        for d in (257, WIDE_D, WIDE_MAX_D):
            for lq in (17, 40):
                cases[f"{name} (8, {lq}, 4096, {d})"] = (d, dt, lq, 4 * d, TOKENS, True)
        cases[f"{name} (8, 17, 4096, {WIDE_D}) KV pitch 1283"] = (
            WIDE_D, dt, 17, 1283, TOKENS, True)
        cases[f"{name} (8, 17, 4096, {PANEL_D}) panels"] = (
            PANEL_D, dt, 17, 4 * PANEL_D, TOKENS, True)
        for d in (WIDE_D, WIDE_MAX_D, PANEL_D):
            cases[f"{name} (8, 17, 1, {d})"] = (d, dt, 17, 4 * d, 1, True)
        cases[f"{name} (8, 17, 1, {WIDE_D}) unmasked"] = (WIDE_D, dt, 17, 4 * WIDE_D, 1, False)
    return cases


# the wide heads' timed shapes: (label, head dim, dtype) at (8, 17, 4096, d)
WIDE_TIMED = [(f"{'wide' if d <= WIDE_MAX_D else 'panels'} {str(dt)[6:]} d {d}", d, dt)
              for d in (WIDE_D, WIDE_MAX_D, PANEL_D, PANEL_FULL_D)
              for dt in (torch.float32, torch.bfloat16)]


def check_wide_smem(dtype, d) -> None:
    """The wide (or panel) kernels' shared memory at head dim d, forward and
    backward (at the library's largest query chunk), against the wrapper's
    reckoning of their layouts (``wide_smem``); both within the card's."""
    bf, lib = int(dtype == torch.bfloat16), _wide_lib()
    align = 16 if bf else 32
    got, want, line = [], [], []
    for bwd in (0, 1):
        pan = flash_panels(dtype, d, backward=bool(bwd))
        dp = -(-max(w for _, w in pan.columns) // align) * align
        panels = pan.count if pan.count * pan.passes > 1 else 1
        rows = lib.healnet_flash_wide_bwd_max_queries(d, bf, pan.count, pan.passes) if bwd else 0
        got.append(lib.healnet_flash_wide_smem(d, bf, pan.count, pan.passes, bwd, rows))
        want.append(wide_smem(dtype, dp, panels, rows if bwd else None)[2])
        line.append(f"{'backward' if bwd else 'forward'} {pan.count} panel(s) x {pan.passes} "
                    f"pass(es) {got[-1]} B" + (f" ({rows} queries a chunk)" if bwd else ""))
    log(f"  {str(dtype)[6:]} d {d}: shared memory {', '.join(line)}; reckoned {want}")
    if got != want or not 0 < max(got) <= 232448:
        raise AssertionError(f"d {d}: the kernels' shared memory {got} is not the plan's {want}")


def time_dropout(gen, direction: str, timings: dict) -> None:
    """The brca rows (tensor-core and FMA variant) timed with dropout 0.083,
    the seed read by every block from a device word, beside the unmasked
    rows without dropout timed just before."""
    b, lq, lkv = BATCH, 17, TOKENS
    for label in ("brca", "brca f32"):
        d, width, dtype = FLASH_SHAPES[label]
        eff = d**-0.5 / 0.5
        word = seed_word(1234, torch.device("cuda"))
        q, k, v = attention_inputs(gen, b, lq, lkv, d, dtype, width=width)
        if direction == "forward":
            run = lambda: flash_attention_kernel(q, k, v, None, eff, 0.083, word)
        else:
            q, k, v, do, lse, delta = flash_bwd_inputs(gen, b, lkv, dtype, None, 0.083, 1234, d,
                                                       width)
            run = lambda: flash_attention_bwd_kernel(q, k, v, None, do, lse, delta, eff, 0.083,
                                                     word)
        t_drop, _ = time_ms(run)
        log(f"  {label} {direction} with dropout 0.083, the seed read from device memory: "
            f"{t_drop:.4f} ms (without dropout {timings[label][0]:.4f} ms)")


def check_seed_replays(gen) -> None:
    """The frozen-seed trap: a flash forward and backward captured in a CUDA
    graph at the brca shape (tensor-core and FMA variant, dropout 0.083)
    and replayed with two seeds in its seed word must drop different
    entries, each replay equal to the eager call with that seed."""
    b, lq, lkv = BATCH, 17, TOKENS
    for label in ("brca", "brca f32"):
        d, width, dtype = FLASH_SHAPES[label]
        eff = d**-0.5 / 0.5
        q, k, v = attention_inputs(gen, b, lq, lkv, d, dtype, width=width)
        do = torch.randn((b, 1, lq, d), generator=gen, device="cuda").to(dtype)
        word = torch.zeros((1,), dtype=torch.int64, device="cuda")

        def call(seed):
            out, lse = flash_attention_kernel(q, k, v, None, eff, 0.083, seed)
            delta = (do.float() * out.float().reshape(b, 1, lq, d)).sum(-1)
            return (out, *flash_attention_bwd_kernel(q, k, v, None, do, lse, delta, eff, 0.083,
                                                     seed))

        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            call(word)
        torch.cuda.current_stream().wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream):
            static = call(word)
        replays = []
        for seed in (11, 12):
            word.fill_(seed)
            graph.replay()
            replays.append([x.clone() for x in static])
            if not all(torch.equal(a, e) for a, e in zip(replays[-1], call(seed))):
                raise AssertionError(f"{label}: a replay with seed {seed} differs from the eager "
                                     "call")
        moved = (replays[0][0] != replays[1][0]).float().mean().item()
        log(f"  {label}: two replays of one captured forward and backward with seeds 11 and 12: "
            f"each equal to its eager call; {moved:.4f} of the outputs differ between them")
        if moved == 0.0:
            raise AssertionError(f"{label}: two replays with two seeds dropped the same entries")
        del graph, static, replays


def phase_flash(gen):
    """Returns the kernels-line entries of the tensor-core (bf16), FMA (f32)
    and wide-head FMA (f32, d 320) variants."""
    log("phase 3: flash cross-attention kernel vs plain version")
    b, lq, lkv = BATCH, 17, TOKENS
    lengths = torch.randint(1, lkv, (b,), generator=gen, device="cuda")
    lengths[0] = 0  # a sample whose whole bag is masked
    mask = torch.arange(lkv, device="cuda")[None, :] < lengths[:, None]
    # (head dim, KV width, mask, dropout rate); kirp's rate is its row's
    cases = {"(8, 17, 4096, 63) unmasked": (63, 252, None, 0.0),
             "(8, 17, 4096, 63) masked": (63, 252, mask, 0.0),
             "(8, 17, 4096, 63) dropout 0.083": (63, 252, mask, 0.083),
             "kirp (8, 17, 4096, 27) masked, dropout 0.318": (
                 27, 270, mask, ROWS["kirp"]["attn_dropout"])}
    seed = 0x9E3779B9
    worst = 0.0
    for label, (d, width, m, rate) in cases.items():
        q, k, v = attention_inputs(gen, b, lq, lkv, d, torch.bfloat16, width=width)
        out, _ = flash_attention_kernel(q, k, v, m, d**-0.5 / 0.5, rate, seed)
        # plain version on the same (bf16) values, held in f32
        ref, _ = multihead_attention(q.float(), k.float(), v.float(), scale=d**-0.5,
                                     temperature=0.5, kv_mask=m, dropout_rate=rate,
                                     dropout_seed=seed)
        torch.cuda.synchronize()
        err = (out.float() - ref).abs().max().item()
        # bf16: the kernel rounds the probabilities to bf16 before the value
        # product (as the TPU kernel does) and rounds the output
        check(f"bf16 {label}", err, 2e-2)
        if m is not None:
            assert out[0].abs().max().item() == 0.0, "fully masked row must output 0"
        if d == 63:
            worst = max(worst, err)
    qf, kf, vf = attention_inputs(gen, 2, 17, 300, 63, torch.float32)
    mf = torch.rand((2, 300), generator=gen, device="cuda") > 0.3
    out, _ = flash_attention_kernel(qf, kf, vf, mf, 63**-0.5 / 0.5, 0.3, seed)
    ref, _ = multihead_attention(qf, kf, vf, scale=63**-0.5, kv_mask=mf, dropout_rate=0.3,
                                 dropout_seed=seed)
    # f32 (the FMA variant): online softmax against materialised weights, as
    # the JAX package's own flash tests hold them
    err_f32 = (out - ref).abs().max().item()
    check("f32 (2, 17, 300, 63) masked, dropout 0.3", err_f32, 2e-5)
    # the FMA variant at full size: f32 at brca's and kirp's shapes, and bf16
    # with a head wider than the tensor-core kernel takes (4 ulps of the
    # largest output); two calls give the same bits
    for label, (d, width, dtype, m, rate) in fma_cases(mask).items():
        q, k, v = attention_inputs(gen, b, lq, lkv, d, dtype, width=width)
        out, lse = flash_attention_kernel(q, k, v, m, d**-0.5 / 0.5, rate, seed)
        out2, lse2 = flash_attention_kernel(q, k, v, m, d**-0.5 / 0.5, rate, seed)
        ref, _ = multihead_attention(q.float(), k.float(), v.float(), scale=d**-0.5,
                                     temperature=0.5, kv_mask=m, dropout_rate=rate,
                                     dropout_seed=seed)
        torch.cuda.synchronize()
        err = (out.float() - ref).abs().max().item()
        tol = 2e-5 if dtype == torch.float32 else 4 * bf16_ulp(ref.abs().max().item())
        check(f"FMA {label}", err, tol)
        if not (torch.equal(out, out2) and torch.equal(lse, lse2)):
            raise AssertionError(f"FMA {label}: two calls differ")
        assert out[0].abs().max().item() == 0.0, "fully masked row must output 0"
        if d == 63:
            err_f32 = max(err_f32, err)
    err_wide = {}
    for label, (d, dtype, nq, width, n, masked) in wide_cases().items():
        q, k, v = attention_inputs(gen, b, nq, n, d, dtype, width=width)
        m = mask[:, :n] if masked else None
        reset_launches()
        out, lse = flash_attention_kernel(q, k, v, m, d**-0.5 / 0.5, 0.083, seed)
        out2, lse2 = flash_attention_kernel(q, k, v, m, d**-0.5 / 0.5, 0.083, seed)
        counter = launch_counter(dtype, d)
        counts = {c: getattr(flash_attention_kernel, c) for c in LAUNCH_COUNTERS}
        if counts != {c: 2 if c == counter else 0 for c in counts}:
            raise AssertionError(f"wide {label}: not one {counter} launch a call: {counts}")
        ref, _ = multihead_attention(q.float(), k.float(), v.float(), scale=d**-0.5,
                                     temperature=0.5, kv_mask=m, dropout_rate=0.083,
                                     dropout_seed=seed)
        torch.cuda.synchronize()
        err = (out.float() - ref).abs().max().item()
        tol = 2e-5 if dtype == torch.float32 else 4 * bf16_ulp(ref.abs().max().item())
        check(f"wide {label} ({counter})", err, tol)
        if not (torch.equal(out, out2) and torch.equal(lse, lse2)):
            raise AssertionError(f"wide {label}: two calls differ")
        if masked:
            assert out[0].abs().max().item() == 0.0, "fully masked row must output 0"
        key = (counter, dtype)
        err_wide[key] = max(err_wide.get(key, 0.0), err)
        del q, k, v, out, out2, ref

    for _, d, dtype in WIDE_TIMED:
        check_wide_smem(dtype, d)
    timings = {}
    for label, (d, width, dtype) in FLASH_SHAPES.items():
        q, k, v = attention_inputs(gen, b, lq, lkv, d, dtype, width=width)
        run = lambda: flash_attention_kernel(q, k, v, None, d**-0.5 / 0.5)
        out, lse = run()
        timings[label] = time_flash(
            f"{label} ({b}, {lq}, {lkv}, {d}) {str(dtype)[6:]} unmasked", run,
            lambda: multihead_attention(q, k, v, scale=d**-0.5),
            lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v,
                                                                     scale=d**-0.5 / 0.5),
            nbytes(q, k, v, out, lse), 4.0 * b * lq * lkv * d, dtype, "SDPA")
    log(f"  kirp f32: kernel {timings['kirp f32'][0]:.4f} ms, SDPA {timings['kirp f32'][2]:.4f}"
        f" ms, bound {timings['kirp f32'][3]:.5f} ms")
    time_dropout(gen, "forward", timings)
    check_seed_replays(gen)
    for label, d, dtype in WIDE_TIMED:
        q, k, v = attention_inputs(gen, b, lq, lkv, d, dtype)
        run = lambda: flash_attention_kernel(q, k, v, None, d**-0.5 / 0.5)
        out, lse = run()
        timings[label] = time_flash(
            f"{label} ({b}, {lq}, {lkv}, {d}) unmasked", run,
            lambda: multihead_attention(q, k, v, scale=d**-0.5),
            lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v,
                                                                     scale=d**-0.5 / 0.5),
            nbytes(q, k, v, out, lse), 4.0 * b * lq * lkv * d, dtype, "SDPA")
    source = "healnet_tpu_torch/ops/csrc/flash_attention.cu"
    wide = "healnet_tpu_torch/ops/csrc/flash_wide.cu"
    f32, bf16 = torch.float32, torch.bfloat16
    return (flash_entry("flash_attention", source, "healnet_tpu/ops/flash_attention.py:98",
                        worst, timings["brca"]),
            flash_entry("flash_attention_fma", source, "healnet_tpu/ops/flash_attention.py:98",
                        err_f32, timings["brca f32"]),
            flash_entry("flash_attention_wide_fma", wide, "healnet_tpu/ops/flash_attention.py:98",
                        err_wide[("launches_wide_fma", f32)],
                        timings[f"wide float32 d {WIDE_D}"]),
            flash_entry("flash_attention_wide_tc", wide, "healnet_tpu/ops/flash_attention.py:98",
                        err_wide[("launches_wide_tc", bf16)],
                        timings[f"wide bfloat16 d {WIDE_D}"]),
            flash_entry("flash_attention_panel_fma", wide, "healnet_tpu/ops/flash_attention.py:98",
                        err_wide[("launches_panel_fma", f32)],
                        timings[f"panels float32 d {PANEL_D}"]),
            flash_entry("flash_attention_panel_tc", wide, "healnet_tpu/ops/flash_attention.py:98",
                        err_wide[("launches_panel_tc", bf16)],
                        timings[f"panels bfloat16 d {PANEL_D}"]))


# ---------------------------------------------------------------- phase 4


def row_model(row, dtype, attention_impl="flash", projection_impl="auto"):
    """The row's model at full width, random weights from seed 0."""
    return HealNetModule(
        **{**BRCA, **ROWS[row]}, dtype=dtype, attention_impl=attention_impl,
        projection_impl=projection_impl, device="cuda",
        generator=torch.Generator().manual_seed(0),
    )


def predictor(dtype, attention_impl, projection_impl, state_dict=None, row="brca"):
    return Predictor(row_model(row, dtype, attention_impl, projection_impl), state_dict,
                     batch_size=BATCH, bucket_boundaries=BUCKETS, device="cuda")


def compare(name, got, ref, tol_logits, against="plain path"):
    for key in ("logits", "hazards", "survival", "risk"):
        if not np.isfinite(got[key]).all():
            raise AssertionError(f"{name}: non-finite {key}")
    err = float(np.abs(got["logits"] - ref["logits"]).max())
    check(f"{name} logits vs {against}", err, tol_logits)


def phase_serving(host_rng) -> dict:
    log("phase 4: serving the full-width BRCA model through Predictor")
    pred = predictor(torch.bfloat16, "flash", "auto")
    ref = predictor(torch.bfloat16, "xla", "xla", pred.module.state_dict())
    warm = pred.warmup([(1, OMIC), (TOKENS, PATCH)])
    ref.warmup([(1, OMIC), (TOKENS, PATCH)])
    log(f"  warmup: {warm['programs']} shapes in {warm['seconds']:.3f} s")

    n = 20
    omic = host_rng.standard_normal((n, 1, OMIC), dtype=np.float32)
    wsi = host_rng.standard_normal((n, TOKENS, PATCH), dtype=np.float32)
    lengths = [700, 1024, 1500, 2048, 3000, 4096, 6000, 8192, 900, 2500]
    bags = [host_rng.standard_normal((ln, PATCH), dtype=np.float32) for ln in lengths]
    requests = {
        "dense 20 x 4096": lambda p: p([omic, wsi]),
        "omic missing": lambda p: p([None, wsi[:8]]),
        "ragged buckets": lambda p: p.predict_ragged([omic[:len(bags)], bags]),
    }

    reset_launches()
    outs, seconds = {}, {}
    for name, call in requests.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs[name] = call(pred)
        seconds[name] = time.perf_counter() - t0
    launches = read_launches("the serving run", ("fused_project", "flash_attention"))

    # bf16 on both sides: the plain path runs its softmax in bf16 and the
    # kernels in f32, so logits of magnitude ~1 differ at the 1e-2 level
    for name, call in requests.items():
        got = outs[name]
        rows = {"dense 20 x 4096": n, "omic missing": 8, "ragged buckets": len(bags)}[name]
        assert got["logits"].shape == (rows, 4) and got["risk"].shape == (rows,), name
        compare(name, got, call(ref), 0.1)
    per_bucket = [sum(pred._bucket_width(ln) == w for ln in lengths) for w in BUCKETS]
    micro = {"dense 20 x 4096": -(-n // BATCH), "omic missing": 1,
             "ragged buckets": sum(-(-c // BATCH) for c in per_bucket)}
    for name, s in seconds.items():
        log(f"  {name}: {s * 1e3:.2f} ms wall, {s * 1e3 / micro[name]:.2f} ms per "
            "micro-batch (host arrays in, host arrays out)")

    # device-resident micro-batch: the model alone, inputs already on the card
    x = [torch.as_tensor(omic[:8], device="cuda"), torch.as_tensor(wsi[:8], device="cuda")]
    with torch.inference_mode():
        (t_model, w_model), (t_plain, w_plain) = (
            time_ms(lambda: pred.module(x)), time_ms(lambda: ref.module(x)))
    log(f"  one micro-batch of 8, inputs on the card: device time kernel path "
        f"{t_model:.4f} ms, plain path {t_plain:.4f} ms; wall per call kernel path "
        f"{w_model:.4f} ms, plain path {w_plain:.4f} ms")

    # float32: the same weights, kernel path against plain path, tight
    pred32 = predictor(None, "flash", "auto", pred.module.state_dict())
    ref32 = predictor(None, "xla", "xla", pred.module.state_dict())
    mask = np.arange(TOKENS)[None, :] < np.array([4096, 3000, 1, 2048, 4096, 100, 4096, 17])[:, None]
    got32 = pred32([omic[:8], wsi[:8]], kv_masks=[None, mask])
    compare("f32 masked micro-batch", got32, ref32([omic[:8], wsi[:8]], kv_masks=[None, mask]),
            1e-3)
    return launches


def phase_serving_rows(host_rng) -> None:
    """The kirp and trimodal rows through Predictor: one dense micro-batch
    of 8 at full width, kernel path against plain path (same weights), in
    bf16 and f32, with phase 4's tolerances."""
    log("phase 4 (continued): serving the kirp and trimodal rows through Predictor")
    for row in ("kirp", "trimodal"):
        shapes = [(BATCH, 1, OMIC), (BATCH, TOKENS, PATCH)]
        shapes += [(BATCH, *EXTRA)] if row == "trimodal" else []
        x = [host_rng.standard_normal(sh, dtype=np.float32) for sh in shapes]
        pred = predictor(torch.bfloat16, "flash", "auto", row=row)
        ref = predictor(torch.bfloat16, "xla", "xla", pred.module.state_dict(), row=row)
        state = pred.module.state_dict()
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = pred(x)
        wall = time.perf_counter() - t0
        read_launches(f"the {row} serving run", ("fused_project", "flash_attention"))
        assert got["logits"].shape == (BATCH, 4) and got["risk"].shape == (BATCH,), row
        compare(f"{row} bf16 dense micro-batch of 8", got, ref(x), 0.1)
        xd = [torch.as_tensor(a, device="cuda") for a in x]
        with torch.inference_mode():
            (t_model, w_model), (t_plain, w_plain) = (
                time_ms(lambda: pred.module(xd)), time_ms(lambda: ref.module(xd)))
        log(f"  {row}: {wall * 1e3:.2f} ms wall for the micro-batch from host arrays (first "
            f"call); inputs on the card: device time kernel path {t_model:.4f} ms, plain path "
            f"{t_plain:.4f} ms; wall per call kernel path {w_model:.4f} ms, plain path "
            f"{w_plain:.4f} ms")
        del ref, xd
        compare(f"{row} f32 dense micro-batch of 8", predictor(None, "flash", "auto", state,
                                                               row=row)(x),
                predictor(None, "xla", "xla", state, row=row)(x), 1e-3)


# ---------------------------------------------------------------- phase 5


def flash_bwd_inputs(gen, b, lkv, dtype, mask, rate, seed, d=63, width=None, lq=17):
    """The backward's inputs at the model's layout: q, k, v, dO and the
    forward kernel's lse, and delta = rowsum(dO * O)."""
    q, k, v = attention_inputs(gen, b, lq, lkv, d, dtype, width=width)
    out, lse = flash_attention_kernel(q, k, v, mask, d**-0.5 / 0.5, rate, seed)
    do = torch.randn((b, lq, d), generator=gen, device="cuda").to(dtype)
    delta = (do.float() * out.float()).sum(-1)[:, None]
    return q, k, v, do[:, None], lse, delta


def phase_flash_bwd(gen):
    """Returns the kernels-line entries of the tensor-core (bf16) and FMA
    (f32) variants."""
    log("phase 5: flash cross-attention backward kernel vs plain version")
    b, lq, lkv = BATCH, 17, TOKENS
    seed = 0x2545F491
    lengths = torch.randint(1, lkv, (b,), generator=gen, device="cuda")
    lengths[0] = 0  # a sample whose whole bag is masked
    mask = torch.arange(lkv, device="cuda")[None, :] < lengths[:, None]
    bf16, f32 = torch.bfloat16, torch.float32
    # (batch, keys, dtype, mask, dropout rate, head dim, KV width)
    cases = {"unmasked": (b, lkv, bf16, None, 0.0, 63, 252),
             "masked": (b, lkv, bf16, mask, 0.0, 63, 252),
             "dropout 0.083": (b, lkv, bf16, mask, 0.083, 63, 252),
             "omic lkv=1, dropout 0.083": (b, 1, bf16, None, 0.083, 63, 252),
             "kirp (8, 17, 4096, 27) masked, dropout 0.318": (
                 b, lkv, bf16, mask, ROWS["kirp"]["attn_dropout"], 27, 270),
             "f32 (2, 17, 300, 63) masked, dropout 0.3": (
                 2, 300, f32, torch.rand((2, 300), generator=gen, device="cuda") > 0.3, 0.3,
                 63, 252)}
    worst = {bf16: 0.0, f32: 0.0}
    for label, (nb, n, dtype, m, rate, d, width) in cases.items():
        args = flash_bwd_inputs(gen, nb, n, dtype, m, rate, seed, d, width)
        q, k, v, do, lse, delta = args
        eff = d**-0.5 / 0.5
        got = flash_attention_bwd_kernel(q, k, v, m, do, lse, delta, eff, rate, seed)
        ref = flash_backward_plain(q, k, v, m, do, lse, delta, eff, rate, seed)
        torch.cuda.synchronize()
        for name, a, r in zip(("dq", "dk", "dv"), got, ref):
            err = (a.float() - r.float()).abs().max().item()
            top = r.float().abs().max().item()
            # f32: sums in another order; bf16: kernel and plain version round
            # p and ds to bf16 at the same places and sum in another order,
            # so a term may round one ulp apart: 4 ulps of the largest value
            tol = 1e-5 * max(1.0, top) if dtype == f32 else 4 * bf16_ulp(top)
            check(f"{label} {name}", err, tol)
            if (dtype == f32 or n == lkv) and d == 63:
                worst[dtype] = max(worst[dtype], err)
        if m is not None and m.shape[0] == b:
            assert all(g[0].abs().max().item() == 0.0 for g in got), \
                "a fully masked row must get zero gradients"
    # the FMA variant at full size (phase 3's cases); two calls give the same bits
    for label, (d, width, dtype, m, rate) in fma_cases(mask).items():
        q, k, v, do, lse, delta = flash_bwd_inputs(gen, b, lkv, dtype, m, rate, seed, d, width)
        eff = d**-0.5 / 0.5
        got = flash_attention_bwd_kernel(q, k, v, m, do, lse, delta, eff, rate, seed)
        again = flash_attention_bwd_kernel(q, k, v, m, do, lse, delta, eff, rate, seed)
        ref = flash_backward_plain(q, k, v, m, do, lse, delta, eff, rate, seed)
        torch.cuda.synchronize()
        for name, a, r in zip(("dq", "dk", "dv"), got, ref):
            err = (a.float() - r.float()).abs().max().item()
            top = r.float().abs().max().item()
            tol = 1e-5 * max(1.0, top) if dtype == f32 else 4 * bf16_ulp(top)
            check(f"FMA {label} {name}", err, tol)
            if dtype == f32 and d == 63:
                worst[f32] = max(worst[f32], err)
        if not all(torch.equal(x, y) for x, y in zip(got, again)):
            raise AssertionError(f"FMA {label}: two calls differ")
        assert all(g[0].abs().max().item() == 0.0 for g in got), \
            "a fully masked row must get zero gradients"
    err_wide = {}
    for label, (d, dtype, nq, width, n, masked) in wide_cases().items():
        m = mask[:, :n] if masked else None
        q, k, v, do, lse, delta = flash_bwd_inputs(gen, b, n, dtype, m, 0.083, seed, d,
                                                   width, nq)
        eff = d**-0.5 / 0.5
        reset_launches()
        got = flash_attention_bwd_kernel(q, k, v, m, do, lse, delta, eff, 0.083, seed)
        again = flash_attention_bwd_kernel(q, k, v, m, do, lse, delta, eff, 0.083, seed)
        counter = launch_counter(dtype, d)
        counts = {c: getattr(flash_attention_bwd_kernel, c) for c in LAUNCH_COUNTERS}
        if counts != {c: 2 if c == counter else 0 for c in counts}:
            raise AssertionError(f"wide {label}: not one {counter} launch a call: {counts}")
        ref = flash_backward_plain(q, k, v, m, do, lse, delta, eff, 0.083, seed)
        torch.cuda.synchronize()
        # at one key p = 1, so dq and dk are the f32 rounding residue of
        # dp * e - delta, terms of dv's size: f32 holds them to 1e-5 of the
        # call's largest gradient (dv's)
        largest = max(r.float().abs().max().item() for r in ref)
        for name, a, r in zip(("dq", "dk", "dv"), got, ref):
            err = (a.float() - r.float()).abs().max().item()
            top = r.float().abs().max().item()
            tol = 1e-5 * max(1.0, largest if n == 1 else top) if dtype == f32 \
                else 4 * bf16_ulp(top)
            check(f"wide {label} ({counter}) {name}", err, tol)
            err_wide[(counter, dtype)] = max(err_wide.get((counter, dtype), 0.0), err)
        if dtype == f32 and n == 1:  # how far f32 itself lies from f64 there
            q64, k64, v64, do64, delta64 = (x.double() for x in (q, k, v, do, delta))
            ref64 = flash_backward_plain(q64, k64, v64, m, do64,
                                         flash_lse_plain(q64, k64, m, eff), delta64, eff, 0.083,
                                         seed)
            log("    against f64: " + ", ".join(
                f"{name} kernel {(a.double() - r).abs().max().item():.3g}, plain f32 "
                f"{(p.double() - r).abs().max().item():.3g}"
                for name, a, p, r in zip(("dq", "dk", "dv"), got, ref, ref64)))
        if not all(torch.equal(x, y) for x, y in zip(got, again)):
            raise AssertionError(f"wide {label}: two calls differ")
        if masked:
            assert all(g[0].abs().max().item() == 0.0 for g in got), \
                "a fully masked row must get zero gradients"
        del q, k, v, do, got, again, ref

    timings = {}
    for label, (d, width, dtype) in FLASH_SHAPES.items():
        q, k, v, do, lse, delta = flash_bwd_inputs(gen, b, lkv, dtype, None, 0.0, seed, d,
                                                   width)
        eff = d**-0.5 / 0.5
        run = lambda: flash_attention_bwd_kernel(q, k, v, None, do, lse, delta, eff)
        dq, dk, dv = run()
        ql, kl, vl = (x.detach().clone().requires_grad_() for x in (q, k, v))
        out = torch.nn.functional.scaled_dot_product_attention(ql, kl, vl, scale=eff)
        # five (lq x lkv x d) products: scores, dO V^T, dV, dK, dQ
        timings[label] = time_flash(
            f"{label} ({b}, {lq}, {lkv}, {d}) {str(dtype)[6:]} unmasked", run,
            lambda: flash_backward_plain(q, k, v, None, do, lse, delta, eff),
            lambda: torch.autograd.grad(out, (ql, kl, vl), do, retain_graph=True),
            nbytes(q, k, v, do, lse, delta, dq, dk, dv), 10.0 * b * lq * lkv * d, dtype,
            "SDPA backward")
    log(f"  kirp f32: kernel {timings['kirp f32'][0]:.4f} ms, SDPA backward "
        f"{timings['kirp f32'][2]:.4f} ms, bound {timings['kirp f32'][3]:.5f} ms")
    time_dropout(gen, "backward", timings)
    for label, d, dtype in WIDE_TIMED:
        q, k, v, do, lse, delta = flash_bwd_inputs(gen, b, lkv, dtype, None, 0.0, seed, d)
        eff = d**-0.5 / 0.5
        run = lambda: flash_attention_bwd_kernel(q, k, v, None, do, lse, delta, eff)
        dq, dk, dv = run()
        ql, kl, vl = (x.detach().clone().requires_grad_() for x in (q, k, v))
        out = torch.nn.functional.scaled_dot_product_attention(ql, kl, vl, scale=eff)
        timings[label] = time_flash(
            f"{label} ({b}, {lq}, {lkv}, {d}) unmasked", run,
            lambda: flash_backward_plain(q, k, v, None, do, lse, delta, eff),
            lambda: torch.autograd.grad(out, (ql, kl, vl), do, retain_graph=True),
            nbytes(q, k, v, do, lse, delta, dq, dk, dv), 10.0 * b * lq * lkv * d, dtype,
            "SDPA backward")
        del q, k, v, do, dq, dk, dv, ql, kl, vl, out
    phase_flash_latents(gen)
    check_row_offsets(gen)
    source = "healnet_tpu_torch/ops/csrc/flash_attention_bwd.cu"
    wide = "healnet_tpu_torch/ops/csrc/flash_wide.cu"
    return (flash_entry("flash_attention_bwd", source, "healnet_tpu/ops/flash_attention.py:201",
                        worst[bf16], timings["brca"]),
            flash_entry("flash_attention_bwd_fma", source,
                        "healnet_tpu/ops/flash_attention.py:201", worst[f32],
                        timings["brca f32"]),
            flash_entry("flash_attention_bwd_wide_fma", wide,
                        "healnet_tpu/ops/flash_attention.py:201",
                        err_wide[("launches_wide_fma", f32)], timings[f"wide float32 d {WIDE_D}"]),
            flash_entry("flash_attention_bwd_wide_tc", wide,
                        "healnet_tpu/ops/flash_attention.py:201",
                        err_wide[("launches_wide_tc", bf16)],
                        timings[f"wide bfloat16 d {WIDE_D}"]),
            flash_entry("flash_attention_bwd_panel_fma", wide,
                        "healnet_tpu/ops/flash_attention.py:201",
                        err_wide[("launches_panel_fma", f32)],
                        timings[f"panels float32 d {PANEL_D}"]),
            flash_entry("flash_attention_bwd_panel_tc", wide,
                        "healnet_tpu/ops/flash_attention.py:201",
                        err_wide[("launches_panel_tc", bf16)],
                        timings[f"panels bfloat16 d {PANEL_D}"]))


# the routes of the row-offset check: (route, head dim, dtype)
OFFSET_ROUTES = (("tc", 63, torch.bfloat16), ("fma", 63, torch.float32),
                 ("wide", 320, torch.bfloat16), ("wide", 320, torch.float32),
                 ("panels", 576, torch.bfloat16), ("panels", 576, torch.float32))


def check_row_offsets(gen) -> None:
    """A shard's hash rows on every flash route: batch rows 4-7 and head 1
    of a (8, 2, 17, 32) call, launched with ``row_offset = 4 * 2 + 1`` and
    ``head_stride 2``, must keep the single call's entries of those rows.
    With one-hot values (v[j, j] = 1) the forward's output is the dropped
    probability map, zero exactly where an entry is dropped: its keeps
    equal the single call's rows and ``dense_keep_mask``'s, bit for bit.
    The shard's backward is held against ``flash_backward_plain`` with the
    same offsets (f64 for f32, f32 for bf16; 1e-5 and 4 bf16 ulps of the
    largest gradient), which a wrong mask misses by whole probabilities."""
    b, h, lq, lkv, rate, seed = 8, 2, 17, 32, 0.083, 4321
    rows, head = slice(4, 8), slice(1, 2)
    for route, d, dtype in OFFSET_ROUTES:
        eff = d**-0.5 / 0.5
        q = torch.randn((b, h, lq, d), generator=gen, device="cuda").to(dtype)
        k = torch.randn((b, h, lkv, d), generator=gen, device="cuda").to(dtype)
        v = torch.zeros((b, h, lkv, d), device="cuda", dtype=dtype)
        v[:, :, torch.arange(lkv), torch.arange(lkv)] = 1
        whole, _ = flash_attention_kernel(q, k, v, None, eff, rate, seed)
        part = [x[rows, head].contiguous() for x in (q, k, v)]
        got, lse = flash_attention_kernel(*part, None, eff, rate, seed, 4 * h + 1, h)
        keep_whole = whole.reshape(b, lq, h, d)[rows, :, head, :lkv] != 0
        keep_part = got.reshape(4, lq, 1, d)[..., :lkv] != 0
        dense = dense_keep_mask(seed, b * h, lq, lkv, rate, device="cuda").reshape(
            b, h, lq, lkv)[rows, head].transpose(1, 2)
        if not (torch.equal(keep_part, keep_whole) and torch.equal(keep_part, dense)):
            raise AssertionError(f"{route} {dtype}: the keeps at row offset {4 * h + 1} differ "
                                 "from the single call's rows")
        do = torch.randn((4, 1, lq, d), generator=gen, device="cuda").to(dtype)
        delta = (do.float() * got.float().reshape(4, 1, lq, d)).sum(-1)
        grads = flash_attention_bwd_kernel(*part, None, do, lse, delta, eff, rate, seed,
                                           4 * h + 1, h)
        # as held_flash_calls holds them: f32 inputs in f64 with the
        # log-sum-exp taken there, bf16 ones as they are (sums in f32)
        wide = torch.float64 if dtype == torch.float32 else dtype
        wq, wk, wv = (x.to(wide) for x in part)
        ref_lse = flash_lse_plain(wq, wk, None, eff) if wide == torch.float64 else lse
        ref = flash_backward_plain(wq, wk, wv, None, do.to(wide), ref_lse,
                                   delta.to(torch.promote_types(wide, torch.float32)), eff, rate,
                                   seed, 4 * h + 1, h)
        top = max(r.abs().max().item() for r in ref)
        tol = 1e-5 * top if dtype == torch.float32 else 4 * bf16_ulp(top)
        err = max((g.double() - r.double()).abs().max().item() for g, r in zip(grads, ref))
        check(f"{route} d {d} {str(dtype)[6:]}: the shard's backward at row offset "
              f"{4 * h + 1} against its plain version", err, tol)
    log(f"  row offsets: {len(OFFSET_ROUTES)} routes, each shard's keeps equal the single "
        "call's rows and dense_keep_mask's, bit for bit")


def phase_flash_latents(gen) -> None:
    """Forward and backward (both variants) at latent counts past a block's
    shared memory, where the kernels walk the queries in chunks: K and V
    slices of a merged KV buffer of width 4 d, a ragged mask with a fully
    masked row, dropout 0.2; the forward to 2e-2 (bf16) / 2e-5 (f32) of the
    plain version, the backward at phase 5's tolerances."""
    b, lkv, rate, seed = 2, 1000, 0.2, 0x2545F491
    mask = torch.arange(lkv, device="cuda")[None, :] < torch.tensor([[0], [777]], device="cuda")
    worst = {}
    for dtype in (torch.bfloat16, torch.float32):
        for lq in (33, 64, 128, 130, 256):
            for d in (27, 63, 96, 113, 128):
                q = torch.randn((b, lq, d), generator=gen, device="cuda").to(dtype)[:, None]
                kv = torch.randn((b, lkv, 4 * d), generator=gen, device="cuda").to(dtype)
                k, v = kv[..., d:2 * d][:, None], kv[..., 2 * d:3 * d][:, None]
                eff = d**-0.5 / 0.5
                out, lse = flash_attention_kernel(q, k, v, mask, eff, rate, seed)
                ref, _ = multihead_attention(q.float(), k.float(), v.float(), scale=d**-0.5,
                                             temperature=0.5, kv_mask=mask, dropout_rate=rate,
                                             dropout_seed=seed)
                errs = [(out.float() - ref).abs().max().item()]
                ftol = 2e-2 if dtype == torch.bfloat16 else 2e-5
                do = torch.randn((b, lq, d), generator=gen, device="cuda").to(dtype)
                delta = (do.float() * out.float()).sum(-1)[:, None]
                got = flash_attention_bwd_kernel(q, k, v, mask, do[:, None], lse, delta, eff,
                                                 rate, seed)
                want = flash_backward_plain(q, k, v, mask, do[:, None], lse, delta, eff, rate,
                                            seed)
                torch.cuda.synchronize()
                ok = errs[0] <= ftol and out[0].abs().max().item() == 0.0
                for a, r in zip(got, want):
                    top = r.float().abs().max().item()
                    tol = 4 * bf16_ulp(top) if dtype == torch.bfloat16 else 1e-5 * max(1.0, top)
                    errs.append((a.float() - r.float()).abs().max().item())
                    ok = ok and errs[-1] <= tol and a[0].abs().max().item() == 0.0
                if not ok:
                    raise AssertionError(f"latent count {lq}, d {d}, {dtype}: max|d| forward, "
                                         f"dq, dk, dv = {errs}")
                worst[dtype] = max(worst.get(dtype, 0.0), *errs[1:])
    log(f"  forward and backward at lq 33, 64, 128, 130, 256 x d 27, 63, 96, 113, 128 (lkv {lkv}, "
        f"masked, dropout {rate}): all within tolerance; worst backward max|d| bf16 "
        f"{worst[torch.bfloat16]:.6g}, f32 {worst[torch.float32]:.6g}")


# ---------------------------------------------------------------- phase 6


def first_block(g):
    """(rows, columns): the (b, t) rows and the leading columns whose sums
    the backward kernel's first block adds into its partial
    (``project_bwd_plan``: token tiles 0, grid_x, 2 grid_x, ..., every batch
    element, the first column chunk)."""
    b, t, f = g.shape
    plan = project_bwd_plan(b, t, f, g.element_size(), g.data_ptr(),
                            torch.cuda.get_device_properties(g.device).multi_processor_count)
    tile = torch.arange(t, device=g.device) // plan.tokens
    return (tile % plan.grid_x == 0)[None, :].expand(b, t), plan.w * plan.vec


def check_dsum2(label, got, g, s1, s2, d_total, show_refusals=False) -> None:
    """dsum2 = [sum g; sum inv mu g], each row and column held against an
    f64 sum of the same terms (inv and mu as the plain version takes them).
    The kernel adds n = b t terms in f32: each addition is off by at most
    2^-24 of a partial sum no larger than sum|term|, and n such errors of
    either sign add up to about sqrt(n) of them (twice that here); rsqrtf
    (2 ulps) moves each term of the second row by up to 4 x 2^-24.
    Tolerance of a column: (4 + 2 sqrt(n)) 2^-24 sum|term|. With
    ``show_refusals``, fail unless the check refuses dsum2 with its second
    row zeroed and with the first block's partial left out
    (``first_block``)."""
    n = s1.numel()
    mu, inv = _mu_inv(s1, s2, d_total, 1e-5)
    gd = g.double()
    terms = torch.stack([gd, (inv * mu).double()[..., None] * gd])  # (2, b, t, F)
    ref = terms.sum(dim=(1, 2))
    tol = (4 + 2 * np.sqrt(n)) * 2.0**-24 * terms.abs().sum(dim=(1, 2))

    def share(x):  # the largest |x - ref| / tol of each row
        return ((x.double() - ref).abs() / tol).amax(dim=1).tolist()

    for row, r in enumerate(share(got)):
        err = (got[row].double() - ref[row]).abs()
        log(f"  {label} dsum2[{row}]: max|d| = {err.max().item():.6g}, at most {r:.3g} of its "
            f"column's tolerance ({tol[row].min().item():.3g}..{tol[row].max().item():.3g})")
        if not bool((err <= tol[row]).all()):
            raise AssertionError(f"{label} dsum2[{row}]: beyond its rounding bound ({r:.3g}x)")
    if not show_refusals:
        return
    zeroed = got.clone()
    zeroed[1] = 0.0
    rows, cols = first_block(g)
    partial = terms[:, rows].sum(dim=1)
    partial[:, cols:] = 0.0
    dropped = got.double() - partial
    for what, x in (("its second row zeroed", zeroed),
                    ("the first block's partial left out", dropped)):
        r = max(share(x))
        log(f"  {label} dsum2 with {what}: {r:.3g}x the tolerance, refused")
        if not r > 1.0:
            raise AssertionError(f"{label}: the dsum2 check passes a result with {what}")


def check_bwd(label, got, ref, g, s1, s2, d_total, plain_terms=None,
              show_refusals=False) -> float:
    """Phases 6 and 9's tolerances; returns d_raw's error. d_raw rounds
    ``(scale *) inv * g`` once in both, and rsqrtf may differ from torch's
    rsqrt in its last bit, which can move a bf16 rounding by one ulp: 1 bf16
    ulp of the largest value, 1e-6 relative in f32. dsum2: ``check_dsum2``.
    bsum: b terms rounded at the same place, each at most one ulp apart: b
    bf16 ulps of the largest term (``plain_terms``: the unscaled d_raw)."""
    bf16 = g.dtype == torch.bfloat16
    top = ref[0].float().abs().max().item()
    err = (got[0].float() - ref[0].float()).abs().max().item()
    check(f"{label} d_raw", err, bf16_ulp(top) if bf16 else 1e-6 * top)
    check_dsum2(label, got[1], g, s1, s2, d_total, show_refusals)
    if plain_terms is not None:
        term = plain_terms.float().abs().max().item()
        check(f"{label} bsum", (got[2] - ref[2]).abs().max().item(),
              g.shape[0] * bf16_ulp(term) if bf16 else 1e-5 * max(1.0, term))
    return err


def time_bwd(label, run, plain, moved, elements, ops_per_element, dtype):
    """Profile one backward call (one launch), check two calls are
    bit-identical, and time kernel and plain version; returns the
    kernels-line times."""
    kinds, prof = launch_profile(run)
    log(f"  {label}: kernels on the profiler: {prof}")
    if kinds != 1:
        raise AssertionError(f"{label}: a backward call launched {kinds} kernels, not 1")
    one, two = run(), run()
    if not all(torch.equal(x, y) for x, y in zip(one, two)):
        raise AssertionError(f"{label}: two calls differ")
    (t_kernel, w_kernel), (t_plain, w_plain) = time_ms(run), time_ms(plain)
    bound, by = bound_ms(moved, ops_per_element * elements, dtype)
    log(f"  {label}: device time kernel {t_kernel:.4f} ms, plain {t_plain:.4f} ms, bound "
        f"{bound:.5f} ms ({by}; {moved / 1e6:.1f} MB); two calls bit-identical; wall per "
        f"call: kernel {w_kernel:.4f} ms, plain {w_plain:.4f} ms; library: none (no single "
        "PyTorch call computes d_raw and both column sums)")
    return dict(ms=t_kernel, plain_ms=t_plain, bound_ms=bound, bound_by=by)


def phase_projection_bwd(gen) -> dict:
    log("phase 6: projection backward (cotangent pass) kernel vs plain version")
    # (b, t, C, F, dtype, timed): brca bf16 and f32, kirp's F 270, a small
    # f32 shape, the one-token omic context, and batch 5000 of one token
    cases = {"bf16 (8, 4096, 252)": (BATCH, TOKENS, PATCH, 252, torch.bfloat16, True),
             "f32 (8, 4096, 252)": (BATCH, TOKENS, PATCH, 252, torch.float32, True),
             "kirp bf16 (8, 4096, 270)": (BATCH, TOKENS, PATCH, 270, torch.bfloat16, True),
             "f32 (2, 300, 70)": (2, 300, 200, 70, torch.float32, False),
             "bf16 omic (8, 1, 252)": (BATCH, 1, OMIC, 252, torch.bfloat16, False),
             "bf16 batch 5000 (5000, 1, 252)": (5000, 1, 64, 252, torch.bfloat16, False)}
    timings, worst = {}, 0.0
    for label, (b, t, c, f, dtype, timed) in cases.items():
        *_, run, _ = projection_case(gen, b, t, c, f, dtype)
        _, s1, s2 = run()  # the forward kernel's saved row statistics
        g = torch.randn((b, t, f), generator=gen, device="cuda").to(dtype)
        d_total = c + 5
        reset_launches()
        got = fused_project_bwd_kernel(g, s1, s2, d_total)
        read_launches(f"the {label} call", ("fused_project_bwd",))
        err = check_bwd(label, got, project_bwd_plain(g, s1, s2, d_total), g, s1, s2, d_total,
                        show_refusals=timed)
        if label.startswith("bf16 (8, 4096"):
            worst = err
        if timed:
            timings[label] = time_bwd(
                label, lambda: fused_project_bwd_kernel(g, s1, s2, d_total),
                lambda: project_bwd_plain(g, s1, s2, d_total),
                nbytes(g, s1, s2, *got), g.numel(), 4.0, dtype)  # 4 operations an element
    return dict(name="fused_project_bwd", route="cuda",
                source="healnet_tpu_torch/ops/csrc/fused_project_bwd.cu",
                replaces="healnet_tpu/ops/fused_project.py:268", max_abs_err=worst,
                **timings["bf16 (8, 4096, 252)"], library_ms=None)


# ---------------------------------------------------------------- phase 7


def brca_trainer(dtype, attention_impl, projection_impl, state_dict=None):
    """The training step of bench.py: NLL/16 + 1e-6 * L1, Adam, max_lr 8e-3."""
    module = HealNetModule(
        **BRCA, dtype=dtype, attention_impl=attention_impl,
        projection_impl=projection_impl, device="cuda",
        generator=torch.Generator().manual_seed(0),
    )
    if state_dict is not None:
        module.load_state_dict(state_dict)
    return SurvivalTrainer(module, l1=1e-6, max_lr=8e-3, gc_compat=16, seed=0, device="cuda")


def train_batch(host_rng, dtype) -> dict:
    """bench.py's batch, on the card: omic 1 x 2000 and WSI 4096 x 2048
    features (in the compute dtype), labels, censoring, event times."""
    put = lambda a, dt=None: torch.as_tensor(a, device="cuda", dtype=dt)
    return {
        "tensors": (put(host_rng.standard_normal((BATCH, 1, OMIC), dtype=np.float32), dtype),
                    put(host_rng.standard_normal((BATCH, TOKENS, PATCH), dtype=np.float32), dtype)),
        "y_disc": put(host_rng.integers(0, 4, size=BATCH)),
        "censorship": put(host_rng.integers(0, 2, size=BATCH).astype(np.float32)),
        "event_time": put(host_rng.uniform(1, 100, size=BATCH).astype(np.float32)),
        "sample_mask": put(np.ones(BATCH, np.float32)),
    }


HORIZON = 1000  # bench.py's schedule length


def compare_gradients(label, kernel, plain, batch, tol_loss, tol_grad, plain_batch=None) -> None:
    """Step 1 on both paths (same weights, same generator seeds, so the same
    dropout draws; ``plain_batch`` where the plain path takes its inputs in
    another dtype); the losses and every parameter's gradient, as L2 errors
    relative to the plain path's gradient of that parameter, or to 1% of the
    global gradient norm where that is larger.

    The floor: the omic modality has one token, so its cross-attention's
    softmax is constant and the true gradients of its query path (``norm``,
    ``to_q``) are zero apart from the L1 term. The plain path's autograd
    gives exactly that; the flash backward's ``delta = rowsum(dO * O)``
    cancels ``dO . v`` only up to rounding (in bf16, of the bf16 output),
    as the JAX package's kernel does. Relative to a zero gradient that
    noise would be unbounded."""
    loss_k = kernel.train_step(batch, HORIZON)[0].item()
    loss_p = plain.train_step(batch if plain_batch is None else plain_batch, HORIZON)[0].item()
    check(f"{label} step-1 loss {loss_k:.6f} vs {loss_p:.6f} (relative)",
          abs(loss_k - loss_p) / abs(loss_p), tol_loss)
    worst, where = worst_grad_error(gradients(kernel.module), gradients(plain.module))
    check(f"{label} step-1 gradients, worst relative L2 error ({where})", worst, tol_grad)


def gradients(module) -> dict:
    return {n: p.grad.float() for n, p in module.named_parameters()}


def worst_grad_error(grads: dict, ref: dict):
    """(worst error, parameter name): each gradient of ``grads`` against
    ``ref``'s, as an L2 error relative to the reference gradient's norm or
    to 1% of the global reference norm, whichever is larger (see
    :func:`compare_gradients`)."""
    floor = 0.01 * torch.sqrt(sum(g.square().sum() for g in ref.values())).item()
    worst, where = 0.0, ""
    for name, g in grads.items():
        err = ((g - ref[name]).norm() / max(ref[name].norm().item(), floor)).item()
        if not err < worst:
            worst, where = err, name
    return worst, where


def step_times(trainer, batch):
    """(wall ms per synchronous step, device busy ms per step, idle share,
    the profiler's device events over 3 steps), inputs on the card."""
    step = lambda: trainer.train_step(batch, HORIZON)
    wall = wall_ms(step)
    _, busy, _, rows = device_profile(step)
    return wall, busy, 1.0 - busy / wall, rows


def phase_training(host_rng) -> dict:
    log("phase 7: training the full-width BRCA model through SurvivalTrainer.train_step")
    batch32 = train_batch(host_rng, torch.float32)
    k32 = brca_trainer(None, "flash", "auto")
    state = {k: v.clone() for k, v in k32.module.state_dict().items()}
    plain32 = brca_trainer(None, "xla", "xla", state)
    # f32: both paths in full f32 (no TF32), differing in summation order
    # only, and drawing the same dropout masks: tight. The f32 kernel-path
    # step is the run of the flash kernels' FMA variants.
    reset_launches()
    compare_gradients("f32", k32, plain32, batch32, 1e-5, 1e-4)
    fma = read_launches("the f32 kernel-path step",
                        ("flash_attention_fma", "flash_attention_bwd_fma", "fused_project_f32"))
    del plain32
    f_wall, f_busy, f_idle, rows = step_times(k32, batch32)
    ours = [e for e in rows if "project_f32" in e.key or "project_bwd" in e.key]
    fma_rows = [e for e in rows if "flash" in e.key]
    log(f"  f32 train step, batch {BATCH}, inputs on the card: wall {f_wall:.4f} ms, device busy "
        f"{f_busy:.4f} ms per step (profiler), idle share {f_idle:.4f}; the f32 projection "
        f"forward and backward kernels {sum(map(device_us, ours)) / 3e3:.4f} ms of it: "
        + "; ".join(f"{e.key.replace('void ', '').replace('(anonymous namespace)::', '')[:40]} "
                    f"{device_us(e) / 3e3:.4f} ms ({e.count / 3:.0f})" for e in ours))
    log(f"  the flash FMA kernels in the f32 step: {sum(map(device_us, fma_rows)) / 3e3:.4f} ms: "
        + "; ".join(f"{e.key.replace('void ', '').replace('(anonymous namespace)::', '')[:40]} "
                    f"{device_us(e) / 3e3:.4f} ms ({e.count / 3:.0f})" for e in fma_rows))
    del batch32, k32
    batch = train_batch(host_rng, torch.bfloat16)
    kernel = brca_trainer(torch.bfloat16, "flash", "auto", state)
    # bf16: the plain path takes its attention scores and softmax in bf16,
    # the kernels in f32 with bf16-rounded probabilities: loose
    compare_gradients("bf16", kernel, brca_trainer(torch.bfloat16, "xla", "xla", state),
                      batch, 2e-2, 0.1)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    losses = [kernel.train_step(batch, HORIZON)[0] for _ in range(5)]
    losses = [x.item() for x in losses]
    launches = read_launches("the training run (5 steps, kernel path)", FLOAT_KERNELS)
    peak = torch.cuda.max_memory_allocated() / 2**20
    log(f"  losses of 5 steps: {losses}")
    if not all(np.isfinite(losses)):
        raise AssertionError("a training loss is not finite")

    plain_attention = brca_trainer(torch.bfloat16, "xla", "auto", state)
    t_wall, t_busy, t_idle, rows = step_times(kernel, batch)
    x_wall, x_busy, x_idle, _ = step_times(plain_attention, batch)
    log(f"  train step, batch {BATCH}, bf16, inputs on the card: wall {t_wall:.4f} ms per "
        f"synchronous step, {BATCH / t_wall * 1e3:.2f} samples/s; device busy {t_busy:.4f} ms "
        f"per step (profiler), idle share {t_idle:.4f}; peak memory {peak:.1f} MiB")
    log(f"  the same step with plain attention (attention_impl='xla'): wall {x_wall:.4f} ms, "
        f"device busy {x_busy:.4f} ms, idle share {x_idle:.4f}")
    flash = [e for e in rows if "flash" in e.key]
    log(f"  flash kernels in the kernel-path step: {sum(map(device_us, flash)) / 3e3:.4f} ms of "
        f"{t_busy:.4f} ms device busy per step (profiler); " + "; ".join(
            f"{e.key.replace('void ', '').replace('(anonymous namespace)::', '')[:40]} "
            f"{device_us(e) / 3e3:.4f} ms ({e.count / 3:.0f})" for e in flash))
    return {**launches, **fma}


@contextlib.contextmanager
def held_flash_calls(label: str):
    """Hold every flash call made inside against its plain version on the
    same inputs: f32 calls against it in f64 (the backward's log-sum-exp
    taken in f64 as well), the forward to 2e-5 as phase 3, each gradient to
    1e-5 of its largest value (of the call's largest gradient at one key, as
    phase 5), with no floor at 1: a step's gradients lie far below 1; bf16
    calls against it in f32, to 4 bf16 ulps of the largest value. The calls
    are caught at ``FlashAttentionFunction``, whose forward and backward
    are swapped for the time of the block, so the wrappers count their
    launches as on any path. Yields {direction: calls held}; logs the worst
    error of each direction and key count."""
    forward, backward = FlashAttentionFunction.forward, FlashAttentionFunction.backward
    worst, held = {}, {"forward": 0, "backward": 0}

    def hold(direction, name, keys, got, ref, largest=0.0) -> None:
        top = ref.abs().max().item()
        tol = (2e-5 if direction == "forward" else 1e-5 * (largest if keys == 1 else top)) \
            if got.dtype == torch.float32 else 4 * bf16_ulp(top)
        err = (got.double() - ref.double()).abs().max().item()
        if not err <= tol:
            raise AssertionError(f"{label}: the {direction} call at {keys} keys, {name}: "
                                 f"max|d| {err} exceeds {tol}")
        key = (direction, keys)
        worst[key] = max(worst.get(key, (0.0, tol)), (err, tol), key=lambda x: x[0] / x[1])

    def ref_dtype(x):
        return torch.float64 if x.dtype == torch.float32 else torch.float32

    def checked_forward(ctx, q, k, v, kv_mask, eff_scale, rate, seed, row_offset=0,
                        head_stride=0):
        out = forward(ctx, q, k, v, kv_mask, eff_scale, rate, seed, row_offset, head_stride)
        wide = ref_dtype(q)
        ref, _ = multihead_attention(q.to(wide), k.to(wide), v.to(wide), scale=eff_scale,
                                     temperature=1.0, kv_mask=kv_mask, dropout_rate=rate,
                                     dropout_seed=seed if rate > 0 else None,
                                     row_offset=row_offset, head_stride=head_stride)
        hold("forward", "out", k.shape[2], out, ref)
        held["forward"] += 1
        return out

    def checked_backward(ctx, g):
        q, k, v, kv_mask, out, lse = ctx.saved_tensors
        grads = backward(ctx, g)
        b, h, lq, d = q.shape
        # the kernel's inputs (dO in q's dtype, delta = rowsum(dO * O)), f32
        # ones widened to f64, with the log-sum-exp taken in f64 (the f32
        # kernel's -1e30 of a fully masked row is another number in f64)
        wide = torch.float64 if q.dtype == torch.float32 else q.dtype
        gw = g.to(q.dtype).to(torch.promote_types(wide, torch.float32)).reshape(b, lq, h, d)
        delta = (gw * out.to(gw.dtype).reshape(b, lq, h, d)).sum(-1).transpose(1, 2)
        q, k, v, do = q.to(wide), k.to(wide), v.to(wide), gw.to(wide).transpose(1, 2)
        if wide == torch.float64:
            lse = flash_lse_plain(q, k, kv_mask, ctx.eff_scale)
        ref = flash_backward_plain(q, k, v, kv_mask, do, lse, delta, ctx.eff_scale, ctx.rate,
                                   ctx.seed, *ctx.rows)
        largest = max(r.abs().max().item() for r in ref)
        for name, got, want in zip(("dq", "dk", "dv"), grads, ref):
            hold("backward", name, k.shape[2], got, want, largest)
        held["backward"] += 1
        return grads

    FlashAttentionFunction.forward = staticmethod(checked_forward)
    FlashAttentionFunction.backward = staticmethod(checked_backward)
    try:
        yield held
    finally:
        FlashAttentionFunction.forward = staticmethod(forward)
        FlashAttentionFunction.backward = staticmethod(backward)
    ref = "f64" if "float32" in label else "f32"
    log(f"  {label}, each flash call against its plain version in {ref}: " + "; ".join(
        f"{direction} at {keys} keys, worst {err:.4g} (tolerance {tol:.4g})"
        for (direction, keys), (err, tol) in sorted(worst.items())))


def phase_wide_step(host_rng) -> dict:
    """The wide heads' paths: one training step of the brca model with a
    320-wide cross head in f32 and in bf16 (the one-pass wide kernels, FMA
    and tensor-core) and one with a 576-wide head in f32 and in bf16 (the
    panel kernels, two panels of 288; the model is not cut, only its cross
    head's width is synthetic). Each step holds every flash call it makes
    (the WSI context and
    the one-token omic one, forward and backward) against the plain version
    on that call's inputs (:func:`held_flash_calls`), must launch its
    route's forward and backward kernel (each launch held) and no other
    flash kernel, and its
    gradients are held against a reference step from the same weights and
    dropout draws with phase 7's tolerances for its dtype.

    Reference steps: the 320-wide f32 step, the plain path in f64; the bf16
    steps, the plain path in bf16 (as phase 7). The 576-wide f32 step, the same
    step with plain attention and the projection kernel, which phase 2
    holds on its own at this head's width (F 2304): in that step one SELU
    gate of the second layer's WSI feed-forward lies 2.9e-7 from the kink,
    and the projection kernel's f32 rounding (unlike the plain projection's
    and f64's) puts it on the other side, which moves that layer's
    feed-forward gradients by 1.5e-3 from f64
    (``scripts/check_wide_step_precision.py``)."""
    launches = {}
    f32, bf16 = torch.float32, torch.bfloat16
    for head, dtype, names, tols, ref in (
            (WIDE_D, f32, ("flash_attention_wide_fma", "flash_attention_bwd_wide_fma"),
             (1e-5, 1e-4), "plain path in f64"),
            (WIDE_D, bf16, ("flash_attention_wide_tc", "flash_attention_bwd_wide_tc"),
             (2e-2, 0.1), "plain path"),
            (PANEL_D, f32, ("flash_attention_panel_fma", "flash_attention_bwd_panel_fma"),
             (1e-5, 1e-4), "plain attention, projection kernel"),
            (PANEL_D, bf16, ("flash_attention_panel_tc", "flash_attention_bwd_panel_tc"),
             (2e-2, 0.1), "plain path")):
        name = str(dtype)[6:]
        log(f"phase 7 (continued): one {name} training step with a {head}-wide cross head")
        batch = train_batch(host_rng, dtype)
        make = lambda dt, attention, projection: SurvivalTrainer(
            HealNetModule(**{**BRCA, "cross_dim_head": head}, dtype=dt, attention_impl=attention,
                          projection_impl=projection, device="cuda",
                          generator=torch.Generator().manual_seed(0)),
            l1=1e-6, max_lr=8e-3, gc_compat=16, seed=0, device="cuda")
        kernel = make(None if dtype == f32 else dtype, "flash", "auto")
        state, plain_batch = kernel.module.state_dict(), None
        if ref == "plain path in f64":
            plain = make(torch.float64, "xla", "xla")
            state = {n: v.double() for n, v in state.items()}
            plain_batch = {**batch, "tensors": tuple(x.double() for x in batch["tensors"])}
        else:
            plain = make(None if dtype == f32 else dtype, "xla",
                         "xla" if ref == "plain path" else "auto")
        plain.module.load_state_dict(state)
        reset_launches()
        run = f"the {name} step with a {head}-wide head"
        with held_flash_calls(run) as held:
            compare_gradients(f"{name} head {head} (against the {ref})", kernel, plain, batch,
                              *tols, plain_batch=plain_batch)
        counts = read_launches(run, names)
        if (held["forward"], held["backward"]) != tuple(counts[n] for n in names):
            raise AssertionError(f"{run}: {held} calls held, {counts} launched")
        others = {n: getattr(*KERNELS[n]) for n in KERNELS
                  if n.startswith("flash_attention") and n not in names}
        if any(others.values()):
            raise AssertionError(f"{run}: other flash kernels launched: {others}")
        launches.update(counts)
        del batch, kernel, plain
    return launches


# the reference-parity layout (config/main.yml: patch_attention false): the
# slide as (dim, n_patches), patches as channels; a cohort's largest bag
# (max_patches) of 4,095 patches and an omic CSV of 2,001 columns stand in
# for a cohort's widths
PARITY_OMIC, PARITY_TOKENS, PARITY_PATCHES = 2001, 2048, 4095


def kv_halves(name: str, got: dict, ref: dict) -> str:
    """Where a ``to_kv`` gradient's error lies: the K rows' share of its
    squared error, and the K rows' reference norm against the V rows'
    (0 where the context has one token: softmax over one key has no score
    gradient, so the K rows' gradient is rounding residue)."""
    if not name.endswith("to_kv.weight"):
        return ""
    half = got[name].shape[0] // 2
    d, r = got[name] - ref[name], ref[name]
    return (f"; K rows {(d[:half].square().sum() / d.square().sum()).item():.3f} of its squared "
            f"error, K / V reference norm {(r[:half].norm() / r[half:].norm()).item():.3g}")


def phase_parity_step(seeds) -> dict:
    """The brca model in the reference-parity layout at full width and depth
    (only the bag width stands in for a cohort's): omic (8, 1, 2001) and
    the slide (8, 2048, 4095) in bf16, rows at 2-byte offsets, so both
    projections take the generic route (the split kernel for the omic
    vector, the Hopper kernel's hull kinds for the slide).

    One training step through ``SurvivalTrainer.train_step`` on each draw
    of data (a host generator for each of ``seeds``; the same weights and
    dropout draws), each held against the plain path (``impl="xla"`` for
    both ops) in f64: the loss at phase 7's bf16 tolerance, and the
    gradients as phase 10 holds its bf16 step: the kernel path's error
    from f64 must be within 1.5x the plain path's in bf16. Both bf16 paths
    swing from f64 with the draw (0.016-0.105 in the worst parameter), each
    farther than the other on some draw, so the two are compared over all
    draws: the kernel path's worst error must be within 1.5x the plain
    path's worst. One served batch (the first draw) through ``Predictor``
    against the plain path in bf16 at phase 4's tolerance. The step's
    launches per counter (the main path's run of the generic route), wall,
    device busy and idle share. Returns the step's launches."""
    log("phase 7 (continued): a bf16 step and a served batch in the reference-parity layout "
        f"(omic 1 x {PARITY_OMIC}, slide {PARITY_TOKENS} x {PARITY_PATCHES})")
    dims = {**BRCA, "channel_dims": (PARITY_OMIC, PARITY_PATCHES)}

    def module(attention, projection, state=None, dtype=torch.bfloat16):
        m = HealNetModule(**dims, dtype=dtype, attention_impl=attention,
                          projection_impl=projection, device="cuda",
                          generator=torch.Generator().manual_seed(0))
        if state is not None:
            m.load_state_dict(state)
        return m

    trainer = lambda m: SurvivalTrainer(m, l1=1e-6, max_lr=8e-3, gc_compat=16, seed=0,
                                        device="cuda")
    state = {k: v.clone() for k, v in module("flash", "auto").state_dict().items()}
    put = lambda a, dt=None: torch.as_tensor(a, device="cuda", dtype=dt)
    names = ("fused_project_generic", "fused_project_generic_split", "fused_project_bwd",
             "flash_attention", "flash_attention_bwd")
    errors = []
    for seed in seeds:
        host_rng = np.random.default_rng(seed)
        omic = host_rng.standard_normal((BATCH, 1, PARITY_OMIC), dtype=np.float32)
        wsi = host_rng.standard_normal((BATCH, PARITY_TOKENS, PARITY_PATCHES), dtype=np.float32)
        batch = {"tensors": (put(omic, torch.bfloat16), put(wsi, torch.bfloat16)),
                 "y_disc": put(host_rng.integers(0, 4, size=BATCH)),
                 "censorship": put(host_rng.integers(0, 2, size=BATCH).astype(np.float32)),
                 "event_time": put(host_rng.uniform(1, 100, size=BATCH).astype(np.float32)),
                 "sample_mask": put(np.ones(BATCH, np.float32))}
        kernel = trainer(module("flash", "auto", state))
        reset_launches()
        loss = kernel.train_step(batch, HORIZON)[0].item()
        step_launches = read_launches(f"the parity-layout step, draw {seed} (launches per step)",
                                      names)
        grads = gradients(kernel.module)
        plain64 = trainer(module("xla", "xla", {k: v.double() for k, v in state.items()},
                                 torch.float64))
        loss64 = plain64.train_step(
            {**batch, "tensors": tuple(x.double() for x in batch["tensors"])}, HORIZON)[0].item()
        ref = {n: g.float() for n, g in gradients(plain64.module).items()}
        del plain64
        check(f"bf16 parity layout draw {seed} step-1 loss {loss:.6f} vs the plain path in f64 "
              f"{loss64:.6f} (relative)", abs(loss - loss64) / abs(loss64), 2e-2)
        plain = trainer(module("xla", "xla", state))
        plain.train_step(batch, HORIZON)
        plain_grads = gradients(plain.module)
        del plain
        (err_k, at_k), (err_p, at_p) = (worst_grad_error(g, ref) for g in (grads, plain_grads))
        log(f"  draw {seed}: step-1 gradients against the plain path in f64, worst relative L2 "
            f"error: kernel path {err_k:.4g} ({at_k}{kv_halves(at_k, grads, ref)}), plain path "
            f"in bf16 {err_p:.4g} ({at_p}{kv_halves(at_p, plain_grads, ref)}); the kernel path "
            "against the plain path in bf16: worst %.4g (%s)" % worst_grad_error(grads,
                                                                                 plain_grads))
        errors.append((err_k, err_p))
        if seed == seeds[0]:  # timed and served below
            first = (step_launches, kernel, batch, omic, wsi)
        del kernel, batch, grads, plain_grads, ref
    worst_k, worst_p = (max(e) for e in zip(*errors))
    check(f"bf16 parity layout step-1 gradients: the kernel path's worst error from f64 over "
          f"draws {tuple(seeds)} (tolerance: 1.5x the plain path's in bf16, {worst_p:.4g})",
          worst_k, 1.5 * worst_p)
    launches, kernel, batch, omic, wsi = first
    del first
    wall, busy, idle, rows = step_times(kernel, batch)
    ours = [e for e in rows if "project" in e.key]
    log(f"  parity-layout train step, batch {BATCH}, bf16, inputs on the card: wall {wall:.4f} ms, "
        f"device busy {busy:.4f} ms per step (profiler), idle share {idle:.4f}; the projection "
        "kernels: " + "; ".join(
            f"{e.key.replace('void ', '').replace('(anonymous namespace)::', '')[:48]} "
            f"{device_us(e) / 3e3:.4f} ms ({e.count / 3:.0f})" for e in ours))
    del kernel, batch

    serve = lambda attention, projection: Predictor(
        module(attention, projection, state), batch_size=BATCH, bucket_boundaries=BUCKETS,
        device="cuda")
    pred, ref = serve("flash", "auto"), serve("xla", "xla")
    reset_launches()
    got = pred([omic, wsi])
    read_launches("the parity-layout served batch", names[:2] + ("flash_attention",))
    if got["logits"].shape != (BATCH, 4):
        raise AssertionError(f"parity-layout logits of shape {got['logits'].shape}")
    compare("parity-layout served batch", got, ref([omic, wsi]), 0.1)
    return {name: launches[name] for name in names[:2]}


# --------------------------------------------------------------- phase 12


def fit_split(host_rng, n: int) -> dict:
    """n synthetic patients at full brca width: omic 1 x 2000 and a WSI bag
    of 4096 x 2048 (f32), 4-bin labels, censoring and event times."""
    return {"tensors": (host_rng.standard_normal((n, 1, OMIC), dtype=np.float32),
                        host_rng.standard_normal((n, TOKENS, PATCH), dtype=np.float32)),
            "y_disc": host_rng.integers(0, 4, size=n),
            "censorship": (host_rng.uniform(size=n) < 0.4).astype(np.float32),
            "event_time": host_rng.uniform(1, 100, size=n).astype(np.float32)}


def fit_trainer(module, **kw):
    return SurvivalTrainer(module, l1=1e-6, max_lr=8e-3, gc_compat=16, seed=0, batch_size=BATCH,
                           device="cuda", **kw)


# the fused fold's bucket boundaries: bags of 1024-4096 patches in two widths
FIT_BUCKETS = (2048, TOKENS)


class ArenaSplit:
    """A split's patients as an arena-indexed streaming source, as a
    dataset with bucket boundaries hands them to the trainer: each bag's
    first ``length`` patches (1024-4096) in a host arena shared by the
    splits, batches of one bucket width each (padded by repeating the last
    patient, masked), in a shuffled order."""

    def __init__(self, split: dict, offsets, lengths):
        self.split, self.offsets, self.lengths = split, offsets, lengths

    def __len__(self) -> int:
        return len(self.lengths)

    def _batches(self, idx, batch_size, boundaries):
        out = []
        for lo, hi in zip((0,) + tuple(boundaries[:-1]), boundaries):
            sel = [int(i) for i in idx if lo < self.lengths[i] <= hi]
            out += [(hi, sel[j:j + batch_size]) for j in range(0, len(sel), batch_size)]
        return out

    def count_batches(self, indices, batch_size, boundaries) -> int:
        return len(self._batches(range(len(self)), batch_size, boundaries))

    def iter_batches(self, batch_size, shuffle=False, rng=None, bucket_boundaries=FIT_BUCKETS):
        idx = np.arange(len(self))
        if shuffle:
            rng.shuffle(idx)
        groups = self._batches(idx, batch_size, bucket_boundaries)
        for g in (rng.permutation(len(groups)) if shuffle else range(len(groups))):
            width, sel = groups[g]
            mask = np.ones(batch_size, np.float32)
            mask[len(sel):] = 0.0
            sel = np.asarray(sel + [sel[-1]] * (batch_size - len(sel)))
            s = self.split
            yield {"tensors": (s["tensors"][0][sel],),
                   "kv_masks": (None, np.arange(width)[None, :] < self.lengths[sel][:, None]),
                   "patch_offsets": self.offsets[sel], "patch_lengths": self.lengths[sel],
                   "y_disc": s["y_disc"][sel].astype(np.int32),
                   "censorship": s["censorship"][sel], "event_time": s["event_time"][sel],
                   "sample_mask": mask}


def arena_splits(host_rng, splits):
    """The splits' WSI bags cut to random lengths of 1024-4096 patches and
    packed back to back into one host arena (then TOKENS zero rows); one
    :class:`ArenaSplit` a split."""
    lengths = [host_rng.integers(TOKENS // 4, TOKENS + 1, size=len(s["y_disc"])).astype(np.int32)
               for s in splits]
    total = int(sum(ln.sum() for ln in lengths))
    arena = np.zeros((total + TOKENS, PATCH), np.float32)
    sources, at = [], 0
    for split, ln in zip(splits, lengths):
        offsets = (at + np.concatenate([[0], np.cumsum(ln)[:-1]])).astype(np.int32)
        for bag, o, n in zip(split["tensors"][1], offsets, ln):
            arena[o:o + n] = bag[:n]
        at += int(ln.sum())
        sources.append(ArenaSplit(split, offsets, ln))
    return arena, sources


def phase_fused_fold(host_rng, train, val) -> None:
    """Phase 12's fused fold: the train and val patients from a host arena
    in two bucket widths, 2 epochs with ``fused_epochs=True`` (the
    captured steps, fused evaluation, a checkpoint each epoch), then a fold
    that stops in epoch 2 and resumes from epoch 1's checkpoint, held
    against the uninterrupted one; the captured step's wall, device busy,
    idle share, launches and peak memory from one bucket."""
    arena, (src_train, src_val) = arena_splits(host_rng, (train, val))
    log(f"  fused fold: arena {arena.shape} f32 from {len(src_train)} + {len(src_val)} "
        f"patients, bucket boundaries {FIT_BUCKETS}, "
        f"{src_train.count_batches(None, BATCH, FIT_BUCKETS)} train steps an epoch")

    class StopAt2:
        def log(self, metrics, step=None):
            if step == 2:
                raise InterruptedError

        def watch(self, **kw):
            pass

    def trainer(ckpt_dir, **kw):
        module = HealNetModule(**BRCA, attention_impl="flash", device="cuda",
                               generator=torch.Generator().manual_seed(0))
        return fit_trainer(module, epochs=2, checkpoint_dir=ckpt_dir, feature_arena=arena,
                           fused_epochs=True, bucket_boundaries=FIT_BUCKETS, prefetch=0,
                           early_stopping=False, **kw)

    with tempfile.TemporaryDirectory() as whole_dir, tempfile.TemporaryDirectory() as cut_dir:
        whole = trainer(whole_dir)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        result = whole.fit(src_train, src_val, verbose=False)
        peak = torch.cuda.max_memory_allocated() / 2**20
        hist = result["history"]
        tables = sorted((key[0], key[1], key[2], t.graph is not None)
                        for key, t in whole._tables.items())
        log(f"  fused fit: epoch walls {[round(h['seconds'], 4) for h in hist]} s; train loss "
            f"{[round(h['train_loss'], 6) for h in hist]}, val loss "
            f"{[round(h['val_loss'], 6) for h in hist]}, val c-index {result['val_c_index']:.6f}; "
            f"step tables (kind, width, slots, captured) {tables}; peak memory {peak:.1f} MiB; "
            f"host launch counts (warm-up and capture only; replays are not counted) "
            f"{ {n: getattr(*KERNELS[n]) for n in ('fused_project_f32', 'flash_attention_fma')} }")
        if len({key[1] for key in whole._tables}) < 2 or not all(t[3] for t in tables):
            raise AssertionError(f"the fused fold did not capture two bucket widths: {tables}")
        if not all(np.isfinite([h["train_loss"] for h in hist] + [result["val_loss"]])):
            raise AssertionError("the fused fit gave a non-finite loss")
        if Checkpointer(whole_dir).latest_step() != 2:
            raise AssertionError("the fused fit saved no checkpoint of epoch 2")
        cut = trainer(cut_dir, tracker=StopAt2())
        try:
            cut.fit(src_train, src_val, verbose=False)
            raise AssertionError("the stopping tracker did not stop the fold")
        except InterruptedError:
            pass
        resumed = trainer(cut_dir, resume=True)
        again = resumed.fit(src_train, src_val, verbose=False)
        got, want = again["history"][0], hist[1]
        log(f"  resumed from epoch 1's checkpoint: epoch {got['epoch']} train loss "
            f"{got['train_loss']:.6f}, val loss {got['val_loss']:.6f}, val c-index "
            f"{got['val_c_index']:.6f} (uninterrupted: {want['train_loss']:.6f}, "
            f"{want['val_loss']:.6f}, {want['val_c_index']:.6f})")
        err = max(abs(got[k] - want[k]) / abs(want[k]) for k in ("train_loss", "val_loss"))
        w_err, where, same = weight_error(resumed.module, whole.module)
        log(f"  resumed fold against the uninterrupted one: bit-identical weights {same}")
        check("resumed fused fold's epoch-2 losses against the uninterrupted fold (relative)",
              err, 1e-5)
        check(f"resumed fused fold's weights against the uninterrupted fold ({where})", w_err,
              1e-5)
        if got["epoch"] != 2 or got["val_c_index"] != want["val_c_index"]:
            raise AssertionError("the resumed fold's epoch 2 differs from the uninterrupted one")

        # the captured step, from one bucket's host batches, and the
        # stepwise step on the same batches
        blist = [b for b in src_train.iter_batches(BATCH, True, np.random.default_rng(0))
                 if b["kv_masks"][-1].shape[1] == TOKENS]
        n = len(blist)
        for name, run in (("captured", lambda: whole._fused_train_bucket(blist)),
                          ("stepwise", lambda: [whole.train_step(b, HORIZON) for b in blist])):
            wall = wall_ms(run, reps=3) / n
            _, busy, count, _ = device_profile(run)
            log(f"  fused fold's {name} step at width {TOKENS} ({n} steps a call, from host "
                f"batches): wall {wall:.4f} ms per step, device busy {busy / n:.4f} ms per step "
                f"(profiler), idle share {1.0 - busy / n / wall:.4f}, {count / n:.1f} device "
                f"kernels and copies and {HOST_LAUNCHES[0] / n:.2f} host launch calls per step")


def phase_fit(host_rng) -> None:
    """The wrapper, remat, fit, resume and serving from a checkpoint, at the
    brca row in f32 (the JAX default precision) at full width, flash
    attention, dropout 0.083 / 0.473."""
    log("phase 12: the wrapper, remat, fit, resume and serving from a checkpoint (brca, f32)")
    t_phase = time.perf_counter()
    train, val, test = fit_split(host_rng, 24), fit_split(host_rng, 8), fit_split(host_rng, 8)
    omic, wsi = val["tensors"]
    dims = {k: v for k, v in BRCA.items() if k not in ("attn_dropout", "ff_dropout")}

    # (a) the HealNet wrapper on the card against HealNetModule on the plain path
    wrapper = HealNet(**BRCA, store_attention="lazy", attention_impl="flash", seed=0,
                      device="cuda")
    plain = HealNetModule(**BRCA, attention_impl="xla", projection_impl="xla", device="cuda")
    plain.load_state_dict(wrapper.module.state_dict())
    plain.eval()
    with torch.no_grad():
        x = [torch.as_tensor(omic, device="cuda"), torch.as_tensor(wsi, device="cuda")]
        want = plain(x)
        presence = torch.tensor([[1.0, 0.0]] * len(omic), device="cuda")
        want_missing = plain([x[0], torch.zeros((len(omic), 1, PATCH), device="cuda")],
                             presence=presence)
    check("wrapper [omic, wsi] logits vs HealNetModule, plain path",
          (wrapper([omic, wsi]) - want).abs().max().item(), 1e-3)
    weights = wrapper.get_attention_weights()
    shapes = [w.shape for w in weights]
    want_shapes = [(len(omic), BRCA["l_c"], t) for _ in range(BRCA["depth"]) for t in (1, TOKENS)]
    log(f"  get_attention_weights (lazy): {len(weights)} arrays, shapes {shapes}")
    if shapes != want_shapes or not all(np.isfinite(w).all() for w in weights):
        raise AssertionError(f"captured weights: shapes {shapes}, expected {want_shapes}")
    check("wrapper [omic, None] logits vs HealNetModule, plain path",
          (wrapper([omic, None]) - want_missing).abs().max().item(), 1e-3)
    del wrapper, plain, x

    # (b) one training step with and without remat, from the same weights
    put = lambda a: torch.as_tensor(a[:BATCH], device="cuda")
    batch = {k: tuple(map(put, v)) if k == "tensors" else put(v) for k, v in train.items()}
    batch["sample_mask"] = torch.ones(BATCH, device="cuda")
    state = None
    for rates in ((0.0, 0.0), (BRCA["attn_dropout"], BRCA["ff_dropout"])):
        runs = {}
        for remat in (False, True):
            module = HealNetModule(**dims, attn_dropout=rates[0], ff_dropout=rates[1],
                                   attention_impl="flash", remat=remat, device="cuda",
                                   generator=torch.Generator().manual_seed(0))
            if state is None:
                state = {k: v.clone() for k, v in module.state_dict().items()}
            module.load_state_dict(state)
            trainer = fit_trainer(module)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            trainer.train_step(batch, HORIZON)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() / 2**20
            runs[remat] = gradients(module)
            _, busy, _, _ = device_profile(lambda: trainer.train_step(batch, HORIZON))
            log(f"  step, remat={remat}, dropout {rates}: device busy {busy:.4f} ms "
                f"(profiler), peak memory {peak:.1f} MiB")
            del trainer, module
        # as phase 7: each gradient's L2 error relative to its norm or to 1%
        # of the global norm (the omic query path's gradient is the L1 term
        # plus the flash backward's rounding noise)
        worst, where = worst_grad_error(runs[True], runs[False])
        check(f"remat vs plain step gradients, dropout {rates} (worst relative L2, {where})",
              worst, 1e-5)

    # (c) fit for 2 epochs with checkpoints, then resume the finished fold
    with tempfile.TemporaryDirectory() as ckpt_dir:
        module = HealNetModule(**BRCA, attention_impl="flash", device="cuda",
                               generator=torch.Generator().manual_seed(0))
        trainer = fit_trainer(module, epochs=2, prefetch=2, checkpoint_dir=ckpt_dir,
                              keep_checkpoints=2)
        step_walls = []
        step = trainer.train_step

        def timed_step(*a, **kw):
            t0 = time.perf_counter()
            out = step(*a, **kw)
            torch.cuda.synchronize()
            step_walls.append(time.perf_counter() - t0)
            return out

        trainer.train_step = timed_step
        reset_launches()
        result = trainer.fit(train, val, test_data=test, verbose=False)
        read_launches("the 2-epoch fit", ("fused_project_f32", "fused_project_bwd",
                                          "flash_attention_fma", "flash_attention_bwd_fma"))
        del trainer.train_step
        hist = result["history"]
        log(f"  fit: epoch walls {[round(h['seconds'], 4) for h in hist]} s, mean step wall "
            f"{statistics.mean(step_walls) * 1e3:.4f} ms over {len(step_walls)} steps; "
            f"train loss {[round(h['train_loss'], 6) for h in hist]}, val loss "
            f"{result['val_loss']:.6f}, val c-index {result['val_c_index']:.6f}, test c-index "
            f"{result['test_c_index']:.6f}")
        if not all(np.isfinite([h["train_loss"] for h in hist] + [result["val_loss"]])):
            raise AssertionError("fit gave a non-finite loss")
        Checkpointer(ckpt_dir).save_best(trainer.module.state_dict())
        resumed = fit_trainer(HealNetModule(**BRCA, attention_impl="flash", device="cuda"),
                              epochs=2, checkpoint_dir=ckpt_dir, resume=True)
        again = resumed.fit(train, val, verbose=False)
        same = (again["history"][0].get("resumed_complete")
                and again["val_loss"] == result["val_loss"]
                and again["val_c_index"] == result["val_c_index"])
        log(f"  resume of the finished fold: val loss {again['val_loss']:.6f}, c-index "
            f"{again['val_c_index']:.6f} (the first run's last evaluation: "
            f"{result['val_loss']:.6f}, {result['val_c_index']:.6f})")
        if not same:
            raise AssertionError("the resumed fold's evaluation differs from the first run's")

        # (d) serving from the checkpoint directory against the trained module
        pred = Predictor(HealNetModule(**BRCA, attention_impl="flash", device="cuda"),
                         params=ckpt_dir, batch_size=BATCH, device="cuda")
        served = pred([omic, wsi])["logits"]
        module.eval()
        with torch.no_grad():
            direct = module([torch.as_tensor(omic, device="cuda"),
                             torch.as_tensor(wsi, device="cuda")]).cpu().numpy()
        check("Predictor(params=<checkpoint dir>) logits vs the trained module",
              float(np.abs(served - direct).max()), 1e-6)

        # the idle share of one step, as phase 7 reckons it
        wall, busy, idle, _ = step_times(trainer, batch)
        log(f"  one fit step, inputs on the card: wall {wall:.4f} ms, device busy {busy:.4f} ms, "
            f"idle share {idle:.4f}")
        del trainer, resumed, pred, module

    # (e) the fused fold from an arena of the same patients
    phase_fused_fold(host_rng, train, val)
    log(f"  c-index implementation: {cindex_implementation()}")
    log(f"  phase 12 wall: {time.perf_counter() - t_phase:.2f} s")


# --------------------------------------------------------------- phase 13

# the synthetic TCGA tree of the CLI phase: the shapes of
# scripts/gen_dress_data.py (2,000 genes, ragged float16 bags of ResNet-50
# features 2,048 wide, ~30% censored, a survival signal planted in both
# modalities), cut to 48 cases and bags of 1,024-4,096 patches
CLI_CASES, CLI_GENES = 48, 2000
CLI_BAGS = (1024, TOKENS)
CLI_RUN = "chip_smoke_cli"
# phase 15's long bags: the README image modality's 224 x 224 tokens
LONG_BAG = 224 * 224


def write_tcga_tree(root: Path, host_rng, cases: int = CLI_CASES, long_bags: int = 0,
                    coords: bool = False) -> dict:
    """A TCGA-layout tree under ``root`` written with numpy, ``zipfile`` and
    ``csv`` only: ``omic/tcga_brca_all_clean.csv.zip``, a ``.h5`` a slide
    under ``patches/`` (empty, or with ``coords`` the slide's patch grid,
    256 pixels apart, through ``etl/h5.py::write_coords``) and its float16
    ``.npy`` bag under ``patch_features/``: ``cases`` bags of 1,024-4,096
    patches, the last ``long_bags`` of them ``LONG_BAG``. Returns the slide
    ids, bag sizes and bytes written."""
    prep = root / "wsi" / "brca_preprocessed_level2"
    for sub in (root / "omic", prep / "patches", prep / "patch_features"):
        sub.mkdir(parents=True)
    n = cases + long_bags
    sids = [f"TCGA-SM-{i:04d}-01Z-00-DX1" for i in range(n)]
    risk = host_rng.standard_normal(n).astype(np.float32)
    omic = host_rng.standard_normal((n, CLI_GENES), dtype=np.float32)
    omic[:, :25] += 0.8 * risk[:, None]  # 25 signal genes
    bags = np.clip(host_rng.lognormal(np.log(2560), 0.45, size=n), *CLI_BAGS).astype(int)
    bags[cases:] = LONG_BAG
    written = 0
    for sid, bag, r in zip(sids, bags, risk):
        if coords:
            side = int(np.ceil(np.sqrt(bag)))
            grid = np.arange(bag)
            write_coords(prep / "patches" / f"{sid}.h5",
                         np.stack([grid % side, grid // side], axis=1) * 256, 256, 2)
        else:
            (prep / "patches" / f"{sid}.h5").touch()
        feats = host_rng.standard_normal((int(bag), PATCH), dtype=np.float32)
        feats[:max(1, int(bag) // 20), :16] += 0.5 * r  # a few "tumour" patches
        feats = feats.astype(np.float16)
        np.save(prep / "patch_features" / f"{sid}.npy", feats)
        written += feats.nbytes
    months = np.exp(3.2 - 0.7 * risk + 0.35 * host_rng.standard_normal(n)).astype(np.float32)
    censorship = (host_rng.uniform(size=n) < 0.3).astype(np.int64)
    write_omic_csv(root, sids, omic, censorship, months)
    return {"sids": sids, "bags": bags, "bytes": written,
            "censored": float(censorship.mean())}


def write_omic_csv(root: Path, sids, omic, censorship, months) -> None:
    """``omic/tcga_brca_all_clean.csv.zip`` of a tree: a row a slide, the
    genes, then the metadata columns the loader reads."""
    buf = io.StringIO()
    out = csv.writer(buf, lineterminator="\n")
    out.writerow(["", *(f"gene_{i}" for i in range(omic.shape[1])), "site", "oncotree_code",
                  "case_id", "slide_id", "train", "censorship", "survival_months"])
    for i, sid in enumerate(sids):
        out.writerow([i, *(repr(float(v)) for v in omic[i]), "breast", "IDC", sid[:12],
                      f"{sid}.svs", 1, int(censorship[i]), repr(float(months[i]))])
    with zipfile.ZipFile(root / "omic" / "tcga_brca_all_clean.csv.zip", "w",
                         compression=zipfile.ZIP_DEFLATED) as archive:
        archive.writestr("tcga_brca_all_clean.csv", buf.getvalue())


def yaml_scalar(value) -> str:
    """A config value as YAML that the port's reader (and PyYAML) reads back
    as the same value: floats always with a dot, strings quoted."""
    if isinstance(value, bool):
        return "true" if value else "false"
    if value is None:
        return "null"
    if isinstance(value, int):
        return str(value)
    if isinstance(value, float):  # "1e-05" reads back as a string: "1.0e-05"
        mantissa, e, exponent = repr(value).partition("e")
        return (mantissa if "." in mantissa else mantissa + ".0") + e + exponent
    if isinstance(value, (list, tuple)):
        return "[" + ", ".join(yaml_scalar(v) for v in value) + "]"
    return json.dumps(str(value))


def yaml_dump(config, indent: int = 0) -> str:
    lines = []
    for key, value in config.items():
        if isinstance(value, dict):
            lines.append(" " * indent + f"{key}:")
            lines.append(yaml_dump(value, indent + 2))
        else:
            lines.append(" " * indent + f"{key}: {yaml_scalar(value)}")
    return "\n".join(lines)


def cli_config(root: Path) -> Path:
    """``config/dress_rehearsal.yml`` pointed at the tree, cut to 2 folds of
    2 epochs, buckets (2048, 4096) and bags of at most 4,096 patches; bf16,
    the int8 arena on the device, fused epochs, checkpoints and resume kept;
    the model the ``brca`` row of ``config/best_hyperparams.yml``."""
    config = Config(str(REPO / "config" / "dress_rehearsal.yml")).read().to_dict()
    config.update(tcga_path=str(root / "tcga"), log_path=str(root / "logs"), run_name=CLI_RUN,
                  hyperparams=str(REPO / "config" / "best_hyperparams.yml"), n_folds=2)
    config["data"]["max_patches"] = TOKENS
    config["train_loop"].update(epochs=2, bucket_boundaries=[TOKENS // 2, TOKENS])
    path = root / "dress_cut.yml"
    path.write_text(yaml_dump(config) + "\n")
    back = Config(str(path)).read()
    if back.to_dict() != config:
        raise AssertionError("the cut config does not read back as written")
    return path


def phase_cli(host_rng) -> None:
    """Phase 13: the pipeline and CLI at full width (see the module
    docstring)."""
    log("phase 13: python -m healnet_tpu_torch.cli.main on a synthetic TCGA tree "
        "(full-width brca, bf16, int8 arena, fused epochs, 2 folds x 2 epochs)")
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        t0 = time.perf_counter()
        tree = write_tcga_tree(root / "tcga", host_rng)
        bags = tree["bags"]
        log(f"  tree: {CLI_CASES} cases x {CLI_GENES} genes, bags of {bags.min()}-{bags.max()} "
            f"patches (mean {bags.mean():.0f}, {int(bags.sum())} rows) x {PATCH} float16, "
            f"{tree['bytes'] / 1e9:.3f} GB, censored {tree['censored']:.3f}; written in "
            f"{time.perf_counter() - t0:.2f} s")
        argv = ["--config_path", str(cli_config(root)), "--mode", "single_run",
                "--dataset", "brca"]
        summary_path = root / "logs" / CLI_RUN / "summary.json"

        # (a) in-process, through the function python -m runs
        seen = {}
        make_trainer = Pipeline.make_trainer

        def keep(pipeline, *a, **kw):
            seen["pipeline"] = pipeline
            seen["trainer"] = make_trainer(pipeline, *a, **kw)
            return seen["trainer"]

        Pipeline.make_trainer = keep
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()) as said:
                summary = cli_main(argv)
            wall = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated() / 2**20
            read_launches("the CLI run (warm-up and capture only; replays are not counted)",
                          ("fused_project", "fused_project_int8", "fused_project_bwd",
                           "fused_project_bwd_int8"))
        finally:
            Pipeline.make_trainer = make_trainer
        pipe, trainer = seen["pipeline"], seen["trainer"]
        first = json.loads(summary_path.read_text())
        log(f"  in-process run: {wall:.2f} s; dataset built in {pipe.timings['dataset_s']:.2f} s, "
            f"arena packed on the host in {pipe.timings['arena_pack_s']:.2f} s, uploaded and "
            f"quantized in {pipe.timings['arena_upload_s']:.4f} s "
            f"({type(trainer._arena).__name__}, {trainer._arena.shape[0]} rows); peak memory "
            f"{peak:.1f} MiB; folds' stdout: "
            f"{[ln for ln in said.getvalue().splitlines() if ln.startswith(('Train', 'Epoch'))]}")
        for fold, res in enumerate(pipe.fold_results, 1):
            walls = [round(h["seconds"], 4) for h in res["history"]]
            log(f"  fold {fold}: epoch 1 (warm-up and capture of each bucket's train and eval "
                f"step) {walls[0]} s, epoch 2 {walls[1:]} s; train loss "
                f"{[round(h['train_loss'], 6) for h in res['history']]}, val c-index "
                f"{res['val_c_index']:.6f}, test c-index {res['test_c_index']:.6f}")
        bad = {k: v for k, v in first.items()
               if k.startswith(("fold_", "mean_", "std_")) and "norm" not in k
               and not np.isfinite(v)}
        if bad or len(pipe.fold_results) != 2:
            raise AssertionError(f"the CLI run gave non-finite summary metrics {bad} or "
                                 f"{len(pipe.fold_results)} folds")
        log(f"  summary: mean test c-index {summary['mean_test_c_index']:.6f} "
            f"(std {summary['std_test_c_index']:.6f}), best fold {summary['best_fold'] + 1}")

        # the arena quantized on the card against the host's quantization of
        # the same bags (the JAX package's way), three slides
        data = pipe._dataset
        offsets, lengths = data._arena_index()
        for i in range(3):
            rows = slice(int(offsets[i]), int(offsets[i] + lengths[i]))
            q, scale = quantize_context_host(data.load_patch_features(data._row_sids[i])
                                             [:lengths[i]])
            if not (np.array_equal(trainer._arena.data[rows].cpu().numpy(), q) and
                    np.array_equal(trainer._arena.scale[rows].cpu().numpy(), scale)):
                raise AssertionError(f"slide {i}'s arena rows differ from host quantization")
        log("  the arena's int8 rows and scales of three slides equal the host's quantization "
            "of their bags, bit for bit")

        # a captured step of the last fold's trainer, replayed on its train
        # split's width-4096 batches (its weights are in the checkpoints)
        train_idx = train_val_test_split(len(data), seed=2)[0]
        blist = [b for b in data.take(train_idx).iter_batches(
                     BATCH, shuffle=True, rng=np.random.default_rng(0),
                     bucket_boundaries=trainer.bucket_boundaries)
                 if b["kv_masks"][-1].shape[1] == TOKENS]
        n = len(blist)

        def run():
            trainer._fused_train_bucket(blist)

        step_wall = wall_ms(run, reps=3) / n
        _, busy, count, _ = device_profile(run)
        log(f"  captured step at width {TOKENS} (bf16, int8 arena; {n} steps a call): wall "
            f"{step_wall:.4f} ms per step, device busy {busy / n:.4f} ms per step (profiler), "
            f"idle share {1.0 - busy / n / step_wall:.4f}, {count / n:.1f} device kernels and "
            f"copies and {HOST_LAUNCHES[0] / n:.2f} host launch calls per step")
        del trainer, pipe, seen, data, blist, q, scale
        _DATASET_CACHE.update(key=None, dataset=None, arena_device=None)

        # (b) a second process with the same run_name: both folds complete,
        # their checkpoints evaluated again
        env = {**os.environ, "PYTHONPATH": os.pathsep.join(
            [str(REPO), *filter(None, [os.environ.get("PYTHONPATH")])])}
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "healnet_tpu_torch.cli.main", *argv],
                              cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
        relaunch = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"the relaunch exited {proc.returncode}:\n{proc.stderr[-4000:]}")
        again = json.loads(summary_path.read_text())
        restored = proc.stdout.count("Fold already complete")
        tests = [(first[f"fold_{k}_test_c_index"], again[f"fold_{k}_test_c_index"])
                 for k in (1, 2)]
        log(f"  relaunch (python -m, same run_name): {relaunch:.2f} s wall, {restored} folds "
            f"restored complete; test c-index first / relaunch {tests}")
        if restored != 2 or any(a != b for a, b in tests):
            raise AssertionError("the relaunch did not restore both folds with the first run's "
                                 "test c-indices")
    log(f"  c-index implementation: {cindex_implementation()}")
    log(f"  phase 13 wall: {time.perf_counter() - t_phase:.2f} s")


# ---------------------------------------------------------------- phase 8


# how much slower than the bf16 brca call the int8 one may be: on one card
# in one run, repeated timings of one projection kernel spread by under 1%
INT8_MARGIN = 0.03


def int8_projection_case(gen, b, t, c, f, cdt):
    """An int8 context (per-token scales, one zero row) with the encoding,
    the kernel's operands in compute dtype ``cdt``, and both versions."""
    qc = quantize_context(torch.randn((b, t, c), generator=gen, device="cuda"))
    qc.scale[0, 0] = 0.0
    qc.data[0, 0] = 0
    enc = positional_encoding((t,), 2.0, 2, dtype=cdt, device="cuda")
    w_all = torch.randn((c + enc.shape[-1], f), generator=gen, device="cuda") * 0.02
    b_all = torch.randn((f,), generator=gen, device="cuda") * 0.1
    ops = _prep(qc.data, enc, w_all, b_all, cdt)
    run = lambda: fused_project_kernel(qc.data, *ops, w_all.shape[0], 1e-5, scale=qc.scale)
    plain = lambda: _project_plain(qc.data, enc, w_all, b_all, 1e-5, qc.scale, cdt)
    return qc, ops, run, plain


def check_quantize_on_card(gen) -> None:
    """``quantize_context`` on the card bit-equal to ``quantize_context_host``
    (the JAX package's host arithmetic): float16 rows of 2,048 channels at
    per-row scales spread 0.1-9 (``scripts/check_quantize_device.py``'s
    case) and a bf16 WSI context of brca's shape."""
    rng = np.random.default_rng(8)
    rows = (rng.standard_normal((40000, PATCH), dtype=np.float32)
            * rng.uniform(0.1, 9, (40000, 1))).astype(np.float16)
    bag = (torch.randn((BATCH, TOKENS, PATCH), generator=gen, device="cuda") * 3).to(
        torch.bfloat16)
    for label, x, host in (("(40000, 2048) float16", torch.as_tensor(rows, device="cuda"), rows),
                           ("(8, 4096, 2048) bfloat16", bag, bag.float().cpu().numpy())):
        got = quantize_context(x)
        q, scale = quantize_context_host(host)
        scales = int((got.scale.cpu().numpy() != scale).sum())
        values = int((got.data.cpu().numpy() != q).sum())
        log(f"  quantize_context on the card, {label}: {scales} of {scale.size} row scales and "
            f"{values} values differ from quantize_context_host")
        if scales or values:
            raise AssertionError(f"quantize_context on the card differs from the host at {label}")


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return ((a - b).abs().max() / b.abs().max().clamp(min=1e-30)).item()


def phase_projection_int8(gen, bf16_ms: float, f32_ms: float):
    """``bf16_ms``: phase 2's time of the bf16 brca call, which the int8 one
    must not exceed by more than ``INT8_MARGIN``; ``f32_ms``: its time of the
    f32 brca call, beside which the int8 call in f32 compute is timed.
    Returns the kernels-line entries of both int8 variants."""
    log("phase 8: int8 projection forward kernels vs plain version")
    check_quantize_on_card(gen)
    worst = 0.0
    for cdt, f in ((torch.bfloat16, 252), (torch.bfloat16, 270), (torch.float32, 252)):
        reset_launches()
        qc, ops, run, plain = int8_projection_case(gen, BATCH, TOKENS, PATCH, f, cdt)
        (kv, s1, s2), (ref, r1, r2) = run(), plain()
        torch.cuda.synchronize()
        variant = "fused_project_int8" if cdt == torch.bfloat16 else "fused_project_f32_int8"
        read_launches(f"the int8 -> {str(cdt)[6:]} F={f} call", (variant,))
        err = (kv.float() - ref.float()).abs().max().item()
        # bf16: as phase 2, 4 ulps of the largest output; f32: sums of 2048
        # products in another order than cuBLAS's, outputs of magnitude ~1-5
        tol = 4 * bf16_ulp(ref.float().abs().max().item()) if cdt == torch.bfloat16 else 1e-4
        check(f"int8 (8, 4096, 2048) -> {str(cdt)[6:]} F={f} kv", err, tol)
        if cdt == torch.bfloat16:
            worst = max(worst, err)
        else:
            err_f32 = err
        # s1: integer sums, exact in both, then the same f32 operations; s2:
        # the kernel's integer sum of q^2 is exact, the plain version's f32
        # sum of 2048 terms is not (pairwise: ~11 roundings of 2^-24)
        check(f"int8 {str(cdt)[6:]} F={f} s1 (relative)", rel_err(s1, r1), 1e-6)
        check(f"int8 {str(cdt)[6:]} F={f} s2 (relative)", rel_err(s2, r2), 2e-6)

    timings = {label: time_projection(gen, label) for label in ("brca int8", "kirp int8")}
    ratio = timings["brca int8"]["ms"] / bf16_ms
    log(f"  int8 against bf16 at brca: {ratio:.3f}x the time "
        f"({timings['brca int8']['ms']:.4f} ms against phase 2's {bf16_ms:.4f} ms)")
    if ratio > 1.0 + INT8_MARGIN:
        raise AssertionError(f"the int8 brca call is {ratio:.3f}x the bf16 one's time")
    f32 = time_projection(gen, "brca int8 -> f32", (BATCH, TOKENS, PATCH, 252, torch.int8),
                          torch.float32)
    log(f"  int8 -> f32 against f32 at brca: {f32['ms'] / f32_ms:.3f}x the time "
        f"({f32['ms']:.4f} ms against phase 2's {f32_ms:.4f} ms)")
    return (projection_entry("fused_project_int8",
                             "healnet_tpu_torch/ops/csrc/fused_project_tma.cu",
                             "healnet_tpu/ops/fused_project.py:171", worst, timings["brca int8"]),
            projection_entry("fused_project_f32_int8",
                             "healnet_tpu_torch/ops/csrc/fused_project_f32.cu",
                             "healnet_tpu/ops/fused_project.py:171", err_f32, f32))


# ---------------------------------------------------------------- phase 9


def phase_projection_bwd_int8(gen) -> dict:
    log("phase 9: scaled cotangent pass (int8 context, with bsum) vs plain version")
    cases = {"bf16 (8, 4096, 252)": (BATCH, TOKENS, PATCH, 252, torch.bfloat16),
             "f32 (2, 300, 70)": (2, 300, 200, 70, torch.float32)}
    for label, (b, t, c, f, dtype) in cases.items():
        qc, _, run, _ = int8_projection_case(gen, b, t, c, f, dtype)
        _, s1, s2 = run()  # the int8 forward kernel's saved row statistics
        d_total = c + 5
        g = torch.randn((b, t, f), generator=gen, device="cuda").to(dtype)
        run_k = lambda: fused_project_bwd_kernel(g, s1, s2, d_total, scale=qc.scale,
                                                 with_bsum=True)
        plain = lambda: project_bwd_plain(g, s1, s2, d_total, scale=qc.scale, with_bsum=True)
        reset_launches()
        got = run_k()
        read_launches(f"the {label} call", ("fused_project_bwd_int8",))
        err = check_bwd(label, got, plain(), g, s1, s2, d_total,
                        plain_terms=project_bwd_plain(g, s1, s2, d_total)[0],
                        show_refusals=dtype == torch.bfloat16)
        if dtype != torch.bfloat16:
            continue
        worst = err
        timing = time_bwd(f"{label} with scale and bsum", run_k, plain,
                          nbytes(g, s1, s2, qc.scale, *got), g.numel(), 5.0, dtype)
        # the d_W_c GEMM that follows the pass in the backward, q^T d_raw:
        # torch.mm takes no int8 operand, so the int8 context is cast to
        # bf16 first (a 134 MB copy), then the f32-output GEMM
        q2d, d2d = qc.data.reshape(-1, c), got[0].reshape(-1, f)
        t_cast, _ = time_ms(lambda: q2d.t().to(dtype))
        q_bf16 = q2d.t().to(dtype)
        t_gemm, _ = time_ms(lambda: _gemm_f32(q_bf16, d2d))
        g_bound, g_by = bound_ms(nbytes(q2d, d2d) + 4 * c * f, 2.0 * q2d.numel() * f, dtype)
        log(f"  d_W_c GEMM at ({c} x {q2d.shape[0]}) x ({q2d.shape[0]} x {f}): cast of the "
            f"int8 context to bf16 {t_cast:.4f} ms + GEMM {t_gemm:.4f} ms; bound of an "
            f"int8-operand GEMM {g_bound:.4f} ms ({g_by})")
        del q_bf16
    return dict(name="fused_project_bwd_int8", route="cuda",
                source="healnet_tpu_torch/ops/csrc/fused_project_bwd.cu",
                replaces="healnet_tpu/ops/fused_project.py:281", max_abs_err=worst, **timing,
                library_ms=None)


# --------------------------------------------------------------- phase 10

ARENA_BAGS = 48
ARENA_BUCKETS = [TOKENS // 4, TOKENS // 2, TOKENS]  # 1024, 2048, 4096


def build_arena(host_rng):
    """48 bags of 1024-4096 patch features packed back to back, then
    TOKENS zero rows (the arena layout of ``healnet_tpu/etl/tcga.py``), and
    arena-indexed survival data for them."""
    lengths = host_rng.integers(TOKENS // 4, TOKENS + 1, size=ARENA_BAGS).astype(np.int32)
    offsets = np.concatenate([[0], np.cumsum(lengths)[:-1]]).astype(np.int32)
    rows = int(lengths.sum())
    arena = np.zeros((rows + TOKENS, PATCH), np.float32)
    arena[:rows] = host_rng.standard_normal((rows, PATCH), dtype=np.float32)
    data = {
        "tensors": (host_rng.standard_normal((ARENA_BAGS, 1, OMIC), dtype=np.float32),),
        "kv_masks": (None, np.arange(TOKENS)[None, :] < lengths[:, None]),
        "patch_offsets": offsets, "patch_lengths": lengths,
        "y_disc": host_rng.integers(0, 4, size=ARENA_BAGS),
        "censorship": host_rng.integers(0, 2, size=ARENA_BAGS).astype(np.float32),
        "event_time": host_rng.uniform(1, 100, size=ARENA_BAGS).astype(np.float32),
    }
    return arena, data


def arena_trainer(dtype, projection_impl, state, **arena):
    module = HealNetModule(**BRCA, dtype=dtype, attention_impl="flash",
                           projection_impl=projection_impl, device="cuda",
                           generator=torch.Generator().manual_seed(0))
    module.load_state_dict(state)
    return SurvivalTrainer(module, l1=1e-6, max_lr=8e-3, gc_compat=16, seed=0, device="cuda",
                           arena_quant=True, **arena)


def weight_error(a, b) -> tuple:
    """(largest |a - b| over a parameter relative to its largest |b|, over
    the parameters; the parameter; whether every parameter is bit-equal)."""
    worst, where, same = 0.0, "", True
    for (name, x), y in zip(a.named_parameters(), b.parameters()):
        same = same and torch.equal(x, y)
        err = ((x - y).abs().max() / y.abs().max().clamp_min(1e-30)).item()
        if not err < worst:
            worst, where = err, name
    return worst, where, same


def fused_vs_stepwise(label, dtype, state, arena, dev, batches, tol) -> dict:
    """The arena steps of ``batches`` on two trainers from the same weights
    and seeds: stepwise (``train_step``, one host batch a step) and fused
    (the bucket in one upload, its seed table drawn in stepwise order, the
    step captured once and replayed, one read-back). Holds the losses and
    the weights after the steps to ``tol`` relative, says whether they are
    bit-identical, and times both ways over the same steps: wall per step,
    device busy, idle share, host launch calls and peak memory."""
    stepwise = arena_trainer(dtype, "auto", state, arena_device=dev)
    fused = arena_trainer(dtype, "auto", state, arena_device=dev, feature_arena=arena,
                          fused_epochs=True)
    assert fused.fused_epochs
    n = len(batches)
    stats = {}
    for name, trainer in (("stepwise", stepwise), ("captured", fused)):
        if name == "stepwise":
            run = lambda: torch.stack([stepwise.train_step(b, HORIZON)[0] for b in batches])
        else:
            fused._horizon.fill_(HORIZON)
            run = lambda: fused._fused_train_bucket(batches)[0]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses = run().float().cpu()
        torch.cuda.synchronize()
        stats[name] = dict(losses=losses, peak=torch.cuda.max_memory_allocated() / 2**20)
    loss_err = ((stats["captured"]["losses"] - stats["stepwise"]["losses"]).abs()
                / stats["stepwise"]["losses"].abs()).max().item()
    w_err, where, same_w = weight_error(fused.module, stepwise.module)
    same_l = torch.equal(stats["captured"]["losses"], stats["stepwise"]["losses"])
    log(f"  {label} arena steps, stepwise losses {stats['stepwise']['losses'].tolist()}, "
        f"captured {stats['captured']['losses'].tolist()}; bit-identical: losses {same_l}, "
        f"weights {same_w}")
    check(f"{label} captured against stepwise, {n} steps: losses (relative)", loss_err, tol)
    check(f"{label} captured against stepwise, weights after {n} steps (largest relative, "
          f"{where})", w_err, tol)
    tables = [t for key, t in fused._tables.items() if key[0] == "train"]
    if len(tables) != 1 or tables[0].graph is None:
        raise AssertionError(f"{label}: the fused steps left no captured graph")
    for name, trainer in (("stepwise", stepwise), ("captured", fused)):
        if name == "stepwise":
            run = lambda: [stepwise.train_step(b, HORIZON) for b in batches]
        else:
            run = lambda: fused._fused_train_bucket(batches)
        wall = wall_ms(run, reps=3) / n
        _, busy, count, _ = device_profile(run)
        log(f"  {label} {name} step, from host batches ({n} steps a call): wall {wall:.4f} ms per "
            f"step, device busy {busy / n:.4f} ms per step (profiler), idle share "
            f"{1.0 - busy / n / wall:.4f}, {count / n:.1f} device kernels and copies and "
            f"{HOST_LAUNCHES[0] / n:.2f} host launch calls per step; peak memory "
            f"{stats[name]['peak']:.1f} MiB")
        stats[name].update(wall=wall, busy=busy / n)
    return stats


def arena_predictor(attention_impl, projection_impl, state, arena):
    module = HealNetModule(**BRCA, dtype=torch.bfloat16, attention_impl=attention_impl,
                           projection_impl=projection_impl, device="cuda")
    return Predictor(module, state, batch_size=BATCH, bucket_boundaries=ARENA_BUCKETS,
                     device="cuda", feature_arena=arena)


def timed(fn, reps=3):
    """(result, median wall seconds) of ``reps`` synchronised calls."""
    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return out, statistics.median(walls)


def phase_arena(host_rng) -> dict:
    log("phase 10: the int8 feature-arena path at full width (training and serving)")
    t0 = time.perf_counter()
    arena, data = build_arena(host_rng)
    log(f"  arena {arena.shape} f32 on the host ({arena.nbytes / 1e9:.3f} GB, "
        f"{time.perf_counter() - t0:.2f} s to make)")
    state = HealNetModule(**BRCA, device="cuda",
                          generator=torch.Generator().manual_seed(0)).state_dict()
    kernel = arena_trainer(torch.bfloat16, "auto", state,
                           feature_arena=(arena, data["patch_offsets"], data["patch_lengths"]))
    t0 = time.perf_counter()
    dev = kernel._device_arena()
    torch.cuda.synchronize()
    log(f"  quantized on the host and uploaded once in {time.perf_counter() - t0:.2f} s: "
        f"int8 {tuple(dev.data.shape)} ({nbytes(dev.data) / 1e6:.1f} MB) + scales "
        f"({nbytes(dev.scale) / 1e6:.1f} MB) on the card")
    batches = list(iterate_batches(data, BATCH))

    # only the projection differs between the two paths (flash attention on
    # both). f32: the int8 kernels held alone, as tight as phase 7.
    k32 = arena_trainer(None, "auto", state, arena_device=dev)
    reset_launches()
    compare_gradients("arena f32", k32, arena_trainer(None, "xla", state, arena_device=dev),
                      batches[0], 1e-5, 1e-4)
    f32_launches = read_launches("the f32 arena step (kernel path)", ("fused_project_f32_int8",))
    # bf16: both paths are held against the f32 gradients (same weights and
    # dropout draws). The omic branch dominates the gradient norm and moves
    # 5-15% in bf16 on either path, so kernel against plain would compare
    # two bf16 errors with each other; instead the kernel path must be no
    # further from f32 than 1.5 times the plain path is.
    truth = gradients(k32.module)
    del k32
    plain16 = arena_trainer(torch.bfloat16, "xla", state, arena_device=dev)
    loss_k = kernel.train_step(batches[0], HORIZON)[0].item()
    loss_p = plain16.train_step(batches[0], HORIZON)[0].item()
    check(f"arena bf16 step-1 loss {loss_k:.6f} vs {loss_p:.6f} (relative)",
          abs(loss_k - loss_p) / abs(loss_p), 2e-2)
    err_p, at_p = worst_grad_error(gradients(plain16.module), truth)
    err_k, at_k = worst_grad_error(gradients(kernel.module), truth)
    log(f"  arena bf16 step-1 gradients against f32, worst relative L2 error: plain path "
        f"{err_p:.4g} ({at_p}), kernel path {err_k:.4g} ({at_k})")
    check("arena bf16 kernel path's gradient error against f32 (tolerance: 1.5x the plain "
          "path's)", err_k, 1.5 * err_p)
    del plain16, truth

    # captured against stepwise, in f32 and in bf16: the same 5 batches in
    # the same order, the same seed tables
    host_arena = (arena, data["patch_offsets"], data["patch_lengths"])
    fused_vs_stepwise("f32", None, state, host_arena, dev, batches[1:6], 1e-5)
    fused_vs_stepwise("bf16", torch.bfloat16, state, host_arena, dev, batches[1:6], 2e-2)
    del arena, host_arena

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    losses = [kernel.train_step(batch, HORIZON)[0] for batch in batches[1:6]]
    losses = [x.item() for x in losses]
    launches = read_launches("the arena training run (5 steps, kernel path)",
                             FLOAT_KERNELS + ("fused_project_int8", "fused_project_bwd_int8"))
    peak = torch.cuda.max_memory_allocated() / 2**20
    log(f"  losses of 5 arena steps: {losses}")
    if not all(np.isfinite(losses)):
        raise AssertionError("an arena training loss is not finite")
    step = lambda: kernel.train_step(batches[1], HORIZON)
    wall = wall_ms(step)
    _, busy, count, rows = device_profile(step)
    log(f"  arena train step, batch {BATCH}, bf16, gather width {TOKENS}, host batches (omic, "
        f"labels, offsets): wall {wall:.4f} ms per synchronous step, "
        f"{BATCH / wall * 1e3:.2f} samples/s; device busy {busy:.4f} ms per step (profiler), "
        f"idle share {1.0 - busy / wall:.4f}, {count:.0f} launches; peak memory {peak:.1f} MiB "
        "(the arena included)")
    top = sorted(rows, key=device_us, reverse=True)[:8]
    log("  its largest device items, ms per step (launches): " + "; ".join(
        f"{e.key.replace('void ', '').replace('(anonymous namespace)::', '')[:64]} "
        f"{device_us(e) / 3e3:.4f} ({e.count / 3:.0f})" for e in top))

    pred = arena_predictor("flash", "auto", state, dev)
    ref = arena_predictor("xla", "xla", state, dev)
    warm = pred.warmup([(1, OMIC), (TOKENS, PATCH)])
    ref.warmup([(1, OMIC), (TOKENS, PATCH)], arena=True)
    log(f"  warmup: {warm['programs']} shapes in {warm['seconds']:.3f} s")
    omic = data["tensors"][0]
    offsets, lengths = data["patch_offsets"], data["patch_lengths"]
    reset_launches()
    got = pred.predict_from_arena([omic], offsets, lengths)
    read_launches("the arena serving run", ("fused_project", "fused_project_int8",
                                            "flash_attention"))
    assert got["logits"].shape == (ARENA_BAGS, 4) and got["risk"].shape == (ARENA_BAGS,)
    compare("arena serving", got, ref.predict_from_arena([omic], offsets, lengths), 0.1)
    q, scale = dev.data.cpu().numpy(), dev.scale.cpu().numpy()
    bags = [q[o:o + n].astype(np.float32) * scale[o:o + n, None] for o, n in zip(offsets, lengths)]
    del q
    # the dequantized bags, cast to bf16 by the model, against the int8 path
    # (the scale applied on the accumulator): bf16-level differences
    ragged = pred.predict_ragged([omic, bags])
    compare("arena serving", got, ragged, 0.1, against="predict_ragged on the dequantized bags")
    _, s_arena = timed(lambda: pred.predict_from_arena([omic], offsets, lengths))
    _, s_host = timed(lambda: pred.predict_ragged([omic, bags]))
    micro = sum(-(-sum(pred._bucket_width(int(n)) == w for n in lengths) // BATCH)
                for w in ARENA_BUCKETS)
    log(f"  {ARENA_BAGS} requests in {micro} micro-batches: from the arena {s_arena * 1e3:.2f} "
        f"ms wall ({s_arena * 1e3 / micro:.2f} ms per micro-batch, "
        f"{s_arena * 1e3 / ARENA_BAGS:.2f} ms per request); from host arrays "
        f"(predict_ragged, f32 bags uploaded) {s_host * 1e3:.2f} ms "
        f"({s_host * 1e3 / micro:.2f} ms per micro-batch, {s_host * 1e3 / ARENA_BAGS:.2f} ms "
        "per request); median of 3")
    return {**f32_launches,
            **{name: launches[name] for name in ("fused_project_int8", "fused_project_bwd_int8")}}


# --------------------------------------------------------------- phase 11


def chain_bound(spec, b, itemsize):
    """(bound ms, what bounds it, MB, GFLOP) of one fused-chain call of
    ``spec`` at batch ``b`` with latents and merged KV of ``itemsize`` bytes:
    each input read once and the output written once (the merged KV whole,
    masks and FF keep multipliers where the call has them, the stacked f32
    weights, presence and int64 seeds); the latent-side products in f32, the
    scores and the value product at the KV dtype's rate."""
    lc, ld, inner, f = spec.l_c, spec.l_d, spec.inner, spec.mult * spec.l_d
    width = max(spec.offsets) + 2 * inner  # the merged KV's columns
    per_site = 6 * ld + 2 * ld * inner + 2 * f * (ld + 1) + f * ld
    moved = (2 * b * lc * ld * itemsize
             + sum(b * t * width * itemsize for t in spec.tokens)
             + sum(b * t * 4 for t, m in zip(spec.tokens, spec.has_mask) if m)
             + (b * spec.sites * lc * ld * 4 if spec.ff_dropout > 0 else 0)
             + 4 * spec.sites * per_site + 4 * b * spec.n_modalities + 8 * spec.sites)
    f32_ops = b * spec.sites * 2 * lc * (2 * ld * inner + 3 * f * ld)
    kv_ops = b * spec.depth * sum(4 * lc * t * inner for t in spec.tokens)
    kv_peak = PEAK_FLOPS[torch.bfloat16 if itemsize == 2 else torch.float32]
    t_bytes = moved / PEAK_BYTES
    t_ops = f32_ops / PEAK_FLOPS[torch.float32] + kv_ops / kv_peak
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations",
            moved / 1e6, (f32_ops + kv_ops) / 1e9)


def row_inputs(gen, row, dtype):
    shapes = [(BATCH, 1, OMIC), (BATCH, TOKENS, PATCH)]
    shapes += [(BATCH, *EXTRA)] if row == "trimodal" else []
    return [torch.randn(sh, generator=gen, device="cuda").to(dtype) for sh in shapes]


def chain_extras(gen, module):
    """The chain's data-side operands for a row: a ragged WSI mask with one
    fully masked row, presence with zeros, FF keep multipliers at the row's
    rate and one attention seed per (layer, modality), all on the card."""
    b, n, sites = BATCH, module.n_modalities, module.depth * module.n_modalities
    lengths = torch.randint(1, TOKENS + 1, (b,), generator=gen, device="cuda")
    lengths[2] = 0
    masks = [None, torch.arange(TOKENS, device="cuda")[None, :] < lengths[:, None]]
    masks += [None] * (n - 2)
    presence = torch.ones((b, n), device="cuda")
    presence[1, 0] = presence[5, n - 1] = 0.0
    rate = module.ff_dropout
    keep = (torch.rand((b, sites, module.l_c, module.l_d), generator=gen, device="cuda")
            >= rate) / (1.0 - rate)
    seeds = torch.randint(0, 2**32, (module.depth, n), generator=gen, device="cuda",
                          dtype=torch.int64)
    return masks, presence, keep, seeds


def chain_case(module, x, extras, training):
    """(operands, spec) of the chain on the served model: the merged KV from
    ``project_contexts`` (the projection kernel) and the stacked weights;
    with ``training`` the row's dropout rates and the FF keep multipliers."""
    masks, presence, keep, seeds = extras
    with torch.no_grad():
        kvs, cdt = module.project_contexts(x)
        weights = stack_chain_weights(module)
        x0 = module.latents.to(cdt).expand(x[0].shape[0], module.l_c, module.l_d)
    spec = chain_spec(module, [kv.shape[1] for kv in kvs], [m is not None for m in masks],
                      training=training)
    return (x0, kvs, masks, keep if training else None, presence, seeds, weights), spec


def module_loop_profile(module, x, ops, out):
    """(device ms, launches) per call of the module path's latent loop at
    the chain's inputs: the forward on the cached merged KV, less the head
    alone."""
    masks, presence = ops[2], ops[4]
    module.project_contexts = lambda tensors: (ops[1], ops[0].dtype)
    try:
        with torch.inference_mode():
            _, busy, count, _ = device_profile(
                lambda: module(x, presence=presence, kv_masks=masks))
            _, h_busy, h_count, _ = device_profile(
                lambda: module.final_head(module.final_norm(out.mean(dim=1))))
    finally:
        del module.project_contexts
    return busy - h_busy, count - h_count


CHAIN_BATCHES = (1, 40, 132)


def batch_of(t, b):
    """``t`` with its batch (first) axis cycled to ``b`` rows."""
    return t[torch.arange(b, device=t.device) % t.shape[0]]


def chain_serving(row, module, x, extras, b):
    """The chain at serving (bf16, dropout off, inputs on the card) at batch
    ``b``, its inputs, masks and presence those of batch 8 cycled to ``b``
    patients: its plan, held against the plain version, and its time beside
    the plain version's and the module path's latent loop's (logged).
    Returns (kernel ms, plain ms, loop ms, loop launches, bound ms, bound_by)."""
    masks, presence, keep, seeds = extras
    xb = [batch_of(t, b) for t in x]
    eb = ([None if mk is None else batch_of(mk, b) for mk in masks], batch_of(presence, b),
          batch_of(keep, b), seeds)
    ops, spec = chain_case(module, xb, eb, training=False)
    cluster, kpb, chunk = chain_launch_plan(spec, b, ops[0].dtype, ops[0].device)
    with torch.no_grad():
        run = lambda: fused_latent_chain(*ops, spec)
        out, ref = run(), chain_reference(*ops, spec)
        top = ref.float().abs().max().item()
        check(f"{row} batch {b} bf16 chain kernel vs plain, dropout off",
              (out.float() - ref.float()).abs().max().item(), 4 * bf16_ulp(top))
        (t_kernel, w_kernel), (t_plain, w_plain) = time_ms(run), time_ms(
            lambda: chain_reference(*ops, spec))
    _, _, _, events = device_profile(run)
    chain_events = [e for e in events if "chain_fwd" in e.key]
    t_prof = (sum(device_us(e) for e in chain_events) / 1e3
              / max(1, sum(e.count for e in chain_events)))
    t_loop, n_loop = module_loop_profile(module, xb, ops, out)
    bound, by, mb, gflop = chain_bound(spec, b, 2)
    log(f"  {row} batch {b} (plan: clusters of {cluster}, keys per block {kpb}, score chunk "
        f"{chunk}; depth {spec.depth}, {spec.n_modalities} modalities, l_d {spec.l_d}, "
        f"inner {spec.inner}, KV widths {[kv.shape[-1] for kv in ops[1]]}) bf16, dropout "
        f"off: kernel {t_kernel:.4f} ms (1 launch; {t_prof:.4f} ms a launch on the "
        f"profiler), plain {t_plain:.4f} ms, the module path's latent loop {t_loop:.4f} ms "
        f"device time in {n_loop:.0f} launches (profiler); bound {bound:.5f} ms ({by}; "
        f"{mb:.2f} MB, {gflop:.3f} GFLOP); wall per call: kernel {w_kernel:.4f} ms, plain "
        f"{w_plain:.4f} ms")
    return t_kernel, t_plain, t_loop, n_loop, bound, by


def phase_chain(gen):
    """Returns (the kernels-line entry, the chain run's launches)."""
    log("phase 11: the fused latent chain at the brca, kirp and trimodal rows")
    cases = {}
    for row in ROWS:
        module = row_model(row, torch.bfloat16).eval()
        x = row_inputs(gen, row, torch.bfloat16)
        extras = chain_extras(gen, module)
        cases[row] = (module, x, extras, *chain_case(module, x, extras, training=True))
    # the main path's run: the chain's entry point once per row, in bf16
    # with the row's dropout rates, FF keep multipliers, masks and presence
    torch.cuda.synchronize()
    reset_launches()
    with torch.no_grad():
        outs = {row: fused_latent_chain(*c[3], c[4]) for row, c in cases.items()}
    launches = read_launches("the chain run (brca, kirp, trimodal; bf16, dropout on)",
                             ("fused_chain",))
    if launches["fused_chain"] != len(cases):
        raise AssertionError(f"the chain run took {launches['fused_chain']} launches for "
                             f"{len(cases)} calls, not one a call")

    worst, entry = 0.0, None
    for row, (module, x, extras, ops, spec) in cases.items():
        cluster, kpb, chunk = chain_launch_plan(spec, BATCH, ops[0].dtype, ops[0].device)
        log(f"  {row} plan: clusters of {cluster} blocks, keys per block {kpb}, score chunk "
            f"{chunk}")
        with torch.no_grad():
            out, ref = outs[row], chain_reference(*ops, spec)
            again = fused_latent_chain(*ops, spec)
        torch.cuda.synchronize()
        if not torch.isfinite(out).all() or out.shape != ref.shape:
            raise AssertionError(f"{row}: the chain's output is not finite or misshapen")
        if not torch.equal(out, again):
            raise AssertionError(f"{row}: two bf16 chain calls differ")
        # bf16: q and the dropped probabilities round to bf16 at the same
        # places in both, sums run in another order, the output rounds once:
        # 4 bf16 ulps of the largest output
        top = ref.float().abs().max().item()
        err = (out.float() - ref.float()).abs().max().item()
        check(f"{row} bf16 chain kernel vs plain ({err / bf16_ulp(top):.2f} bf16 ulps of the "
              f"largest output, {top:.4g})", err, 4 * bf16_ulp(top))
        worst = max(worst, err)

        # f32: the same weights and (bf16-valued) inputs
        m32 = row_model(row, None).eval()
        m32.load_state_dict(module.state_dict())
        x32 = [t.float() for t in x]
        ops32, spec32 = chain_case(m32, x32, extras, training=True)
        with torch.no_grad():
            got32, ref32 = fused_latent_chain(*ops32, spec32), chain_reference(*ops32, spec32)
            if not torch.equal(got32, fused_latent_chain(*ops32, spec32)):
                raise AssertionError(f"{row}: two f32 chain calls differ")
        top32 = ref32.abs().max().item()
        # sums of the same products in another order
        check(f"{row} f32 chain kernel vs plain", (got32 - ref32).abs().max().item(),
              2e-5 * max(1.0, top32))
        # the chain path against the module path, f32, dropout off: logits
        ops_e, spec_e = chain_case(m32, x32, extras, training=False)
        with torch.no_grad():
            emb = fused_latent_chain(*ops_e, spec_e)
            logits = m32.final_head(m32.final_norm(emb.mean(dim=1)))
            want = m32(x32, presence=ops_e[4], kv_masks=ops_e[2])
        # the module path's LayerNorm clamps the variance and its softmax
        # fills masked scores, the chain's does neither: f32 rounding apart
        check(f"{row} f32 chain logits vs module(x) logits", (logits - want).abs().max().item(),
              1e-4)
        del m32, ops32, ops_e, got32, ref32

        # times at serving (bf16, dropout off), inputs on the card
        t_kernel, t_plain, t_loop, n_loop, bound, by = chain_serving(row, module, x, extras,
                                                                     BATCH)
        if row == "brca":
            entry = dict(name="fused_chain", route="cuda",
                         source="healnet_tpu_torch/ops/csrc/fused_chain.cu",
                         replaces="healnet_tpu/ops/fused_chain.py:288", ms=t_kernel,
                         plain_ms=t_plain, bound_ms=bound, bound_by=by, library_ms=None)
            log("  library: none (no single PyTorch call computes the chain); the module "
                f"path's latent loop at brca: {t_loop:.4f} ms, {n_loop:.0f} launches")
    # the other plans that the batch gives at brca's widths (batch 8 takes
    # clusters of 16): 1 patient (16), 40 (4; 1024-key ranges, scored in
    # two chunks) and 132 (1; the whole bag a block)
    module, x, extras = cases["brca"][:3]
    for b in CHAIN_BATCHES:
        chain_serving("brca", module, x, extras, b)
    entry["max_abs_err"] = worst
    return entry, launches


# --------------------------------------------------------------- phase 14

# the bucket widths of the exported ragged programs
EXPORT_WIDTHS = (1024, 2048, 4096)
# the fresh serving process of phase 14: it imports nothing but the
# artifact's loader, serves the ragged request from each artifact named on
# its command line and prints each one's launch counters
FRESH_SERVER = """
import json, sys
import numpy as np
import healnet_tpu_torch.serving_export as se
with np.load(sys.argv[1]) as z:
    omic = z["omic"]
    bags = [z[f"bag{i}"] for i in range(len(z.files) - 1)]
project, flash = se.fused_project.fused_project_kernel, se.flash_attention.flash_attention_kernel
for art in sys.argv[2:]:
    for fn in (project, flash):
        for name in [a for a in vars(fn) if a.startswith("launches")]:
            setattr(fn, name, 0)
    np.savez(art + "/fresh.npz", **se.ExportedPredictor(art).predict_ragged([omic, bags]))
    print(json.dumps({"artifact": art, "project": {k: v for k, v in vars(project).items()
                                                    if k.startswith("launches")},
                      "flash": {k: v for k, v in vars(flash).items()
                                if k.startswith("launches")}}))
print(json.dumps({"imported": sorted(m for m in sys.modules
                                     if m.split(".")[0] in ("jax", "flax", "healnet_tpu"))}))
"""


def port_ops(program) -> dict:
    """The registered ops a loaded program's graph calls, with counts."""
    ops = {}
    for node in program.graph.nodes:
        if node.op == "call_function" and "healnet_port" in str(node.target):
            ops[str(node.target)] = ops.get(str(node.target), 0) + 1
    return ops


def counter_sum(fn) -> int:
    return sum(v for k, v in vars(fn).items() if k.startswith("launches"))


def export_requests(host_rng):
    """Phase 14's requests: 20 dense samples (as they are, without the omic
    modality, and with a KV mask on the slide) and 24 ragged bags of
    500-4096 patches; and the micro-batches each takes."""
    n = 20
    omic = host_rng.standard_normal((n, 1, OMIC), dtype=np.float32)
    wsi = host_rng.standard_normal((n, TOKENS, PATCH), dtype=np.float32)
    mask = np.arange(TOKENS)[None, :] < host_rng.integers(1, TOKENS + 1, n)[:, None]
    lengths = host_rng.integers(500, TOKENS + 1, 24)
    bags = [host_rng.standard_normal((int(ln), PATCH), dtype=np.float32) for ln in lengths]
    omic24 = host_rng.standard_normal((len(bags), 1, OMIC), dtype=np.float32)
    requests = {
        "dense 20": lambda p: p([omic, wsi]),
        "omic missing": lambda p: p([None, wsi]),
        "slide masked": lambda p: p([omic, wsi], kv_masks=[None, mask]),
        "ragged 24": lambda p: p.predict_ragged([omic24, bags]),
    }
    per_width = [sum(int(w == min(x for x in EXPORT_WIDTHS if x >= ln)) for ln in lengths)
                 for w in EXPORT_WIDTHS]
    calls = {name: -(-n // BATCH) for name in requests}
    calls["ragged 24"] = sum(-(-c // BATCH) for c in per_width)
    return requests, calls, (omic, wsi), (omic24, bags)


def dispatch_trace(fn) -> list:
    """Every ATen op ``fn`` runs, in order, with clones of its tensor
    outputs: (name, outputs)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    ops = []

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            flat = out if isinstance(out, (tuple, list)) else (out,)
            ops.append((str(func), [t.clone() for t in flat if isinstance(t, torch.Tensor)]))
            return out

    with Record():
        fn()
    return ops


def first_divergence(live, served, omic, wsi) -> str:
    """Where the exported dense program's ATen ops leave the live module's
    on one micro-batch (all-True KV masks on both sides, as the program
    takes them): the first op whose name or outputs differ."""
    x = tuple(torch.as_tensor(a, device="cuda") for a in (omic, wsi))
    pres = torch.ones((x[0].shape[0], 2), device="cuda")
    masks = tuple(torch.ones(t.shape[:2], dtype=torch.bool, device="cuda") for t in x)
    a = dispatch_trace(lambda: live._predict(x, pres, masks))
    b = dispatch_trace(lambda: served._fn("predict")(x, pres, masks))
    for i, ((name_a, out_a), (name_b, out_b)) in enumerate(zip(a, b)):
        if name_a != name_b:
            return f"op {i}: live {name_a}, exported {name_b}"
        for ta, tb in zip(out_a, out_b):
            if ta.shape == tb.shape and ta.dtype == tb.dtype and not torch.equal(ta, tb):
                err = (ta.double() - tb.double()).abs().max().item()
                return f"op {i} {name_a}: max|d| {err:.6g}"
    return f"none in {min(len(a), len(b))} ops (live {len(a)}, exported {len(b)})"


def host_us_per_call(fn, calls: int = 40) -> float:
    """Host microseconds to enqueue one call, the device kept busy behind a
    sleep kernel so no launch waits."""
    torch.cuda.synchronize()
    torch.cuda._sleep(int(2e9 * 0.05))
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return host


def op_dispatch_cost(gen) -> None:
    """What the registered ops add on the host: a call through the op
    against the same call of its CUDA implementation, at brca's bag
    (projection, bf16) and cross-attention (flash, bf16), alternated."""
    x = torch.randn((BATCH, TOKENS, PATCH), generator=gen, device="cuda").to(torch.bfloat16)
    enc = positional_encoding((TOKENS,), 2.0, 2, dtype=torch.bfloat16, device="cuda")
    w_all = torch.randn((PATCH + 5, 252), generator=gen, device="cuda") * 0.02
    b_all = torch.zeros((252,), device="cuda")
    proj = (x, enc, w_all, b_all, 1e-5, None, torch.bfloat16)
    q, k, v = attention_inputs(gen, BATCH, 17, TOKENS, 63, torch.bfloat16, width=252)
    flash = (q, k, v, None, 63**-0.5 / 0.5, 0.0, None)
    pairs = {"projection": (lambda: project_op(*proj), lambda: _project_op_cuda(*proj)),
             "flash forward": (lambda: flash_fwd_op(*flash),
                               lambda: flash_attention_kernel(*flash[:6]))}
    for name, (op, bare) in pairs.items():
        times = {"op": [], "bare": []}
        for _ in range(3):
            times["op"].append(host_us_per_call(op))
            times["bare"].append(host_us_per_call(bare))
        op_us, bare_us = statistics.median(times["op"]), statistics.median(times["bare"])
        log(f"  {name}: host {op_us:.1f} us a call through the registered op, {bare_us:.1f} us "
            f"through its CUDA implementation alone: the op adds {op_us - bare_us:.1f} us")


def phase_export(host_rng) -> None:
    """The deployment artifact at brca's full width and depth: export from
    a live Predictor in bf16 and f32 under attention_impl "auto" (plain
    attention) and "flash", load, serve, and hold against the live path."""
    log("phase 14: the serving artifact (Predictor.export, ExportedPredictor) at full width")
    t_phase = time.perf_counter()
    requests, calls, (omic, wsi), (omic24, bags) = export_requests(host_rng)
    tmp = Path(tempfile.mkdtemp(prefix="healnet_export_"))
    np.savez(tmp / "ragged.npz", omic=omic24, **{f"bag{i}": b for i, b in enumerate(bags)})
    ragged_outs = {}
    try:
        for dtype in (torch.bfloat16, None):
            state = None
            for attention in ("auto", "flash"):
                label = f"{'bf16' if dtype else 'f32'} {attention}"
                live = predictor(dtype, attention, "auto", state)
                state = live.module.state_dict()
                live.warmup([(1, OMIC), (TOKENS, PATCH)], widths=EXPORT_WIDTHS)
                art = tmp / label.replace(" ", "_")
                live.export(art, example_shapes=[(1, OMIC), (TOKENS, PATCH)],
                            widths=EXPORT_WIDTHS)
                manifest = json.loads((art / "manifest.json").read_text())
                size = sum(f.stat().st_size for f in art.rglob("*") if f.is_file())
                log(f"  {label}: exported {len(manifest['export_seconds'])} programs in "
                    + ", ".join(f"{k.split('/')[-1]} {v:.2f} s"
                                for k, v in manifest["export_seconds"].items())
                    + f"; the artifact {size} bytes ("
                    + ", ".join(f"{f.name} {f.stat().st_size}" for f in sorted(art.iterdir()))
                    + ")")
                served = ExportedPredictor(art)
                warm = served.warmup()
                log(f"  {label}: loaded and warmed {warm['programs']} programs in "
                    f"{warm['seconds']:.2f} s")
                depth_mods = BRCA["depth"] * BRCA["n_modalities"]
                want_ops = {"healnet_port.fused_kv_project.default": BRCA["n_modalities"]}
                if attention == "flash":
                    want_ops["healnet_port.flash_attention_fwd.default"] = depth_mods
                for name in ["predict"] + [f"predict_w{w}" for w in EXPORT_WIDTHS]:
                    got_ops = port_ops(torch.export.load(art / f"{name}.pt2"))
                    if got_ops != want_ops:
                        raise AssertionError(f"{label} {name}: the graph calls {got_ops}, "
                                             f"expected {want_ops}")
                log(f"  {label}: every program's graph calls {want_ops}")

                walls = {"live": {}, "exported": {}}
                for name, call in requests.items():
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    want = call(live)
                    walls["live"][name] = time.perf_counter() - t0
                    reset_launches()
                    t0 = time.perf_counter()
                    got = call(served)
                    walls["exported"][name] = time.perf_counter() - t0
                    project, flash = (counter_sum(fused_project_kernel),
                                      counter_sum(flash_attention_kernel))
                    n_flash = depth_mods * calls[name] if attention == "flash" else 0
                    if project != BRCA["n_modalities"] * calls[name] or flash != n_flash:
                        raise AssertionError(
                            f"{label} {name}: {project} projection and {flash} flash launches "
                            f"over {calls[name]} program calls, expected "
                            f"{BRCA['n_modalities'] * calls[name]} and {n_flash}")
                    if (counter_sum(fused_project_bwd_kernel)
                            or counter_sum(flash_attention_bwd_kernel)):
                        raise AssertionError(f"{label} {name}: a backward kernel ran")
                    for key in ("logits", "hazards", "survival", "risk"):
                        if not np.isfinite(got[key]).all():
                            raise AssertionError(f"{label} {name}: non-finite {key}")
                    same = all(np.array_equal(got[k], want[k]) for k in got)
                    log(f"  {label} {name}: {calls[name]} program calls, {project} projection "
                        f"and {flash} flash launches; exported equal to live bit for bit: "
                        f"{same}")
                    if not same:
                        err = float(np.abs(got["logits"] - want["logits"]).max())
                        top = float(np.abs(want["logits"]).max())
                        log(f"  {label} {name}: the graph leaves the live ops at "
                            + first_divergence(live, served, omic[:BATCH], wsi[:BATCH]))
                        check(f"{label} {name} logits exported vs live", err,
                              2 * bf16_ulp(top) if dtype else 1e-5 * top)
                    if name == "ragged 24":
                        ragged_outs[str(art)] = got
                log(f"  {label}: wall per micro-batch, live / exported: " + "; ".join(
                    f"{name} {walls['live'][name] * 1e3 / calls[name]:.2f} / "
                    f"{walls['exported'][name] * 1e3 / calls[name]:.2f} ms"
                    for name in requests))
                for side, p in (("live", live), ("exported", served)):
                    wall, busy, count, _ = device_profile(lambda: p([omic[:BATCH], wsi[:BATCH]]))
                    log(f"  {label} {side}: one micro-batch of 8 from host arrays, wall "
                        f"{wall:.4f} ms, device busy {busy:.4f} ms (profiler), idle share "
                        f"{1.0 - busy / wall:.4f}, {count:.1f} device kernels and copies")
                del live, served
                torch.cuda.empty_cache()

        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", FRESH_SERVER, str(tmp / "ragged.npz"),
                               *ragged_outs], capture_output=True, text=True, cwd=REPO,
                              timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"the fresh serving process failed:\n{proc.stderr[-4000:]}")
        lines = [json.loads(line) for line in proc.stdout.splitlines() if line.startswith("{")]
        for line in lines[:-1]:
            art = line["artifact"]
            with np.load(Path(art) / "fresh.npz") as z:
                same = all(np.array_equal(z[k], ragged_outs[art][k]) for k in z.files)
            project, flash = sum(line["project"].values()), sum(line["flash"].values())
            log(f"  fresh process, {Path(art).name}: outputs equal to this process's bit for "
                f"bit: {same}; projection launches {project}, flash {flash}")
            if not same or project <= 0 or (art.endswith("flash") and flash <= 0):
                raise AssertionError(f"the fresh process served {art} differently")
        if lines[-1]["imported"]:
            raise AssertionError(f"the fresh process imported {lines[-1]['imported']}")
        log(f"  fresh process: {len(lines) - 1} artifacts in {time.perf_counter() - t0:.2f} s, "
            "importing only healnet_tpu_torch.serving_export (no JAX)")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    op_dispatch_cost(torch.Generator(device="cuda").manual_seed(14))
    log(f"  phase 14 wall: {time.perf_counter() - t_phase:.2f} s")


# --------------------------------------------------------------- phase 15

EXPL_CASES, EXPL_LONG = 24, 2
EXPL_RUN = "chip_smoke_explainer"
# the explainer's tolerances, as tests/test_torch_port_explainer.py holds
# the port against JAX on the CPU: arrays within 1e-5, ranking order where
# neighbouring scores differ by more than 1e-6
EXPL_ATOL, EXPL_GAP = 1e-5, 1e-6
EXPL_NPY = ("omic_attention", "attention", "heatmap", "mask")
PROJECTION_FWD = ("fused_project", "fused_project_int8", "fused_project_generic",
                  "fused_project_generic_split", "fused_project_f32", "fused_project_f32_int8")
PROJECTION_BWD = ("fused_project_bwd", "fused_project_bwd_int8")


def explainer_config(root: Path) -> dict:
    """``config/dress_rehearsal.yml`` with the ``brca`` row of
    ``config/best_hyperparams.yml``, pointed at the tree: one fold of one
    epoch, ``explainer: true``, ``omic_attention: false``, bags as scanned
    (up to ``LONG_BAG``) in buckets 2048 / 4096 / ``LONG_BAG``."""
    config = Config(str(REPO / "config" / "dress_rehearsal.yml")).read().to_dict()
    config["model_params"] = Config(
        str(REPO / "config" / "best_hyperparams.yml")).read().to_dict()["brca"]
    config.update(tcga_path=str(root / "tcga"), log_path=str(root / "logs"),
                  run_name=EXPL_RUN, n_folds=1, explainer=True, omic_attention=False)
    config["data"]["max_patches"] = None
    config["train_loop"].update(epochs=1, bucket_boundaries=[TOKENS // 2, TOKENS, LONG_BAG],
                                checkpoint=False, resume=False)
    return config


def read_launch_groups(run: str, groups) -> None:
    """Each group of kernel variants' launches since :func:`reset_launches`;
    fails if a group's total is 0."""
    for label, names in groups:
        counts = {name: getattr(*KERNELS[name]) for name in names}
        log(f"  {label} launches in {run}: {counts}")
        if sum(counts.values()) <= 0:
            raise AssertionError(f"{run} launched no {label} kernel")


def rankings_agree(label: str, a, b) -> None:
    """Two omic rankings: the same length, attention within ``EXPL_ATOL``,
    the same features in every run of scores within ``EXPL_GAP``."""
    fa, fb = list(a["feature"]), list(b["feature"])
    sa = np.asarray(a["attention"], np.float64)
    err = float(np.abs(sa - np.asarray(b["attention"], np.float64)).max())
    check(f"{label}: omic ranking attention", err, EXPL_ATOL)
    start = 0
    for i in range(1, len(sa) + 1):
        if i == len(sa) or sa[i - 1] - sa[i] > EXPL_GAP:
            if len(fa) != len(fb) or set(fa[start:i]) != set(fb[start:i]):
                raise AssertionError(f"{label}: ranking order differs at {start}-{i}: "
                                     f"{fa[start:i]} against {fb[start:i]}")
            start = i


def timed_explanation(ex, idx, sid, name, streaming):
    """One ``run_sample_explanation``: (result, wall s, peak MiB, the
    captures it called)."""
    calls = {"dense": 0, "streaming": 0}
    dense, stats = ex.model.get_attention_weights, ex.model.get_attention_stats

    def counted(kind, fn):
        def call():
            calls[kind] += 1
            return fn()
        return call

    ex.model.get_attention_weights = counted("dense", dense)
    ex.model.get_attention_stats = counted("streaming", stats)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()) as said:
            result = ex.run_sample_explanation(idx, sid, save_name=name, streaming=streaming)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        ex.model.get_attention_weights, ex.model.get_attention_stats = dense, stats
    return result, wall, torch.cuda.max_memory_allocated() / 2**20, calls, said.getvalue()


def phase_explainer(host_rng) -> None:
    """Phase 15: the explainer at full width (see the module docstring)."""
    log("phase 15: Pipeline(explainer: true) and Explainer on the card (full-width brca, "
        f"omic_attention false, {EXPL_CASES} bags of 1,024-4,096 patches and {EXPL_LONG} of "
        f"{LONG_BAG})")
    t_phase = time.perf_counter()
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        t0 = time.perf_counter()
        tree = write_tcga_tree(root / "tcga", host_rng, cases=EXPL_CASES, long_bags=EXPL_LONG,
                               coords=True)
        log(f"  tree: {EXPL_CASES + EXPL_LONG} cases x {CLI_GENES} genes, bags "
            f"{sorted(int(b) for b in tree['bags'])} x {PATCH} float16, "
            f"{tree['bytes'] / 1e9:.3f} GB, coords through etl/h5.py; written in "
            f"{time.perf_counter() - t0:.2f} s")

        # (a) train and write the run's artifacts
        reset_launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        pipe = Pipeline(explainer_config(root))
        with contextlib.redirect_stdout(io.StringIO()):
            summary = pipe.main()
        torch.cuda.synchronize()
        log(f"  Pipeline: one fold of one epoch in {time.perf_counter() - t0:.2f} s (dataset "
            f"{pipe.timings['dataset_s']:.2f} s, arena upload "
            f"{pipe.timings['arena_upload_s']:.4f} s), peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB, test c-index "
            f"{summary['mean_test_c_index']:.6f}")
        read_launch_groups("the explainer run's training (warm-up and capture only)",
                           (("#1 projection forward", PROJECTION_FWD),
                            ("#2 projection backward", PROJECTION_BWD)))
        log_dir = Path(pipe.log_dir)
        for name in ("config.pkl", "test_data_indices.pkl", "checkpoints/best.pt"):
            if not (log_dir / name).exists():
                raise AssertionError(f"the run wrote no {name}")
        del pipe
        _DATASET_CACHE.update(key=None, dataset=None, arena_device=None)

        os.chdir(root)  # explanations/<run> lands in the temporary directory
        try:
            # (b) the explainer's entry point on the test patients
            reset_launches()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()) as said:
                ex = Explainer(log_dir)
                results = ex.run(n_high=2, n_low=1)
            torch.cuda.synchronize()
            skipped = said.getvalue().count("skipped")
            log(f"  Explainer(log_dir).run(n_high=2, n_low=1): {time.perf_counter() - t0:.2f} s, "
                f"patients {[(r['slide_id'], int(tree['bags'][tree['sids'].index(r['slide_id'])])) for r in results]}, "
                f"figures skipped without matplotlib: {skipped}")
            read_launch_groups("Explainer.run", (("#1 projection forward", PROJECTION_FWD),))
            names = ["high_risk_0", "high_risk_1", "low_risk_0"]
            if len(results) != 3:
                raise AssertionError(f"run gave {len(results)} results")
            for name, r in zip(names, results):
                check_explanation(ex, name, r, int(tree["bags"][tree["sids"].index(r["slide_id"])]))

            # (c) one long case streamed, then dense
            sid = tree["sids"][EXPL_CASES]
            idx = str(ex.omic_df.index[list(ex.omic_df["slide_id"]).index(sid + ".svs")])
            if LONG_BAG <= explainer_module.STREAMING_TOKENS:
                raise AssertionError("the long bag does not pass the streaming threshold")
            reset_launches()
            stream = timed_explanation(ex, idx, sid, "long_streaming", None)
            read_launch_groups("the streamed explanation", (("#1 projection forward",
                                                             PROJECTION_FWD),))
            # in turns (streamed, dense, dense, streamed): the later two of
            # each write the same files again
            dense = timed_explanation(ex, idx, sid, "long_dense", False)
            walls = {"streamed": [stream[1]], "dense": [dense[1]]}
            walls["dense"].append(timed_explanation(ex, idx, sid, "long_dense", False)[1])
            walls["streamed"].append(timed_explanation(ex, idx, sid, "long_streaming", None)[1])
            for label, (res, wall, peak, calls, _) in (("streamed", stream), ("dense", dense)):
                log(f"  {LONG_BAG}-patch case {sid}, {label}: "
                    f"{', '.join(f'{w:.3f}' for w in walls[label])} s wall (in turns: streamed, "
                    f"dense, dense, streamed), peak memory {peak:.1f} MiB, captures called "
                    f"{calls}")
            if stream[3] != {"dense": 0, "streaming": 1} or \
                    dense[3] != {"dense": 1, "streaming": 0}:
                raise AssertionError(f"captures: streamed {stream[3]}, dense {dense[3]}")
            check_explanation(ex, "long_streaming", stream[0], LONG_BAG)
            check_explanation(ex, "long_dense", dense[0], LONG_BAG)
            rankings_agree("streamed vs dense", stream[0]["omic_ranking"],
                           dense[0]["omic_ranking"])
            for suffix in EXPL_NPY:
                a = np.load(ex.expl_dir / f"long_streaming_{suffix}.npy")
                b = np.load(ex.expl_dir / f"long_dense_{suffix}.npy")
                if suffix == "mask":
                    if not np.array_equal(a, b):
                        raise AssertionError("the streamed and dense masks differ")
                    log(f"  {suffix}.npy {a.shape}: equal")
                else:
                    check(f"streamed vs dense {suffix}.npy {a.shape}",
                          float(np.abs(a.astype(np.float64) - b).max()), EXPL_ATOL)
        finally:
            os.chdir(cwd)
    log(f"  phase 15 wall: {time.perf_counter() - t_phase:.2f} s")


def check_explanation(ex, name: str, result, bag: int) -> None:
    """One explanation's return values and ``.npy`` files: finite, of the
    shapes the JAX package's code gives (the omic vector a gene, the slide
    vector a token of the run's bag width, the heatmap and mask over the
    coords grid's 16-pixel cells)."""
    side = int(np.ceil(np.sqrt(bag)))
    rows = int(np.ceil(bag / side))
    want = {"omic_attention": (CLI_GENES,), "attention": (ex.data.max_patches,),
            "heatmap": (rows * 16, side * 16), "mask": (rows * 16, side * 16)}
    logits = np.asarray(result["logits"])
    if logits.shape != (1, 4) or not np.isfinite(logits).all():
        raise AssertionError(f"{name}: logits {logits}")
    if len(result["omic_ranking"]["feature"]) != 20 or result.get("heatmap") is None:
        raise AssertionError(f"{name}: no omic ranking of 20 or no heatmap")
    for suffix, shape in want.items():
        arr = np.load(ex.expl_dir / f"{name}_{suffix}.npy")
        if arr.shape != shape or (arr.dtype != bool and not np.isfinite(arr).all()):
            raise AssertionError(f"{name}_{suffix}.npy: {arr.shape} {arr.dtype}, want {shape}")



# --------------------------------------------------------------- phase 16

BASE_RUN = "chip_smoke_baselines"
# every baseline the pipeline builds: (model, sources)
BASELINES = [("fcnn", ("omic", "slides")), ("mcat", ("omic", "slides")), ("mcat", ("omic",)),
             ("mcat", ("slides",)), ("mm_prognosis", ("omic", "slides")),
             ("motcat", ("omic", "slides")), ("multimodn", ("omic", "slides"))]
# an eval batch on the card against the same weights on the CPU, both f32
# (TF32 off): the logits within BASE_TOL of their largest magnitude.
# MMPrognosis centres its highway's output by the batch's statistics, whose
# spread is a small part of its size: there each f32 path lies ~1e-4 from
# float64 (tests/test_torch_port_baselines.py), so 1e-3
BASE_TOL, BASE_TOL_BATCH_NORM = 1e-4, 1e-3
MMN_SAMPLES, MMN_STATE = 32, 2000


def baseline_config(root: Path, model: str, sources) -> dict:
    """``config/dress_rehearsal.yml`` with the ``brca`` row of
    ``config/best_hyperparams.yml`` pointed at the tree: one fold of two
    epochs, buckets 2048 / 4096, the int8 arena asked for (which the
    baselines ignore, as in JAX), fused epochs, no checkpoints. ``fcnn``'s
    early-fusion vector (omic and the bag flattened) takes one width, so
    its batches are padded to 4,096 patches, unbucketed."""
    config = Config(str(REPO / "config" / "dress_rehearsal.yml")).read().to_dict()
    config["model_params"] = Config(
        str(REPO / "config" / "best_hyperparams.yml")).read().to_dict()["brca"]
    config.update(tcga_path=str(root / "tcga"), log_path=str(root / "logs"),
                  run_name=f"{BASE_RUN}_{model}_{'_'.join(sources)}", n_folds=1, model=model,
                  sources=list(sources))
    config["data"]["max_patches"] = TOKENS
    config["train_loop"].update(epochs=2, bucket_boundaries=[TOKENS // 2, TOKENS],
                                checkpoint=False, resume=False)
    if model == "fcnn":
        config["train_loop"]["bucket_boundaries"] = None
    return config


def logits_on_cpu(label: str, trainer, batch, tol: float) -> None:
    """One eval batch through the trained module on the card and through a
    CPU copy of it, f32: the logits within ``tol`` of their largest."""
    module = trainer.module.eval()
    trainer.optimizer.zero_grad(set_to_none=True)
    placed = trainer._place(batch)
    tensors = tuple(placed["tensors"])
    if placed.get("patch_offsets") is not None:
        tensors += (gather_bag(trainer._arena, placed["patch_offsets"], placed["kv_masks"][-1]),)
    with torch.no_grad():
        card = module(tensors).float().cpu()
        cpu = copy.deepcopy(module).cpu()(tuple(t.cpu() for t in tensors)).float()
    err = float((card - cpu).abs().max() / cpu.abs().max())
    check(f"{label}: card vs CPU logits {tuple(card.shape)} (relative to the largest)", err, tol)


def run_baseline(root: Path, model: str, sources) -> dict:
    """One ``Pipeline`` fold of a baseline at full width (see
    :func:`phase_baselines`); returns its summary numbers."""
    label = model if model != "mcat" else {
        ("omic", "slides"): "mcat (MCAT)", ("omic",): "mcat (SNN)",
        ("slides",): "mcat (MILAttentionNet)"}[tuple(sources)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    pipe = Pipeline(baseline_config(root, model, sources))
    with contextlib.redirect_stdout(io.StringIO()) as said:
        summary = pipe.main()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**20
    trainer, data = pipe._trainer, pipe._dataset
    res = pipe.fold_results[0]
    walls = [round(h["seconds"], 4) for h in res["history"]]
    bad = {k: v for k, v in summary.items() if k.startswith(("mean_", "std_")) and
           not np.isfinite(v)}
    bad.update({k: res[k] for k in ("train_loss", "val_loss", "test_loss") if
                not np.isfinite(res[k])})
    if bad:
        raise AssertionError(f"{label}: non-finite metrics {bad}")
    if data.device_cache and "data.quantize_arena ignored" not in said.getvalue():
        raise AssertionError(f"{label}: quantize_arena was not ignored")
    n_params = count_parameters(trainer.module)
    log(f"  {label} ({type(trainer.module).__name__}, {n_params} parameters): {wall:.2f} s "
        f"(dataset {pipe.timings['dataset_s']:.2f} s, arena upload "
        f"{pipe.timings.get('arena_upload_s', float('nan')):.4f} s), epochs {walls} s, peak "
        f"memory {peak:.1f} MiB; train loss {[round(h['train_loss'], 6) for h in res['history']]}"
        f", val c-index {res['val_c_index']:.6f}, test c-index {res['test_c_index']:.6f}; "
        f"{'fused epochs from the arena' if trainer.fused_epochs else 'stepwise, streamed'}")

    # one step of its train path under the profiler: the captured step where
    # the model takes the arena, the stepwise one where it cannot (an
    # early-fusion vector or omic alone, as in JAX)
    whole = data.take(np.arange(len(data)))
    train_idx = train_val_test_split(len(data), seed=1)[0]
    if trainer.fused_epochs:
        # the train split's width-4096 batches as one bucket, one replay a
        # step, as phase 13 times its captured step
        blist = [b for b in data.take(train_idx).iter_batches(
                     BATCH, shuffle=True, rng=np.random.default_rng(0),
                     bucket_boundaries=trainer.bucket_boundaries)
                 if b["kv_masks"][-1].shape[1] == TOKENS]
        if trainer.device.type == "cuda" and not any(
                key[:2] == ("train", TOKENS) and table.graph is not None
                for key, table in trainer._tables.items()):
            raise AssertionError(f"{label}: no captured step at width {TOKENS}")

        def run():
            trainer._fused_train_bucket(blist)
        kind = f"captured step ({len(blist)} graph replays a call)"
    else:
        blist = [next(data.take(train_idx).iter_batches(BATCH))]

        def run():
            trainer.train_step(blist[0])
        kind = "stepwise step"
    n = len(blist)
    step_wall = wall_ms(run, reps=3) / n
    # one profiled call: MultiModN's steps run ~37,600 kernels each, and the
    # profiler's cost grows with the events it keeps
    _, busy, count, _ = device_profile(run, reps=1)
    log(f"    {kind} at width {TOKENS}: wall {step_wall:.4f} ms per step, device busy "
        f"{busy / n:.4f} ms (profiler), idle share {1.0 - busy / n / step_wall:.4f}, "
        f"{count / n:.1f} device kernels and copies, {HOST_LAUNCHES[0] / n:.2f} host launch "
        "calls per step")

    def full_width(b):
        masks = b.get("kv_masks")
        return not masks or masks[-1] is None or masks[-1].shape[1] == TOKENS

    eval_batch = next(filter(full_width, whole.iter_batches(
        BATCH, bucket_boundaries=trainer.bucket_boundaries)))
    logits_on_cpu(f"    {label}", trainer, eval_batch,
                  BASE_TOL_BATCH_NORM if model == "mm_prognosis" else BASE_TOL)
    del pipe, trainer, data, whole
    _DATASET_CACHE.update(key=None, dataset=None, arena_device=None)
    torch.cuda.empty_cache()
    return {"model": label, "wall_s": wall, "epochs_s": walls, "peak_mib": peak,
            "params": n_params, "step_ms": step_wall, "busy_ms": busy / n}


def multimodn_trainer_fit(root: Path, host_rng) -> None:
    """``MultiModNTrainer.fit`` for 2 epochs on 32 synthetic samples at the
    pipeline's widths (omic 2,000, bags of 4,096 x 2,048 float16, state
    2,000), 2 classes: the confusion counts cover every row, the history's
    CSV has a row per epoch, stage and split, ``predict`` one label a
    sample."""
    n = MMN_SAMPLES
    omic = host_rng.standard_normal((n, 1, CLI_GENES), dtype=np.float32)
    bags = host_rng.standard_normal((n, TOKENS, PATCH), dtype=np.float32).astype(np.float16)
    y = (omic[:, 0, 0] + 0.5 * bags[:, 0, 0].astype(np.float32) > 0).astype(np.int64)
    data = {"tensors": (omic, bags), "y_disc": y, "censorship": np.zeros(n, np.float32),
            "event_time": np.ones(n, np.float32)}
    gen = torch.Generator().manual_seed(20)
    module = MultiModNModule(
        MMN_STATE,
        [MLPEncoder(MMN_STATE, (1024, 256, 128, 64), input_shape=(1, CLI_GENES)),
         PatchEncoder(MMN_STATE, (512, 256, 128, 64), input_shape=(TOKENS, PATCH))],
        [ClassDecoder(2, state_size=MMN_STATE)], generator=gen)
    trainer = MultiModNTrainer(module, n_classes=2, lr=1e-3, batch_size=BATCH)
    history = MultiModNHistory()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    train_m, val_m = trainer.fit(data, data, epochs=2, history=history)
    wall = time.perf_counter() - t0
    preds = trainer.predict(data)
    history.save_csv(root / "multimodn_history.csv")
    rows = (root / "multimodn_history.csv").read_text().splitlines()
    counts = sum(val_m[k] for k in ("tp", "tn", "fp", "fn"))
    log(f"  MultiModNTrainer.fit (2 epochs, {n} samples, {count_parameters(module)} "
        f"parameters): {wall:.2f} s; val loss by stage {val_m['loss'][:, 0].round(6).tolist()}, "
        f"accuracy {val_m['accuracy'][:, 0].round(4).tolist()}, balanced accuracy "
        f"{val_m['balanced_accuracy'][:, 0].round(4).tolist()}; history {len(rows) - 1} rows; "
        f"predictions {np.bincount(preds, minlength=2).tolist()}")
    if not (np.isfinite(train_m["loss"]).all() and np.isfinite(val_m["loss"]).all()):
        raise AssertionError("MultiModNTrainer gave non-finite losses")
    if val_m["loss"].shape != (3, 1) or not np.allclose(counts, BATCH):
        raise AssertionError(f"confusion counts {counts} do not cover the batches' rows")
    if len(rows) != 1 + 2 * 3 * 2 or preds.shape != (n,) or not set(preds) <= {0, 1}:
        raise AssertionError(f"history rows {len(rows)} or predictions {preds.shape}")


def phase_baselines(host_rng) -> None:
    """Phase 16: every baseline through ``Pipeline`` at full width, and
    MultiModN's own trainer (see the module docstring)."""
    log("phase 16: the baselines through Pipeline at full width (fcnn, MCAT, SNN, "
        "MILAttentionNet, MMPrognosis, MOTCAT, MultiModN; 1 fold x 2 epochs)")
    t_phase = time.perf_counter()
    reset_launches()
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        t0 = time.perf_counter()
        tree = write_tcga_tree(root / "tcga", host_rng)
        log(f"  tree: {CLI_CASES} cases x {CLI_GENES} genes, bags of {tree['bags'].min()}-"
            f"{tree['bags'].max()} patches x {PATCH} float16, {tree['bytes'] / 1e9:.3f} GB; "
            f"written in {time.perf_counter() - t0:.2f} s")
        for model, sources in BASELINES:
            run_baseline(root, model, sources)
        multimodn_trainer_fit(root, host_rng)
    moved = {name: getattr(*KERNELS[name]) for name in KERNELS if getattr(*KERNELS[name])}
    if moved:
        raise AssertionError(f"the baselines launched the port's kernels: {moved}")
    log(f"  no projection, flash or chain counter moved; phase 16 wall: "
        f"{time.perf_counter() - t_phase:.2f} s")



# --------------------------------------------------------------- phase 17

# the sharded layouts of each world size on the one card, (data, seq, model)
WORLD_LAYOUTS = {2: [(2, 1, 1), (1, 2, 1), (1, 1, 2)], 4: [(1, 2, 2)]}
WORLD_TIMEOUT_S = 300
MESH_BAGS = 12  # bags of the arena gathered sharded and replicated


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def mesh_trainer(mesh, state=None, **kw):
    """Phase 7's bf16 trainer (flash attention), on ``mesh``."""
    module = HealNetModule(**BRCA, dtype=torch.bfloat16, attention_impl="flash",
                           device="cuda", generator=torch.Generator().manual_seed(0))
    if state is not None:
        module.load_state_dict(state)
    return SurvivalTrainer(module, l1=1e-6, max_lr=8e-3, gc_compat=16, seed=0, device="cuda",
                           mesh=mesh, prefetch=0, **kw)


def shard_grads(module, mesh, grads: dict) -> dict:
    """The blocks of whole gradients that ``mesh``'s rank holds of
    ``module``'s parameters."""
    from healnet_tpu_torch.parallel.mesh import _HALVES_SUFFIXES, local_block, param_shardings

    return {n: local_block(g, spec, mesh, halves=n.endswith(_HALVES_SUFFIXES))
            for (n, g), spec in zip(grads.items(),
                                    param_shardings(module, mesh).values())}


def world_worker() -> None:
    """One rank of phase 17's gloo world on the shared card: one bf16
    training step of the full-width BRCA model in each layout of its world
    size against the single-process step on the same weights, batch and
    seeds (the loss, and every gradient block against the single step's
    block), the layout's launch counts and wall; in the world of 2, the
    int8 arena sharded over seq gathered against the replicated gather."""
    import datetime

    import torch.distributed as dist

    from healnet_tpu_torch.parallel import build_device_arena, make_mesh, place_arena

    cfg = json.loads(os.environ["CHIP_SMOKE_WORLD"])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=cfg["init"], rank=cfg["rank"],
                            world_size=cfg["world"],
                            timeout=datetime.timedelta(seconds=WORLD_TIMEOUT_S))
    host = np.random.default_rng(17)
    batch = {"tensors": (host.standard_normal((BATCH, 1, OMIC), dtype=np.float32),
                         host.standard_normal((BATCH, TOKENS, PATCH), dtype=np.float32)),
             "y_disc": host.integers(0, 4, size=BATCH),
             "censorship": host.integers(0, 2, size=BATCH).astype(np.float32),
             "event_time": host.uniform(1, 100, size=BATCH).astype(np.float32),
             "sample_mask": np.ones(BATCH, np.float32)}
    ref = mesh_trainer(None)
    loss_ref = ref.train_step(batch, HORIZON)[0].item()
    grads_ref = gradients(ref.module)
    del ref
    out = {}
    for layout in WORLD_LAYOUTS[cfg["world"]]:
        mesh = make_mesh(max_model=layout[2], max_seq=layout[1], device="cuda")
        trainer = mesh_trainer(mesh)
        reset_launches()
        loss = trainer.train_step(batch, HORIZON)[0].item()
        launches = {name: getattr(fn, counter) for name, (fn, counter) in KERNELS.items()
                    if name in FLOAT_KERNELS}
        err, where = worst_grad_error(gradients(trainer.module),
                                      shard_grads(trainer.module, mesh, grads_ref))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            trainer.train_step(batch, HORIZON)
        torch.cuda.synchronize()
        out[str(layout)] = dict(loss=loss, loss_ref=loss_ref, err=err, where=where,
                                launches=launches, wall=(time.perf_counter() - t0) / 3 * 1e3,
                                coords=mesh.coords)
        del trainer
    if cfg["world"] == 2:
        mesh = make_mesh(max_model=1, max_seq=2, device="cuda")
        lengths = host.integers(TOKENS // 4, TOKENS + 1, size=MESH_BAGS)
        offsets = np.concatenate([[0], np.cumsum(lengths)[:-1]]).astype(np.int32)
        arena = np.zeros((int(lengths.sum()) + TOKENS, PATCH), np.float32)
        arena[:int(lengths.sum())] = host.standard_normal((int(lengths.sum()), PATCH),
                                                          dtype=np.float32)
        q = QuantizedContext(*quantize_context_host(arena))
        sharded = build_device_arena(q, mesh, halo=TOKENS)
        whole = place_arena(q, "cuda")
        offs = torch.from_numpy(offsets).cuda()
        mask = torch.from_numpy(np.arange(TOKENS)[None, :] < lengths[:, None]).cuda()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = gather_bag(sharded, offs, mask, mesh=mesh)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        want = gather_bag(whole, offs, mask)
        out["arena"] = dict(equal=bool(torch.equal(got.data, want.data)
                                       and torch.equal(got.scale, want.scale)),
                            rows=int(arena.shape[0]), shard_rows=sharded.data.shard_rows,
                            halo=sharded.data.halo, wall=wall)
    Path(cfg["dir"], f"rank{cfg['rank']}.json").write_text(json.dumps(out))
    dist.barrier()
    dist.destroy_process_group()


def spawn_world(n: int) -> list:
    """Phase 17's world of ``n`` gloo processes on the card: each rank's
    results. A rank's failure stops the others at once, and a world past
    ``WORLD_TIMEOUT_S`` is stopped; either fails the phase."""
    with tempfile.TemporaryDirectory() as tmp:
        procs, logs = [], []
        env = {**os.environ, "PYTHONPATH": os.pathsep.join(
            [str(REPO), *filter(None, [os.environ.get("PYTHONPATH")])])}
        for rank in range(n):
            cfg = dict(init=f"file://{tmp}/rendezvous", rank=rank, world=n, dir=tmp)
            logs.append(open(Path(tmp, f"rank{rank}.log"), "w"))
            procs.append(subprocess.Popen(
                [sys.executable, "-c", "import chip_smoke; chip_smoke.world_worker()"],
                cwd=REPO, env={**env, "CHIP_SMOKE_WORLD": json.dumps(cfg)}, stdout=logs[-1],
                stderr=subprocess.STDOUT))
        deadline = time.monotonic() + WORLD_TIMEOUT_S
        try:
            while any(p.poll() is None for p in procs):
                if time.monotonic() > deadline or any(p.poll() for p in procs):
                    break
                time.sleep(0.2)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
            for f in logs:
                f.close()
        for rank, p in enumerate(procs):
            if p.returncode != 0:
                text = Path(tmp, f"rank{rank}.log").read_text()
                raise AssertionError(f"rank {rank} of the world of {n} exited {p.returncode} "
                                     f"(stopped past {WORLD_TIMEOUT_S} s where negative):\n"
                                     f"{text[-4000:]}")
        return [json.loads(Path(tmp, f"rank{r}.json").read_text()) for r in range(n)]


def phase_multi_device(host_rng) -> None:
    """Phase 17: the multi-device layer on the one card (see the module
    docstring)."""
    import torch.distributed as dist

    from healnet_tpu_torch.parallel import make_mesh

    log("phase 17: multi-device on torch.distributed (full-width BRCA, bf16, flash attention); "
        "worlds of 2 and 4 share the one card over gloo, which stages through the host: their "
        "walls are not NCCL times")
    t_phase = time.perf_counter()
    # (a) a world of one over NCCL: stepwise and fused against the mesh-free trainer
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}", world_size=1,
                            rank=0)
    try:
        mesh = make_mesh(device="cuda")
        state = HealNetModule(**BRCA, device="cuda",
                              generator=torch.Generator().manual_seed(0)).state_dict()
        batches = [train_batch(host_rng, torch.bfloat16) for _ in range(3)]
        runs = {}
        for name, m in (("mesh-free", None), ("world of one", mesh)):
            trainer = mesh_trainer(m, state)
            reset_launches()
            losses = [trainer.train_step(b, HORIZON)[0] for b in batches]
            losses = [x.item() for x in losses]
            launches = read_launches(f"3 stepwise steps, {name}", FLOAT_KERNELS)
            runs[name] = (trainer, losses, launches)
        (t_ref, l_ref, _), (t_mesh, l_mesh, _) = runs.values()
        w_err, where, same = weight_error(t_mesh.module, t_ref.module)
        # the walls of 3 more steps each, in turns (mesh-free, mesh, mesh, mesh-free)
        walls = {"mesh-free": [], "world of one": []}
        for name in ("mesh-free", "world of one", "world of one", "mesh-free"):
            trainer = runs[name][0]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for b in batches:
                trainer.train_step(b, HORIZON)
            torch.cuda.synchronize()
            walls[name].append((time.perf_counter() - t0) / len(batches) * 1e3)
        log(f"  (a) world of one over NCCL, stepwise: losses {l_mesh} against {l_ref} "
            f"(bit-identical weights after 3 steps: {same}); wall per step (3 steps, in turns) "
            f"{[round(w, 4) for w in walls['world of one']]} ms, mesh-free "
            f"{[round(w, 4) for w in walls['mesh-free']]} ms")
        # no collective runs in a world of one: bit-identical, or it fails
        check("(a) stepwise losses against the mesh-free trainer (relative)",
              max(abs(a - b) / abs(b) for a, b in zip(l_mesh, l_ref)), 0.0)
        check(f"(a) stepwise weights after 3 steps (largest relative, {where})", w_err, 0.0)
        if not same:
            raise AssertionError("(a) the stepwise weights differ from the mesh-free trainer's")
        del runs, t_ref, t_mesh
        arena, data = build_arena(np.random.default_rng(12))
        arena = QuantizedContext(*quantize_context_host(arena))  # once for both trainers
        blist = list(iterate_batches(data, BATCH))[:3]
        fused = {}
        for name, m in (("mesh-free", None), ("world of one", mesh)):
            trainer = arena_trainer(torch.bfloat16, "auto", state, mesh=m, fused_epochs=True,
                                    feature_arena=(arena, data["patch_offsets"],
                                                   data["patch_lengths"]))
            trainer._horizon.fill_(HORIZON)
            reset_launches()
            losses = trainer._fused_train_bucket(blist)[0].tolist()
            read_launches(f"3 fused steps, {name} (warm-up and capture)",
                          ("fused_project_int8", "fused_project_bwd_int8", "flash_attention",
                           "flash_attention_bwd"))
            if not any(t.graph is not None for t in trainer._tables.values()):
                raise AssertionError(f"(a) the fused steps {name} left no captured graph")
            fused[name] = (trainer, losses)
        (f_ref, fl_ref), (f_mesh, fl_mesh) = fused.values()
        w_err, where, same = weight_error(f_mesh.module, f_ref.module)
        log(f"  (a) world of one over NCCL, fused (captured): losses {fl_mesh} against {fl_ref} "
            f"(bit-identical weights: {same})")
        check("(a) fused losses against the mesh-free trainer (relative)",
              max(abs(a - b) / abs(b) for a, b in zip(fl_mesh, fl_ref)), 0.0)
        check(f"(a) fused weights after 3 steps (largest relative, {where})", w_err, 0.0)
        if not same:
            raise AssertionError("(a) the fused weights differ from the mesh-free trainer's")
        del fused, f_ref, f_mesh, arena, data, blist

        # (d) the CLI, phase 13's config with spmd and data.shard_arena, in this world
        with tempfile.TemporaryDirectory() as tmp:
            root = Path(tmp)
            write_tcga_tree(root / "tcga", host_rng)
            config = Config(str(cli_config(root))).read().to_dict()
            config.update(spmd=True, n_folds=1, run_name="chip_smoke_spmd")
            config["data"]["shard_arena"] = True
            config["train_loop"]["epochs"] = 1
            path = root / "spmd.yml"
            path.write_text(yaml_dump(config) + "\n")
            seen = {}
            make_trainer = Pipeline.make_trainer

            def keep(pipeline, *a, **kw):
                seen["trainer"] = make_trainer(pipeline, *a, **kw)
                return seen["trainer"]

            Pipeline.make_trainer = keep
            try:
                reset_launches()
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(io.StringIO()):
                    summary = cli_main(["--config_path", str(path), "--mode", "single_run",
                                        "--dataset", "brca"])
                wall = time.perf_counter() - t0
                # phase 13's config: plain attention under "auto" (dropout on)
                read_launches("(d) the spmd CLI run (warm-up and capture)",
                              ("fused_project_int8", "fused_project_bwd_int8"))
            finally:
                Pipeline.make_trainer = make_trainer
            trainer = seen["trainer"]
            inner = trainer._arena.data if isinstance(trainer._arena, QuantizedContext) \
                else trainer._arena
            kind = type(inner).__name__
            metrics = {k: v for k, v in summary.items() if k.startswith("mean_")}
            log(f"  (d) CLI with spmd and data.shard_arena in the world of one: {wall:.2f} s, "
                f"mesh {trainer.mesh.shape}, arena {kind} (halo {inner.halo}); "
                f"{metrics}")
            if kind != "ShardedArena" or not all(np.isfinite(v) for v in metrics.values()):
                raise AssertionError(f"(d) the spmd CLI run gave {kind} or metrics {metrics}")
            del trainer, seen
            _DATASET_CACHE.update(key=None, dataset=None, arena_device=None, arena_sharded=None,
                                  arena_sharded_key=None)
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()

    # (b) worlds of 2 and 4 gloo processes on the one card, (c) the int8 arena
    for n in WORLD_LAYOUTS:
        t0 = time.perf_counter()
        ranks = spawn_world(n)
        log(f"  world of {n} over gloo: {time.perf_counter() - t0:.2f} s wall (each rank's torch "
            "import, its single-process reference step and the layouts)")
        for layout in WORLD_LAYOUTS[n]:
            key = str(layout)
            worst = max(r[key]["err"] for r in ranks)
            loss_err = max(abs(r[key]["loss"] - r[key]["loss_ref"]) / abs(r[key]["loss_ref"])
                           for r in ranks)
            log(f"  (b) {layout} world of {n}: loss {ranks[0][key]['loss']:.6f} against "
                f"{ranks[0][key]['loss_ref']:.6f}; wall {max(r[key]['wall'] for r in ranks):.2f} "
                f"ms per step (gloo on one card); launches per rank "
                f"{[r[key]['launches'] for r in ranks]}")
            # three times the worst of the sound runs (loss 1.96e-3, gradient
            # block 1.32e-2, NVIDIA H100 80GB HBM3, 700.00 W)
            check(f"(b) {layout}: the step's loss against the single-process step (relative)",
                  loss_err, 6e-3)
            check(f"(b) {layout}: every rank's gradient blocks against the single-process "
                  f"step's, worst relative L2 ({ranks[0][key]['where']})", worst, 0.04)
            for r in ranks:
                must = ["fused_project", "fused_project_bwd"]
                if layout[1] == 1:
                    must += ["flash_attention", "flash_attention_bwd"]
                idle = [m for m in must if r[key]["launches"][m] == 0]
                if idle:
                    raise AssertionError(f"(b) {layout} rank {r[key]['coords']}: {idle} were "
                                         "never launched")
        if n == 2:
            a = ranks[0]["arena"]
            log(f"  (c) int8 arena of {a['rows']} rows over seq 2 (shards of {a['shard_rows']} "
                f"rows, halo {a['halo']}): {MESH_BAGS} bags gathered in {a['wall']:.2f} ms "
                f"(gloo), bit-equal to the replicated gather: "
                f"{[r['arena']['equal'] for r in ranks]}")
            if not all(r["arena"]["equal"] for r in ranks):
                raise AssertionError("(c) the sharded int8 gather differs from the replicated one")
    log(f"  phase 17 wall: {time.perf_counter() - t_phase:.2f} s")


# --------------------------------------------------------------- phase 18

# the data-ops slides: a large 40x TCGA slide's level 0 (131,072 pixels a
# side), five levels at a downsample of 4; level 2 holds a 32 x 32 grid of
# 256-pixel patches
DATAOPS_SLIDES = 4
DATAOPS_LEVELS = [(131072 >> 2 * i, 131072 >> 2 * i) for i in range(5)]
DATAOPS_LEVEL, DATAOPS_PATCH, DATAOPS_BATCH = 2, 256, 64
# ResNet-50's multiply-adds for one 224 x 224 image (convolutions and fc),
# two operations each: the work a batch's bound counts
RESNET50_FLOPS = 2 * 4.09e9
DATAOPS_TOL = 1e-4  # cuDNN's f32 algorithms against the CPU's, of the largest feature


class SyntheticSlideLib:
    """A numpy stand-in for libopenslide, with the C call conventions of
    ``tests/test_torch_port_explainer.py::FastFakeOpenSlideLib``: every path
    opens a slide of ``DATAOPS_LEVELS``, white background with stained
    tissue (a large ellipse and three discs, placed by the file's stem) of
    textured colour, premultiplied ARGB with alpha 255."""

    def __init__(self, levels=DATAOPS_LEVELS):
        self.levels = [tuple(lv) for lv in levels]
        self.slides = {}

        class _Fn:
            def __init__(self, impl):
                self._impl, self.restype, self.argtypes = impl, None, None

            def __call__(self, *args):
                return self._impl(*args)

        def openslide_open(path):
            stem = path.decode().rsplit("/", 1)[-1].rsplit(".", 1)[0]
            rng = np.random.default_rng(zlib.crc32(stem.encode()))
            # (cx, cy, rx, ry) as fractions of the slide
            blobs = [(rng.uniform(0.45, 0.55), rng.uniform(0.45, 0.55), rng.uniform(0.44, 0.47),
                      rng.uniform(0.41, 0.44))]
            blobs += [(*rng.uniform(0.12, 0.88, 2), *(rng.uniform(0.1, 0.14),) * 2)
                      for _ in range(3)]
            self.slides[len(self.slides) + 1] = np.array(blobs)
            return len(self.slides)

        def openslide_get_level_dimensions(handle, level, wref, href):
            wref._obj.value, href._obj.value = self.levels[level]

        def openslide_read_region(handle, buf, x, y, level, w, h):
            (w0, h0), (wl, hl) = self.levels[0], self.levels[level]
            px = np.arange(w, dtype=np.int64) + x * wl // w0
            py = np.arange(h, dtype=np.int64) + y * hl // h0
            fx, fy = (px[None, :] + 0.5) / wl, (py[:, None] + 0.5) / hl
            inside = np.zeros((h, w), bool)
            for cx, cy, rx, ry in self.slides[handle]:
                inside |= ((fx - cx) / rx) ** 2 + ((fy - cy) / ry) ** 2 < 1.0
            # texture at level 0's scale: a hash of the pixel's coordinates
            noise = (((px[None, :] << 2 * level) * 73856093)
                     ^ ((py[:, None] << 2 * level) * 19349663)) % 61
            r = np.where(inside, 190 - noise, 238 + noise % 13)
            g = np.where(inside, 90 + noise // 2, 238 + noise % 13)
            b = np.where(inside, 180 - noise // 3, 238 + noise % 13)
            np.ctypeslib.as_array(buf)[:] = (
                (255 << 24) | (r << 16) | (g << 8) | b).reshape(-1).astype(np.uint32)

        impls = dict(
            openslide_open=openslide_open,
            openslide_get_error=lambda handle: None,
            openslide_get_level_count=lambda handle: len(self.levels),
            openslide_get_level_dimensions=openslide_get_level_dimensions,
            openslide_read_region=openslide_read_region,
            openslide_get_property_names=lambda handle: [None],
            openslide_get_property_value=lambda handle, key: b"",
            openslide_close=lambda handle: None,
        )
        for name, impl in impls.items():
            setattr(self, name, _Fn(impl))


def install_synthetic_slides() -> bool:
    """Put :class:`SyntheticSlideLib` in the port's slide binding (through
    ``etl/slides.py::_configure`` and ``_LIB``); returns whether a real
    libopenslide was found first."""
    from healnet_tpu_torch.etl import slides

    found = slides._load_lib() is not None
    lib = SyntheticSlideLib()
    slides._configure(lib)
    slides._LIB, slides._LIB_ERROR = lib, None
    return found


def dataops_tree(root: Path, host_rng):
    """Empty ``.svs`` files of ``DATAOPS_SLIDES`` slides under ``wsi/brca``
    (the stand-in library draws them), the omics table the loader joins
    them with, and a config pointing at the tree; returns (slide ids,
    config path)."""
    sids = [f"TCGA-DO-{i:04d}-01Z-00-DX1" for i in range(DATAOPS_SLIDES)]
    (root / "wsi" / "brca").mkdir(parents=True)
    (root / "omic").mkdir()
    for sid in sids:
        (root / "wsi" / "brca" / f"{sid}.svs").touch()
    omic = host_rng.standard_normal((DATAOPS_SLIDES, 16), dtype=np.float32)
    write_omic_csv(root, sids, omic, np.zeros(DATAOPS_SLIDES, np.int64),
                   np.linspace(10.0, 40.0, DATAOPS_SLIDES))
    config = root / "dataops.yml"
    config.write_text(f"tcga_path: {json.dumps(str(root))}\n")
    return sids, config


def run_tasks(argv) -> tuple:
    """``tasks.main(argv)`` in this process: (its result, its lines, wall s)."""
    from healnet_tpu_torch.cli import tasks

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as said:
        result = tasks.main(argv)
    torch.cuda.synchronize()
    return result, said.getvalue().splitlines(), time.perf_counter() - t0


def phase_dataops(host_rng, smi: str) -> None:
    """Phase 18: the data-ops CLI at full width (see the module docstring)."""
    from healnet_tpu_torch.cli import tasks
    from healnet_tpu_torch.etl import TCGADataset, h5
    from healnet_tpu_torch.etl.slides import OpenSlide
    from healnet_tpu_torch.ops.resnet import PatchFeatureExtractor
    from healnet_tpu_torch.utils.profiling import log_compile_time

    log(f"phase 18: python -m healnet_tpu_torch.cli.tasks preprocess (patch, then features) on "
        f"{DATAOPS_SLIDES} synthetic slides of {DATAOPS_LEVELS[0][0]:,} x "
        f"{DATAOPS_LEVELS[0][1]:,} pixels, level {DATAOPS_LEVEL}, {DATAOPS_PATCH}-pixel patches; "
        f"ResNet-50 on the card in f32, TF32 off, batch {DATAOPS_BATCH}, random weights")
    t_phase = time.perf_counter()
    found = install_synthetic_slides()
    log(f"  a real libopenslide was {'found' if found else 'not found'}; the slides are drawn "
        "by a numpy stand-in for it, installed through etl/slides.py::_configure and _LIB")
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        sids, config = dataops_tree(root, host_rng)
        common = ["--dataset", "brca", "--config", str(config), "--level", str(DATAOPS_LEVEL),
                  "--patch_size", str(DATAOPS_PATCH)]
        _, _, patch_wall = run_tasks(["preprocess", *common, "--step", "patch"])
        prep = root / "wsi" / f"brca_preprocessed_level{DATAOPS_LEVEL}"
        coords = {sid: h5.read_dataset(prep / "patches" / f"{sid}.h5", "coords") for sid in sids}
        counts = {sid: len(c) for sid, c in coords.items()}
        grid = (DATAOPS_LEVELS[DATAOPS_LEVEL][0] // DATAOPS_PATCH) ** 2
        log(f"  patch step: {patch_wall:.4f} s wall for {DATAOPS_SLIDES} slides; tissue patches "
            f"per slide {list(counts.values())} of {grid}; {smi}")
        # (b) the coords read back equal a second patching of the slide
        slide = OpenSlide(root / "wsi" / "brca" / f"{sids[0]}.svs")
        again = tasks.patch_slide(slide, level=DATAOPS_LEVEL, patch_size=DATAOPS_PATCH)
        attrs = h5.read_attrs(prep / "patches" / f"{sids[0]}.h5", "coords")
        if not (np.array_equal(again, coords[sids[0]]) and again.dtype == np.int64
                and {k: int(v) for k, v in attrs.items()} == {
                    "patch_size": DATAOPS_PATCH, "patch_level": DATAOPS_LEVEL}):
            raise AssertionError(f"(b) the h5 coords or attrs {attrs} differ from patch_slide's")
        if min(counts.values()) < DATAOPS_BATCH:
            raise AssertionError(f"a slide has fewer than {DATAOPS_BATCH} tissue patches: {counts}")
        log(f"  (b) {sids[0]}: the h5 coords ({len(again)} x 2 int64) and attrs {dict(attrs)} "
            "equal a second patch_slide")

        # (a) the first 64 patches of one slide, the card against a CPU copy
        patches = tasks.read_patches(slide, coords[sids[0]][:DATAOPS_BATCH], DATAOPS_LEVEL,
                                     DATAOPS_PATCH)
        card = PatchFeatureExtractor(batch_size=DATAOPS_BATCH)
        timed = log_compile_time(card, name="PatchFeatureExtractor")
        with contextlib.redirect_stdout(io.StringIO()) as said:
            got = timed(patches)
            timed(patches)
        for line in said.getvalue().splitlines():
            log(f"  {line} ({smi})")
        want = PatchFeatureExtractor(batch_size=DATAOPS_BATCH, device="cpu")(patches)
        err = float(np.abs(got - want).max() / np.abs(want).max())
        check(f"(a) card vs CPU features of {sids[0]}'s first {DATAOPS_BATCH} patches, relative "
              "to the largest", err, DATAOPS_TOL)
        x = torch.from_numpy(patches).cuda()
        wall, busy, count, _ = device_profile(lambda: card.embed(x))
        bound, bound_by = bound_ms(nbytes(x) + DATAOPS_BATCH * 2048 * 4,
                                   DATAOPS_BATCH * RESNET50_FLOPS, torch.float32)
        log(f"  one batch of {DATAOPS_BATCH} on the card (uint8 on the device, normalise, "
            f"ResNet-50): device busy {busy:.4f} ms (profiler), wall {wall:.4f} ms, "
            f"{count:.0f} kernels and copies, bound {bound:.4f} ms ({bound_by}, f32 without "
            f"TF32); {DATAOPS_BATCH / busy * 1e3:.2f} patches/s of device time; {smi}")

        # the features step, in this process through main, every counter at 0
        reset_launches()
        torch.cuda.reset_peak_memory_stats()
        feats, feat_lines, feat_wall = run_tasks(["preprocess", *common, "--step", "features"])
        peak = torch.cuda.max_memory_allocated() / 2**20
        moved = {name: getattr(*KERNELS[name]) for name in KERNELS if getattr(*KERNELS[name])}
        if moved:
            raise AssertionError(f"(d) the extraction launched the port's kernels: {moved}")
        total = sum(counts.values())
        if feats["patches"] != total or feat_lines[-1] != (
                f"features: {DATAOPS_SLIDES} extracted, 0 already present, 0 without a patches h5"):
            raise AssertionError(f"the features step said {feat_lines[-3:]}")
        log(f"  features step: {feat_wall:.4f} s wall for {total} patches "
            f"({total / feat_wall:.2f} patches/s end to end); region reading and resize on the "
            f"host {feats['read_s']:.4f} s ({total / feats['read_s']:.2f} patches/s), extraction "
            f"{feats['extract_s']:.4f} s ({total / feats['extract_s']:.2f} patches/s, the first "
            f"call's cuDNN set-up included); peak memory {peak:.1f} MiB; {smi}")
        log("  (d) no projection, flash or chain counter moved during extraction")

        written = np.load(prep / "patch_features" / f"{sids[0]}.npy")[:DATAOPS_BATCH]
        d_written = float(np.abs(written - got).max())
        log(f"  the main path's features of {sids[0]}'s first {DATAOPS_BATCH} patches: max|d| "
            f"{d_written:.3g} from the (a) extractor's")
        if not d_written <= DATAOPS_TOL * np.abs(want).max():
            raise AssertionError("the written features differ from the extractor's")

        # (c) the loader reads every bag, sized from the .npy header
        data = TCGADataset("brca", {"tcga_path": str(root)}, level=DATAOPS_LEVEL)
        for sid in data.slide_ids:
            bag = data.load_patch_features(sid)
            if data._bag_sizes[sid] != counts[sid] or bag.shape != (counts[sid], 2048) \
                    or not np.isfinite(bag).all():
                raise AssertionError(f"(c) {sid}: header {data._bag_sizes[sid]}, bag "
                                     f"{bag.shape}, coords {counts[sid]}")
        if sorted(data.slide_ids) != sids:
            raise AssertionError(f"(c) the loader found {data.slide_ids}")
        log(f"  (c) TCGADataset reads the {len(sids)} bags, {sorted(counts.values())} x 2048, "
            "sized from the .npy headers")

        # the module entry point in a fresh process, on one slide
        out = prep / "patch_features" / f"{sids[-1]}.npy"
        first = np.load(out)
        out.unlink()
        code = ("import runpy, torch, chip_smoke\n"
                "torch.backends.cudnn.allow_tf32 = False\n"
                "torch.backends.cuda.matmul.allow_tf32 = False\n"
                "chip_smoke.install_synthetic_slides()\n"
                "runpy.run_module('healnet_tpu_torch.cli.tasks', run_name='__main__', "
                "alter_sys=True)\n")
        t0 = time.perf_counter()
        env = {**os.environ,
               "PYTHONPATH": f"{REPO}{os.pathsep}{os.environ.get('PYTHONPATH', '')}"}
        proc = subprocess.run([sys.executable, "-c", code, "preprocess", *common, "--step",
                               "features"], cwd=REPO, env=env, capture_output=True, text=True,
                              timeout=300)
        fresh_wall = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"python3 -m healnet_tpu_torch.cli.tasks failed:\n"
                                 f"{proc.stderr[-3000:]}")
        said = proc.stdout.splitlines()
        again = np.load(out)
        diff = float(np.abs(again - first).max())
        if said[-1] != f"features: 1 extracted, {DATAOPS_SLIDES - 1} already present, 0 without " \
                       "a patches h5" or not diff <= DATAOPS_TOL * np.abs(first).max():
            raise AssertionError(f"the fresh process said {said[-2:]}; max|d| {diff}")
        log(f"  python3 -m healnet_tpu_torch.cli.tasks preprocess --step features in a fresh "
            f"process: {fresh_wall:.2f} s wall, '{said[-1]}'; {sids[-1]}'s features "
            f"{'bit-equal' if diff == 0 else f'max|d| {diff:.3g}'} to the in-process run's")
    log(f"  phase 18 wall: {time.perf_counter() - t_phase:.2f} s; {smi}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")

    log("phase 1: build")
    t0 = time.perf_counter()
    seconds = cuda_build.build()
    log(f"  built {sorted(seconds)} in {time.perf_counter() - t0:.2f} s wall "
        f"({', '.join(f'{k} {v:.2f} s' for k, v in seconds.items())})")
    for name, info in cuda_build.BUILD_LOG.items():
        log(f"  {name}: {info['ptxas']}")

    gen = torch.Generator(device="cuda").manual_seed(0)
    projection = phase_projection(gen)
    kernels = [*projection, *phase_flash(gen)]
    phase_serving(np.random.default_rng(0))
    phase_serving_rows(np.random.default_rng(3))
    kernels += [*phase_flash_bwd(gen), phase_projection_bwd(gen)]
    launches = phase_training(np.random.default_rng(1))
    launches.update(phase_parity_step((6, 1, 7)))
    launches.update(phase_wide_step(np.random.default_rng(4)))
    kernels += [*phase_projection_int8(gen, projection[0]["ms"], projection[1]["ms"]),
                phase_projection_bwd_int8(gen)]
    launches.update(phase_arena(np.random.default_rng(2)))
    chain, chain_launches = phase_chain(gen)
    kernels.append(chain)
    launches.update(chain_launches)
    phase_fit(np.random.default_rng(5))
    phase_cli(np.random.default_rng(6))
    phase_export(np.random.default_rng(7))
    phase_explainer(np.random.default_rng(8))
    phase_baselines(np.random.default_rng(9))
    phase_multi_device(np.random.default_rng(10))
    phase_dataops(np.random.default_rng(11), smi)
    order = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
             "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = [{key: {**k, "launches": launches[k["name"]]}[key] for key in order}
               for k in kernels]
    log(f"profiler windows that saw no device kernel (each profiled again): "
        f"{len(EMPTY_WINDOWS)}; first kernel - first launch over {len(WINDOW_GAPS)} windows "
        f"(us): min {min(WINDOW_GAPS):.1f}, median {statistics.median(WINDOW_GAPS):.1f}, max "
        f"{max(WINDOW_GAPS):.1f}; the first ten {[round(g, 1) for g in WINDOW_GAPS[:10]]}, the "
        f"last ten {[round(g, 1) for g in WINDOW_GAPS[-10:]]}")
    log(json.dumps({"kernels": kernels, "empty_profiler_windows": len(EMPTY_WINDOWS)}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
