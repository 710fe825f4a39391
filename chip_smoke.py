#!/usr/bin/env python3
"""Smoke test of the PyTorch port (healnet_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit code:

1. build the CUDA kernels from ``healnet_tpu_torch/ops/csrc`` (nvcc, one
   process per source, started together);
2. hold the fused KV projection kernel against its plain PyTorch version at
   the serving shapes (bf16 WSI bag and omic vector) and at a small ragged
   f32 shape, and time kernel, plain version, the library GEMM and the bound;
3. the same for the flash cross-attention kernel at (8, 17, 4096, 63) bf16:
   unmasked, masked with ragged lengths and one fully masked row, and with
   hash dropout, plus a small f32 case;
4. serve the full-width BRCA-tuned HealNet (bf16, batch 8, flash attention,
   random weights from a seeded generator) through ``Predictor``: a dense
   4096-token request of 20 samples, a request without the omic modality,
   and ragged bags across the 1024/2048/4096/8192 buckets; check the outputs
   against the same weights on the plain path, and that both kernels were
   launched by that run;
5. hold the flash cross-attention backward kernel against its plain version
   at (8, 17, 4096, 63) bf16 (unmasked, masked with a fully masked row,
   dropout 0.083), at the one-token omic context, and at a small f32 shape;
   time kernel, plain version, SDPA's backward and the bound;
6. the same for the projection backward (cotangent pass) kernel at
   (8, 4096, 252) bf16 and a small f32 shape;
7. train the full-width BRCA model through ``SurvivalTrainer.train_step``
   (dropout 0.083 / 0.473, NLL/16 + L1, Adam under OneCycle): step-1 loss and
   gradients of the kernel path against the plain path with the same weights
   and dropout draws, in f32 and bf16; then 5 bf16 steps on the kernel path,
   the main path's run, which must launch all four kernels and give finite
   losses; step time, samples/s and peak memory, and one step with plain
   attention for comparison;
8. print the kernels line, then the device line.

Needs one CUDA GPU, nvcc, and the repository around this file.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from healnet_tpu_torch.models.healnet import HealNetModule
from healnet_tpu_torch.ops import cuda_build
from healnet_tpu_torch.ops.attention import multihead_attention
from healnet_tpu_torch.ops.flash_attention import (
    flash_attention_bwd_kernel,
    flash_attention_kernel,
    flash_backward_plain,
)
from healnet_tpu_torch.ops.fourier import positional_encoding
from healnet_tpu_torch.ops.fused_project import (
    _prep,
    fused_project_bwd_kernel,
    fused_project_kernel,
    project_bwd_plain,
    project_plain,
)
from healnet_tpu_torch.serving import Predictor
from healnet_tpu_torch.train.loop import SurvivalTrainer

KERNELS = {"fused_project": fused_project_kernel, "fused_project_bwd": fused_project_bwd_kernel,
           "flash_attention": flash_attention_kernel,
           "flash_attention_bwd": flash_attention_bwd_kernel}

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


def device_profile(fn, reps: int = 3):
    """``torch.profiler`` over ``reps`` calls after three warm-up calls:
    (wall ms per call with the profiler on, device busy ms per call,
    kernels and copies per call, their averaged events). Busy time sums the
    kernels' and copies' own device times; annotation ranges (such as
    ``Optimizer.step``) span kernels already counted and are left out."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / reps
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and device_us(e) > 0
            and not getattr(e, "is_user_annotation", False)]
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
    for fn in KERNELS.values():
        fn.launches = 0


def read_launches(run: str, names) -> dict:
    """The named kernels' launch counts since :func:`reset_launches`; fails
    if one of them was never launched."""
    launches = {name: KERNELS[name].launches for name in names}
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


def phase_projection(gen) -> dict:
    log("phase 2: fused KV projection kernel vs plain version")
    # bf16 tolerance: the kernel and the plain version round the product to
    # bf16 at the same place but sum it in another order, so a raw value may
    # round one bf16 ulp apart, and the output rounds once more: 4 ulps of
    # the largest output leaves a margin of two
    worst = {}
    for label, (b, t, c) in {"wsi": (BATCH, TOKENS, PATCH), "omic": (BATCH, 1, OMIC)}.items():
        *_, ops, run, plain = projection_case(gen, b, t, c, 252, torch.bfloat16)
        kv, s1, s2 = run()
        ref = plain()
        torch.cuda.synchronize()
        err = (kv.float() - ref.float()).abs().max().item()
        check(f"bf16 {label} {(b, t, c)} F=252", err, 4 * bf16_ulp(ref.float().abs().max().item()))
        worst[label] = err
    # f32: the same schedule with FMA; sums of ~200 products in another
    # order than cuBLAS's full-f32 GEMM agree to ~1e-6 of values ~1
    for c in (200, 203):  # 16-byte row loads, and the element-wise path
        *_, ops, run, plain = projection_case(gen, 2, 300, c, 70, torch.float32)
        err = (run()[0] - plain()).abs().max().item()
        check(f"f32 ragged (2, 300, {c}) F=70", err, 1e-4)

    dat, enc, w_all, b_all, ops, run, plain = projection_case(
        gen, BATCH, TOKENS, PATCH, 252, torch.bfloat16)
    kv, s1, s2 = run()
    w_c = ops[0]
    dat2d = dat.reshape(-1, PATCH)
    (t_kernel, w_kernel), (t_plain, w_plain) = time_ms(run), time_ms(plain)
    t_library, _ = time_ms(lambda: torch.matmul(dat2d, w_c))
    flops = 2.0 * dat2d.shape[0] * PATCH * w_c.shape[1]
    bound, by = bound_ms(nbytes(dat, *ops, kv, s1, s2), flops, torch.bfloat16)
    log(f"  device time at (8, 4096, 2048) bf16 F=252: kernel {t_kernel:.4f} ms, plain "
        f"{t_plain:.4f} ms, torch.matmul GEMM alone {t_library:.4f} ms, bound "
        f"{bound:.4f} ms ({by}); wall per call: kernel {w_kernel:.4f} ms, plain "
        f"{w_plain:.4f} ms")
    return dict(name="fused_project", route="cuda",
                source="healnet_tpu_torch/ops/csrc/fused_project.cu",
                replaces="healnet_tpu/ops/fused_project.py:162",
                max_abs_err=worst["wsi"], ms=t_kernel, plain_ms=t_plain,
                bound_ms=bound, bound_by=by, library_ms=t_library)


# ---------------------------------------------------------------- phase 3


def attention_inputs(gen, b, lq, lkv, d, dtype):
    """q (b, 1, lq, d), and k/v as the column slices of a merged KV buffer
    (b, lkv, 4 d), as the model hands them to the kernel."""
    q = torch.randn((b, lq, d), generator=gen, device="cuda").to(dtype)[:, None]
    kv = torch.randn((b, lkv, 4 * d), generator=gen, device="cuda").to(dtype)
    return q, kv[..., d:2 * d][:, None], kv[..., 2 * d:3 * d][:, None]


def phase_flash(gen) -> dict:
    log("phase 3: flash cross-attention kernel vs plain version")
    b, lq, lkv, d = BATCH, 17, TOKENS, 63
    scale = d**-0.5
    q, k, v = attention_inputs(gen, b, lq, lkv, d, torch.bfloat16)
    lengths = torch.randint(1, lkv, (b,), generator=gen, device="cuda")
    lengths[0] = 0  # a sample whose whole bag is masked
    mask = torch.arange(lkv, device="cuda")[None, :] < lengths[:, None]
    cases = {"unmasked": (None, 0.0), "masked": (mask, 0.0), "dropout 0.083": (mask, 0.083)}
    seed = 0x9E3779B9
    worst = 0.0
    for label, (m, rate) in cases.items():
        out, _ = flash_attention_kernel(q, k, v, m, scale / 0.5, rate, seed)
        # plain version on the same (bf16) values, held in f32
        ref, _ = multihead_attention(q.float(), k.float(), v.float(), scale=scale,
                                     temperature=0.5, kv_mask=m, dropout_rate=rate,
                                     dropout_seed=seed)
        torch.cuda.synchronize()
        err = (out.float() - ref).abs().max().item()
        # bf16: the kernel rounds the probabilities to bf16 before the value
        # product (as the TPU kernel does) and rounds the output
        check(f"bf16 (8, 17, 4096, 63) {label}", err, 2e-2)
        if m is not None:
            assert out[0].abs().max().item() == 0.0, "fully masked row must output 0"
        worst = max(worst, err)
    qf, kf, vf = attention_inputs(gen, 2, 17, 300, 63, torch.float32)
    mf = torch.rand((2, 300), generator=gen, device="cuda") > 0.3
    out, _ = flash_attention_kernel(qf, kf, vf, mf, scale / 0.5, 0.3, seed)
    ref, _ = multihead_attention(qf, kf, vf, scale=scale, kv_mask=mf, dropout_rate=0.3,
                                 dropout_seed=seed)
    # f32: online softmax against materialised weights, as the JAX package's
    # own flash tests hold them
    check("f32 (2, 17, 300, 63) masked, dropout 0.3", (out - ref).abs().max().item(), 2e-5)

    run = lambda: flash_attention_kernel(q, k, v, None, scale / 0.5)
    out, lse = run()
    t_kernel, w_kernel = time_ms(run)
    t_plain, w_plain = time_ms(lambda: multihead_attention(q, k, v, scale=scale))
    t_library, _ = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, scale=scale / 0.5))
    flops = 4.0 * b * lq * lkv * d
    bound, by = bound_ms(nbytes(q, out, lse) + 2 * b * lkv * d * 2, flops, torch.bfloat16)
    log(f"  device time at (8, 17, 4096, 63) bf16 unmasked: kernel {t_kernel:.4f} ms, "
        f"plain {t_plain:.4f} ms, SDPA {t_library:.4f} ms, bound {bound:.5f} ms ({by}); "
        f"wall per call: kernel {w_kernel:.4f} ms, plain {w_plain:.4f} ms")
    return dict(name="flash_attention", route="cuda",
                source="healnet_tpu_torch/ops/csrc/flash_attention.cu",
                replaces="healnet_tpu/ops/flash_attention.py:98",
                max_abs_err=worst, ms=t_kernel, plain_ms=t_plain,
                bound_ms=bound, bound_by=by, library_ms=t_library)


# ---------------------------------------------------------------- phase 4


def brca_predictor(dtype, attention_impl, projection_impl, state_dict=None):
    module = HealNetModule(
        **BRCA, dtype=dtype, attention_impl=attention_impl,
        projection_impl=projection_impl, device="cuda",
        generator=torch.Generator().manual_seed(0),
    )
    return Predictor(module, state_dict, batch_size=BATCH,
                     bucket_boundaries=BUCKETS, device="cuda")


def compare(name, got, ref, tol_logits):
    for key in ("logits", "hazards", "survival", "risk"):
        if not np.isfinite(got[key]).all():
            raise AssertionError(f"{name}: non-finite {key}")
    err = float(np.abs(got["logits"] - ref["logits"]).max())
    check(f"{name} logits vs plain path", err, tol_logits)


def phase_serving(host_rng) -> dict:
    log("phase 4: serving the full-width BRCA model through Predictor")
    pred = brca_predictor(torch.bfloat16, "flash", "auto")
    ref = brca_predictor(torch.bfloat16, "xla", "xla", pred.module.state_dict())
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
    pred32 = brca_predictor(None, "flash", "auto", pred.module.state_dict())
    ref32 = brca_predictor(None, "xla", "xla", pred.module.state_dict())
    mask = np.arange(TOKENS)[None, :] < np.array([4096, 3000, 1, 2048, 4096, 100, 4096, 17])[:, None]
    got32 = pred32([omic[:8], wsi[:8]], kv_masks=[None, mask])
    compare("f32 masked micro-batch", got32, ref32([omic[:8], wsi[:8]], kv_masks=[None, mask]),
            1e-3)
    return launches


# ---------------------------------------------------------------- phase 5


def flash_bwd_inputs(gen, b, lkv, dtype, mask, rate, seed):
    """The backward's inputs at the model's layout: q, k, v, dO and the
    forward kernel's lse, and delta = rowsum(dO * O)."""
    d = 63
    q, k, v = attention_inputs(gen, b, 17, lkv, d, dtype)
    out, lse = flash_attention_kernel(q, k, v, mask, d**-0.5 / 0.5, rate, seed)
    do = torch.randn((b, 17, d), generator=gen, device="cuda").to(dtype)
    delta = (do.float() * out.float()).sum(-1)[:, None]
    return q, k, v, do[:, None], lse, delta


def phase_flash_bwd(gen) -> dict:
    log("phase 5: flash cross-attention backward kernel vs plain version")
    b, lq, lkv, d = BATCH, 17, TOKENS, 63
    eff = d**-0.5 / 0.5
    seed = 0x2545F491
    lengths = torch.randint(1, lkv, (b,), generator=gen, device="cuda")
    lengths[0] = 0  # a sample whose whole bag is masked
    mask = torch.arange(lkv, device="cuda")[None, :] < lengths[:, None]
    cases = {"unmasked": (b, lkv, torch.bfloat16, None, 0.0),
             "masked": (b, lkv, torch.bfloat16, mask, 0.0),
             "dropout 0.083": (b, lkv, torch.bfloat16, mask, 0.083),
             "omic lkv=1, dropout 0.083": (b, 1, torch.bfloat16, None, 0.083),
             "f32 (2, 17, 300, 63) masked, dropout 0.3": (
                 2, 300, torch.float32, torch.rand((2, 300), generator=gen, device="cuda") > 0.3,
                 0.3)}
    worst = 0.0
    for label, (nb, n, dtype, m, rate) in cases.items():
        args = flash_bwd_inputs(gen, nb, n, dtype, m, rate, seed)
        q, k, v, do, lse, delta = args
        got = flash_attention_bwd_kernel(q, k, v, m, do, lse, delta, eff, rate, seed)
        ref = flash_backward_plain(q, k, v, m, do, lse, delta, eff, rate, seed)
        torch.cuda.synchronize()
        for name, a, r in zip(("dq", "dk", "dv"), got, ref):
            err = (a.float() - r.float()).abs().max().item()
            top = r.float().abs().max().item()
            # f32: sums in another order; bf16: kernel and plain version round
            # p and ds to bf16 at the same places and sum in another order,
            # so a term may round one ulp apart: 4 ulps of the largest value
            tol = 1e-5 * max(1.0, top) if dtype == torch.float32 else 4 * bf16_ulp(top)
            check(f"{label} {name}", err, tol)
            if dtype == torch.bfloat16 and n == lkv:
                worst = max(worst, err)
        if m is not None and m.shape[0] == b:
            assert all(g[0].abs().max().item() == 0.0 for g in got), \
                "a fully masked row must get zero gradients"

    q, k, v, do, lse, delta = flash_bwd_inputs(gen, b, lkv, torch.bfloat16, None, 0.0, seed)
    run = lambda: flash_attention_bwd_kernel(q, k, v, None, do, lse, delta, eff)
    dq, dk, dv = run()
    t_kernel, w_kernel = time_ms(run)
    t_plain, w_plain = time_ms(
        lambda: flash_backward_plain(q, k, v, None, do, lse, delta, eff))
    ql, kl, vl = (x.detach().clone().requires_grad_() for x in (q, k, v))
    out = torch.nn.functional.scaled_dot_product_attention(ql, kl, vl, scale=eff)
    t_library, _ = time_ms(lambda: torch.autograd.grad(out, (ql, kl, vl), do,
                                                       retain_graph=True))
    # five (lq x lkv x d) products: scores, dO V^T, dV, dK, dQ
    flops = 10.0 * b * lq * lkv * d
    bound, by = bound_ms(nbytes(q, k, v, do, lse, delta, dq, dk, dv), flops, torch.bfloat16)
    log(f"  device time at (8, 17, 4096, 63) bf16 unmasked: kernel {t_kernel:.4f} ms, "
        f"plain {t_plain:.4f} ms, SDPA backward {t_library:.4f} ms, bound {bound:.5f} ms "
        f"({by}; {flops / 1e9:.3f} GFLOP); wall per call: kernel {w_kernel:.4f} ms, "
        f"plain {w_plain:.4f} ms")
    return dict(name="flash_attention_bwd", route="cuda",
                source="healnet_tpu_torch/ops/csrc/flash_attention_bwd.cu",
                replaces="healnet_tpu/ops/flash_attention.py:201",
                max_abs_err=worst, ms=t_kernel, plain_ms=t_plain,
                bound_ms=bound, bound_by=by, library_ms=t_library)


# ---------------------------------------------------------------- phase 6


def phase_projection_bwd(gen) -> dict:
    log("phase 6: projection backward (cotangent pass) kernel vs plain version")
    worst = 0.0
    cases = {"bf16 (8, 4096, 252)": (BATCH, TOKENS, PATCH, 252, torch.bfloat16),
             "f32 (2, 300, 70)": (2, 300, 200, 70, torch.float32)}
    for label, (b, t, c, f, dtype) in cases.items():
        *_, run, _ = projection_case(gen, b, t, c, f, dtype)
        _, s1, s2 = run()  # the forward kernel's saved row statistics
        g = torch.randn((b, t, f), generator=gen, device="cuda").to(dtype)
        d_raw, dsum2 = fused_project_bwd_kernel(g, s1, s2, c + 5)
        ref_raw, ref_sum = project_bwd_plain(g, s1, s2, c + 5)
        torch.cuda.synchronize()
        err = (d_raw.float() - ref_raw.float()).abs().max().item()
        top = ref_raw.float().abs().max().item()
        # d_raw rounds inv * g once in both; rsqrtf may differ from torch's
        # rsqrt in its last bit, which can move a bf16 rounding by one ulp
        check(f"{label} d_raw", err, bf16_ulp(top) if dtype == torch.bfloat16 else 1e-6 * top)
        # dsum2: f32 sums of b*t terms in another order; the worst-case
        # rounding error of such a sum is (terms) * 2^-24 * sum|terms|
        mu = s1 / (c + 5)
        imu = mu * torch.rsqrt(s2 / (c + 5) - mu * mu + 1e-5)
        weight = torch.clamp(imu.abs().max(), min=1.0).item()
        bound_err = b * t * 2.0**-24 * weight * g.float().abs().sum(dim=(0, 1)).max().item()
        check(f"{label} dsum2", (dsum2 - ref_sum).abs().max().item(), bound_err)
        if dtype == torch.bfloat16:
            worst = err
            run_k = lambda: fused_project_bwd_kernel(g, s1, s2, c + 5)
            t_kernel, w_kernel = time_ms(run_k)
            t_plain, w_plain = time_ms(lambda: project_bwd_plain(g, s1, s2, c + 5))
            # 4 operations per element (the JAX cost estimate)
            bound, by = bound_ms(nbytes(g, s1, s2, d_raw, dsum2), 4.0 * g.numel(), dtype)
            log(f"  device time at (8, 4096, 252) bf16: kernel {t_kernel:.4f} ms, plain "
                f"{t_plain:.4f} ms, bound {bound:.5f} ms ({by}); wall per call: kernel "
                f"{w_kernel:.4f} ms, plain {w_plain:.4f} ms; library: none (no single "
                "PyTorch call computes d_raw and both column sums)")
    return dict(name="fused_project_bwd", route="cuda",
                source="healnet_tpu_torch/ops/csrc/fused_project_bwd.cu",
                replaces="healnet_tpu/ops/fused_project.py:268",
                max_abs_err=worst, ms=t_kernel, plain_ms=t_plain,
                bound_ms=bound, bound_by=by, library_ms=None)


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


def compare_gradients(label, kernel, plain, batch, tol_loss, tol_grad) -> None:
    """Step 1 on both paths (same weights, same generator seeds, so the same
    dropout draws); the losses and every parameter's gradient, as L2 errors
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
    loss_p = plain.train_step(batch, HORIZON)[0].item()
    check(f"{label} step-1 loss {loss_k:.6f} vs {loss_p:.6f} (relative)",
          abs(loss_k - loss_p) / abs(loss_p), tol_loss)
    grads_p = {n: p.grad.float() for n, p in plain.module.named_parameters()}
    floor = 0.01 * torch.sqrt(sum(g.square().sum() for g in grads_p.values())).item()
    worst, where = 0.0, ""
    for name, p in kernel.module.named_parameters():
        ref = grads_p[name]
        err = ((p.grad.float() - ref).norm() / max(ref.norm().item(), floor)).item()
        if not err < worst:
            worst, where = err, name
    check(f"{label} step-1 gradients, worst relative L2 error ({where})", worst, tol_grad)


def step_times(trainer, batch):
    """(wall ms per synchronous step, device busy ms per step, idle share),
    inputs on the card."""
    step = lambda: trainer.train_step(batch, HORIZON)
    wall = wall_ms(step)
    _, busy, _, _ = device_profile(step)
    return wall, busy, 1.0 - busy / wall


def phase_training(host_rng) -> dict:
    log("phase 7: training the full-width BRCA model through SurvivalTrainer.train_step")
    batch32 = train_batch(host_rng, torch.float32)
    k32 = brca_trainer(None, "flash", "auto")
    state = {k: v.clone() for k, v in k32.module.state_dict().items()}
    # f32: both paths in full f32 (no TF32), differing in summation order
    # only, and drawing the same dropout masks: tight
    compare_gradients("f32", k32, brca_trainer(None, "xla", "xla", state), batch32, 1e-5, 1e-4)
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
    launches = read_launches("the training run (5 steps, kernel path)", KERNELS)
    peak = torch.cuda.max_memory_allocated() / 2**20
    log(f"  losses of 5 steps: {losses}")
    if not all(np.isfinite(losses)):
        raise AssertionError("a training loss is not finite")

    plain_attention = brca_trainer(torch.bfloat16, "xla", "auto", state)
    t_wall, t_busy, t_idle = step_times(kernel, batch)
    x_wall, x_busy, x_idle = step_times(plain_attention, batch)
    log(f"  train step, batch {BATCH}, bf16, inputs on the card: wall {t_wall:.4f} ms per "
        f"synchronous step, {BATCH / t_wall * 1e3:.2f} samples/s; device busy {t_busy:.4f} ms "
        f"per step (profiler), idle share {t_idle:.4f}; peak memory {peak:.1f} MiB")
    log(f"  the same step with plain attention (attention_impl='xla'): wall {x_wall:.4f} ms, "
        f"device busy {x_busy:.4f} ms, idle share {x_idle:.4f}")
    return launches


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
    kernels = [phase_projection(gen), phase_flash(gen)]
    phase_serving(np.random.default_rng(0))
    kernels += [phase_flash_bwd(gen), phase_projection_bwd(gen)]
    launches = phase_training(np.random.default_rng(1))
    order = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
             "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = [{key: {**k, "launches": launches[k["name"]]}[key] for key in order}
               for k in kernels]
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
