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
5. print the kernels line, then the device line.

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

from healnet_tpu_torch.models.healnet import HealNetModule
from healnet_tpu_torch.ops import cuda_build
from healnet_tpu_torch.ops.attention import multihead_attention
from healnet_tpu_torch.ops.flash_attention import flash_attention_kernel
from healnet_tpu_torch.ops.fourier import positional_encoding
from healnet_tpu_torch.ops.fused_project import _prep, fused_project_kernel, project_plain
from healnet_tpu_torch.serving import Predictor

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


def time_ms(fn, reps: int = 20):
    """(device ms per call, wall ms per synchronous call).

    Device: the median of ``reps`` per-call CUDA-event timings, the calls
    queued back to back behind a sleep kernel with an event between each,
    so the host's launch cost is hidden as long as the queue stays ahead
    (a note is printed when it does not). Wall: median of single
    synchronised calls, launch cost included.
    """
    fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall = statistics.median(walls)
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

    fused_project_kernel.launches = 0
    flash_attention_kernel.launches = 0
    outs, seconds = {}, {}
    for name, call in requests.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs[name] = call(pred)
        seconds[name] = time.perf_counter() - t0
    launches = {"fused_project": fused_project_kernel.launches,
                "flash_attention": flash_attention_kernel.launches}
    log(f"  launches in the serving run: {launches}")
    for kname, count in launches.items():
        if count <= 0:
            raise AssertionError(f"the serving run never launched {kname}")

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
    launches = phase_serving(np.random.default_rng(0))
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
