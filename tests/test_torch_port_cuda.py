"""The port's CUDA kernels (forward and backward) against their plain
PyTorch versions, and the kernel path's gradients against the plain path's,
on the GPU.

These tests need an NVIDIA GPU and nvcc; without a GPU the ``gen`` fixture
skips them. On such a machine run them with

    python -m pytest --noconftest tests/test_torch_port_cuda.py

(``--noconftest``: the suite's conftest configures JAX, which the GPU
machine need not have). Tolerances: float32 kernels agree with the plain
version to the order of f32 rounding of sums taken in another order; bf16
kernels to a few bf16 ulps (the kernels round where the plain version does,
but sum in another order).
"""

import numpy as np
import pytest
import torch

from healnet_tpu_torch.models.healnet import HealNetModule
from healnet_tpu_torch.ops import QuantizedContext, quantize_context, quantize_context_host
from healnet_tpu_torch.ops.attention import multihead_attention
from healnet_tpu_torch.ops.flash_attention import (
    LAUNCH_COUNTERS,
    _wide_lib,
    flash_attention_bwd_kernel,
    flash_attention_kernel,
    flash_backward_plain,
    flash_cross_attention,
    flash_lse_plain,
    flash_panels,
    launch_counter,
    wide_smem,
)
from healnet_tpu_torch.ops.hash_dropout import dense_keep_mask
from healnet_tpu_torch.ops.fused_chain import (
    WEIGHT_FIELDS,
    ChainSpec,
    chain_launch_plan,
    chain_reference,
    fused_chain_kernel,
    fused_latent_chain,
    weight_shapes,
)
from healnet_tpu_torch.train.loop import SurvivalTrainer
from healnet_tpu_torch.ops.fused_project import (
    _prep,
    _project_launch,
    _project_plain,
    fused_kv_project,
    fused_project_bwd_kernel,
    fused_project_kernel,
    project_bwd_plain,
    project_generic_plan,
    project_plain,
    project_route,
)

# every launch counter of the projection forward's kernels
PROJECT_COUNTERS = ("launches", "launches_int8", "launches_generic", "launches_generic_split",
                    "launches_f32", "launches_f32_int8")


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.Generator(device="cuda").manual_seed(0)


def _bf16_tol(ref: torch.Tensor, ulps: int = 4) -> float:
    top = max(ref.float().abs().max().item(), 2.0**-126)
    return ulps * 2.0 ** (np.floor(np.log2(top)) - 7)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "b,t,c,f",
    [(2, 300, 200, 70), (3, 129, 203, 300), (8, 1, 64, 252)],
    ids=["ragged_rows", "two_column_blocks_unaligned_rows", "one_token"],
)
def test_projection_kernel_matches_plain(gen, dtype, b, t, c, f):
    dat = torch.randn((b, t, c), generator=gen, device="cuda").to(dtype)
    enc = torch.randn((t, 5), generator=gen, device="cuda").to(dtype)
    w_all = torch.randn((c + 5, f), generator=gen, device="cuda") * 0.05
    b_all = torch.randn((f,), generator=gen, device="cuda") * 0.1
    kv, s1, s2 = fused_project_kernel(dat, *_prep(dat, enc, w_all, b_all, dtype), c + 5, 1e-5)
    ref = project_plain(dat, enc, w_all, b_all)
    assert kv.dtype == dtype and kv.shape == (b, t, f)
    tol = 1e-4 if dtype == torch.float32 else _bf16_tol(ref)
    assert (kv.float() - ref.float()).abs().max().item() <= tol
    xf = torch.cat([dat.float(), enc.float().expand(b, t, 5)], dim=-1)
    torch.testing.assert_close(s1, xf.sum(-1), rtol=1e-5, atol=1e-3)
    torch.testing.assert_close(s2, (xf * xf).sum(-1), rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "b,t,c,f",
    [(2, 300, 200, 70), (3, 129, 203, 300), (8, 1, 64, 252)],
    ids=["ragged_rows", "two_column_blocks_unaligned_rows", "one_token"],
)
def test_projection_kernel_int8_matches_plain(gen, cdt, b, t, c, f):
    """The int8 branch in bf16 and f32 compute. kv: as the bf16/f32 cases
    (the integer sum of q^2 is exact where the plain version's f32 sum is
    not, which moves inv in its last bits); s1 equal up to f32 rounding of
    the scale product, s2 to 1e-6 relative."""
    qc = quantize_context(torch.randn((b, t, c), generator=gen, device="cuda") * 3)
    qc.scale[0, 0] = 0.0  # a zero row
    qc.data[0, 0] = 0
    enc = torch.randn((t, 5), generator=gen, device="cuda").to(cdt)
    w_all = torch.randn((c + 5, f), generator=gen, device="cuda") * 0.05
    b_all = torch.randn((f,), generator=gen, device="cuda") * 0.1
    # the Hopper kernel's int8 variant, the f32 kernel's (f32 compute), or
    # the generic route's kernel (int8 rows off 16 bytes)
    route = project_route(qc.data.dtype, cdt, c, qc.data.data_ptr())
    counter = {"tma": "launches_int8", "f32": "launches_f32_int8"}.get(
        route, project_generic_plan(b * t, c, f, 1).counter)
    setattr(fused_project_kernel, counter, 0)
    kv, s1, s2 = fused_project_kernel(qc.data, *_prep(qc.data, enc, w_all, b_all, cdt), c + 5,
                                      1e-5, scale=qc.scale)
    assert getattr(fused_project_kernel, counter) == 1
    ref = project_plain(qc.data, enc, w_all, b_all, scale=qc.scale, out_dtype=cdt)
    assert kv.dtype == cdt and kv.shape == (b, t, f)
    tol = 1e-4 if cdt == torch.float32 else _bf16_tol(ref)
    assert (kv.float() - ref.float()).abs().max().item() <= tol
    xq = qc.data.float()
    ef = enc.float().expand(b, t, 5)
    torch.testing.assert_close(s1, qc.scale * xq.sum(-1) + ef.sum(-1), rtol=1e-6, atol=1e-5)
    torch.testing.assert_close(s2, qc.scale * qc.scale * (xq * xq).sum(-1) + (ef * ef).sum(-1),
                               rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_bsum", [True, False], ids=["bsum", "no_bsum"])
@pytest.mark.parametrize("b,t,f", [(2, 300, 70), (8, 129, 300), (200, 3, 20)],
                         ids=["ragged_rows", "wide", "batch_over_a_block"])
def test_projection_bwd_kernel_scale_matches_plain(gen, dtype, with_bsum, b, t, f):
    g = torch.randn((b, t, f), generator=gen, device="cuda").to(dtype)
    x = torch.randn((b, t, 40), generator=gen, device="cuda") * 2 + 0.5
    s1, s2 = x.sum(-1), (x * x).sum(-1)
    scale = torch.rand((b, t), generator=gen, device="cuda") * 0.05
    fused_project_bwd_kernel.launches_int8 = 0
    got = fused_project_bwd_kernel(g, s1, s2, 40, 1e-5, scale=scale, with_bsum=with_bsum)
    assert fused_project_bwd_kernel.launches_int8 == 1
    ref = project_bwd_plain(g, s1, s2, 40, 1e-5, scale=scale, with_bsum=with_bsum)
    assert len(got) == len(ref) == (3 if with_bsum else 2)
    tol = 1e-6 if dtype == torch.float32 else _bf16_tol(ref[0], ulps=1)
    assert (got[0].float() - ref[0].float()).abs().max().item() <= tol
    torch.testing.assert_close(got[1], ref[1], rtol=1e-5, atol=1e-4)
    if with_bsum:
        # sums over the batch of terms rounded at the same place; a term may
        # round one bf16 ulp apart (rsqrtf vs torch's rsqrt): b ulps of the
        # largest term round(inv * g)
        terms = project_bwd_plain(g, s1, s2, 40, 1e-5)[0]
        atol = 1e-5 if dtype == torch.float32 else b * _bf16_tol(terms, ulps=1)
        torch.testing.assert_close(got[2], ref[2], rtol=1e-5, atol=atol)


@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16])
def test_projection_function_int8_grads_match_plain_autograd(gen, cdt):
    """w, bias and scale gradients through the int8 kernels (forward, the
    scaled cotangent pass with its batch-sum, the d_W GEMM on the int8
    values cast to the compute dtype) against the plain path's autograd."""
    qc = quantize_context(torch.randn((2, 300, 64), generator=gen, device="cuda"))
    enc = torch.randn((300, 5), generator=gen, device="cuda").to(cdt)
    w = (torch.randn((69, 70), generator=gen, device="cuda") * 0.05).requires_grad_()
    bias = torch.randn((70,), generator=gen, device="cuda", requires_grad=True)
    scale = qc.scale.clone().requires_grad_()
    g = torch.randn((2, 300, 70), generator=gen, device="cuda").to(cdt)
    inputs = (w, bias, scale)
    fused_project_bwd_kernel.launches_int8 = 0
    got = torch.autograd.grad(fused_kv_project(QuantizedContext(qc.data, scale), enc, w, bias,
                                               out_dtype=cdt), inputs, g)
    assert fused_project_bwd_kernel.launches_int8 == 1
    ref = torch.autograd.grad(project_plain(qc.data, enc, w, bias, scale=scale, out_dtype=cdt),
                              inputs, g)
    for name, a, r in zip(("w", "bias", "scale"), got, ref):
        # bf16: the plain path's autograd differentiates through its bf16
        # roundings, the kernel path's formulas do not: 2% of the largest
        rel = 1e-4 if cdt == torch.float32 else 2e-2
        torch.testing.assert_close(a, r, rtol=rel, atol=rel * r.abs().max().item(), msg=name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "b,h,lq,lkv,d,rate",
    [(2, 1, 17, 1000, 63, 0.0), (2, 1, 17, 1000, 63, 0.3), (3, 8, 17, 17, 20, 0.0),
     (1, 2, 1, 33, 27, 0.5)],
    ids=["cross", "cross_dropout", "self_8_heads", "one_query"],
)
def test_flash_kernel_matches_plain(gen, dtype, b, h, lq, lkv, d, rate):
    q = torch.randn((b, lq, h * d), generator=gen, device="cuda").to(dtype)
    kv = torch.randn((b, lkv, 2 * h * d + 3), generator=gen, device="cuda").to(dtype)
    split = lambda x: x.reshape(x.shape[0], x.shape[1], h, d).transpose(1, 2)
    qh, kh, vh = split(q), split(kv[..., 3:3 + h * d]), split(kv[..., 3 + h * d:])
    mask = torch.rand((b, lkv), generator=gen, device="cuda") > 0.3
    mask[0] = False  # a fully masked row outputs zero
    out, lse = flash_attention_kernel(qh, kh, vh, mask, d**-0.5 / 0.5, rate, 1234)
    ref, _ = multihead_attention(qh.float(), kh.float(), vh.float(), scale=d**-0.5,
                                 kv_mask=mask, dropout_rate=rate, dropout_seed=1234)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    assert (out.float() - ref).abs().max().item() <= tol
    assert out[0].abs().max().item() == 0.0
    assert lse.shape == (b, h, lq) and torch.isfinite(lse[1:]).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "b,h,lq,lkv,d,rate",
    [(2, 1, 17, 1000, 63, 0.0), (2, 1, 17, 1000, 63, 0.3), (3, 8, 17, 17, 20, 0.0),
     (8, 1, 17, 1, 63, 0.083)],
    ids=["cross", "cross_dropout", "self_8_heads", "one_key"],
)
def test_flash_bwd_kernel_matches_plain(gen, dtype, b, h, lq, lkv, d, rate):
    q = torch.randn((b, lq, h * d), generator=gen, device="cuda").to(dtype)
    kv = torch.randn((b, lkv, 2 * h * d + 3), generator=gen, device="cuda").to(dtype)
    split = lambda x: x.reshape(x.shape[0], x.shape[1], h, d).transpose(1, 2)
    qh, kh, vh = split(q), split(kv[..., 3:3 + h * d]), split(kv[..., 3 + h * d:])
    mask = torch.rand((b, lkv), generator=gen, device="cuda") > 0.3
    mask[:, 0] = True
    mask[0] = False  # a fully masked row gets zero gradients
    scale = d**-0.5 / 0.5
    out, lse = flash_attention_kernel(qh, kh, vh, mask, scale, rate, 99)
    do = torch.randn((b, lq, h * d), generator=gen, device="cuda").to(dtype)
    delta = (do.float() * out.float()).reshape(b, lq, h, d).sum(-1).transpose(1, 2)
    doh = split(do)
    got = flash_attention_bwd_kernel(qh, kh, vh, mask, doh, lse, delta, scale, rate, 99)
    ref = flash_backward_plain(qh, kh, vh, mask, doh, lse, delta, scale, rate, 99)
    for name, a, r in zip(("dq", "dk", "dv"), got, ref):
        assert a.dtype == dtype and a.shape == r.shape, name
        # f32: sums in another order; bf16: both round p and ds to bf16 at
        # the same places, so a few ulps of the largest gradient
        tol = (1e-5 * max(1.0, r.abs().max().item()) if dtype == torch.float32
               else _bf16_tol(r))
        assert (a.float() - r.float()).abs().max().item() <= tol, name
    assert got[0][0].abs().max().item() == 0.0
    assert got[1][0].abs().max().item() == 0.0 and got[2][0].abs().max().item() == 0.0


def _odd_pitch_case(gen, b, h, lq, lkv, d):
    """bf16 q (b, h, lq, d) and k/v as head-split column slices of a merged
    KV buffer of width 2 h d + 3 (an odd pitch: rows alternate between 2-
    and 4-byte alignment), a random mask with row 0 fully masked."""
    q = torch.randn((b, lq, h * d), generator=gen, device="cuda").to(torch.bfloat16)
    kv = torch.randn((b, lkv, 2 * h * d + 3), generator=gen, device="cuda").to(torch.bfloat16)
    split = lambda x: x.reshape(x.shape[0], x.shape[1], h, d).transpose(1, 2)
    mask = torch.rand((b, lkv), generator=gen, device="cuda") > 0.3
    mask[0] = False
    return split(q), split(kv[..., 3:3 + h * d]), split(kv[..., 3 + h * d:]), mask, split


@pytest.mark.parametrize("h", [1, 8])
@pytest.mark.parametrize("lkv", [1, 17, 1000, 4096, 8192])
@pytest.mark.parametrize("lq", [1, 17, 33])
@pytest.mark.parametrize("d", [63, 27, 20, 113, 128])
def test_flash_tc_kernels_match_plain(gen, d, lq, lkv, h):
    """The tensor-core variants (bf16, d <= 128) forward and backward on
    the odd-pitch KV layout, masked with a fully masked row, dropout 0.2:
    the forward to 2e-2 of the f32 plain version (p rounds to bf16 before
    @V), the backward to 4 ulps of the largest gradient (p e and ds round
    to bf16 at the same places, sums run in another order)."""
    b, rate, seed = 2, 0.2, 4321
    qh, kh, vh, mask, split = _odd_pitch_case(gen, b, h, lq, lkv, d)
    eff = d**-0.5 / 0.5
    flash_attention_kernel.launches = flash_attention_bwd_kernel.launches = 0
    out, lse = flash_attention_kernel(qh, kh, vh, mask, eff, rate, seed)
    ref, _ = multihead_attention(qh.float(), kh.float(), vh.float(), scale=d**-0.5,
                                 kv_mask=mask, dropout_rate=rate, dropout_seed=seed)
    assert (out.float() - ref).abs().max().item() <= 2e-2
    assert out[0].abs().max().item() == 0.0
    do = torch.randn((b, lq, h * d), generator=gen, device="cuda").to(torch.bfloat16)
    delta = (do.float() * out.float()).reshape(b, lq, h, d).sum(-1).transpose(1, 2)
    got = flash_attention_bwd_kernel(qh, kh, vh, mask, split(do), lse, delta, eff, rate, seed)
    want = flash_backward_plain(qh, kh, vh, mask, split(do), lse, delta, eff, rate, seed)
    assert flash_attention_kernel.launches == 1 and flash_attention_bwd_kernel.launches == 1
    for name, a, r in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.bfloat16 and a.shape == r.shape, name
        assert (a.float() - r.float()).abs().max().item() <= _bf16_tol(r), name
        assert a[0].abs().max().item() == 0.0, name


def test_flash_tc_calls_are_bit_identical(gen):
    """No float atomics: two calls give the same bits (brca's shape)."""
    qh, kh, vh, mask, split = _odd_pitch_case(gen, 8, 1, 17, 4096, 63)
    do = split(torch.randn((8, 17, 63), generator=gen, device="cuda").to(torch.bfloat16))
    args = (qh, kh, vh, mask, 63**-0.5 / 0.5, 0.083, 99)
    out1, lse1 = flash_attention_kernel(*args)
    out2, lse2 = flash_attention_kernel(*args)
    assert torch.equal(out1, out2) and torch.equal(lse1, lse2)
    delta = (do.float() * split(out1).float()).sum(-1)
    g1 = flash_attention_bwd_kernel(qh, kh, vh, mask, do, lse1, delta, *args[4:])
    g2 = flash_attention_bwd_kernel(qh, kh, vh, mask, do, lse1, delta, *args[4:])
    assert all(torch.equal(a, b) for a, b in zip(g1, g2))


@pytest.mark.parametrize("dtype,d,variant", [(torch.float32, 63, "launches_fma"),
                                             (torch.bfloat16, 160, "launches_fma"),
                                             (torch.bfloat16, 128, "launches"),
                                             (torch.bfloat16, 63, "launches")])
def test_flash_variant_counters(gen, dtype, d, variant):
    """f32 and bf16 d > 128 take the FMA variant, bf16 d <= 128 the tensor
    cores; each wrapper counts the variant it launched, and only that."""
    q = torch.randn((2, 1, 17, d), generator=gen, device="cuda").to(dtype)
    k = torch.randn((2, 1, 300, d), generator=gen, device="cuda").to(dtype)
    for fn in (flash_attention_kernel, flash_attention_bwd_kernel):
        fn.launches = fn.launches_fma = 0
    out, lse = flash_attention_kernel(q, k, k, None, 0.1)
    delta = torch.zeros((2, 1, 17), device="cuda")
    flash_attention_bwd_kernel(q, k, k, None, q, lse, delta, 0.1)
    other = "launches" if variant == "launches_fma" else "launches_fma"
    for fn in (flash_attention_kernel, flash_attention_bwd_kernel):
        assert getattr(fn, variant) == 1 and getattr(fn, other) == 0, fn.__name__


@pytest.mark.parametrize("d,width,rate", [(63, 252, 0.083), (27, 270, 0.318)],
                         ids=["brca", "kirp"])
def test_flash_fma_kernels_full_size(gen, d, width, rate):
    """The FMA variants at the model's full f32 size, (8, 17, 4096, d) with
    K and V as column slices of the merged KV buffer (brca: pitch 252, V at
    element 63; kirp: pitch 270), masked with a fully masked sample, the
    row's dropout: one launch a call each (``launches_fma``), the forward to
    2e-5 of the plain version, the backward to 1e-5 of the largest gradient,
    and two calls bit-identical."""
    b, lq, lkv, seed = 8, 17, 4096, 2024
    q = torch.randn((b, lq, d), generator=gen, device="cuda")[:, None]
    kv = torch.randn((b, lkv, width), generator=gen, device="cuda")
    k, v = kv[..., d:2 * d][:, None], kv[..., 2 * d:3 * d][:, None]
    lengths = torch.randint(1, lkv, (b,), generator=gen, device="cuda")
    lengths[0] = 0
    mask = torch.arange(lkv, device="cuda")[None, :] < lengths[:, None]
    eff = d**-0.5 / 0.5
    for fn in (flash_attention_kernel, flash_attention_bwd_kernel):
        fn.launches = fn.launches_fma = 0
    out, lse = flash_attention_kernel(q, k, v, mask, eff, rate, seed)
    assert flash_attention_kernel.launches_fma == 1 and flash_attention_kernel.launches == 0
    ref, _ = multihead_attention(q, k, v, scale=d**-0.5, kv_mask=mask, dropout_rate=rate,
                                 dropout_seed=seed)
    assert (out - ref).abs().max().item() <= 2e-5
    assert out[0].abs().max().item() == 0.0
    assert torch.equal(flash_attention_kernel(q, k, v, mask, eff, rate, seed)[0], out)
    do = torch.randn((b, lq, d), generator=gen, device="cuda")[:, None]
    delta = (do * out.reshape(b, 1, lq, d)).sum(-1)
    got = flash_attention_bwd_kernel(q, k, v, mask, do, lse, delta, eff, rate, seed)
    assert flash_attention_bwd_kernel.launches_fma == 1 and flash_attention_bwd_kernel.launches == 0
    want = flash_backward_plain(q, k, v, mask, do, lse, delta, eff, rate, seed)
    again = flash_attention_bwd_kernel(q, k, v, mask, do, lse, delta, eff, rate, seed)
    for name, a, r, a2 in zip(("dq", "dk", "dv"), got, want, again):
        assert (a - r).abs().max().item() <= 1e-5 * max(1.0, r.abs().max().item()), name
        assert a[0].abs().max().item() == 0.0 and torch.equal(a, a2), name


# (head dim, KV buffer width or None for 4 d): the one-pass wide kernels
# at 257-512, the panel kernels past them (513, 576 and 1000 in two panels,
# three for 1000 in the bf16 backward; 3100 past one pass: four panels in
# each of two passes), and rows at odd 2-byte (bf16) or 4-byte (f32)
# offsets, whose 16-byte hulls the ring shifts into place
WIDE_HEADS = [(257, None), (320, None), (512, None), (513, None), (320, 1283), (576, None),
              (1000, None), (576, 2307), (3100, None)]


@pytest.mark.parametrize("lkv", [1000, 1])
@pytest.mark.parametrize("lq", [17, 40])
@pytest.mark.parametrize("d,width", WIDE_HEADS, ids=["257", "320", "512", "513", "320-pitch1283",
                                                     "576", "1000", "576-pitch2307", "3100"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_fma_kernels_wide_heads(gen, dtype, d, width, lq, lkv):
    """Heads wider than 256: K and V as column slices of a merged KV buffer
    (width 4 d unless given), masked with a fully masked sample, dropout
    0.083; one launch a call each, counted by the kernel's own counter
    (``launches_wide_fma`` / ``launches_wide_tc`` for the one-pass kernels
    up to 512, ``launches_panel_fma`` / ``launches_panel_tc`` past them), the
    forward to 2e-5
    (f32) or 4 bf16 ulps of the plain version, the backward to 1e-5 of the
    largest gradient or 4 ulps, two calls bit-identical; lq 40 takes two
    query groups (and two chunks where the backward holds 32 queries or
    fewer). The f32 backward is held against the plain version in f64 (with
    its log-sum-exp and delta in f64), as ``chip_smoke.py`` holds every
    flash call of its steps: at d 3100 the plain version's own f32 sums lie
    farther from f64 than the kernel's. lkv 1 (the omic context) is
    one partial key tile on a cluster of 1; there p = 1, so dq and dk are
    the f32 rounding residue of dp * e - delta, terms of dv's size, and f32
    holds them to 1e-5 of the call's largest gradient (dv's)."""
    b, rate, seed = 3, 0.083, 77
    q = torch.randn((b, lq, d), generator=gen, device="cuda").to(dtype)[:, None]
    kv = torch.randn((b, lkv, width or 4 * d), generator=gen, device="cuda").to(dtype)
    k, v = kv[..., d:2 * d][:, None], kv[..., 2 * d:3 * d][:, None]
    mask = torch.arange(lkv, device="cuda")[None, :] < torch.tensor([[0], [777], [1000]],
                                                                     device="cuda")
    eff = d**-0.5 / 0.5
    counters = LAUNCH_COUNTERS
    for fn in (flash_attention_kernel, flash_attention_bwd_kernel):
        for name in counters:
            setattr(fn, name, 0)
    out, lse = flash_attention_kernel(q, k, v, mask, eff, rate, seed)
    ref, _ = multihead_attention(q.float(), k.float(), v.float(), scale=d**-0.5, kv_mask=mask,
                                 dropout_rate=rate, dropout_seed=seed)
    tol = 2e-5 if dtype == torch.float32 else _bf16_tol(ref)
    assert (out.float() - ref).abs().max().item() <= tol
    assert out[0].abs().max().item() == 0.0
    assert torch.equal(flash_attention_kernel(q, k, v, mask, eff, rate, seed)[0], out)
    do = torch.randn((b, lq, d), generator=gen, device="cuda").to(dtype)[:, None]
    delta = (do.float() * out.float().reshape(b, 1, lq, d)).sum(-1)
    got = flash_attention_bwd_kernel(q, k, v, mask, do, lse, delta, eff, rate, seed)
    if dtype == torch.float32:
        q64, k64, v64, do64 = (x.double() for x in (q, k, v, do))
        want = flash_backward_plain(
            q64, k64, v64, mask, do64, flash_lse_plain(q64, k64, mask, eff),
            (do64 * out.double().reshape(b, 1, lq, d)).sum(-1), eff, rate, seed)
    else:
        want = flash_backward_plain(q, k, v, mask, do, lse, delta, eff, rate, seed)
    again = flash_attention_bwd_kernel(q, k, v, mask, do, lse, delta, eff, rate, seed)
    largest = max(r.double().abs().max().item() for r in want)
    for name, a, r, a2 in zip(("dq", "dk", "dv"), got, want, again):
        top = largest if lkv == 1 else r.double().abs().max().item()
        tol = 1e-5 * max(1.0, top) if dtype == torch.float32 else _bf16_tol(r)
        assert (a.double() - r.double()).abs().max().item() <= tol, name
        assert a[0].abs().max().item() == 0.0 and torch.equal(a, a2), name
    moved = launch_counter(dtype, d)
    for fn in (flash_attention_kernel, flash_attention_bwd_kernel):
        assert {name: getattr(fn, name) for name in counters} == {
            name: 2 if name == moved else 0 for name in counters}, fn.__name__


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [320, 512, 513, 576, 1000, 3072, 3100, 8200])
def test_flash_wide_smem_matches_plan(gen, dtype, d):
    """The wide and panel kernels' shared memory at (panels, passes) of
    ``flash_panels``, forward and backward (at the library's largest query
    chunk and at 1 and 16 rows), is what ``wide_smem`` reckons from the
    layouts, and fits the card."""
    bf, lib = int(dtype == torch.bfloat16), _wide_lib()
    align = 16 if bf else 32
    for bwd in (False, True):
        pan = flash_panels(dtype, d, backward=bwd)
        dp = -(-max(w for _, w in pan.columns) // align) * align
        panels = pan.count if pan.count * pan.passes > 1 else 1
        if not bwd:
            assert lib.healnet_flash_wide_smem(d, bf, pan.count, pan.passes, 0, 0) == wide_smem(
                dtype, dp, panels)[2] > 0
            continue
        top = lib.healnet_flash_wide_bwd_max_queries(d, bf, pan.count, pan.passes)
        for rows in {top, 16} if bf else {top, 16, 1}:
            assert lib.healnet_flash_wide_smem(d, bf, pan.count, pan.passes, 1, rows) == wide_smem(
                dtype, dp, panels, rows)[2] > 0, rows


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,f", [(2, 300, 70), (3, 129, 300), (8, 1, 252)],
                         ids=["ragged_rows", "wide", "one_token"])
def test_projection_bwd_kernel_matches_plain(gen, dtype, b, t, f):
    g = torch.randn((b, t, f), generator=gen, device="cuda").to(dtype)
    x = torch.randn((b, t, 40), generator=gen, device="cuda") * 2 + 0.5
    s1, s2 = x.sum(-1), (x * x).sum(-1)
    d_raw, dsum2 = fused_project_bwd_kernel(g, s1, s2, 40, 1e-5)
    ref_raw, ref_sum = project_bwd_plain(g, s1, s2, 40, 1e-5)
    assert d_raw.dtype == dtype and dsum2.shape == (2, f)
    tol = 1e-6 if dtype == torch.float32 else _bf16_tol(ref_raw, ulps=1)
    assert (d_raw.float() - ref_raw.float()).abs().max().item() <= tol
    torch.testing.assert_close(dsum2, ref_sum, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("rate", [0.0, 0.3])
def test_flash_function_grads_match_plain_autograd(gen, rate):
    q = torch.randn((2, 2, 17, 20), generator=gen, device="cuda", requires_grad=True)
    k = torch.randn((2, 2, 500, 20), generator=gen, device="cuda", requires_grad=True)
    v = torch.randn((2, 2, 500, 20), generator=gen, device="cuda", requires_grad=True)
    mask = torch.rand((2, 500), generator=gen, device="cuda") > 0.3
    g = torch.randn((2, 17, 40), generator=gen, device="cuda")
    kw = dict(scale=20**-0.5, kv_mask=mask, dropout_rate=rate, dropout_seed=7)
    got = torch.autograd.grad(flash_cross_attention(q, k, v, **kw), (q, k, v), g)
    ref = torch.autograd.grad(multihead_attention(q, k, v, **kw)[0], (q, k, v), g)
    for a, r in zip(got, ref):
        torch.testing.assert_close(a, r, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("enc_on", [True, False])
def test_projection_function_grads_match_plain_autograd(gen, enc_on):
    dat = torch.randn((2, 300, 64), generator=gen, device="cuda", requires_grad=True)
    enc = torch.randn((300, 5), generator=gen, device="cuda", requires_grad=True) if enc_on else None
    w = (torch.randn((64 + (5 if enc_on else 0), 70), generator=gen, device="cuda") * 0.05
         ).requires_grad_()
    bias = torch.randn((70,), generator=gen, device="cuda", requires_grad=True)
    g = torch.randn((2, 300, 70), generator=gen, device="cuda")
    inputs = [x for x in (dat, enc, w, bias) if x is not None]
    got = torch.autograd.grad(fused_kv_project(dat, enc, w, bias, impl="auto"), inputs, g)
    ref = torch.autograd.grad(project_plain(dat, enc, w, bias), inputs, g)
    for a, r in zip(got, ref):
        torch.testing.assert_close(a, r, rtol=1e-4, atol=1e-4)


def test_model_kernel_path_matches_plain_path(gen):
    cfg = dict(n_modalities=2, channel_dims=(40, 24), num_spatial_axes=(1, 1), out_dims=4,
               depth=2, l_c=17, l_d=32, x_heads=1, cross_dim_head=15, l_heads=2,
               latent_dim_head=8, self_per_cross_attn=1, max_freq=2.0)
    kernel = HealNetModule(**cfg, attention_impl="flash", projection_impl="auto",
                           device="cuda", generator=torch.Generator().manual_seed(0)).eval()
    plain = HealNetModule(**cfg, attention_impl="xla", projection_impl="xla",
                          device="cuda", generator=torch.Generator().manual_seed(0)).eval()
    x = [torch.randn((3, 1, 40), generator=gen, device="cuda"),
         torch.randn((3, 200, 24), generator=gen, device="cuda")]
    mask = torch.rand((3, 200), generator=gen, device="cuda") > 0.2
    fused_project_kernel.launches_f32 = flash_attention_kernel.launches = 0
    flash_attention_kernel.launches_fma = 0
    with torch.inference_mode():
        got = kernel(x, kv_masks=[None, mask])
        ref = plain(x, kv_masks=[None, mask])
    # one merged projection per modality, f32: the f32 kernel
    assert fused_project_kernel.launches_f32 == 2
    # f32: 2 layers x 2 modalities x (cross + self) on the FMA variant
    assert flash_attention_kernel.launches_fma == 8 and flash_attention_kernel.launches == 0
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("rate", [0.0, 0.2], ids=["no_dropout", "dropout"])
def test_model_kernel_path_grads_match_plain_path(gen, rate):
    """Parameter gradients through both kernels' backwards against the
    plain path's autograd, same weights and same dropout draws (f32)."""
    cfg = dict(n_modalities=2, channel_dims=(40, 24), num_spatial_axes=(1, 1), out_dims=4,
               depth=2, l_c=17, l_d=32, x_heads=1, cross_dim_head=15, l_heads=2,
               latent_dim_head=8, self_per_cross_attn=1, max_freq=2.0,
               attn_dropout=rate, ff_dropout=rate)
    models = [HealNetModule(**cfg, attention_impl=a, projection_impl=p, device="cuda",
                            generator=torch.Generator().manual_seed(0)).train()
              for a, p in (("flash", "auto"), ("xla", "xla"))]
    x = [torch.randn((3, 1, 40), generator=gen, device="cuda"),
         torch.randn((3, 200, 24), generator=gen, device="cuda")]
    mask = torch.rand((3, 200), generator=gen, device="cuda") > 0.2
    fused_project_bwd_kernel.launches = flash_attention_bwd_kernel.launches_fma = 0
    grads = []
    for model in models:
        gens = dict(generator=torch.Generator(device="cuda").manual_seed(5),
                    seed_generator=torch.Generator().manual_seed(6))
        model(x, kv_masks=[None, mask], **gens).square().sum().backward()
        grads.append({n: p.grad for n, p in model.named_parameters()})
    assert fused_project_bwd_kernel.launches == 2
    assert flash_attention_bwd_kernel.launches_fma == 8  # f32: the FMA variant
    for name, ref in grads[1].items():
        got = grads[0][name]
        assert got is not None and ref is not None, name
        torch.testing.assert_close(got, ref, rtol=1e-3, atol=1e-5, msg=name)


def test_model_int8_slide_kernel_path_matches_plain_path(gen):
    """A quantized slide through the model: the int8 branch of the
    projection on the slide, the f32 one on the omic vector (both on the
    f32 kernel), logits against the plain path (f32)."""
    cfg = dict(n_modalities=2, channel_dims=(40, 24), num_spatial_axes=(1, 1), out_dims=4,
               depth=2, l_c=17, l_d=32, x_heads=1, cross_dim_head=15, l_heads=2,
               latent_dim_head=8, self_per_cross_attn=0, max_freq=2.0)
    kernel, plain = (HealNetModule(**cfg, attention_impl=a, projection_impl=p, device="cuda",
                                   generator=torch.Generator().manual_seed(0)).eval()
                     for a, p in (("flash", "auto"), ("xla", "xla")))
    x = [torch.randn((3, 1, 40), generator=gen, device="cuda"),
         quantize_context(torch.randn((3, 200, 24), generator=gen, device="cuda"))]
    for name in ("launches_f32", "launches_f32_int8", "launches_int8"):
        setattr(fused_project_kernel, name, 0)
    with torch.inference_mode():
        got, ref = kernel(x), plain(x)
    assert fused_project_kernel.launches_f32 == fused_project_kernel.launches_f32_int8 == 1
    assert fused_project_kernel.launches_int8 == 0
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-5)


def test_wrappers_refuse_what_the_kernels_do_not_take(gen):
    q = torch.randn((1, 1, 4, 8), generator=gen, device="cuda").half()
    with pytest.raises(TypeError):
        flash_attention_kernel(q, q, q, None, 1.0)
    k = torch.randn((1, 1, 8, 4), generator=gen, device="cuda").transpose(2, 3)
    with pytest.raises(ValueError):
        flash_attention_kernel(q.float(), k, k, None, 1.0)
    dat = torch.randn((1, 4, 8), generator=gen, device="cuda")
    with pytest.raises(ValueError):
        flash_attention_bwd_kernel(q.float(), q.float(), q.float(), None, q.float()[..., :2],
                                   torch.zeros((1, 1, 4), device="cuda"),
                                   torch.zeros((1, 1, 4), device="cuda"), 1.0)
    with pytest.raises(TypeError):
        fused_project_bwd_kernel(torch.zeros((1, 4, 3), device="cuda", dtype=torch.half),
                                 torch.zeros((1, 4), device="cuda"),
                                 torch.zeros((1, 4), device="cuda"), 8)
    with pytest.raises(ValueError):
        fused_project_kernel(dat, torch.zeros((8, 3), device="cuda"),
                             torch.zeros((4, 2), device="cuda"),
                             torch.zeros((2, 4), device="cuda"),
                             torch.zeros((2, 3), device="cuda"), 8, 1e-5)
    q = torch.zeros((1, 4, 8), device="cuda", dtype=torch.int8)
    ops = (torch.zeros((8, 3), device="cuda"), torch.zeros((4, 3), device="cuda"),
           torch.zeros((2, 4), device="cuda"), torch.zeros((2, 3), device="cuda"), 8, 1e-5)
    with pytest.raises(ValueError):  # int8 without its scale
        fused_project_kernel(q, *ops)
    with pytest.raises(ValueError):  # a scale with a float context
        fused_project_kernel(dat, *ops, scale=torch.zeros((1, 4), device="cuda"))
    with pytest.raises(ValueError):  # the scale's shape
        fused_project_kernel(q, *ops, scale=torch.zeros((4,), device="cuda"))


# ------------------------------------------------ the Hopper projection kernel


def _tma_case(gen, b, t, c, f, kind):
    """A bf16 or int8 context (per-token scales, one zero row) with the
    encoding, the Hopper kernel's operands, and the plain version's
    ``(kv, s1, s2)``."""
    x = torch.randn((b, t, c), generator=gen, device="cuda")
    scale = None
    if kind == "int8":
        qc = quantize_context(x * 3)
        qc.scale[0, 0] = 0.0
        qc.data[0, 0] = 0
        dat, scale = qc.data, qc.scale
    else:
        dat = x.to(torch.bfloat16)
    enc = torch.randn((t, 5), generator=gen, device="cuda").to(torch.bfloat16)
    w_all = torch.randn((c + 5, f), generator=gen, device="cuda") * 0.02
    b_all = torch.randn((f,), generator=gen, device="cuda") * 0.1
    ops = _prep(dat, enc, w_all, b_all, torch.bfloat16)
    ref = _project_plain(dat, enc, w_all, b_all, 1e-5, scale, torch.bfloat16)
    return dat, scale, ops, ref


def _check_projection(got, ref, kind):
    """kv within 4 bf16 ulps of the largest output (the product rounds at
    the same places, summed in another order); s1, s2 as the int8 branch's
    contract (exact integer sums against the plain version's f32 sums) or
    f32 sums of the same values in another order."""
    (kv, s1, s2), (r, r1, r2) = got, ref
    assert kv.dtype == torch.bfloat16 and kv.shape == r.shape
    assert (kv.float() - r.float()).abs().max().item() <= _bf16_tol(r)
    if kind == "int8":
        assert ((s1 - r1).abs().max() / r1.abs().max()).item() <= 1e-6
        assert ((s2 - r2).abs().max() / r2.abs().max()).item() <= 2e-6
    else:
        torch.testing.assert_close(s1, r1, rtol=1e-5, atol=1e-3)
        torch.testing.assert_close(s2, r2, rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("kind", ["bf16", "int8"])
@pytest.mark.parametrize("b,t", [(3, 700), (8, 1)], ids=["ragged_rows", "one_token"])
@pytest.mark.parametrize("f", [252, 270, 300, 71])
@pytest.mark.parametrize("c", [2000, 2048, 1024])
def test_projection_tma_kernel_matches_plain(gen, c, f, b, t, kind):
    """The Hopper kernel at the model's widths (brca / trimodal F 252, kirp
    270), at 300 (two column passes) and at an odd 71, with rows that are
    not a multiple of the 128-row tile and one-token contexts: one launch of
    the variant."""
    dat, scale, ops, ref = _tma_case(gen, b, t, c, f, kind)
    assert project_route(dat.dtype, torch.bfloat16, c, dat.data_ptr()) == "tma"
    counter = "launches_int8" if kind == "int8" else "launches"
    for name in ("launches", "launches_int8", "launches_generic"):
        setattr(fused_project_kernel, name, 0)
    got = fused_project_kernel(dat, *ops, c + 5, 1e-5, scale=scale)
    assert getattr(fused_project_kernel, counter) == 1
    assert fused_project_kernel.launches + fused_project_kernel.launches_int8 == 1
    assert fused_project_kernel.launches_generic == 0
    _check_projection(got, ref, kind)


@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_projection_tma_calls_are_bit_identical(gen, kind):
    """No atomics, no order that changes between calls: the same bits."""
    dat, scale, ops, _ = _tma_case(gen, 4, 1000, 2048, 270, kind)
    one = fused_project_kernel(dat, *ops, 2053, 1e-5, scale=scale)
    two = fused_project_kernel(dat, *ops, 2053, 1e-5, scale=scale)
    assert all(torch.equal(a, b) for a, b in zip(one, two))


@pytest.mark.parametrize("case", ["misaligned_view", "c_203"])
def test_projection_generic_route(gen, case):
    """bf16 rows TMA cannot describe take the generic route, at 600 rows
    its Hopper kernel's hull kinds (``launches_generic``): a contiguous view
    2 bytes off 16, and C = 203."""
    c = 2048 if case == "misaligned_view" else 203
    b, t = 2, 300
    if case == "misaligned_view":
        buf = torch.randn((b * t * c + 8,), generator=gen, device="cuda").to(torch.bfloat16)
        dat = buf[1:1 + b * t * c].view(b, t, c)
    else:
        dat = torch.randn((b, t, c), generator=gen, device="cuda").to(torch.bfloat16)
    assert project_route(dat.dtype, torch.bfloat16, c, dat.data_ptr()) == "generic"
    enc = torch.randn((t, 5), generator=gen, device="cuda").to(torch.bfloat16)
    w_all = torch.randn((c + 5, 252), generator=gen, device="cuda") * 0.02
    b_all = torch.randn((252,), generator=gen, device="cuda") * 0.1
    for name in PROJECT_COUNTERS:
        setattr(fused_project_kernel, name, 0)
    got = fused_project_kernel(dat, *_prep(dat, enc, w_all, b_all, torch.bfloat16), c + 5, 1e-5)
    assert project_generic_plan(b * t, c, 252, 2).counter == "launches_generic"
    assert fused_project_kernel.launches_generic == 1
    assert sum(getattr(fused_project_kernel, name) for name in PROJECT_COUNTERS) == 1
    _check_projection(got, _project_plain(dat, enc, w_all, b_all, 1e-5), "bf16")


def _generic_case(gen, b, t, c, f, kind, offset=None):
    """:func:`_tma_case`'s call, with ``offset`` the context placed that
    many bytes past a 16-byte aligned base in a storage that ends where the
    context ends (the operands do not depend on where it lies)."""
    dat, scale, ops, ref = _tma_case(gen, b, t, c, f, kind)
    if offset is not None:
        lead = offset // dat.element_size()
        store = torch.empty((lead + dat.numel(),), dtype=dat.dtype, device="cuda")
        store[lead:] = dat.reshape(-1)
        dat = store[lead:].view(b, t, c)
        assert dat.data_ptr() % 16 == offset % 16
        assert dat.data_ptr() + dat.numel() * dat.element_size() == \
            store.data_ptr() + store.untyped_storage().nbytes()
    return dat, scale, ops, ref


def _run_generic(dat, scale, ops, forced=False):
    """One generic call, which must be one launch on the counter of the
    kernel its plan picks; a second call must give the same bits."""
    for name in PROJECT_COUNTERS:
        setattr(fused_project_kernel, name, 0)
    c = dat.shape[-1]
    args = (dat, *ops, c + 5, 1e-5, scale, "generic" if forced else None)
    got = _project_launch(*args)
    counter = project_generic_plan(dat.shape[0] * dat.shape[1], c, ops[-1].shape[1],
                                   dat.element_size()).counter
    assert getattr(fused_project_kernel, counter) == 1
    assert sum(getattr(fused_project_kernel, name) for name in PROJECT_COUNTERS) == 1
    assert all(torch.equal(a, b) for a, b in zip(got, _project_launch(*args)))
    return got


# the generic route's shapes at small T: (b, t, C, F, kind, forced onto the
# route): the parity layout's slide and omic vector, the image modality,
# int8 rows of 2040 channels, brca's and kirp's widths and the aligned omic
# vector forced onto the route; two column passes and an odd F on both
# kernels
GENERIC_CASES = {"parity_wsi": (2, 200, 4095, 252, "bf16", False),
                 "two_column_passes": (3, 129, 203, 300, "bf16", False),
                 "int8_odd_f": (2, 300, 2047, 71, "int8", False),
                 "few_rows_two_column_passes": (8, 1, 203, 300, "bf16", False),
                 "int8_few_rows_odd_f": (8, 1, 2047, 71, "int8", False),
                 "parity_omic": (8, 1, 2001, 252, "bf16", False),
                 "image": (2, 3000, 3, 252, "bf16", False),
                 "int8_2040": (2, 300, 2040, 252, "int8", False),
                 "int8_omic_2040": (8, 1, 2040, 252, "int8", False),
                 "brca_forced": (2, 300, 2048, 252, "bf16", True),
                 "kirp_forced": (2, 300, 2048, 270, "bf16", True),
                 "omic_forced": (8, 1, 2000, 252, "bf16", True)}


@pytest.mark.parametrize("case", list(GENERIC_CASES))
def test_projection_generic_kernel_matches_plain(gen, case):
    """The generic route's kernels at the shapes of the timing table (small
    T): kv within 4 bf16 ulps, s1 and s2 as the route's contract, one
    launch a call, two calls bit-identical."""
    b, t, c, f, kind, forced = GENERIC_CASES[case]
    dat, scale, ops, ref = _generic_case(gen, b, t, c, f, kind)
    if not forced:
        assert project_route(dat.dtype, torch.bfloat16, c, dat.data_ptr()) == "generic"
    _check_projection(_run_generic(dat, scale, ops, forced), ref, kind)


@pytest.mark.parametrize("kind", ["bf16", "int8"])
@pytest.mark.parametrize("offset", [2, 6, 14])
@pytest.mark.parametrize("c", [2048, 2049, 2047], ids=["k_tail_0", "k_tail_1", "k_tail_63"])
@pytest.mark.parametrize("b,t", [(2, 300), (8, 1)], ids=["many_rows", "few_rows"])
def test_projection_generic_offsets_and_tails(gen, b, t, c, offset, kind):
    """Bases 2, 6 and 14 bytes off 16, C % 64 of 0, 1 and 63 (the k-step
    whose hull carries the next row's values), contexts that end where
    their storage ends; many rows (the hull kinds) and few (the split
    kernel)."""
    dat, scale, ops, ref = _generic_case(gen, b, t, c, 252, kind, offset)
    _check_projection(_run_generic(dat, scale, ops), ref, kind)


# ------------------------------------------------ the f32 projection kernel


def _f32_case(gen, b, t, c, f, kind):
    """An f32 or int8 context (per-token scales, one zero row) with the
    encoding, computed in f32: the f32 kernel's operands and the plain
    version's ``(kv, s1, s2)``."""
    x = torch.randn((b, t, c), generator=gen, device="cuda")
    scale = None
    if kind == "int8":
        qc = quantize_context(x * 3)
        qc.scale[0, 0] = 0.0
        qc.data[0, 0] = 0
        dat, scale = qc.data, qc.scale
    else:
        dat = x
    enc = torch.randn((t, 5), generator=gen, device="cuda")
    w_all = torch.randn((c + 5, f), generator=gen, device="cuda") * 0.05
    b_all = torch.randn((f,), generator=gen, device="cuda") * 0.1
    ops = _prep(dat, enc, w_all, b_all, torch.float32)
    ref = _project_plain(dat, enc, w_all, b_all, 1e-5, scale, torch.float32)
    return dat, scale, ops, ref


@pytest.mark.parametrize("kind", ["f32", "int8"])
@pytest.mark.parametrize("f", [70, 252, 270, 600])
@pytest.mark.parametrize("b,t,c", [(3, 129, 203), (2, 300, 2048), (8, 1, 2000)],
                         ids=["ragged_rows_c203", "c2048", "one_token"])
def test_projection_f32_kernel_matches_plain(gen, b, t, c, f, kind):
    """The f32 route at ragged rows (129 tokens, C = 203 staged element by
    element), at 16-byte rows, and one token, over F up to 600 (three
    column passes): one launch of the variant; kv to 1e-4 (f32 sums of the
    same products in another order than the plain version's GEMM); s1, s2
    as the f32 sums or the int8 branch's exact integer sums."""
    dat, scale, ops, (r, r1, r2) = _f32_case(gen, b, t, c, f, kind)
    assert project_route(dat.dtype, torch.float32, c, dat.data_ptr()) == "f32"
    counter = "launches_f32_int8" if kind == "int8" else "launches_f32"
    for name in ("launches", "launches_int8", "launches_generic", "launches_f32",
                 "launches_f32_int8"):
        setattr(fused_project_kernel, name, 0)
    kv, s1, s2 = fused_project_kernel(dat, *ops, c + 5, 1e-5, scale=scale)
    assert getattr(fused_project_kernel, counter) == 1
    assert sum(getattr(fused_project_kernel, n) for n in (
        "launches", "launches_int8", "launches_generic", "launches_f32", "launches_f32_int8")) == 1
    assert kv.dtype == torch.float32 and kv.shape == r.shape
    assert (kv - r).abs().max().item() <= 1e-4
    if kind == "int8":
        assert ((s1 - r1).abs().max() / r1.abs().max()).item() <= 1e-6
        assert ((s2 - r2).abs().max() / r2.abs().max()).item() <= 2e-6
    else:
        torch.testing.assert_close(s1, r1, rtol=1e-5, atol=1e-3)
        torch.testing.assert_close(s2, r2, rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("kind", ["f32", "int8"])
def test_projection_f32_calls_are_bit_identical(gen, kind):
    """No atomics, no order that changes between calls: the same bits."""
    dat, scale, ops, _ = _f32_case(gen, 4, 1000, 2048, 270, kind)
    one = fused_project_kernel(dat, *ops, 2053, 1e-5, scale=scale)
    two = fused_project_kernel(dat, *ops, 2053, 1e-5, scale=scale)
    assert all(torch.equal(a, b) for a, b in zip(one, two))


# ------------------------------------------ the projection backward kernel


def _bwd_case(gen, b, t, f, dtype, kind):
    g = torch.randn((b, t, f), generator=gen, device="cuda").to(dtype)
    x = torch.randn((b, t, 40), generator=gen, device="cuda") * 2 + 0.5
    scale = torch.rand((b, t), generator=gen, device="cuda") * 0.05 if kind == "int8" else None
    return g, x.sum(-1), (x * x).sum(-1), scale


@pytest.mark.parametrize("kind", ["plain", "int8"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,t,f", [(8, 700, 252), (8, 700, 270), (8, 1, 252), (5000, 1, 252),
                                   (3, 129, 2100)],
                         ids=["brca_f", "kirp_f", "one_token", "batch_5000", "two_chunks"])
def test_projection_bwd_kernel_any_batch_matches_plain(gen, b, t, f, dtype, kind):
    """The cotangent pass at brca's and kirp's F (8- and 4-byte bf16
    vectors), one token, batch 5000 (past any shared-memory row table), and
    F 2100 (two column chunks): one launch; d_raw within 1 bf16 ulp (1e-6
    in f32); dsum2 to f32 rounding of the sum; with the scale, bsum within
    b bf16 ulps of the largest term, and in f32 within the worst-case
    rounding of a sum of b terms in another order, b 2^-24 sum |term|."""
    g, s1, s2, scale = _bwd_case(gen, b, t, f, dtype, kind)
    counter = "launches_int8" if kind == "int8" else "launches"
    fused_project_bwd_kernel.launches = fused_project_bwd_kernel.launches_int8 = 0
    got = fused_project_bwd_kernel(g, s1, s2, 40, 1e-5, scale=scale, with_bsum=kind == "int8")
    assert getattr(fused_project_bwd_kernel, counter) == 1
    ref = project_bwd_plain(g, s1, s2, 40, 1e-5, scale=scale, with_bsum=kind == "int8")
    tol = 1e-6 * ref[0].float().abs().max().item() if dtype == torch.float32 else \
        _bf16_tol(ref[0], ulps=1)
    assert (got[0].float() - ref[0].float()).abs().max().item() <= tol
    torch.testing.assert_close(got[1], ref[1], rtol=1e-5, atol=1e-3)
    if kind == "int8":
        terms = project_bwd_plain(g, s1, s2, 40, 1e-5)[0].float()
        if dtype == torch.float32:
            atol = b * 2.0**-24 * terms.abs().sum(dim=0).max().item()
        else:
            atol = b * _bf16_tol(terms, ulps=1)
        assert (got[2] - ref[2]).abs().max().item() <= atol


@pytest.mark.parametrize("kind", ["plain", "int8"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_projection_bwd_calls_are_bit_identical(gen, dtype, kind):
    """Column sums finished by ticket in a fixed block order, no float
    atomics: two calls give the same bits, and the ticket counters are left
    at zero for the next call."""
    g, s1, s2, scale = _bwd_case(gen, 8, 4096, 270, dtype, kind)
    one = fused_project_bwd_kernel(g, s1, s2, 40, scale=scale, with_bsum=kind == "int8")
    two = fused_project_bwd_kernel(g, s1, s2, 40, scale=scale, with_bsum=kind == "int8")
    assert all(torch.equal(a, b) for a, b in zip(one, two))


# ------------------------------------------- flash kernels at any latent count


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [27, 63, 96, 113, 128])
@pytest.mark.parametrize("lq", [64, 128, 130, 256])
def test_flash_kernels_take_any_latent_count(gen, lq, d, dtype):
    """Latent counts past a block's shared memory (the backward walks the
    queries in chunks, carrying dk and dv over them; the FMA forward takes a
    chunk per block): forward and backward against the plain versions on
    the odd-pitch layout, masked with a fully masked row, dropout 0.2, at
    chip_smoke's phase 5 tolerances (bf16: 2e-2 forward, 4 ulps of the
    largest gradient backward; f32: 2e-5 and 1e-5 relative)."""
    b, h, lkv, rate, seed = 2, 1, 700, 0.2, 77
    qh, kh, vh, mask, split = _odd_pitch_case(gen, b, h, lq, lkv, d)
    if dtype == torch.float32:
        qh, kh, vh = qh.float(), kh.float(), vh.float()
    eff = d**-0.5 / 0.5
    out, lse = flash_attention_kernel(qh, kh, vh, mask, eff, rate, seed)
    ref, _ = multihead_attention(qh.float(), kh.float(), vh.float(), scale=d**-0.5,
                                 kv_mask=mask, dropout_rate=rate, dropout_seed=seed)
    assert (out.float() - ref).abs().max().item() <= (2e-2 if dtype == torch.bfloat16 else 2e-5)
    assert out[0].abs().max().item() == 0.0
    do = split(torch.randn((b, lq, h * d), generator=gen, device="cuda").to(dtype))
    delta = (do.float() * split(out).float()).sum(-1)
    got = flash_attention_bwd_kernel(qh, kh, vh, mask, do, lse, delta, eff, rate, seed)
    want = flash_backward_plain(qh, kh, vh, mask, do, lse, delta, eff, rate, seed)
    for name, a, r in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == dtype and a.shape == r.shape, name
        tol = (_bf16_tol(r) if dtype == torch.bfloat16
               else 1e-5 * max(1.0, r.abs().max().item()))
        assert (a.float() - r.float()).abs().max().item() <= tol, name
        assert a[0].abs().max().item() == 0.0, name


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_bwd_chunked_calls_are_bit_identical(gen, dtype):
    """dk and dv summed over query chunks without atomics: two calls at
    lq 256, d 128 (four chunks on the tensor cores) give the same bits."""
    qh, kh, vh, mask, split = _odd_pitch_case(gen, 2, 1, 256, 2000, 128)
    if dtype == torch.float32:
        qh, kh, vh = qh.float(), kh.float(), vh.float()
    out, lse = flash_attention_kernel(qh, kh, vh, mask, 0.1, 0.1, 5)
    do = split(torch.randn((2, 256, 128), generator=gen, device="cuda").to(dtype))
    delta = (do.float() * split(out).float()).sum(-1)
    g1 = flash_attention_bwd_kernel(qh, kh, vh, mask, do, lse, delta, 0.1, 0.1, 5)
    g2 = flash_attention_bwd_kernel(qh, kh, vh, mask, do, lse, delta, 0.1, 0.1, 5)
    assert all(torch.equal(a, b) for a, b in zip(g1, g2))


def _chain_operands(gen, dtype, spec, b=3):
    """Seeded operands of one chain call on the card: a ragged mask with a
    fully masked row on the bag, presence zeros, FF keep multipliers when
    the spec's FF dropout is on."""
    dev = "cuda"
    rand = lambda *s: torch.randn(s, generator=gen, device=dev)
    width = max(spec.offsets) + 2 * spec.inner + 3
    x0 = rand(b, spec.l_c, spec.l_d).to(dtype)
    # K|V slices at odd element offsets, as the merged KV gives them
    kvs = [rand(b, t, width + 1)[..., 1:].to(dtype) for t in spec.tokens]
    lengths = torch.randint(1, spec.tokens[1] + 1, (b,), generator=gen, device=dev)
    if b > 1:  # batch 1 keeps its one sample's keys
        lengths[1] = 0
    masks = [None, torch.arange(spec.tokens[1], device=dev)[None, :] < lengths[:, None]]
    keep = None
    if spec.ff_dropout > 0:
        keep = (torch.rand((b, spec.sites, spec.l_c, spec.l_d), generator=gen, device=dev)
                > spec.ff_dropout) / (1.0 - spec.ff_dropout)
    presence = torch.ones((b, 2), device=dev)
    if b > 2:
        presence[0, 1] = presence[b - 1, 0] = 0.0
    seeds = torch.randint(0, 2**32, (spec.depth, 2), generator=gen, device=dev,
                          dtype=torch.int64)
    weights = []
    for name, shape in zip(WEIGHT_FIELDS, weight_shapes(spec)):
        w = rand(*shape)
        weights.append(1.0 + 0.1 * w if name in ("ln1_s", "ln2_s") else
                       w / shape[-2] ** 0.5 if name in ("wq", "wout", "w0", "w2") else 0.1 * w)
    return x0, kvs, masks, keep, presence, seeds, weights


CHAIN_SPECS = {  # l_c 17 and inner 15 unless given; 24 and 70 take the other instantiations
    "dropout_ff_keep": dict(depth=2, act="selu", offsets=(0, 30), attn_dropout=0.3,
                            ff_dropout=0.2),
    "tied_gelu": dict(depth=3, act="gelu", offsets=(0, 30, 30), attn_dropout=0.0,
                      ff_dropout=0.0),
    "wide_rows_and_heads": dict(depth=2, act="selu", offsets=(0, 140), attn_dropout=0.3,
                                ff_dropout=0.0, l_c=24, inner=70),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(CHAIN_SPECS))
def test_chain_kernel_matches_plain(gen, dtype, case):
    dims = {"l_c": 17, "inner": 15, **CHAIN_SPECS[case]}
    spec = ChainSpec(n_modalities=2, l_d=32, mult=4, scale=dims["inner"]**-0.5 / 0.5,
                     tokens=(1, 300), has_mask=(False, True), out_dtype=str(dtype)[6:], **dims)
    ops = _chain_operands(gen, dtype, spec)
    fused_chain_kernel.launches = 0
    got = fused_latent_chain(*ops, spec)
    assert fused_chain_kernel.launches == 1
    ref = chain_reference(*ops, spec)
    assert got.dtype == dtype and got.shape == ref.shape
    # f32: sums in another order; bf16: q and the dropped probabilities
    # round at the same places in both, the output once: 4 ulps of the
    # largest value
    tol = 2e-5 * max(1.0, ref.abs().max().item()) if dtype == torch.float32 else _bf16_tol(ref)
    assert (got.float() - ref.float()).abs().max().item() <= tol


def test_chain_kernel_is_forward_only(gen):
    spec = ChainSpec(depth=1, n_modalities=2, l_c=5, l_d=16, inner=8, mult=4, act="selu",
                     scale=8**-0.5 / 0.5, attn_dropout=0.0, ff_dropout=0.0, tokens=(1, 40),
                     offsets=(0,), has_mask=(False, True), out_dtype="float32")
    x0, kvs, masks, keep, presence, seeds, weights = _chain_operands(gen, torch.float32, spec)
    weights[2].requires_grad_()
    with pytest.raises(RuntimeError, match="forward-only"):
        fused_latent_chain(x0, kvs, masks, keep, presence, seeds, weights, spec)
    with torch.no_grad():
        assert fused_latent_chain(x0, kvs, masks, keep, presence, seeds, weights,
                                  spec).shape == x0.shape


# batch, the bag's tokens -> the plan (cluster, keys per block) on an H100
CHAIN_PLANS = {1: (1000, (16, (64, 64))), 3: (2000, (16, (64, 128))),
               8: (4096, (16, (64, 256))), 40: (1000, (4, (64, 256)))}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b", list(CHAIN_PLANS))
def test_chain_kernel_plans_match_plain(gen, dtype, b):
    """Four plans at brca's widths over a 1-token modality (one block owns
    its key) and a ragged bag spread over the cluster, a fully masked
    sample and presence 0 for a sample (batch > 2), dropout and FF keep
    multipliers: one launch a call, two calls bit-identical, and the plain
    version's tolerances."""
    tokens, plan = CHAIN_PLANS[b]
    spec = ChainSpec(depth=2, n_modalities=2, l_c=17, l_d=126, inner=63, mult=4, act="selu",
                     scale=63**-0.5, attn_dropout=0.083, ff_dropout=0.473, tokens=(1, tokens),
                     offsets=(0, 126), has_mask=(False, True), out_dtype=str(dtype)[6:])
    ops = _chain_operands(gen, dtype, spec, b=b)
    assert chain_launch_plan(spec, b, dtype, ops[0].device)[:2] == plan
    fused_chain_kernel.launches = 0
    with torch.no_grad():
        got, again = fused_latent_chain(*ops, spec), fused_latent_chain(*ops, spec)
    assert fused_chain_kernel.launches == 2
    assert torch.equal(got, again)
    ref = chain_reference(*ops, spec)
    tol = 2e-5 * max(1.0, ref.abs().max().item()) if dtype == torch.float32 else _bf16_tol(ref)
    assert (got.float() - ref.float()).abs().max().item() <= tol


def test_chain_kernel_takes_long_ranges_in_chunks(gen):
    """Clusters of 1 force a block's whole 1300-key range through the
    512-key score buffer in three chunks (scores recomputed in the second
    pass)."""
    spec = ChainSpec(depth=1, n_modalities=2, l_c=17, l_d=32, inner=15, mult=4, act="gelu",
                     scale=15**-0.5, attn_dropout=0.3, ff_dropout=0.0, tokens=(1, 1300),
                     offsets=(0,), has_mask=(False, True), out_dtype="float32")
    ops = _chain_operands(gen, torch.float32, spec, b=200)
    cluster, kpb, chunk = chain_launch_plan(spec, 200, torch.float32, ops[0].device)
    assert cluster == 1 and kpb[1] == 1344 and chunk == 512
    with torch.no_grad():
        got = fused_latent_chain(*ops, spec)
    ref = chain_reference(*ops, spec)
    assert (got - ref).abs().max().item() <= 2e-5 * max(1.0, ref.abs().max().item())


# --------------------------------------------------------- captured steps

# a small arena model: one omic token and bags of up to 24 patches of 64
# channels, flash attention forced, attention and FF dropout on
CAPTURE_CFG = dict(n_modalities=2, channel_dims=(40, 64), num_spatial_axes=(1, 1), out_dims=4,
                   depth=2, l_c=17, l_d=32, x_heads=1, cross_dim_head=16, self_per_cross_attn=0,
                   num_freq_bands=2, max_freq=2.0, attn_dropout=0.2, ff_dropout=0.3)


def _capture_data(n=12, width=24):
    rng = np.random.default_rng(3)
    lengths = rng.integers(5, width + 1, size=n).astype(np.int32)
    offsets = np.concatenate([[0], np.cumsum(lengths)[:-1]]).astype(np.int32)
    arena = np.concatenate([rng.normal(size=(int(lengths.sum()), 64)),
                            np.zeros((width, 64))]).astype(np.float32)
    data = {"tensors": (rng.normal(size=(n, 1, 40)).astype(np.float32),),
            "kv_masks": (None, np.arange(width)[None, :] < lengths[:, None]),
            "patch_offsets": offsets, "patch_lengths": lengths,
            "y_disc": rng.integers(0, 4, size=n),
            "censorship": (rng.uniform(size=n) < 0.4).astype(np.float32),
            "event_time": rng.uniform(1, 100, size=n).astype(np.float32)}
    return data, arena


def _capture_trainer(arena, fused, dtype, seed=0, init=0):
    module = HealNetModule(**CAPTURE_CFG, attention_impl="flash", dtype=dtype, device="cuda",
                           generator=torch.Generator().manual_seed(init))
    return SurvivalTrainer(module, batch_size=4, epochs=2, l1=1e-4, max_lr=1e-3, seed=seed,
                           device="cuda", feature_arena=arena, fused_epochs=fused,
                           early_stopping=False, prefetch=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_captured_step_equals_eager_step(gen, dtype):
    """A fused fold (each bucket's step captured once and replayed) against
    the stepwise fold on the same weights, batches and seeds: the same
    kernels on the same inputs, so the losses, c-indices and weights agree
    (1e-5 relative in f32; in bf16 within 2e-2 relative, phase 10's step
    tolerance in ``chip_smoke.py``)."""
    data, arena = _capture_data()
    fused, step = _capture_trainer(arena, True, dtype), _capture_trainer(arena, False, dtype)
    got, ref = fused.fit(data, data, verbose=False), step.fit(data, data, verbose=False)
    assert all(t.graph is not None for t in fused._tables.values())
    rtol = 1e-5 if dtype == torch.float32 else 2e-2
    for g, r in zip(got["history"], ref["history"]):
        for key in ("train_loss", "val_loss"):
            np.testing.assert_allclose(g[key], r[key], rtol=rtol, err_msg=key)
    for (name, a), b in zip(fused.module.named_parameters(), step.module.parameters()):
        torch.testing.assert_close(a, b, rtol=rtol, atol=1e-6, msg=name)


@pytest.mark.parametrize("d,dtype", [(63, torch.bfloat16), (63, torch.float32),
                                     (320, torch.bfloat16), (576, torch.float32)],
                         ids=["tc", "fma", "wide", "panels"])
def test_two_replays_drop_different_entries(gen, d, dtype):
    """The flash kernels read their seed from device memory: one captured
    forward and backward replayed with two seeds in its seed word drops
    different entries, and each replay equals the eager call with that
    seed (bit for bit); a replay with the first seed again repeats it."""
    q, k, v = (torch.randn((2, 1, n, d), generator=gen, device="cuda").to(dtype)
               for n in (17, 300, 300))
    do = torch.randn((2, 1, 17, d), generator=gen, device="cuda").to(dtype)
    eff, rate = d**-0.5 / 0.5, 0.3
    word = torch.zeros((1,), dtype=torch.int64, device="cuda")

    def call(seed):
        out, lse = flash_attention_kernel(q, k, v, None, eff, rate, seed)
        delta = (do.float() * out.float().reshape(2, 17, 1, d).transpose(1, 2)).sum(-1)
        return (out, *flash_attention_bwd_kernel(q, k, v, None, do, lse, delta, eff, rate, seed))

    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        call(word)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        static = call(word)
    replays = []
    for seed in (11, 12, 11):
        word.fill_(seed)
        graph.replay()
        replays.append([x.clone() for x in static])
    for got, seed in zip(replays, (11, 12)):
        assert all(torch.equal(a, b) for a, b in zip(got, call(seed)))
    assert not torch.equal(replays[0][0], replays[1][0])
    assert all(torch.equal(a, b) for a, b in zip(replays[0], replays[2]))


def test_graph_replays_after_set_fold(gen):
    """``set_fold`` gives the trainer a new optimizer: its captured steps
    are dropped and captured again, and the new fold trains as a fresh
    fused trainer with that seed does (bit for bit)."""
    data, arena = _capture_data()
    trainer = _capture_trainer(arena, True, torch.float32)
    trainer.fit(data, data, verbose=False)
    trainer.set_fold(seed=7)
    assert all(t.graph is None for t in trainer._tables.values())
    got = trainer.fit(data, data, verbose=False)
    fresh = _capture_trainer(arena, True, torch.float32, seed=7, init=7)
    want = fresh.fit(data, data, verbose=False)
    assert [h["train_loss"] for h in got["history"]] == [h["train_loss"] for h in want["history"]]
    assert got["val_c_index"] == want["val_c_index"]


def test_quantize_context_on_card_equals_host(gen):
    """``quantize_context`` on a CUDA tensor divides by a device scalar:
    its scales and values equal the host's (the JAX package's arithmetic)
    bit for bit, at float16 rows of 2,048 channels with per-row scales
    spread 0.1-9."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((40000, 2048), dtype=np.float32)
         * rng.uniform(0.1, 9, (40000, 1))).astype(np.float16)
    got = quantize_context(torch.as_tensor(x, device="cuda"))
    q, scale = quantize_context_host(x)
    np.testing.assert_array_equal(got.scale.cpu().numpy(), scale)
    np.testing.assert_array_equal(got.data.cpu().numpy(), q)


@pytest.mark.parametrize("attention_impl", ["auto", "flash"])
def test_exported_predictor_launches_the_kernels(gen, tmp_path, attention_impl):
    """An artifact exported on the card holds the registered ops (the
    flash forward under "flash"), launches the kernels when served, and
    serves what the live Predictor serves, bit for bit."""
    from healnet_tpu_torch.serving import Predictor
    from healnet_tpu_torch.serving_export import ExportedPredictor

    module = HealNetModule(n_modalities=2, channel_dims=(64, 128), num_spatial_axes=(1, 1),
                           out_dims=4, depth=2, l_c=17, l_d=32, cross_dim_head=27,
                           self_per_cross_attn=0, attention_impl=attention_impl,
                           dtype=torch.bfloat16, device="cuda")
    live = Predictor(module, batch_size=4, bucket_boundaries=[64, 128], device="cuda")
    live.export(tmp_path, example_shapes=[(1, 64), (128, 128)], widths=[64, 128])
    ops = [str(n.target) for n in torch.export.load(tmp_path / "predict.pt2").graph.nodes
           if "healnet_port" in str(n.target)]
    flash_ops = 4 if attention_impl == "flash" else 0
    assert ops.count("healnet_port.fused_kv_project.default") == 2
    assert ops.count("healnet_port.flash_attention_fwd.default") == flash_ops
    served = ExportedPredictor(tmp_path)
    rng = np.random.default_rng(0)
    omic = rng.normal(size=(6, 1, 64)).astype(np.float32)
    bags = [rng.normal(size=(n, 128)).astype(np.float32) for n in (30, 64, 100, 128, 5, 77)]
    for counter in PROJECT_COUNTERS:
        setattr(fused_project_kernel, counter, 0)
    for counter in LAUNCH_COUNTERS:
        setattr(flash_attention_kernel, counter, 0)
    got = served.predict_ragged([omic, bags])
    calls = 2  # a micro-batch of 4 a width: 3 bags of at most 64, 3 above
    assert sum(getattr(fused_project_kernel, c) for c in PROJECT_COUNTERS) == 2 * calls
    assert sum(getattr(flash_attention_kernel, c) for c in LAUNCH_COUNTERS) == flash_ops * calls
    want = live.predict_ragged([omic, bags])
    for key in ("logits", "hazards", "survival", "risk"):
        np.testing.assert_array_equal(got[key], want[key])


@pytest.mark.parametrize("d,dtype", [(63, torch.bfloat16), (63, torch.float32),
                                     (320, torch.bfloat16), (576, torch.float32)],
                         ids=["tc", "fma", "wide", "panels"])
def test_flash_row_offset_keeps_the_whole_calls_rows(gen, d, dtype):
    """A shard (batch rows 2-3, head 1 of 2) launched with its hash row
    offset and head stride keeps the whole call's entries of those rows:
    with one-hot values the output is the dropped map, zero where dropped."""
    b, h, lq, lkv, rate, seed = 4, 2, 17, 32, 0.3, 99
    eff = d**-0.5 / 0.5
    q = torch.randn((b, h, lq, d), generator=gen, device="cuda").to(dtype)
    k = torch.randn((b, h, lkv, d), generator=gen, device="cuda").to(dtype)
    v = torch.zeros((b, h, lkv, d), device="cuda", dtype=dtype)
    v[:, :, torch.arange(lkv), torch.arange(lkv)] = 1
    whole, _ = flash_attention_kernel(q, k, v, None, eff, rate, seed)
    part = [x[2:4, 1:2].contiguous() for x in (q, k, v)]
    got, _ = flash_attention_kernel(*part, None, eff, rate, seed, 2 * h + 1, h)
    keep = dense_keep_mask(seed, b * h, lq, lkv, rate, device="cuda").reshape(b, h, lq, lkv)
    assert torch.equal(got.reshape(2, lq, 1, d)[..., :lkv] != 0,
                       whole.reshape(b, lq, h, d)[2:4, :, 1:2, :lkv] != 0)
    assert torch.equal(got.reshape(2, lq, d)[..., :lkv] != 0, keep[2:4, 1])


def test_patch_extractor_on_card_matches_cpu(gen, monkeypatch):
    """The data-ops ResNet-50 on the card (cuDNN, TF32 off) against its CPU
    copy on the same 8 uint8 patches: within 1e-4 of the largest feature,
    and no port kernel launched."""
    from healnet_tpu_torch.ops.resnet import PatchFeatureExtractor

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    patches = np.random.default_rng(0).integers(0, 256, (8, 224, 224, 3)).astype(np.uint8)
    card = PatchFeatureExtractor(batch_size=4, seed=3)
    cpu = PatchFeatureExtractor(batch_size=4, seed=3, device="cpu")
    for counter in PROJECT_COUNTERS:
        setattr(fused_project_kernel, counter, 0)
    for counter in LAUNCH_COUNTERS:
        setattr(flash_attention_kernel, counter, 0)
    fused_chain_kernel.launches = 0
    got, want = card(patches), cpu(patches)
    assert got.shape == (8, 2048) and np.isfinite(got).all()
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    assert sum(getattr(fused_project_kernel, c) for c in PROJECT_COUNTERS) == 0
    assert sum(getattr(flash_attention_kernel, c) for c in LAUNCH_COUNTERS) == 0
    assert fused_chain_kernel.launches == 0
