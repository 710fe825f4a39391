"""Fused merged-KV projection with folded LayerNorm, forward and backward.

Counterpart of ``healnet_tpu/ops/fused_project.py``. The model projects every
fusion layer's KV from the raw context in one merged product with each
layer's context-LayerNorm affine folded into the weights:

    x_hat @ W = (1/sigma) (ctx @ W_c + enc @ W_e - mu * colsum(W)) + beta @ W

so the normalization applies on the (tokens x F) output, never on the
context itself. :func:`project_plain` is the two-pass PyTorch version (the
math of the JAX package's ``_xla_project``); :func:`fused_project_kernel`
launches the CUDA kernel (``csrc/fused_project.cu``), which reads the
context once for the statistics, the product and the normalization.
:class:`FusedProjectFunction` gives it a backward whose cotangent pass is a
second kernel (``csrc/fused_project_bwd.cu``, plain version
:func:`project_bwd_plain`).

Rounding contract, identical in both: the product accumulates in f32 and is
rounded to the compute dtype, the encoding projection is added in the
compute dtype, and the sum is widened to f32 before the normalization. The
statistics are f32 sums of the stored context values.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from healnet_tpu_torch.ops import cuda_build

_IMPLS = ("auto", "xla", "kernel", "pallas")


def _row_stats(dat, enc):
    """f32 row sums and sums of squares of the stored context values, the
    encoding's added on: ``(s1, s2)``, each (b, t)."""
    xf = dat.float()
    s1 = torch.sum(xf, dim=-1)
    s2 = torch.sum(xf * xf, dim=-1)
    if enc is not None:
        ef = enc.float()
        s1 = s1 + torch.sum(ef, dim=-1)
        s2 = s2 + torch.sum(ef * ef, dim=-1)
    return s1, s2


def _mu_inv(s1, s2, d_total, eps):
    mu = s1 / d_total
    return mu, torch.rsqrt(s2 / d_total - mu * mu + eps)


def _raw(dat, enc, w_all, cdt):
    """The pre-normalization product in f32, with the rounding contract."""
    c_dim = dat.shape[-1]
    raw = dat.to(cdt) @ w_all[:c_dim].to(cdt)
    if enc is not None:
        raw = raw + enc.to(cdt) @ w_all[c_dim:].to(cdt)
    return raw.float()


def _project_plain(dat, enc, w_all, b_all, eps):
    """``(kv, s1, s2)`` of the plain version, as the kernel returns them."""
    s1, s2 = _row_stats(dat, enc)
    mu, inv = _mu_inv(s1, s2, w_all.shape[0], eps)
    colsum = torch.sum(w_all, dim=0)
    raw = _raw(dat, enc, w_all, dat.dtype)
    return (inv[..., None] * (raw - mu[..., None] * colsum) + b_all).to(dat.dtype), s1, s2


def project_plain(
    dat: torch.Tensor,
    enc: Optional[torch.Tensor],
    w_all: torch.Tensor,
    b_all: torch.Tensor,
    eps: float = 1e-5,
) -> torch.Tensor:
    """Plain version: a statistics pass plus a matmul pass.

    dat: (b, t, C); enc: optional (t, E) shared across the batch;
    w_all: (C + E, F) f32; b_all: (F,). Returns (b, t, F) in the context
    dtype, which is also the compute dtype.
    """
    return _project_plain(dat, enc, w_all, b_all, eps)[0]


def project_bwd_plain(
    g: torch.Tensor,
    s1: torch.Tensor,
    s2: torch.Tensor,
    d_total: int,
    eps: float = 1e-5,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the backward kernel: the cotangent pass.

    g: (b, t, F) cotangent of the projection, in the compute dtype; s1, s2:
    (b, t) f32 saved row statistics. Returns ``d_raw = round(inv * g)``
    (b, t, F) in g's dtype and ``dsum2 = [sum g; sum inv * mu * g]`` (2, F)
    f32, which are ``[d_bias; -d_colsum]``.
    """
    mu, inv = _mu_inv(s1, s2, d_total, eps)
    gf = g.float()
    d_raw = (inv[..., None] * gf).to(g.dtype)
    dsum2 = torch.stack([
        torch.sum(gf, dim=(0, 1)),
        torch.sum((inv * mu)[..., None] * gf, dim=(0, 1)),
    ])
    return d_raw, dsum2


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("fused_project")
    fn = lib.healnet_fused_project
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, f, f, i, i, p]
        fn.restype = ctypes.c_int
    return lib


def fused_project_kernel(
    dat: torch.Tensor,
    w_c: torch.Tensor,
    enc_proj: torch.Tensor,
    enc_stats: torch.Tensor,
    aux: torch.Tensor,
    d_total: int,
    eps: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel: returns ``(kv, s1, s2)``.

    dat: (b, t, C) bf16 or f32; w_c: (C, F) in dat's dtype; enc_proj: (t, F)
    in dat's dtype; enc_stats: (2, t) f32 [row sums; row sums of squares] of
    the encoding; aux: (2, F) f32 [colsum(W); folded bias]. All contiguous
    and on one CUDA device. kv: (b, t, F) in dat's dtype; s1, s2: (b, t) f32.
    """
    if not dat.is_cuda:
        raise ValueError("fused_project_kernel takes CUDA tensors")
    if dat.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"fused_project_kernel takes bf16 or f32, got {dat.dtype}")
    if dat.ndim != 3:
        raise ValueError(f"dat must be (b, t, C), got {tuple(dat.shape)}")
    b, t, c = dat.shape
    f = w_c.shape[1]
    expect = {
        "w_c": (w_c, (c, f), dat.dtype),
        "enc_proj": (enc_proj, (t, f), dat.dtype),
        "enc_stats": (enc_stats, (2, t), torch.float32),
        "aux": (aux, (2, f), torch.float32),
    }
    for name, (x, shape, dtype) in expect.items():
        if tuple(x.shape) != shape or x.dtype != dtype:
            raise ValueError(
                f"{name} must be {shape} {dtype}, got {tuple(x.shape)} {x.dtype}"
            )
        if x.device != dat.device or not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {dat.device}")
    if not dat.is_contiguous():
        raise ValueError("dat must be contiguous")
    kv = torch.empty((b, t, f), dtype=dat.dtype, device=dat.device)
    s1 = torch.empty((b, t), dtype=torch.float32, device=dat.device)
    s2 = torch.empty((b, t), dtype=torch.float32, device=dat.device)
    if kv.numel() == 0:
        return kv, s1, s2
    is_bf16 = dat.dtype == torch.bfloat16
    # 16-byte row loads need 8-element rows and an aligned base
    vec = int(c % 8 == 0 and dat.data_ptr() % 16 == 0)
    lib = _lib()
    with torch.cuda.device(dat.device):
        stream = torch.cuda.current_stream(dat.device).cuda_stream
        code = lib.healnet_fused_project(
            dat.data_ptr(), w_c.data_ptr(), enc_proj.data_ptr(),
            enc_stats.data_ptr(), aux.data_ptr(), kv.data_ptr(),
            s1.data_ptr(), s2.data_ptr(), b * t, c, f, t,
            float(d_total), float(eps), int(is_bf16), vec, stream,
        )
    fused_project_kernel.launches += 1
    cuda_build.check(lib, code, "fused_project_kernel")
    return kv, s1, s2


fused_project_kernel.launches = 0


def _prep(dat, enc, w_all, b_all, cdt):
    """The kernel's small operands: weights in the compute dtype, the
    encoding projection and statistics, and [colsum; bias]."""
    b, t, c = dat.shape
    f = w_all.shape[1]
    w_c = w_all[:c].to(cdt).contiguous()
    aux = torch.stack([torch.sum(w_all, dim=0), b_all]).float().contiguous()
    if enc is not None:
        enc_proj = (enc.to(cdt) @ w_all[c:].to(cdt)).contiguous()
        ef = enc.float()
        enc_stats = torch.stack([torch.sum(ef, dim=-1), torch.sum(ef * ef, dim=-1)])
    else:
        enc_proj = torch.zeros((t, f), dtype=cdt, device=dat.device)
        enc_stats = torch.zeros((2, t), dtype=torch.float32, device=dat.device)
    return w_c, enc_proj, enc_stats.contiguous(), aux


def _bwd_lib() -> ctypes.CDLL:
    lib = cuda_build.load("fused_project_bwd")
    fn = lib.healnet_fused_project_bwd
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p, p, p, p, p, p, i, i, f, f, i, p]
        fn.restype = ctypes.c_int
        lib.healnet_fused_project_bwd_tiles.argtypes = [i]
        lib.healnet_fused_project_bwd_tiles.restype = i
    return lib


def fused_project_bwd_kernel(
    g: torch.Tensor,
    s1: torch.Tensor,
    s2: torch.Tensor,
    d_total: int,
    eps: float = 1e-5,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the backward (cotangent pass) kernel: returns ``(d_raw,
    dsum2)`` as :func:`project_bwd_plain` does.

    g: (b, t, F) bf16 or f32, contiguous; s1, s2: (b, t) f32, contiguous;
    all on one CUDA device.
    """
    if not g.is_cuda:
        raise ValueError("fused_project_bwd_kernel takes CUDA tensors")
    if g.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"fused_project_bwd_kernel takes bf16 or f32, got {g.dtype}")
    if g.ndim != 3 or not g.is_contiguous():
        raise ValueError(f"g must be a contiguous (b, t, F), got {tuple(g.shape)}")
    b, t, f = g.shape
    for name, x in (("s1", s1), ("s2", s2)):
        if (tuple(x.shape) != (b, t) or x.dtype != torch.float32
                or x.device != g.device or not x.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous {(b, t)} f32 on {g.device}")
    lib = _bwd_lib()
    m = b * t
    tiles = lib.healnet_fused_project_bwd_tiles(m)
    d_raw = torch.empty_like(g)
    part = torch.empty((tiles, 2, f), dtype=torch.float32, device=g.device)
    dsum2 = torch.zeros((2, f), dtype=torch.float32, device=g.device)
    if m == 0 or f == 0:
        return d_raw, dsum2
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream(g.device).cuda_stream
        code = lib.healnet_fused_project_bwd(
            g.data_ptr(), s1.data_ptr(), s2.data_ptr(), d_raw.data_ptr(),
            part.data_ptr(), dsum2.data_ptr(), m, f, float(d_total), float(eps),
            int(g.dtype == torch.bfloat16), stream,
        )
    fused_project_bwd_kernel.launches += 1
    cuda_build.check(lib, code, "fused_project_bwd_kernel")
    return d_raw, dsum2


fused_project_bwd_kernel.launches = 0


def _gemm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` accumulated and returned in f32 (bf16 products are exact
    in f32), as JAX's ``preferred_element_type=float32``."""
    if a.dtype == torch.float32:
        return a @ b
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


class FusedProjectFunction(torch.autograd.Function):
    """The merged folded-KV projection with its backward, for autograd.

    ``apply(dat, enc, w_all, b_all, eps)`` -> (b, t, F) in dat's dtype.
    CUDA tensors launch the forward kernel and, in the backward, the
    cotangent-pass kernel; CPU tensors take the plain versions, which the
    tests use to check the formulas. The residuals are the inputs and the
    two (b, t) row statistics, never a (b, t, F) tensor.

    Backward (the JAX package's ``_pallas_bwd``): with ``d_raw = inv * g``
    and ``dsum2 = [sum g; sum inv * mu * g]`` from the cotangent pass,
    ``d_W_c = dat^T d_raw`` (a library GEMM, as JAX leaves it to XLA),
    ``d_W_e = enc^T sum_b d_raw`` in f32, ``d_bias = dsum2[0]`` and
    ``-dsum2[1]`` added to every row of ``d_W``. The input cotangents
    ``d_dat`` and ``d_enc`` are plain ops, computed only when asked for:
    training never needs them.
    """

    @staticmethod
    def forward(ctx, dat, enc, w_all, b_all, eps):
        if dat.is_cuda:
            dat = dat.contiguous()
            ops = _prep(dat, enc, w_all, b_all, dat.dtype)
            kv, s1, s2 = fused_project_kernel(dat, *ops, w_all.shape[0], eps)
        else:
            kv, s1, s2 = _project_plain(dat, enc, w_all, b_all, eps)
        ctx.save_for_backward(dat, enc, w_all, s1, s2)
        ctx.eps, ctx.b_dtype = eps, b_all.dtype
        return kv

    @staticmethod
    def backward(ctx, g):
        dat, enc, w_all, s1, s2 = ctx.saved_tensors
        eps = ctx.eps
        need_dat, need_enc, need_w, need_b = ctx.needs_input_grad[:4]
        need_enc = need_enc and enc is not None
        cdt = dat.dtype
        c, d_total, f = dat.shape[-1], w_all.shape[0], w_all.shape[1]
        g = g.contiguous().to(cdt)
        d_dat = d_enc = d_w = d_bias = None

        if need_w or need_b:
            bwd = fused_project_bwd_kernel if g.is_cuda else project_bwd_plain
            d_raw, dsum2 = bwd(g, s1, s2, d_total, eps)
            d_bias = dsum2[0].to(ctx.b_dtype)
            d_w = torch.zeros_like(w_all)
            d_w[:c] = _gemm_f32(dat.reshape(-1, c).t(), d_raw.reshape(-1, f))
            if enc is not None:
                d_raw_t = torch.sum(d_raw.float(), dim=0)  # (t, F)
                d_w[c:] = enc.float().t() @ d_raw_t
            d_w -= dsum2[1]

        if need_dat or need_enc:
            mu, inv = _mu_inv(s1, s2, d_total, eps)
            colsum = torch.sum(w_all, dim=0)
            gf = g.float()
            p_term = _raw(dat, enc, w_all, cdt) - mu[..., None] * colsum
            d_inv = torch.sum(gf * p_term, dim=-1)
            d_p = inv[..., None] * gf
            d_var = d_inv * -0.5 * inv * inv * inv
            d_s2 = d_var / d_total
            d_s1 = (-torch.sum(d_p * colsum, dim=-1) - 2.0 * mu * d_var) / d_total
            if need_dat:
                d_dat = (d_p @ w_all[:c].t().float() + d_s1[..., None]
                         + 2.0 * dat.float() * d_s2[..., None]).to(dat.dtype)
            if need_enc:
                d_enc = (torch.sum(d_p, dim=0) @ w_all[c:].t().float()
                         + torch.sum(d_s1, dim=0)[..., None]
                         + 2.0 * enc.float() * torch.sum(d_s2, dim=0)[..., None]
                         ).to(enc.dtype)
        return d_dat, d_enc, d_w, d_bias, None


def fused_kv_project(
    dat: torch.Tensor,
    enc: Optional[torch.Tensor],
    w_all: torch.Tensor,
    b_all: torch.Tensor,
    *,
    eps: float = 1e-5,
    impl: str = "auto",
) -> torch.Tensor:
    """Merged folded-KV projection of a raw context: (b, t, F).

    impl: ``"xla"`` is the plain two-pass version anywhere; ``"kernel"``
    (also spelt ``"pallas"``, the JAX package's name) and ``"auto"`` run a
    CUDA tensor through :class:`FusedProjectFunction` (the forward kernel,
    and the cotangent-pass kernel in the backward). A CPU tensor always
    takes the plain version.
    """
    if impl not in _IMPLS:
        raise ValueError(f"unknown fused projection impl: {impl!r}")
    if impl == "xla" or not dat.is_cuda:
        return project_plain(dat, enc, w_all, b_all, eps)
    return FusedProjectFunction.apply(dat, enc, w_all, b_all, eps)


def split_columns(x: torch.Tensor, widths) -> Tuple[torch.Tensor, ...]:
    """Split the last axis into contiguous column blocks (views)."""
    widths = [int(w) for w in widths]
    if sum(widths) != x.shape[-1]:
        raise ValueError(f"widths {widths} do not cover {x.shape[-1]} columns")
    return tuple(torch.split(x, widths, dim=-1))
