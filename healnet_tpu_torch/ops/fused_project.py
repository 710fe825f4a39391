"""Fused merged-KV projection with folded LayerNorm (forward).

Counterpart of ``healnet_tpu/ops/fused_project.py``. The model projects every
fusion layer's KV from the raw context in one merged product with each
layer's context-LayerNorm affine folded into the weights:

    x_hat @ W = (1/sigma) (ctx @ W_c + enc @ W_e - mu * colsum(W)) + beta @ W

so the normalization applies on the (tokens x F) output, never on the
context itself. :func:`project_plain` is the two-pass PyTorch version (the
math of the JAX package's ``_xla_project``); :func:`fused_project_kernel`
launches the CUDA kernel (``csrc/fused_project.cu``), which reads the
context once for the statistics, the product and the normalization.

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
    cdt = dat.dtype
    c_dim = dat.shape[-1]
    w_c, w_e = w_all[:c_dim], w_all[c_dim:]
    colsum = torch.sum(w_all, dim=0)
    d_total = w_all.shape[0]

    xf = dat.float()
    s1 = torch.sum(xf, dim=-1)
    s2 = torch.sum(xf * xf, dim=-1)
    if enc is not None:
        ef = enc.float()
        s1 = s1 + torch.sum(ef, dim=-1)
        s2 = s2 + torch.sum(ef * ef, dim=-1)
    mu = s1 / d_total
    var = s2 / d_total - mu * mu
    inv = torch.rsqrt(var + eps)

    raw = dat.to(cdt) @ w_c.to(cdt)
    if enc is not None:
        raw = raw + enc.to(cdt) @ w_e.to(cdt)
    return (inv[..., None] * (raw.float() - mu[..., None] * colsum) + b_all).to(cdt)


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
    (also spelt ``"pallas"``, the JAX package's name) and ``"auto"`` launch
    the CUDA kernel for a CUDA tensor. A CPU tensor always takes the plain
    version.
    """
    if impl not in _IMPLS:
        raise ValueError(f"unknown fused projection impl: {impl!r}")
    if impl == "xla" or not dat.is_cuda:
        return project_plain(dat, enc, w_all, b_all, eps)
    w_c, enc_proj, enc_stats, aux = _prep(dat, enc, w_all, b_all, dat.dtype)
    kv, _, _ = fused_project_kernel(
        dat.contiguous(), w_c, enc_proj, enc_stats, aux, w_all.shape[0], eps
    )
    return kv


def split_columns(x: torch.Tensor, widths) -> Tuple[torch.Tensor, ...]:
    """Split the last axis into contiguous column blocks (views)."""
    widths = [int(w) for w in widths]
    if sum(widths) != x.shape[-1]:
        raise ValueError(f"widths {widths} do not cover {x.shape[-1]} columns")
    return tuple(torch.split(x, widths, dim=-1))
