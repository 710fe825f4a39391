"""Flash cross-attention forward.

Counterpart of ``healnet_tpu/ops/flash_attention.py`` (forward). A small
latent query array attends to a long per-modality context; the CUDA kernel
(``csrc/flash_attention.cu``) streams KV tiles with an online softmax so the
(lq x lkv) weights never reach device memory. The plain version is
:func:`healnet_tpu_torch.ops.attention.multihead_attention`, which computes
the same function with materialised weights.

Semantics shared with the TPU kernel: temperature folded into the scale,
masked keys contribute zero, a row with every key masked outputs zero,
dropout multiplies the normalised probabilities by ``keep / (1 - rate)``
with ``keep`` from the coordinate hash over absolute (batch*head row, query,
key) coordinates, and the denominator is taken before dropout.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from healnet_tpu_torch.ops import cuda_build
from healnet_tpu_torch.ops.attention import multihead_attention
from healnet_tpu_torch.ops.hash_dropout import keep_threshold

_KEY_TILE = 32  # keys per tile in the kernel (kTile)
_MAX_SMEM = 232448  # dynamic shared memory a block may use on Hopper


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("flash_attention")
    fn = lib.healnet_flash_forward
    if fn.argtypes is None:
        p, i, ll, f, u = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                          ctypes.c_float, ctypes.c_uint32)
        fn.argtypes = (
            [p] * 8 + [i] * 7 + [ll] * 10 + [f, i, u, u, f, i, p]
        )
        fn.restype = ctypes.c_int
        lib.healnet_flash_smem_bytes.argtypes = [i, i]
        lib.healnet_flash_smem_bytes.restype = ctypes.c_longlong
    return lib


def _n_split(rows: int, lkv: int, device: torch.device) -> Tuple[int, int]:
    """Key splits per row: enough blocks for two on every SM (a block is
    latency-bound on its own), each split a whole number of key tiles.
    Returns (n_split, split_len)."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    tiles = max(1, -(-lkv // _KEY_TILE))
    want = max(1, min(tiles, -(-2 * sms // max(rows, 1))))
    split_len = -(-tiles // want) * _KEY_TILE
    return max(1, -(-lkv // split_len)), split_len


def flash_attention_kernel(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_mask: Optional[torch.Tensor],
    eff_scale: float,
    dropout_rate: float = 0.0,
    dropout_seed: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel: returns ``(out (b, lq, h*d), lse (b, h, lq))``.

    q: (b, h, lq, d); k, v: (b, h, lkv, d), any strides with a unit stride
    on d (the column slices of the merged KV buffer are taken as they are);
    kv_mask: optional (b, lkv), True/1 = attend; eff_scale = scale / T.
    """
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not x.is_cuda or x.device != q.device:
            raise ValueError(f"{name} must be a CUDA tensor on {q.device}")
        if x.dtype != q.dtype or x.dtype not in (torch.bfloat16, torch.float32):
            raise TypeError(f"q, k, v must share bf16 or f32, got {x.dtype}")
        if x.ndim != 4 or x.stride(-1) != 1:
            raise ValueError(f"{name} must be (b, h, n, d) with unit stride on d")
    b, h, lq, d = q.shape
    lkv = k.shape[2]
    if tuple(k.shape) != (b, h, lkv, d) or tuple(v.shape) != (b, h, lkv, d):
        raise ValueError(f"k, v must be {(b, h, lkv, d)}: {k.shape}, {v.shape}")
    lib = _lib()
    smem = lib.healnet_flash_smem_bytes(lq, d)
    if smem > _MAX_SMEM:
        raise ValueError(f"lq={lq}, d={d} needs {smem} B of shared memory")
    mask = None
    if kv_mask is not None:
        if tuple(kv_mask.shape) != (b, lkv):
            raise ValueError(f"kv_mask must be {(b, lkv)}, got {tuple(kv_mask.shape)}")
        mask = kv_mask.to(device=q.device, dtype=torch.float32).contiguous()
    n_split, split_len = _n_split(b * h, lkv, q.device)
    out = torch.empty((b, lq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, lq), dtype=torch.float32, device=q.device)
    part_acc = torch.empty((b * h, n_split, lq, d), dtype=torch.float32, device=q.device)
    part_ml = torch.empty((b * h, n_split, 2, lq), dtype=torch.float32, device=q.device)
    rate = float(dropout_rate)
    keep_scale = float(np.float32(1.0 / (1.0 - rate))) if rate > 0 else 1.0
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = lib.healnet_flash_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if mask is None else mask.data_ptr(),
            part_acc.data_ptr(), part_ml.data_ptr(), out.data_ptr(), lse.data_ptr(),
            b, h, lq, lkv, d, n_split, split_len,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            0 if mask is None else mask.stride(0),
            float(eff_scale), int(rate > 0), int(dropout_seed) & 0xFFFFFFFF,
            keep_threshold(rate), keep_scale, int(q.dtype == torch.bfloat16), stream,
        )
    flash_attention_kernel.launches += 1
    cuda_build.check(lib, code, "flash_attention_kernel")
    return out.reshape(b, lq, h * d), lse


flash_attention_kernel.launches = 0


def flash_cross_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    scale: float,
    temperature: float = 0.5,
    kv_mask: Optional[torch.Tensor] = None,
    dropout_rate: float = 0.0,
    dropout_seed: Optional[int] = None,
) -> torch.Tensor:
    """Fused cross-attention: q (b, h, lq, d), k/v (b, h, lkv, d) ->
    (b, lq, h * d). CUDA tensors launch the kernel; CPU tensors take the
    plain version. ``dropout_seed`` is the raw 32-bit hash seed, required
    when ``dropout_rate > 0``."""
    dropout_rate = float(dropout_rate)
    if dropout_rate > 0.0 and dropout_seed is None:
        raise ValueError("dropout_rate > 0 requires dropout_seed")
    if not q.is_cuda:
        out, _ = multihead_attention(
            q, k, v, scale=scale, temperature=temperature, kv_mask=kv_mask,
            dropout_rate=dropout_rate, dropout_seed=dropout_seed,
        )
        return out
    out, _ = flash_attention_kernel(
        q, k, v, kv_mask, float(scale) / float(temperature), dropout_rate,
        0 if dropout_seed is None else int(dropout_seed),
    )
    return out
