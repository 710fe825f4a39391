"""Functional attention core (the plain path).

Counterpart of ``healnet_tpu/ops/attention.py`` (forward): scores are
``q @ k^T * scale / temperature``; masked keys are filled AFTER the
temperature division; softmax; a row whose keys are all masked outputs zero;
optional coordinate-hash dropout on the normalised probabilities; weighted
sum over values. The flash kernel (:mod:`healnet_tpu_torch.ops.flash_attention`)
computes the same function with an online softmax.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from healnet_tpu_torch.ops.activations import mask_value
from healnet_tpu_torch.ops.hash_dropout import dense_keep_mask


def attention_scores(
    q: torch.Tensor,
    k: torch.Tensor,
    scale: float,
    temperature: float = 1.0,
    kv_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Masked, temperature-scaled probabilities ``(b, h, lq, lkv)``.

    q: ``(b, h, lq, d)``; k: ``(b, h, lkv, d)``; kv_mask: ``(b, lkv)`` bool,
    True = attend.
    """
    sim = torch.einsum("bhid,bhjd->bhij", q, k) * scale / temperature
    if kv_mask is not None:
        # a Python fill value: a device scalar made from the host would be a
        # blocking copy
        sim = sim.masked_fill(~kv_mask[:, None, None, :], mask_value(sim.dtype))
    return torch.softmax(sim, dim=-1)


def multihead_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    scale: float,
    temperature: float = 0.5,
    kv_mask: Optional[torch.Tensor] = None,
    dropout_rate: float = 0.0,
    dropout_seed: Optional[Union[int, torch.Tensor]] = None,
    return_weights: bool = False,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Attention over projected q/k/v; returns ``((b, lq, h * d), weights)``.

    ``dropout_seed`` is the raw 32-bit coordinate-hash seed; dropout applies
    only when it is given and ``dropout_rate > 0``.
    """
    attn = attention_scores(q, k, scale, temperature=temperature, kv_mask=kv_mask)
    if kv_mask is not None:
        valid = torch.any(kv_mask, dim=-1)[:, None, None, None]
        attn = attn * valid
    weights = attn if return_weights else None
    if dropout_rate > 0.0 and dropout_seed is not None:
        b, h, lq, lkv = attn.shape
        keep = dense_keep_mask(
            dropout_seed, b * h, lq, lkv, dropout_rate, device=attn.device
        ).reshape(b, h, lq, lkv)
        attn = torch.where(keep, attn / (1.0 - dropout_rate), torch.zeros_like(attn))
    out = torch.einsum("bhij,bhjd->bhid", attn, v)
    b, h, lq, d = out.shape
    out = out.transpose(1, 2).reshape(b, lq, h * d)
    return out, weights


def split_heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    """``(b, n, h * d) -> (b, h, n, d)`` as a view."""
    b, n, hd = x.shape
    return x.reshape(b, n, heads, hd // heads).transpose(1, 2)
