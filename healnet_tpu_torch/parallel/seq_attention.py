"""Sequence-parallel cross-attention: the keys and values sharded over
``seq``.

Counterpart of ``healnet_tpu/parallel/seq_attention.py``. The latent
queries are small and replicated over ``seq``; the context (a WSI bag) is
split along its tokens. Each rank takes online-softmax partials over its
own keys, and three collectives over ``seq`` combine them; no rank holds
the whole context or the whole (lq x lkv) weight matrix:

    local:  m_k = max_j s_kj ;  l_k = sum_j e^(s_kj - m_k) ;
            o_k = sum_j e^(s_kj - m_k) drop_kj v_j
    global: m = max_k m_k ;  out = sum_k(o_k e^(m_k - m)) / max(sum_k(l_k e^(m_k - m)), 1e-30)

The denominator is taken before dropout, and ``m`` carries no gradient
(the softmax is invariant to it). The per-shard products are torch ops, as
the JAX package computes them outside any Pallas kernel. The queries enter
through :func:`~healnet_tpu_torch.parallel.comm.sum_grad` (each shard's
gradient of them is a part) and the partials leave through
:func:`~healnet_tpu_torch.parallel.comm.all_sum`.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from healnet_tpu_torch.ops.activations import mask_value
from healnet_tpu_torch.ops.hash_dropout import hash_keep, hash_rows, keep_scale
from healnet_tpu_torch.parallel.comm import all_max, all_sum, sum_grad
from healnet_tpu_torch.parallel.mesh import AXIS_DATA, AXIS_MODEL, AXIS_SEQ, Mesh


def _local_attention_stats(q, k, v, kv_mask, scale, temperature, drop=None):
    """Per-shard online-softmax partials ``(m, l, o)``: (b, h, lq, 1) twice
    and (b, h, lq, d); ``drop`` multiplies the probabilities in ``o`` only."""
    sim = torch.einsum("bhid,bhjd->bhij", q, k) * (scale / temperature)
    if kv_mask is not None:
        kv_mask = kv_mask.to(torch.bool)
        sim = sim.masked_fill(~kv_mask[:, None, None, :], mask_value(sim.dtype))
    m = torch.amax(sim, dim=-1, keepdim=True).detach()
    p = torch.exp(sim - m)
    if kv_mask is not None:
        p = p * kv_mask[:, None, None, :].to(p.dtype)
    l = torch.sum(p, dim=-1, keepdim=True)
    if drop is not None:
        p = p * drop  # f32 multipliers, as in JAX: bf16 probabilities promote
    o = torch.einsum("bhij,bhjd->bhid", p, v.to(p.dtype))
    return m, l, o


def sequence_parallel_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mesh: Mesh,
    *,
    scale: float,
    temperature: float = 0.5,
    kv_mask: Optional[torch.Tensor] = None,
    axis: str = AXIS_SEQ,
    dropout_rate: float = 0.0,
    dropout_seed: Optional[Union[int, torch.Tensor]] = None,
    heads: Optional[int] = None,
) -> torch.Tensor:
    """Cross-attention over keys sharded along ``axis``; this rank's shards
    in, ``(b, lq, h * d)`` out, the same on every rank of ``axis``.

    q: ``(b, h, lq, d)``, the same on every rank of ``axis``; k, v: ``(b, h,
    lkv_local, d)``, this rank's keys; kv_mask: optional ``(b, lkv_local)``
    bool of those keys. ``b`` rows and ``h`` heads are this rank's: the
    batch is split over ``data`` (its first row ``data coordinate * b``),
    and with ``heads`` (the model's head count) above ``h`` the heads are
    split over ``model``. Dropout keeps with the coordinate hash at the
    global (batch*head row, query, key) coordinates, so every layout drops
    what the single-device run drops with ``dropout_seed``.
    """
    dropout_rate = float(dropout_rate)
    if dropout_rate > 0.0 and dropout_seed is None:
        raise ValueError("dropout_rate > 0 requires dropout_seed")
    group = mesh.group(axis)
    b, h, lq, _ = q.shape
    lkv = k.shape[2]
    total_heads = h if heads is None else int(heads)
    q = sum_grad(q, group)
    drop = None
    if dropout_rate > 0.0:
        h0 = mesh.coord(AXIS_MODEL) * h if total_heads > h else 0
        rows = hash_rows(b * h, mesh.coord(AXIS_DATA) * b * total_heads + h0, h, total_heads,
                         q.device).reshape(b, h, 1, 1)
        qid = torch.arange(lq, dtype=torch.int64, device=q.device).reshape(1, 1, lq, 1)
        kid = (mesh.coord(axis) * lkv
               + torch.arange(lkv, dtype=torch.int64, device=q.device)).reshape(1, 1, 1, lkv)
        keep = hash_keep(dropout_seed, rows, qid, kid, dropout_rate)
        drop = keep.to(torch.float32) * keep_scale(dropout_rate)
    m, l, o = _local_attention_stats(q, k, v, kv_mask, scale, temperature, drop=drop)
    m_global = all_max(m, group)
    correction = torch.exp(m - m_global)
    l_global = torch.clamp(all_sum(l * correction, group), min=1e-30)
    out = all_sum(o * correction, group) / l_global
    return out.transpose(1, 2).reshape(b, lq, h * out.shape[-1])
