"""Functional attention core (the plain path).

Counterpart of ``healnet_tpu/ops/attention.py`` (forward): scores are
``q @ k^T * scale / temperature``; masked keys are filled AFTER the
temperature division; softmax; a row whose keys are all masked outputs zero;
optional coordinate-hash dropout on the normalised probabilities (or, under
``mask_family("threefry")``, a Bernoulli mask from the call's generator);
weighted sum over values. The flash kernel
(:mod:`healnet_tpu_torch.ops.flash_attention`) computes the same function with
an online softmax. :func:`streaming_attention_stats` computes it in KV chunks
with the reductions of the probability map that inspection needs, never
holding the whole map.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from healnet_tpu_torch.ops.activations import mask_value
from healnet_tpu_torch.ops.hash_dropout import dense_keep_mask, hash_keep, mask_family


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
    generator: Optional[torch.Generator] = None,
    row_offset: int = 0,
    kv_offset: int = 0,
    head_stride: int = 0,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Attention over projected q/k/v; returns ``((b, lq, h * d), weights)``.

    ``dropout_seed`` is the raw 32-bit coordinate-hash seed; dropout applies
    only when it is given and ``dropout_rate > 0``. Under
    ``mask_family("threefry")`` the keep mask is drawn from ``generator`` (on
    the inputs' device) instead of the hash. ``row_offset``, ``kv_offset``
    and ``head_stride`` (0: ``h``) place a shard's rows and keys at their
    global hash coordinates (:func:`~healnet_tpu_torch.ops.hash_dropout.
    hash_rows`).
    """
    attn = attention_scores(q, k, scale, temperature=temperature, kv_mask=kv_mask)
    if kv_mask is not None:
        valid = torch.any(kv_mask, dim=-1)[:, None, None, None]
        attn = attn * valid
    weights = attn if return_weights else None
    if dropout_rate > 0.0 and dropout_seed is not None:
        b, h, lq, lkv = attn.shape
        if mask_family() == "threefry":
            if generator is None:
                raise ValueError("threefry attention dropout needs a generator")
            keep = torch.rand(attn.shape, generator=generator, device=attn.device) \
                < 1.0 - dropout_rate
        else:
            keep = dense_keep_mask(
                dropout_seed, b * h, lq, lkv, dropout_rate, device=attn.device,
                row_offset=row_offset, kv_offset=kv_offset, heads=h, head_stride=head_stride,
            ).reshape(b, h, lq, lkv)
        attn = torch.where(keep, attn / (1.0 - dropout_rate), torch.zeros_like(attn))
    out = torch.einsum("bhij,bhjd->bhid", attn, v)
    b, h, lq, d = out.shape
    out = out.transpose(1, 2).reshape(b, lq, h * d)
    return out, weights


def streaming_attention_stats(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    scale: float,
    temperature: float = 0.5,
    kv_mask: Optional[torch.Tensor] = None,
    chunk: int = 2048,
    dropout_rate: float = 0.0,
    dropout_seed: Optional[Union[int, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Attention output and inspection statistics from KV chunks.

    Counterpart of ``healnet_tpu/ops/attention.py::streaming_attention_stats``:
    two passes over chunks of ``chunk`` keys (the last zero-padded), the
    first for each query row's log-sum-exp, the second for the normalised
    probabilities of each chunk, so the largest attention tensor is ``(b,
    h, lq, chunk)``. The contract is :func:`multihead_attention`'s: scores
    scaled by ``scale / temperature`` and masked after that division, a row
    whose keys are all masked outputs zero and adds nothing to the
    statistics, the statistics come from the probabilities before dropout
    and the output from those after it, through the coordinate-hash keep
    mask at absolute KV coordinates (the same mask as the dense path's).

    Returns ``(out (b, lq, h * d), stats)``: ``colsum`` (b, lkv) f32, each
    key's probability summed over heads and queries; ``psum`` and
    ``psumsq``, 0-d f32, the map's sum and sum of squares, added one
    chunk's sum at a time; ``count``, its element count.
    """
    b, h, lq, _ = q.shape
    lkv = k.shape[2]
    chunk = max(1, min(int(chunk), lkv))
    nc = -(-lkv // chunk)
    pad = nc * chunk - lkv
    fill = mask_value(torch.float32)
    dev = q.device

    mask = torch.ones((b, lkv), dtype=torch.bool, device=dev) if kv_mask is None \
        else kv_mask.to(torch.bool)
    valid = torch.any(mask, dim=-1)[:, None, None, None]
    if pad:
        k = F.pad(k, (0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, pad))
        mask = F.pad(mask, (0, pad))
    qf = q.float()
    inv_t = float(scale) / float(temperature)

    def sim_chunk(c):
        sl = slice(c * chunk, (c + 1) * chunk)
        s = torch.einsum("bhid,bhjd->bhij", qf, k[:, :, sl].float()) * inv_t
        return s.masked_fill(~mask[:, None, None, sl], fill)

    # pass 1: the running max and denominator of each query row
    m = torch.full((b, h, lq), fill, dtype=torch.float32, device=dev)
    s = torch.zeros((b, h, lq), dtype=torch.float32, device=dev)
    for c in range(nc):
        sim = sim_chunk(c)
        m_new = torch.maximum(m, sim.amax(dim=-1))
        s = s * torch.exp(m - m_new) + torch.exp(sim - m_new[..., None]).sum(dim=-1)
        m = m_new
    lse = m + torch.log(torch.clamp(s, min=1e-30))

    drop = dropout_rate > 0.0 and dropout_seed is not None
    if drop:
        ids = lambda n: torch.arange(n, dtype=torch.int64, device=dev)
        rid, qid = ids(b * h).reshape(b, h, 1, 1), ids(lq).reshape(1, 1, lq, 1)

    # pass 2: each chunk's probabilities -> output and reductions
    acc = torch.zeros((b, h, lq, v.shape[-1]), dtype=torch.float32, device=dev)
    cols = []
    psum = torch.zeros((), dtype=torch.float32, device=dev)
    psumsq = torch.zeros((), dtype=torch.float32, device=dev)
    for c in range(nc):
        probs = torch.exp(sim_chunk(c) - lse[..., None]) * valid
        cols.append(probs.sum(dim=(1, 2)))
        psum = psum + probs.sum()
        psumsq = psumsq + torch.square(probs).sum()
        if drop:
            kvid = (c * chunk + ids(chunk)).reshape(1, 1, 1, chunk)
            keep = hash_keep(dropout_seed, rid, qid, kvid, dropout_rate)
            probs = torch.where(keep, probs / (1.0 - dropout_rate), torch.zeros_like(probs))
        acc = acc + torch.einsum("bhij,bhjd->bhid", probs,
                                 v[:, :, c * chunk:(c + 1) * chunk].float())
    out = acc.to(q.dtype).transpose(1, 2).reshape(b, lq, h * v.shape[-1])
    stats = {
        "colsum": torch.cat(cols, dim=1)[:, :lkv],
        "psum": psum,
        "psumsq": psumsq,
        "count": torch.tensor(float(b * h * lq * lkv), dtype=torch.float32),
    }
    return out, stats


def split_heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    """``(b, n, h * d) -> (b, h, n, d)`` as a view."""
    b, n, hd = x.shape
    return x.reshape(b, n, heads, hd // heads).transpose(1, 2)
