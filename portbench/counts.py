"""Operations and bytes of the work a cell does, from its config's shapes.

Operations are the matrix products' multiply-adds, two each, as the model
needs them with no recompute; elementwise work (norms, softmax, masks) is
not counted. A training step is the forward and the backward: every
product's backward costs two products (an input's and a weight's
gradient), except the context projection's, whose inputs are data and
need no gradient (one). Bytes are each input and output of a call read or
written once, whatever a kernel reads again.
"""

from __future__ import annotations

from typing import Iterable

#: NVIDIA H100 SXM data sheet: dense bf16 tensor-core rate, HBM3 bandwidth
PEAK_FLOPS_BF16 = 989e12
PEAK_BYTES_PER_S = 3.35e12


def enc_dim(cfg: dict) -> int:
    """Fourier channels of a one-axis modality."""
    return 2 * int(cfg["num_freq_bands"]) + 1 if cfg["fourier_encode_data"] else 0


def kv_width(cfg: dict) -> int:
    """Columns of one layer's merged K|V projection."""
    return 2 * int(cfg["cross_heads"]) * int(cfg["cross_dim_head"])


def projection_flops(cfg: dict, tokens: int) -> float:
    """Forward of one sample's context projections: every layer's K|V of the
    omic vector and of a slide of ``tokens`` tokens."""
    e = enc_dim(cfg)
    rows = (cfg["omic_dim"] + e) + tokens * (cfg["wsi_dim"] + e)
    return 2.0 * rows * cfg["depth"] * kv_width(cfg)


def latent_flops(cfg: dict, tokens: int) -> float:
    """Forward of one sample's latent path: the cross-attentions over the
    omic token and ``tokens`` slide tokens, the feed-forwards, the head."""
    lc, ld = cfg["num_latents"], cfg["latent_dim"]
    heads, d = cfg["cross_heads"], cfg["cross_dim_head"]
    total = 0.0
    for n in (1, tokens):
        attn = 2.0 * lc * ld * heads * d * 2 + 4.0 * heads * lc * n * d
        ff = 2.0 * lc * ld * 8 * ld + 2.0 * lc * 4 * ld * ld
        total += attn + ff
    return cfg["depth"] * total + 2.0 * ld * cfg["output_dims"]


def train_flops(cfg: dict, tokens: int) -> float:
    """Forward and backward of one training sample."""
    return 2.0 * projection_flops(cfg, tokens) + 3.0 * latent_flops(cfg, tokens)


def eval_flops(cfg: dict, tokens: int) -> float:
    return projection_flops(cfg, tokens) + latent_flops(cfg, tokens)


def fold_flops(cfg: dict, train_lengths: Iterable[int], val_lengths: Iterable[int],
               epochs: int, eval_epochs: int) -> float:
    """A fold's model operations over its patients' real bag lengths."""
    return (epochs * sum(train_flops(cfg, int(n)) for n in train_lengths)
            + eval_epochs * sum(eval_flops(cfg, int(n)) for n in val_lengths))


def projection_cost(cfg: dict, b: int, tokens: int):
    """(operations, bytes) of the model's context projections of a batch,
    forward and weight backward: int8 slide values and f32 scales, f32
    omic, f32 weights and LayerNorm affines, bf16 outputs and cotangents,
    f32 weight gradients."""
    e, f = enc_dim(cfg), cfg["depth"] * kv_width(cfg)
    flops = 2.0 * b * projection_flops(cfg, tokens)
    inputs = b * cfg["omic_dim"] * 4 + b * tokens * (cfg["wsi_dim"] + 4) + (tokens + 1) * e * 2
    weights = sum((c + e) * (f + 2 * cfg["depth"]) * 4 for c in (cfg["omic_dim"], cfg["wsi_dim"]))
    outputs = b * (1 + tokens) * f * 2
    return flops, inputs + 2 * weights + 2 * outputs


def attention_cost(cfg: dict, b: int, tokens: int):
    """(operations, bytes) of one cross-attention module over a slide,
    forward and backward: bf16 latents and K|V (and their gradients), the
    key mask, f32 weights (and their gradients)."""
    lc, ld = cfg["num_latents"], cfg["latent_dim"]
    inner = cfg["cross_heads"] * cfg["cross_dim_head"]
    flops = 3.0 * b * (2.0 * lc * ld * inner * 2 + 4.0 * cfg["cross_heads"] * lc * tokens
                       * cfg["cross_dim_head"])
    latents = b * lc * ld * 2
    kv = b * tokens * 2 * inner * 2
    weights = (2 * inner * ld + ld) * 4
    return flops, 4 * latents + 2 * kv + b * tokens + 2 * weights


def bound_s(flops: float, nbytes: float) -> float:
    """Least seconds for the work on the card: operations over the bf16
    peak or bytes over the bandwidth, whichever is longer."""
    return max(flops / PEAK_FLOPS_BF16, nbytes / PEAK_BYTES_PER_S)
