"""Shared building blocks of the baselines.

Counterpart of ``healnet_tpu/models/baselines/common.py``:

- :func:`max_weights_dense`: a Dense with N(0, 1/sqrt(fan_in)) kernel and
  zero bias (the reference's ``init_max_weights``);
- :class:`AlphaDropout`: SELU-compatible dropout, dropped units set to
  -alpha' and an affine correction after (Klambauer et al., 2017);
- :class:`SNNBlock` (Linear + ELU + AlphaDropout), :class:`AttnNetGated`,
  :class:`BilinearFusion`;
- :class:`TransformerEncoderLayer` / :class:`TransformerEncoder`: torch
  ``nn.TransformerEncoder`` semantics (post-norm, ReLU feed-forward,
  LayerNorm eps 1e-5) over Flax's ``MultiHeadDotProductAttention``
  (:class:`MultiHeadDotProductAttention`).

Also the pieces the other baselines share: Flax's ``nn.Dropout``
(:func:`dropout`), ``nn.Conv`` with ``"SAME"`` padding (:class:`Conv`),
and the Flax initialisers (lecun-normal, orthogonal) drawn from a
``torch.Generator``.

Conventions of every baseline in the port. Parameters are float32 and
named after the Flax scopes, each kernel in the layout that
:mod:`healnet_tpu_torch.compat.flax_params` maps one to one. Dropout acts
in training mode (``.train()``) only, its keep masks drawn from the
``generator`` passed to ``forward`` (on the inputs' device), never from
the global RNG; training with dropout and no generator raises. Flax's
threefry masks are not reproduced. A module draws its initial weights from
the ``generator`` given to its constructor (again by
:meth:`reset_parameters`), by distribution as the JAX package does:
torch ``nn.Linear``'s uniform for ``torch_dense``, N(0, 1/sqrt(fan_in))
for :func:`max_weights_dense`, Flax's defaults elsewhere (lecun-normal
convolution, attention and GRU input kernels, orthogonal GRU recurrent
kernels, zero biases). A module built from inputs takes their per-sample
shapes, where Flax infers them at ``init``.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from healnet_tpu_torch.models.layers import Dense, LayerNorm, torch_dense

# SELU constants (match jax.nn.selu / torch)
_SELU_ALPHA = 1.6732632423543772
_SELU_SCALE = 1.0507009873554805
# lecun-normal: a normal truncated at 2 std, rescaled to unit variance
_TRUNC_STD = 0.87962566103423978


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator],
            training: bool) -> torch.Tensor:
    """Flax ``nn.Dropout``: in training, keep with probability ``1 - rate``
    and divide the kept values by it; the keep mask is drawn from
    ``generator`` on ``x``'s device."""
    if not training or rate == 0.0:
        return x
    if generator is None:
        raise ValueError("training with dropout needs a generator")
    if rate >= 1.0:
        return torch.zeros_like(x)
    keep = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def lecun_normal_(tensor: torch.Tensor, fan_in: int,
                  generator: Optional[torch.Generator]) -> torch.Tensor:
    """Flax's ``lecun_normal``: a normal truncated at +-2 std of variance
    ``1 / fan_in`` (by the inverse CDF of a uniform draw)."""
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    lo, hi = (math.erf(-math.sqrt(2.0)) + 1) / 2, (math.erf(math.sqrt(2.0)) + 1) / 2
    with torch.no_grad():
        tensor.uniform_(2 * lo - 1, 2 * hi - 1, generator=generator)
        return tensor.erfinv_().mul_(std * math.sqrt(2.0)).clamp_(-2.0 * std, 2.0 * std)


def orthogonal_(tensor: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
    """Flax's ``orthogonal`` on a square (or 2-D) kernel: Q of the QR of a
    standard normal draw, signs fixed by R's diagonal."""
    rows, cols = tensor.shape
    with torch.no_grad():
        a = torch.randn(max(rows, cols), min(rows, cols), generator=generator)
        q, r = torch.linalg.qr(a)
        q = q * torch.sign(torch.diagonal(r))
        return tensor.copy_(q if rows >= cols else q.t())


def reset_leaves(module: nn.Module, generator: Optional[torch.Generator]) -> None:
    """Redraw every leaf layer of ``module`` (those without children) in
    module order from ``generator``."""
    for m in module.modules():
        if next(m.children(), None) is None and hasattr(m, "reset_parameters"):
            m.reset_parameters(generator)


class Block(nn.Module):
    """A module whose weights live in its leaf layers:
    :meth:`reset_parameters` redraws them in module order."""

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        reset_leaves(self, generator)


class MaxDense(Dense):
    """``max_weights_dense``: N(0, 1/sqrt(fan_in)) kernel, zero bias."""

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        with torch.no_grad():
            self.weight.normal_(0.0, 1.0 / math.sqrt(self.in_features), generator=generator)
            self.bias.zero_()


def max_weights_dense(features: int, fan_in: int) -> MaxDense:
    """Dense with N(0, 1/sqrt(fan_in)) kernel and zero bias."""
    return MaxDense(fan_in, features)


class LecunDense(Dense):
    """Flax ``nn.Dense``'s defaults: lecun-normal kernel, zero bias."""

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        lecun_normal_(self.weight, self.in_features, generator)
        if self.bias is not None:
            with torch.no_grad():
                self.bias.zero_()


class OrthogonalDense(Dense):
    """A GRU cell's recurrent Dense: orthogonal kernel, zero bias."""

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        orthogonal_(self.weight, generator)
        if self.bias is not None:
            with torch.no_grad():
                self.bias.zero_()


def _same_pads(size: int, kernel: int, stride: int):
    """Flax ``"SAME"`` padding of one axis: (before, after)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """Flax ``nn.Conv`` with ``"SAME"`` padding over channels-last inputs
    ``(b, *spatial, in)``, one or two spatial axes; the weight in torch's
    layout ``(out, in, *kernel)``, lecun-normal over ``in * prod(kernel)``,
    zero bias."""

    def __init__(self, in_features: int, features: int, kernel_size: Sequence[int],
                 strides: Optional[Sequence[int]] = None):
        super().__init__()
        self.kernel_size = tuple(kernel_size)
        self.strides = tuple(strides) if strides is not None else (1,) * len(self.kernel_size)
        if len(self.kernel_size) not in (1, 2):
            raise ValueError("Conv takes one or two spatial axes")
        self.in_features = in_features
        self.weight = nn.Parameter(torch.empty(features, in_features, *self.kernel_size))
        self.bias = nn.Parameter(torch.empty(features))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        lecun_normal_(self.weight, self.in_features * math.prod(self.kernel_size), generator)
        with torch.no_grad():
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        spatial = x.shape[1:-1]
        pads = []  # F.pad takes the last axis first
        for size, k, s in reversed(list(zip(spatial, self.kernel_size, self.strides))):
            pads += _same_pads(size, k, s)
        x = x.to(torch.promote_types(x.dtype, self.weight.dtype))  # Flax's promotion
        h = F.pad(x.movedim(-1, 1), pads)
        conv = F.conv1d if len(self.kernel_size) == 1 else F.conv2d
        return conv(h, self.weight, self.bias, stride=self.strides).movedim(1, -1)


class AlphaDropout(nn.Module):
    """Self-normalising dropout for SELU networks (torch ``nn.AlphaDropout``)."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        if not self.training or self.rate == 0.0:
            return x
        if generator is None:
            raise ValueError("training with dropout needs a generator")
        alpha_p = -_SELU_ALPHA * _SELU_SCALE
        keep = 1.0 - self.rate
        mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
        a = (keep + alpha_p**2 * keep * (1 - keep)) ** -0.5
        b = -a * alpha_p * (1 - keep)
        return a * torch.where(mask, x, torch.full_like(x, alpha_p)) + b


class SNNBlock(Block):
    """Linear + ELU + AlphaDropout. ``max_init=True`` draws the Linear as
    :func:`max_weights_dense` (the standalone SNN's scheme)."""

    def __init__(self, features: int, dropout: float = 0.25, max_init: bool = False, *,
                 in_features: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.features, self.dropout, self.max_init = features, dropout, max_init
        dense = max_weights_dense if max_init else torch_dense
        self.fc = dense(features, in_features)
        self.alpha_dropout = AlphaDropout(dropout)
        self.reset_parameters(generator)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        return self.alpha_dropout(F.elu(self.fc(x)), generator)


class AttnNetGated(Block):
    """Gated attention network: A = W_c(tanh(W_a x) * sigmoid(W_b x));
    returns ``(scores, x)``."""

    def __init__(self, hidden: int = 256, n_classes: int = 1, dropout: float = 0.0, *,
                 in_features: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.hidden, self.n_classes, self.dropout = hidden, n_classes, dropout
        self.attention_a = torch_dense(hidden, in_features)
        self.attention_b = torch_dense(hidden, in_features)
        self.attention_c = torch_dense(n_classes, hidden)
        self.reset_parameters(generator)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        a = torch.tanh(self.attention_a(x))
        b = torch.sigmoid(self.attention_b(x))
        if self.dropout > 0:
            a = dropout(a, self.dropout, generator, self.training)
            b = dropout(b, self.dropout, generator, self.training)
        return self.attention_c(a * b), x


class BilinearFusion(Block):
    """Gated bilinear late-fusion block: gated, projected ``vec1`` and
    ``vec2``, each with a bias-1 column appended, fused by their outer
    product, then two Linear + ReLU layers."""

    def __init__(self, dim1: int = 128, dim2: int = 128, scale_dim1: int = 1,
                 scale_dim2: int = 1, mmhid: int = 256, dropout_rate: float = 0.25,
                 gate1: bool = True, gate2: bool = True, skip: bool = False, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dropout_rate, self.gate1, self.gate2, self.skip = dropout_rate, gate1, gate2, skip
        d1, d2 = dim1 // scale_dim1, dim2 // scale_dim2
        self.linear_h1 = torch_dense(d1, dim1)
        if gate1:
            self.linear_z1 = torch_dense(d1, dim1 + dim2)
        self.linear_o1 = torch_dense(d1, d1)
        self.linear_h2 = torch_dense(d2, dim2)
        if gate2:
            self.linear_z2 = torch_dense(d2, dim1 + dim2)
        self.linear_o2 = torch_dense(d2, d2)
        self.encoder1 = torch_dense(256, (d1 + 1) * (d2 + 1))
        self.encoder2 = torch_dense(mmhid, 256 + (dim1 + dim2 if skip else 0))
        self.reset_parameters(generator)

    def _branch(self, vec, both, h, z, o, gate, generator):
        out = F.relu(h(vec))
        if gate:
            out = torch.sigmoid(z(both)) * out
        out = F.relu(o(out))
        return dropout(out, self.dropout_rate, generator, self.training)

    def forward(self, vec1: torch.Tensor, vec2: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        both = torch.cat([vec1, vec2], dim=1)
        o1 = self._branch(vec1, both, self.linear_h1, getattr(self, "linear_z1", None),
                          self.linear_o1, self.gate1, generator)
        o2 = self._branch(vec2, both, self.linear_h2, getattr(self, "linear_z2", None),
                          self.linear_o2, self.gate2, generator)
        ones = torch.ones((o1.shape[0], 1), dtype=o1.dtype, device=o1.device)
        o1, o2 = torch.cat([o1, ones], dim=1), torch.cat([o2, ones], dim=1)
        o12 = torch.einsum("bi,bj->bij", o1, o2).reshape(o1.shape[0], -1)
        out = dropout(o12, self.dropout_rate, generator, self.training)
        out = F.relu(self.encoder1(out))
        out = dropout(out, self.dropout_rate, generator, self.training)
        if self.skip:
            out = torch.cat([out, vec1, vec2], dim=1)
        out = F.relu(self.encoder2(out))
        return dropout(out, self.dropout_rate, generator, self.training)


class HeadProjection(nn.Module):
    """Flax ``DenseGeneral(features=(heads, head_dim))``, the query / key /
    value projection of :class:`MultiHeadDotProductAttention`: weight
    ``(heads, head_dim, in)``, bias ``(heads, head_dim)``."""

    def __init__(self, in_features: int, heads: int, head_dim: int):
        super().__init__()
        self.in_features = in_features
        self.weight = nn.Parameter(torch.empty(heads, head_dim, in_features))
        self.bias = nn.Parameter(torch.empty(heads, head_dim))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        lecun_normal_(self.weight, self.in_features, generator)
        with torch.no_grad():
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(b, l, in) -> (b, l, heads, head_dim)."""
        return torch.einsum("bld,hkd->blhk", x, self.weight) + self.bias


class HeadOutput(nn.Module):
    """Flax ``DenseGeneral(features, axis=(-2, -1))``, the output projection
    of :class:`MultiHeadDotProductAttention`: weight ``(features, heads,
    head_dim)``, bias ``(features,)``."""

    def __init__(self, heads: int, head_dim: int, features: int):
        super().__init__()
        self.fan_in = heads * head_dim
        self.weight = nn.Parameter(torch.empty(features, heads, head_dim))
        self.bias = nn.Parameter(torch.empty(features))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        lecun_normal_(self.weight, self.fan_in, generator)
        with torch.no_grad():
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(b, l, heads, head_dim) -> (b, l, features)."""
        return torch.einsum("blhk,fhk->blf", x, self.weight) + self.bias


class MultiHeadDotProductAttention(nn.Module):
    """Flax ``nn.MultiHeadDotProductAttention`` (self-attention here):
    queries scaled by 1/sqrt(head_dim), softmax over keys, and in training
    dropout on the attention weights with ONE keep mask of shape ``(q, k)``
    shared by every batch row and head (``broadcast_dropout=True``)."""

    def __init__(self, num_heads: int, qkv_features: int, dropout_rate: float = 0.0, *,
                 in_features: int, out_features: Optional[int] = None):
        super().__init__()
        if qkv_features % num_heads:
            raise ValueError("qkv_features must be divisible by num_heads")
        self.num_heads, self.dropout_rate = num_heads, dropout_rate
        head_dim = qkv_features // num_heads
        self.query = HeadProjection(in_features, num_heads, head_dim)
        self.key = HeadProjection(in_features, num_heads, head_dim)
        self.value = HeadProjection(in_features, num_heads, head_dim)
        self.out = HeadOutput(num_heads, head_dim, out_features or in_features)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        q, k, v = self.query(x), self.key(x), self.value(x)
        q = q / math.sqrt(q.shape[-1])
        weights = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k), dim=-1)
        if self.training and self.dropout_rate > 0.0:
            if generator is None:
                raise ValueError("training with dropout needs a generator")
            keep_prob = 1.0 - self.dropout_rate
            keep = torch.rand(weights.shape[-2:], generator=generator,
                              device=weights.device) < keep_prob
            weights = weights * (keep.to(weights.dtype) / keep_prob)
        return self.out(torch.einsum("bhqk,bkhd->bqhd", weights, v))


class TransformerEncoderLayer(Block):
    """torch ``nn.TransformerEncoderLayer`` semantics: post-norm, ReLU FF."""

    def __init__(self, d_model: int = 256, nhead: int = 8, dim_feedforward: int = 512,
                 dropout: float = 0.25, *, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dropout = dropout
        self.self_attn = MultiHeadDotProductAttention(nhead, d_model, dropout,
                                                      in_features=d_model)
        self.norm1 = LayerNorm(d_model)
        self.linear1 = torch_dense(dim_feedforward, d_model)
        self.linear2 = torch_dense(d_model, dim_feedforward)
        self.norm2 = LayerNorm(d_model)
        self.reset_parameters(generator)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        attn = self.self_attn(x, generator)
        x = self.norm1(x + dropout(attn, self.dropout, generator, self.training))
        ff = F.relu(self.linear1(x))
        ff = self.linear2(dropout(ff, self.dropout, generator, self.training))
        return self.norm2(x + dropout(ff, self.dropout, generator, self.training))


class TransformerEncoder(Block):
    """Stack of encoder layers (torch ``nn.TransformerEncoder``), named
    ``layer_{i}``."""

    def __init__(self, num_layers: int = 2, d_model: int = 256, nhead: int = 8,
                 dim_feedforward: int = 512, dropout: float = 0.25, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"layer_{i}", TransformerEncoderLayer(
                d_model, nhead, dim_feedforward, dropout, generator=generator))

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        for i in range(self.num_layers):
            x = getattr(self, f"layer_{i}")(x, generator)
        return x
