"""HealNet building blocks: Dense, LayerNorm, FeedForward, FoldedKV,
Attention and the PreNorm wrappers.

Counterpart of ``healnet_tpu/models/layers.py``. Parameters are float32 and
named after the Flax scopes (``to_q``, ``to_kv``, ``to_out``, ``net_0``,
``net_2``, ``norm``, ``norm_context``), so a Flax parameter tree converts
one to one (:mod:`healnet_tpu_torch.compat.flax_params`). A module's
``dtype`` is its compute dtype, as in Flax: weights are cast to it at each
call and stay float32 in the state dict.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from healnet_tpu_torch.ops.activations import gated_gelu, gated_selu
from healnet_tpu_torch.ops.attention import multihead_attention, split_heads
from healnet_tpu_torch.ops.flash_attention import flash_cross_attention
from healnet_tpu_torch.ops.fused_project import split_columns


def _compute_dtype(x: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.dtype:
    """Flax's promotion: the module dtype, else at least float32."""
    return dtype if dtype is not None else torch.promote_types(x.dtype, torch.float32)


class Dense(nn.Module):
    """Flax ``nn.Dense`` semantics over a torch-layout (out, in) weight."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.in_features, self.features, self.dtype = in_features, features, dtype
        self.weight = nn.Parameter(torch.empty(features, in_features))
        self.bias = nn.Parameter(torch.empty(features)) if use_bias else None

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """torch ``nn.Linear`` default: U(+-1/sqrt(fan_in)) for both."""
        bound = 1.0 / math.sqrt(self.in_features)
        with torch.no_grad():
            self.weight.uniform_(-bound, bound, generator=generator)
            if self.bias is not None:
                self.bias.uniform_(-bound, bound, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = _compute_dtype(x, self.dtype)
        y = x.to(dt) @ self.weight.to(dt).t()
        if self.bias is not None:
            y = y + self.bias.to(dt)
        return y


def torch_dense(features: int, fan_in: int, use_bias: bool = True,
                dtype: Optional[torch.dtype] = None) -> Dense:
    """Dense with torch ``nn.Linear`` default initialisation."""
    return Dense(fan_in, features, use_bias=use_bias, dtype=dtype)


class LayerNorm(nn.Module):
    """Flax ``nn.LayerNorm(epsilon=1e-5)``: f32 statistics with the fast
    variance E[x^2] - E[x]^2 clipped at zero, output in ``dtype``."""

    def __init__(self, dim: int, dtype: Optional[torch.dtype] = None, eps: float = 1e-5):
        super().__init__()
        self.dtype, self.eps = dtype, eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = torch.clamp((xf * xf).mean(dim=-1, keepdim=True) - mean * mean, min=0.0)
        y = (xf - mean) * (torch.rsqrt(var + self.eps) * self.weight)
        y = y + self.bias
        return y.to(_compute_dtype(x, self.dtype))


class LayerNormAffine(nn.Module):
    """Holds a LayerNorm's ``weight``/``bias`` without applying them (they
    fold into the KV projection)."""

    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    reset_parameters = LayerNorm.reset_parameters

    def forward(self) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.weight, self.bias


class FeedForward(nn.Module):
    """Linear(d -> 2 d mult) -> gated SELU/GELU -> Linear(d mult -> d) ->
    dropout.

    Dropout (training only) follows Flax's ``nn.Dropout``: keep with
    probability ``1 - rate``, kept values divided by ``1 - rate``. The keep
    mask is drawn from the ``generator`` passed to :meth:`forward` (on the
    input's device), never from the global RNG; Flax's threefry masks are
    not reproduced.
    """

    def __init__(self, dim: int, mult: int = 4, dropout: float = 0.0, snn: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.snn, self.dropout = snn, dropout
        self.net_0 = torch_dense(dim * mult * 2, dim, dtype=dtype)
        self.net_2 = torch_dense(dim, dim * mult, dtype=dtype)

    def draws_dropout(self) -> bool:
        return self.training and self.dropout > 0.0

    def keep_mask(self, shape, generator: Optional[torch.Generator],
                  device: torch.device) -> torch.Tensor:
        """The dropout keep mask of an output of ``shape``, from ``generator``."""
        if generator is None:
            raise ValueError("FeedForward dropout needs a generator")
        return torch.rand(shape, generator=generator, device=device) < 1.0 - self.dropout

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``keep``: a keep mask drawn beforehand (:meth:`keep_mask`), else
        one is drawn here from ``generator``."""
        h = self.net_0(x)
        h = gated_selu(h) if self.snn else gated_gelu(h)
        h = self.net_2(h)
        if self.draws_dropout():
            if keep is None:
                keep = self.keep_mask(h.shape, generator, h.device)
            h = torch.where(keep, h / (1.0 - self.dropout), torch.zeros_like(h))
        return h


class FoldedKV(nn.Module):
    """``to_kv`` projection whose weights can take a LayerNorm affine:
    ``(x_hat * s + b) @ W = x_hat @ (s . W) + b @ W`` (:meth:`fold`)."""

    def __init__(self, features: int, in_features: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.in_features, self.dtype = in_features, dtype
        self.weight = nn.Parameter(torch.empty(features, in_features))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        bound = 1.0 / math.sqrt(self.in_features)
        with torch.no_grad():
            self.weight.uniform_(-bound, bound, generator=generator)

    def fold(self, scale: torch.Tensor, bias: torch.Tensor):
        """``(scale . W, bias @ W)`` in the (in, out) layout, float32."""
        kernel = self.weight.t()
        return kernel * scale[:, None], bias @ kernel

    def forward(self, x, scale=None, bias=None):
        """``x @ W``, or with a LayerNorm affine ``(scale, bias)`` folded in."""
        kernel, folded_bias = self.weight.t(), None
        if scale is not None:
            kernel, folded_bias = self.fold(scale, bias)
        if self.dtype is not None:
            x, kernel = x.to(self.dtype), kernel.to(self.dtype)
        y = x @ kernel
        if folded_bias is not None:
            y = y + folded_bias.to(y.dtype)
        return y


class Attention(nn.Module):
    """Cross/self attention with temperature-0.5 softmax.

    ``attention_impl``: ``"xla"`` the plain path, ``"flash"`` the flash
    kernels (plain version on the CPU), ``"auto"`` flash on the card where
    the JAX package's rule picks it. ``dropout`` applies in training to the
    normalised probabilities, with the coordinate-hash keep mask of the
    per-call ``dropout_seed``, on both paths.
    """

    def __init__(self, query_dim: int, context_dim: Optional[int] = None, heads: int = 8,
                 dim_head: int = 64, dropout: float = 0.0, temperature: float = 0.5,
                 attention_impl: str = "xla", dtype: Optional[torch.dtype] = None):
        super().__init__()
        if attention_impl not in ("xla", "flash", "auto"):
            raise ValueError(f"unknown attention impl: {attention_impl!r}")
        inner = dim_head * heads
        ctx_dim = context_dim if context_dim is not None else query_dim
        self.heads, self.dim_head, self.dropout = heads, dim_head, dropout
        self.temperature, self.attention_impl = temperature, attention_impl
        self.to_q = torch_dense(inner, query_dim, use_bias=False, dtype=dtype)
        self.to_kv = FoldedKV(inner * 2, in_features=ctx_dim, dtype=dtype)
        self.to_out = torch_dense(query_dim, inner, dtype=dtype)

    def kv_fold(self, scale, bias):
        return self.to_kv.fold(scale, bias)

    def forward(self, x, context=None, kv_mask=None, kv=None,
                dropout_seed: Optional[Union[int, torch.Tensor]] = None,
                return_weights: bool = False,
                ctx_scale=None, ctx_bias=None):
        """``kv``: precomputed (b, tokens, 2 * inner) merged-KV slice;
        ``dropout_seed``: the raw 32-bit hash seed of this call (an int, or
        a one-element tensor on the inputs' device), required in training
        when ``dropout > 0``; ``ctx_scale`` / ``ctx_bias``: a
        LayerNorm affine folded into ``to_kv`` over an already normalised
        ``context``. Returns ``(out, weights)``: the post-softmax,
        pre-dropout weights ``(b, h, lq, lkv)`` with ``return_weights``
        (always on the plain path), else None."""
        inner = self.dim_head * self.heads
        scale = self.dim_head**-0.5
        rate = self.dropout if self.training else 0.0
        if rate > 0.0 and dropout_seed is None:
            raise ValueError("attention dropout needs a dropout_seed")
        q = self.to_q(x)
        if kv is None:
            kv = self.to_kv(x if context is None else context, scale=ctx_scale, bias=ctx_bias)
        k, v = split_columns(kv, (inner, inner))
        qh, kh, vh = (split_heads(t, self.heads) for t in (q, k, v))
        kw = dict(scale=scale, temperature=self.temperature, kv_mask=kv_mask,
                  dropout_rate=rate, dropout_seed=dropout_seed)
        weights = None
        # capture needs the materialised weights: the plain path, as in JAX
        if not return_weights and self._should_use_flash(rate, qh.shape[0], qh.shape[2],
                                                         kh.shape[2], qh.is_cuda):
            out = flash_cross_attention(qh, kh, vh, **kw)
        else:
            out, weights = multihead_attention(qh, kh, vh, return_weights=return_weights, **kw)
        return F.leaky_relu(self.to_out(out), negative_slope=1e-2), weights

    def _should_use_flash(self, dropout_rate: float, b: int, lq: int, lkv: int,
                          on_card: bool) -> bool:
        if self.attention_impl == "flash":
            return True
        if self.attention_impl == "auto":
            if not on_card:
                return False
            # the JAX package's rule as it stands; its thresholds were
            # measured on a TPU and are still to be re-measured on the card
            weights_bytes = b * self.heads * lq * lkv * 4
            big_weights = weights_bytes > 2 * 1024**3
            flash_regime = dropout_rate == 0.0 and lq >= 2 * self.dim_head and lkv >= 8192
            return flash_regime or big_weights
        return False


class PreNormAttention(nn.Module):
    """LayerNorm on the query (and on a given context) before Attention.

    The model passes ``kv``, the merged projection of the raw context with
    this layer's ``norm_context`` affine folded in (:meth:`kv_fold`); a raw
    ``context`` is normalized here instead.
    """

    def __init__(self, query_dim: int, context_dim: Optional[int] = None, heads: int = 8,
                 dim_head: int = 64, dropout: float = 0.0, temperature: float = 0.5,
                 attention_impl: str = "xla", dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.norm = LayerNorm(query_dim, dtype=dtype)
        self.norm_context = LayerNormAffine(context_dim) if context_dim is not None else None
        self.fn = Attention(query_dim, context_dim, heads=heads, dim_head=dim_head,
                            dropout=dropout, temperature=temperature,
                            attention_impl=attention_impl, dtype=dtype)

    def kv_fold(self):
        """This layer's context-KV weights with its LayerNorm affine folded."""
        scale, bias = self.norm_context()
        return self.fn.kv_fold(scale, bias)

    def forward(self, x, context=None, kv_mask=None, kv=None, dropout_seed=None,
                return_weights: bool = False, context_normalized: bool = False):
        """``context_normalized``: ``context`` is the shared normalised
        context (the remat path); this layer's ``norm_context`` affine is
        then folded into ``to_kv`` instead of applied over the context."""
        normed = self.norm(x)
        normed_ctx = ctx_scale = ctx_bias = None
        if kv is None and context is not None:
            if context_normalized:
                ctx_scale, ctx_bias = self.norm_context()
                normed_ctx = context
            else:
                scale_p, bias_p = self.norm_context()
                xf = context.float()
                mu = xf.mean(dim=-1, keepdim=True)
                var = (xf * xf).mean(dim=-1, keepdim=True) - mu * mu
                xhat = (xf - mu) * torch.rsqrt(var + 1e-5)
                normed_ctx = (xhat * scale_p + bias_p).to(self.dtype or context.dtype)
        return self.fn(normed, context=normed_ctx, kv_mask=kv_mask, kv=kv,
                       dropout_seed=dropout_seed, return_weights=return_weights,
                       ctx_scale=ctx_scale, ctx_bias=ctx_bias)


class PreNormFeedForward(nn.Module):
    """LayerNorm before FeedForward."""

    def __init__(self, dim: int, mult: int = 4, dropout: float = 0.0, snn: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.norm = LayerNorm(dim, dtype=dtype)
        self.fn = FeedForward(dim, mult=mult, dropout=dropout, snn=snn, dtype=dtype)

    def forward(self, x, generator: Optional[torch.Generator] = None,
                keep: Optional[torch.Tensor] = None):
        return self.fn(self.norm(x), generator=generator, keep=keep)
