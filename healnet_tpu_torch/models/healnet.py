"""HealNet fusion model (forward, for inference and training).

Counterpart of ``healnet_tpu/models/healnet.py::HealNetModule``: a shared
latent bottleneck array, per-modality cross-attention and feed-forward with
residuals, optional latent self-attention blocks, Fourier positional
encodings, and a mean-pool -> LayerNorm -> Linear head.

- Missing modalities: a per-sample ``presence`` vector gates each modality's
  residual updates to zero, so the shapes never depend on availability.
- Weight tying (``weight_tie_layers``): layer 0 keeps its own modules,
  layers >= 1 share one group, and the cross feed-forward of that group is
  one module across modalities (the reference's ``cache_fn`` semantics).
- Merged KV projection: every fusion layer's KV depends only on the context,
  so all layer groups project in ONE product per modality over the raw
  context, with each layer's context-LayerNorm folded into the weights
  (:func:`healnet_tpu_torch.ops.fused_project.fused_kv_project`).

Submodules are named after the Flax scopes (``layer{key}_cross_attn_m{m}``,
``layer{key}_cross_ff_m{m}`` / ``_shared``, ``layer{key}_self_attn_b{blk}``,
``layer{key}_self_ff_b{blk}``, ``latents``, ``final_norm``, ``final_head``).
- Dropout (``.train()`` with a rate above 0): every attention call, tied
  layers included, gets a fresh 32-bit hash seed (JAX's ``make_rng`` gives
  each call its own stream) and the feed-forward masks come from an
  explicit ``torch.Generator``; see :meth:`HealNetModule.forward`.

- Int8 contexts: a modality may arrive as a
  :class:`healnet_tpu_torch.ops.quantize.QuantizedContext` (per-token int8
  values and f32 scales). It is not cast; its encoding and its projection
  are in the compute dtype (``dtype``, float32 when None), and the merged
  projection reads the int8 values and rescales on the accumulator.

Rematerialisation, meshes and attention capture are not ported yet.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from healnet_tpu_torch.device import DeviceLike, resolve_device
from healnet_tpu_torch.models.layers import (
    LayerNorm,
    PreNormAttention,
    PreNormFeedForward,
    torch_dense,
)
from healnet_tpu_torch.ops.fourier import positional_encoding
from healnet_tpu_torch.ops.fused_project import fused_kv_project, split_columns
from healnet_tpu_torch.ops.quantize import QuantizedContext


def _tie_key(layer: int, weight_tie_layers: bool) -> int:
    """Module-sharing group of a fusion layer: layer 0 is always its own;
    layers >= 1 share one group when tying is on."""
    if layer == 0:
        return 0
    return 1 if weight_tie_layers else layer


class HealNetModule(nn.Module):
    """HealNet core. ``forward(tensors, presence=None, kv_masks=None)``:

    tensors: one tensor per modality, ``(b, *spatial_i, channels_i)``, or a
    :class:`QuantizedContext` of that shape;
    presence: optional ``(b, n_modalities)``, 1 where the modality exists;
    kv_masks: optional per-modality bool masks ``(b, tokens_i)`` (True =
    attend) for padded contexts.

    ``device``: where the parameters live, the GPU unless ``"cpu"`` is
    asked for. ``generator``: the seeded ``torch.Generator`` (CPU) that
    draws the initial weights; the same seed gives the same weights on
    every device.
    """

    def __init__(
        self,
        n_modalities: int,
        channel_dims: Sequence[int],
        num_spatial_axes: Sequence[int],
        out_dims: int,
        depth: int = 3,
        num_freq_bands: int = 2,
        max_freq: float = 10.0,
        l_c: int = 128,
        l_d: int = 128,
        x_heads: int = 8,
        l_heads: int = 8,
        cross_dim_head: int = 64,
        latent_dim_head: int = 64,
        attn_dropout: float = 0.0,
        ff_dropout: float = 0.0,
        weight_tie_layers: bool = False,
        fourier_encode_data: bool = True,
        self_per_cross_attn: int = 1,
        final_classifier_head: bool = True,
        snn: bool = True,
        attention_impl: str = "xla",
        projection_impl: str = "auto",
        dtype: Optional[torch.dtype] = None,
        device: DeviceLike = None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        device = resolve_device(device)
        if not (len(channel_dims) == len(num_spatial_axes) == n_modalities):
            raise ValueError("channel_dims and num_spatial_axes need one entry per modality")
        self.n_modalities = n_modalities
        self.channel_dims = tuple(channel_dims)
        self.num_spatial_axes = tuple(num_spatial_axes)
        self.out_dims = out_dims
        self.depth = depth
        self.num_freq_bands, self.max_freq = num_freq_bands, max_freq
        self.l_c, self.l_d = l_c, l_d
        self.x_heads, self.l_heads = x_heads, l_heads
        self.cross_dim_head, self.latent_dim_head = cross_dim_head, latent_dim_head
        self.attn_dropout, self.ff_dropout = attn_dropout, ff_dropout
        self.weight_tie_layers = weight_tie_layers
        self.fourier_encode_data = fourier_encode_data
        self.self_per_cross_attn = self_per_cross_attn
        self.final_classifier_head = final_classifier_head
        self.snn = snn
        self.attention_impl, self.projection_impl = attention_impl, projection_impl
        self.dtype = dtype

        input_dims = self.input_dims()
        # group key -> submodule names per role (modules registered by name)
        self.groups: Dict[int, Dict[str, List[str]]] = {}
        for layer in range(depth):
            key = _tie_key(layer, weight_tie_layers)
            if key in self.groups:
                continue
            group = {"cross_attns": [], "cross_ffs": [], "self_attns": [], "self_ffs": []}
            for m in range(n_modalities):
                name = f"layer{key}_cross_attn_m{m}"
                self.add_module(name, PreNormAttention(
                    l_d, input_dims[m], heads=x_heads, dim_head=cross_dim_head,
                    dropout=attn_dropout, attention_impl=attention_impl, dtype=dtype,
                ))
                group["cross_attns"].append(name)
            if key >= 1 and weight_tie_layers:
                name = f"layer{key}_cross_ff_shared"
                self.add_module(name, PreNormFeedForward(
                    l_d, dropout=ff_dropout, snn=snn, dtype=dtype))
                group["cross_ffs"] = [name] * n_modalities
            else:
                for m in range(n_modalities):
                    name = f"layer{key}_cross_ff_m{m}"
                    self.add_module(name, PreNormFeedForward(
                        l_d, dropout=ff_dropout, snn=snn, dtype=dtype))
                    group["cross_ffs"].append(name)
            for blk in range(self_per_cross_attn):
                name = f"layer{key}_self_attn_b{blk}"
                self.add_module(name, PreNormAttention(
                    l_d, heads=l_heads, dim_head=latent_dim_head,
                    dropout=attn_dropout, attention_impl=attention_impl, dtype=dtype,
                ))
                group["self_attns"].append(name)
                name = f"layer{key}_self_ff_b{blk}"
                self.add_module(name, PreNormFeedForward(
                    l_d, dropout=ff_dropout, snn=snn, dtype=dtype))
                group["self_ffs"].append(name)
            self.groups[key] = group

        self.latents = nn.Parameter(torch.empty(l_c, l_d))
        if final_classifier_head:
            self.final_norm = LayerNorm(l_d, dtype=dtype)
            self.final_head = torch_dense(out_dims, l_d, dtype=dtype)
        self.reset_parameters(generator)
        self.to(device)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Initial weights: torch ``nn.Linear`` defaults, unit LayerNorms,
        N(0, 1) latents, drawn in module order from ``generator``."""
        with torch.no_grad():
            self.latents.normal_(0.0, 1.0, generator=generator)
        for module in self.modules():
            if module is not self and hasattr(module, "reset_parameters"):
                module.reset_parameters(generator)

    def input_dims(self) -> List[int]:
        """Per-modality context dims after the Fourier concat."""
        dims = []
        for axis, channels in zip(self.num_spatial_axes, self.channel_dims):
            f_channels = axis * (2 * self.num_freq_bands + 1) if self.fourier_encode_data else 0
            dims.append(f_channels + channels)
        return dims

    def forward(
        self,
        tensors: Sequence[torch.Tensor],
        presence: Optional[torch.Tensor] = None,
        kv_masks: Optional[Sequence[Optional[torch.Tensor]]] = None,
        return_embeddings: bool = False,
        generator: Optional[torch.Generator] = None,
        seed_generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """Logits ``(b, out_dims)``, or the latents with ``return_embeddings``.

        In training (``.train()``) with a dropout rate above 0, ``generator``
        (on the inputs' device) draws the feed-forward keep masks, and
        ``seed_generator`` (default: ``generator``) one 32-bit hash seed for
        every attention call, all drawn at once. A CPU ``seed_generator``
        keeps that draw off the device; one on the card costs a host read.
        """
        if len(tensors) != self.n_modalities:
            raise ValueError(f"expected {self.n_modalities} modalities, got {len(tensors)}")
        dropout_on = self.training and (self.attn_dropout > 0 or self.ff_dropout > 0)
        if dropout_on and generator is None:
            raise ValueError("training with dropout needs a generator")
        seeds = iter(())
        if self.training and self.attn_dropout > 0:
            src = seed_generator if seed_generator is not None else generator
            calls = self.depth * self.n_modalities * (1 + self.self_per_cross_attn)
            seeds = iter(torch.randint(0, 2**32, (calls,), generator=src, device=src.device,
                                       dtype=torch.int64).tolist())
        b = tensors[0].shape[0]
        kvs, cdt = self.project_contexts(tensors)
        if presence is None:
            presence = torch.ones((b, self.n_modalities), dtype=cdt, device=tensors[0].device)
        presence = presence.to(cdt)
        if kv_masks is None:
            kv_masks = [None] * self.n_modalities

        # each group's K|V columns of the merged buffers
        group_keys = list(self.groups)
        width = 2 * self.cross_dim_head * self.x_heads
        kv_cache = {}
        for i, kv_all in enumerate(kvs):
            for key, sl in zip(group_keys, split_columns(kv_all, [width] * len(group_keys))):
                kv_cache[(key, i)] = sl

        x = self.latents.to(cdt).expand(b, self.l_c, self.l_d)

        for layer in range(self.depth):
            key = _tie_key(layer, self.weight_tie_layers)
            group = self.groups[key]
            for i in range(self.n_modalities):
                pres = presence[:, i][:, None, None]
                update, _ = self._mod(group["cross_attns"][i])(
                    x, kv_mask=kv_masks[i], kv=kv_cache[(key, i)],
                    dropout_seed=next(seeds, None),
                )
                x = pres * update + x
                x = pres * self._mod(group["cross_ffs"][i])(x, generator) + x
                # self-attention runs once per modality iteration
                for blk in range(self.self_per_cross_attn):
                    update, _ = self._mod(group["self_attns"][blk])(
                        x, dropout_seed=next(seeds, None))
                    x = update + x
                    x = self._mod(group["self_ffs"][blk])(x, generator) + x

        if return_embeddings or not self.final_classifier_head:
            return x
        pooled = torch.mean(x, dim=1)
        return self.final_head(self.final_norm(pooled))

    def project_contexts(
        self, tensors: Sequence[torch.Tensor]
    ) -> Tuple[List[torch.Tensor], torch.dtype]:
        """Each modality's merged KV buffer and the compute dtype.

        One merged folded-KV projection per modality: every layer group's
        K|V columns side by side, in ``self.groups`` order, ``(b, tokens_i,
        n_groups * 2 * inner)``. The compute dtype is the module's ``dtype``,
        else the first input's (float32 for a quantized one).
        """
        b = tensors[0].shape[0]
        # raw data and the batch-shared positional encoding stay separate:
        # the merged projection normalizes on its output
        compute_dt = self.dtype if self.dtype is not None else torch.float32
        context_parts = []
        for i, data in enumerate(tensors):
            quantized = isinstance(data, QuantizedContext)
            spatial = tuple(data.shape[1:-1])
            if len(spatial) != self.num_spatial_axes[i]:
                raise ValueError(
                    f"input data for modality {i + 1} must have the same number of "
                    "axes as the num_spatial_axes parameter"
                )
            if self.dtype is not None and not quantized:
                data = data.to(self.dtype)
            enc_flat = None
            if self.fourier_encode_data:
                enc = positional_encoding(
                    spatial, self.max_freq, self.num_freq_bands,
                    dtype=compute_dt if quantized else data.dtype, device=data.device,
                )
                enc_flat = enc.reshape(-1, enc.shape[-1])  # (tokens, E)
            if quantized:
                flat = QuantizedContext(data.data.reshape(b, -1, data.shape[-1]),
                                        data.scale.reshape(b, -1))
            else:
                flat = data.reshape(b, -1, data.shape[-1])
            context_parts.append((flat, enc_flat))

        first = context_parts[0][0]
        cdt = compute_dt if isinstance(first, QuantizedContext) else first.dtype
        kvs = []
        for i, (dat, enc_flat) in enumerate(context_parts):
            folds = [self._mod(group["cross_attns"][i]).kv_fold() for group in self.groups.values()]
            w_all = torch.cat([w for w, _ in folds], dim=1)  # (D, F) f32
            b_all = torch.cat([fb for _, fb in folds])       # (F,)
            kvs.append(fused_kv_project(
                dat, enc_flat, w_all, b_all, eps=1e-5, impl=self.projection_impl,
                out_dtype=compute_dt if isinstance(dat, QuantizedContext) else None,
            ))
        return kvs, cdt

    def _mod(self, name: str) -> nn.Module:
        return self._modules[name]
