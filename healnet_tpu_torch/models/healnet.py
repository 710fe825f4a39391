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
- Rematerialisation (``remat=True``): the normalised concat contexts are
  built once, each attention and feed-forward block runs under
  ``torch.utils.checkpoint`` (recomputed in the backward), and every layer
  projects its own KV from the shared normalised context (no merged
  projection). The feed-forward keep masks are drawn before each block, so
  the recomputation sees the same masks.
- Attention capture (``store_attention=True``): the forward also returns
  each attention call's post-softmax, pre-dropout weights, by tag, in call
  order (JAX's sown ``intermediates``); :class:`HealNet` reads them in the
  reference module order (:func:`attention_module_order`).

:class:`HealNet` is the reference-compatible wrapper: the reference
constructor and call signature, ``None`` for a missing modality, lazy or
eager attention capture, and persistence. Meshes are not ported yet.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

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


def attention_module_order(
    depth: int, n_modalities: int, self_per_cross_attn: int, weight_tie_layers: bool,
) -> List[Tuple[str, int, int, int]]:
    """The reference ``get_attention_weights`` order: ``(kind, index,
    first_layer, last_layer)`` for each attention module, once, in the
    order torch registers them; ``last_layer`` is the layer whose call a
    tied module's stored weights come from (its last)."""
    order: List[Tuple[str, int, int, int]] = []
    seen: Dict[Tuple[str, int, int], int] = {}
    for layer in range(depth):
        key = _tie_key(layer, weight_tie_layers)
        ids = [("cross", m) for m in range(n_modalities)]
        ids += [("self", blk) for blk in range(self_per_cross_attn)]
        for kind, idx in ids:
            mod_id = (kind, idx, key)
            if mod_id not in seen:
                seen[mod_id] = len(order)
                order.append((kind, idx, layer, layer))
            else:
                first = order[seen[mod_id]][2]
                order[seen[mod_id]] = (kind, idx, first, layer)
    return order


def attention_tag(kind: str, index: int, layer: int) -> str:
    """The capture tag of an attention call (JAX's sow names)."""
    return f"attn_l{layer}_cross_m{index}" if kind == "cross" else f"attn_l{layer}_self_b{index}"


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
        remat: bool = False,
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
        self.remat = remat

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
        store_attention: bool = False,
        seeds: Optional[torch.Tensor] = None,
    ):
        """Logits ``(b, out_dims)``, or the latents with ``return_embeddings``.

        In training (``.train()``) with a dropout rate above 0, ``generator``
        (on the inputs' device) draws the feed-forward keep masks, and
        every attention call takes one 32-bit hash seed, in call order, from
        ``seeds``: a ``(attention_calls(),)`` integer tensor on the inputs'
        device (a step's row of a seed table), which the kernels read
        there. Without it the seeds are drawn at once from
        ``seed_generator`` (default: ``generator``); from a CPU generator
        they reach the card in one copy from pinned memory, with no wait
        on the host and no host read.

        ``store_attention`` returns ``(out, weights)`` instead: every
        attention call's post-softmax, pre-dropout weights ``(b, h, lq,
        lkv)``, a list in call order under the call's
        :func:`attention_tag` (attention then takes the plain path).
        """
        if len(tensors) != self.n_modalities:
            raise ValueError(f"expected {self.n_modalities} modalities, got {len(tensors)}")
        dropout_on = self.training and (self.attn_dropout > 0 or self.ff_dropout > 0)
        if dropout_on and generator is None:
            raise ValueError("training with dropout needs a generator")
        b = tensors[0].shape[0]
        seeds = self._call_seeds(seeds, seed_generator if seed_generator is not None
                                 else generator, tensors[0].device)
        parts, compute_dt, cdt = self._context_parts(tensors)
        if presence is None:
            presence = torch.ones((b, self.n_modalities), dtype=cdt, device=tensors[0].device)
        presence = presence.to(cdt)
        if kv_masks is None:
            kv_masks = [None] * self.n_modalities

        contexts, kv_cache = [], {}
        if self.remat:
            contexts = self._normalized_contexts(parts, compute_dt)
        else:
            # each group's K|V columns of the merged buffers
            group_keys = list(self.groups)
            width = 2 * self.cross_dim_head * self.x_heads
            for i, kv_all in enumerate(self._project(parts, compute_dt)):
                for key, sl in zip(group_keys, split_columns(kv_all, [width] * len(group_keys))):
                    kv_cache[(key, i)] = sl

        x = self.latents.to(cdt).expand(b, self.l_c, self.l_d)
        captured: Dict[str, List[torch.Tensor]] = {}

        def attend(name, x, tag, **kw):
            update, weights = self._attend(self._mod(name), x, return_weights=store_attention,
                                           dropout_seed=next(seeds, None), **kw)
            if store_attention:
                captured.setdefault(tag, []).append(weights)
            return update

        for layer in range(self.depth):
            key = _tie_key(layer, self.weight_tie_layers)
            group = self.groups[key]
            for i in range(self.n_modalities):
                pres = presence[:, i][:, None, None]
                if self.remat:  # shared x_hat, each layer's affine folded into its to_kv
                    ctx = dict(context=contexts[i], context_normalized=True)
                else:
                    ctx = dict(kv=kv_cache[(key, i)])
                update = attend(group["cross_attns"][i], x, attention_tag("cross", i, layer),
                                kv_mask=kv_masks[i], **ctx)
                x = pres * update + x
                x = pres * self._feed_forward(group["cross_ffs"][i], x, generator) + x
                # self-attention runs once per modality iteration
                for blk in range(self.self_per_cross_attn):
                    x = attend(group["self_attns"][blk], x, attention_tag("self", blk, layer)) + x
                    x = self._feed_forward(group["self_ffs"][blk], x, generator) + x

        if return_embeddings or not self.final_classifier_head:
            out = x
        else:
            out = self.final_head(self.final_norm(torch.mean(x, dim=1)))
        return (out, captured) if store_attention else out

    def attention_calls(self) -> int:
        """Attention calls a forward makes: one hash seed each."""
        return self.depth * self.n_modalities * (1 + self.self_per_cross_attn)

    def _call_seeds(self, seeds: Optional[torch.Tensor], src: Optional[torch.Generator],
                    device: torch.device):
        """An iterator over the attention calls' seeds (0-d views on
        ``device``), or over nothing without attention dropout."""
        if not (self.training and self.attn_dropout > 0):
            return iter(())
        calls = self.attention_calls()
        if seeds is None:
            if src is None:
                raise ValueError("attention dropout needs seeds or a seed generator")
            seeds = torch.randint(0, 2**32, (calls,), generator=src, device=src.device,
                                  dtype=torch.int64)
            if seeds.device != device:
                if device.type == "cuda":
                    seeds = seeds.pin_memory()
                seeds = seeds.to(device, non_blocking=True)
        elif tuple(seeds.shape) != (calls,) or seeds.device != device:
            raise ValueError(f"seeds must be ({calls},) on {device}, got "
                             f"{tuple(seeds.shape)} on {seeds.device}")
        return iter(seeds.unbind(0))

    def _rematerialise(self) -> bool:
        return self.remat and torch.is_grad_enabled()

    def _attend(self, module: nn.Module, x: torch.Tensor, **kw):
        """One attention block, under ``checkpoint`` on the remat path."""
        if self._rematerialise():
            context = kw.pop("context", None)
            return checkpoint(lambda x_, c_: module(x_, context=c_, **kw), x, context,
                              use_reentrant=False)
        return module(x, **kw)

    def _feed_forward(self, name: str, x: torch.Tensor,
                      generator: Optional[torch.Generator]) -> torch.Tensor:
        """One feed-forward block. On the remat path its keep mask is drawn
        before the checkpointed call (the recomputation reuses it) and in
        the same order as on the plain path, so both draw the same masks."""
        module = self._mod(name)
        if self._rematerialise():
            keep = (module.fn.keep_mask(x.shape, generator, x.device)
                    if module.fn.draws_dropout() else None)
            return checkpoint(module, x, None, keep, use_reentrant=False)
        return module(x, generator)

    def _context_parts(self, tensors: Sequence[torch.Tensor]):
        """Each modality's flattened data (a :class:`QuantizedContext`
        stays one) and its batch-shared positional encoding ``(tokens, E)``
        or None, kept apart; the compute dtype (the module's ``dtype``,
        else float32) and the latents' dtype (the compute dtype for a
        quantized first input, else that input's dtype)."""
        b = tensors[0].shape[0]
        compute_dt = self.dtype if self.dtype is not None else torch.float32
        parts = []
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
                enc_flat = enc.reshape(-1, enc.shape[-1])
            if quantized:
                flat = QuantizedContext(data.data.reshape(b, -1, data.shape[-1]),
                                        data.scale.reshape(b, -1))
            else:
                flat = data.reshape(b, -1, data.shape[-1])
            parts.append((flat, enc_flat))
        first = parts[0][0]
        cdt = compute_dt if isinstance(first, QuantizedContext) else first.dtype
        return parts, compute_dt, cdt

    def _project(self, parts, compute_dt: torch.dtype) -> List[torch.Tensor]:
        """One merged folded-KV projection per modality over its raw data."""
        kvs = []
        for i, (dat, enc_flat) in enumerate(parts):
            folds = [self._mod(group["cross_attns"][i]).kv_fold() for group in self.groups.values()]
            w_all = torch.cat([w for w, _ in folds], dim=1)  # (D, F) f32
            b_all = torch.cat([fb for _, fb in folds])       # (F,)
            kvs.append(fused_kv_project(
                dat, enc_flat, w_all, b_all, eps=1e-5, impl=self.projection_impl,
                out_dtype=compute_dt if isinstance(dat, QuantizedContext) else None,
            ))
        return kvs

    @staticmethod
    def _normalized_contexts(parts, compute_dt: torch.dtype) -> List[torch.Tensor]:
        """The remat path's materialised contexts: data and encoding
        concatenated, LayerNorm-normalised without an affine (the
        statistics do not depend on the layer), in the context's dtype; an
        int8 context is dequantized first."""
        contexts = []
        for dat, enc_flat in parts:
            if isinstance(dat, QuantizedContext):
                dat = dat.dequantize(compute_dt)
            ctx = dat
            if enc_flat is not None:
                enc = enc_flat.expand(dat.shape[0], *enc_flat.shape)
                ctx = torch.cat([dat, enc], dim=-1)
            xf = ctx.float()
            mu = xf.mean(dim=-1, keepdim=True)
            var = (xf * xf).mean(dim=-1, keepdim=True) - mu * mu
            contexts.append(((xf - mu) * torch.rsqrt(var + 1e-5)).to(ctx.dtype))
        return contexts

    def project_contexts(
        self, tensors: Sequence[torch.Tensor]
    ) -> Tuple[List[torch.Tensor], torch.dtype]:
        """Each modality's merged KV buffer and the compute dtype.

        One merged folded-KV projection per modality: every layer group's
        K|V columns side by side, in ``self.groups`` order, ``(b, tokens_i,
        n_groups * 2 * inner)``. The compute dtype is the module's ``dtype``,
        else the first input's (float32 for a quantized one).
        """
        parts, compute_dt, cdt = self._context_parts(tensors)
        return self._project(parts, compute_dt), cdt

    def _mod(self, name: str) -> nn.Module:
        return self._modules[name]


class HealNet:
    """The reference-compatible wrapper around :class:`HealNetModule`.

    Keeps the reference constructor and call signature: ``model(tensors)``
    takes a list of per-modality arrays (an entry may be None for a missing
    modality) and returns logits; :meth:`get_attention_weights` gives the
    attention maps of the last pass in the reference's module order.
    Weights are drawn from ``seed`` when the wrapper is built.

    ``store_attention``: ``"lazy"`` (default) captures nothing on the pass
    and replays the last pass with capture when the weights are asked for;
    ``"eager"`` (or True) captures on every pass, as the reference does;
    ``"off"`` (or False) never captures. ``device``: the GPU unless
    ``"cpu"`` is asked for.
    """

    def __init__(
        self,
        *,
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
        seed: int = 0,
        store_attention: Any = "lazy",
        attention_impl: str = "xla",
        projection_impl: str = "auto",
        dtype: Optional[torch.dtype] = None,
        stats_chunk: int = 2048,
        device: DeviceLike = None,
    ):
        if len(channel_dims) != len(num_spatial_axes):
            raise ValueError("input channels and input axis must be of the same length")
        if len(num_spatial_axes) != n_modalities:
            raise ValueError("input axis must be of the same length as the number of modalities")
        if store_attention is True:
            store_attention = "eager"
        elif store_attention is False:
            store_attention = "off"
        if store_attention not in ("lazy", "eager", "off"):
            raise ValueError(f"unknown store_attention {store_attention!r}")
        self.device = resolve_device(device)
        self.module = HealNetModule(
            n_modalities=n_modalities, channel_dims=tuple(channel_dims),
            num_spatial_axes=tuple(num_spatial_axes), out_dims=out_dims, depth=depth,
            num_freq_bands=num_freq_bands, max_freq=max_freq, l_c=l_c, l_d=l_d,
            x_heads=x_heads, l_heads=l_heads, cross_dim_head=cross_dim_head,
            latent_dim_head=latent_dim_head, attn_dropout=attn_dropout, ff_dropout=ff_dropout,
            weight_tie_layers=weight_tie_layers, fourier_encode_data=fourier_encode_data,
            self_per_cross_attn=self_per_cross_attn,
            final_classifier_head=final_classifier_head, snn=snn,
            attention_impl=attention_impl, projection_impl=projection_impl, dtype=dtype,
            device=self.device, generator=torch.Generator().manual_seed(seed),
        )
        self.store_attention = store_attention
        self.stats_chunk = stats_chunk
        # dropout draws of train=True passes: feed-forward masks on the
        # device, attention hash seeds on the host
        self._generator = torch.Generator(device=self.device).manual_seed(seed)
        self._seed_generator = torch.Generator().manual_seed(seed + 1)
        self._attn_weights: Optional[List[np.ndarray]] = None
        self._last_pass = None

    def _prepare_inputs(self, tensors: Sequence[Any], mask):
        """A reference-style list (None = missing) -> (tensors, presence,
        kv_masks) on the device: a missing modality becomes a one-token
        zero tensor with presence 0. ``mask``: a list (one per modality,
        None for unmasked) or one array, applied to every modality whose
        flattened token count it matches (it must match one)."""
        module = self.module
        if len(tensors) != module.n_modalities:
            raise ValueError(f"expected {module.n_modalities} modalities, got {len(tensors)}")
        present = [t for t in tensors if t is not None]
        if not present:
            raise ValueError("at least one modality must be present")
        batch = present[0].shape[0]
        prepared = []
        presence = torch.ones((batch, module.n_modalities), dtype=torch.float32)
        for i, t in enumerate(tensors):
            if t is None:
                presence[:, i] = 0.0
                shape = (batch,) + (1,) * module.num_spatial_axes[i] + (module.channel_dims[i],)
                prepared.append(torch.zeros(shape, device=self.device))
            elif isinstance(t, QuantizedContext):
                prepared.append(t.to(self.device))
            else:
                prepared.append(torch.as_tensor(t, dtype=torch.float32, device=self.device))
        kv_masks: List[Optional[torch.Tensor]] = [None] * module.n_modalities
        as_mask = lambda m: torch.as_tensor(m, dtype=torch.bool, device=self.device)
        if mask is not None:
            if isinstance(mask, (list, tuple)):
                kv_masks = [None if m is None else as_mask(m) for m in mask]
            else:
                mask = as_mask(mask).reshape(batch, -1)
                matched = False
                for i, t in enumerate(prepared):
                    if int(np.prod(t.shape[1:-1])) == mask.shape[1]:
                        kv_masks[i], matched = mask, True
                if not matched:
                    raise ValueError(
                        f"mask has {mask.shape[1]} tokens but no modality's flattened token "
                        "count matches: pass a per-modality list of masks (None for "
                        "unmasked modalities)")
        return tuple(prepared), presence.to(self.device), tuple(kv_masks)

    def _apply(self, prepared, presence, kv_masks, train: bool, return_embeddings: bool,
               store_attention: bool):
        module = self.module.train(train)
        with torch.no_grad():
            return module(prepared, presence=presence, kv_masks=kv_masks,
                          return_embeddings=return_embeddings, generator=self._generator,
                          seed_generator=self._seed_generator, store_attention=store_attention)

    def __call__(self, tensors: Sequence[Any], mask=None, return_embeddings: bool = False,
                 train: bool = False, verbose: bool = False) -> torch.Tensor:
        """Logits ``(b, out_dims)`` (or the latents with
        ``return_embeddings``) on the wrapper's device; ``train`` applies
        dropout, drawn from the wrapper's generators."""
        tensors = list(tensors)
        if verbose:
            print(f"Missing modalities indices: {[i for i, t in enumerate(tensors) if t is None]}")
        prepared, presence, kv_masks = self._prepare_inputs(tensors, mask)
        # the generators' states before the pass: a lazy capture replays it
        states = (self._generator.get_state(), self._seed_generator.get_state())
        eager = self.store_attention == "eager"
        out = self._apply(prepared, presence, kv_masks, train, return_embeddings, eager)
        self._attn_weights = None
        if eager:
            out, captured = out
            self._attn_weights = self._collect_attention(captured)
        self._last_pass = (prepared, presence, kv_masks, train, states)
        return out

    forward = __call__

    def _collect_attention(self, captured: Dict[str, List[torch.Tensor]]) -> List[np.ndarray]:
        """Each module's weights of its last call, ``(b * h, lq, lkv)``, in
        the reference module order."""
        m = self.module
        weights = []
        for kind, idx, _first, last in attention_module_order(
                m.depth, m.n_modalities, m.self_per_cross_attn, m.weight_tie_layers):
            w = captured.get(attention_tag(kind, idx, last))
            if w:
                b, h, lq, lkv = w[-1].shape
                weights.append(w[-1].float().reshape(b * h, lq, lkv).cpu().numpy())
        return weights

    def get_attention_weights(self) -> List[np.ndarray]:
        """The attention maps of the last pass, in the reference module
        order. Under ``"lazy"`` this replays that pass with capture (same
        inputs, same dropout draws)."""
        if self._attn_weights is not None:
            return self._attn_weights
        if self.store_attention == "off" or self._last_pass is None:
            return []
        prepared, presence, kv_masks, train, (gen_state, seed_state) = self._last_pass
        current = (self._generator.get_state(), self._seed_generator.get_state())
        self._generator.set_state(gen_state)
        self._seed_generator.set_state(seed_state)
        try:
            _, captured = self._apply(prepared, presence, kv_masks, train, False, True)
        finally:
            self._generator.set_state(current[0])
            self._seed_generator.set_state(current[1])
        self._attn_weights = self._collect_attention(captured)
        return self._attn_weights

    def get_attention_stats(self):
        raise NotImplementedError(
            "streaming attention statistics come with the explainer slice "
            "(ROADMAP.md, Queue 1 item 5)")

    def count_parameters(self) -> int:
        return sum(int(p.numel()) for p in self.module.parameters())

    def save(self, path) -> None:
        """Save the weights as the ``best`` entry of a checkpoint directory."""
        from healnet_tpu_torch.train.checkpoint import Checkpointer

        Checkpointer(path).save_best(self.module.state_dict())

    def load(self, path) -> "HealNet":
        """Restore weights saved with :meth:`save` (or a trainer's best)."""
        from healnet_tpu_torch.train.checkpoint import Checkpointer

        self.module.load_state_dict(Checkpointer(path).restore_best())
        return self

    def load_torch_state_dict(self, state_dict) -> "HealNet":
        """Import weights from a reference HealNet ``state_dict``."""
        from healnet_tpu_torch.compat.torch_import import state_dict_from_reference

        self.module.load_state_dict(state_dict_from_reference(state_dict, self.module))
        return self
