"""Convert between the reference HealNet's ``state_dict`` and the port's.

The reference (a torch ``nn.Module``) registers its modules as ``latents``,
``layers.{L}.{2m}`` (modality m's cross-attention), ``layers.{L}.{2m+1}``
(its feed-forward), ``layers.{L}.{2n}.{2b}`` / ``.{2b+1}`` (self-attention
block b and its feed-forward, n modalities) and ``to_logits.{1,2}`` (the
head's LayerNorm and Linear). Inside a block: ``norm``, ``norm_context``,
``fn.to_q``, ``fn.to_kv``, ``fn.to_out.0``, ``fn.net.0``, ``fn.net.2``.

The port's modules carry the Flax scope names (``layer{key}_cross_attn_m{m}``
...; see :mod:`healnet_tpu_torch.models.healnet`) and keep torch's (out, in)
weight layout, so the mapping renames keys and copies values. With weight
tying the reference registers a shared module under every layer that uses
it: importing reads each layer's entry into the shared module (the values
are the same), exporting writes the shared module under every such layer.
"""

from __future__ import annotations

from typing import Dict, Iterator, Mapping, Tuple

import torch

from healnet_tpu_torch.models.healnet import _tie_key

_ATTN = (("norm.weight", "norm.weight"), ("norm.bias", "norm.bias"),
         ("fn.to_q.weight", "fn.to_q.weight"), ("fn.to_kv.weight", "fn.to_kv.weight"),
         ("fn.to_out.weight", "fn.to_out.0.weight"), ("fn.to_out.bias", "fn.to_out.0.bias"))
_CONTEXT = (("norm_context.weight", "norm_context.weight"),
            ("norm_context.bias", "norm_context.bias"))
_FF = (("norm.weight", "norm.weight"), ("norm.bias", "norm.bias"),
       ("fn.net_0.weight", "fn.net.0.weight"), ("fn.net_0.bias", "fn.net.0.bias"),
       ("fn.net_2.weight", "fn.net.2.weight"), ("fn.net_2.bias", "fn.net.2.bias"))
_HEAD = (("final_norm.weight", "to_logits.1.weight"), ("final_norm.bias", "to_logits.1.bias"),
         ("final_head.weight", "to_logits.2.weight"), ("final_head.bias", "to_logits.2.bias"))


def key_pairs(module) -> Iterator[Tuple[str, str]]:
    """``(port key, reference key)`` for every parameter of every layer of
    ``module`` (a :class:`HealNetModule`), tied modules once per layer."""
    yield "latents", "latents"
    n_mod = module.n_modalities
    for layer in range(module.depth):
        key = _tie_key(layer, module.weight_tie_layers)
        tied_ff = key >= 1 and module.weight_tie_layers
        for m in range(n_mod):
            attn = f"layer{key}_cross_attn_m{m}"
            for ours, ref in _ATTN + _CONTEXT:
                yield f"{attn}.{ours}", f"layers.{layer}.{2 * m}.{ref}"
            ff = f"layer{key}_cross_ff_shared" if tied_ff else f"layer{key}_cross_ff_m{m}"
            for ours, ref in _FF:
                yield f"{ff}.{ours}", f"layers.{layer}.{2 * m + 1}.{ref}"
        for blk in range(module.self_per_cross_attn):
            prefix = f"layers.{layer}.{2 * n_mod}"
            for ours, ref in _ATTN:
                yield f"layer{key}_self_attn_b{blk}.{ours}", f"{prefix}.{2 * blk}.{ref}"
            for ours, ref in _FF:
                yield f"layer{key}_self_ff_b{blk}.{ours}", f"{prefix}.{2 * blk + 1}.{ref}"
    if module.final_classifier_head:
        yield from _HEAD


def state_dict_from_reference(state_dict: Mapping[str, torch.Tensor],
                              module) -> Dict[str, torch.Tensor]:
    """Reference ``state_dict`` -> the port's, for ``module``'s config
    (float32 CPU tensors)."""
    return {ours: torch.as_tensor(state_dict[ref]).detach().to("cpu", torch.float32).clone()
            for ours, ref in key_pairs(module)}


def reference_from_state_dict(state_dict: Mapping[str, torch.Tensor],
                              module) -> Dict[str, torch.Tensor]:
    """The port's ``state_dict`` -> the reference layout (float32 CPU
    tensors; a tied module under every layer that uses it)."""
    return {ref: state_dict[ours].detach().to("cpu", torch.float32).clone()
            for ours, ref in key_pairs(module)}
