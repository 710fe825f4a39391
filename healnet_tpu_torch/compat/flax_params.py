"""Convert between a Flax ``params`` tree and the port's ``state_dict``.

The port's modules carry the Flax scope names, so a Flax path maps to a
state-dict key one to one. A ``kernel`` becomes ``weight`` in torch's
layout, by its rank and scope:

- Dense ``(in, out)``: transposed to ``(out, in)``;
- ``nn.Conv`` ``(k, in, out)`` and ``(kh, kw, in, out)``: ``(out, in, k)``
  and ``(out, in, kh, kw)``;
- ``MultiHeadDotProductAttention``'s ``query`` / ``key`` / ``value``
  ``(in, heads, head_dim)``: ``(heads, head_dim, in)``; its ``out``
  ``(heads, head_dim, out)``: ``(out, heads, head_dim)``.

``scale`` (LayerNorm, BatchStatNorm) becomes ``weight``; every other leaf
(``bias``, including the attention's ``(heads, head_dim)`` biases,
``latents``, MultiModN's ``state``) keeps its name and value. The GRU
cells' ``ir`` / ``iz`` / ``in`` / ``hr`` / ``hz`` / ``hn`` are Dense scopes
of their own. The inverse reads the same rules backwards (a 1-D
``weight`` is a ``scale``), so the round trip is exact. The tree is nested
mappings of numpy arrays (or anything ``np.asarray`` accepts).

:func:`state_dict_from_flax_resnet` maps the Flax ResNet-50's variables
(``params`` and ``batch_stats``) onto the port's ResNet-50, whose names
are torchvision's: the inverse of the JAX package's
``params_from_torchvision_state_dict``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

_HEAD_PROJECTIONS = ("query", "key", "value")


def _flatten(tree: Mapping, prefix=()):
    for name, value in tree.items():
        if isinstance(value, Mapping):
            yield from _flatten(value, prefix + (str(name),))
        else:
            yield prefix + (str(name),), value


def _kernel_axes(ndim: int, scope: str) -> Tuple[int, ...]:
    """The permutation taking a Flax kernel of ``ndim`` axes under
    ``scope`` to the port's weight."""
    if ndim == 2:
        return (1, 0)
    if ndim == 3 and scope in _HEAD_PROJECTIONS:
        return (1, 2, 0)
    if ndim == 3 and scope == "out":
        return (2, 0, 1)
    if ndim == 3:
        return (2, 1, 0)
    if ndim == 4:
        return (3, 2, 0, 1)
    raise ValueError(f"no port layout for a {ndim}-D kernel under {scope!r}")


def state_dict_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """Flax params tree -> port state_dict (float32 CPU tensors)."""
    out: Dict[str, torch.Tensor] = {}
    for path, value in _flatten(params):
        arr = np.array(value, dtype=np.float32)
        leaf = path[-1]
        if leaf == "kernel":
            scope = path[-2] if len(path) > 1 else ""
            arr, leaf = np.ascontiguousarray(arr.transpose(_kernel_axes(arr.ndim, scope))), "weight"
        elif leaf == "scale":
            leaf = "weight"
        out[".".join(path[:-1] + (leaf,))] = torch.from_numpy(arr)
    return out


def flax_from_state_dict(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """Port state_dict -> nested Flax params tree of numpy arrays."""
    tree: Dict[str, Any] = {}
    for key, value in state_dict.items():
        *scopes, leaf = key.split(".")
        arr = value.detach().cpu().numpy()
        if leaf == "weight":
            if arr.ndim == 1:
                leaf = "scale"
            else:
                axes = _kernel_axes(arr.ndim, scopes[-1] if scopes else "")
                arr, leaf = np.ascontiguousarray(arr.transpose(np.argsort(axes))), "kernel"
        node = tree
        for scope in scopes:
            node = node.setdefault(scope, {})
        node[leaf] = arr
    return tree


def is_flax_tree(params: Mapping) -> bool:
    """True for a nested Flax tree, False for a flat state_dict."""
    return any(isinstance(v, Mapping) for v in params.values())


def state_dict_from_flax_resnet(variables: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX package's ResNet-50 variables (``{"params": ...,
    "batch_stats": ...}``) -> the port's ResNet-50 state_dict (float32 CPU
    tensors). Convolution kernels go HWIO -> OIHW; a BatchNorm's ``scale``,
    ``bias``, ``mean`` and ``var`` become ``weight``, ``bias``,
    ``running_mean`` and ``running_var``; ``layerS_B`` becomes ``layerS.B``
    and its ``downsample_conv`` / ``downsample_bn`` ``downsample.0`` /
    ``downsample.1``; a Dense ``fc`` is transposed."""
    params, stats = variables["params"], variables["batch_stats"]
    out: Dict[str, torch.Tensor] = {}

    def put(key, value):
        out[key] = torch.from_numpy(np.ascontiguousarray(np.array(value, dtype=np.float32)))

    def conv(p, key):
        put(f"{key}.weight", np.asarray(p["kernel"]).transpose(3, 2, 0, 1))

    def bn(p, s, key):
        put(f"{key}.weight", p["scale"])
        put(f"{key}.bias", p["bias"])
        put(f"{key}.running_mean", s["mean"])
        put(f"{key}.running_var", s["var"])

    for scope, p in params.items():
        if scope == "fc":
            put("fc.weight", np.asarray(p["kernel"]).T)
            put("fc.bias", p["bias"])
        elif scope == "conv1":
            conv(p, "conv1")
        elif scope == "bn1":
            bn(p, stats["bn1"], "bn1")
        else:  # a bottleneck, layerS_B -> layerS.B
            block = scope.replace("_", ".")
            for name, leaf in p.items():
                key = {"downsample_conv": "downsample.0",
                       "downsample_bn": "downsample.1"}.get(name, name)
                if "kernel" in leaf:
                    conv(leaf, f"{block}.{key}")
                else:
                    bn(leaf, stats[scope][name], f"{block}.{key}")
    return out
