"""Convert between the Flax ``params`` tree of ``HealNetModule`` and the
port's ``state_dict``.

The port's submodules carry the Flax scope names, so a Flax path maps to a
state-dict key one to one: ``a/b/kernel`` (Dense, (in, out)) becomes
``a.b.weight`` transposed to (out, in); ``a/b/scale`` (LayerNorm) becomes
``a.b.weight``; ``bias`` and ``latents`` keep their names and values. The
tree is nested mappings of numpy arrays (or anything ``np.asarray``
accepts). The inverse maps a 2-D ``weight`` back to ``kernel`` and a 1-D
``weight`` back to ``scale``, so the round trip is exact.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


def _flatten(tree: Mapping, prefix=()):
    for name, value in tree.items():
        if isinstance(value, Mapping):
            yield from _flatten(value, prefix + (str(name),))
        else:
            yield prefix + (str(name),), value


def state_dict_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """Flax params tree -> port state_dict (float32 CPU tensors)."""
    out: Dict[str, torch.Tensor] = {}
    for path, value in _flatten(params):
        arr = np.array(value, dtype=np.float32)
        leaf = path[-1]
        if leaf == "kernel":
            arr, leaf = np.ascontiguousarray(arr.T), "weight"
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
            if arr.ndim == 2:
                arr, leaf = np.ascontiguousarray(arr.T), "kernel"
            else:
                leaf = "scale"
        node = tree
        for scope in scopes:
            node = node.setdefault(scope, {})
        node[leaf] = arr
    return tree


def is_flax_tree(params: Mapping) -> bool:
    """True for a nested Flax tree, False for a flat state_dict."""
    return any(isinstance(v, Mapping) for v in params.values())
