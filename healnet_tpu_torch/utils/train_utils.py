"""Training utilities (the part the serving path needs).

Counterpart of ``healnet_tpu/utils/train_utils.py::accepts_kv_masks``.
"""

from __future__ import annotations

import inspect


def accepts_kv_masks(module) -> bool:
    """True when the module's forward takes a ``kv_masks`` keyword.

    HealNet-family modules mask ragged padded contexts; modules that pool
    zero-padded tokens without masks do not take one. Shared by the trainer
    and the serving Predictor so both gate the same way.
    """
    fn = getattr(type(module), "forward", None) or type(module).__call__
    try:
        return "kv_masks" in inspect.signature(fn).parameters
    except (TypeError, ValueError):
        return True
