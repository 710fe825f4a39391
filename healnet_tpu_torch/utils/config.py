"""YAML config system with ``!include``, per-user overlays, and dotted-key
flattening: the port's counterpart of ``healnet_tpu/utils/config.py``.

The semantics are the JAX package's:

- ``Config(path).read()`` returns an attribute-accessible mapping (:class:`Box`).
- ``!include other.yml`` splices a sub-config, resolved relative to the
  including file, with that file's own per-user overlay applied.
- If ``config.$USER.yml`` exists next to ``config.yml`` it recursively
  overrides it.
- :func:`flatten_config` flattens nested mappings to dotted keys
  (``{"a": {"b": 1}} -> {"a.b": 1}``); :func:`unflatten_config` inverts it.

Files are read by :mod:`healnet_tpu_torch.utils.yaml_reader`, which resolves
scalars as PyYAML's ``FullLoader`` does, so a config reads the same in both
packages; PyYAML is not needed.
"""

from __future__ import annotations

import getpass
import os
from typing import Optional

from healnet_tpu_torch.utils.boxdict import Box
from healnet_tpu_torch.utils.yaml_reader import load


class Config:
    def __init__(self, config_path: str):
        self._config_path = config_path

    def read(self) -> Box:
        """Read the main config file, applying any per-user overlay."""
        if not _readable(self._config_path):
            raise FileNotFoundError(self._config_path)
        return _apply_user_overlay(
            _load_yaml(self._config_path), filename=self._config_path
        )


def _readable(path: str) -> bool:
    return os.path.isfile(path) and os.access(path, os.R_OK)


def _user_overlay_path(filename: str) -> Optional[str]:
    """``config.yml`` -> ``config.$USER.yml`` if that file exists, else None."""
    user = getpass.getuser().lower().replace(" ", "_")
    stem, ext = os.path.splitext(filename)
    candidate = f"{stem}.{user}{ext}"
    return candidate if _readable(candidate) else None


def _include(root: str):
    def include(name: str) -> Box:
        target = os.path.join(root, name)
        return _apply_user_overlay(_load_yaml(target), filename=target)

    return include


def _load_yaml(filename: str) -> Box:
    if not _readable(filename):
        raise FileNotFoundError(filename)
    root = os.path.split(filename)[0]
    return Box(load(filename, include=_include(root)) or {})


def _apply_user_overlay(config: Box, filename: str) -> Box:
    overlay = _user_overlay_path(filename)
    if overlay is not None:
        config.merge_update(_load_yaml(overlay))
    return config


def flatten_config(dictionary, parent_key: str = "", sep: str = ".") -> Box:
    """Flatten nested mappings to dotted keys."""
    items = []
    for key, value in dictionary.items():
        dotted = sep.join((parent_key, str(key))) if parent_key else str(key)
        if isinstance(value, dict):
            items.extend(flatten_config(value, parent_key=dotted, sep=sep).items())
        else:
            items.append((dotted, value))
    return Box(dict(items))


def unflatten_config(dictionary, sep: str = ".") -> Box:
    """Inverse of :func:`flatten_config` (rebuild keeps nested structure)."""
    out: Box = Box()
    for key, value in dictionary.items():
        parts = key.split(sep)
        node = out
        for part in parts[:-1]:
            if part not in node or not isinstance(node[part], dict):
                node[part] = Box()
            node = node[part]
        node[parts[-1]] = value
    return out
