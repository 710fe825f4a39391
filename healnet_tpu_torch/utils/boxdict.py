"""Attribute-accessible dict, the port's copy of ``healnet_tpu/utils/boxdict.py``.

The subset of ``python-box`` that configs need: attribute access, nested
conversion, ``merge_update``, and plain-dict behaviour everywhere else.
"""

from __future__ import annotations

from typing import Any, Mapping


class Box(dict):
    """A dict with attribute access and recursive conversion of nested mappings."""

    def __init__(self, *args, **kwargs):
        super().__init__()
        source = dict(*args, **kwargs)
        for key, value in source.items():
            self[key] = value

    @staticmethod
    def _convert(value: Any) -> Any:
        if isinstance(value, Box):
            return value
        if isinstance(value, Mapping):
            return Box(value)
        if isinstance(value, (list, tuple)):
            converted = [Box._convert(v) for v in value]
            if isinstance(value, tuple):
                # namedtuples take N positional args, not one iterable
                if hasattr(value, "_fields"):
                    return type(value)(*converted)
                return tuple(converted)
            return converted
        return value

    def __setitem__(self, key, value):
        super().__setitem__(key, Box._convert(value))

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as exc:  # pragma: no cover - mirrors Box behaviour
            raise AttributeError(name) from exc

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __delattr__(self, name: str) -> None:
        try:
            del self[name]
        except KeyError as exc:  # pragma: no cover
            raise AttributeError(name) from exc

    def merge_update(self, other: Mapping) -> None:
        """Recursive dict merge (python-box ``merge_update`` semantics)."""
        for key, value in other.items():
            if (
                key in self
                and isinstance(self[key], Mapping)
                and isinstance(value, Mapping)
            ):
                self[key].merge_update(value)
            else:
                self[key] = value

    def copy(self) -> "Box":
        return Box(self)

    def to_dict(self) -> dict:
        out = {}
        for key, value in self.items():
            if isinstance(value, Box):
                out[key] = value.to_dict()
            elif isinstance(value, list):
                out[key] = [v.to_dict() if isinstance(v, Box) else v for v in value]
            else:
                out[key] = value
        return out
