"""Pickle helpers, the port's copy of ``healnet_tpu/utils/io.py``."""

from __future__ import annotations

import pickle
from pathlib import Path
from typing import Any, Union


def pickle_obj(obj: Any, path: Union[str, Path]) -> None:
    with open(path, "wb") as f:
        pickle.dump(obj, f)


def unpickle(path: Union[str, Path]) -> Any:
    with open(path, "rb") as f:
        return pickle.load(f)
