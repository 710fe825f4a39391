"""The map-style dataset contract, the port's copy of ``healnet_tpu/etl/base.py``."""

from __future__ import annotations

from abc import ABC, abstractmethod


class Dataset(ABC):
    """Minimal map-style dataset contract."""

    @abstractmethod
    def __getitem__(self, index: int):
        ...

    @abstractmethod
    def __len__(self) -> int:
        ...

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]
