"""GDC manifest utilities: the port's counterpart of
``healnet_tpu/etl/manifests.py``, on :class:`~healnet_tpu_torch.etl.table.Table`
instead of pandas.

A GDC download manifest is tab-separated with a header (``id``,
``filename``, ``md5``, ``size``, ``state``) and no index column. It reads
into a :class:`Table` whose columns are typed as pandas types them (``size``
int64, the rest strings) and whose index counts the rows.
"""

from __future__ import annotations

from pathlib import Path
from typing import Iterable, Optional, Union

import numpy as np

from healnet_tpu_torch.etl.table import Table


def read_manifest(path: Union[str, Path]) -> Table:
    """Read a GDC download manifest (tab-separated: id, filename, md5, ...)."""
    return Table.read_csv(path, sep="\t", index=False)


def filter_manifest(
    manifest: Table,
    keep_filenames: Optional[Iterable[str]] = None,
    contains: Optional[str] = None,
) -> Table:
    """Filter manifest rows by exact filenames and/or a substring pattern
    (a plain substring, not a regex); the index counts the kept rows."""
    filenames = manifest["filename"]
    keep = np.ones(len(manifest), bool)
    if keep_filenames is not None:
        wanted = set(keep_filenames)
        keep &= np.fromiter((f in wanted for f in filenames), bool, len(filenames))
    if contains is not None:
        keep &= np.fromiter((contains in f for f in filenames), bool, len(filenames))
    return Table({name: manifest[name][keep] for name in manifest.columns})


def write_manifest(manifest: Table, path: Union[str, Path]) -> None:
    manifest.to_csv(path, sep="\t", index=False)
