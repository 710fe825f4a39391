"""A column table read from and written to (zipped) CSV, without pandas.

The omics tables of a TCGA tree (``omic/tcga_<ds>_all_clean.csv.zip``) are
CSV files written by pandas: an unnamed index column, then one column per
gene and a few of metadata. The machine with the GPU has no pandas, so the
port reads them with :mod:`csv` and :mod:`zipfile` and keeps each column as
a numpy array, typed as pandas' reader types it:

- every cell empty or a missing-value token (``pandas``' default set:
  ``""``, ``NA``, ``NaN``, ``null``, ``None``, ...): float64, all NaN;
- integers and no missing cell: int64;
- numbers, with or without missing cells: float64 (NaN where missing);
- ``True`` / ``False`` and no missing cell: bool;
- anything else: strings (an object array, None where missing).

Numbers are parsed by Python's ``float``, which rounds correctly; pandas'
own parser may differ in the last bit of a float64, which no float32 copy
of the value shows.
"""

from __future__ import annotations

import csv
import io
import math
import re
import zipfile
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Union

import numpy as np

NA_TOKENS = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND",
    "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a", "nan", "null",
})
_INT = re.compile(r"^[+-]?[0-9]+$")
_FLOAT = re.compile(r"^[+-]?(?:[0-9]+\.?[0-9]*|\.[0-9]+)(?:[eE][+-]?[0-9]+)?$"
                    r"|^[+-]?(?:inf|infinity)$", re.IGNORECASE)
_TRUE, _FALSE = {"True", "TRUE", "true"}, {"False", "FALSE", "false"}


def _column(tokens: Sequence[str]) -> np.ndarray:
    """One CSV column's cells as a typed numpy array (see the module docstring)."""
    missing = np.fromiter((t in NA_TOKENS for t in tokens), bool, len(tokens))
    present = [t for t, m in zip(tokens, missing) if not m]
    if not present:
        return np.full(len(tokens), np.nan)
    if all(_INT.match(t) for t in present):
        if not missing.any():
            return np.array([int(t) for t in tokens], dtype=np.int64)
    elif not all(_FLOAT.match(t) for t in present):
        if not missing.any() and all(t in _TRUE or t in _FALSE for t in tokens):
            return np.array([t in _TRUE for t in tokens], dtype=bool)
        return np.array([None if m else t for t, m in zip(tokens, missing)], dtype=object)
    out = np.full(len(tokens), np.nan)
    out[~missing] = [float(t) for t in present]
    return out


def csv_cell(value) -> str:
    """A value as pandas' ``to_csv`` writes it (NaN and None empty)."""
    if value is None:
        return ""
    if isinstance(value, (float, np.floating)):
        return "" if math.isnan(value) else repr(float(value))
    if isinstance(value, (bool, np.bool_)):
        return str(bool(value))
    if isinstance(value, (int, np.integer)):
        return str(int(value))
    return str(value)


class Table:
    """Named columns of equal length, with an index (the CSV's first column)."""

    def __init__(self, columns: Dict[str, np.ndarray], index: Optional[np.ndarray] = None,
                 index_name: str = ""):
        self._data: Dict[str, np.ndarray] = {}
        n = len(next(iter(columns.values()))) if columns else 0
        self.index = np.arange(n).astype(object) if index is None else np.asarray(index, object)
        self.index_name = index_name
        for name, values in columns.items():
            self[name] = values

    # ------------------------------------------------------------ access
    @property
    def columns(self) -> List[str]:
        return list(self._data)

    @property
    def shape(self):
        return (len(self.index), len(self._data))

    def __len__(self) -> int:
        return len(self.index)

    def __contains__(self, name) -> bool:
        return name in self._data

    def __getitem__(self, name: str) -> np.ndarray:
        return self._data[name]

    def __setitem__(self, name: str, values) -> None:
        values = np.asarray(values)
        if values.shape != (len(self.index),):
            raise ValueError(f"column {name!r} has shape {values.shape}, the table "
                             f"{len(self.index)} rows")
        self._data[name] = values

    def rows(self, selector) -> "Table":
        """The rows a boolean mask or an index array selects, in its order."""
        return Table({k: v[selector] for k, v in self._data.items()}, self.index[selector],
                     self.index_name)

    def fill_missing_with_means(self) -> "Table":
        """Missing cells of numeric columns replaced by the column's mean over
        its present cells (``df.fillna(df.mean(numeric_only=True))``)."""
        for name, values in self._data.items():
            if values.dtype.kind == "f":
                missing = np.isnan(values)
                if missing.any() and not missing.all():
                    mean = np.sum(np.where(missing, 0.0, values)) / float((~missing).sum())
                    self._data[name] = np.where(missing, mean, values)
        return self

    def matrix(self, names: Iterable[str]) -> np.ndarray:
        """(rows, len(names)) float64 of the named columns; a column that is
        not numeric raises."""
        names = list(names)
        for name in names:
            if self._data[name].dtype.kind not in "biuf":
                raise ValueError(f"column {name!r} is not numeric")
        if not names:
            return np.zeros((len(self), 0))
        return np.stack([self._data[n].astype(np.float64) for n in names], axis=1)

    # ------------------------------------------------------------ files
    @classmethod
    def read_csv(cls, path: Union[str, Path], sep: str = ",", index: bool = True) -> "Table":
        """A CSV file, or the one CSV member of a ``.zip``, its fields split
        at ``sep``; the first column is the index, or with ``index=False``
        a column like the others (the index then counts the rows, as
        pandas' ``read_csv`` without ``index_col``)."""
        path = Path(path)
        if path.suffix == ".zip":
            with zipfile.ZipFile(path) as archive:
                members = [m for m in archive.namelist() if not m.endswith("/")]
                if len(members) != 1:
                    raise ValueError(f"{path}: expected one file in the archive, found "
                                     f"{members}")
                text = archive.read(members[0]).decode("utf-8")
        else:
            text = path.read_text()
        rows = [r for r in csv.reader(io.StringIO(text), delimiter=sep) if r]
        if not rows:
            raise ValueError(f"{path}: no header")
        header, body = rows[0], rows[1:]
        width = len(header)
        for no, row in enumerate(body, 2):
            if len(row) > width:
                raise ValueError(f"{path}, row {no}: {len(row)} fields, the header {width}")
            row.extend([""] * (width - len(row)))
        cells = list(zip(*body)) if body else [()] * width
        if not index:
            return cls({name: _column(list(col)) for name, col in zip(header, cells)})
        columns = {name: _column(list(col)) for name, col in zip(header[1:], cells[1:])}
        return cls(columns, index=np.asarray(cells[0], object), index_name=header[0])

    def to_csv(self, path: Union[str, Path], sep: str = ",", index: bool = True) -> None:
        """Write the table as pandas' ``to_csv`` does, its fields joined by
        ``sep``, the index first unless ``index=False``; zipped when
        ``path`` ends in ``.zip`` (one member, named as the file without
        ``.zip``)."""
        path = Path(path)
        buf = io.StringIO()
        writer = csv.writer(buf, delimiter=sep, lineterminator="\n")
        cols = list(self._data.values())
        writer.writerow([self.index_name, *self._data] if index else list(self._data))
        for i, label in enumerate(self.index):
            cells = [csv_cell(c[i]) for c in cols]
            writer.writerow([csv_cell(label), *cells] if index else cells)
        if path.suffix == ".zip":
            with zipfile.ZipFile(path, "w", compression=zipfile.ZIP_DEFLATED) as archive:
                archive.writestr(path.stem, buf.getvalue())
        else:
            path.write_text(buf.getvalue())
