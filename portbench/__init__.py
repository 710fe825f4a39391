"""The benchmark of ``healnet_tpu_torch``: one cell a run, ``python3 -m portbench.run``."""

import importlib.util
from pathlib import Path

HERE = Path(__file__).resolve().parent


def load_file(path: Path, name: str):
    """The module in file ``path`` (a file of the benchmark found by name)."""
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
