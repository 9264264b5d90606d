"""Files of the benchmark found by name: the readers of the per-layer
metrics (`metrics/<metric>.py`), the units of work (`units/<kind>.py`),
the comparisons (`checks/<kind>.py`) and the reference's models
(`reference/models/<name>.py`).  A later cell, metric, unit, comparison
or model adds its file; nothing here lists them."""

from __future__ import annotations

import importlib.util
import os
import re

HERE = os.path.dirname(os.path.abspath(__file__))
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
_loaded: dict = {}


def path_of(folder: str, name: str) -> str:
    if not NAME.fullmatch(name):
        raise ValueError(f"portbench: {name!r} is not a name")
    return os.path.join(HERE, folder, name + ".py")


def load(folder: str, name: str):
    """The module `portbench/<folder>/<name>.py`, loaded once."""
    path = path_of(folder, name)
    if path not in _loaded:
        if not os.path.isfile(path):
            raise LookupError(f"portbench: no {folder}/{name}.py")
        tag = re.sub(r"[^A-Za-z0-9_]", "_", f"{folder}_{name}")
        spec = importlib.util.spec_from_file_location(f"portbench_{tag}",
                                                      path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _loaded[path] = mod
    return _loaded[path]
