"""Packages that import their public names on first use.

A package's ``__init__`` maps each name it exports to the module that
defines it; :func:`lazy_exports` gives the package's ``__getattr__`` (PEP
562) and ``__dir__``. ``from grace_tpu_torch.telemetry import JSONLSink``
then imports ``telemetry.sinks`` (and torch) when it runs, while ``python
-m grace_tpu_torch.telemetry``, which reads a file, imports neither: torch
alone takes 7-8 s to import on the card's host.
"""

from __future__ import annotations

import importlib
from typing import Callable, Dict, List, Mapping, Sequence, Tuple


def lazy_exports(package: str, exports: Mapping[str, Sequence[str]]
                 ) -> Tuple[Callable[[str], object], Callable[[], List[str]]]:
    """``(__getattr__, __dir__)`` of ``package``, which exports the names
    ``exports[m]`` of each module ``m`` (relative to ``package`` when it
    starts with a dot)."""
    table: Dict[str, str] = {name: module
                             for module, names in exports.items()
                             for name in names}

    def __getattr__(name: str):
        module = table.get(name)
        if module is None:
            raise AttributeError(
                f"module {package!r} has no attribute {name!r}")
        value = getattr(importlib.import_module(module, package), name)
        setattr(importlib.import_module(package), name, value)
        return value

    def __dir__() -> List[str]:
        return sorted(set(vars(importlib.import_module(package))) | set(table))

    return __getattr__, __dir__
