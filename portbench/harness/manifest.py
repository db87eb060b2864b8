"""The benchmark's data, found by name.

``BENCHMARK.json`` at the root of the checkout names the cells; each cell
names a configuration (``configs/<name>.json``), a traffic mix
(``mixes/<name>.json``) and its chips. A configuration names its
``family``: the port's model adapter (``models/<family>.py``), the plain
reference (``reference/models/<family>.py``) and the FLOP count
(``counts/<family>.py``). A mix names its reference codec
(``reference/codecs/<name>.py``). A per-layer or end-to-end metric is read
by ``metrics/<name>.py``; a cell's comparison limits are in
``limits/<cell>.json``. Adding any of these is adding files and entries:
no code here changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent
MANIFEST = ROOT / "BENCHMARK.json"

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path) -> ModuleType:
    """Import the file at ``path`` as a module of its own (names may hold
    dots, as metric names do)."""
    if not path.is_file():
        raise FileNotFoundError(f"no file {path}")
    name = "portbench_dyn_" + re.sub(r"\W", "_", str(path))
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclasses.dataclass
class Cell:
    """One entry of ``workloads`` with its files resolved."""

    name: str
    chips: int
    config: Dict[str, Any]
    mix: Dict[str, Any]
    limits: Dict[str, Any]
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]
    bench_dir: Path = BENCH_DIR

    def family(self) -> ModuleType:
        return load_module(self.bench_dir / "models"
                           / f"{self.config['family']}.py")

    def reference_model(self) -> ModuleType:
        return load_module(self.bench_dir / "reference" / "models"
                           / f"{self.config['family']}.py")

    def reference_codec(self) -> ModuleType:
        return load_module(self.bench_dir / "reference" / "codecs"
                           / f"{self.mix['reference_codec']}.py")

    def counts(self) -> ModuleType:
        return load_module(self.bench_dir / "counts"
                           / f"{self.config['family']}.py")

    def metric_reader(self, name: str) -> ModuleType:
        return load_module(self.bench_dir / "metrics" / f"{name}.py")


def resolve(name: str, manifest: Optional[Dict[str, Any]] = None,
            bench_dir: Path = BENCH_DIR,
            limits: Optional[Dict[str, Any]] = None) -> Cell:
    """The cell ``name`` of the manifest with its files read; ``limits``
    stands in for ``limits/<name>.json`` (the tests' tiny cells)."""
    if manifest is None:
        manifest = load_json(bench_dir.parent / "BENCHMARK.json")
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; it has "
                       f"{sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in manifest["configs"]}
    config = load_json(bench_dir.parent / configs[w["config"]]["file"])
    mix = load_json(bench_dir / "mixes" / f"{w['traffic']}.json")
    if limits is None:
        limits = load_json(bench_dir / "limits" / f"{name}.json")
    return Cell(name, int(w["chips"]), config, mix, limits,
                manifest["end_to_end"], manifest["per_layer"], bench_dir)
