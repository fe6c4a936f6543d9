"""Finding the benchmark's pieces by name.

``BENCHMARK.json`` at the root of the checkout lists the cells, the
configurations and the metrics.  Each piece lives in a file of its own
that the harness finds by the name there, so that a later cell, traffic
mix, configuration or metric is a new file and a new entry, never an edit:

- a configuration: the JSON file that its entry's ``file`` names
  (``benchmark/configs/<config>.json``);
- a traffic mix: ``benchmark/traffic/<traffic>.json``;
- a per-layer metric: ``benchmark/metrics/<metric>.py``, a reader with
  ``UNIT``, ``LAYER``, ``MOVES``, ``SOURCE`` and ``read(ctx)``;
- the check of a configuration's family, which its file names:
  ``benchmark/checks/<check>.py`` (see ``check.py``).
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


def _tuples(x):
    """JSON lists as tuples, as the port's configs write their sizes."""
    if isinstance(x, list):
        return tuple(_tuples(v) for v in x)
    if isinstance(x, dict):
        return {k: _tuples(v) for k, v in x.items()}
    return x


def _load(path: Path) -> ModuleType:
    """The module in the file ``path`` (``<folder>/<name>.py``)."""
    name = path.stem.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(
        f"bench_{path.parent.name}_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def sibling(path: str, name: str) -> ModuleType:
    """The module ``name`` beside the file ``path``: a reader that reads
    what another does, for cells whose end-to-end metric differs."""
    return _load(Path(path).with_name(f"{name}.py"))


class Registry:
    """The benchmark rooted at ``root`` (the checkout, which holds
    ``BENCHMARK.json`` and the ``benchmark/`` folder)."""

    def __init__(self, root: Path = ROOT, bench_dir: Path | None = None):
        self.root = Path(root)
        self.bench_dir = Path(bench_dir) if bench_dir else \
            self.root / BENCH_DIR.name
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())

    def cell(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        """The configuration file of ``name``, lists read as tuples."""
        for c in self.spec["configs"]:
            if c["name"] == name:
                return _tuples(json.loads((self.root / c["file"])
                                          .read_text()))
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return _tuples(json.loads(
            (self.bench_dir / "traffic" / f"{name}.json").read_text()))

    def metric(self, name: str) -> ModuleType:
        """The reader module of per-layer metric ``name``."""
        return self._module("metrics", name)

    def check(self, name: str) -> ModuleType:
        """The check module ``name`` (a configuration's ``check``)."""
        return self._module("checks", name)

    def _module(self, folder: str, name: str) -> ModuleType:
        return _load(self.bench_dir / folder / f"{name}.py")

    def end_to_end(self, cell: str) -> list:
        """The end-to-end metrics ``cell`` reports."""
        return [m for m in self.spec["end_to_end"]
                if cell in m.get("workloads", [cell])]

    def per_layer(self, cell: str) -> list:
        """The per-layer metrics ``cell`` reports: of those that move an
        end-to-end metric it reports, those without a ``workloads`` key,
        and those that list it."""
        moved = {m["name"] for m in self.end_to_end(cell)}
        return [m for m in self.spec["per_layer"]
                if m["moves"] in moved
                and cell in m.get("workloads", [cell])]
