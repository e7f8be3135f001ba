"""Find a cell's pieces by name: ``BENCHMARK.json`` names the cell, its
configuration, its traffic mix and its metrics, and each lives in a file
of its own under ``bench/``:

* ``bench/configs/<config>.json``: the configuration entry's ``file``.
  Its ``program`` names the system under test,
  ``bench/programs/<program>.py`` (the inputs it is given, the port behind
  the calls the traffic makes, the control, and the check that decides
  ``correct``); the rest is that program's: for the solver, its
  ``matrices``, each made by ``bench/matrices/<generator>.py``, the scheme
  and the entry's options;
* ``bench/traffic/<traffic>.json``: the mix's parameters, read by the one
  generator in :mod:`harness.traffic`; its ``entry`` names the client loop,
  ``bench/entries/<entry>.py``;
* ``bench/metrics/<metric>.py``: one reader a metric, ``read(run)``;
* ``bench/limits/<cell>.json``: the limit of each number compared.

A new cell, configuration, matrix, mix, entry, program or metric is new
files and entries, and no edit to this harness.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, List

__all__ = ["ROOT", "Cell", "load_cell", "load_module"]

#: The checkout's root: ``bench/harness/`` is two levels below it.
ROOT = Path(__file__).resolve().parents[2]


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict            # the configuration's file, parsed
    traffic: dict           # the mix's file, parsed
    limits: Dict[str, float]
    end_to_end: List[dict]  # this cell's entries of BENCHMARK.json
    per_layer: List[dict]
    readers: Dict[str, Callable]
    program: ModuleType     # bench/programs/<config's program>.py
    entry: ModuleType       # bench/entries/<mix's entry>.py
    root: Path


def load_module(path: Path) -> ModuleType:
    """The module in the file ``path``, loaded once a process under a name
    made from its folder and stem (``bench/metrics/idle_pct.single.py`` is
    ``bench_metrics.idle_pct_single``)."""
    path = Path(path).resolve()
    name = (f"bench_{path.parent.name}."
            f"{path.stem.replace('.', '_').replace('-', '_')}")
    mod = sys.modules.get(name)
    if mod is not None and getattr(mod, "__file__", None) == str(path):
        return mod
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its files."""
    root = Path(root)
    bench = _json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; it has "
                       f"{sorted(cells)}")
    w = cells[name]
    cfg = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = _json(root / cfg["file"])
    traffic = _json(root / "bench" / "traffic" / f"{w['traffic']}.json")
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    layer = [m for m in bench["per_layer"] if _reports(m, name)]
    readers = {m["name"]: load_module(root / "bench" / "metrics"
                                      / f"{m['name']}.py").read
               for m in e2e + layer}
    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=traffic,
                limits=_json(root / "bench" / "limits" / f"{name}.json"),
                end_to_end=e2e, per_layer=layer, readers=readers,
                program=load_module(root / "bench" / "programs"
                                    / f"{config['program']}.py"),
                entry=load_module(root / "bench" / "entries"
                                  / f"{traffic['entry']}.py"),
                root=root)
