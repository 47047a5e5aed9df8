"""A cell's parts, found by name.

`BENCHMARK.json`'s cell names a configuration (its file, given in
`configs`) and a traffic mix (`traffic/<mix>.json`); the configuration
names its model family (`families/<family>.py`), the mix its driver
(`drivers/<driver>.py`), and each per-layer metric has its reader
(`metrics/<metric>.py`, a function `read(ctx)`). Adding a cell, a mix, a
metric or a configuration is adding files and entries: nothing here names
one.
"""

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]       # the benchmark's folder


@dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list
    root: Path


def _load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(kind: str, name: str, folder: Path = HERE):
    """`<folder>/<kind>/<name>.py` as a module."""
    path = folder / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r}: {path}")
    spec = importlib.util.spec_from_file_location(
        f"bench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reports(metric: dict, cell: str, e2e_names) -> bool:
    """Whether `cell` reports `metric`: the cells it lists, or, with no
    list, every cell that reports the end-to-end metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric["moves"] in e2e_names


def load_cell(bench_json: Path, workload: str, folder: Path = HERE) -> Cell:
    spec = _load_json(bench_json)
    root = bench_json.resolve().parent
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in {bench_json}: "
                       f"{sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in spec["configs"]}
    config = _load_json(root / configs[w["config"]]["file"])
    traffic = _load_json(folder / "traffic" / f"{w['traffic']}.json")
    e2e = [m for m in spec["end_to_end"]
           if workload in m.get("workloads", [workload])]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"] if reports(m, workload, names)]
    return Cell(workload, w, config, traffic, e2e, per_layer, root)
