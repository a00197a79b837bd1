"""Find a cell's configuration, traffic mix and metrics by name.

``BENCHMARK.json`` at the checkout's root names each cell's configuration
and traffic mix; each is a JSON file under ``configs/`` or ``traffic/``, and
each metric is a reader under ``metrics/<name>.py`` with a function
``read(run) -> Optional[float]``. Adding a cell, a mix or a metric adds
files and entries; no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
import os
from typing import Callable, Dict, List, NamedTuple, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


class Metric(NamedTuple):
    name: str
    unit: str
    kind: str  # "end_to_end" or "per_layer"
    read: Callable


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict
    traffic: dict
    metrics: List[Metric]  # every metric this cell reports, both kinds


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark_json(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def config_path(name: str) -> str:
    return os.path.join(HERE, "configs", f"{name}.json")


def traffic_path(name: str) -> str:
    return os.path.join(HERE, "traffic", f"{name}.json")


def metric_path(name: str) -> str:
    return os.path.join(HERE, "metrics", f"{name}.py")


def load_reader(name: str) -> Callable:
    """The ``read`` function of ``metrics/<name>.py``."""
    path = metric_path(name)
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_").replace("-", "_"), path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metrics_of(bench: dict, cell: str) -> List[Metric]:
    """The metrics ``cell`` reports: each entry of ``end_to_end`` and
    ``per_layer`` with no ``workloads`` key or one that lists it."""
    out = []
    for kind in ("end_to_end", "per_layer"):
        for m in bench.get(kind, []):
            if "workloads" in m and cell not in m["workloads"]:
                continue
            out.append(Metric(m["name"], m["unit"], kind,
                              load_reader(m["name"])))
    return out


def cell(name: str, bench: Optional[dict] = None) -> Cell:
    bench = bench if bench is not None else benchmark_json()
    for w in bench["workloads"]:
        if w["name"] == name:
            return Cell(name, int(w["chips"]),
                        load_json(config_path(w["config"])),
                        load_json(traffic_path(w["traffic"])),
                        metrics_of(bench, name))
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def scaled(c: Cell, scale: Dict[str, int]) -> Cell:
    """A copy of ``c`` at another size, for the CPU tests: ``rows`` cuts the
    corpus, ``pool`` the query pool, ``processes`` and
    ``connections_per_process`` the load."""
    config = dict(c.config)
    traffic = dict(c.traffic)
    for key, value in scale.items():
        (config if key == "rows" else traffic)[key] = value
    return c._replace(config=config, traffic=traffic)
