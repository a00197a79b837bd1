"""Small cells for the CPU tests: the committed cells at a few thousand rows,
a small pool and two load processes, and a filtered cell made of data alone
(the SIFT configuration with a TAG field, behind a 1% tag filter), which
keeps the harness's filter path tested while no committed cell filters, and
the Cohere configuration's files under 50 connections, which keep the cosine
path, K2's dtype and the batcher's coalescing tested."""

import time
from benchmark import run, spec

SMALL = {"rows": 6144, "pool": 128, "processes": 2,
         "connections_per_process": 3}
SEED = 2**31 + 99
TAGGED = "sift1m_int8.tagged"


def tagged_cell() -> spec.Cell:
    base = spec.cell("sift1m_int8.serial_c1")
    config = dict(base.config, fields=[
        {"name": "cat", "type": "TAG", "recipe": "uniform_tag", "prefix": "c",
         "values": 100}], ft_create=base.config["ft_create"] + ["cat", "TAG"])
    traffic = dict(base.traffic, processes=5, connections_per_process=10,
                   filter={"kind": "tag", "field": "cat", "value": "c<j>",
                           "j": [0, 100]})
    return base._replace(name=TAGGED, config=config, traffic=traffic)


def named_cell(name: str) -> spec.Cell:
    """A cell of BENCHMARK.json, the tagged cell, or ``<config>.<traffic>``
    made from the files of that name (as ``cohere1m_bf16.knn100_c50``, whose
    files stay for a later cell): the metrics of a cell that BENCHMARK.json
    does not list are those without a ``workloads`` key."""
    if name == TAGGED:
        return tagged_cell()
    bench = spec.benchmark_json()
    if any(w["name"] == name for w in bench["workloads"]):
        return spec.cell(name, bench)
    config, traffic = name.split(".", 1)
    return spec.Cell(name, 1, spec.load_json(spec.config_path(config)),
                     spec.load_json(spec.traffic_path(traffic)),
                     spec.metrics_of(bench, name))


def small_cell(name: str, **scale) -> spec.Cell:
    """``name`` cut to SMALL; a cell keeps its load where that is smaller."""
    c = named_cell(name)
    scale = dict(SMALL, **scale)
    for key in ("processes", "connections_per_process"):
        scale[key] = min(scale[key], int(c.traffic[key]))
    return spec.scaled(c, scale)


def cpu_run(name: str, seconds: float = 1.5, trace: bool = False,
            seed: int = SEED) -> dict:
    return run.run_cell(small_cell(name), seed, seconds, trace,
                        device="cpu", t_start=time.monotonic())
