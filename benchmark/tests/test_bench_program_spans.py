"""The readers of the program's own spans (``program_spans.py`` and the six
metrics that use it): a CPU run of ``serial_c1`` at 6,144 rows, whose sums
must meet the benchmark's outside spans, and synthetic spans and slices
whose answers are known."""

import numpy as np
import pytest

from bench_helpers import SEED, small_cell
from benchmark import program_spans, run, spec, tracing
from benchmark.record import Run

PROGRAM = ["resp_ms", "reader_wait_ms", "engine_self_ms", "batcher_wait_ms",
           "launch_host_ms"]
DEVICE = ["launch_idle_ms"]


def traced_cpu_run(monkeypatch):
    """A traced CPU run of serial_c1 with every command traced, so that the
    means of the program's spans are over the requests the outside spans
    time; returns (the result line, the Run)."""
    from valkey_search_tpu_torch.runtime.metrics import TRACE

    monkeypatch.setattr(TRACE, "every", 1)
    runs = []
    result = run.result

    def keep(cell, r, *args, **kwargs):
        runs.append(r)
        return result(cell, r, *args, **kwargs)

    monkeypatch.setattr(run, "result", keep)
    import time

    out = run.run_cell(small_cell("sift1m_int8.serial_c1"), SEED, 2.0, True,
                       device="cpu", t_start=time.monotonic())
    return out, runs[0]


def test_a_cpu_run_reads_every_program_metric_and_they_add_up(monkeypatch):
    out, r = traced_cpu_run(monkeypatch)
    assert out["correct"]
    got = {n: m["value"] for n, m in out["metrics"].items()}
    for name in PROGRAM:
        assert name in got and got[name] > 0, name
    assert not set(DEVICE) & set(got)  # the CPU has no device trace
    split = program_spans.split(r)
    # one launch a request; at the window's edges one may end on either side
    assert split["requests"] > 10
    assert abs(split["launches"] - split["requests"]) <= 1
    sync = split["flat.sync"]
    assert abs(got["launch_host_ms"] + sync - got["launch_ms"]) <= 0.05
    parts = (got["engine_self_ms"] + got["batcher_wait_ms"]
             + got["launch_host_ms"] + sync)
    assert abs(parts - got["engine_ms"]) <= 0.1


class Spans:
    """A ring of the program's kind filled by hand, in seconds."""

    def __init__(self, capacity=1 << 10):
        from valkey_search_tpu_torch.runtime.metrics import SPAN, SpanRecorder

        self.ring = SpanRecorder(capacity)
        self.span = SPAN

    def add(self, name, start, end, rid, link=0, arg=0, arg2=0):
        self.ring.record(self.span[name], int(start * 1e9), int(end * 1e9),
                         rid, link, arg, arg2)


def two_requests_in_one_launch() -> Spans:
    """Requests 1 and 2 batched into launch 7 (rows 2); request 3 filtered
    into launch 8 of its own; a launch 9 inside the window but outside the
    slice. Times in seconds from 1.0."""
    s = Spans()
    for rid, base in ((1, 1.100), (2, 1.1005)):
        s.add("reader.queue", base, base + 0.001, rid)
        s.add("batcher.queue", base + 0.002, 1.104, rid, 7)
        s.add("batcher.return", 1.111, 1.112, rid, 7)
        s.add("engine.ft_search", base + 0.001, 1.113, rid)
        s.add("reader.return", 1.113, 1.114, rid)
        s.add("resp.write", 1.114, 1.115, rid)
        s.add("resp.command", base - 0.0005, 1.116, rid)
    s.add("flat.sync", 1.106, 1.110, 1, 7)
    s.add("flat.search_batch", 1.104, 1.110, 1, 7, 2, 10)
    s.add("reader.queue", 1.500, 1.501, 3)
    s.add("flat.sync", 1.505, 1.506, 3, 8)
    s.add("flat.search_batch", 1.502, 1.506, 3, 8, 1, 10)
    s.add("engine.ft_search", 1.501, 1.507, 3)
    s.add("reader.return", 1.507, 1.509, 3)
    s.add("resp.command", 1.4995, 1.510, 3)
    s.add("flat.search_batch", 1.950, 1.952, 0, 9, 1, 10)
    return s


def synthetic_run(monkeypatch, spans, ops):
    from valkey_search_tpu_torch.runtime import metrics

    monkeypatch.setattr(metrics, "TRACE", spans.ring)
    sl = tracing.DeviceSlice(1.0, 1.9, ops, True)
    cfg = spec.cell("sift1m_int8.serial_c1").config
    return Run(cfg, {}, 1.0, 2.0, 1.0, [], np.zeros(0), None, sl,
               "NVIDIA H100 80GB HBM3")


OPS = [("scan", 1.105, 1.106), ("topk", 1.1055, 1.107),  # 2 ms busy in 7
       ("copy", 1.3, 1.4),  # outside every launch
       ("scan", 1.501, 1.503)]  # 1 ms of it inside launch 8


def test_program_readers_on_synthetic_spans(monkeypatch):
    r = synthetic_run(monkeypatch, two_requests_in_one_launch(), OPS)
    read = {n: spec.load_reader(n)(r) for n in PROGRAM + DEVICE}
    # resp.command less reader.queue, engine.ft_search and reader.return
    resp = [16.5 - 1 - 12 - 1, 16 - 1 - 11.5 - 1, 10.5 - 1 - 6 - 2]
    assert read["resp_ms"] == pytest.approx(np.mean(resp))
    assert read["reader_wait_ms"] == pytest.approx(np.mean([2, 2, 3]))
    # engine.ft_search less the batcher's waits and the launch waited on
    engine = [12 - 2 - 1 - 6, 11.5 - 1.5 - 1 - 6, 6 - 4]
    assert read["engine_self_ms"] == pytest.approx(np.mean(engine))
    assert read["batcher_wait_ms"] == pytest.approx(np.mean([3, 2.5, 0]))
    # launches 7, 8 and 9: 6 - 4, 4 - 1 and 2 ms of host time
    assert read["launch_host_ms"] == pytest.approx(np.mean([2, 3, 2]))
    # inside the slice: launch 7 idles 6 - 2 ms, launch 8 4 - 1 ms
    assert read["launch_idle_ms"] == pytest.approx(np.mean([4, 3]))
    # span_split's view: launch 7's sync is busy 1 ms of 4, launch 8's none
    split = program_spans.split(r)
    assert (split["requests"], split["launches"]) == (3, 3)
    assert split["slice launches"] == 2
    assert split["slice busy"] == pytest.approx(1.5)
    assert split["flat.sync idle"] == pytest.approx((3 + 1) / 2)


def test_launch_idle_counts_only_the_idle_time_inside_launches(monkeypatch):
    r = synthetic_run(monkeypatch, two_requests_in_one_launch(),
                      [("scan", 1.0, 1.9)])  # busy throughout
    assert spec.load_reader("launch_idle_ms")(r) == pytest.approx(0.0)
    r = synthetic_run(monkeypatch, two_requests_in_one_launch(),
                      [("scan", 1.3, 1.4)])  # busy only between launches
    assert spec.load_reader("launch_idle_ms")(r) == pytest.approx(5.0)
    # copies alone: the profiler lost the kernels
    r = synthetic_run(monkeypatch, two_requests_in_one_launch(),
                      [("Memcpy DtoH (Device -> Pageable)", 1.105, 1.106)])
    assert spec.load_reader("launch_idle_ms")(r) is None


@pytest.mark.parametrize("case", ["no spans", "overwritten", "no program"])
def test_readers_read_nothing_where_there_is_nothing(monkeypatch, case):
    if case == "no spans":
        spans = Spans()
    else:
        spans = two_requests_in_one_launch()
    r = synthetic_run(monkeypatch, spans, OPS)
    if case == "overwritten":
        # a small ring that wrapped inside the window
        small = Spans(capacity=8)
        for n in range(20):
            small.add("resp.command", 1.1 + n * 0.01, 1.105 + n * 0.01, n)
        r = synthetic_run(monkeypatch, small, OPS)
    if case == "no program":
        from valkey_search_tpu_torch.runtime import metrics

        monkeypatch.delattr(metrics, "TRACE")
    for name in PROGRAM + DEVICE:
        assert spec.load_reader(name)(r) is None, name
