"""Spans around the calls into the program's layers, and the device trace.

``Spans.install`` wraps, in this process only and for the traced run only,
``Engine.ft_search`` (the engine: parse, plan, filter mask, batcher wait,
launch, reply) and ``FlatVectorIndex.search_batch`` (the device program: it
returns host arrays, so its span is synchronised). Each span is kept in memory
as (start, end) on the system's monotonic clock; a ``search_batch`` span also
keeps its batch rows, its k and the rows its filter admits (counted after the
call, whose results it waited for). ``uninstall`` puts the program's methods
back.

``device_slice`` runs ``torch.profiler`` with CUDA activity only over a few
seconds inside the window, and returns every device operation as (name,
start, end) on the same monotonic clock: a spin kernel launched on a stream of
its own at the slice's start, at a known host time, ties the trace's clock to
the host's (where the trace lacks it, the profiler's start does, to within
its start-up). ``run.py`` has CUPTI detached after every session
(``TEARDOWN_CUPTI=1``): left attached, it could come back from a later
session with the copies and none of the kernels. ``has_kernels`` tells such a
slice, and the run then takes another.
"""

from __future__ import annotations

import array
import time
from typing import Dict, List, NamedTuple, Optional, Tuple


class BatchSpan(NamedTuple):
    start: float
    end: float
    rows: int
    k: int
    admitted: int  # rows the filter admits; -1 without a filter


class Spans:
    """Spans kept in flat arrays of floats, so that recording them leaves
    no object for the collector; each record is one ``extend``, which the
    interpreter lock makes whole against other threads."""

    def __init__(self):
        self._ft = array.array("d")  # start, end
        self._sb = array.array("d")  # start, end, rows, k, admitted
        self._saved: Dict[str, tuple] = {}

    @property
    def ft_search(self) -> List[Tuple[float, float]]:
        a = self._ft
        return [(a[n], a[n + 1]) for n in range(0, len(a), 2)]

    @property
    def search_batch(self) -> List[BatchSpan]:
        a = self._sb
        return [BatchSpan(a[n], a[n + 1], int(a[n + 2]), int(a[n + 3]),
                          int(a[n + 4])) for n in range(0, len(a), 5)]

    def install(self) -> None:
        from valkey_search_tpu_torch.indexes.flat import FlatVectorIndex
        from valkey_search_tpu_torch.server.engine import Engine

        ft_search = Engine.ft_search
        search_batch = FlatVectorIndex.search_batch
        ft, sb = self._ft, self._sb

        def ft_search_spanned(engine, *args, **kwargs):
            t0 = time.monotonic()
            try:
                return ft_search(engine, *args, **kwargs)
            finally:
                ft.extend((t0, time.monotonic()))

        def search_batch_spanned(index, queries, k, filter_mask=None):
            t0 = time.monotonic()
            try:
                return search_batch(index, queries, k, filter_mask=filter_mask)
            finally:
                t1 = time.monotonic()
                rows = 1 if getattr(queries, "ndim", 1) == 1 else len(queries)
                # the mask is ready: the call synchronised on its results
                admitted = -1 if filter_mask is None else int(filter_mask.sum())
                sb.extend((t0, t1, rows, k, admitted))

        self._saved = {"ft_search": (Engine, ft_search),
                       "search_batch": (FlatVectorIndex, search_batch)}
        Engine.ft_search = ft_search_spanned
        FlatVectorIndex.search_batch = search_batch_spanned

    def uninstall(self) -> None:
        for name, (cls, fn) in self._saved.items():
            setattr(cls, name, fn)
        self._saved = {}


class DeviceSlice(NamedTuple):
    start: float  # host monotonic seconds
    end: float
    ops: List[Tuple[str, float, float]]  # (name, start, end), host seconds
    aligned: bool  # the marker was found (else the trace's start is used)


MARKER = "spin_kernel"


def warm_profiler(torch) -> None:
    """Start and stop the profiler once in set-up, so that its first start
    (CUPTI's) does not fall inside the window."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]):
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()


def device_slice(torch, seconds: float) -> DeviceSlice:
    """Trace the device for ``seconds`` while the server runs."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    stream = torch.cuda.Stream()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t_enter = time.monotonic()
        with torch.cuda.stream(stream):
            t_marker = time.monotonic()
            torch.cuda._sleep(1000)
        start = time.monotonic()
        time.sleep(seconds)
        end = time.monotonic()
        stream.synchronize()
    ops = []
    marker_us = None
    for e in prof.events():
        if e.device_type != DeviceType.CUDA or e.is_user_annotation:
            continue
        if MARKER in e.name and marker_us is None:
            marker_us = e.time_range.start
            continue
        ops.append((e.name, e.time_range.start, e.time_range.end))
    # without the marker, the trace's start stands for the profiler's
    off = t_enter if marker_us is None else t_marker - marker_us / 1e6
    return DeviceSlice(start, end,
                       [(n, s / 1e6 + off, e / 1e6 + off) for n, s, e in ops],
                       marker_us is not None)


def has_kernels(sl: Optional[DeviceSlice]) -> bool:
    """The slice holds a kernel, not only copies and fills."""
    return sl is not None and any(not name.startswith(("Memcpy", "Memset"))
                                  for name, _, _ in sl.ops)


def union(intervals, lo: float, hi: float) -> List[Tuple[float, float]]:
    """The union of ``intervals`` [(start, end)] clipped to [lo, hi],
    as sorted disjoint intervals."""
    out: List[List[float]] = []
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_seconds(sl: DeviceSlice) -> float:
    return sum(e - s for s, e in union([(s, e) for _, s, e in sl.ops],
                                       sl.start, sl.end))


def idle_gaps(sl: DeviceSlice) -> List[Tuple[float, float]]:
    busy = union([(s, e) for _, s, e in sl.ops], sl.start, sl.end)
    gaps, t = [], sl.start
    for s, e in busy:
        if s > t:
            gaps.append((t, s))
        t = e
    if sl.end > t:
        gaps.append((t, sl.end))
    return gaps


def host_doing(t: float, spans: Spans) -> str:
    """What the host was doing at ``t``, by the benchmark's spans."""
    if any(s.start <= t <= s.end for s in spans.search_batch):
        return "host inside search_batch"
    if any(s <= t <= e for s, e in spans.ft_search):
        return "host inside Engine.ft_search, outside search_batch"
    return "no Engine.ft_search running (RESP, reader pool)"


def breakdown(sl: Optional[DeviceSlice], spans: Spans, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle
    gaps named by what the host was doing."""
    if sl is None or not sl.ops:
        return {}
    by_name: Dict[str, float] = {}
    for name, s, e in sl.ops:
        by_name[name[:120]] = by_name.get(name[:120], 0.0) + (e - s)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(idle_gaps(sl), key=lambda g: g[0] - g[1])[:top]
    return {"device_ops": [[n, t] for n, t in ops],
            "idle_gaps": [[host_doing((s + e) / 2, spans), e - s]
                          for s, e in gaps]}

