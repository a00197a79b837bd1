"""The program's own spans, as the per-layer readers see them.

The port records the spans of one FT.SEARCH in ``TRACE.every`` (16 by
default), from its RESP handler down to the scan launch, into a ring
(``valkey_search_tpu_torch/runtime/metrics.py`` ``TRACE``): name, start,
end, request id and link (the launch id of a launch's spans and of the
batcher's), on ``time.monotonic_ns()``, the clock of the run's window and of
the device slice. Every mean below is over the traced requests or launches,
which the sampling leaves unbiased. ``table(run)`` reads them; it
gives None where there is nothing to read: a program without the recorder,
one that recorded nothing (``search.trace-spans no``), or a ring that
overwrote spans inside the window.

A request is an FT.SEARCH whose ``resp.command`` span ended in the window;
its spans are read from ``LEAD_S`` before the window, since its first ones
end before its reply. A launch is a ``flat.search_batch`` span that ended in
the window. Times come out in milliseconds.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

LEAD_S = 10.0


def table(run):
    """The program's spans from ``LEAD_S`` before the window to its close,
    or None."""
    try:
        from valkey_search_tpu_torch.runtime import metrics
    except ImportError:
        return None
    trace = getattr(metrics, "TRACE", None)
    if trace is None:
        return None
    spans = trace.spans(int((run.t0 - LEAD_S) * 1e9), int(run.t1 * 1e9))
    if not spans.complete or not spans.of("resp.command").any():
        return None
    return spans


def _in_window(run, spans, mask: np.ndarray) -> np.ndarray:
    return mask & (spans.end >= run.t0 * 1e9) & (spans.end <= run.t1 * 1e9)


def requests(run, spans) -> np.ndarray:
    """Sorted ids of the FT.SEARCH requests answered in the window."""
    rids = spans.rid[_in_window(run, spans, spans.of("resp.command"))]
    return np.unique(rids[np.isin(rids, spans.rid[spans.of(
        "engine.ft_search")])])


def per_request(spans, rids: np.ndarray, name: str) -> np.ndarray:
    """ns spent in spans called ``name``, for each of ``rids``."""
    sel = spans.of(name) & np.isin(spans.rid, rids)
    at = np.searchsorted(rids, spans.rid[sel])
    return np.bincount(at, weights=(spans.end - spans.start)[sel],
                       minlength=rids.size)


def launch_per_request(spans, rids: np.ndarray) -> np.ndarray:
    """ns of the launches each request waited on: those its
    ``batcher.queue`` spans link to, and its own filtered launch."""
    launches = spans.of("flat.search_batch")
    took = dict(zip(spans.link[launches].tolist(),
                    (spans.end - spans.start)[launches].tolist()))
    queued = spans.of("batcher.queue")
    pairs = set(zip(spans.rid[queued].tolist(), spans.link[queued].tolist()))
    pairs |= set(zip(spans.rid[launches].tolist(),
                     spans.link[launches].tolist()))
    out = np.zeros(rids.size)
    for rid, launch in pairs:
        at = np.searchsorted(rids, rid)
        if at < rids.size and rids[at] == rid:
            out[at] += took.get(launch, 0.0)
    return out


def request_mean_ms(run, parts: Dict[str, int]) -> Optional[float]:
    """The mean over requests of Σ sign · (time in spans of that name)."""
    spans = table(run)
    if spans is None:
        return None
    rids = requests(run, spans)
    if not rids.size:
        return None
    total = np.zeros(rids.size)
    for name, sign in parts.items():
        if name == "launch":
            total += sign * launch_per_request(spans, rids)
        else:
            total += sign * per_request(spans, rids, name)
    return float(total.mean() / 1e6)


def launches(run, spans):
    """(start, end, launch id) arrays of the launches that ended in the
    window."""
    sel = _in_window(run, spans, spans.of("flat.search_batch"))
    return spans.start[sel], spans.end[sel], spans.link[sel]


def per_launch(spans, ids: np.ndarray, name: str) -> np.ndarray:
    """ns spent in spans called ``name``, for each launch of ``ids``."""
    order = np.argsort(ids)
    sel = spans.of(name) & np.isin(spans.link, ids)
    at = order[np.searchsorted(ids[order], spans.link[sel])]
    return np.bincount(at, weights=(spans.end - spans.start)[sel],
                       minlength=ids.size)


def launch_host_ms(run) -> Optional[float]:
    """The mean launch less the host's wait for the device's results."""
    spans = table(run)
    if spans is None:
        return None
    start, end, ids = launches(run, spans)
    if not ids.size:
        return None
    host = (end - start) - per_launch(spans, ids, "flat.sync")
    return float(host.mean() / 1e6)


def device_busy(device_slice):
    """A function that gives, for intervals (start and end arrays, in
    seconds), the device's busy seconds within each: the union of the
    slice's device operations. None when the slice holds no kernel."""
    from benchmark import tracing

    if not tracing.has_kernels(device_slice):
        return None
    busy = np.asarray(tracing.union([(s, e) for _, s, e in device_slice.ops],
                                    device_slice.start, device_slice.end),
                      np.float64).reshape(-1, 2)
    done = np.concatenate([[0.0], np.cumsum(busy[:, 1] - busy[:, 0])])

    def busy_until(t: np.ndarray) -> np.ndarray:
        """Device busy seconds from the slice's start to each of ``t``."""
        at = np.searchsorted(busy[:, 0], t, side="right") - 1
        part = np.where(at >= 0, np.minimum(t, busy[at.clip(0), 1])
                        - busy[at.clip(0), 0], 0.0)
        return done[at.clip(0)] * (at >= 0) + np.maximum(part, 0.0)

    return lambda start, end: busy_until(end) - busy_until(start)


def slice_launches(run, spans, device_slice):
    """(start, end) seconds and ids of the launches inside the slice."""
    start, end, ids = launches(run, spans)
    start, end = start / 1e9, end / 1e9
    inside = (start >= device_slice.start) & (end <= device_slice.end)
    return start[inside], end[inside], ids[inside]


def launch_idle_ms(run, device_slice) -> Optional[float]:
    """The mean device idle time inside each launch that lies in the
    traced slice: the launch's span less the part of it that the union of
    the slice's device operations covers."""
    spans = table(run)
    busy = None if spans is None else device_busy(device_slice)
    if busy is None:
        return None
    start, end, _ = slice_launches(run, spans, device_slice)
    if not start.size:
        return None
    return float(((end - start) - busy(start, end)).mean() * 1e3)


def split(run) -> Optional[dict]:
    """Each span name's mean ms a request (request spans) or a launch
    (launch spans) in the window, with the counts: where the time went.
    With a device slice, the launches inside it besides: their mean span,
    the device's busy time in it, and each launch span's device idle time
    (``<name> idle``), per launch."""
    spans = table(run)
    if spans is None:
        return None
    rids = requests(run, spans)
    _, _, ids = launches(run, spans)
    out = {"requests": int(rids.size), "launches": int(ids.size)}
    for n, name in enumerate(spans.names[1:], 1):
        per = (per_launch(spans, ids, name) if name.startswith(("flat.",
                                                                "topk."))
               else per_request(spans, rids, name))
        if per.size and (spans.name == n).any():
            out[name] = float(per.mean() / 1e6)
    busy = device_busy(run.device_slice)
    if busy is None:
        return out
    start, end, ids = slice_launches(run, spans, run.device_slice)
    if not ids.size:
        return out
    # the launches inside the traced slice, which the profiler slows
    out["slice launches"] = int(ids.size)
    out["slice flat.search_batch"] = float((end - start).mean() * 1e3)
    out["slice busy"] = float(busy(start, end).mean() * 1e3)
    for name in spans.names[1:]:
        if not name.startswith(("flat.", "topk.")):
            continue
        sel = spans.of(name) & np.isin(spans.link, ids)
        s, e = spans.start[sel] / 1e9, spans.end[sel] / 1e9
        if s.size:
            out[f"{name} idle"] = float(((e - s) - busy(s, e)).sum()
                                        / ids.size * 1e3)
    return out
