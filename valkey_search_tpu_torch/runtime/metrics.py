"""Global metrics: counters + latency histograms.

Models the reference's Metrics singleton (src/metrics.h:29-155 — ~70
counters and 12 HDR latency samplers) and vmsdk::LatencySampler
(vmsdk/src/latency_sampler.h — hdrhistogram, ~1% precision, sampled 1-in-N).

Here: a plain thread-safe counter table plus a log-bucketed histogram
(64 buckets/decade ≈ 1.1% relative error — same ballpark as the reference's
precision-2 hdrhistogram) with 1-in-N sampling on the hot paths.

The port's own copy of valkey_search_tpu/runtime/metrics.py: the same
names, defaults and behaviour, with its imports pointing into
valkey_search_tpu_torch, and one addition: ``TRACE``, a recorder of the
spans of one FT.SEARCH in ``TRACE.every`` (16) from the RESP handler down
to the scan launch (``SpanRecorder``), switched by ``search.trace-spans``,
with its derived counter ``trace_spans_dropped`` in ``STATS``.
"""

from __future__ import annotations

import itertools
import math
import struct
import threading
import time
from collections import defaultdict
from concurrent.futures import Future
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np

from valkey_search_tpu_torch.runtime import config


class LatencySampler:
    """Log-bucketed latency histogram over microseconds.

    Bucket b holds values in [2^(b/G), 2^((b+1)/G)) µs with G buckets per
    octave; G=64 gives ~1.1% relative error, comparable to the reference's
    hdrhistogram precision 2 (src/metrics.h:17-18) at a fraction of the
    memory.
    """

    GRANULARITY = 64
    MAX_EXP = 32  # up to 2^32 µs ≈ 71 min

    def __init__(self, sample_every_n: int = 1):
        self._buckets: Dict[int, int] = defaultdict(int)
        self._count = 0
        self._calls = 0
        self._sample_every_n = max(1, sample_every_n)
        self._lock = threading.Lock()

    def observe_usec(self, usec: float) -> None:
        with self._lock:
            self._calls += 1
            if self._calls % self._sample_every_n:
                return
            usec = max(usec, 1e-3)
            b = int(math.log2(usec) * self.GRANULARITY)
            self._buckets[b] += 1
            self._count += 1

    def percentile(self, p: float) -> Optional[float]:
        with self._lock:
            if not self._count:
                return None
            target = p / 100.0 * self._count
            seen = 0
            for b in sorted(self._buckets):
                seen += self._buckets[b]
                if seen >= target:
                    return 2.0 ** ((b + 0.5) / self.GRANULARITY)
            return 2.0 ** ((max(self._buckets) + 0.5) / self.GRANULARITY)

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    def summary(self) -> Dict[str, Optional[float]]:
        return {
            "p50_usec": self.percentile(50),
            "p99_usec": self.percentile(99),
            "count": self.count,
        }


class Stats:
    """Counter + sampler table; mirrors Metrics::GetStats() (src/metrics.h:156)."""

    def __init__(self):
        self._counters: Dict[str, int] = defaultdict(int)
        self._samplers: Dict[str, LatencySampler] = {}
        # counters that another object keeps, read where they are
        self._derived: Dict[str, Callable[[], int]] = {}
        self._lock = threading.Lock()

    def incr(self, name: str, by: int = 1) -> None:
        with self._lock:
            self._counters[name] += by

    def get(self, name: str) -> int:
        with self._lock:
            if name in self._derived:
                return self._derived[name]()
            return self._counters[name]

    def derive(self, name: str, read: Callable[[], int]) -> None:
        """Count ``name`` as ``read()`` returns it: for a count its owner
        keeps without a lock, such as the span ring's overwritten records."""
        with self._lock:
            self._derived[name] = read

    def sampler(self, name: str, sample_every_n: int = 1) -> LatencySampler:
        with self._lock:
            if name not in self._samplers:
                self._samplers[name] = LatencySampler(sample_every_n)
            return self._samplers[name]

    def snapshot(self) -> Dict[str, object]:
        with self._lock:
            out: Dict[str, object] = dict(self._counters)
            for name, read in self._derived.items():
                value = read()
                if value:
                    out[name] = value
            for name, s in self._samplers.items():
                out[f"{name}_latency"] = s.summary()
            return out

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._samplers.clear()


STATS = Stats()


class timed:
    """Context manager: record elapsed µs into a sampler."""

    def __init__(self, sampler: LatencySampler):
        self._sampler = sampler

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._sampler.observe_usec((time.perf_counter() - self._t0) * 1e6)
        return False


# -- spans ------------------------------------------------------------------

# The spans of one FT.SEARCH, each recorded where its work happens; the id of
# a name is its place here, from 1 (0 marks an empty record).
SPAN_NAMES: Tuple[str, ...] = (
    "resp.command",       # server/resp.py: argv parsed to reply flushed
    "resp.write",         # encode, write and flush of a reply
    "reader.queue",       # submit to the reader pool to ft_search starting
    "reader.return",      # ft_search returned to the handler resuming
    "engine.ft_search",   # Engine.ft_search
    "query.parse",        # parse_ft_search_args, and parse_query
    "query.mask",         # a filter's estimate and device mask; arg: rows
    "batcher.queue",      # batcher submit to its launch starting
    "batcher.return",     # the batch settled to the submitter resuming
    "reply.shape",        # results to the reply list
    "flat.search_batch",  # one launch; arg: query rows, arg2: k
    "flat.prepare",       # queries copied and uploaded, snapshot, options
    "topk.bias",          # the scan's inputs: queries, bias, padding
    "topk.plan",          # the survivor budget and the block split
    "topk.scan",          # the K1b / K2 launch's host enqueue; arg: rows
    "topk.select",        # survivor top-k, decode and merge
    "topk.rescore",       # the fp32 rescore's enqueue
    "topk.replay",        # a CUDA graph's copy-in and replay enqueue
    "topk.capture",       # a CUDA graph's warm-up launch and capture
    "flat.sync",          # the host blocked on the device's results
)
SPAN = {name: n for n, name in enumerate(SPAN_NAMES, 1)}

clock = time.monotonic_ns  # the spans' clock
_RECORD = struct.Struct("<7q")  # name, start, end, rid, link, arg, arg2
FIELDS = ("name", "start", "end", "rid", "link", "arg", "arg2")
REORDER_NS = 1_000_000_000


class SpanContext(threading.local):
    """What the calling thread works for: the id of the traced request it
    serves (``rid``; 0 while it serves an untraced one) and, while a traced
    launch runs in the thread, its launch id (``launch``; else 0).
    ``last_launch`` is the id of the thread's last traced launch, for the
    caller that started it. Threads hand ids to each other explicitly. A
    span point records only while ``rid`` (or ``launch``) is set, so an
    untraced request pays one read of it a span point."""

    rid = 0
    launch = 0
    last_launch = 0


class SpanTable(NamedTuple):
    """Spans as arrays of equal length (``FIELDS``), in recording order;
    ``name`` holds ids into ``names``. Times are ``time.monotonic_ns()``.
    ``complete`` is False when the ring overwrote a record that may have
    ended inside the window asked for."""

    names: Tuple[str, ...]
    name: np.ndarray
    start: np.ndarray
    end: np.ndarray
    rid: np.ndarray
    link: np.ndarray
    arg: np.ndarray
    arg2: np.ndarray
    complete: bool

    def of(self, name: str) -> np.ndarray:
        """A boolean mask of the spans called ``name``."""
        return self.name == SPAN.get(name, -1)


class SpanRecorder:
    """A bounded ring of span records: each record is seven int64 (name id,
    start, end, request id, link, arg, arg2) in one preallocated array.

    ``record`` takes a slot from an ``itertools.count`` and writes the
    record with one ``struct.pack_into``: no lock beyond the interpreter's,
    and no object kept. Once the ring is full each record overwrites the
    oldest; ``dropped`` counts them (``STATS`` reads it as
    ``trace_spans_dropped``). ``link`` is the launch id for the spans of a
    launch and of the batcher, else 0.

    A command is traced when ``sample`` gives it a request id: one command
    in ``every`` while ``search.trace-spans`` is on; a request that is not
    traced reads the clock nowhere. The readers take means over the traced
    requests. The default 2,097,152 records (112 MiB, taken as they are
    first written) hold 116 s at 1,000 traced requests a second of 18 spans
    each."""

    def __init__(self, capacity: int = 1 << 21, every: int = 16):
        cap = 1 << max(0, int(capacity) - 1).bit_length()
        self.capacity = cap
        self._mask = cap - 1
        self._table = np.zeros((cap, len(FIELDS)), np.int64)
        self._buf = memoryview(self._table).cast("B")
        self._slots = itertools.count()
        self.every = every
        self._commands = itertools.count()
        self.new_id = itertools.count(1).__next__  # request and launch ids

    def sample(self) -> int:
        """A new request id for one command in ``every`` while
        ``search.trace-spans`` is on, else 0 (the command is not traced)."""
        if TRACE_ON.value and not next(self._commands) % self.every:
            return self.new_id()
        return 0

    def record(self, name: int, t0: int, t1: int, rid: int, link: int = 0,
               arg: int = 0, arg2: int = 0) -> None:
        """One span of name id ``name`` from ``t0`` to ``t1``."""
        _RECORD.pack_into(self._buf,
                          (next(self._slots) & self._mask) * _RECORD.size,
                          name, t0, t1, rid, link, arg, arg2)

    def taken(self) -> int:
        """Slots taken so far. The count's repr tells it: reading it takes
        no slot and no lock."""
        return int(repr(self._slots)[len("count("):-1])

    @property
    def dropped(self) -> int:
        """Records overwritten by newer ones."""
        return max(0, self.taken() - self.capacity)

    def spans(self, t0: Optional[int] = None,
              t1: Optional[int] = None) -> SpanTable:
        """The spans that ended in [t0, t1] (``time.monotonic_ns()``; None:
        no bound), as arrays. A record being written while this runs may be
        left out."""
        taken = self.taken()
        if taken <= self.capacity:
            rows = self._table[:taken]
            complete = True
        else:  # in slot order: the oldest surviving record first
            head = taken & self._mask
            rows = np.concatenate([self._table[head:], self._table[:head]])
            live = rows[rows[:, 0] != 0]
            # a record reaches the ring up to a launch after its end, so
            # the overwritten ones ended before the oldest left, give or
            # take REORDER_NS
            complete = (t0 is not None and live.size > 0
                        and int(live[0, 2]) < t0 - REORDER_NS)
        keep = rows[:, 0] != 0
        if t0 is not None:
            keep &= rows[:, 2] >= t0
        if t1 is not None:
            keep &= rows[:, 2] <= t1
        sel = rows[keep]
        return SpanTable(("",) + SPAN_NAMES,
                         *(sel[:, j].copy() for j in range(len(FIELDS))),
                         complete)


class Handoff(Future):
    """A future that one thread settles and another waits on. The settling
    thread stamps ``settled`` (``clock()``, when ``rid`` is a traced
    request's) and may set ``link``; ``result()`` then records span ``name``
    from that stamp to the waiter resuming, under request id ``rid``."""

    def __init__(self, name: int, rid: int):
        super().__init__()
        self.name = name
        self.rid = rid
        self.link = 0
        self.settled = 0

    def result(self, timeout: Optional[float] = None):
        try:
            return super().result(timeout)
        finally:
            if self.settled:
                TRACE.record(self.name, self.settled, clock(), self.rid,
                             self.link)
                self.settled = 0


TRACE = SpanRecorder()
TRACE_ON = config.TRACE_SPANS  # ``TRACE_ON.value``: record spans?
CTX = SpanContext()
STATS.derive("trace_spans_dropped", lambda: TRACE.dropped)
