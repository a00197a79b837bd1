"""Query batcher: concurrent KNN searches coalesce into one kernel launch.

Reference P1 (SURVEY.md §2.5): every FT.SEARCH runs on a reader-pool
thread (valkey_search.cc:1161-1164, vmsdk/src/thread_pool.h) and scales
with cores. The TPU-native equivalent is *batching*: one chip runs one
program at a time, so concurrent queries against the same index are
stacked on the host and executed as a single `search_batch` device call —
per-launch overhead and the corpus stream amortize across the whole batch
(the same reason bench.py batches 1024 queries).

Dispatcher-pool design (r5): submitters only ENQUEUE — a small pool of
per-signature dispatcher threads drains the backlog into max-batch
launches. The original leader-on-submitter-thread scheme collapsed under
open-loop load: every submitter thread became the leader of a near-empty
batch and paid a full device round trip for it (measured 140 qps achieved
at 50k offered, r5 run 1). With dispatchers, batch size grows with the
backlog instead of shrinking with submitter concurrency, and up to
`search.query-dispatch-threads` workers keep multiple launches in flight
so host↔device round trips overlap (the reader-pool analog: reference
reader threads overlap their hnswlib walks the same way).
`search.query-batch-window-us` still bounds how long a lone query waits
for followers before launching.

The port's own copy of valkey_search_tpu/query/batcher.py: the same
names, defaults and behaviour, with its imports pointing into
valkey_search_tpu_torch, and these departures. A submit wakes every waiting
dispatcher (``notify_all``): the JAX package wakes one, which under mixed
(index, k, ef) signatures can be another signature's worker, so a query
could wait out IDLE_S. A dispatcher that dies gives its count back, so a
later submit starts a new one instead of waiting for ever. A waiter's
cancelled future no longer turns the rest of its batch into errors. A
batch is launched at its own size: the JAX package pads it to a power of
two so that XLA compiles few shapes, which the CUDA scans do not need. And
a traced query's wait is recorded into runtime/metrics.py's ``TRACE``:
``batcher.queue`` from submit to its launch starting, linked to the launch
id, and ``batcher.return`` from its future settled to the submitter
resuming; the launch's own spans carry its first traced query's request
id.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future, InvalidStateError
from typing import Deque, Dict, Optional

import numpy as np

from valkey_search_tpu_torch.runtime import config
from valkey_search_tpu_torch.runtime.metrics import (
    CTX,
    SPAN,
    STATS,
    TRACE,
    Handoff,
    clock,
)


class _PendingQuery:
    __slots__ = ("vector", "future", "submitted")

    def __init__(self, vector: np.ndarray):
        self.vector = vector
        # carries the submitter's request id (0: not traced) to the
        # dispatcher
        rid = CTX.rid
        self.future: Handoff = Handoff(SPAN["batcher.return"], rid)
        self.submitted = clock() if rid else 0


class VectorQueryBatcher:
    """Batches (index, k, ef) compatible single-vector searches."""

    # a dispatcher with an empty queue lingers this long before exiting,
    # so steady traffic reuses warm threads instead of respawning
    IDLE_S = 2.0

    def __init__(self):
        self._cond = threading.Condition()
        self._queues: Dict[tuple, Deque[_PendingQuery]] = {}
        self._workers: Dict[tuple, int] = {}

    def submit(
        self,
        index,
        vector: np.ndarray,
        k: int,
        ef: Optional[int],
    ) -> Future:
        """Queue one query; returns a Future of (dists [k], ids [k])."""
        sig = (id(index), k, ef)
        q = _PendingQuery(np.asarray(vector, np.float32).reshape(-1))
        max_batch = int(config.get("search.query-max-batch"))
        cap = int(config.get("search.query-dispatch-threads"))
        with self._cond:
            queue = self._queues.setdefault(sig, deque())
            queue.append(q)
            n = self._workers.get(sig, 0)
            # first worker on demand; extra workers only while the backlog
            # already exceeds n full launches (they overlap round trips)
            if n == 0 or (n < cap and len(queue) > max_batch * n):
                self._workers[sig] = n + 1
                threading.Thread(
                    target=self._worker,
                    args=(sig, index, k, ef),
                    name=f"vstpu-query-dispatch-{n}",
                    daemon=True,
                ).start()
            else:
                # every waiter: the dispatchers of all signatures share one
                # condition, and a single wake-up can reach another
                # signature's worker while this one's sleeps out IDLE_S
                self._cond.notify_all()
        return q.future

    def _worker(self, sig: tuple, index, k: int, ef: Optional[int]) -> None:
        try:
            while self._serve_one(sig, index, k, ef):
                pass
        except BaseException:
            # a dispatcher that dies gives its count back, so the next
            # submit for this signature starts a new one
            with self._cond:
                self._retire(sig)
            raise

    def _retire(self, sig: tuple) -> None:
        """Give one dispatcher's count back (the condition is held). The
        queue goes with the last one only while it is empty."""
        n = self._workers.get(sig, 0) - 1
        if n > 0:
            self._workers[sig] = n
        else:
            self._workers.pop(sig, None)
            if not self._queues.get(sig):
                self._queues.pop(sig, None)

    def _serve_one(self, sig: tuple, index, k: int, ef: Optional[int]) -> bool:
        """Wait for queries, launch one batch; False once idle for IDLE_S
        (the dispatcher's count is then already given back)."""
        with self._cond:
            deadline = time.monotonic() + self.IDLE_S
            while not self._queues.get(sig):
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    self._retire(sig)
                    return False
                self._cond.wait(remaining)
        window_s = float(config.get("search.query-batch-window-us")) / 1e6
        if window_s > 0:
            time.sleep(window_s)  # let followers pile up behind us
        max_batch = int(config.get("search.query-max-batch"))
        with self._cond:
            queue = self._queues.get(sig)
            chunk = []
            while queue and len(chunk) < max_batch:
                chunk.append(queue.popleft())
        if not chunk:
            return True
        t_launch = 0
        try:
            # the batch goes out at its own size: the scans take any B
            queries = np.stack([p.vector for p in chunk])
            # a launch is traced when one of its queries is, and its spans
            # carry the first such query's request id
            CTX.rid = rid = next(
                (p.future.rid for p in chunk if p.future.rid), 0)
            CTX.last_launch = 0
            t_launch = clock() if rid else 0
            if ef is not None:
                d, ids = index.search_batch(queries, k, ef=ef)
            else:
                d, ids = index.search_batch(queries, k)
            STATS.incr("batched_queries", len(chunk))
            STATS.incr("search_batch_launches")
            if len(chunk) > 1:
                STATS.incr("query_batches_coalesced")
        except Exception as exc:  # propagate to every waiter
            _queued(chunk, t_launch)
            for p in chunk:
                _settle(p.future, exc=exc)
            return True
        _queued(chunk, t_launch)
        for row, p in enumerate(chunk):
            _settle(p.future, (d[row], ids[row]))
        return True


def _queued(chunk, t_launch: int) -> None:
    """Record each query's wait from submit to its launch starting at
    ``t_launch`` (0: the launch is not traced), linked to the launch that
    served it."""
    if not t_launch:
        return
    launch = CTX.last_launch
    for p in chunk:
        p.future.link = launch
        if p.submitted:
            TRACE.record(SPAN["batcher.queue"], p.submitted, t_launch,
                         p.future.rid, launch)


def _settle(future: Future, result=None, exc=None) -> None:
    """Resolve one waiter; a future its caller cancelled is skipped, so the
    rest of its batch still gets results."""
    if future.rid:
        future.settled = clock()
    try:
        if exc is not None:
            future.set_exception(exc)
        else:
            future.set_result(result)
    except InvalidStateError:
        pass


_GLOBAL = VectorQueryBatcher()


def submit(index, vector, k: int, ef: Optional[int] = None) -> Future:
    return _GLOBAL.submit(index, vector, k, ef)
