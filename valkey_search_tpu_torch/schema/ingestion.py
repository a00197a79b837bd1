"""Ingestion pipeline: mutation queue + writer pool.

Reference: the keyspace-notification → mutation-queue → writer-thread-pool
path (src/index_schema.cc): TrackMutatedRecord (:1986) upserts into a
per-key queue *combining* consecutive mutations of the same key (only the
latest value matters), ScheduleMutation (:855) hands batches to the writer
pool (valkey_search.cc:1165-1168), ProcessSingleMutationAsync (:999)
applies under the write time-slice, and completion re-dispatches parked
queries.

Design: the same per-key combine queue feeds a small host writer pool;
"apply" routes to the host-side index structures (native HNSW inserts,
postings, columns), and device snapshots publish lazily on the next query
(epoch double-buffering instead of the time-sliced MRMW mutex). Because a
query always runs on a published snapshot plus host-side content
re-verification (server.ft_search.resolve_content), the reference's
sequence-number contention check degenerates to ``drain()`` for strict
read-your-writes.

The port's own copy of valkey_search_tpu/schema/ingestion.py, with its imports
pointing into valkey_search_tpu_torch, and two repairs. A writer never takes
a mutation whose key another writer is still applying: the JAX package hands
it out, so with two writers an upsert that is mid-apply can land after the
delete that followed it, and the deleted key stays in the index. And the
pending check of a key counts its MULTI/EXEC entries in a side table: the JAX
package scans every queue for them, so a backfill tick, which checks each
key of its batch against the batch it is queueing, is quadratic in the
batch size.
"""

from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict
from typing import Dict, Optional, Tuple

from valkey_search_tpu_torch.runtime import config
from valkey_search_tpu_torch.runtime.metrics import STATS


@dataclasses.dataclass
class Mutation:
    schema: object
    key: str
    fields: Optional[Dict[str, object]]  # None → delete (unless fields_fn)
    seq: int = 0
    # refresh mutation (backfill): the worker fetches CURRENT fields at
    # apply time — a snapshot captured at enqueue time could resurrect a
    # concurrently-deleted key (r3 review finding). None → key gone → skip.
    fields_fn: Optional[object] = None
    on_done: Optional[object] = None  # completion callback (backfill gauge)


PRIORITIES = ("max", "high", "low")  # reference ThreadPool::Priority


class IngestionEngine:
    """Per-key combining mutation queue drained by writer threads.

    Priority scheduling mirrors the reference pool (vmsdk thread_pool.h:43
    / thread_pool.cc TryGetNextTask): "max" always wins; "high" vs "low"
    use pattern-based weighted round-robin governed by
    ``search.high-priority-weight`` (0-100; low share = 100 - weight;
    reference default 100). Live keyspace writes enqueue at "high",
    backfill at "low" (index_schema.cc:994), so a bulk backfill cannot
    starve live mutation visibility once the weight is below 100.

    suspend()/resume() park every worker between items (reference
    SuspendWorkers — the pre-fork quiesce used by AtForkPrepare,
    valkey_search.cc:1029); Engine.bgsave uses it to fork a
    copy-on-write child with no writer mid-apply.
    """

    def __init__(self, num_workers: Optional[int] = None):
        self._queues: Dict[str, "OrderedDict[tuple, Mutation]"] = {
            p: OrderedDict() for p in PRIORITIES
        }
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._inflight = 0
        self._inflight_keys: set = set()
        # (schema id, key) -> queued MULTI/EXEC entries, which sit under
        # three-part queue keys that a lookup by key cannot find
        self._multi_queued: Dict[tuple, int] = {}
        self._seq = 0
        self._fairness = 0
        self._stop = False
        self._suspended = False
        self._parked = 0
        n = num_workers or int(config.get("search.writer-threads"))
        self._workers = [
            threading.Thread(target=self._run, name=f"vstpu-writer-{i}",
                             daemon=True)
            for i in range(n)
        ]
        for w in self._workers:
            w.start()

    # -- producer side -------------------------------------------------------
    def enqueue_upsert(
        self, schema, key: str, fields: Dict[str, object],
        priority: str = "high",
    ) -> None:
        self._enqueue(Mutation(schema, key, dict(fields)), priority)

    def enqueue_delete(
        self, schema, key: str, priority: str = "high"
    ) -> None:
        self._enqueue(Mutation(schema, key, None), priority)

    def _enqueue(self, m: Mutation, priority: str = "high") -> None:
        displaced_done = None
        with self._cv:
            self._seq += 1
            m.seq = self._seq
            qk = (id(m.schema), m.key)
            existing = None
            for p in PRIORITIES:
                old = self._queues[p].pop(qk, None)
                if old is not None:
                    existing = p
                    displaced_done = old.on_done  # fire below, unlocked
                    break
            if existing is not None:
                # combine: replace the pending mutation for this key
                # (reference TrackMutatedRecord combine,
                # index_schema.cc:1986); the combined entry keeps the
                # MORE urgent of the two priorities (a live write
                # supersedes a pending backfill row)
                if PRIORITIES.index(existing) < PRIORITIES.index(priority):
                    priority = existing
                STATS.incr("mutations_combined")
            self._queues[priority][qk] = m
            STATS.incr("mutations_enqueued")
            self._cv.notify()
        if displaced_done is not None:
            displaced_done()

    def enqueue_refresh(
        self, schema, key: str, fetch, on_done=None, priority: str = "low"
    ) -> None:
        """Backfill-style enqueue: the worker resolves the key's CURRENT
        fields via ``fetch(key)`` at apply time (None → skip). If ANY
        mutation for the key is already pending, this one is dropped —
        the pending mutation is by definition newer than backfill data."""
        with self._cv:
            if self._pending_for_key_locked(schema, key):
                pending = True
            else:
                pending = False
                self._seq += 1
                m = Mutation(
                    schema, key, None, seq=self._seq,
                    fields_fn=fetch, on_done=on_done,
                )
                self._queues[priority][(id(schema), key)] = m
                STATS.incr("mutations_enqueued")
                self._cv.notify()
        if pending and on_done is not None:
            on_done()

    def enqueue_multi(self, muts) -> None:
        """Ordered group enqueue, exempt from per-key combining (reference
        EnqueueMultiMutation, index_schema.cc:834: MULTI/EXEC mutations keep
        their order and never merge with other pending writes)."""
        with self._cv:
            for m in muts:
                self._seq += 1
                m.seq = self._seq
                # unique queue key → no combining, FIFO order preserved
                self._queues["high"][(id(m.schema), m.key, m.seq)] = m
                owner = (id(m.schema), m.key)
                self._multi_queued[owner] = self._multi_queued.get(owner, 0) + 1
                STATS.incr("mutations_enqueued")
            self._cv.notify_all()

    # -- scheduling ----------------------------------------------------------
    def _any_queued(self) -> bool:
        return any(self._queues[p] for p in PRIORITIES)

    def _pop_next_locked(self) -> Optional[Mutation]:
        """Reference TryGetNextTask: max first, then weighted RR. Within
        the picked queue, the oldest mutation whose key no writer is
        applying (a key's mutations apply in the order they were queued);
        None when every queued key is mid-apply."""
        if self._queues["max"]:
            m = self._pop_free_locked("max")
            if m is not None:
                return m
        high = bool(self._queues["high"])
        low = bool(self._queues["low"])
        if high and low:
            weight = int(config.get("search.high-priority-weight"))
            if weight >= 100:
                pick = "high"
            elif weight <= 0:
                pick = "low"
            else:
                # Bresenham-spread pattern: highs distributed evenly
                # through the cycle (reference pre-computed pattern,
                # thread_pool.cc:465-470), not front-loaded runs
                pick = (
                    "high"
                    if (self._fairness * weight) % 100 < weight
                    else "low"
                )
                self._fairness += 1
        else:
            pick = "high" if high else "low"
        m = self._pop_free_locked(pick)
        if m is None:
            m = self._pop_free_locked("low" if pick == "high" else "high")
        return m

    def _pop_free_locked(self, priority: str) -> Optional[Mutation]:
        queue = self._queues[priority]
        for qk, m in queue.items():
            owner = (qk[0], qk[1])
            if owner not in self._inflight_keys:
                del queue[qk]
                if len(qk) == 3:
                    left = self._multi_queued[owner] - 1
                    if left:
                        self._multi_queued[owner] = left
                    else:
                        del self._multi_queued[owner]
                return m
        return None

    def suspend(self, timeout: float = 30.0) -> bool:
        """Park all workers between items (pre-fork quiesce). Returns True
        once every worker is parked and nothing is mid-apply."""
        with self._cv:
            self._suspended = True
            self._cv.notify_all()
            return self._cv.wait_for(
                lambda: self._parked == len(self._workers)
                and self._inflight == 0,
                timeout,
            )

    def resume(self) -> None:
        with self._cv:
            self._suspended = False
            self._cv.notify_all()

    @property
    def suspended(self) -> bool:
        with self._lock:
            return self._suspended

    # -- worker side ---------------------------------------------------------
    def _run(self) -> None:
        from valkey_search_tpu_torch.runtime.debug import PAUSEPOINTS

        while True:
            with self._cv:
                while True:
                    if self._stop and not self._any_queued():
                        return
                    if self._suspended:
                        # park between items (reference SuspendWorkers)
                        self._parked += 1
                        self._cv.notify_all()
                        while self._suspended:
                            self._cv.wait()
                        self._parked -= 1
                        continue
                    if self._any_queued():
                        break
                    self._cv.wait()
            # reference-named gate that holds mutations IN the queue
            # (ft_debug.cc block_mutation_queue: integration tests freeze
            # the queue to probe in-flight revalidation, test_postfilter.py)
            PAUSEPOINTS.test("block_mutation_queue")
            with self._cv:
                if self._suspended or not self._any_queued():
                    continue  # drained/suspended while gated
                m = self._pop_next_locked()
                if m is None:
                    # every queued key is mid-apply on another writer: its
                    # completion (or a new enqueue) wakes this one
                    self._cv.wait()
                    continue
                self._inflight += 1
                self._inflight_keys.add((id(m.schema), m.key))
            # BACKGROUND_PAUSEPOINT equivalent (reference search.cc:435,657:
            # writer-path marks integration tests freeze on)
            from valkey_search_tpu_torch.runtime.debug import PAUSEPOINTS

            PAUSEPOINTS.test("ingest.before_apply")
            # reference-named processing gate: the mutation is dequeued and
            # tracked in-flight but not yet applied — text queries whose
            # result keys hit this state park until it clears
            # (integration/test_fulltext_inflight_blocking.py)
            PAUSEPOINTS.test("mutation_processing")
            try:
                if m.fields_fn is not None:
                    # refresh (backfill): CURRENT fields at apply time; a
                    # key deleted since the scan snapshot yields None and
                    # is skipped — never resurrected
                    fields = m.fields_fn(m.key)
                    if fields is not None:
                        m.schema.upsert(m.key, fields)
                elif m.fields is None:
                    m.schema.delete(m.key)
                else:
                    m.schema.upsert(m.key, m.fields)
                STATS.incr("mutations_applied")
            except Exception:
                STATS.incr("mutation_failures")
            finally:
                if m.on_done is not None:
                    try:
                        m.on_done()
                    except Exception:
                        pass
                with self._cv:
                    self._inflight -= 1
                    self._inflight_keys.discard((id(m.schema), m.key))
                    self._cv.notify_all()

    # -- synchronization -----------------------------------------------------
    def pending(self) -> int:
        with self._lock:
            return (
                sum(len(self._queues[p]) for p in PRIORITIES) + self._inflight
            )

    def pending_for_key(self, schema, key: str) -> bool:
        """In-flight-mutation check for a result key (the reference parks
        contended queries on the mutation's completion,
        PerformKeyContentionCheck, index_schema.cc:1917)."""
        with self._lock:
            return self._pending_for_key_locked(schema, key)

    def _pending_for_key_locked(self, schema, key: str) -> bool:
        owner = (id(schema), key)
        if owner in self._inflight_keys or owner in self._multi_queued:
            return True
        return any(owner in self._queues[p] for p in PRIORITIES)

    def wait_for_key(self, schema, key: str, timeout: float) -> bool:
        """Park until the key's in-flight mutation completes (the analog of
        the reference re-dispatching a contended query from the mutation's
        waiting_queries list on completion). Returns True if it cleared."""
        with self._cv:
            return self._cv.wait_for(
                lambda: not self._pending_for_key_locked(schema, key),
                timeout,
            )

    def drain(self, timeout: Optional[float] = None) -> bool:
        with self._cv:
            return self._cv.wait_for(
                lambda: not self._any_queued() and self._inflight == 0,
                timeout,
            )

    def shutdown(self) -> None:
        with self._cv:
            self._stop = True
            self._suspended = False
            self._cv.notify_all()
        for w in self._workers:
            w.join(timeout=5)
