"""Engine: keyspace + schemas + FT.* command dispatch on the PyTorch port.

The port's own copy of valkey_search_tpu/server/engine.py, with its imports
pointing into valkey_search_tpu_torch. The reference runs inside a Valkey
server (module ABI: src/module_loader.cc registers FT.CREATE/FT.DROPINDEX/
FT.SEARCH/FT.AGGREGATE/FT.INFO/FT._LIST/FT._DEBUG); here the engine owns its
keyspace and exposes the same command surface as Python methods plus an
``execute(argv)`` dispatcher that takes redis-style argument vectors:

    FT.CREATE, FT.DROPINDEX, FT.SEARCH, FT.AGGREGATE, FT.INFO, FT._LIST,
    FT._DEBUG, INFO,
    HSET, HGET, HMGET, HGETALL, HDEL, DEL, EXISTS, TYPE, KEYS, SCAN, COPY,
    EXPIRE, PEXPIRE, TTL, PERSIST,
    HEXPIRE, HPEXPIRE, HTTL, HPTTL, HPERSIST, JSON.SET, JSON.GET.

Document mutations flow through the ingestion pipeline (schema.ingestion)
like the reference's keyspace-notification -> mutation-queue -> writer-pool
path (index_schema.cc:560-1050): ``Engine(sync_ingest=False)`` queues every
write for the writer threads (``drain()`` waits for them, ``cron()``
advances backfills, sweeps expired keys and vacuums HNSW tombstones);
the default indexes each write before the command returns. ``multi()``
gives a MULTI/EXEC transaction, ``acl`` the per-user key and command
permissions every FT.* method checks.

Two departures from the JAX package: the ingestion queue and the reader
pool are created under the engine's lock, so clients that arrive together
share one of each.

``save``/``load`` write and read the checkpoint format of
``persistence/`` (the same file as the JAX package's). SAVE and BGSAVE are
commands of the RESP server (``server/resp.py``), not of ``execute``, as in
the JAX package.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Dict, List, Optional, Sequence, Union

from valkey_search_tpu_torch.runtime import config
from valkey_search_tpu_torch.runtime.metrics import (
    CTX,
    SPAN,
    STATS,
    TRACE,
    Handoff,
    clock,
)
from valkey_search_tpu_torch.schema.index_schema import IndexSchema
from valkey_search_tpu_torch.schema.schema_manager import SchemaError, SchemaManager
from valkey_search_tpu_torch.server import ft_create as ft_create_mod
from valkey_search_tpu_torch.server import ft_search as ft_search_mod

Value = Union[str, bytes, int, float]


class CommandError(ValueError):
    pass


class OutOfMemoryError(MemoryError):
    """DENYOOM equivalent: mutating commands refused above the memory cap
    (reference module_loader.cc:47 DENYOOM flag; backfill pauses,
    index_schema.h:475 paused_by_oom)."""


class Engine:
    def __init__(self, sync_ingest: bool = True):
        self.manager = SchemaManager()
        self.keyspace: Dict[str, Dict[str, Value]] = {}
        self._lock = threading.RLock()
        self._sync_ingest = sync_ingest
        self._ingestion = None  # created lazily (schema.ingestion)
        self._acl = None        # created lazily (server.acl)
        self._expiry: Dict[str, float] = {}  # key → unix deadline
        self._field_expiry: Dict[tuple, float] = {}  # (key, field) → deadline
        # approximated-LRU/LFU bookkeeping for the lru/lfu maxmemory
        # policies (valkey evict.c: 24-bit lru clock / 8-bit saturating
        # lfu counter per object; here a monotonic access sequence and a
        # capped hit counter, sampled at eviction time)
        self._access: Dict[str, int] = {}
        self._freq: Dict[str, int] = {}
        self._access_clock = 0
        # keyspace-notification hook: fn(event, key, klass) — wired by the
        # RESP server to the __keyspace@N__/__keyevent@N__ pub/sub
        # channels (valkey notify.c; the reference CONSUMES these events
        # to index, utils/patricia.py here — this hook re-EMITS them to
        # clients). klass is the valkey event-class letter (g/h/d/x/...).
        self.event_observer = None

    def _event(self, event: str, key: str, klass: str) -> None:
        obs = self.event_observer
        if obs is not None:
            try:
                obs(event, key, klass)
            except Exception:  # noqa: BLE001 — notification must not
                pass           # break the write that triggered it

    # ------------------------------------------------------------------ data
    def memory_pools(self) -> Dict[str, int]:
        """Per-subsystem resident bytes (reference malloc interposition
        counts every module byte, memory_allocation_overrides.h, plus
        per-text-component MemoryPools, text_index.h:50-55): every index
        structure self-reports, the keyspace is walked."""
        pools = {"vector": 0, "tag": 0, "numeric": 0, "text": 0,
                 "interner": 0, "keyspace": 0}
        for schema in self.manager.all_schemas():
            for name, b in schema.memory_pools().items():
                pools[name] = pools.get(name, 0) + b
        ks = 0
        with self._lock:
            for key, fields in self.keyspace.items():
                ks += 64 + len(key)
                for f, v in fields.items():
                    ks += 72 + len(f) + (
                        len(v) if isinstance(v, (str, bytes)) else 8
                    )
        pools["keyspace"] = ks
        return pools

    def used_memory_bytes(self) -> int:
        """Total engine footprint across every pool — the DENYOOM gauge.
        Round-1 counted only vector stores + keyspace, so the OOM guard
        under-fired exactly when text/graph structures dominated."""
        total = sum(self.memory_pools().values())
        self._mem_cached = total
        self._mem_writes_since = 0
        return total

    def _used_memory_cached(self, cap: int) -> int:
        """Memory gauge for the per-write OOM gate: a full pool walk per
        HSET would be O(engine); recompute when the last reading is
        anywhere near the cap (>= cap/2) or every 256 writes, else trust
        the cached value (the reference's interposition counter is O(1)
        by construction — this is the amortized equivalent)."""
        cached = getattr(self, "_mem_cached", None)
        writes = getattr(self, "_mem_writes_since", 0) + 1
        self._mem_writes_since = writes
        if cached is None or cached >= cap // 2 or writes >= 256:
            return self.used_memory_bytes()
        return cached

    def _deny_oom(self) -> None:
        cap = int(config.get("search.max-memory-bytes"))
        if cap and self._used_memory_cached(cap) >= cap:
            # eviction first (valkey maxmemory-policy; reference
            # integration/test_eviction.py — evicted keys leave every
            # index through the normal delete notification path)
            if self._evict_until_under(cap) and self.used_memory_bytes() < cap:
                for schema in self.manager.all_schemas():
                    schema.paused_by_oom = False
                return
            STATS.incr("oom_rejections")
            for schema in self.manager.all_schemas():
                if not getattr(schema, "paused_by_oom", False):
                    # reference worker_pool_suspend_cnt: writers suspend
                    # while over the cap (vmsdk ThreadPool suspension)
                    STATS.incr("worker_pool_suspends")
                schema.paused_by_oom = True
            raise OutOfMemoryError(
                "command not allowed when used memory > search.max-memory-bytes"
            )
        for schema in self.manager.all_schemas():
            if getattr(schema, "paused_by_oom", False):
                schema.paused_by_oom = False
                STATS.incr("writer_resumes")
                STATS.incr("reader_resumes")

    def _evict_until_under(self, cap: int, max_evictions: int = 10_000) -> int:
        """Evict keys per search.maxmemory-policy until under the cap.
        Deletion rides the keyspace-notification path, so evicted keys
        are removed from every index (tag/numeric/text postings, vector
        rows) exactly like an explicit DEL."""
        policy = str(config.get("search.maxmemory-policy"))
        if policy == "noeviction":
            return 0
        import random

        evicted = 0
        while evicted < max_evictions:
            batch = []
            with self._lock:
                if policy == "volatile-ttl":
                    # soonest-expiring keys that carry a TTL
                    cands = sorted(self._expiry.items(), key=lambda kv: kv[1])
                    batch = [k for k, _dl in cands[:32]]
                else:
                    # volatile-* restricts candidates to keys with a TTL
                    # (valkey evict.c: the volatile pool is db->expires)
                    if policy.startswith("volatile"):
                        pool = [k for k in self._expiry if k in self.keyspace]
                    else:
                        pool = list(self.keyspace.keys())
                    if policy.endswith("random"):
                        random.shuffle(pool)
                        batch = pool[:32]
                    else:
                        # lru/lfu: approximated via sampling like valkey's
                        # maxmemory-samples pool, not a full sort
                        samples = (pool if len(pool) <= 160
                                   else random.sample(pool, 160))
                        if policy.endswith("lru"):
                            samples.sort(key=lambda k: self._access.get(k, 0))
                        else:  # *-lfu; ties broken by least-recent access
                            samples.sort(key=lambda k: (
                                self._freq.get(k, 0), self._access.get(k, 0)))
                        batch = samples[:32]
            if not batch:
                break
            for k in batch:
                self.delete(k)
                evicted += 1
                STATS.incr("keys_evicted")
            if self.used_memory_bytes() < cap:
                break
        return evicted

    def _touch(self, key: str) -> None:
        """Record an access for the lru/lfu eviction policies. Caller
        holds the engine lock."""
        self._access_clock += 1
        self._access[key] = self._access_clock
        f = self._freq.get(key, 0)
        if f < 255:
            self._freq[key] = f + 1

    def hset(self, key: str, mapping: Dict[str, Value]) -> int:
        """HSET equivalent; triggers keyspace notification → index update
        (reference OnKeyspaceNotification, index_schema.cc:560)."""
        self._deny_oom()
        with self._lock:
            doc = self.keyspace.setdefault(key, {})
            added = sum(1 for f in mapping if f not in doc)
            doc.update(mapping)
            if self._field_expiry:
                # writing a field clears its TTL (valkey HFE contract)
                for f in mapping:
                    self._field_expiry.pop((key, f), None)
            self._touch(key)
            snapshot = dict(doc)
        self._notify(key, snapshot)
        self._event("hset", key, "h")
        return added

    def hdel(self, key: str, *fields: str) -> int:
        with self._lock:
            doc = self.keyspace.get(key)
            if doc is None:
                return 0
            removed = 0
            for f in fields:
                if f in doc:
                    del doc[f]
                    removed += 1
            if doc:
                snapshot: Optional[Dict[str, Value]] = dict(doc)
            else:
                del self.keyspace[key]
                snapshot = None
        if snapshot is None:
            self._notify_delete(key)
        else:
            self._notify(key, snapshot)
        if removed:
            self._event("hdel", key, "h")
        if snapshot is None:
            self._event("del", key, "g")  # empty hash never survives
        return removed

    def delete(self, key: str, _event_name: Optional[str] = "del") -> int:
        """DEL; ``_event_name`` lets expiry paths emit "expired" instead
        of "del" (valkey notify.c: expiration never fires a del event)."""
        with self._lock:
            existed = self.keyspace.pop(key, None) is not None
            self._expiry.pop(key, None)
            self._access.pop(key, None)
            self._freq.pop(key, None)
            if self._field_expiry:
                for kf in [kf for kf in self._field_expiry if kf[0] == key]:
                    del self._field_expiry[kf]
        if existed:
            self._notify_delete(key)
            if _event_name:
                self._event(_event_name, key,
                            "x" if _event_name == "expired" else "g")
        return int(existed)

    def hgetall(self, key: str) -> Dict[str, Value]:
        self._expire_if_due(key)
        with self._lock:
            doc = self.keyspace.get(key)
            if doc is None:
                return {}
            self._touch(key)
            return dict(doc)

    # ------------------------------------------------------------ TTL/expiry
    # Reference behavior: key expiry fires a keyspace event that removes the
    # key from every index (integration test_expired.py); the engine expires
    # lazily on access plus actively on cron (valkey semantics).
    def expire(self, key: str, seconds: float) -> int:
        with self._lock:
            if key not in self.keyspace:
                return 0
            self._expiry[key] = time.time() + float(seconds)
        self._event("expire", key, "g")
        return 1

    def persist(self, key: str) -> int:
        with self._lock:
            hit = self._expiry.pop(key, None) is not None
        if hit:
            self._event("persist", key, "g")
        return int(hit)

    def ttl(self, key: str) -> float:
        """Seconds to live; -1 no expiry, -2 missing (redis TTL contract)."""
        self._expire_if_due(key)
        with self._lock:
            if key not in self.keyspace:
                return -2
            dl = self._expiry.get(key)
            return -1 if dl is None else max(0.0, dl - time.time())

    def _expire_if_due(self, key: str) -> bool:
        # lock-free fast path: with no TTLs anywhere there is nothing to
        # expire — this probe sits on every read, incl. per-result-row in
        # content resolution (emptiness reads are GIL-atomic)
        if not self._expiry and not self._field_expiry:
            return False
        self._expire_fields_if_due(key)
        with self._lock:
            dl = self._expiry.get(key)
            if dl is None or time.time() < dl:
                return False
            self._expiry.pop(key, None)
        self.delete(key, _event_name="expired")
        STATS.incr("keys_expired")
        return True

    # -------------------------------------------------- hash-field expiry
    # HFE (valkey 7.4 HEXPIRE/HTTL/HPERSIST): indexed fields that expire
    # leave the index through the normal notification path while the key
    # survives (reference integration/test_expired.py
    # test_hash_field_expiration_should_update_index)
    def hexpire(self, key: str, seconds: float, fields) -> list:
        out = []
        notify = False
        with self._lock:
            doc = self.keyspace.get(key)
            for f in fields:
                if doc is None or f not in doc:
                    out.append(-2)
                elif seconds <= 0:
                    doc.pop(f, None)
                    self._field_expiry.pop((key, f), None)
                    out.append(2)  # deleted immediately (HEXPIRE contract)
                    notify = True
                else:
                    self._field_expiry[(key, f)] = time.time() + seconds
                    out.append(1)
            snapshot = dict(doc) if doc is not None else None
        if any(r == 1 for r in out):
            self._event("hexpire", key, "g")
        if notify:
            if snapshot:
                self._notify(key, snapshot)
                self._event("hdel", key, "h")
            elif snapshot is not None:
                # last field deleted → the key goes too (valkey never
                # keeps an empty hash)
                self.delete(key)
        return out

    def httl(self, key: str, fields, ms: bool = False) -> list:
        self._expire_fields_if_due(key)
        now = time.time()
        with self._lock:
            doc = self.keyspace.get(key)
            out = []
            for f in fields:
                if doc is None or f not in doc:
                    out.append(-2)
                else:
                    dl = self._field_expiry.get((key, f))
                    if dl is None:
                        out.append(-1)
                    elif ms:
                        out.append(max(0, int(round((dl - now) * 1000))))
                    else:
                        # valkey HTTL rounds up: a live sub-second TTL
                        # reports 1, never the ambiguous 0
                        out.append(max(0, math.ceil(dl - now)))
            return out

    def hpersist(self, key: str, fields) -> list:
        with self._lock:
            doc = self.keyspace.get(key)
            out = []
            for f in fields:
                if doc is None or f not in doc:
                    out.append(-2)
                elif self._field_expiry.pop((key, f), None) is not None:
                    out.append(1)
                else:
                    out.append(-1)
        if any(r == 1 for r in out):
            self._event("hpersist", key, "g")
        return out

    def _expire_fields_if_due(self, key: Optional[str] = None) -> int:
        """Drop due fields (one key, or all when key is None); re-index
        surviving content, delete keys whose last field expired."""
        if not self._field_expiry:  # lock-free emptiness fast path
            return 0
        now = time.time()
        with self._lock:
            if not self._field_expiry:
                return 0
            due = [
                (k, f) for (k, f), dl in self._field_expiry.items()
                if dl <= now and (key is None or k == key)
            ]
            touched: Dict[str, Optional[Dict]] = {}
            for k, f in due:
                self._field_expiry.pop((k, f), None)
                doc = self.keyspace.get(k)
                if doc is not None:
                    doc.pop(f, None)
                    touched[k] = dict(doc) if doc else None
        for k, snapshot in touched.items():
            STATS.incr("hash_fields_expired")
            if snapshot is None:
                # last field gone → key gone (valkey HFE). Decide + pop in
                # ONE critical section: a concurrent HSET between the
                # sweep and here must not be wiped.
                with self._lock:
                    if self.keyspace.get(k):
                        continue  # repopulated concurrently: keep it
                    existed = self.keyspace.pop(k, None) is not None
                    self._expiry.pop(k, None)
                    self._access.pop(k, None)
                    self._freq.pop(k, None)
                if existed:
                    self._notify_delete(k)
                    self._event("hexpired", k, "g")
                    self._event("del", k, "g")
            else:
                with self._lock:
                    doc = self.keyspace.get(k)
                    snapshot = dict(doc) if doc else None
                if snapshot:
                    self._notify(k, snapshot)
                    self._event("hexpired", k, "g")
        return len(due)

    def sweep_expired(self) -> int:
        """Active expiration pass (the server-cron equivalent of the
        reference's OnServerCronCallback housekeeping)."""
        now = time.time()
        n = self._expire_fields_if_due()
        with self._lock:
            due = [k for k, dl in self._expiry.items() if dl <= now]
        for k in due:
            if self._expire_if_due(k):
                n += 1
        return n

    # ------------------------------------------------------------- JSON API
    def json_set(self, key: str, path: str, value: Value) -> str:
        """JSON.SET equivalent (reference JsonAttributeDataType fetches via
        JSON.GET, attribute_data_type.h:114-117). Path `$` replaces the
        document; nested paths update in place."""
        self._deny_oom()
        with self._lock:
            snapshot = _apply_json(self, key, path, value)
        self._notify(key, snapshot, kind="JSON")
        self._event("json.set", key, "d")
        return "OK"

    def json_get(self, key: str, path: str = "$") -> Optional[str]:
        import json as _json

        from valkey_search_tpu_torch.schema.attribute_data_type import resolve_json_path

        with self._lock:
            raw = self.keyspace.get(key, {}).get("$")
        if raw is None:
            return None
        if path in ("$", "."):
            return raw if isinstance(raw, str) else _json.dumps(raw)
        val = resolve_json_path(_json.loads(raw), path)
        return None if val is None else _json.dumps(val)

    def copy(self, src: str, dst: str, replace: bool = False) -> int:
        """COPY equivalent (reference integration test_copy.py: the copy
        must be indexed like any other write). Returns 1 on copy, 0 when
        src is missing or dst exists without REPLACE."""
        self._deny_oom()
        if self._expire_if_due(src):  # logically-expired src must not copy
            return 0
        with self._lock:
            doc = self.keyspace.get(src)
            if doc is None:
                return 0
            if dst in self.keyspace and not replace:
                return 0
            snapshot = dict(doc)
            self.keyspace[dst] = snapshot
            self._touch(dst)
            # valkey COPY carries the source expire to the copy
            # (db.c copyCommand → setExpire with the source deadline)
            src_dl = self._expiry.get(src)
            if src_dl is not None:
                self._expiry[dst] = src_dl
            else:
                self._expiry.pop(dst, None)
        kind = "JSON" if set(snapshot) == {"$"} else "HASH"
        self._notify(dst, snapshot, kind=kind)
        return 1

    def flushall(self) -> None:
        with self._lock:
            keys = list(self.keyspace)
        for k in keys:
            self.delete(k)
        # standalone (CMD) semantics: FLUSHALL/FLUSHDB deletes the index
        # schemas of the flushed DB (reference OnFlushDBEnded,
        # schema_manager.cc:505; drilled by integration/test_flushall.py
        # FT._LIST == [] after FLUSHALL). In coordinated/cluster mode the
        # schemas are a cluster-level construct and survive empty
        # (schema_manager.cc:527 recreate branch) — signalled here by an
        # attached MetadataManager.
        if getattr(self, "metadata", None) is None:
            for schema in self.manager.all_schemas():
                try:
                    self.manager.drop(schema.name, db=getattr(schema, "db", 0))
                except Exception:
                    pass

    def _notify(self, key: str, fields: Dict[str, Value], kind: str = "HASH") -> None:
        # reference: hash vs JSON keyspace events route only to schemas of
        # the matching ON type (attribute_data_type.h)
        for schema in self.manager.subscribed(key):
            if schema.on != kind:
                continue
            if self._sync_ingest:
                schema.upsert(key, fields)
            else:
                self._queue().enqueue_upsert(schema, key, fields)

    def _notify_delete(self, key: str) -> None:
        for schema in self.manager.subscribed(key):
            if self._sync_ingest:
                schema.delete(key)
            else:
                self._queue().enqueue_delete(schema, key)

    def _queue(self):
        if self._ingestion is None:
            from valkey_search_tpu_torch.schema.ingestion import IngestionEngine

            # under the lock: the first writes of several clients must find
            # ONE queue (the JAX package checks and creates unlocked, so
            # each may start its own, and a key's mutations then apply in
            # no order)
            with self._lock:
                if self._ingestion is None:
                    self._ingestion = IngestionEngine()
        return self._ingestion

    # ---------------------------------------------------------- MULTI/EXEC
    def multi(self) -> "Transaction":
        """Begin a MULTI/EXEC transaction: queued writes apply atomically
        in order, exempt from mutation-queue combining (reference
        EnqueueMultiMutation ordered queue, index_schema.cc:834)."""
        return Transaction(self)

    def _backfill_fetch(self, key: str):
        """Apply-time field resolution for pooled backfill refreshes:
        the key's CURRENT content, or None once it no longer exists."""
        fields = self.hgetall(key)
        return fields or None

    def drain(self) -> None:
        """Wait for async ingestion to settle (tests/shutdown)."""
        if self._ingestion is not None:
            self._ingestion.drain()

    # --------------------------------------------------------- persistence
    def save(self, path: str):
        """Checkpoint keyspace + schemas + vector graphs (reference RDB
        save, SURVEY.md §3.5)."""
        from valkey_search_tpu_torch.persistence import save_engine

        if config.get("search.drain-mutation-queue-on-save"):
            self.drain()
        return save_engine(self, path)

    @classmethod
    def load(cls, path: str, skip_vector_payload=None) -> "Engine":
        """Restore a checkpoint into a fresh engine. With
        skip_vector_payload=True (or the search.skip-rdb-load config set)
        the vector graphs are rebuilt from the keyspace (reference
        skip-index-load config, valkey_search_options.cc:179)."""
        from valkey_search_tpu_torch.persistence import load_engine

        return load_engine(
            path, engine=cls(), skip_vector_payload=skip_vector_payload
        )

    # ------------------------------------------------------------------ acl
    @property
    def acl(self):
        if getattr(self, "_acl", None) is None:
            from valkey_search_tpu_torch.server.acl import AclManager

            self._acl = AclManager()
        return self._acl

    def _acl_check(self, user: str, prefixes) -> None:
        """Reference AclPrefixCheck (acl.h:36-43), called from every FT.*
        command (commands.cc:166)."""
        if user == "default" and getattr(self, "_acl", None) is None:
            return  # no custom users registered; default has allkeys
        self.acl.check_index_access(user, prefixes)

    def _acl_check_command(self, user: str, cmd: str) -> None:
        """Per-command ACL category gate (reference commands.h:46-59
        permission sets; integration/test_valkey_search_acl.py)."""
        if user == "default" and getattr(self, "_acl", None) is None:
            return
        self.acl.check_command(user, cmd)

    # ----------------------------------------------------------------- cron
    def cron(self) -> Dict[str, int]:
        """One server-cron tick (reference OnServerCronCallback,
        valkey_search.cc:1069): advance pending backfills by one batch
        each (skipping OOM-paused schemas) and sweep expired keys."""
        stats = {"backfilled": 0, "expired": 0}
        for schema in self.manager.all_schemas():
            if schema.backfill_in_progress:
                with self._lock:
                    snapshot = {k: dict(v) for k, v in self.keyspace.items()}
                stats["backfilled"] += self.manager.backfill_batch(
                    schema, snapshot,
                    # async mode: batches ride the writer pool at LOW
                    # priority so live writes stay responsive; fields are
                    # re-fetched from the LIVE keyspace at apply time
                    ingestion=None if self._sync_ingest else self._queue(),
                    fetch=None if self._sync_ingest else self._backfill_fetch,
                )
        stats["expired"] = self.sweep_expired()
        # tombstone reclamation (cron-driven vacuum; reference reuses
        # deleted hnswlib slots in place — see HnswVectorIndex.vacuum)
        for schema in self.manager.all_schemas():
            for a in schema.vector_attributes():
                vac = getattr(a.index, "vacuum", None)
                if vac is not None:
                    stats["vacuumed"] = stats.get("vacuumed", 0) + vac()
        # thread CPU sampling rides the cron like the reference's
        # ThreadMonitor (sampled on server cron)
        try:
            from valkey_search_tpu_torch.runtime.threadmon import MONITOR

            MONITOR.sample()
        except OSError:
            pass
        return stats

    def start_cron(self, interval_s: float = 0.1) -> None:
        """Background cron thread (optional — tests and embedders may call
        cron() directly)."""
        if getattr(self, "_cron_thread", None) is not None:
            return
        self._cron_stop = threading.Event()

        def loop():
            while not self._cron_stop.wait(interval_s):
                try:
                    self.cron()
                except Exception:
                    STATS.incr("cron_errors")

        self._cron_thread = threading.Thread(
            target=loop, daemon=True, name="server-cron"
        )
        self._cron_thread.start()

    def stop_cron(self) -> None:
        if getattr(self, "_cron_thread", None) is not None:
            self._cron_stop.set()
            self._cron_thread.join(5)
            self._cron_thread = None

    # ------------------------------------------------------------- commands
    def ft_create(self, *args: Value, user: str = "default") -> str:
        schema, skip_scan = ft_create_mod.parse_ft_create(
            [_s(a) for a in args]
        )
        self._acl_check(user, schema.prefixes)
        self.manager.create(schema)
        if not skip_scan:
            if self._sync_ingest:
                with self._lock:
                    snapshot = {k: dict(v) for k, v in self.keyspace.items()}
                self.manager.backfill(schema, snapshot)
            else:
                # async engines backfill incrementally on cron ticks
                # (reference: backfill runs on server cron at low priority)
                schema.backfill_in_progress = True
                schema.backfill_cursor = 0
        return "OK"

    def ft_dropindex(self, name: str, user: str = "default") -> str:
        schema = self.manager.get(_s(name))
        self._acl_check(user, schema.prefixes)
        self.manager.drop(_s(name))
        return "OK"

    def ft_list(self) -> List[str]:
        return self.manager.list_names()

    def ft_search(self, *args: Value, user: str = "default") -> list:
        t0 = clock()
        rid = CTX.rid  # the RESP command's, when it is traced
        # top-level request counters (reference Metrics query_successful_
        # requests_cnt / query_failed_requests_cnt split by hybrid/vector,
        # valkey_search.cc:866-890)
        STATS.incr("queries_total")
        try:
            # category gate here too: the RESP async path calls this
            # method directly, bypassing execute()
            self._acl_check_command(user, "FT.SEARCH")
            tp = clock() if rid else 0
            sp = ft_search_mod.parse_ft_search_args(list(args))
            if rid:
                TRACE.record(SPAN["query.parse"], tp, clock(), rid)
            schema = self.manager.get(sp.index_name)
            self._acl_check(user, schema.prefixes)
            reply = ft_search_mod.run_ft_search(self, schema, sp)
        except Exception:
            STATS.incr("query_errors")
            raise
        finally:
            t1 = clock()
            if rid:
                TRACE.record(SPAN["engine.ft_search"], t0, t1, rid)
        # INFO's search_vector_ / search_nonvector_latency_usec, from the
        # span's clock readings, taken traced or not
        STATS.sampler("vector_search_usec" if sp.vector
                      else "nonvector_search_usec").observe_usec(
                          (t1 - t0) / 1e3)
        return reply

    def ft_search_async(self, *args: Value, user: str = "default"):
        """Schedule a search on the reader pool (reference SearchAsync,
        search.cc:875: kHigh-priority enqueue on the reader thread pool;
        the blocked client resolves when the reader finishes). Returns a
        concurrent.futures.Future of the reply list. Concurrent unfiltered
        KNN queries coalesce into one device launch (query/batcher.py)."""
        if getattr(self, "_reader_pool", None) is None:
            from concurrent.futures import ThreadPoolExecutor

            with self._lock:  # one pool, whoever asks first
                if getattr(self, "_reader_pool", None) is None:
                    self._reader_pool = ThreadPoolExecutor(
                        max_workers=max(
                            2, int(config.get("search.reader-threads")) * 4),
                        thread_name_prefix="reader",
                    )
        rid = CTX.rid
        if not rid:  # not traced
            return self._reader_pool.submit(self.ft_search, *args, user=user)
        # a traced request's future carries its id to the reader thread,
        # and the handoff back to the caller's span
        fut = Handoff(SPAN["reader.return"], rid)
        submitted = clock()

        def serve():
            if not fut.set_running_or_notify_cancel():
                return
            CTX.rid = rid
            TRACE.record(SPAN["reader.queue"], submitted, clock(), rid)
            try:
                reply = self.ft_search(*args, user=user)
            except BaseException as exc:  # the waiter raises it, as it
                # would from the executor's own future
                fut.settled = clock()
                fut.set_exception(exc)
                return
            finally:
                CTX.rid = 0
            fut.settled = clock()
            fut.set_result(reply)

        self._reader_pool.submit(serve)
        return fut

    def ft_aggregate(self, *args: Value, user: str = "default") -> list:
        from valkey_search_tpu_torch.server import ft_aggregate as agg

        self._acl_check_command(user, "FT.AGGREGATE")

        if args:
            try:
                schema = self.manager.get(_s(args[0]))
                self._acl_check(user, schema.prefixes)
            except KeyError:
                pass  # unknown index error surfaces from the parser
        return agg.run_ft_aggregate(self, list(args))

    def ft_info(self, name: str, user: str = "default") -> list:
        schema = self.manager.get(_s(name))
        self._acl_check(user, schema.prefixes)
        st = schema.stats()
        attrs = []
        for alias, a in st["attributes"].items():
            attrs.append(
                ["identifier", a["identifier"], "attribute", alias,
                 "type", a["type"],
                 # per-attribute gauges (reference FT.INFO attribute
                 # entries: num_records + user_indexed_memory, drilled by
                 # integration/test_info_primary.py
                 # test_ft_info_primary_attribute)
                 "num_records", a["tracked"],
                 "user_indexed_memory", a.get("memory", 0)]
            )
        topts = getattr(schema, "text_options", None) or {}
        out = [
            "index_name", st["name"],
            "index_options", [],
            "index_definition",
            ["key_type", st["on"], "prefixes", st["prefixes"],
             "default_score", topts.get("score", 1.0),
             "score_field", topts.get("score_field")],
            "attributes", attrs,
            "num_docs", st["num_docs"],
            "num_records", sum(a["tracked"] for a in st["attributes"].values()),
            "hash_indexing_failures",
            getattr(schema, "indexing_failures", 0),
            "backfill_in_progress", int(st["backfill_in_progress"]),
            "backfill_complete_percent",
            "1.000000" if not st["backfill_in_progress"] else "0.000000",
            "mutation_queue_size", self._queue_size(),
            "recent_mutations_queue_delay", "0 sec",
            "state", "ready",
        ]
        eng = getattr(schema, "text_engine", None)
        if eng is None:
            # reference emits the text counters unconditionally, 0 when the
            # schema has no text index (index_schema.cc:1230-1237)
            i_hif = out.index("hash_indexing_failures")
            out[i_hif:i_hif] = [
                "total_term_occurrences", 0, "num_terms", 0,
            ]
        else:  # text sections (index_schema.cc:1194-1280)
            tstats = eng.stats()
            out += [
                "num_terms", tstats["distinct_words"],
                "total_term_occurrences", sum(
                    p.position_count() for _, p in eng.dictionary.items()
                ),
                "punctuation", eng.options.punctuation,
                "stop_words", list(eng.options.stop_words),
                "with_offsets", int(eng.options.with_offsets),
                "min_stem_size", eng.lexer.min_stem_size,
                "language", "english",
            ]
        return out

    def _queue_size(self) -> int:
        return self._ingestion.pending() if self._ingestion is not None else 0

    def ft_debug(self, *args: Value) -> object:
        from valkey_search_tpu_torch.server import ft_debug as dbg

        return dbg.run_ft_debug(self, [_s(a) for a in args])

    def info(self, include_dev: Optional[bool] = None) -> Dict[str, object]:
        """INFO-style observability snapshot (reference vmsdk info_field
        registry, ~90 fields, valkey_search.cc:93-1006)."""
        from valkey_search_tpu_torch.runtime import info as info_mod

        if getattr(self, "_info_registry", None) is None:
            self._info_registry = info_mod.InfoRegistry()
            info_mod.register_engine_fields(self, self._info_registry)
        out = info_mod.REGISTRY.collect(include_dev=include_dev)
        out.update(self._info_registry.collect(include_dev=include_dev))
        return out

    def config_set(self, name: str, value: Value) -> str:
        config.set_config(_s(name), value)
        return "OK"

    def config_get(self, name: str):
        return config.get(_s(name))

    # redis-style generic dispatch -----------------------------------------
    def execute(self, *argv: Value, user: str = "default"):
        if not argv:
            raise CommandError("empty command")
        cmd = _s(argv[0]).upper()
        rest = list(argv[1:])
        table = {
            "FT.CREATE": lambda: self.ft_create(*rest, user=user),
            "FT.DROPINDEX": lambda: self.ft_dropindex(*rest, user=user),
            "FT.SEARCH": lambda: self.ft_search(*rest, user=user),
            "FT.AGGREGATE": lambda: self.ft_aggregate(*rest, user=user),
            "FT.INFO": lambda: self.ft_info(*rest, user=user),
            "FT._LIST": lambda: self.ft_list(),
            "FT._DEBUG": lambda: self.ft_debug(*rest),
            "INFO": lambda: self.info(),
        }
        if cmd in table:
            # per-command category gate BEFORE the handler (prefix ACL
            # checks run inside the handlers)
            self._acl_check_command(user, cmd)
        def dispatch():
            if cmd == "HSET":
                if len(rest) < 3 or len(rest) % 2 == 0:
                    raise CommandError("wrong number of arguments for HSET")
                mapping = {
                    _s(rest[i]): rest[i + 1] for i in range(1, len(rest), 2)
                }
                return self.hset(_s(rest[0]), mapping)
            if cmd == "DEL":
                return sum(self.delete(_s(k)) for k in rest)
            if cmd == "HGETALL":
                return self.hgetall(_s(rest[0]))
            if cmd == "JSON.SET":
                if len(rest) != 3:
                    raise CommandError("JSON.SET key path value")
                return self.json_set(_s(rest[0]), _s(rest[1]), rest[2])
            if cmd == "JSON.GET":
                if not rest:
                    raise CommandError("JSON.GET key [path]")
                return self.json_get(
                    _s(rest[0]), _s(rest[1]) if len(rest) > 1 else "$"
                )
            if cmd == "EXPIRE":
                return self.expire(_s(rest[0]), float(_s(rest[1])))
            if cmd == "PEXPIRE":
                return self.expire(_s(rest[0]), float(_s(rest[1])) / 1000.0)
            if cmd == "TTL":
                return self.ttl(_s(rest[0]))
            if cmd == "PERSIST":
                return self.persist(_s(rest[0]))
            if cmd in ("HEXPIRE", "HPEXPIRE", "HTTL", "HPTTL", "HPERSIST"):
                # HFE surface: <key> [<seconds|ms>] FIELDS <n> f [f ...]
                args2 = [_s(a) for a in rest]
                key = args2[0]
                i = 2 if cmd in ("HEXPIRE", "HPEXPIRE") else 1
                if len(args2) < i + 2 or args2[i].upper() != "FIELDS":
                    raise CommandError(f"{cmd} key [ttl] FIELDS n field ...")
                nf = int(args2[i + 1])
                flds = args2[i + 2 : i + 2 + nf]
                if len(flds) != nf:
                    raise CommandError("FIELDS count mismatch")
                if cmd == "HEXPIRE":
                    return self.hexpire(key, float(args2[1]), flds)
                if cmd == "HPEXPIRE":
                    return self.hexpire(key, float(args2[1]) / 1000.0, flds)
                if cmd == "HPERSIST":
                    return self.hpersist(key, flds)
                return self.httl(key, flds, ms=(cmd == "HPTTL"))
            if cmd == "COPY":
                if len(rest) < 2:
                    raise CommandError("COPY source destination [REPLACE]")
                replace = any(_s(a).upper() == "REPLACE" for a in rest[2:])
                return self.copy(_s(rest[0]), _s(rest[1]), replace)
            if cmd == "EXISTS":
                # lazy-expiry probe first: a logically expired key must
                # read as absent even before the cron sweep touches it
                for k in rest:
                    self._expire_if_due(_s(k))
                with self._lock:
                    return sum(1 for k in rest if _s(k) in self.keyspace)
            if cmd == "TYPE":
                self._expire_if_due(_s(rest[0]))
                with self._lock:
                    doc = self.keyspace.get(_s(rest[0]))
                if doc is None:
                    return "none"
                return "ReJSON-RL" if set(doc) == {"$"} else "hash"
            if cmd == "HGET":
                if len(rest) != 2:
                    raise CommandError("HGET key field")
                self._expire_if_due(_s(rest[0]))
                with self._lock:
                    return self.keyspace.get(_s(rest[0]), {}).get(_s(rest[1]))
            if cmd == "HMGET":
                if len(rest) < 2:
                    raise CommandError("HMGET key field [field ...]")
                self._expire_if_due(_s(rest[0]))
                with self._lock:
                    doc = self.keyspace.get(_s(rest[0]), {})
                    return [doc.get(_s(f)) for f in rest[1:]]
            if cmd == "HDEL":
                if len(rest) < 2:
                    raise CommandError("HDEL key field [field ...]")
                return self.hdel(_s(rest[0]), *[_s(f) for f in rest[1:]])
            if cmd == "KEYS":
                import fnmatch as _fn
                import time as _time

                pat = _s(rest[0]) if rest else "*"
                now = _time.time()
                with self._lock:
                    out, due = [], []
                    for k in self.keyspace:
                        if self._expiry.get(k, now + 1) <= now:
                            due.append(k)  # logically expired: hidden
                        elif _fn.fnmatchcase(k, pat):
                            out.append(k)
                for k in due:
                    self._expire_if_due(k)
                return out
            if cmd == "SCAN":
                # cursor semantics over a sorted key snapshot (valkey's
                # SCAN guarantees are looser; sorted-order paging gives
                # the same complete-iteration property for a stable set)
                import fnmatch as _fn

                cursor = int(_s(rest[0])) if rest else 0
                pat, count = "*", 10
                i = 1
                while i < len(rest):
                    opt = _s(rest[i]).upper()
                    if opt == "MATCH" and i + 1 < len(rest):
                        pat = _s(rest[i + 1])
                        i += 2
                    elif opt == "COUNT" and i + 1 < len(rest):
                        count = max(1, int(_s(rest[i + 1])))
                        i += 2
                    elif opt == "TYPE" and i + 1 < len(rest):
                        i += 2  # single logical type: accepted, no-op
                    else:
                        raise CommandError(f"bad SCAN option {opt!r}")
                import time as _time

                now = _time.time()
                with self._lock:
                    keys = sorted(self.keyspace)
                page = keys[cursor:cursor + count]
                nxt = cursor + count
                if nxt >= len(keys):
                    nxt = 0
                out = []
                for k in page:
                    if not _fn.fnmatchcase(k, pat):
                        continue
                    with self._lock:
                        due = self._expiry.get(k, now + 1) <= now
                    if due:
                        self._expire_if_due(k)  # hidden + reaped lazily
                    else:
                        out.append(k)
                return [str(nxt), out]
            fn = table.get(cmd)
            if fn is None:
                raise CommandError(f"unknown command {cmd!r}")
            return fn()

        try:
            return dispatch()
        except (TypeError, IndexError) as exc:
            # arity/shape errors surface as the redis-style command error
            # instead of leaking python signature failures
            raise CommandError(
                f"wrong number of arguments for {cmd}"
            ) from exc


def _apply_json(eng: "Engine", key: str, path: str, value: Value) -> Dict[str, Value]:
    """Apply a JSON.SET to the keyspace (caller holds eng._lock); returns
    the new {"$": raw} snapshot for notification."""
    import json as _json

    raw = value.decode() if isinstance(value, bytes) else str(value)
    new_val = _json.loads(raw)
    if path in ("$", "."):
        doc = new_val
    else:
        cur_raw = eng.keyspace.get(key, {}).get("$")
        doc = _json.loads(cur_raw) if cur_raw else {}
        parts = path.lstrip("$").lstrip(".").split(".")
        parent = doc
        for p in parts[:-1]:
            nxt = parent.get(p) if isinstance(parent, dict) else None
            if not isinstance(nxt, (dict, list)):
                nxt = {}
                parent[p] = nxt
            parent = nxt
        parent[parts[-1]] = new_val
    snapshot = {"$": _json.dumps(doc)}
    eng.keyspace[key] = snapshot
    return snapshot


class Transaction:
    """Queued keyspace writes applied atomically on exec().

    Two usage modes:
    - deferred (hset/delete/json_set + exec): all writes apply at exec()
      under the engine lock — the embedded-API transaction.
    - in-order (hset_now/delete_now/json_set_now + flush_notifications):
      the RESP MULTI/EXEC path applies each keyspace write at its queue
      position (redis executes queued commands strictly in order, so
      reads inside the transaction see earlier writes) while the *index*
      notifications still commit as one ordered mutation group
      (reference EnqueueMultiMutation, index_schema.cc:834). The caller
      must hold engine._lock for the whole transaction.
    """

    def __init__(self, engine: Engine):
        self._engine = engine
        self._ops: List[tuple] = []
        self._notifications: List[tuple] = []  # (schema, key, fields|None)
        self._done = False

    def hset(self, key: str, mapping: Dict[str, Value]) -> "Transaction":
        self._ops.append(("hset", key, dict(mapping)))
        return self

    def delete(self, key: str) -> "Transaction":
        self._ops.append(("del", key, None))
        return self

    def json_set(self, key: str, path: str, value: Value) -> "Transaction":
        self._ops.append(("json", key, (path, value)))
        return self

    def discard(self) -> None:
        self._ops.clear()
        self._done = True

    # -- in-order application (RESP MULTI/EXEC; caller holds eng._lock) ----
    def hset_now(self, key: str, mapping: Dict[str, Value]) -> int:
        eng = self._engine
        doc = eng.keyspace.setdefault(key, {})
        added = sum(1 for f in mapping if f not in doc)
        doc.update(mapping)
        self._collect(key, dict(doc), "HASH")
        return added

    def delete_now(self, key: str) -> int:
        eng = self._engine
        existed = eng.keyspace.pop(key, None) is not None
        eng._expiry.pop(key, None)
        eng._access.pop(key, None)
        eng._freq.pop(key, None)
        if existed:
            self._collect(key, None, None)
        return int(existed)

    def json_set_now(self, key: str, path: str, value: Value) -> str:
        snapshot = _apply_json(self._engine, key, path, value)
        self._collect(key, snapshot, "JSON")
        return "OK"

    def _collect(self, key: str, snapshot, kind) -> None:
        for schema in self._engine.manager.subscribed(key):
            if snapshot is not None and schema.on != kind:
                continue
            self._notifications.append((schema, key, snapshot))

    def flush_notifications(self) -> None:
        """Commit the collected index notifications as one ordered group."""
        eng = self._engine
        notifications, self._notifications = self._notifications, []
        if not notifications:
            return
        if eng._sync_ingest:
            for schema, key, fields in notifications:
                if fields is None:
                    schema.delete(key)
                else:
                    schema.upsert(key, fields)
        else:
            from valkey_search_tpu_torch.schema.ingestion import Mutation

            eng._queue().enqueue_multi([
                Mutation(schema, key, fields)
                for schema, key, fields in notifications
            ])

    def exec(self) -> int:
        """Apply all queued writes under the engine lock; index mutations
        land as one ordered group."""
        if self._done:
            raise CommandError("transaction already finished")
        self._done = True
        eng = self._engine
        n_ops = len(self._ops)
        with eng._lock:
            for op, key, arg in self._ops:
                if op == "hset":
                    self.hset_now(key, arg)
                elif op == "json":
                    self.json_set_now(key, *arg)
                else:  # del
                    self.delete_now(key)
            self._ops = []
            self.flush_notifications()
        return n_ops


def _s(v: Value) -> str:
    if isinstance(v, bytes):
        return v.decode()
    return str(v)
