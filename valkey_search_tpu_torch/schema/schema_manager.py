"""SchemaManager: per-db index registry + backfill.

Copied from valkey_search_tpu/schema/schema_manager.py (reference
src/schema_manager.{h,cc}), holding the port's IndexSchema. A synchronous
engine backfills a new index inside FT.CREATE (``backfill``); an
asynchronous one advances it by cursor batches on cron ticks
(``backfill_batch``), through the writer pool at low priority.
"""

from __future__ import annotations

import threading
from typing import Dict, Iterable, List, Optional, Tuple

from valkey_search_tpu_torch.runtime import config
from valkey_search_tpu_torch.runtime.debug import PAUSEPOINTS
from valkey_search_tpu_torch.runtime.metrics import STATS
from valkey_search_tpu_torch.utils.patricia import PatriciaTree
from valkey_search_tpu_torch.schema.index_schema import IndexSchema, SchemaError

__all__ = ["SchemaError", "SchemaManager"]


class SchemaManager:
    def __init__(self):
        self._schemas: Dict[Tuple[int, str], IndexSchema] = {}
        self._subscriptions = PatriciaTree()  # prefix -> schemas
        self._lock = threading.RLock()

    def create(self, schema: IndexSchema) -> IndexSchema:
        with self._lock:
            key = (schema.db, schema.name)
            if key in self._schemas:
                raise SchemaError(f"Index {schema.name} already exists")
            if len(self._schemas) >= int(config.get("search.max-indexes")):
                raise SchemaError("too many indexes")
            self._schemas[key] = schema
            for p in schema.prefixes:
                self._subscriptions.insert(p, schema)
            STATS.incr("indexes_created")
            return schema

    def get(self, name: str, db: int = 0) -> IndexSchema:
        with self._lock:
            s = self._schemas.get((db, name))
            if s is None:
                raise SchemaError(f"Index with name '{name}' not found")
            return s

    def drop(self, name: str, db: int = 0) -> None:
        with self._lock:
            if (db, name) not in self._schemas:
                raise SchemaError(f"Index with name '{name}' not found")
            schema = self._schemas.pop((db, name))
            for p in schema.prefixes:
                self._subscriptions.remove(p, schema)
            STATS.incr("indexes_dropped")

    def list_names(self, db: int = 0) -> List[str]:
        with self._lock:
            return sorted(n for (d, n) in self._schemas if d == db)

    def all_schemas(self) -> List[IndexSchema]:
        with self._lock:
            return list(self._schemas.values())

    def subscribed(self, key: str, db: int = 0) -> Iterable[IndexSchema]:
        """Schemas whose prefix set matches the key (patricia dispatch,
        deduplicated: a schema may own several covering prefixes)."""
        with self._lock:
            seen = set()
            out = []
            for s in self._subscriptions.match(key):
                if id(s) not in seen and s.db == db:
                    seen.add(id(s))
                    out.append(s)
            return out

    def backfill(
        self,
        schema: IndexSchema,
        keyspace: Dict[str, Dict[str, object]],
        batch_size: Optional[int] = None,
    ) -> int:
        """Scan existing keys into a fresh index (reference
        IndexSchema::PerformBackfill, index_schema.cc:1044)."""
        batch_size = batch_size or int(config.get("search.backfill-batch-size"))
        schema.backfill_in_progress = True
        n = 0
        try:
            for key, fields in list(keyspace.items()):
                if not schema.matches_key(key):
                    continue
                if n % batch_size == 0:
                    PAUSEPOINTS.test("backfill.batch")
                schema.upsert(key, fields)
                n += 1
                schema.backfill_scanned = n
        finally:
            schema.backfill_in_progress = False
        STATS.incr("backfilled_records", n)
        return n

    def backfill_batch(
        self,
        schema: IndexSchema,
        keyspace: Dict[str, Dict[str, object]],
        batch_size: Optional[int] = None,
        ingestion=None,
        fetch=None,
    ) -> int:
        """Advance one cursor-batched backfill step (reference
        SchemaManager::PerformBackfill driven from server cron,
        schema_manager.cc:621: scan-cursor batches, low priority, paused
        while over the memory cap). Returns the keys processed this step; 0
        when complete. The scan snapshot is the key list at cron time: keys
        written after the cursor passed them arrive by keyspace
        notification."""
        if schema.paused_by_oom:
            return 0
        batch_size = batch_size or int(config.get("search.backfill-batch-size"))
        PAUSEPOINTS.test("backfill.batch")
        keys = sorted(k for k in keyspace if schema.matches_key(k))
        cursor = schema.backfill_cursor
        chunk = keys[cursor : cursor + batch_size]
        if not chunk:
            if ingestion is not None and schema.backfill_outstanding > 0:
                # every key is enqueued but some still apply: complete
                # means applied, so stay in progress until they settle
                return 0
            schema.backfill_in_progress = False
            schema.backfill_cursor = 0
            return 0
        schema.backfill_in_progress = True
        if ingestion is not None:
            # writer pool at LOW priority (reference index_schema.cc:994):
            # live writes overtake a bulk backfill. The mutations are
            # refreshes: the worker fetches the CURRENT fields at apply time
            # (a snapshot value could resurrect a key deleted meanwhile),
            # and a key with a pending mutation is skipped outright.
            if fetch is None:
                fetch = keyspace.get

            def _done(s=schema):
                with s._backfill_ctr_lock:
                    s.backfill_outstanding -= 1

            for key in chunk:
                if keyspace.get(key) is None:
                    continue
                with schema._backfill_ctr_lock:
                    schema.backfill_outstanding += 1
                ingestion.enqueue_refresh(
                    schema, key, fetch, on_done=_done, priority="low"
                )
        else:
            for key in chunk:
                fields = keyspace.get(key)
                if fields is not None:
                    schema.upsert(key, fields)
        schema.backfill_cursor = cursor + len(chunk)
        schema.backfill_scanned = schema.backfill_cursor
        if schema.backfill_cursor >= len(keys) and not (
                ingestion is not None and schema.backfill_outstanding > 0):
            # with refreshes still queued or applying, a later tick (the
            # empty-chunk path) finishes once the outstanding count settles
            schema.backfill_in_progress = False
            schema.backfill_cursor = 0
        STATS.incr("backfilled_records", len(chunk))
        return len(chunk)


MANAGER = SchemaManager()
