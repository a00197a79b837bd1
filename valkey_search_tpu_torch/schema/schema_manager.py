"""SchemaManager: per-db index registry + synchronous backfill.

Copied from valkey_search_tpu/schema/schema_manager.py (reference
src/schema_manager.{h,cc}), holding the port's IndexSchema. The cron-driven,
cursor-batched backfill of the JAX package serves its asynchronous ingestion,
which is not ported yet; FT.CREATE backfills synchronously.
"""

from __future__ import annotations

import threading
from typing import Dict, Iterable, List, Tuple

from valkey_search_tpu_torch.runtime import config
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

    def backfill(self, schema: IndexSchema,
                 keyspace: Dict[str, Dict[str, object]]) -> int:
        """Scan existing keys into a fresh index (reference
        IndexSchema::PerformBackfill, index_schema.cc:1044)."""
        schema.backfill_in_progress = True
        n = 0
        try:
            for key, fields in list(keyspace.items()):
                if schema.matches_key(key):
                    schema.upsert(key, fields)
                    n += 1
        finally:
            schema.backfill_in_progress = False
        STATS.incr("backfilled_records", n)
        return n
