"""Engine: keyspace + schemas + FT.* command dispatch on the PyTorch port.

Counterpart of valkey_search_tpu/server/engine.py. The engine owns its
keyspace (HSET/DEL/HGETALL) and indexes every write synchronously through
the subscribed schemas, and ``execute(argv)`` takes redis-style argument
vectors:

    FT.CREATE, FT.SEARCH, FT.INFO, FT._LIST, FT.DROPINDEX,
    HSET, HGETALL, DEL.

An HSET indexes every field a subscribed schema declares (VECTOR FLAT and
HNSW, TAG, NUMERIC, TEXT); a DEL removes the key from every index. FT.INFO
reports an HNSW attribute as the JAX package does; the cron's HNSW vacuum is
not ported (``HnswVectorIndex.vacuum`` stays callable).

Commands whose modules are not ported yet raise ``CommandError`` naming the
module of the JAX package that serves them; ACL users other than "default",
asynchronous ingestion, key expiry, persistence and the cron are not ported
either.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Union

from valkey_search_tpu_torch.runtime import config
from valkey_search_tpu_torch.runtime.metrics import STATS
from valkey_search_tpu_torch.schema.schema_manager import SchemaManager
from valkey_search_tpu_torch.server import ft_create as ft_create_mod
from valkey_search_tpu_torch.server import ft_search as ft_search_mod

Value = Union[str, bytes, int, float]

# command -> the JAX package's module that serves it (not ported yet)
_NOT_PORTED = {
    "FT.AGGREGATE": "server/ft_aggregate.py",
    "FT._DEBUG": "server/ft_debug.py",
    "INFO": "runtime/info.py",
    "JSON.SET": "server/engine.py JSON documents",
    "JSON.GET": "server/engine.py JSON documents",
    "SAVE": "persistence/",
    "BGSAVE": "persistence/",
    "EXPIRE": "server/engine.py key expiry",
    "PEXPIRE": "server/engine.py key expiry",
    "TTL": "server/engine.py key expiry",
    "PERSIST": "server/engine.py key expiry",
    "HEXPIRE": "server/engine.py hash-field expiry",
    "HPEXPIRE": "server/engine.py hash-field expiry",
    "HTTL": "server/engine.py hash-field expiry",
    "HPTTL": "server/engine.py hash-field expiry",
    "HPERSIST": "server/engine.py hash-field expiry",
    "MULTI": "server/engine.py transactions",
    "EXEC": "server/engine.py transactions",
    "HDEL": "server/engine.py keyspace commands",
    "HGET": "server/engine.py keyspace commands",
    "HMGET": "server/engine.py keyspace commands",
    "EXISTS": "server/engine.py keyspace commands",
    "TYPE": "server/engine.py keyspace commands",
    "KEYS": "server/engine.py keyspace commands",
    "SCAN": "server/engine.py keyspace commands",
    "COPY": "server/engine.py keyspace commands",
}


class CommandError(ValueError):
    pass


def _s(v: Value) -> str:
    return v.decode() if isinstance(v, bytes) else str(v)


class Engine:
    def __init__(self):
        self.manager = SchemaManager()
        self.keyspace: Dict[str, Dict[str, Value]] = {}
        self._lock = threading.RLock()

    # ------------------------------------------------------------------ data
    def hset(self, key: str, mapping: Dict[str, Value]) -> int:
        """HSET; the write is indexed by every subscribed schema."""
        with self._lock:
            doc = self.keyspace.setdefault(key, {})
            added = sum(1 for f in mapping if f not in doc)
            doc.update(mapping)
            snapshot = dict(doc)
        self._notify(key, snapshot)
        return added

    def delete(self, key: str) -> int:
        with self._lock:
            existed = self.keyspace.pop(key, None) is not None
        if existed:
            self._notify_delete(key)
        return int(existed)

    def hgetall(self, key: str) -> Dict[str, Value]:
        with self._lock:
            doc = self.keyspace.get(key)
            return dict(doc) if doc is not None else {}

    def _notify(self, key: str, fields: Dict[str, Value]) -> None:
        for schema in self.manager.subscribed(key):
            if schema.on == "HASH":
                schema.upsert(key, fields)

    def _notify_delete(self, key: str) -> None:
        for schema in self.manager.subscribed(key):
            schema.delete(key)

    # ------------------------------------------------------------- commands
    def ft_create(self, *args: Value) -> str:
        schema, skip_scan = ft_create_mod.parse_ft_create(
            [_s(a) for a in args])
        self.manager.create(schema)
        if not skip_scan:
            with self._lock:
                snapshot = {k: dict(v) for k, v in self.keyspace.items()}
            self.manager.backfill(schema, snapshot)
        return "OK"

    def ft_dropindex(self, name: Value) -> str:
        self.manager.drop(_s(name))
        return "OK"

    def ft_list(self) -> List[str]:
        return self.manager.list_names()

    def ft_search(self, *args: Value) -> list:
        STATS.incr("queries_total")
        try:
            sp = ft_search_mod.parse_ft_search_args(list(args))
            schema = self.manager.get(sp.index_name)
            return ft_search_mod.run_ft_search(self, schema, sp)
        except Exception:
            STATS.incr("query_errors")
            raise

    def ft_info(self, name: Value) -> list:
        schema = self.manager.get(_s(name))
        st = schema.stats()
        attrs = [
            ["identifier", a["identifier"], "attribute", alias,
             "type", a["type"], "num_records", a["tracked"],
             "user_indexed_memory", a["memory"]]
            for alias, a in st["attributes"].items()
        ]
        topts = schema.text_options or {}
        out = [
            "index_name", st["name"],
            "index_options", [],
            "index_definition",
            ["key_type", st["on"], "prefixes", st["prefixes"],
             "default_score", topts.get("score", 1.0),
             "score_field", topts.get("score_field")],
            "attributes", attrs,
            "num_docs", st["num_docs"],
            "num_records", sum(a["tracked"]
                               for a in st["attributes"].values()),
        ]
        eng = schema.text_engine
        if eng is None:
            # the text counters come first, 0 without a text index
            # (index_schema.cc:1230-1237)
            out += ["total_term_occurrences", 0, "num_terms", 0]
        out += [
            "hash_indexing_failures", schema.indexing_failures,
            "backfill_in_progress", int(st["backfill_in_progress"]),
            "backfill_complete_percent",
            "1.000000" if not st["backfill_in_progress"] else "0.000000",
            "mutation_queue_size", 0,
            "recent_mutations_queue_delay", "0 sec",
            "state", "ready",
        ]
        if eng is not None:  # text sections (index_schema.cc:1194-1280)
            out += [
                "num_terms", eng.stats()["distinct_words"],
                "total_term_occurrences", sum(
                    p.position_count() for _, p in eng.dictionary.items()),
                "punctuation", eng.options.punctuation,
                "stop_words", list(eng.options.stop_words),
                "with_offsets", int(eng.options.with_offsets),
                "min_stem_size", eng.lexer.min_stem_size,
                "language", "english",
            ]
        return out

    def config_set(self, name: Value, value: Value) -> str:
        config.set_config(_s(name), value)
        return "OK"

    # redis-style generic dispatch -----------------------------------------
    def execute(self, *argv: Value, user: str = "default"):
        if not argv:
            raise CommandError("empty command")
        cmd = _s(argv[0]).upper()
        rest = list(argv[1:])
        if user != "default":
            raise CommandError("ACL users are not ported yet (server/acl.py)")
        if cmd in _NOT_PORTED:
            raise CommandError(
                f"{cmd} is not ported yet (valkey_search_tpu/"
                f"{_NOT_PORTED[cmd]})")
        table = {
            "FT.CREATE": lambda: self.ft_create(*rest),
            "FT.DROPINDEX": lambda: self.ft_dropindex(*rest),
            "FT.SEARCH": lambda: self.ft_search(*rest),
            "FT.INFO": lambda: self.ft_info(*rest),
            "FT._LIST": lambda: self.ft_list(),
            "HGETALL": lambda: self.hgetall(_s(rest[0])),
            "DEL": lambda: sum(self.delete(_s(k)) for k in rest),
        }

        def dispatch():
            if cmd == "HSET":
                if len(rest) < 3 or len(rest) % 2 == 0:
                    raise CommandError("wrong number of arguments for HSET")
                mapping = {
                    _s(rest[i]): rest[i + 1] for i in range(1, len(rest), 2)
                }
                return self.hset(_s(rest[0]), mapping)
            fn = table.get(cmd)
            if fn is None:
                raise CommandError(f"unknown command {cmd!r}")
            return fn()

        try:
            return dispatch()
        except (TypeError, IndexError) as exc:
            # arity errors surface as the redis-style command error
            raise CommandError(
                f"wrong number of arguments for {cmd}") from exc
