"""Engine checkpoint save/load.

Reference flow (SURVEY.md §3.5): AuxSaveCallback → PerformRDBSave →
per-section SchemaManager::SaveIndexes → IndexSchema::RDBSave
(index_schema.cc:1340): the index definition proto, then per vector
attribute the proto-framed hnswlib graph (hnswalg.h:807) and the
tracked-keys (key→id, magnitude) map; tag/numeric/text indexes are NOT
serialized — they rebuild from the key list on load. The skip-rdb-load
config drops the vector payload and rebuilds everything via backfill
(README.md:60-77).

Here the "database" (keyspace) is also ours, so a checkpoint is:
    engine header → keyspace blob → per schema: definition + interner
    id map → per vector attribute: store arrays + native graph export.
Load restores the id space verbatim, imports vector state without
re-inserting a single point, and replays non-vector attributes from the
restored keyspace.

The port's own copy of valkey_search_tpu/persistence/checkpoint.py, with its imports
pointing into valkey_search_tpu_torch.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional

import numpy as np

from valkey_search_tpu_torch.persistence.format import ChunkReader, ChunkWriter
from valkey_search_tpu_torch.indexes.base import RecordResult
from valkey_search_tpu_torch.runtime.metrics import STATS


class CheckpointError(IOError):
    pass


# -- keyspace binary codec ------------------------------------------------------

def _pack_str(out: bytearray, s: bytes) -> None:
    out += struct.pack("<I", len(s))
    out += s


def _encode_keyspace(docs: Dict[str, Dict[str, object]]) -> np.ndarray:
    out = bytearray()
    out += struct.pack("<I", len(docs))
    for key, fields in docs.items():
        _pack_str(out, key.encode())
        out += struct.pack("<I", len(fields))
        for name, val in fields.items():
            _pack_str(out, str(name).encode())
            if isinstance(val, bytes):
                out += b"\x01"
                _pack_str(out, val)
            else:
                out += b"\x00"
                _pack_str(out, str(val).encode())
    return np.frombuffer(bytes(out), np.uint8)


def _decode_keyspace(arr: np.ndarray) -> Dict[str, Dict[str, object]]:
    buf = arr.tobytes()
    pos = 0

    def u32() -> int:
        nonlocal pos
        (v,) = struct.unpack_from("<I", buf, pos)
        pos += 4
        return v

    def blob() -> bytes:
        nonlocal pos
        n = u32()
        b = buf[pos : pos + n]
        pos += n
        return b

    docs: Dict[str, Dict[str, object]] = {}
    for _ in range(u32()):
        key = blob().decode()
        fields: Dict[str, object] = {}
        for _f in range(u32()):
            name = blob().decode()
            tag = buf[pos]
            pos += 1
            raw = blob()
            fields[name] = raw if tag == 1 else raw.decode()
        docs[key] = fields
    return docs


def _pack_keys(keys: List[str]) -> np.ndarray:
    return np.frombuffer(b"\x00".join(k.encode() for k in keys), np.uint8)


def _unpack_keys(arr: np.ndarray, n: int) -> List[str]:
    if n == 0:
        return []
    return [b.decode() for b in arr.tobytes().split(b"\x00")]


# -- schema definitions ----------------------------------------------------------

def _attr_definition(attr) -> Dict:
    idx = attr.index
    d = {"alias": attr.alias, "identifier": attr.identifier, "kind": attr.kind}
    if attr.kind == "TAG":
        d["separator"] = idx.separator
        d["case_sensitive"] = idx.case_sensitive
    elif attr.kind == "TEXT":
        d["no_stem"] = idx.info.no_stem
        d["with_suffix_trie"] = idx.info.with_suffix_trie
        d["weight"] = idx.info.weight
    elif attr.kind in ("HNSW", "FLAT"):
        d["dim"] = idx.dim
        d["metric"] = idx.metric
        if attr.kind == "HNSW":
            d["m"] = idx.m
            d["ef_construction"] = idx.ef_construction
            d["ef_runtime"] = idx.ef_runtime
    return d


def _schema_definition(schema) -> Dict:
    return {
        "name": schema.name,
        "prefixes": list(schema.prefixes),
        "on": schema.on,
        "db": schema.db,
        "text_options": getattr(schema, "text_options", None),
        "mutation_epoch": schema.mutation_epoch,
        "attributes": [
            _attr_definition(a) for a in schema.attributes.values()
        ],
    }


def _build_schema(defn: Dict):
    from valkey_search_tpu_torch.schema.index_schema import IndexSchema

    schema = IndexSchema(
        defn["name"], prefixes=tuple(defn["prefixes"]), on=defn["on"],
        db=defn.get("db", 0),
    )
    if defn.get("text_options") is not None:
        schema.text_options = defn["text_options"]
    for a in defn["attributes"]:
        kind = a["kind"]
        if kind == "TAG":
            schema.add_tag_attribute(
                a["alias"], a["identifier"], separator=a["separator"],
                case_sensitive=a["case_sensitive"],
            )
        elif kind == "NUMERIC":
            schema.add_numeric_attribute(a["alias"], a["identifier"])
        elif kind == "TEXT":
            schema.add_text_attribute(
                a["alias"], a["identifier"], no_stem=a["no_stem"],
                with_suffix_trie=a["with_suffix_trie"], weight=a["weight"],
            )
        elif kind in ("HNSW", "FLAT"):
            schema.add_vector_attribute(
                a["alias"], a["identifier"], algorithm=kind, dim=a["dim"],
                metric=a["metric"], m=a.get("m", 16),
                ef_construction=a.get("ef_construction", 200),
                ef_runtime=a.get("ef_runtime"),
            )
        else:
            raise CheckpointError(f"unknown attribute kind {kind!r}")
    return schema


# -- vector sections --------------------------------------------------------------

def _save_vector_attr(w: ChunkWriter, schema, attr) -> None:
    idx = attr.index
    st = idx.store
    tracked_keys = list(idx.tracked_keys())
    tracked_docs = np.asarray(
        [idx.doc_of(k) for k in tracked_keys], np.int32
    )
    meta = {
        "type": "vector",
        "schema": schema.name,
        "db": schema.db,
        "alias": attr.alias,
        "kind": attr.kind,
        "capacity": st.capacity,
        "tracked_count": len(tracked_keys),
    }
    arrays = [
        st.vectors, st.norms_sq, st.magnitudes,
        st.present.astype(np.uint8),
        _pack_keys(tracked_keys), tracked_docs,
    ]
    if attr.kind == "HNSW":
        g = idx.builder.export_graph()
        meta["graph"] = {
            "entry": int(g["entry"]),
            "max_level": int(g["max_level"]),
            "count": int(g["count"]),
            "num_upper_levels": len(g["uppers"]),
        }
        arrays += [
            g["links0"], g["levels"], g["deleted"].astype(np.uint8),
            idx._node_doc, idx._deleted.astype(np.uint8),
        ]
        for lv in g["uppers"]:
            arrays += [lv["nodes"], lv["links"]]
    w.section(meta, arrays)


def _restore_vector_attr(schema, meta: Dict, arrays: List[np.ndarray]) -> None:
    attr = schema.attribute(meta["alias"])
    idx = attr.index
    st = idx.store
    vectors, norms_sq, magnitudes, present, keys_blob, tracked_docs = arrays[:6]
    st.vectors = np.array(vectors, np.float32)
    st.norms_sq = np.array(norms_sq, np.float32)
    st.magnitudes = np.array(magnitudes, np.float32)
    st.present = np.array(present, bool)
    st._device = None
    st.epoch += 1
    keys = _unpack_keys(keys_blob, meta["tracked_count"])
    if len(keys) != meta["tracked_count"]:
        raise CheckpointError("tracked key count mismatch")
    idx._tracked = {k: int(d) for k, d in zip(keys, tracked_docs)}
    if meta["kind"] == "HNSW":
        g = meta["graph"]
        links0, levels, gdeleted, node_doc, deleted = arrays[6:11]
        uppers = []
        pos = 11
        for _ in range(g["num_upper_levels"]):
            uppers.append({"nodes": arrays[pos], "links": arrays[pos + 1]})
            pos += 2
        idx.builder.import_graph(
            st.vectors,
            {
                "links0": links0, "levels": levels,
                "deleted": gdeleted.astype(bool), "uppers": uppers,
                "entry": g["entry"], "max_level": g["max_level"],
                "count": g["count"],
            },
        )
        idx._node_doc = np.array(node_doc, np.int32)
        idx._deleted = np.array(deleted, bool)
        idx._doc_node = {
            int(doc): int(node)
            for node, doc in enumerate(idx._node_doc[: g["count"]])
            if doc >= 0 and not idx._deleted[node]
        }
        idx._graph_dirty = True
        idx._device_graph = None


# -- top level --------------------------------------------------------------------

def save_engine(engine, path: str) -> Dict[str, int]:
    """Write a full checkpoint. Returns summary counters.

    Runs under the engine lock: every keyspace write path holds it, so
    the serialized state is a consistent point-in-time snapshot and the
    dict iterations below cannot race a concurrent HSET/DEL (redis SAVE
    blocks writes the same way; BGSAVE here is a thread, not a fork, so
    it briefly stalls writers instead of COW-sharing pages)."""
    try:
        lock = getattr(engine, "_lock", None)
        if lock is not None:
            with lock:
                return _save_engine_locked(engine, path)
        return _save_engine_locked(engine, path)
    except Exception:
        STATS.incr("rdb_save_failures")
        raise


def _save_engine_locked(engine, path: str) -> Dict[str, int]:
    schemas = engine.manager.all_schemas()
    with ChunkWriter(path) as w:
        w.section({"type": "engine", "num_schemas": len(schemas)})
        w.section({"type": "keyspace"}, [_encode_keyspace(engine.keyspace)])
        expiry = dict(getattr(engine, "_expiry", {}))
        if expiry:
            # volatile keys keep their absolute unix deadline across a
            # restore (reference: RDB stores absolute expiry ms per key)
            ekeys = list(expiry)
            w.section(
                {"type": "expiry", "count": len(ekeys)},
                [
                    _pack_keys(ekeys),
                    np.asarray([expiry[k] for k in ekeys], np.float64),
                ],
            )
        fexp = dict(getattr(engine, "_field_expiry", {}))
        if fexp:
            # hash-field TTLs (HFE) survive save/restore like key TTLs;
            # keys and field names pack as two parallel arrays (keys may
            # contain any byte, so no in-band separator)
            fkeys = list(fexp)
            w.section(
                {"type": "field_expiry", "count": len(fkeys)},
                [
                    _pack_keys([k for k, _ in fkeys]),
                    _pack_keys([f for _, f in fkeys]),
                    np.asarray([fexp[kf] for kf in fkeys], np.float64),
                ],
            )
        for schema in schemas:
            interner_items = list(schema.interner.items())
            w.section(
                {
                    "type": "schema",
                    "definition": _schema_definition(schema),
                    "interner_capacity": schema.interner.capacity,
                    "interner_count": len(interner_items),
                },
                [
                    _pack_keys([k for k, _ in interner_items]),
                    np.asarray([d for _, d in interner_items], np.int32),
                ],
            )
            for attr in schema.attributes.values():
                if attr.kind in ("HNSW", "FLAT"):
                    _save_vector_attr(w, schema, attr)
    STATS.incr("rdb_saves")
    return {"schemas": len(schemas), "keys": len(engine.keyspace)}


def _replay_nonvector(schema, keyspace: Dict[str, Dict[str, object]]) -> None:
    """Rebuild tag/numeric/text state from the restored keyspace
    (reference: non-vector indexes rebuilt from tracked keys by re-reading
    the db, index_schema.cc:1685 load path)."""
    nonvec = [a for a in schema.attributes.values()
              if a.kind not in ("HNSW", "FLAT")]
    for key, fields in keyspace.items():
        if not schema.matches_key(key):
            continue
        schema._documents[key] = dict(fields)
        invalid = False
        for attr in nonvec:
            val = schema.data_type.fetch(fields, attr.identifier)
            if val is not None:
                if attr.index.add_record(key, val) is RecordResult.INVALID_DATA:
                    invalid = True
        if invalid:
            for attr in schema.attributes.values():
                attr.index.remove_record(key)
            schema.interner.release(key)


def load_engine(
    path: str,
    engine=None,
    skip_vector_payload: Optional[bool] = None,
):
    """Restore a checkpoint into ``engine`` (or a fresh Engine).

    ``skip_vector_payload`` mirrors the reference's skip-index-load config
    (rdb_load_skip_index, valkey_search_options.cc:179): the saved vector
    graphs are dropped and every index rebuilds from the keyspace via the
    normal ingest path (backfill equivalent). When not passed explicitly
    it follows the ``search.skip-rdb-load`` config, so a recovery restart
    with the config set skips damaged payloads without code changes
    (index_schema.cc:1698 LoadFromRDB).

    A failure mid-load unregisters any schema this call created before
    re-raising (reference: module RDB-load errors must not leak
    half-created indexes, integration/test_rdb_load_error_cleanup.py)."""
    from valkey_search_tpu_torch.runtime import config as _config

    if skip_vector_payload is None:
        skip_vector_payload = bool(_config.get("search.skip-rdb-load"))
    if engine is None:
        from valkey_search_tpu_torch.server.engine import Engine

        engine = Engine()
    try:
        return _load_engine_inner(path, engine, skip_vector_payload)
    except Exception:
        STATS.incr("rdb_load_failures")
        raise


def _load_engine_inner(path, engine, skip_vector_payload: bool):
    pending_schemas = []
    keyspace: Dict[str, Dict[str, object]] = {}
    with ChunkReader(path) as r:
        current = None
        for meta, arrays in r.sections():
            t = meta["type"]
            if t == "engine":
                continue
            if t == "keyspace":
                keyspace = _decode_keyspace(arrays[0])
            elif t == "expiry":
                ekeys = _unpack_keys(arrays[0], meta["count"])
                engine._expiry.update(
                    {k: float(dl) for k, dl in zip(ekeys, arrays[1])}
                )
            elif t == "field_expiry":
                fkeys = _unpack_keys(arrays[0], meta["count"])
                ffields = _unpack_keys(arrays[1], meta["count"])
                engine._field_expiry.update({
                    (k, f): float(dl)
                    for k, f, dl in zip(fkeys, ffields, arrays[2])
                })
            elif t == "schema":
                schema = _build_schema(meta["definition"])
                keys = _unpack_keys(arrays[0], meta["interner_count"])
                ids = arrays[1]
                schema.interner.restore(
                    {k: int(d) for k, d in zip(keys, ids)},
                    meta["interner_capacity"],
                )
                schema.mutation_epoch = meta["definition"].get("mutation_epoch", 0)
                pending_schemas.append(schema)
                current = schema
            elif t == "vector":
                if skip_vector_payload:
                    continue
                if current is None or current.name != meta["schema"]:
                    raise CheckpointError("vector section without its schema")
                _restore_vector_attr(current, meta, arrays)
            else:
                raise CheckpointError(f"unknown section type {t!r}")
    prior_keyspace = engine.keyspace
    engine.keyspace = keyspace
    created = []
    try:
        for schema in pending_schemas:
            if skip_vector_payload:
                # full rebuild through the ingest path
                schema.interner.restore({}, 0)
                for key, fields in keyspace.items():
                    if schema.matches_key(key):
                        schema.upsert(key, fields)
            else:
                _replay_nonvector(schema, keyspace)
            engine.manager.create(schema)
            created.append(schema.name)
    except Exception:
        # half-loaded state must not leak: drop everything this load
        # registered AND restore the pre-load keyspace so a retry (or a
        # fresh FT.CREATE of the same name) starts clean — surviving
        # schemas keep agreeing with the keyspace they indexed
        # (reference test_rdb_load_error_cleanup.py)
        engine.keyspace = prior_keyspace
        for name in created:
            try:
                engine.manager.drop(name)
            except Exception:
                pass
        raise
    STATS.incr("rdb_loads")
    return engine
