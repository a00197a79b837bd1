"""IndexSchema: one index - attribute map, shared doc-id space, ingest routing.

Counterpart of valkey_search_tpu/schema/index_schema.py (reference
src/index_schema.{h,cc}). All attribute indexes share one KeyInterner, so
predicate masks and vector rows align on one doc-id space; masks are bool
tensors on the schema's device. ``upsert``/``delete`` are the write path,
called by the engine directly or by the ingestion queue's writer threads
(schema/ingestion.py); both run under the schema's lock and touch host
structures only, so a device tensor changes at a search's publish alone.

TAG, NUMERIC, TEXT, ``VECTOR FLAT`` and ``VECTOR HNSW`` attributes are
ported. ``schema_from_reference`` builds a schema over the JAX package's
exported host state under the same doc ids.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from valkey_search_tpu_torch.runtime import config
from valkey_search_tpu_torch.runtime.metrics import STATS
from valkey_search_tpu_torch.schema.attribute_data_type import data_type_for
from valkey_search_tpu_torch.utils.interning import KeyInterner
from valkey_search_tpu_torch.indexes.base import IndexBase, RecordResult
from valkey_search_tpu_torch.indexes.flat import FlatVectorIndex
from valkey_search_tpu_torch.indexes.hnsw import HnswVectorIndex
from valkey_search_tpu_torch.indexes.numeric import NumericIndex
from valkey_search_tpu_torch.indexes.tag import TagIndex
from valkey_search_tpu_torch.indexes.vector_base import store_from_reference
from valkey_search_tpu_torch.runtime.device import get_device
from valkey_search_tpu_torch.text.text_index import TextEngine, TextFieldIndex


class SchemaError(ValueError):
    pass


def _not_ported(kind: str, module: str) -> SchemaError:
    return SchemaError(
        f"{kind} attributes are not ported yet (valkey_search_tpu/{module})")


@dataclasses.dataclass
class Attribute:
    """alias -> stored-field identifier -> index instance."""

    alias: str
    identifier: str
    index: IndexBase

    @property
    def kind(self) -> str:
        return getattr(self.index, "kind", type(self.index).__name__)


class IndexSchema:
    """One search index over a key prefix set."""

    def __init__(
        self,
        name: str,
        prefixes: Sequence[str] = ("",),
        on: str = "HASH",
        db: int = 0,
        device: Optional[torch.device] = None,
    ):
        if on not in ("HASH", "JSON"):
            raise ValueError("ON must be HASH or JSON")
        self.name = name
        self.prefixes = tuple(prefixes) or ("",)
        self.on = on
        self.data_type = data_type_for(on)
        self.db = db
        self.device = torch.device(device) if device is not None \
            else get_device()
        self.interner = KeyInterner()
        self.attributes: Dict[str, Attribute] = {}  # by alias
        self._documents: Dict[str, Dict[str, object]] = {}  # key -> fields
        self._lock = threading.RLock()
        self.mutation_epoch = 0  # bumped per applied mutation
        self.indexing_failures = 0
        self.backfill_in_progress = False
        self.backfill_scanned = 0
        self.backfill_cursor = 0
        self.backfill_outstanding = 0  # refreshes enqueued, not yet applied
        self._backfill_ctr_lock = threading.Lock()
        self.paused_by_oom = False
        self._valid_mask_cache = None
        self.text_engine: Optional[TextEngine] = None  # with the first TEXT
        self.text_options: Optional[dict] = None  # FT.CREATE's text options

    # -- definition ----------------------------------------------------------
    def add_tag_attribute(self, alias: str, identifier: Optional[str] = None,
                          separator: str = ",",
                          case_sensitive: bool = False) -> Attribute:
        idx = TagIndex(interner=self.interner, separator=separator,
                       case_sensitive=case_sensitive, device=self.device)
        return self._add(alias, identifier, idx)

    def add_numeric_attribute(self, alias: str,
                              identifier: Optional[str] = None) -> Attribute:
        return self._add(alias, identifier,
                         NumericIndex(interner=self.interner,
                                      device=self.device))

    def add_text_attribute(self, alias: str, identifier: Optional[str] = None,
                           no_stem: bool = False, with_suffix_trie: bool = True,
                           weight: float = 1.0) -> Attribute:
        if self.text_engine is None:
            self.text_engine = TextEngine(self, options=self.text_options)
        idx = TextFieldIndex(engine=self.text_engine, alias=alias,
                             no_stem=no_stem,
                             with_suffix_trie=with_suffix_trie, weight=weight)
        return self._add(alias, identifier, idx)

    def add_vector_attribute(
        self,
        alias: str,
        identifier: Optional[str] = None,
        algorithm: str = "HNSW",
        dim: int = 0,
        metric: str = "l2",
        m: int = 16,
        ef_construction: int = 200,
        ef_runtime: Optional[int] = None,
        initial_cap: int = 0,
    ) -> Attribute:
        if dim <= 0:
            raise ValueError("vector DIM must be positive")
        if algorithm.upper() == "HNSW":
            idx: IndexBase = HnswVectorIndex(
                dim=dim, metric=metric, m=m, ef_construction=ef_construction,
                ef_runtime=ef_runtime, interner=self.interner,
                device=self.device)
        elif algorithm.upper() == "FLAT":
            idx = FlatVectorIndex(dim=dim, metric=metric,
                                  interner=self.interner, device=self.device)
        else:
            raise ValueError(f"unknown vector algorithm {algorithm!r}")
        return self._add(alias, identifier, idx)

    def _add(self, alias: str, identifier: Optional[str],
             idx: IndexBase) -> Attribute:
        with self._lock:
            if alias in self.attributes:
                raise ValueError(f"duplicate attribute alias {alias!r}")
            if len(self.attributes) >= int(config.get("search.max-attributes")):
                raise ValueError("too many attributes")
            attr = Attribute(alias, identifier or alias, idx)
            self.attributes[alias] = attr
            return attr

    def attribute(self, alias: str) -> Attribute:
        a = self.attributes.get(alias)
        if a is None:
            raise KeyError(f"unknown attribute @{alias}")
        return a

    def vector_attributes(self) -> List[Attribute]:
        return [a for a in self.attributes.values()
                if a.kind in ("HNSW", "FLAT")]

    def text_attributes(self) -> List[Attribute]:
        return [a for a in self.attributes.values() if a.kind == "TEXT"]

    # -- key routing ---------------------------------------------------------
    def matches_key(self, key: str) -> bool:
        return any(key.startswith(p) for p in self.prefixes)

    # -- write path ----------------------------------------------------------
    def upsert(self, key: str,
               fields: Dict[str, object]) -> Dict[str, RecordResult]:
        """Index (or re-index) a document's attribute values. Attributes
        absent from ``fields`` are removed for this key; INVALID_DATA in any
        attribute removes the key from every index (index_schema.cc:729)."""
        results: Dict[str, RecordResult] = {}
        with self._lock:
            self._documents[key] = dict(fields)
            invalid = False
            for attr in self.attributes.values():
                val = self.data_type.fetch(fields, attr.identifier)
                if val is None:
                    r = attr.index.remove_record(key)
                else:
                    r = attr.index.add_record(key, val)
                    if r is RecordResult.INVALID_DATA:
                        invalid = True
                results[attr.alias] = r
            if invalid:
                for attr in self.attributes.values():
                    attr.index.remove_record(key)
                self.interner.release(key)
                STATS.incr("documents_dropped_invalid")
                self.indexing_failures += 1
            else:
                self._maybe_release(key)
            self.mutation_epoch += 1
            return results

    def delete(self, key: str) -> bool:
        with self._lock:
            existed = self._documents.pop(key, None) is not None
            for attr in self.attributes.values():
                attr.index.remove_record(key)
            self.interner.release(key)
            self.mutation_epoch += 1
            return existed

    def _maybe_release(self, key: str) -> None:
        """Free the doc id if no attribute tracks the key anymore."""
        if key not in self._documents:
            return
        for attr in self.attributes.values():
            if attr.index.tracks(key):
                return
        self.interner.release(key)

    # -- read helpers --------------------------------------------------------
    def document(self, key: str) -> Optional[Dict[str, object]]:
        with self._lock:
            doc = self._documents.get(key)
            return dict(doc) if doc is not None else None

    def num_docs(self) -> int:
        """Documents in the index (>= 1 indexed attribute)."""
        return self.interner.count

    def doc_capacity(self) -> int:
        """Doc-id-space capacity all predicate masks are sized to."""
        cap = max(self.interner.capacity, 1)
        for a in self.vector_attributes():
            cap = max(cap, a.index.store.capacity)
        return cap

    def docs_valid_mask(self, cap: int) -> torch.Tensor:
        """bool [cap] on the schema's device: allocated doc ids, cached per
        (interner epoch, cap)."""
        with self._lock:
            key = (self.interner.epoch, cap)
            cache = self._valid_mask_cache
            if cache is not None and cache[0] == key:
                return cache[1]
            mask = torch.from_numpy(self.interner.valid_ids_np(cap)).to(
                self.device)
            self._valid_mask_cache = (key, mask)
            return mask

    def doc_keys(self, docs: Sequence[int]) -> List[Optional[str]]:
        return [self.interner.key_of(int(d)) for d in docs]

    def memory_pools(self) -> Dict[str, int]:
        """Host bytes by subsystem: vector stores and graphs, tag and
        numeric structures, the text engine, the key interner. A device
        mirror is not host memory and is not counted."""
        pools = {"vector": 0, "tag": 0, "numeric": 0, "text": 0,
                 "interner": 0}
        with self._lock:
            for a in self.attributes.values():
                if a.kind in ("HNSW", "FLAT"):
                    pools["vector"] += a.index.memory_bytes()
                elif a.kind == "TAG":
                    pools["tag"] += a.index.memory_bytes()
                elif a.kind == "NUMERIC":
                    pools["numeric"] += a.index.memory_bytes()
            if self.text_engine is not None:
                pools["text"] = self.text_engine.bytes_used()
            pools["interner"] = self.interner.memory_bytes()
        return pools

    def stats(self) -> Dict[str, object]:
        with self._lock:
            return {
                "name": self.name,
                "on": self.on,
                "prefixes": list(self.prefixes),
                "num_docs": self.interner.count,
                "num_attributes": len(self.attributes),
                "doc_capacity": self.doc_capacity(),
                "mutation_epoch": self.mutation_epoch,
                "backfill_in_progress": self.backfill_in_progress,
                "attributes": {
                    alias: {"type": a.kind, "identifier": a.identifier,
                            "tracked": a.index.count(),
                            "memory": a.index.memory_bytes()}
                    for alias, a in self.attributes.items()
                },
            }


def schema_from_reference(state: Mapping[str, object],
                          device: Optional[torch.device] = None
                          ) -> IndexSchema:
    """A schema over the JAX package's exported host state, under its doc ids.

    ``state`` holds plain values: ``name``, ``prefixes``, ``on``,
    ``text_options``, ``keys_by_doc`` (the interner's key -> doc map),
    ``interner_capacity``, ``documents`` (key -> raw fields) and
    ``attributes``, a list of dicts with ``alias``, ``identifier``, ``kind``
    and the kind's options (TAG: ``separator``, ``case_sensitive``; TEXT:
    ``no_stem``, ``with_suffix_trie``, ``weight``; FLAT and HNSW: the
    ``arrays`` that ``FlatVectorIndex.from_reference`` and
    ``HnswVectorIndex.from_reference`` take). Vector rows and HNSW graphs
    are copied verbatim; tag, numeric and text values are replayed from each
    key's fields under the key's own doc id, so masks and KNN ids compare
    bit for bit with the JAX package's."""
    schema = IndexSchema(str(state["name"]), prefixes=state["prefixes"],
                         on=str(state["on"]), device=device)
    schema.text_options = state.get("text_options")
    flat, hnsw = [], []
    for a in state["attributes"]:
        alias, ident, kind = a["alias"], a["identifier"], a["kind"]
        if kind == "TAG":
            schema.add_tag_attribute(alias, ident, separator=a["separator"],
                                     case_sensitive=a["case_sensitive"])
        elif kind == "NUMERIC":
            schema.add_numeric_attribute(alias, ident)
        elif kind == "TEXT":
            schema.add_text_attribute(
                alias, ident, no_stem=a["no_stem"],
                with_suffix_trie=a["with_suffix_trie"], weight=a["weight"])
        elif kind == "FLAT":
            arr = a["arrays"]
            attr = schema.add_vector_attribute(
                alias, ident, algorithm="FLAT",
                dim=np.asarray(arr["vectors"]).shape[1],
                metric=str(arr["metric"]))
            attr.index.store = store_from_reference(
                np.asarray(arr["vectors"]), arr["norms_sq"],
                arr["magnitudes"], arr["present"], metric=str(arr["metric"]),
                block=int(arr["block"]), device=schema.device)
            flat.append(attr.index)
        elif kind == "HNSW":
            arr = a["arrays"]
            attr = schema.add_vector_attribute(
                alias, ident, algorithm="HNSW",
                dim=np.asarray(arr["vectors"]).shape[1],
                metric=str(arr["metric"]), m=int(arr["m"]),
                ef_construction=int(arr["ef_construction"]),
                ef_runtime=int(arr["ef_runtime"]))
            attr.index.adopt_reference(arr)
            hnsw.append(attr.index)
        else:
            raise _not_ported(kind, "indexes/")
    mapping = dict(state["keys_by_doc"])
    schema.interner.restore(mapping, capacity=int(state["interner_capacity"]))
    for index in flat:
        present = index.store.present
        index._tracked = {k: d for k, d in mapping.items()
                          if d < len(present) and present[d]}
    for index in hnsw:
        index.track_reference_keys(mapping)
    for key, fields in state["documents"].items():
        schema._documents[key] = dict(fields)
        if key not in mapping:
            continue  # dropped as invalid, or indexes nothing
        for attr in schema.attributes.values():
            if attr.kind in ("HNSW", "FLAT"):
                continue
            val = schema.data_type.fetch(fields, attr.identifier)
            if val is not None:
                attr.index.add_record(key, val)
    return schema
