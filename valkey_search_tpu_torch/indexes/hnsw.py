"""HNSW vector index: native host construction + batched search on a torch device.

Counterpart of valkey_search_tpu/indexes/hnsw.py (reference
src/indexes/vector_hnsw.{h,cc} over modified hnswlib):

- construction (addPoint's greedy descent, ef_construction beam and
  neighbour pruning) runs in the native builder (``native_lib.HnswBuilder``),
  host-side like the reference; ``bulk_load`` can take its candidate pools
  from exact device scans instead (``ops/hnsw_build.py``);
- search runs on the store's device: under ``search.hnsw-scan-threshold``
  rows, the exact scan over the index's vectors (``exact_search_batch``,
  the fused K1/K2 scan from 131,072 rows of capacity); above it, the batched
  graph walk (``ops/hnsw_search.py``) over a published snapshot of the graph;
- an update tombstones the old node and inserts a fresh one (node <-> doc
  indirection, as hnswlib's internal-id <-> label maps); tombstones are
  traversed but never returned (markDelete semantics);
- capacity doubles (``growth="pow2"``), as in the JAX package, so both
  packages lay out and scan the same capacity.

``search.hnsw-build-mode auto`` builds on the device when the store lies on
a CUDA device, on the host otherwise. A failed device build raises; it never
falls back to the host build. Over ``search.ivf-threshold`` live keys an
unfiltered ``exact_search_batch`` goes to the IVF mirror of the store's rows
(nodes), as in the JAX package.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from valkey_search_tpu_torch.indexes.base import RecordResult
from valkey_search_tpu_torch.indexes.vector_base import (
    VectorIndexBase,
    _scatter_rows,
    parse_vector,
    store_from_reference,
)
from valkey_search_tpu_torch.native_lib import HnswBuilder
from valkey_search_tpu_torch.ops import hnsw_build as hb
from valkey_search_tpu_torch.ops import hnsw_search as hs_ops
from valkey_search_tpu_torch.ops import topk as topk_ops
from valkey_search_tpu_torch.runtime import config
from valkey_search_tpu_torch.runtime.metrics import STATS
from valkey_search_tpu_torch.utils.interning import KeyInterner


def _build_threads() -> int:
    threads = int(config.get("search.native-build-threads"))
    return max(1, threads or os.cpu_count() or 1)


class HnswVectorIndex(VectorIndexBase):
    kind = "HNSW"

    def __init__(
        self,
        dim: int,
        metric: str = "l2",
        m: int = 16,
        ef_construction: int = 200,
        ef_runtime: Optional[int] = None,
        interner: Optional[KeyInterner] = None,
        seed: int = 0x5EED,
        device: Optional[torch.device] = None,
    ):
        super().__init__(
            dim, metric, interner,
            block_size=int(config.get("search.hnsw-block-size")),
            device=device, growth="pow2",
        )
        self.m = m
        self.ef_construction = ef_construction
        self.ef_runtime = ef_runtime or int(
            config.get("search.default-ef-runtime"))
        self.seed = seed
        try:
            self.builder = HnswBuilder(dim, metric=metric, m=m,
                                       ef_construction=ef_construction,
                                       seed=seed)
        except Exception:
            STATS.incr("hnsw_create_exceptions")
            raise
        # node-space bookkeeping (store rows are NODES for this index)
        self._doc_node: Dict[int, int] = {}  # doc id -> live node
        self._node_doc = np.full(self.store.capacity, -1, np.int32)
        self._deleted = np.zeros(self.store.capacity, bool)
        self._graph_dirty = True
        self._device_graph: Optional[hs_ops.HnswDeviceGraph] = None
        self._aos_tables: Optional[hs_ops.HnswAosTables] = None
        self._aos_for_epoch = None
        self._graph_lock = threading.Lock()
        # seconds per stage of the last device bulk build
        self.build_seconds: Dict[str, float] = {}

    @classmethod
    def from_reference(
        cls,
        arrays: Mapping[str, object],
        keys_by_doc: Mapping[str, int],
        device: Optional[torch.device] = None,
    ) -> "HnswVectorIndex":
        """An index over the JAX package's HNSW state. ``arrays`` holds its
        HostVectorStore's ``vectors``, ``norms_sq``, ``magnitudes``,
        ``present``, ``metric`` and ``block``; its ``m``,
        ``ef_construction`` and ``ef_runtime``; ``node_doc``, ``deleted``
        and ``doc_node`` (doc -> live node); and ``graph``, its builder's
        ``export_graph()``, imported into this index's builder, so both
        packages walk the same graph. ``keys_by_doc`` is its interner's
        key -> doc map."""
        index = cls(dim=np.asarray(arrays["vectors"]).shape[1],
                    metric=str(arrays["metric"]), m=int(arrays["m"]),
                    ef_construction=int(arrays["ef_construction"]),
                    ef_runtime=int(arrays["ef_runtime"]), device=device)
        index.adopt_reference(arrays)
        mapping = dict(keys_by_doc)
        cap = max([index.store.capacity] + [d + 1 for d in mapping.values()])
        index.interner.restore(mapping, capacity=cap)
        index.track_reference_keys(mapping)
        return index

    def adopt_reference(self, arrays: Mapping[str, object]) -> None:
        """Take the store rows and graph state of ``from_reference``'s
        ``arrays`` (the keys are left to ``track_reference_keys``)."""
        self.store = store_from_reference(
            np.asarray(arrays["vectors"]), arrays["norms_sq"],
            arrays["magnitudes"], arrays["present"], metric=self.metric,
            block=int(arrays["block"]), device=self.store.device,
            growth="pow2",
        )
        self.builder.import_graph(self.store.vectors, arrays["graph"])
        self._node_doc = np.array(arrays["node_doc"], np.int32)
        self._deleted = np.array(arrays["deleted"], bool)
        self._doc_node = {int(d): int(n)
                          for d, n in dict(arrays["doc_node"]).items()}
        self._graph_dirty = True
        self._device_graph = None

    def track_reference_keys(self, keys_by_doc: Mapping[str, int]) -> None:
        """Track the keys whose doc has a live node."""
        self._tracked = {k: d for k, d in keys_by_doc.items()
                         if d in self._doc_node}

    def memory_bytes(self) -> int:
        return (super().memory_bytes() + self._node_doc.nbytes
                + self.builder.memory_bytes())  # native graph

    # -- deleted-slot reclamation -------------------------------------------
    def deleted_count(self) -> int:
        with self._lock:
            return self.builder.count - len(self._doc_node)

    def reclaimable_bytes(self) -> int:
        """Bytes held by tombstoned graph slots: each keeps its vector row
        and link rows until ``vacuum()``."""
        n_del = self.deleted_count()
        if n_del <= 0 or self.builder.count == 0:
            return 0
        per_node = self.builder.memory_bytes() / max(1, self.builder.count)
        return int(n_del * (per_node + self.dim * 4))  # + store row

    def vacuum(self, force: bool = False) -> int:
        """Rebuild the graph from the live vectors, dropping tombstones.

        hnswlib reuses deleted slots in place; this index rebuilds instead
        (a multi-threaded native build), so the walk carries no tombstones
        and the device mirror republishes compactly. Without ``force`` it
        runs only past ``search.hnsw-vacuum-deleted-ratio`` (0 disables).
        Returns the reclaimed slot count."""
        with self._lock:
            total = self.builder.count
            n_del = total - len(self._doc_node)
            if total == 0 or n_del == 0:
                return 0
            ratio = float(config.get("search.hnsw-vacuum-deleted-ratio"))
            if not force and (ratio <= 0 or n_del / total < ratio):
                return 0
            pairs = sorted(self._doc_node.items(), key=lambda kv: kv[1])
            docs = np.asarray([d for d, _ in pairs], np.int64)
            nodes = np.asarray([n for _, n in pairs], np.int64)
            vecs = self.store.vectors[nodes].copy()
            if self.metric == "cosine":
                # store rows are normalized; rebuild from the originals
                vecs = vecs * self.store.magnitudes[nodes][:, None]
            self.builder = HnswBuilder(
                self.dim, metric=self.metric, m=self.m,
                ef_construction=self.ef_construction, seed=self.seed,
            )
            self.store = type(self.store)(
                self.dim, self.metric,
                int(config.get("search.hnsw-block-size")),
                self.store.device, growth="pow2",
            )
            self._doc_node = {}
            self._node_doc = np.full(self.store.capacity, -1, np.int32)
            self._deleted = np.zeros(self.store.capacity, bool)
            if len(vecs):
                new_nodes = self.builder.add_batch(vecs,
                                                   threads=_build_threads())
                self.store.ensure_capacity(int(new_nodes.max()) + 1)
                self._ensure_node_arrays()
                for row, doc, v in zip(new_nodes, docs, vecs):
                    self.store.set_row(int(row), v)
                    self._node_doc[int(row)] = int(doc)
                    self._doc_node[int(doc)] = int(row)
            self._graph_dirty = True
            self._device_graph = None
            self._aos_tables = None
            STATS.incr("hnsw_vacuums")
            STATS.incr("hnsw_slots_reclaimed", n_del)
            return n_del

    # -- record mutation (nodes, not docs, are store rows) -------------------
    def add_record(self, key: str, value) -> RecordResult:
        try:
            vec = parse_vector(value, self.dim)
        except ValueError:
            STATS.incr("vector_invalid_records")
            return RecordResult.INVALID_DATA
        try:
            return self._add_record_parsed(key, vec)
        except Exception:
            STATS.incr("hnsw_modify_exceptions" if key in self._tracked
                       else "hnsw_add_exceptions")
            raise

    def _add_record_parsed(self, key: str, vec: np.ndarray) -> RecordResult:
        with self._lock:
            doc = self.interner.intern(key)
            existed = key in self._tracked
            if existed:
                old = self._doc_node.pop(doc, None)
                if old is not None:
                    self.builder.mark_deleted(old)
                    self._deleted[old] = True
            ins = vec
            if self.metric == "cosine":
                mag = float(np.linalg.norm(vec))
                if mag > 0:
                    ins = vec / mag
            node = self.builder.add(ins)
            self.store.ensure_capacity(node + 1)
            self._ensure_node_arrays()
            self.store.set_row(node, vec)  # normalizes, records magnitude
            self._node_doc[node] = doc
            self._deleted[node] = False
            self._doc_node[doc] = node
            self._tracked[key] = doc
            self._graph_dirty = True
            STATS.incr("vector_records_modified" if existed
                       else "vector_records_added")
            return RecordResult.MODIFIED if existed else RecordResult.ADDED

    def remove_record(self, key: str) -> RecordResult:
        try:
            return self._remove_record_inner(key)
        except Exception:
            STATS.incr("hnsw_remove_exceptions")
            raise

    def _remove_record_inner(self, key: str) -> RecordResult:
        with self._lock:
            doc = self._tracked.pop(key, None)
            if doc is None:
                return RecordResult.SKIPPED
            node = self._doc_node.pop(doc, None)
            if node is not None:
                self.builder.mark_deleted(node)
                self._deleted[node] = True
            if self._owns_interner:
                self.interner.release(key)
            self._graph_dirty = True
            STATS.incr("vector_records_removed")
            return RecordResult.REMOVED

    def bulk_load(self, keys, vectors: np.ndarray) -> int:
        """Batch construction; returns the count inserted.

        ``search.hnsw-build-mode`` "device" (corpora of 2,048 rows and
        more): every insert's level-0 candidate pool is the exact nearest
        among the lower node ids, from a device scan, in place of the
        ef_construction beam. "host": the native build (``add_batch``,
        ``search.native-build-threads`` threads). "auto": "device" when the
        store lies on a CUDA device."""
        vectors = np.ascontiguousarray(vectors, np.float32)
        with self._lock:
            # replace semantics: the last occurrence of a key wins, and the
            # previous node of a tracked key is tombstoned
            last = {k: i for i, k in enumerate(keys)}
            if len(last) != len(keys):
                order = sorted(last.values())
                keys = [keys[i] for i in order]
                vectors = vectors[order]
            for k in keys:
                doc = self._tracked.get(k)
                if doc is None:
                    continue
                old = self._doc_node.pop(doc, None)
                if old is not None:
                    self.builder.mark_deleted(old)
                    self._deleted[old] = True
            ins = vectors
            if self.metric == "cosine":
                mags = np.linalg.norm(vectors, axis=1, keepdims=True)
                ins = vectors / np.maximum(mags, 1e-30)
            mode = str(config.get("search.hnsw-build-mode"))
            if mode == "auto":
                mode = "device" if self.store.device.type == "cuda" \
                    else "host"
            if mode == "device" and len(keys) >= 2048:
                if self.builder.count == 0:
                    nodes = self._bulk_build_device(ins)
                else:
                    nodes = self._add_batch_device_seeded(ins)
            else:
                nodes = self.builder.add_batch(ins, threads=_build_threads())
            self.store.ensure_capacity(int(nodes.max()) + 1)
            self._ensure_node_arrays()
            st = self.store
            st.vectors[nodes] = ins
            st.norms_sq[nodes] = (ins * ins).sum(1)
            if self.metric == "cosine":
                st.magnitudes[nodes] = np.linalg.norm(vectors, axis=1)
            st.present[nodes] = True
            st._device = None  # full upload at the next publish
            docs = np.fromiter(
                (self.interner.intern(k) for k in keys), np.int64, len(keys))
            self._node_doc[nodes] = docs
            self._deleted[nodes] = False
            for k, d, n in zip(keys, docs, nodes):
                self._tracked[k] = int(d)
                self._doc_node[int(d)] = int(n)
            self._graph_dirty = True
            STATS.incr("vector_records_added", len(keys))
            return len(keys)

    def _bulk_build_device(self, ins: np.ndarray) -> np.ndarray:
        """Device-exact candidates and the select heuristic for every node
        (``ops/hnsw_build.py``); the native side installs the links and the
        small upper hierarchy. A bulk KNN graph lacks the long-range edges
        of incremental insertion, so clustered corpora fragment into islands
        at level 0: ``bridge_components`` joins them. The seconds of each
        stage go to ``build_seconds``."""
        dev = self.store.device
        times: Dict[str, float] = {}
        levels, _ = hb.sample_levels(ins.shape[0], self.m, seed=0x5EED)
        links = hb.build_pruned_knn_links(
            ins, self.metric, m=self.m,
            k_cand=min(self.ef_construction, 64),
            batch=int(config.get("search.hnsw-build-batch")),
            device=dev, timings=times,
        )
        t0 = time.perf_counter()
        nodes = self.builder.bulk_build(ins, levels, links)
        t1 = time.perf_counter()
        times["bridge_rounds"] = hb.bridge_components(self.builder, ins,
                                                      device=dev)
        times["native_bulk_build_s"] = t1 - t0
        times["bridge_s"] = time.perf_counter() - t1
        self.build_seconds = times
        return nodes

    def _add_batch_device_seeded(self, ins: np.ndarray) -> np.ndarray:
        """Insert ``ins`` with device-computed candidate pools: the seeds of
        batch rows [s, e) are the exact nearest of each row among node ids <
        base + e (earlier rows of the batch included, so near-duplicates in
        one batch still link; the native side skips ids >= its own node),
        scored over the bf16 rows, as the JAX package does."""
        base = self.builder.count
        n = ins.shape[0]
        total = base + n
        corpus = (np.concatenate([self.store.vectors[:base], ins]) if base
                  else ins)
        cf = torch.from_numpy(np.ascontiguousarray(corpus, np.float32)).to(
            self.store.device).to(torch.bfloat16).to(torch.float32)
        metric = "ip" if self.metric == "cosine" else self.metric
        c_sq = (cf * cf).sum(1) if metric == "l2" else None
        bsz = int(config.get("search.hnsw-build-batch"))
        k_seeds = min(min(self.ef_construction, 128) + 1, total)
        out_nodes = np.empty(n, np.int32)
        for s in range(0, n, bsz):
            e = min(s + bsz, n)
            q_sq = None if c_sq is None else c_sq[base + s:base + e]
            _, ids = hb.nearest(cf[base + s:base + e], cf, k_seeds, metric,
                                q_sq, c_sq, base + e)
            out_nodes[s:e] = self.builder.add_batch_seeded(
                ins[s:e], ids.cpu().numpy())
        return out_nodes

    def _ensure_node_arrays(self) -> None:
        cap = self.store.capacity
        if self._node_doc.shape[0] < cap:
            grow = cap - self._node_doc.shape[0]
            self._node_doc = np.concatenate(
                [self._node_doc, np.full(grow, -1, np.int32)])
            self._deleted = np.concatenate(
                [self._deleted, np.zeros(grow, bool)])

    @property
    def node_count(self) -> int:
        return self.builder.count

    # -- snapshot publish ----------------------------------------------------
    def device_graph(self) -> hs_ops.HnswDeviceGraph:
        """Publish (or reuse) the device snapshot of the graph.

        Searches run against an immutable published graph; mutations set
        ``_graph_dirty`` and the next publish either scatters the changed
        level-0 rows into new tensors (up to max(1,024, cap / 5) of them)
        or exports the whole graph."""
        with self._graph_lock:
            if self._device_graph is not None and not self._graph_dirty:
                return self._device_graph
            with self._lock:
                prev = self._device_graph
                cap = self.store.capacity
                self._ensure_node_arrays()
                dirty = self.builder.dirty_count
                if (prev is not None and prev.links0.shape[0] == cap
                        and 0 < dirty <= max(1024, cap // 5)):
                    upper_dirty = self.builder.upper_dirty
                    nodes, links_rows, del_rows = self.builder.export_dirty()
                    snap = self.store.device_snapshot()
                    dev = snap["vectors"].device
                    idx = torch.from_numpy(nodes.astype(np.int64)).to(dev)
                    links0 = _scatter_rows(
                        prev.links0, idx, torch.from_numpy(links_rows).to(dev))
                    deleted = _scatter_rows(
                        prev.deleted, idx, torch.from_numpy(del_rows).to(dev))
                    node_doc = _scatter_rows(
                        prev.node_doc, idx,
                        torch.from_numpy(self._node_doc[nodes]).to(dev))
                    if upper_dirty:
                        self._device_graph = hs_ops.build_device_graph(
                            vectors=snap["vectors"], links0=links0,
                            deleted=deleted,
                            uppers=self.builder.export_uppers(),
                            entry=max(self.builder.entry, 0),
                            node_doc=node_doc, m=self.m,
                        )
                    else:
                        self._device_graph = prev._replace(
                            vectors=snap["vectors"], links0=links0,
                            deleted=deleted, node_doc=node_doc,
                        )
                    self._graph_dirty = False
                    STATS.incr("hnsw_graph_incremental_publishes")
                    return self._device_graph

                g = self.builder.export_graph()
                n = g["count"]
                links0 = np.full((cap, 2 * self.m), -1, np.int32)
                links0[:n] = g["links0"]
                deleted = np.ones(cap, bool)
                deleted[:n] = g["deleted"]
                snap = self.store.device_snapshot()
                self._device_graph = hs_ops.build_device_graph(
                    vectors=snap["vectors"], links0=links0, deleted=deleted,
                    uppers=g["uppers"], entry=max(g["entry"], 0),
                    node_doc=self._node_doc, m=self.m,
                )
                self.builder.clear_dirty()
                self._graph_dirty = False
                STATS.incr("hnsw_graph_publishes")
            return self._device_graph

    # -- search --------------------------------------------------------------
    def _prepare(self, queries: np.ndarray) -> np.ndarray:
        # a copy: query blobs arrive as read-only buffers
        queries = np.array(np.atleast_2d(queries), np.float32, order="C")
        if queries.shape[1] != self.dim:
            raise ValueError(
                f"query dim {queries.shape[1]} != index dim {self.dim}")
        if self.metric == "cosine":
            mags = np.linalg.norm(queries, axis=1, keepdims=True)
            queries = queries / np.maximum(mags, 1e-30)
        return queries

    def _docs_of(self, nodes: np.ndarray) -> np.ndarray:
        docs = np.where(nodes >= 0, self._node_doc[np.maximum(nodes, 0)], -1)
        return docs.astype(np.int32)

    def search_batch(
        self,
        queries: np.ndarray,
        k: int,
        ef: Optional[int] = None,
        filter_mask: Optional[torch.Tensor] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """ANN search [B, d] -> (dists [B, k], doc ids [B, k]).

        ``filter_mask``: optional bool tensor in doc-id space on the store's
        device: the inline filter of the walk (reference
        InlineVectorFilter, search.cc:102-133)."""
        try:
            return self._search_batch_inner(queries, k, ef, filter_mask)
        except Exception:
            STATS.incr("hnsw_search_exceptions")
            raise

    def _search_batch_inner(self, queries, k, ef, filter_mask):
        if self.builder.count == 0:
            b = np.atleast_2d(queries).shape[0]
            return (np.full((b, k), np.inf, np.float32),
                    np.full((b, k), -1, np.int32))
        # below the threshold the exact scan serves (higher QPS at recall
        # 1.0 than the walk); 0 sends every search to the walk
        scan_thresh = int(config.get("search.hnsw-scan-threshold"))
        if scan_thresh and self.builder.count <= scan_thresh:
            STATS.incr("hnsw_served_by_scan")
            return self.exact_search_batch(queries, k,
                                           filter_mask=filter_mask, ef=ef)
        queries = self._prepare(queries)
        ef = min(max(ef or self.ef_runtime, k),
                 int(config.get("search.max-ef-runtime")))
        graph = self.device_graph()
        q = torch.from_numpy(queries).to(graph.vectors.device)
        aos = None if filter_mask is not None else self._aos_mirror(graph)
        if aos is not None:
            # int8 neighbour blocks + the exact fp32 rescore
            d, ids = hs_ops.hnsw_search_batch_aos(
                graph, aos, q, k=k, ef=ef, metric=self.metric,
                seed_stride=int(
                    config.get("search.hnsw-traversal-seed-stride")),
            )
        else:
            d, ids = hs_ops.hnsw_search_batch(
                graph, q, k=k, ef=ef, metric=self.metric,
                filter_mask=filter_mask,
            )
        STATS.incr("hnsw_searches", queries.shape[0])
        return d.cpu().numpy(), self._docs_of(ids.cpu().numpy())

    def _aos_mirror(self, graph: hs_ops.HnswDeviceGraph):
        """The budget-gated AoS mirror, rebuilt per publish epoch."""
        budget = int(config.get("search.hnsw-aos-budget-bytes"))
        dp = min(int(config.get("search.hnsw-aos-project-dim")) or self.dim,
                 self.dim)
        cap, m0 = graph.links0.shape
        if budget == 0 or cap * m0 * dp > budget:
            return None
        epoch = (self.store.epoch, dp)
        if self._aos_tables is None or self._aos_for_epoch != epoch:
            self._aos_tables = hs_ops.build_aos_tables(
                graph, project_dim=dp if dp < self.dim else 0)
            self._aos_for_epoch = epoch
        return self._aos_tables

    def exact_search_batch(
        self,
        queries: np.ndarray,
        k: int,
        filter_mask: Optional[torch.Tensor] = None,
        ef: Optional[int] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Exact scored scan over this index's vectors (the pre-filter
        path; reference CalcBestMatchingPrefilteredKeys, search.cc:456).
        The doc-space mask becomes a node-space mask on the device and
        folds into the scan: ``flat_topk_fused`` (K1 under int8, K2 under
        bfloat16) from 131,072 rows of capacity, ``flat_topk_two_stage``
        or ``flat_topk`` below; ``ef`` has no effect on an exact scan.
        Unfiltered, over ``search.ivf-threshold`` live keys, the IVF mirror
        serves instead: tombstones ride ~invalid, and EF_RUNTIME, a
        candidate count, raises the probe to ceil(ef / block_rows)."""
        queries = self._prepare(queries)
        graph = self.device_graph()
        snap = self.store.device_snapshot()
        node_doc = graph.node_doc
        invalid = graph.deleted | (node_doc < 0)
        corpus = snap["vectors"]
        q = torch.from_numpy(queries).to(corpus.device)
        node_filter = None
        if filter_mask is not None:
            node_filter = hs_ops.docs_allowed(filter_mask, node_doc)
        else:
            mirror = self.ivf_mirror()
            if mirror is not None:
                d, nodes = self._ivf_search(mirror, q, k, corpus, invalid,
                                            ef=ef)
                STATS.incr("ivf_served_searches", queries.shape[0])
                return d.cpu().numpy(), self._docs_of(nodes.cpu().numpy())
        block_rows = max(self.store.capacity, 131072)
        common = dict(k=k, metric=self.metric, corpus_sq=snap["norms_sq"],
                      invalid=invalid, filter_mask=node_filter)
        approx = str(config.get("search.topk-mode")) == "approx"
        if (approx and ("vectors_lp" in snap or "vectors_i8" in snap)
                and topk_ops.use_fused_scan(corpus.shape[0], node_filter,
                                            corpus)):
            d, ids = topk_ops.flat_topk_fused(
                q, corpus, snap.get("vectors_lp"), block_rows=block_rows,
                corpus_i8=snap.get("vectors_i8"),
                i8_scale=snap.get("i8_scale"), **common)
        elif approx and "vectors_lp" in snap:
            d, ids = topk_ops.flat_topk_two_stage(
                q, corpus, snap["vectors_lp"], block_rows=block_rows,
                **common)
        else:
            d, ids = topk_ops.flat_topk(q, corpus, block_rows=block_rows,
                                        **common)
        return d.cpu().numpy(), self._docs_of(ids.cpu().numpy())

    def search(self, query: np.ndarray, k: int,
               ef: Optional[int] = None) -> List[Tuple[str, float]]:
        d, docs = self.search_batch(np.atleast_2d(query), k, ef=ef)
        return self.neighbors_to_keys(d[0], docs[0])
