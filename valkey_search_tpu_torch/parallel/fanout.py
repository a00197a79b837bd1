"""ShardedHnswIndex: the cluster-mode HNSW index, a fanout without RPCs.

Counterpart of valkey_search_tpu/parallel/fanout.py. The coordinator's
scatter/gather (reference src/query/fanout.cc PerformSearchFanoutAsync
:312, one SearchIndexPartition RPC a shard, the merge tracker :69-222)
becomes S HNSW subgraphs, one a mesh position, each walked on its device,
and one top-k merge (parallel/mesh.py). Keys go to shards by hash (the
reference routes by hash slot, vmsdk/src/cluster_map.h); ``zlib.crc32``
sends each key to the shard the JAX package sends it to. The per-shard
store epochs take the place of the index fingerprint check
(coordinator/server.h:60-65): an epoch that moved while a search ran is
retried on a fresh publish, or accepted under
``search.prefer-partial-results``.

The shards are separate graphs, padded to equal shapes
(``_normalize_graphs``) so that a result id ``shard * node_cap + node``
equals the JAX package's; each walk is its own call, so they are not
stacked into one tensor. Like the JAX package's, this index is not wired
into FT.CREATE.
"""

from __future__ import annotations

import threading
import zlib
from typing import List, Optional, Tuple

import numpy as np
import torch

from valkey_search_tpu_torch.indexes.base import IndexBase, RecordResult
from valkey_search_tpu_torch.indexes.hnsw import HnswVectorIndex
from valkey_search_tpu_torch.ops import hnsw_search as hs_ops
from valkey_search_tpu_torch.parallel import mesh as pm
from valkey_search_tpu_torch.runtime import config
from valkey_search_tpu_torch.runtime.metrics import STATS
from valkey_search_tpu_torch.utils.interning import KeyInterner


def _pad_rows(t: torch.Tensor, rows: int, value) -> torch.Tensor:
    """``t`` with ``rows - len(t)`` rows of ``value`` appended."""
    pad = rows - t.shape[0]
    if pad <= 0:
        return t
    return torch.cat([t, torch.full((pad,) + tuple(t.shape[1:]), value,
                                    dtype=t.dtype, device=t.device)])


def _normalize_graphs(
    graphs: List[hs_ops.HnswDeviceGraph], m: int
) -> List[hs_ops.HnswDeviceGraph]:
    """Pad per-shard graphs to identical shapes: the same node capacity,
    level count and per-level link-table rows (padding nodes are deleted
    and unlinked, padding levels empty)."""
    cap = max(g.vectors.shape[0] for g in graphs)
    max_lv = max(len(g.upper_id2row) for g in graphs)
    lvl_rows = [
        max(
            (g.upper_links[li].shape[0] if li < len(g.upper_links) else 8)
            for g in graphs
        )
        for li in range(max_lv)
    ]

    out = []
    for g in graphs:
        dev = g.vectors.device
        id2rows, links = [], []
        for li in range(max_lv):
            if li < len(g.upper_id2row):
                idr = _pad_rows(g.upper_id2row[li], cap, -1)
                lnk = _pad_rows(g.upper_links[li], lvl_rows[li], -1)
            else:
                idr = torch.full((cap,), -1, dtype=torch.int32, device=dev)
                lnk = torch.full((lvl_rows[li], m), -1, dtype=torch.int32,
                                 device=dev)
            id2rows.append(idr)
            links.append(lnk)
        out.append(
            hs_ops.HnswDeviceGraph(
                vectors=_pad_rows(g.vectors, cap, 0.0),
                links0=_pad_rows(g.links0, cap, -1),
                deleted=_pad_rows(g.deleted, cap, True),
                entry=g.entry,
                upper_id2row=tuple(id2rows),
                upper_links=tuple(links),
                node_doc=_pad_rows(g.node_doc, cap, -1),
            )
        )
    return out


class ShardedHnswIndex(IndexBase):
    """HNSW corpus sharded over a device mesh (the cluster-mode index)."""

    kind = "HNSW"
    mutation_weight = 10.0

    def __init__(
        self,
        dim: int,
        metric: str = "l2",
        m: int = 16,
        ef_construction: int = 200,
        ef_runtime: Optional[int] = None,
        n_shards: Optional[int] = None,
        mesh: Optional[pm.Mesh] = None,
        interner: Optional[KeyInterner] = None,
        seed: int = 0x5EED,
    ):
        self.dim = dim
        self.metric = metric
        self.m = m
        self.ef_runtime = ef_runtime or int(
            config.get("search.default-ef-runtime"))
        self._owns_interner = interner is None
        self.interner = interner if interner is not None else KeyInterner()
        self.mesh = mesh if mesh is not None else pm.make_mesh(n_shards)
        self.n_shards = self.mesh.shape[pm.SHARD_AXIS]
        # The shards share the schema interner, so predicate masks stay in
        # the schema doc-id space on every shard; shard s lies on the
        # mesh's s-th device.
        self.shards = [
            HnswVectorIndex(
                dim, metric, m, ef_construction, ef_runtime,
                interner=self.interner, seed=seed + s, device=dev,
            )
            for s, dev in enumerate(pm.shard_devices(self.mesh))
        ]
        self._stacked = None
        self._lock = threading.RLock()

    # -- key routing (hash slot analog) -------------------------------------
    def shard_of(self, key: str) -> int:
        return zlib.crc32(key.encode()) % self.n_shards

    # -- IndexBase -----------------------------------------------------------
    def add_record(self, key: str, value) -> RecordResult:
        r = self.shards[self.shard_of(key)].add_record(key, value)
        if r is not RecordResult.INVALID_DATA:
            with self._lock:
                self._stacked = None
        return r

    def modify_record(self, key: str, value) -> RecordResult:
        return self.add_record(key, value)

    def remove_record(self, key: str) -> RecordResult:
        r = self.shards[self.shard_of(key)].remove_record(key)
        if r is RecordResult.REMOVED:
            if self._owns_interner:
                # the shards share this interner and never release it;
                # without this the doc-id space grows under add/remove churn
                self.interner.release(key)
            with self._lock:
                self._stacked = None
        return r

    def tracked_keys(self):
        out = set()
        for s in self.shards:
            out |= s.tracked_keys()
        return out

    def count(self) -> int:
        return sum(s.count() for s in self.shards)

    def doc_of(self, key: str):
        return self.shards[self.shard_of(key)].doc_of(key)

    # -- snapshot ------------------------------------------------------------
    def _publish(self):
        """(graphs, versions [S] int32, node_docs [S, cap] host) of the
        current shards, reused until a write."""
        with self._lock:
            if self._stacked is not None:
                return self._stacked
            graphs = _normalize_graphs(
                [s.device_graph() for s in self.shards], self.m
            )
            versions = torch.tensor(
                [s.store.epoch for s in self.shards], dtype=torch.int32)
            node_docs = np.stack([g.node_doc.cpu().numpy() for g in graphs])
            self._stacked = (graphs, versions, node_docs)
            STATS.incr("sharded_graph_publishes")
            return self._stacked

    # -- search --------------------------------------------------------------
    def search_batch(
        self,
        queries: np.ndarray,
        k: int,
        ef: Optional[int] = None,
        filter_mask: Optional[torch.Tensor] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Fanout search -> (dists [B, k], doc ids [B, k]) on the host.
        ``filter_mask``: optional bool [doc_cap] in doc-id space."""
        if self.count() == 0:
            b = np.atleast_2d(queries).shape[0]
            return (
                np.full((b, k), np.inf, np.float32),
                np.full((b, k), -1, np.int32),
            )
        queries = np.ascontiguousarray(np.atleast_2d(queries), np.float32)
        if self.metric == "cosine":
            mags = np.linalg.norm(queries, axis=1, keepdims=True)
            queries = queries / np.maximum(mags, 1e-30)
        ef = max(ef or self.ef_runtime, k)
        fmasks = None
        if filter_mask is not None:
            fmasks = [torch.as_tensor(filter_mask)] * self.n_shards
        q = torch.from_numpy(queries)
        # Consistency: the shards' store epochs are independent counters, so
        # they are not compared with each other (one shard's write would
        # look like a permanent spread). Did any shard's epoch move between
        # the publish searched and now? Then retry on a fresh publish, at
        # most three times, or accept (the partial-results stance).
        for _attempt in range(3):
            graphs, versions, node_docs = self._publish()
            d, gids, _vminmax = pm.sharded_hnsw_search(
                self.mesh,
                graphs,
                q,
                k=k,
                ef=ef,
                metric=self.metric,
                filter_masks=fmasks,
                shard_versions=versions,
            )
            current = np.asarray(
                [s.store.epoch for s in self.shards], np.int32
            )
            if np.array_equal(versions.numpy(), current) or bool(
                config.get("search.prefer-partial-results")
            ):
                break
            STATS.incr("fanout_version_retries")
            with self._lock:
                self._stacked = None
        d = d.cpu().numpy()
        gids = gids.cpu().numpy()
        node_cap = graphs[0].vectors.shape[0]
        shard_idx = np.maximum(gids, 0) // node_cap
        node_idx = np.maximum(gids, 0) % node_cap
        docs = np.where(
            gids >= 0, node_docs[shard_idx, node_idx], -1
        ).astype(np.int32)
        STATS.incr("fanout_searches", queries.shape[0])
        return d, docs

    def exact_search_batch(
        self,
        queries: np.ndarray,
        k: int,
        filter_mask: Optional[torch.Tensor] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """The pre-filtered exact path: each shard's masked scan, merged on
        the host by a stable sort (ties to the lower shard)."""
        per = [
            s.exact_search_batch(
                queries, k,
                None if filter_mask is None
                else torch.as_tensor(filter_mask).to(s.store.device))
            for s in self.shards
        ]
        d = np.concatenate([p[0] for p in per], axis=1)
        docs = np.concatenate([p[1] for p in per], axis=1)
        order = np.argsort(d, axis=1, kind="stable")[:, :k]
        return np.take_along_axis(d, order, 1), np.take_along_axis(docs, order, 1)

    def neighbors_to_keys(self, dists, docs):
        out = []
        for dd, doc in zip(np.asarray(dists), np.asarray(docs)):
            if doc < 0 or not np.isfinite(dd):
                continue
            key = self.interner.key_of(int(doc))
            if key is not None:
                out.append((key, float(dd)))
        return out
