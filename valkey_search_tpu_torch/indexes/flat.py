"""Flat (brute-force) vector index on a torch device mirror.

Counterpart of valkey_search_tpu/indexes/flat.py. ``search_batch`` routes a
query batch the way the JAX package does:

- an unfiltered batch over an index of ``search.ivf-threshold`` rows or more
  (3,000,000 by default; 0 disables): the IVF mirror (``ivf_mirror``,
  ``ops/ivf.py``), rescored in fp32, with the rows written since its build
  merged in exactly; a filtered batch takes the scan, since block probing
  cannot see the filter;
- ``search.topk-mode approx`` with a bf16 or int8 mirror and a corpus the
  fused scan serves (``ops.topk.use_fused_scan``): ``flat_topk_fused``, i.e.
  the hand-written coarse scan K1 (int8) or K2 (bf16), an exact survivor
  top-k and the fp32 rescore; unfiltered on the card at up to 128 queries,
  a CUDA graph of it captured once per shape and snapshot and replayed
  (ops/fused_graphs.py);
- ``approx`` with a bf16 mirror otherwise: ``flat_topk_two_stage``;
- else the blocked exact scan ``flat_topk``.

Each call for a traced request (runtime/metrics.py ``CTX.rid``) is one
traced launch: it mints a launch id and records
``flat.search_batch`` (its query rows and k), ``flat.prepare`` (the queries
copied, normalised and uploaded, the snapshot and the options read) and
``flat.sync`` (the host blocked on the device's results) into
runtime/metrics.py's ``TRACE``; ``ops/`` records the launch's inner spans
(a replayed graph ``topk.replay`` alone).
"""

from __future__ import annotations

from typing import List, Mapping, Optional, Tuple

import numpy as np
import torch

from valkey_search_tpu_torch.runtime import config
from valkey_search_tpu_torch.runtime.metrics import (
    CTX,
    SPAN,
    STATS,
    TRACE,
    clock,
)
from valkey_search_tpu_torch.indexes.vector_base import (
    VectorIndexBase,
    store_from_reference,
)
from valkey_search_tpu_torch.ops import fused_graphs
from valkey_search_tpu_torch.ops import topk as topk_ops


class FlatVectorIndex(VectorIndexBase):
    kind = "FLAT"

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._graphs = fused_graphs.FusedGraphs()

    @classmethod
    def from_reference(
        cls,
        arrays: Mapping[str, object],
        keys_by_doc: Mapping[str, int],
        device: Optional[torch.device] = None,
    ) -> "FlatVectorIndex":
        """An index over the JAX package's state: ``arrays`` holds its
        HostVectorStore's ``vectors``, ``norms_sq``, ``magnitudes`` and
        ``present`` plus ``metric`` and ``block``; ``keys_by_doc`` is its
        interner's key -> doc map."""
        vectors = np.asarray(arrays["vectors"])
        index = cls(dim=vectors.shape[1], metric=str(arrays["metric"]),
                    block_size=int(arrays["block"]), device=device)
        index.store = store_from_reference(
            vectors, arrays["norms_sq"], arrays["magnitudes"],
            arrays["present"], metric=index.metric, block=int(arrays["block"]),
            device=device,
        )
        mapping = dict(keys_by_doc)
        index.interner.restore(mapping, capacity=index.store.capacity)
        index._tracked = mapping
        return index

    def search_batch(
        self,
        queries: np.ndarray,
        k: int,
        filter_mask: Optional[torch.Tensor] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """k-NN for a query batch [B, d] -> (dists [B, k], doc ids [B, k]).

        ``filter_mask``: optional bool tensor [n] (or [B, n]) of allowed
        docs on the store's device. Predicate masks span the schema's whole
        doc-id space, which can outgrow the store (docs without this
        vector field); the mask is cut or padded with False to the store's
        capacity, since rows past it hold no vector and are never answers.
        (The JAX package passes such a mask on and fails to broadcast.)"""
        # a traced request's launch: it mints the launch id
        launch = TRACE.new_id() if CTX.rid else 0
        t0 = clock() if launch else 0
        CTX.launch = launch
        try:
            out_d, out_i, t_sync = self._launch(queries, k, filter_mask, t0)
        finally:
            CTX.launch = 0
        STATS.incr("flat_searches", out_d.shape[0])
        if launch:
            t1 = clock()
            rid = CTX.rid
            TRACE.record(SPAN["flat.sync"], t_sync, t1, rid, launch)
            TRACE.record(SPAN["flat.search_batch"], t0, t1, rid, launch,
                         out_d.shape[0], k)
            CTX.last_launch = launch
        return out_d, out_i

    def _launch(
        self,
        queries: np.ndarray,
        k: int,
        filter_mask: Optional[torch.Tensor],
        t0: int,
    ) -> Tuple[np.ndarray, np.ndarray, int]:
        """``search_batch``'s work: (dists, ids, the clock when the host
        began to wait for them, 0 untraced); records ``flat.prepare`` from
        ``t0`` when it is not 0. An unfiltered fused launch of up to
        ``GRAPH_MAX_B`` queries on the card replays its CUDA graph
        (ops/fused_graphs.py)."""
        # a copy: query blobs arrive as read-only buffers
        queries = np.array(np.atleast_2d(queries), np.float32, order="C")
        if queries.shape[1] != self.dim:
            raise ValueError(
                f"query dim {queries.shape[1]} != index dim {self.dim}")
        if self.metric == "cosine":
            mags = np.linalg.norm(queries, axis=1, keepdims=True)
            queries = queries / np.maximum(mags, 1e-30)
        store = self.store
        snap, epoch = store.published()
        mode = str(config.get("search.topk-mode"))
        block_rows = int(config.get("search.flat-block-size"))
        corpus = snap["vectors"]
        b = queries.shape[0]
        if filter_mask is None:
            mirror = self.ivf_mirror()
            if mirror is not None:
                q = self._prepared(queries, t0)
                d, i = self._ivf_search(mirror, q, k, corpus,
                                        snap["invalid"])
                STATS.incr("ivf_served_searches", b)
                return _fetched(d, i)
        else:
            filter_mask = _fit_mask(filter_mask, corpus.shape[0])
        common = dict(k=k, metric=self.metric, corpus_sq=snap["norms_sq"],
                      invalid=snap["invalid"], filter_mask=filter_mask)
        if (
            mode == "approx"
            and ("vectors_lp" in snap or "vectors_i8" in snap)
            and topk_ops.use_fused_scan(corpus.shape[0], filter_mask, corpus)
        ):
            fused = dict(
                corpus_lp=snap.get("vectors_lp"),
                corpus_i8=snap.get("vectors_i8"),
                i8_scale=snap.get("i8_scale"),
                block_rows=max(block_rows, corpus.shape[0]),
                span=int(config.get("search.scan-span")) or None,
                coarse_factor=(int(config.get("search.scan-coarse-factor"))
                               or None),
                **common,
            )
            if fused_graphs.takes_graph(b, corpus.device,
                                        filter_mask is not None):
                plan = topk_ops.fused_plan(
                    b, corpus, fused["corpus_lp"], fused["corpus_i8"],
                    fused["block_rows"], fused["coarse_factor"],
                    fused["span"])
                if t0:
                    TRACE.record(SPAN["flat.prepare"], t0, clock(), CTX.rid,
                                 CTX.launch)
                    t0 = 0  # recorded: not again if the launch runs eagerly
                out = self._graphs.search(
                    store, epoch, fused_graphs.graph_key(b, k, self.metric,
                                                         plan),
                    queries, corpus.device,
                    lambda q: topk_ops.flat_topk_fused(q, corpus, plan=plan,
                                                       **fused))
                if out is not None:
                    return out
            q = self._prepared(queries, t0)
            return _fetched(*topk_ops.flat_topk_fused(q, corpus, **fused))
        q = self._prepared(queries, t0)
        if mode == "approx" and "vectors_lp" in snap:
            d, i = topk_ops.flat_topk_two_stage(
                q, corpus, snap["vectors_lp"], block_rows=block_rows,
                **common,
            )
        else:
            d, i = topk_ops.flat_topk(q, corpus, block_rows=block_rows,
                                      mode=mode, **common)
        return _fetched(d, i)

    def _prepared(self, queries: np.ndarray, t0: int) -> torch.Tensor:
        """The queries uploaded; ``flat.prepare`` recorded from ``t0`` when
        it is not 0."""
        q = torch.from_numpy(queries).to(self.store.device)
        if t0:
            TRACE.record(SPAN["flat.prepare"], t0, clock(), CTX.rid,
                         CTX.launch)
        return q

    def search(
        self,
        query: np.ndarray,
        k: int,
        filter_mask: Optional[torch.Tensor] = None,
    ) -> List[Tuple[str, float]]:
        """Single-query convenience wrapper -> [(key, distance)] ascending."""
        d, i = self.search_batch(np.atleast_2d(query), k,
                                 filter_mask=filter_mask)
        return self.neighbors_to_keys(d[0], i[0])


def _fetched(d: torch.Tensor,
             i: torch.Tensor) -> Tuple[np.ndarray, np.ndarray, int]:
    """A launch's results copied to the host, with the clock when the host
    began to wait for them (0 outside a traced launch)."""
    t_sync = clock() if CTX.launch else 0
    return d.cpu().numpy(), i.cpu().numpy(), t_sync


def _fit_mask(mask: torch.Tensor, cap: int) -> torch.Tensor:
    """``mask`` [..., n] cut or False-padded to [..., cap]."""
    n = mask.shape[-1]
    if n > cap:
        return mask[..., :cap]
    if n < cap:
        return torch.nn.functional.pad(mask, (0, cap - n), value=False)
    return mask
