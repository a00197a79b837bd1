"""Search executor: parsed query -> device scan -> neighbors.

Counterpart of valkey_search_tpu/query/search.py (reference
src/query/search.{h,cc}) for FLAT and HNSW vector attributes. An
unfiltered KNN goes through the query batcher (the port's copy of the JAX
package's), so concurrent searches coalesce into one ``search_batch``
launch; for HNSW the batch signature carries ``ef`` (EF_RUNTIME). A
filtered KNN is one launch of its own over the predicate's device mask
(TAG, NUMERIC and TEXT leaves under And/Or/Negate): a FLAT index folds the
mask into its scan; an HNSW index scans the qualified rows exactly
(``exact_search_batch``) when the planner pre-filters, and walks the graph
with the mask inline otherwise. A query without KNN resolves its predicate
on the host.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from valkey_search_tpu_torch.query import batcher, planner
from valkey_search_tpu_torch.runtime import config
from valkey_search_tpu_torch.runtime.metrics import (
    CTX,
    SPAN,
    STATS,
    TRACE,
    clock,
)
from valkey_search_tpu_torch.utils import cancel
from valkey_search_tpu_torch.indexes.flat import FlatVectorIndex
from valkey_search_tpu_torch.indexes.hnsw import HnswVectorIndex
from valkey_search_tpu_torch.query import parser as qparser
from valkey_search_tpu_torch.query import predicate as P


class QueryError(ValueError):
    pass


@dataclasses.dataclass
class SearchParameters:
    """Parsed FT.SEARCH request (reference query::SearchParameters)."""

    index_name: str
    query: str
    params: Dict[str, object] = dataclasses.field(default_factory=dict)
    limit_offset: int = 0
    limit_num: int = 10
    no_content: bool = False
    return_fields: Optional[List[Tuple[str, str]]] = None  # (field, as_name)
    timeout_ms: Optional[int] = None
    sortby: Optional[str] = None
    sortby_desc: bool = False
    withsortkeys: bool = False
    ef_runtime: Optional[int] = None
    local_only: bool = False
    # columnar consumers (FT.AGGREGATE's index-columnar GROUPBY) take the
    # doc-id ndarray instead of materialized Neighbor rows
    docs_only: bool = False
    # set once the query is parsed: it has a KNN clause (INFO's vector and
    # non-vector latencies)
    vector: bool = False


class Neighbor:
    """Result row (key, distance, doc)."""

    __slots__ = ("key", "distance", "doc")

    def __init__(self, key, distance=None, doc=-1):
        self.key = key
        self.distance = distance  # None for non-vector queries
        self.doc = doc

    def __repr__(self):
        return f"Neighbor({self.key!r}, {self.distance}, {self.doc})"


@dataclasses.dataclass
class SearchResponse:
    total: int
    neighbors: List[Neighbor]
    score_field: Optional[str] = None  # e.g. "__vec_score"
    predicate: Optional[P.Predicate] = None
    knn: Optional[qparser.KnnClause] = None
    # schema.mutation_epoch when the search began: content resolution skips
    # per-row re-verification while it is unchanged
    epoch: int = -1
    # docs_only result: ascending doc-id ndarray instead of neighbors
    # (materialize_neighbors() converts on fallback)
    doc_array: Optional[np.ndarray] = None


def execute_search(schema, sp: SearchParameters, token=None) -> SearchResponse:
    """Run one search against a schema's published snapshots."""
    # epoch BEFORE any index read: a mutation landing mid-query must fail
    # the content-resolution fast path
    epoch0 = schema.mutation_epoch
    if token is None:
        token = cancel.from_timeout_ms(sp.timeout_ms)
    token.check()
    rid = CTX.rid
    t0 = clock() if rid else 0
    pred, knn = qparser.parse_query(sp.query, sp.params)
    if rid:
        TRACE.record(SPAN["query.parse"], t0, clock(), rid)
    sp.vector = knn is not None
    ctx = P.EvalContext(schema)
    if knn is not None:
        resp = _search_vector(schema, ctx, pred, knn, sp)
    else:
        resp = _search_non_vector(schema, ctx, pred, sp, token)
    resp.predicate = pred
    resp.knn = knn
    resp.epoch = epoch0
    return resp


def _search_vector(schema, ctx, pred, knn, sp) -> SearchResponse:
    attr = schema.attribute(knn.field)
    index = attr.index
    if not isinstance(index, (HnswVectorIndex, FlatVectorIndex)):
        raise QueryError(f"@{knn.field} is not a VECTOR attribute")
    qvec = np.frombuffer(knn.vector, dtype="<f4")
    if qvec.shape[0] != index.dim:
        raise QueryError(
            f"query vector has {qvec.shape[0]} dims, @{knn.field} expects "
            f"{index.dim}"
        )
    ef = sp.ef_runtime or knn.ef_runtime
    hnsw = isinstance(index, HnswVectorIndex)
    score_field = knn.score_as or f"__{knn.field}_score"
    if isinstance(pred, P.MatchAll):
        # concurrent unfiltered searches coalesce into one launch
        d_row, doc_row = batcher.submit(index, qvec, knn.k,
                                        ef if hnsw else None).result()
        d, docs = d_row[None], doc_row[None]
        STATS.incr("vector_searches_unfiltered")
    else:
        rid = CTX.rid
        t0 = clock() if rid else 0
        qualified = pred.estimate(ctx)
        mask = pred.device_mask(ctx)
        if rid:
            TRACE.record(SPAN["query.mask"], t0, clock(), rid,
                         arg=int(qualified))
        # a FLAT index always pre-filters (planner.cc:26-28): its scan scores
        # every row anyway, with the mask folded into the bias
        if planner.use_prefiltering(qualified, index):
            if hnsw:  # exact scoring over the qualified set (search.cc:456)
                d, docs = index.exact_search_batch(qvec[None], knn.k, mask)
            else:
                d, docs = index.search_batch(qvec[None], knn.k,
                                             filter_mask=mask)
            STATS.incr("vector_searches_prefiltered")
        else:
            d, docs = index.search_batch(qvec[None], knn.k, ef=ef,
                                         filter_mask=mask)
            STATS.incr("vector_searches_inline_filtered")

    neighbors = []
    for dist, doc in zip(d[0], docs[0]):
        if doc < 0 or not np.isfinite(dist):
            continue
        key = schema.interner.key_of(int(doc))
        if key is not None:
            neighbors.append(Neighbor(key, float(dist), int(doc)))
    return SearchResponse(
        total=len(neighbors), neighbors=neighbors, score_field=score_field
    )


def _search_non_vector(schema, ctx, pred, sp, token=None) -> SearchResponse:
    """Host-side predicate resolution, capped by
    search.max-non-vector-search-results-fetched (and LIMIT x the buffer
    multiplier without SORTBY)."""
    cap_results = int(config.get("search.max-non-vector-search-results-fetched"))
    if sp.sortby is None:
        mult = max(1, int(config.get("search.search-result-buffer-multiplier")))
        cap_results = min(cap_results, (sp.limit_offset + sp.limit_num) * mult)
    ids = pred.host_ids(ctx)
    if isinstance(ids, np.ndarray):
        arr = ids.astype(np.int64, copy=False)
    else:
        arr = np.fromiter(ids, np.int64, len(ids))
    total = int(arr.size)
    if cap_results < total:
        arr = np.partition(arr, cap_results - 1)[:cap_results]
    arr = np.sort(arr)
    if token is not None:
        token.check()
    STATS.incr("non_vector_searches")
    if sp.docs_only:
        return SearchResponse(total=total, neighbors=[], doc_array=arr)
    resp = SearchResponse(total=total, neighbors=[], doc_array=arr)
    materialize_neighbors(schema, resp)
    return resp


def materialize_neighbors(schema, resp: SearchResponse) -> None:
    """Build the Neighbor rows of a docs_only response whose consumer could
    not stay columnar."""
    if resp.doc_array is None:
        return
    docs = resp.doc_array.tolist()
    keys = schema.interner.keys_of(docs)
    resp.neighbors = [
        Neighbor(key, None, doc)
        for key, doc in zip(keys, docs) if key is not None
    ]
    resp.doc_array = None
