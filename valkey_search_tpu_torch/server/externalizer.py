"""Vector externalizer: serve RETURN fields straight from the index.

Copied from valkey_search_tpu/server/externalizer.py.

Reference: src/vector_externalizer.{h,cc} — interned vectors are shared
back to the engine so the bytes are never stored twice, with an LRU of
denormalized vectors (kLRUCapacity=100, vector_externalizer.h:31); and
MaybeAddIndexedContent (search.cc:497) serves RETURN fields from the
indexes when possible, skipping the main-thread content fetch entirely.

Cosine indexes store L2-normalized rows plus the original magnitude
(NormalizeEmbedding); denormalization multiplies the magnitude back in
before returning the original fp32 blob.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from valkey_search_tpu_torch.runtime.metrics import STATS
from valkey_search_tpu_torch.utils.lru import LRU

_LRU_CAPACITY = 100  # reference kLRUCapacity (vector_externalizer.h:31)
_cache: LRU = LRU(_LRU_CAPACITY)


def vector_bytes(index, doc: int) -> Optional[bytes]:
    """Denormalized fp32 blob for one doc, LRU-cached per store epoch."""
    st = index.store
    key = (id(index), doc, st.epoch)
    hit = _cache.get(key)
    if hit is not None:
        return hit
    row = getattr(index, "_doc_node", None)
    node = row.get(doc) if row is not None else doc  # HNSW: doc → node row
    if node is None or node >= st.capacity or not st.present[node]:
        return None
    vec = np.array(st.vectors[node], np.float32)
    if index.metric == "cosine":
        vec = vec * np.float32(st.magnitudes[node])  # denormalize
    blob = vec.tobytes()
    _cache.put(key, blob)
    STATS.incr("vectors_externalized")
    return blob


def index_serves_return_fields(schema, sp, resp) -> bool:
    """True when every RETURN field can be served without a keyspace
    fetch: the vector attribute itself, the KNN score, or a numeric
    attribute value (reference MaybeAddIndexedContent conditions)."""
    if sp.no_content or not sp.return_fields:
        return False
    if resp.predicate is not None:
        from valkey_search_tpu_torch.query import predicate as P

        if not isinstance(resp.predicate, P.MatchAll):
            return False  # filtered queries re-verify via content resolution
    for f, _ in sp.return_fields:
        if resp.score_field is not None and f == resp.score_field:
            continue
        attr = schema.attributes.get(f) or next(
            (a for a in schema.attributes.values() if a.identifier == f), None
        )
        if attr is None or attr.kind not in ("HNSW", "FLAT", "NUMERIC"):
            return False
    return True


def indexed_content(schema, sp, nb, resp) -> dict:
    """Build the RETURN field dict from index state for one neighbor."""
    out = {}
    for f, _ in sp.return_fields:
        if resp.score_field is not None and f == resp.score_field:
            continue  # reply shaping adds the score itself
        attr = schema.attributes.get(f) or next(
            (a for a in schema.attributes.values() if a.identifier == f), None
        )
        if attr is None:
            continue
        if attr.kind in ("HNSW", "FLAT"):
            blob = vector_bytes(attr.index, nb.doc)
            if blob is not None:
                out[f] = blob
        elif attr.kind == "NUMERIC":
            v = attr.index.value_of(nb.key)
            if v is not None:
                out[f] = repr(float(v))
    return out
