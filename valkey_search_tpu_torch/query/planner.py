"""Hybrid-query planner: pre-filter vs inline-filter.

Reference: src/query/planner.cc:21-46 ``UsePreFiltering`` — flat indexes
always pre-filter (the exact scan already touches every candidate); HNSW
pre-filters iff the estimated qualified count ≤ ratio × tracked keys,
otherwise the predicate is evaluated inline during graph traversal.

On TPU the same structure holds but the costs shift: the inline filter is a
fused bitmask lookup (near-free inside the beam-search kernel), while the
pre-filter path is an exact blocked matmul over qualified rows — whose cost
is O(cap·d/B) per batch regardless of selectivity, since the MXU scans the
whole padded corpus. The threshold ratio (search.prefiltering-threshold-ratio)
is therefore retuned empirically rather than inherited.

The port's own copy of valkey_search_tpu/query/planner.py: the same
names, defaults and behaviour, with its imports pointing into
valkey_search_tpu_torch.
"""

from __future__ import annotations

from valkey_search_tpu_torch.runtime import config


def use_prefiltering(qualified_estimate: int, vector_index) -> bool:
    kind = getattr(vector_index, "kind", "")
    if kind == "FLAT":
        return True  # planner.cc:26-28
    tracked = max(vector_index.count(), 1)
    ratio = float(config.get("search.prefiltering-threshold-ratio"))
    return qualified_estimate <= ratio * tracked
