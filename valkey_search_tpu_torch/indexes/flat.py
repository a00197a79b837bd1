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
  top-k and the fp32 rescore;
- ``approx`` with a bf16 mirror otherwise: ``flat_topk_two_stage``;
- else the blocked exact scan ``flat_topk``.
"""

from __future__ import annotations

from typing import Mapping, Optional, Tuple

import numpy as np
import torch

from valkey_search_tpu_torch.runtime import config
from valkey_search_tpu_torch.runtime.metrics import STATS
from valkey_search_tpu_torch.indexes.vector_base import (
    VectorIndexBase,
    store_from_reference,
)
from valkey_search_tpu_torch.ops import topk as topk_ops


class FlatVectorIndex(VectorIndexBase):
    kind = "FLAT"

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
        # a copy: query blobs arrive as read-only buffers
        queries = np.array(np.atleast_2d(queries), np.float32, order="C")
        if queries.shape[1] != self.dim:
            raise ValueError(
                f"query dim {queries.shape[1]} != index dim {self.dim}")
        if self.metric == "cosine":
            mags = np.linalg.norm(queries, axis=1, keepdims=True)
            queries = queries / np.maximum(mags, 1e-30)
        snap = self.store.device_snapshot()
        mode = str(config.get("search.topk-mode"))
        q = torch.from_numpy(queries).to(self.store.device)
        corpus = snap["vectors"]
        if filter_mask is None:
            mirror = self.ivf_mirror()
            if mirror is not None:
                d, i = self._ivf_search(mirror, q, k, corpus,
                                        snap["invalid"])
                STATS.incr("flat_searches", queries.shape[0])
                STATS.incr("ivf_served_searches", queries.shape[0])
                return d.cpu().numpy(), i.cpu().numpy()
        else:
            filter_mask = _fit_mask(filter_mask, corpus.shape[0])
        common = dict(k=k, metric=self.metric, corpus_sq=snap["norms_sq"],
                      invalid=snap["invalid"], filter_mask=filter_mask)
        if (
            mode == "approx"
            and ("vectors_lp" in snap or "vectors_i8" in snap)
            and topk_ops.use_fused_scan(corpus.shape[0], filter_mask, corpus)
        ):
            d, i = topk_ops.flat_topk_fused(
                q, corpus, snap.get("vectors_lp"),
                block_rows=max(int(config.get("search.flat-block-size")),
                               corpus.shape[0]),
                corpus_i8=snap.get("vectors_i8"),
                i8_scale=snap.get("i8_scale"),
                span=int(config.get("search.scan-span")) or None,
                coarse_factor=(
                    int(config.get("search.scan-coarse-factor")) or None),
                **common,
            )
        elif mode == "approx" and "vectors_lp" in snap:
            d, i = topk_ops.flat_topk_two_stage(
                q, corpus, snap["vectors_lp"],
                block_rows=int(config.get("search.flat-block-size")),
                **common,
            )
        else:
            d, i = topk_ops.flat_topk(
                q, corpus,
                block_rows=int(config.get("search.flat-block-size")),
                mode=mode, **common,
            )
        STATS.incr("flat_searches", queries.shape[0])
        return d.cpu().numpy(), i.cpu().numpy()


def _fit_mask(mask: torch.Tensor, cap: int) -> torch.Tensor:
    """``mask`` [..., n] cut or False-padded to [..., cap]."""
    n = mask.shape[-1]
    if n > cap:
        return mask[..., :cap]
    if n < cap:
        return torch.nn.functional.pad(mask, (0, cap - n), value=False)
    return mask
