"""Vectorized HNSW bulk construction: the device side.

Counterpart of valkey_search_tpu/ops/hnsw_build.py. hnswlib builds its graph
one point at a time (``addPoint``, third_party/hnswlib/hnswalg.h:1260: an
ef_construction beam for the candidate pool, the getNeighborsByHeuristic2
select, then bidirectional connect). The bulk build replaces the per-point
beam with two batched device passes over the whole corpus:

1. exact candidates: each node's nearest among the nodes before it (the set
   hnswlib's addPoint sees), from one product per batch of nodes;
2. the select heuristic for every node of a batch at once: a K-step loop
   whose step is a [B, K] masked compare, over one batched pairwise product.

The host then installs forward lists, adds reverse edges and builds the
small upper hierarchy (native/hnsw_builder.cpp ``bulk_build``).

The f32 scores of bf16 operands are taken in f32 (the JAX package's
``preferred_element_type``): bf16 values are widened first, and with TF32
off every product is exact. Every selection is exact and breaks ties by the
lower id (the JAX package's ``approx_min_k`` is exact only on its CPU path).
A score block of a batch against a whole corpus of 1M rows would take
16 GiB, so the columns go in blocks sized from the device's free memory,
with a running top-k (``nearest``).
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from valkey_search_tpu_torch.ops.topk import merge_topk, topk_smallest

INF = float("inf")
# score-block bytes per (query, column) cell: the f32 scores, the int64
# composite key of a tie fallback (_smallest) and the top-k's own scratch
_CELL_BYTES = 32
_CPU_BLOCK_BYTES = 1 << 30
_COLUMN_QUANTUM = 4096
# extra values an f32 top-k takes so ties at the k-th stay exact (_smallest)
_TIE_MARGIN = 8


def _column_block(rows: int, device: torch.device) -> int:
    """Columns per score block for ``rows`` queries: 40% of the device's
    free memory (1 GiB on the CPU), in multiples of 4,096."""
    if device.type == "cuda":
        budget = int(torch.cuda.mem_get_info(device)[0] * 0.4)
    else:
        budget = _CPU_BLOCK_BYTES
    cols = budget // (max(rows, 1) * _CELL_BYTES)
    return max(_COLUMN_QUANTUM, cols // _COLUMN_QUANTUM * _COLUMN_QUANTUM)


def _smallest(s: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``topk_smallest(s, k)`` of a wide f32 score block, by way of an f32
    ``torch.topk`` of k + _TIE_MARGIN values: the int64 composite key of
    ``topk_smallest`` doubles the bytes of every pass over the block. The
    top-(k + margin) set holds every entry below its last value, so when the
    k-th value is below the last, ordering the set by (value, column) gives
    ``topk_smallest``'s answer; a block where some row's finite k-th value
    ties the last takes ``topk_smallest`` itself. (Entries at +inf become
    id -1 in ``nearest``, so their order does not matter.)"""
    kk = min(k + _TIE_MARGIN, s.shape[-1])
    if kk == k:
        return topk_smallest(s, k)
    vals, pos = torch.topk(s, kk, dim=-1, largest=False, sorted=True)
    kth = vals[:, k - 1]
    if bool(((kth == vals[:, -1]) & torch.isfinite(kth)).any()):
        return topk_smallest(s, k)
    order = torch.argsort(pos, dim=-1)
    vals, pos = vals.gather(-1, order), pos.gather(-1, order)
    vals, order = torch.sort(vals, dim=-1, stable=True)
    return vals[:, :k], pos.gather(-1, order[:, :k])


def nearest(
    qf: torch.Tensor,
    cf: torch.Tensor,
    k: int,
    metric: str,
    q_sq: Optional[torch.Tensor],
    c_sq: Optional[torch.Tensor],
    n_cols: int,
    allowed: Optional[Callable[[int, int], torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact k nearest of each query ``qf`` [B, d] f32 among the rows
    [0, n_cols) of ``cf`` [N, d] f32 that ``allowed(c0, c1)`` (bool
    [B, c1 - c0]) admits -> (dists [B, k], ids [B, k] int32) ascending,
    ties to the lower id, (+inf, -1) where fewer rows qualify.

    l2 scores are q_sq + c_sq - 2 q.c, ip 1 - q.c."""
    b = qf.shape[0]
    run_d = torch.full((b, k), INF, device=qf.device)
    run_i = torch.full((b, k), -1, dtype=torch.int32, device=qf.device)
    step = _column_block(b, qf.device)
    for c0 in range(0, n_cols, step):
        c1 = min(c0 + step, n_cols)
        dots = qf @ cf[c0:c1].T
        if metric == "l2":
            s = q_sq[:, None] + c_sq[None, c0:c1] - 2.0 * dots
        else:
            s = 1.0 - dots
        del dots
        if allowed is not None:
            s = torch.where(allowed(c0, c1), s, INF)
        d, pos = _smallest(s, min(k, c1 - c0))
        del s
        run_d, run_i = merge_topk(run_d, run_i, d, (pos + c0).to(torch.int32),
                                  k)
    return run_d, torch.where(torch.isinf(run_d), -1, run_i)


def prune_candidates(
    corpus_lp: torch.Tensor,  # [N, d] bf16
    corpus_sq: torch.Tensor,  # [N] f32
    ids: torch.Tensor,        # [B, K] candidate ids, ascending by dist, -1 pad
    dq: torch.Tensor,         # [B, K] candidate -> query distances
    self_ids: torch.Tensor,   # [B] the node each row is built for
    m: int,
    metric: str,
    alpha: float = 1.0,
) -> torch.Tensor:
    """The select heuristic for every row at once -> links [B, m] int32.

    alpha = 1: hnswlib getNeighborsByHeuristic2 per row: scan candidates
    closest first, keep c iff dist(c, q) < dist(c, s) for every kept s.
    alpha > 1 is the Vamana/DiskANN RobustPrune relaxation (reject c only
    when a kept s has alpha * d(s, c) <= d(c, q)). The kept candidates come
    first, then the closest pruned ones fill up to m (hnswlib's
    keepPrunedConnections)."""
    b, k = ids.shape
    cv = corpus_lp.index_select(0, ids.reshape(-1).clamp_min(0)).reshape(
        b, k, -1).to(torch.float32)                            # [B, K, d]
    dots = torch.bmm(cv, cv.transpose(1, 2))
    if metric == "l2":
        nsq = corpus_sq[ids.clamp_min(0).long()]               # [B, K]
        pair = nsq[:, :, None] + nsq[:, None, :] - 2.0 * dots
    else:
        pair = 1.0 - dots
    valid = (ids >= 0) & (ids != self_ids[:, None]) & torch.isfinite(dq)
    dqv = torch.where(valid, dq, INF)
    kept = torch.zeros((b, k), dtype=torch.bool, device=ids.device)
    n_kept = torch.zeros(b, dtype=torch.int32, device=ids.device)
    for i in range(k):
        # candidate i is rejected if a kept candidate is (alpha-decisively)
        # closer to it than it is to the query
        viol = ((pair[:, :, i] * alpha < dqv[:, i, None]) & kept).any(1)
        ok = ~viol & valid[:, i] & (n_kept < m)
        kept[:, i] = ok
        n_kept += ok
    col = torch.arange(k, dtype=torch.int32, device=ids.device)[None, :]
    take = torch.argsort(torch.where(kept, col, k + col), dim=1,
                         stable=True)[:, :m]
    links = torch.where(valid, ids, -1).gather(1, take).to(torch.int32)
    if links.shape[1] < m:
        links = torch.nn.functional.pad(links, (0, m - links.shape[1]),
                                        value=-1)
    return links


def _candidate_scan(
    qf: torch.Tensor,        # [B, d] f32 (bf16 values)
    qsq: torch.Tensor,       # [B] f32
    cf: torch.Tensor,        # [N, d] f32 (bf16 values)
    c_sq: torch.Tensor,      # [N] f32
    self_ids: torch.Tensor,  # [B] prefix bound = own node id
    k: int,
    metric: str,
    n_cols: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Prefix-masked candidate scan -> (dq [B, k], ids [B, k]): the k
    nearest of each row among the rows below its own id. Only the columns
    [0, n_cols) are scanned: ``n_cols`` is at least the batch's highest self
    id, and every column past it is masked for all rows anyway."""
    return nearest(
        qf, cf, k, metric, qsq, c_sq, n_cols,
        lambda c0, c1: (torch.arange(c0, c1, device=qf.device)[None, :]
                        < self_ids[:, None]))


def _dists_to_rows(corpus_lp, corpus_sq, qrows, ids, metric):
    """Distances corpus[qrows] -> corpus[ids] ([B, R]) over the bf16 rows."""
    qv = corpus_lp[qrows.long()].to(torch.float32)
    cv = corpus_lp[ids.clamp_min(0).long()].to(torch.float32)
    dots = torch.einsum("bd,brd->br", qv, cv)
    if metric == "l2":
        return (corpus_sq[qrows.long()][:, None]
                + corpus_sq[ids.clamp_min(0).long()] - 2.0 * dots)
    return 1.0 - dots


def build_pruned_knn_links(
    corpus: np.ndarray,
    metric: str,
    m: int,
    k_cand: int = 64,
    batch: int = 8192,
    alpha: float = 1.0,
    n_random: int = 0,
    prefix: bool = True,
    seed: int = 0xB41D,
    device: Optional[torch.device] = None,
    timings: Optional[Dict[str, float]] = None,
) -> np.ndarray:
    """Forward level-0 links [N, m] for every corpus row, device-computed.

    ``prefix=True`` restricts node i's candidates to ids < i, the set
    hnswlib's addPoint sees when it inserts node i. That keeps the era
    structure that makes HNSW graphs navigable: early nodes link across the
    whole space. A symmetric pruned-KNN graph (prefix=False) fragments into
    cluster islands on clustered corpora. ``timings``, when given, gains
    the seconds spent in the candidate scan and in the prune."""
    n, d = corpus.shape
    device = torch.device(device) if device is not None else torch.device(
        "cpu")
    rng = np.random.default_rng(seed)
    c_dev = torch.from_numpy(np.ascontiguousarray(corpus, np.float32)).to(
        device)
    c_lp = c_dev.to(torch.bfloat16)
    c_sq = (c_dev * c_dev).sum(1)
    del c_dev
    cf = c_lp.to(torch.float32)
    kk = min(k_cand + 1, n)  # +1: the self-match takes one slot
    links = np.full((n, m), -1, np.int32)
    metric_eff = "ip" if metric == "cosine" else metric
    times = {"candidate_scan_s": 0.0, "prune_s": 0.0}
    for s in range(0, n, batch):
        e = min(s + batch, n)
        t0 = time.perf_counter()
        self_ids = torch.arange(s, e, dtype=torch.int32, device=device)
        if prefix:
            scan_ids, n_cols = self_ids, e
        else:
            scan_ids, n_cols = torch.full_like(self_ids, n), n
        dq, ids = _candidate_scan(cf[s:e], c_sq[s:e], cf, c_sq, scan_ids,
                                  kk, metric_eff, n_cols)
        if n_random > 0 and n > kk + n_random:
            # drawn for a whole batch, as the JAX package pads its last one
            rand = rng.integers(0, n, size=(batch, n_random))[:e - s]
            rand_ids = torch.as_tensor(rand, dtype=torch.int32,
                                       device=device)
            rand_dq = _dists_to_rows(c_lp, c_sq, self_ids, rand_ids,
                                     metric_eff)
            ids = torch.cat([ids, rand_ids], 1)
            dq = torch.cat([dq, rand_dq], 1)
        if device.type == "cuda":  # the scan's time, not its launch
            torch.cuda.synchronize(device)
        t1 = time.perf_counter()
        pruned = prune_candidates(c_lp, c_sq, ids, dq, self_ids, m=m,
                                  metric=metric_eff, alpha=alpha)
        links[s:e] = pruned.cpu().numpy()
        times["candidate_scan_s"] += t1 - t0
        times["prune_s"] += time.perf_counter() - t1
    if timings is not None:
        for key, v in times.items():
            timings[key] = timings.get(key, 0.0) + v
    return links


def sample_levels(
    n: int, m: int, seed: int
) -> Tuple[np.ndarray, int]:
    """Geometric level assignment, hnswlib distribution (mult = 1/ln(M))."""
    rng = np.random.default_rng(seed)
    u = np.maximum(rng.random(n), 1e-300)
    mult = 1.0 / np.log(m)
    levels = np.floor(-np.log(u) * mult).astype(np.int32)
    return levels, int(levels.max(initial=0))


def bridge_components(
    builder, corpus: np.ndarray, max_rounds: int = 12,
    device: Optional[torch.device] = None,
) -> int:
    """Connect level-0 islands (see indexes/hnsw.py ``_bulk_build_device``).

    Each round: label the components (native union-find), take each
    non-giant component's first node, find its nearest node outside its own
    component with one masked device scan (l2 over the bf16 rows, as the
    JAX package does for every metric), and add a mutual bridge edge.
    Components at least halve per round. Returns the rounds run."""
    device = torch.device(device) if device is not None else torch.device(
        "cpu")
    n = corpus.shape[0]
    cf = torch.from_numpy(np.ascontiguousarray(corpus, np.float32)).to(
        device).to(torch.bfloat16).to(torch.float32)
    c_sq = (cf * cf).sum(1)
    rounds = 0
    for rounds in range(1, max_rounds + 1):
        comp = builder.components()
        ncomp = int(comp.max()) + 1 if comp.size else 1
        if ncomp <= 1:
            return rounds - 1
        # the biggest component keeps its label; every other sends a probe
        giant = int(np.bincount(comp, minlength=ncomp).argmax())
        labels, first = np.unique(comp, return_index=True)
        probe = first[labels != giant]  # each component's first node
        comp_dev = torch.from_numpy(comp).to(device)
        for s in range(0, len(probe), 512):
            chunk = probe[s:s + 512]
            rows = torch.from_numpy(chunk).to(device)
            own = comp_dev[rows]
            _, ids = nearest(
                cf[rows], cf, 1, "l2", c_sq[rows], c_sq, n,
                lambda c0, c1: comp_dev[None, c0:c1] != own[:, None])
            for u, v in zip(chunk, ids[:, 0].cpu().numpy()):
                if v >= 0:
                    builder.add_bridge(int(u), int(v))
    return rounds
