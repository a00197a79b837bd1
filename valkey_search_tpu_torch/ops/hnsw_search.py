"""Batched HNSW search on a torch device: the graph walk.

Counterpart of valkey_search_tpu/ops/hnsw_search.py (reference searchKnn,
third_party/hnswlib/hnswalg.h:1611-1685). A whole batch of queries walks
the graph in lockstep:

- upper layers: batched greedy descent (each step gathers every query's
  neighbour rows and scores them with one batched product);
- layer 0: a batched best-first beam. Each iteration expands the E best
  unexpanded beam entries of every query, scores their M0 neighbours and
  merges them into a sorted ef-beam. Re-gathered nodes are deduplicated
  against the beam instead of a visited bitset (an evicted node cannot
  re-enter: its distance exceeds a bound that only falls).

With a filter or tombstones, traversal and result admission separate: a
result list keeps the best ef *allowed* nodes while the beam traverses
everything, as hnswlib's searchBaseLayerST keeps two heaps.

Each ``lax.while_loop`` of the JAX package is a Python loop of tensor ops on
the graph's device. A query that is done keeps its state through further
iterations (no entry is expanded, and the stable sorts leave a sorted beam
as it is), so the loop reads ``done`` back to the host only every
``check_every`` iterations: the results are those of a check on every
iteration, and the extra iterations cost only device time.

Sorts are stable, as ``jnp.argsort`` is; ``lax.top_k`` becomes
``topk_smallest`` (ties to the lower index). Every -1 id passes through
``clamp_min(0)`` before it indexes anything (an out-of-range index is a
device-side assert on CUDA), and a filter mask shorter than the doc space
admits no doc past its end.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from valkey_search_tpu_torch.ops import distance as dist_ops
from valkey_search_tpu_torch.ops.topk import topk_smallest

INF = float("inf")
# iterations between reads of the beam's ``done`` flags (a device-to-host
# copy each); results do not depend on it
CHECK_EVERY = 4


class HnswDeviceGraph(NamedTuple):
    """Device-resident HNSW graph (struct of arrays).

    vectors:      [cap, d] fp32 node vectors (the store's published mirror)
    links0:       [cap, M0] int32 level-0 adjacency, -1 padded
    deleted:      [cap] bool tombstones (and unallocated rows)
    entry:        the global entry node
    upper_id2row: per level 1.., [cap] int32 node -> row of its link table
                  (-1 if the node is not on the level)
    upper_links:  per level 1.., [n_l, M] int32 link tables
    node_doc:     [cap] int32 node -> schema doc id (-1 unallocated)
    """

    vectors: torch.Tensor
    links0: torch.Tensor
    deleted: torch.Tensor
    entry: int
    upper_id2row: Tuple[torch.Tensor, ...]
    upper_links: Tuple[torch.Tensor, ...]
    node_doc: torch.Tensor


def _gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table[idx] with negative indices mapped to row 0 (callers mask)."""
    rows = table.index_select(0, idx.reshape(-1).clamp_min(0))
    return rows.reshape(*idx.shape, *table.shape[1:])


def docs_allowed(filter_mask: torch.Tensor, docs: torch.Tensor) -> torch.Tensor:
    """filter_mask[docs]; a doc < 0 or past the mask's end is not allowed."""
    n = filter_mask.shape[0]
    inside = (docs >= 0) & (docs < n)
    return _gather_rows(filter_mask, docs.clamp(max=n - 1)) & inside


def _descend_level(queries, vectors, id2row, links, cur, cur_d, metric):
    """Greedy move-to-best-neighbour until no query improves (one layer)."""
    while True:
        rows = _gather_rows(id2row, cur)                      # [B]
        nbrs = _gather_rows(links, rows)                      # [B, M]
        valid = (nbrs >= 0) & (rows >= 0)[:, None]
        nd = dist_ops.batched_candidate_scores(
            queries, _gather_rows(vectors, nbrs), metric)
        nd = torch.where(valid, nd, INF)
        best = nd.argmin(dim=1, keepdim=True)                 # first minimum
        best_d = nd.gather(1, best)[:, 0]
        best_i = nbrs.gather(1, best)[:, 0]
        improved = best_d < cur_d
        cur = torch.where(improved, best_i, cur)
        cur_d = torch.where(improved, best_d, cur_d)
        if not bool(improved.any()):
            return cur, cur_d


def _descend(graph: HnswDeviceGraph, queries, cur, cur_d, metric: str):
    """(node, distance) per query from the top level down to level 1."""
    for id2row, links in zip(reversed(graph.upper_id2row),
                             reversed(graph.upper_links)):
        cur, cur_d = _descend_level(queries, graph.vectors, id2row, links,
                                    cur, cur_d, metric)
    return cur, cur_d


def _entry(graph: HnswDeviceGraph, queries: torch.Tensor):
    """The entry node for every query, and its vector."""
    cur = torch.full((queries.shape[0],), graph.entry, dtype=torch.int32,
                     device=queries.device)
    return cur, _gather_rows(graph.vectors, cur)


def _earlier(c: int, device) -> torch.Tensor:
    """bool [c, c]: column j precedes column i (the intra-step dedup)."""
    return torch.ones((c, c), dtype=torch.bool, device=device).tril(-1)


def _select_unexpanded(beam_d, beam_i, beam_e, lb, done, e_exp):
    """The E best unexpanded beam entries of every query -> (their ids
    [B, E], which of them expand [B, E], new done [B], new beam_e)."""
    cand_d = torch.where(beam_e | (beam_i < 0), INF, beam_d)
    sel_d, sel_pos = topk_smallest(cand_d, e_exp)              # [B, E]
    # hnswlib's break per expansion slot; a query is done only when its
    # best unexpanded entry fails
    active = torch.isfinite(sel_d) & (sel_d <= lb[:, None]) & ~done[:, None]
    done = done | ~active[:, 0]
    sel_id = beam_i.gather(1, sel_pos)
    beam_e = beam_e.scatter(1, sel_pos, beam_e.gather(1, sel_pos) | active)
    return sel_id, active, done, beam_e


def hnsw_search_batch(
    graph: HnswDeviceGraph,
    queries: torch.Tensor,
    k: int,
    ef: int,
    metric: str = "l2",
    filter_mask: Optional[torch.Tensor] = None,
    max_iters: Optional[int] = None,
    expand_per_iter: int = 4,
    check_every: int = CHECK_EVERY,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched ANN search -> (dists [B, k], node ids [B, k]) ascending.

    ``filter_mask``: optional bool [n_docs] in doc-id space (True =
    allowed). Deleted nodes are traversed but never returned, as in
    hnswlib. ``expand_per_iter`` E > 1 expands the E best unexpanded entries
    at once: ~E times fewer iterations for the same products; termination
    still fires when the best unexpanded entry is worse than the ef-th
    result."""
    ef = max(ef, k)
    queries = queries.to(torch.float32)
    dev = queries.device
    b = queries.shape[0]
    e_exp = max(1, min(expand_per_iter, ef))
    if max_iters is None:
        max_iters = (16 * ef + 64 + e_exp - 1) // e_exp
    cur, evec = _entry(graph, queries)
    cur_d = dist_ops.batched_candidate_scores(queries, evec[:, None, :],
                                              metric)[:, 0]
    cur, cur_d = _descend(graph, queries, cur, cur_d, metric)

    def excluded(nodes):  # deleted, filtered out, or no node
        ex = _gather_rows(graph.deleted, nodes)
        if filter_mask is not None:
            ex = ex | ~docs_allowed(filter_mask,
                                _gather_rows(graph.node_doc, nodes))
        return ex | (nodes < 0)

    beam_d = torch.full((b, ef), INF, device=dev)
    beam_d[:, 0] = cur_d
    beam_i = torch.full((b, ef), -1, dtype=torch.int32, device=dev)
    beam_i[:, 0] = cur
    beam_e = torch.zeros((b, ef), dtype=torch.bool, device=dev)
    ex0 = excluded(beam_i)
    res_d, order = torch.sort(torch.where(ex0, INF, beam_d), dim=1,
                              stable=True)
    res_i = torch.where(ex0, -1, beam_i).gather(1, order)
    done = torch.zeros(b, dtype=torch.bool, device=dev)
    earlier = _earlier(e_exp * graph.links0.shape[1], dev)
    fresh = torch.zeros((b, earlier.shape[0]), dtype=torch.bool, device=dev)

    for it in range(1, max_iters + 1):
        # hnswlib lowerBound: the worst result once the list holds ef
        # entries, +inf before (a filtered list can stay underfull)
        sel_id, active, done, beam_e = _select_unexpanded(
            beam_d, beam_i, beam_e, res_d[:, ef - 1], done, e_exp)
        nbrs = _gather_rows(graph.links0, sel_id)             # [B, E, M0]
        nbrs = torch.where(active[:, :, None], nbrs, -1).reshape(b, -1)
        nd = dist_ops.batched_candidate_scores(
            queries, _gather_rows(graph.vectors, nbrs), metric)
        nd = torch.where(nbrs >= 0, nd, INF)
        if e_exp > 1:
            # a node reached from two expanded entries enters once
            dup = ((nbrs[:, :, None] == nbrs[:, None, :]) & earlier).any(2)
            nd = torch.where(dup, INF, nd)
        # dedup against the beam (the visited set's role)
        dup = (nbrs[:, :, None] == beam_i[:, None, :]).any(2)
        all_d, order = torch.sort(
            torch.cat([beam_d, torch.where(dup, INF, nd)], 1), dim=1,
            stable=True)
        order = order[:, :ef]
        beam_d = all_d[:, :ef]
        beam_i = torch.cat([beam_i, nbrs], 1).gather(1, order)
        beam_e = torch.cat([beam_e, fresh], 1).gather(1, order)

        # the result list admits allowed nodes only, deduplicated
        nd_res = torch.where(excluded(nbrs), INF, nd)
        dup = (nbrs[:, :, None] == res_i[:, None, :]).any(2)
        nd_res = torch.where(dup, INF, nd_res)
        r_d, r_order = torch.sort(torch.cat([res_d, nd_res], 1), dim=1,
                                  stable=True)
        r_order = r_order[:, :ef]
        res_d = r_d[:, :ef]
        res_i = torch.cat(
            [res_i, torch.where(torch.isinf(nd_res), -1, nbrs)], 1
        ).gather(1, r_order)
        if it % check_every == 0 and bool(done.all()):
            break

    out_d = res_d[:, :k]
    out_i = torch.where(torch.isfinite(out_d), res_i[:, :k], -1)
    return out_d, out_i


class HnswAosTables(NamedTuple):
    """The walk's array-of-structures mirror (built from an HnswDeviceGraph).

    One gather of node n's row fetches the quantized vectors of all its
    level-0 neighbours as one contiguous block. A projection to dp dims (the
    top principal components of a corpus sample) shrinks the rows further:
    the walk needs distance order only, and the final fp32 rescore restores
    precision. The blocks hold each vector once per in-edge (M0 times the
    int8 corpus), so ``search.hnsw-aos-budget-bytes`` gates the mirror.

    nbr_vecs_q: [cap, M0, dp] int8, 0-padded
    scale:      f32 scalar, value = q * scale
    q_vectors:  [cap, dp] int8 per-node quantized vector (seeding)
    proj:       [d, dp] f32 projection, or None (dp == d)
    """

    nbr_vecs_q: torch.Tensor
    scale: torch.Tensor
    q_vectors: torch.Tensor
    proj: Optional[torch.Tensor]


def build_aos_tables(graph: HnswDeviceGraph,
                     project_dim: int = 0) -> HnswAosTables:
    """Assemble the AoS mirror on the graph's device. ``project_dim`` > 0
    and < d projects onto the top principal components of a strided corpus
    sample first (PCA keeps distance order far better than a random
    projection on real corpora)."""
    vecs = graph.vectors
    d = vecs.shape[1]
    proj = None
    if project_dim and project_dim < d:
        sample = vecs[::max(1, vecs.shape[0] // 4096)]
        centered = sample - sample.mean(dim=0)
        _, _, vt = torch.linalg.svd(centered, full_matrices=False)
        proj = vt[:project_dim].T.contiguous()                # [d, dp]
        vecs = vecs @ proj
    scale = torch.clamp_min(vecs.abs().max(), 1e-30) / 127.0
    q = torch.clamp(torch.round(vecs / scale), -127, 127).to(torch.int8)
    blk = _gather_rows(q, graph.links0)                       # [cap, M0, dp]
    blk = blk.masked_fill((graph.links0 < 0)[:, :, None], 0)
    return HnswAosTables(nbr_vecs_q=blk, scale=scale, q_vectors=q,
                         proj=proj)


def hnsw_search_batch_aos(
    graph: HnswDeviceGraph,
    aos: HnswAosTables,
    queries: torch.Tensor,
    k: int,
    ef: int,
    metric: str = "l2",
    expand_per_iter: int = 8,
    max_iters: Optional[int] = None,
    seed_stride: int = 0,
    check_every: int = CHECK_EVERY,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The unfiltered walk over the AoS mirror: int8 neighbour blocks scored
    elementwise in bf16, one sort per iteration, and an exact fp32 rescore
    of the beam at the end, which also drops deleted nodes.

    ``seed_stride`` > 0 fills the beam from one product over every
    seed_stride-th node instead of the upper-layer descent."""
    ef = max(ef, k)
    queries = queries.to(torch.float32)
    dev = queries.device
    b = queries.shape[0]
    e_exp = max(1, min(expand_per_iter, ef))
    if max_iters is None:
        # a scan-seeded beam starts near-converged and needs fewer
        factor = 2 if seed_stride else 4
        max_iters = (factor * ef + 32 + e_exp - 1) // e_exp

    # walk-space queries (projected with the mirror); the rescore at the
    # end is in the full space
    walk_q = queries if aos.proj is None else queries @ aos.proj
    qbf = walk_q.to(torch.bfloat16)
    scale_bf = aos.scale.to(torch.bfloat16)

    beam_d = torch.full((b, ef), INF, device=dev)
    beam_i = torch.full((b, ef), -1, dtype=torch.int32, device=dev)
    if seed_stride:
        sub = aos.q_vectors[::seed_stride].to(torch.bfloat16) * scale_bf
        dots = (qbf @ sub.T).to(torch.float32)                # [B, S]
        if metric == "l2":
            s_sq = (sub.to(torch.float32) ** 2).sum(1)
            q_sq = (walk_q * walk_q).sum(1)
            sd = q_sq[:, None] + s_sq[None, :] - 2.0 * dots
        else:
            sd = 1.0 - dots
        # capacity slack and tombstones are deleted in the published graph:
        # their zero vectors must not tighten the bound
        sd = torch.where(graph.deleted[::seed_stride][None, :], INF, sd)
        seed_d, pos = topk_smallest(sd, min(ef, sub.shape[0]))
        beam_d[:, :seed_d.shape[1]] = seed_d
        beam_i[:, :seed_d.shape[1]] = (pos * seed_stride).to(torch.int32)
    else:
        cur, evec = _entry(graph, queries)
        if metric == "l2":
            cur_d = ((evec - queries) ** 2).sum(-1)
        else:
            cur_d = 1.0 - (evec * queries).sum(-1)
        cur, cur_d = _descend(graph, queries, cur, cur_d, metric)
        if aos.proj is not None:
            # beam distances live in the walk space: rescore the entry there
            evq = _gather_rows(aos.q_vectors, cur).to(torch.float32) \
                * aos.scale
            if metric == "l2":
                cur_d = ((evq - walk_q) ** 2).sum(-1)
            else:
                cur_d = 1.0 - (evq * walk_q).sum(-1)
        beam_d[:, 0] = cur_d
        beam_i[:, 0] = cur
    beam_e = torch.zeros((b, ef), dtype=torch.bool, device=dev)
    done = torch.zeros(b, dtype=torch.bool, device=dev)
    earlier = _earlier(e_exp * graph.links0.shape[1], dev)
    fresh = torch.zeros((b, earlier.shape[0]), dtype=torch.bool, device=dev)

    def score_blk(blk_q):  # [B, E, M0, dp] int8 -> [B, E*M0] f32
        v = blk_q.to(torch.bfloat16) * scale_bf
        if metric == "l2":
            diff = v - qbf[:, None, None, :]
            nd = (diff * diff).sum(-1)
        else:
            nd = 1.0 - (v * qbf[:, None, None, :]).sum(-1)
        return nd.reshape(b, -1).to(torch.float32)

    for it in range(1, max_iters + 1):
        sel_id, active, done, beam_e = _select_unexpanded(
            beam_d, beam_i, beam_e, beam_d[:, ef - 1], done, e_exp)
        safe_sel = sel_id.clamp_min(0)
        nbrs = _gather_rows(graph.links0, safe_sel)           # [B, E, M0]
        nbrs = torch.where(active[:, :, None], nbrs, -1).reshape(b, -1)
        nd = score_blk(_gather_rows(aos.nbr_vecs_q, safe_sel))
        nd = torch.where(nbrs >= 0, nd, INF)
        dup = (nbrs[:, :, None] == beam_i[:, None, :]).any(2)
        if e_exp > 1:
            dup = dup | ((nbrs[:, :, None] == nbrs[:, None, :])
                         & earlier).any(2)
        all_d, order = torch.sort(
            torch.cat([beam_d, torch.where(dup, INF, nd)], 1), dim=1,
            stable=True)
        order = order[:, :ef]
        beam_d = all_d[:, :ef]
        beam_i = torch.cat([beam_i, nbrs], 1).gather(1, order)
        beam_e = torch.cat([beam_e, fresh], 1).gather(1, order)
        if it % check_every == 0 and bool(done.all()):
            break

    # exact fp32 rescore of the beam: restores the int8 walk's recall and
    # drops deleted nodes (traversed, never returned)
    vecs = _gather_rows(graph.vectors, beam_i)                # [B, ef, d]
    if metric == "l2":
        exact = ((vecs - queries[:, None, :]) ** 2).sum(-1)
    else:
        exact = 1.0 - (vecs * queries[:, None, :]).sum(-1)
    bad = (beam_i < 0) | _gather_rows(graph.deleted, beam_i)
    out_d, pos = topk_smallest(torch.where(bad, INF, exact), k)
    out_i = torch.where(torch.isfinite(out_d), beam_i.gather(1, pos), -1)
    return out_d, out_i


def build_device_graph(
    vectors: torch.Tensor,
    links0,
    deleted,
    uppers: Sequence[dict],
    entry: int,
    node_doc,
    m: int,
) -> HnswDeviceGraph:
    """An HnswDeviceGraph on ``vectors``' device from host arrays (or
    tensors already there).

    ``uppers`` is the native export of levels 1..max_level: [{"nodes":
    [n_l], "links": [n_l, M]}, ...]. A level's link table keeps at least
    one row, so a gather at row 0 stays in range."""
    dev = vectors.device
    cap = vectors.shape[0]
    id2rows, link_tables = [], []
    for lv in uppers:
        nodes = np.asarray(lv["nodes"], np.int64)
        links = np.full((max(1, len(nodes)), m), -1, np.int32)
        links[:len(nodes)] = np.asarray(lv["links"], np.int32)[:len(nodes)]
        id2row = np.full(cap, -1, np.int32)
        id2row[nodes] = np.arange(len(nodes), dtype=np.int32)
        id2rows.append(torch.from_numpy(id2row).to(dev))
        link_tables.append(torch.from_numpy(links).to(dev))
    return HnswDeviceGraph(
        vectors=vectors.to(torch.float32),
        links0=torch.as_tensor(links0, dtype=torch.int32, device=dev),
        deleted=torch.as_tensor(deleted, dtype=torch.bool, device=dev),
        entry=int(entry),
        upper_id2row=tuple(id2rows),
        upper_links=tuple(link_tables),
        node_doc=torch.as_tensor(node_doc, dtype=torch.int32, device=dev),
    )
