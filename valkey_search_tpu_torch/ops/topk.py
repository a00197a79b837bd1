"""Exact k-NN over a corpus tensor: blocked scans, fused coarse scans, rescoring.

Counterpart of valkey_search_tpu/ops/topk.py. Distances are "smaller is
better" throughout; invalid rows (unallocated, deleted, filtered out) score
+inf and come back as id -1.

Every selection here is exact and breaks ties by the lower index, as
``lax.top_k`` does (``topk_smallest``). The JAX package's approximate
selections (``lax.approx_min_k``, and its chunked survivor select, a
workaround for its TPU backend) are exact top-k's in the port: the coarse
survivor arrays are 128 to 1024 times smaller than the score matrix, so
exact selection costs little, and the port then returns the same ids as the
JAX package on its CPU path.

Inside a traced launch (runtime/metrics.py ``CTX.launch``) the fused scan
records ``topk.plan`` (``fused_plan``: the mirror, span and coarse factor,
the survivor budget and the block split), ``topk.bias`` (the scan's inputs:
the queries quantized or scaled, the bias and its padding), ``topk.select``
and ``topk.rescore`` into ``TRACE``, and ops/bucket_scan.py ``topk.scan``.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from valkey_search_tpu_torch.runtime import config
from valkey_search_tpu_torch.runtime.metrics import CTX, SPAN, TRACE, clock
from valkey_search_tpu_torch.ops import bucket_scan as bs
from valkey_search_tpu_torch.ops import distance as dist_ops

INF = float("inf")
INVALID_ID = -1

# survivor-memory limit on a device without a memory query (the CPU), as in
# the JAX package
_DEFAULT_MEMORY_LIMIT = 16 << 30


def topk_smallest(vals: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` smallest of each row, ascending, ties to the lower index
    (the order of ``lax.top_k(-vals, k)``). ``vals`` is f32 or int32;
    returns (values, positions int64)."""
    if vals.dtype == torch.float32:
        bits = vals.view(torch.int32)
        ordered = bits ^ ((bits >> 31) & 0x7FFFFFFF)  # f32 total order
    elif vals.dtype == torch.int32:
        ordered = vals
    else:
        raise ValueError(f"topk_smallest takes f32 or int32, not {vals.dtype}")
    pos = torch.arange(vals.shape[-1], dtype=torch.int64, device=vals.device)
    comp = (ordered.to(torch.int64) << 32) | pos
    top = torch.topk(comp, k, dim=-1, largest=False, sorted=True).values
    pos = top & 0xFFFFFFFF
    return vals.gather(-1, pos), pos


def merge_topk(
    dists_a: torch.Tensor,
    ids_a: torch.Tensor,
    dists_b: torch.Tensor,
    ids_b: torch.Tensor,
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge two top-k sets [B, ka] + [B, kb] into the best k, ascending."""
    d = torch.cat([dists_a, dists_b], dim=-1)
    i = torch.cat([ids_a, ids_b], dim=-1)
    top, pos = topk_smallest(d, k)
    return top, i.gather(-1, pos)


def _pad_k(d: torch.Tensor, ids: torch.Tensor, k: int):
    pad = k - d.shape[-1]
    if pad <= 0:
        return d, ids
    return (torch.nn.functional.pad(d, (0, pad), value=INF),
            torch.nn.functional.pad(ids, (0, pad), value=INVALID_ID))


def _rescore_exact(
    queries: torch.Tensor,      # [B, d] fp32
    corpus: torch.Tensor,       # [cap, d] fp32
    cand_ids: torch.Tensor,     # [B, C] int32 (-1 padded)
    cand_valid_d: torch.Tensor, # [B, C] coarse distances (inf = invalid)
    k: int,
    metric: str = "l2",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact fp32 re-ranking of coarse candidates: gather, score, top-k."""
    launch = CTX.launch
    t0 = clock() if launch else 0
    cand = corpus[cand_ids.clamp_min(0).long()]  # [B, C, d]
    d = dist_ops.batched_candidate_scores(queries.to(torch.float32), cand,
                                          metric)
    d = torch.where((cand_ids >= 0) & torch.isfinite(cand_valid_d), d, INF)
    out_d, pos = topk_smallest(d, min(k, d.shape[-1]))
    out_i = cand_ids.gather(-1, pos)
    out_i = torch.where(torch.isfinite(out_d), out_i, INVALID_ID)
    out = _pad_k(out_d, out_i.to(torch.int32), k)
    if t0:
        TRACE.record(SPAN["topk.rescore"], t0, clock(), CTX.rid, launch)
    return out


def flat_topk_two_stage(
    queries: torch.Tensor,
    corpus: torch.Tensor,      # fp32 [cap, d]
    corpus_lp: torch.Tensor,   # bf16 [cap, d] (same rows)
    k: int,
    metric: str = "l2",
    corpus_sq: Optional[torch.Tensor] = None,
    invalid: Optional[torch.Tensor] = None,
    filter_mask: Optional[torch.Tensor] = None,
    block_rows: int = 131072,
    coarse_factor: int = 3,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """bf16 coarse scan over-retrieving coarse_factor*k candidates, then an
    exact fp32 rescore (the plain path below the fused scan's size)."""
    ck = min(coarse_factor * k, corpus.shape[0])
    cd, ci = flat_topk(
        queries.to(torch.bfloat16), corpus_lp, k=ck, metric=metric,
        corpus_sq=corpus_sq, invalid=invalid, filter_mask=filter_mask,
        block_rows=block_rows, mode="approx", approx_over_retrieve=1,
    )
    return _rescore_exact(queries, corpus, ci, cd, k=k, metric=metric)


def use_fused_scan(cap: int, filter_mask: Optional[torch.Tensor],
                   corpus: torch.Tensor) -> bool:
    """Route a coarse scan to the hand-written fused kernels?

    ``search.scan-kernel`` "xla" means the plain two-stage path; "pallas"
    means the fused scan wherever it is called (on a CPU tensor its plain
    version runs); "auto" means the fused scan when the corpus lies on a
    CUDA device. The corpus must be large enough for bucketed selection
    (>= 131072 rows), and a pre-filter must be shared by all queries."""
    choice = str(config.get("search.scan-kernel"))
    if choice == "xla":
        return False
    if filter_mask is not None and filter_mask.dim() != 1:
        return False
    if cap < 131072:
        return False
    if choice == "pallas":
        return True
    return corpus.is_cuda


# a device's total memory, read once: the survivor budget's base
_TOTAL_MEMORY: Dict[torch.device, int] = {}


def _memory_limit(device: torch.device) -> int:
    if device.type != "cuda":
        return _DEFAULT_MEMORY_LIMIT
    total = _TOTAL_MEMORY.get(device)
    if total is None:
        total = _TOTAL_MEMORY[device] = torch.cuda.mem_get_info(device)[1]
    return total


class FusedPlan(NamedTuple):
    """The host's choices that shape a fused launch's work, besides B, k
    and the metric: the mirror K1 (int8) or K2 (bf16) scans, the int8
    survivor span, the coarse factor, the rows the bias covers (the
    capacity padded to the scan's quantum) and the rows of one coarse block
    (the survivor budget's split)."""

    int8: bool
    span: int
    coarse_factor: int
    n: int
    block_rows: int


def fused_plan(
    b: int,
    corpus: torch.Tensor,
    corpus_lp: Optional[torch.Tensor],
    corpus_i8: Optional[torch.Tensor],
    block_rows: int = 262144,
    coarse_factor: Optional[int] = None,
    span: Optional[int] = None,
) -> FusedPlan:
    """``flat_topk_fused``'s plan for ``b`` queries: host arithmetic alone
    (the device's total memory is read once), so it can be made outside a
    CUDA graph's capture and key the graph."""
    cap = corpus.shape[0]
    use_i8 = corpus_i8 is not None
    if not use_i8 and corpus_lp is None:
        raise ValueError("flat_topk_fused needs corpus_lp or corpus_i8")
    if coarse_factor is None:
        # measured frontier points of the JAX package (ops/topk.py there)
        if use_i8:
            if cap >= 4_000_000:
                coarse_factor = 8
            elif cap >= 1_048_576:
                coarse_factor = 4
            else:
                coarse_factor = 5
        else:
            coarse_factor = 3
    if use_i8:
        if span is None:
            # survivor width >= ~1k columns: span 8 from 1M rows, 4 from
            # 512k, 1 below (the JAX package's measured choice)
            if cap >= 1_048_576:
                span = 8
            elif cap >= 524_288:
                span = 4
            else:
                span = 1
        quantum = bs.GROUP * span
    else:
        span = 1
        quantum = bs.GROUP
    n = cap + (-cap % quantum)
    block_rows = bs.round_up(block_rows, quantum)

    # One block is fastest, but the survivors of a block take B * width/128
    # * 8 bytes; shrink the block to the largest quantum-aligned divisor of
    # n that fits beside the resident mirrors in 70% of device memory.
    resident = corpus.nbytes
    if corpus_lp is not None:
        resident += corpus_lp.nbytes
    if use_i8:
        resident += corpus_i8.nbytes
    surv_budget = max(1 << 30,
                      int(_memory_limit(corpus.device) * 0.70) - resident)
    bs_rows = min(block_rows, n)

    def _surv_bytes(width):
        return b * (width // (bs.BUCKET * span)) * 8

    if _surv_bytes(bs_rows) > surv_budget or n % bs_rows:
        m = 2
        while not (
            n % m == 0
            and (n // m) % quantum == 0
            and n // m <= max(bs_rows, quantum)
            and _surv_bytes(n // m) <= surv_budget
        ):
            m += 1
            if m > n // quantum:
                raise ValueError(
                    f"no survivor-budget block split for n={n}, B={b}")
        bs_rows = n // m
    return FusedPlan(use_i8, span, coarse_factor, n, bs_rows)


def flat_topk_fused(
    queries: torch.Tensor,
    corpus: torch.Tensor,      # fp32 [cap, d]
    corpus_lp: Optional[torch.Tensor],  # bf16 [cap, d]; None when int8 serves
    k: int,
    metric: str = "l2",
    corpus_sq: Optional[torch.Tensor] = None,
    invalid: Optional[torch.Tensor] = None,
    filter_mask: Optional[torch.Tensor] = None,  # 1-D only (shared prefilter)
    block_rows: int = 262144,
    coarse_factor: Optional[int] = None,
    corpus_i8: Optional[torch.Tensor] = None,  # int8 [cap, d] mirror
    i8_scale: Optional[torch.Tensor] = None,   # f32 scalar corpus quant scale
    span: Optional[int] = None,  # int8 survivor granularity (None = auto)
    plan: Optional[FusedPlan] = None,  # made by the caller: the three above
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two-stage k-NN with the coarse scan fused into K1 (int8 mirror) or K2
    (bf16 mirror): one survivor key per bucket, an exact top-k of
    coarse_factor*k survivors, then the exact fp32 rescore.

    The constants that change results (coarse_factor, span, the layout) are
    the JAX package's, so both return the same candidates. ``plan``
    (``fused_plan``) takes the place of ``block_rows``, ``coarse_factor``
    and ``span``; past it the launch enqueues device work alone, with no
    host copy or synchronisation, so a CUDA graph can capture it."""
    cap, d = corpus.shape
    b = queries.shape[0]
    dev = corpus.device
    launch = CTX.launch
    if filter_mask is not None and filter_mask.dim() != 1:
        raise ValueError("flat_topk_fused needs a 1-D filter mask")
    if plan is None:
        t_plan = clock() if launch else 0
        plan = fused_plan(b, corpus, corpus_lp, corpus_i8, block_rows,
                          coarse_factor, span)
        if t_plan:
            TRACE.record(SPAN["topk.plan"], t_plan, clock(), CTX.rid, launch,
                         plan.block_rows)
    use_i8, span, coarse_factor, n, block_rows = plan
    if metric == "l2" and corpus_sq is None:
        corpus_sq = dist_ops.squared_norms(
            corpus_lp if corpus_lp is not None else corpus)
    queries = queries.to(torch.float32)
    alpha = -2.0 if metric == "l2" else -1.0
    positive = metric == "l2"
    kc = min(coarse_factor * k, cap)
    d_pad = bs.round_up(d, 128)   # the layout constants' dim
    # K1 reads 16-byte row pieces; K2's TMA boxes need only 16-byte rows
    # and zero-fill the k-step themselves, so a bf16 corpus at d % 8 == 0
    # is scanned in place
    pad_d = -d % (16 if use_i8 else 8)

    t_inputs = clock() if launch else 0
    if use_i8:
        if i8_scale is None:
            raise ValueError("corpus_i8 needs i8_scale")
        # per-batch global query scale, in f32 in the JAX package's order
        sq = torch.clamp_min(queries.abs().max() / 127.0, 1e-30)
        q_scan = torch.clamp(torch.round(queries / sq), -127, 127).to(torch.int8)
        inv_two = 1.0 / (2.0 * sq * i8_scale.to(torch.float32))
        bias = bs.make_bias_i8_packed(
            cap, d_pad, span, metric, corpus_sq, inv_two, invalid,
            filter_mask,
        )
        _, _, sentinel, pre_shift, invalid_thresh = bs.i8_packed_layout(
            d_pad, span)
        cb = bs.chunk_bits(span)
        bias = torch.nn.functional.pad(bias, (0, n - cap), value=sentinel)
        c_scan = corpus_i8
    else:
        q_scan = (queries * alpha).to(torch.bfloat16)
        qsq = (dist_ops.squared_norms(queries) if positive
               else torch.zeros(b, dtype=torch.float32, device=dev))
        bias = bs.make_bias(cap, metric, corpus_sq, invalid, filter_mask,
                            device=dev)
        bias = torch.nn.functional.pad(bias, (0, n - cap), value=INF)
        c_scan = corpus_lp
    if pad_d:
        q_scan = torch.nn.functional.pad(q_scan, (0, pad_d))
        c_scan = torch.nn.functional.pad(c_scan, (0, pad_d))
    q_scan = q_scan.contiguous()
    if t_inputs:
        TRACE.record(SPAN["topk.bias"], t_inputs, clock(), CTX.rid, launch, n)

    def coarse_block(row0: int):
        c_blk = c_scan[row0:min(row0 + block_rows, cap)]
        bias_blk = bias[row0:row0 + block_rows]
        if use_i8:
            packed = bs.bucket_min_scan_i8_packed(q_scan, c_blk, bias_blk,
                                                  span)
            t_select = clock() if launch else 0
            # keys are >= 0 and unique per column: the selected values ARE
            # the keys, decoded to (score, row)
            key, pos = topk_smallest(packed, min(kc, packed.shape[-1]))
            chunk = key & (span * bs.BUCKET - 1)
            score = (key >> cb) << pre_shift
            bi = (row0 + (pos // bs.BUCKET) * (span * bs.GROUP)
                  + chunk * bs.BUCKET + pos % bs.BUCKET)
            bad = score > invalid_thresh
            bd = torch.where(bad, INF, score.to(torch.float32))
            bi = torch.where(bad, INVALID_ID, bi)
        else:
            vals, idx = bs.bucket_min_scan(q_scan, qsq, c_blk, bias_blk,
                                           positive)
            t_select = clock() if launch else 0
            bd, pos = topk_smallest(vals, min(kc, vals.shape[-1]))
            bi = idx.gather(-1, pos) + row0
            bi = torch.where(torch.isinf(bd), INVALID_ID, bi)
        bi = bi.to(torch.int32)
        if t_select:
            TRACE.record(SPAN["topk.select"], t_select, clock(), CTX.rid,
                         launch)
        return bd, bi

    if n <= block_rows:
        cd, ci = coarse_block(0)
    else:
        kk = min(kc, block_rows // (bs.BUCKET * span))
        cd = torch.full((b, kk), INF, dtype=torch.float32, device=dev)
        ci = torch.full((b, kk), INVALID_ID, dtype=torch.int32, device=dev)
        for row0 in range(0, n, block_rows):
            bd, bi = coarse_block(row0)
            t_merge = clock() if launch else 0
            cd, ci = merge_topk(cd, ci, bd, bi, bd.shape[-1])
            if t_merge:
                TRACE.record(SPAN["topk.select"], t_merge, clock(), CTX.rid,
                             launch)
    ci = torch.where(ci >= cap, INVALID_ID, ci)  # padded corpus rows
    return _rescore_exact(queries, corpus, ci, cd, k=k, metric=metric)


def flat_topk(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    k: int,
    metric: str = "l2",
    corpus_sq: Optional[torch.Tensor] = None,
    invalid: Optional[torch.Tensor] = None,
    filter_mask: Optional[torch.Tensor] = None,
    block_rows: int = 131072,
    mode: str = "exact",
    approx_over_retrieve: int = 2,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact k-NN of ``queries`` [B, d] over ``corpus`` [cap, d].

    ``invalid``: optional bool [cap] of rows never returned; ``filter_mask``:
    optional bool [cap] or [B, cap] of rows a pre-filter allows. The corpus
    is scored ``block_rows`` rows at a time with a running top-k; cap must
    be a multiple of it once cap > block_rows. ``mode`` "approx"
    over-retrieves ``approx_over_retrieve * k`` per block before the exact
    trim, like the JAX package; selection itself is always exact here.

    Returns (dists [B, k] f32, ids [B, k] int32) ascending; empty slots are
    (+inf, -1)."""
    cap = corpus.shape[0]
    b = queries.shape[0]
    # bf16 queries against a bf16 corpus (the two-stage coarse pass)
    qdt = torch.bfloat16 if corpus.dtype == torch.bfloat16 else torch.float32
    queries = queries.to(qdt)
    if metric == "l2" and corpus_sq is None:
        corpus_sq = dist_ops.squared_norms(corpus)

    def score_block(row0: int, rows: int):
        sl = slice(row0, row0 + rows)
        s = dist_ops.pairwise_scores(
            queries, corpus[sl], metric=metric,
            corpus_sq=None if corpus_sq is None else corpus_sq[sl],
        )
        if invalid is not None:
            s = torch.where(invalid[sl][None, :], INF, s)
        if filter_mask is not None:
            fm = filter_mask[:, sl] if filter_mask.dim() == 2 \
                else filter_mask[sl][None, :]
            s = torch.where(fm, s, INF)
        if mode == "approx" and rows > 1024:
            kk = min(approx_over_retrieve * k, rows)
        else:
            kk = min(k, rows)
        d, pos = topk_smallest(s, kk)
        ids = torch.where(torch.isinf(d), INVALID_ID, pos + row0)
        return _pad_k(d, ids.to(torch.int32), k)

    if cap <= block_rows:
        d, ids = score_block(0, cap)
        if d.shape[-1] > k:  # over-retrieval: exact trim to k
            d, pos = topk_smallest(d, k)
            ids = ids.gather(-1, pos)
        return d, ids

    if cap % block_rows:
        raise ValueError(
            f"capacity {cap} not divisible by block_rows {block_rows}")
    run_d = torch.full((b, k), INF, dtype=torch.float32,
                       device=corpus.device)
    run_i = torch.full((b, k), INVALID_ID, dtype=torch.int32,
                       device=corpus.device)
    for row0 in range(0, cap, block_rows):
        bd, bi = score_block(row0, block_rows)
        run_d, run_i = merge_topk(run_d, run_i, bd, bi, k)
    return run_d, run_i
