"""IVF coarse-pruned k-NN on a torch device: the sub-linear path for large corpora.

Counterpart of valkey_search_tpu/ops/ivf.py. The corpus is laid out
cluster-major (k-means coarse clusters, a second k-means level inside each,
a principal-axis sort within a cell) and cut into S-row blocks, each with its
own mini-centroid and a per-block int8 residual code. A search scores every
query against all block centroids (stage 1), takes the ``probe`` best blocks
and scores their rows (stage 2):

- ``_ivf_search_batch_grouped`` (many queries per block): (query, block)
  pairs sorted by block and packed into capacity-G segments, one batched
  product per segment, each selected block read once;
- ``_ivf_search_batch_steps`` (about one query per block): a per-query
  gather of ``probe_chunk`` blocks at a time with a running top-k.

Distances decompose exactly (x = c + r): |q - x|^2 = |q|^2 - 2 q.c - 2 q.r +
|recon|^2 and q.x = q.c + q.r, with q.c in f32 and only q.r through int8.
``ivf_search_rescored`` over-retrieves and rescores in fp32 against the
resident corpus, as the engine does.

What differs from the JAX package, and why:

- Products of bf16 operands. Inside the JAX package's jitted functions
  XLA's CPU backend keeps the f32 result of a bf16 product: a bf16 dot whose
  output is cast to f32 is not rounded to bf16 first (an eager bf16 dot
  is). So the port widens both operands, already rounded to bf16, to f32
  and multiplies in f32 with TF32 off (``runtime/device.py``); int8 codes
  and bf16 queries are exact in f32.
- Random draws. ``jax.random`` has no torch counterpart, so builds seed a
  ``torch.Generator`` from ``seed``: both packages build valid indexes, not
  equal ones. ``refine_oversized`` draws from numpy, as the JAX package does.
- Selections are exact (``topk_smallest``: ascending, ties to the lower
  index), where the JAX package calls ``lax.approx_min_k`` (exact on its CPU
  path).
- Centroid sums use ``index_add_``; on the card float atomics sum in an
  order that changes from run to run, so centroids may differ in their last
  bits between runs.
- Working sets are chunked from the device's free memory
  (``torch.cuda.mem_get_info``), not from the JAX package's 16 GiB residency
  model (``ivf_build_plan``, not ported), and the build has no per-chunk host
  syncs (they bounded in-flight XLA buffers).
- Kept on purpose: ``plan_blocks``' padding (pow2 block counts up to 4,096
  blocks, multiples of 1,024 above). The block count sets ``default_probe``
  and the grouped/steps routing, so it changes results.

Each stage of a search runs inside a ``torch.profiler`` range
(``ivf.stage1``, ``ivf.dispatch``, ``ivf.gather``, ``ivf.product``,
``ivf.topk``, ``ivf.rescore``, ``ivf.overlay``), so a profile splits a
search's device time by stage.

The tier beyond device memory (``build_ivf_streaming``,
``ivf_search_rescored_streaming``) reads the corpus from a deterministic
chunk source, pass after pass, and never holds it whole. Torch frees a
chunk when its last reference drops, so the JAX package's per-chunk
syncs, jitted fills and donated reshapes have no counterpart.
"""

from __future__ import annotations

import time
from typing import (Callable, Dict, Iterable, Mapping, NamedTuple, Optional,
                    Tuple, Union)

import numpy as np
import torch
from torch.profiler import record_function

from valkey_search_tpu_torch.ops import distance as dist_ops
from valkey_search_tpu_torch.ops.topk import (_pad_k, _rescore_exact,
                                             topk_smallest)
from valkey_search_tpu_torch.runtime.device import get_device
from valkey_search_tpu_torch.runtime.metrics import STATS

INF = float("inf")
# bytes one chunk of a stage's temporaries may take on the CPU; on a CUDA
# device a quarter of what is free (_work_bytes)
_CPU_WORK_BYTES = 1 << 28


class IvfIndex(NamedTuple):
    """Device-resident IVF index (immutable once published); the field
    names of the JAX package's IvfDeviceIndex.

    centroids   [nb, d]    f32 block mini-centroids
    cent_sq     [nb]       f32 centroid squared norms
    block_valid [nb]       bool, False for padding blocks
    blocks_i8   [nb, S, d] int8 residual codes ((row - centroid) / scale)
    block_scale [nb]       f32 per-block dequantization scale
    row_sq      [nb, S]    f32 |reconstruction|^2 (see quantize_blocks)
    block_ids   [nb, S]    int32 row ids, -1 padding
    """

    centroids: torch.Tensor
    cent_sq: torch.Tensor
    block_valid: torch.Tensor
    blocks_i8: torch.Tensor
    block_scale: torch.Tensor
    row_sq: torch.Tensor
    block_ids: torch.Tensor

    @property
    def n_blocks(self) -> int:
        return self.blocks_i8.shape[0]

    @property
    def block_rows(self) -> int:
        return self.blocks_i8.shape[1]

    def device_bytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self)


def ivf_from_reference(arrays: Mapping[str, np.ndarray],
                       device: Optional[torch.device] = None) -> IvfIndex:
    """The JAX package's IvfDeviceIndex on ``device``: ``arrays`` maps each
    of its seven field names to the field as a numpy array."""
    dev = torch.device(device) if device is not None else get_device()
    return IvfIndex(*(torch.from_numpy(np.array(arrays[name])).to(dev)
                      for name in IvfIndex._fields))


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to bf16, widened back to f32 (exact)."""
    return x.to(torch.bfloat16).to(torch.float32)


def _generator(seed: int, device: torch.device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed))


def _work_bytes(device: torch.device) -> int:
    """Bytes one chunk of temporaries may take: a quarter of the device's
    free memory (the caching allocator's idle blocks counted as free)."""
    if device.type != "cuda":
        return _CPU_WORK_BYTES
    free = torch.cuda.mem_get_info(device)[0]
    idle = (torch.cuda.memory_reserved(device)
            - torch.cuda.memory_allocated(device))
    return int((free + idle) * 0.25)


def _chunk(per_item_bytes: int, device: torch.device) -> int:
    return max(1, _work_bytes(device) // max(1, int(per_item_bytes)))


class _StageClock:
    """Adds the seconds since the last mark to ``timings[name]``,
    synchronising a CUDA device first (no-op without ``timings``)."""

    def __init__(self, device: torch.device,
                 timings: Optional[Dict[str, float]]):
        self.device = device
        self.timings = timings
        self.t = time.perf_counter()

    def __call__(self, name: str) -> None:
        if self.timings is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.timings[name] = self.timings.get(name, 0.0) + now - self.t
        self.t = now


# --------------------------------------------------------------------------
# k-means
# --------------------------------------------------------------------------


def kmeans_fit(
    x: torch.Tensor,
    n_clusters: int,
    iters: int = 12,
    seed: int = 0,
    valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Lloyd's on ``x``'s device: assignment by one product + argmin,
    update by ``index_add_``. Empty clusters keep their centroid; ``valid``
    masks rows out of seeding and of the update. Returns [n_clusters, d]
    f32."""
    n = x.shape[0]
    dev = x.device
    x = x.to(torch.float32)
    gen = _generator(seed, dev)
    if valid is None:
        perm = torch.randperm(n, generator=gen, device=dev)
    else:
        # random order among valid rows first
        u = torch.rand(n, generator=gen, device=dev) + torch.where(
            valid, 0.0, 1e9)
        perm = torch.argsort(u, stable=True)
    return _lloyd(x, x[perm[:n_clusters]], valid, iters)


def _lloyd(x: torch.Tensor, cent: torch.Tensor,
           valid: Optional[torch.Tensor], iters: int) -> torch.Tensor:
    """``iters`` Lloyd's iterations of ``kmeans_fit`` from the seeds
    ``cent`` [k, d]."""
    n, d = x.shape
    n_clusters = cent.shape[0]
    dev = x.device
    # the [chunk, k] f32 dots stay ~512 MB
    chunk = max(1, min(n, (1 << 27) // max(1, n_clusters)))
    w = (torch.ones((n, 1), dtype=torch.float32, device=dev) if valid is None
         else valid.to(torch.float32)[:, None])
    xbf = _bf16(x)
    xw = x * w
    for _ in range(iters):
        csq = (cent * cent).sum(1)
        centbf = _bf16(cent).T
        sums = torch.zeros((n_clusters, d), dtype=torch.float32, device=dev)
        cnt = torch.zeros((n_clusters, 1), dtype=torch.float32, device=dev)
        for s in range(0, n, chunk):
            dots = xbf[s:s + chunk] @ centbf
            a = torch.argmin(csq[None, :] - 2.0 * dots, dim=1)
            sums.index_add_(0, a, xw[s:s + chunk])
            cnt.index_add_(0, a, w[s:s + chunk])
        cent = torch.where(cnt > 0, sums / cnt.clamp_min(1.0), cent)
    return cent


def kmeans_fit_batched(
    x: torch.Tensor,       # [C, R, d] f32 per-cluster row tables (0-padded)
    valid: torch.Tensor,   # [C, R] bool
    k_each: int,           # centroids per cluster (shared max; mask after)
    iters: int = 8,
    seed: int = 0,
) -> torch.Tensor:
    """Lloyd's for C independent k-means problems at once (batched
    products, a one-hot update). Returns [C, k_each, d] f32."""
    x = x.to(torch.float32)
    gen = _generator(seed, x.device)
    # per cluster, random valid rows as seeds
    u = torch.rand(valid.shape, generator=gen, device=x.device) + torch.where(
        valid, 0.0, 1e9)
    seed_pos = torch.argsort(u, dim=1, stable=True)[:, :k_each]     # [C, k]
    cent = torch.gather(x, 1, seed_pos[:, :, None].expand(-1, -1, x.shape[2]))
    return _lloyd_batched(x, cent, valid, iters)


def _lloyd_batched(x: torch.Tensor, cent: torch.Tensor, valid: torch.Tensor,
                   iters: int) -> torch.Tensor:
    """``iters`` iterations of ``kmeans_fit_batched`` from the seeds
    ``cent`` [C, k, d]."""
    k_each = cent.shape[1]
    w = valid.to(torch.float32)
    xbf = _bf16(x)
    for _ in range(iters):
        csq = (cent * cent).sum(2)                                   # [C, k]
        dots = torch.bmm(xbf, _bf16(cent).transpose(1, 2))           # [C, R, k]
        a = torch.argmin(csq[:, None, :] - 2.0 * dots, dim=2)        # [C, R]
        # the one-hot carries the validity weight
        oh = torch.nn.functional.one_hot(a, k_each).to(torch.float32) \
            * w[:, :, None]
        sums = torch.bmm(oh.transpose(1, 2), x)                      # [C, k, d]
        cnt = oh.sum(1)                                              # [C, k]
        cent = torch.where(cnt[:, :, None] > 0,
                           sums / cnt.clamp_min(1.0)[:, :, None], cent)
    return cent


def _assign_chunk(xc: torch.Tensor, cent: torch.Tensor) -> torch.Tensor:
    csq = (cent * cent).sum(1)
    dots = _bf16(xc) @ _bf16(cent).T
    return torch.argmin(csq[None, :] - 2.0 * dots, dim=1).to(torch.int32)


def assign_clusters(
    chunks: Union[np.ndarray, Iterable[np.ndarray]],
    cent: torch.Tensor,
    chunk_rows: int = 262144,
) -> np.ndarray:
    """Nearest-centroid assignment of host rows (chunked uploads, device
    products). ``chunks`` is the full [N, d] array or an iterable of row
    chunks."""
    # the [chunk, k] f32 dots stay ~512 MB
    chunk_rows = max(
        1024, min(chunk_rows, (1 << 27) // max(1, int(cent.shape[0]))))
    if isinstance(chunks, np.ndarray):
        n = chunks.shape[0]
        it = (chunks[s:min(s + chunk_rows, n)] for s in range(0, n, chunk_rows))
    else:
        it = chunks
    out = []
    for xc in it:
        xc = torch.from_numpy(np.ascontiguousarray(xc, np.float32)).to(
            cent.device)
        out.append(_assign_chunk(xc, cent).cpu().numpy())
    return np.concatenate(out) if out else np.empty(0, np.int32)


# --------------------------------------------------------------------------
# layout
# --------------------------------------------------------------------------


def _pow2_at_least(v: int) -> int:
    p = 1
    while p < v:
        p *= 2
    return p


def plan_blocks(
    assign: np.ndarray, order: np.ndarray, block_rows: int,
    block_align: int = 0,
) -> Tuple[np.ndarray, int, int]:
    """Map each row (in cluster-major ``order``) to its slot in the flat
    [nb_pad * S] block layout: each cluster takes ceil(size/S) whole
    blocks, tails pad with -1 rows. Returns (pos [N], nb, nb_pad).

    block_align 0 pads the block count to a power of two, > 0 to a multiple
    of it (large one-shot builds: pow2 would waste up to 2x the codes)."""
    s = block_rows
    n_clusters = int(assign.max()) + 1 if len(assign) else 1
    sizes = np.bincount(assign, minlength=n_clusters)
    nblk = -(-sizes // s)  # ceil
    nb = int(nblk.sum())
    if block_align > 0:
        nb_pad = -(-nb // block_align) * block_align
    else:
        nb_pad = _pow2_at_least(max(nb, 1))
    base_blk = np.zeros(n_clusters + 1, np.int64)
    np.cumsum(nblk, out=base_blk[1:])
    cluster_start = np.zeros(n_clusters + 1, np.int64)
    np.cumsum(sizes, out=cluster_start[1:])
    a_sorted = assign[order]
    within = np.arange(len(order), dtype=np.int64) - cluster_start[a_sorted]
    pos = base_blk[a_sorted] * s + within
    return pos, nb, nb_pad


def principal_axis(sample: np.ndarray) -> np.ndarray:
    """First principal component of a row sample (host: the d x d
    covariance's eigendecomposition); sorts rows within a cell so blocks are
    spatially coherent slabs."""
    x = np.asarray(sample, np.float32)
    x = x - x.mean(axis=0, keepdims=True)
    cov = (x.T @ x) / max(1, x.shape[0] - 1)
    w, v = np.linalg.eigh(cov)
    return np.ascontiguousarray(v[:, -1], np.float32)


# --------------------------------------------------------------------------
# quantization
# --------------------------------------------------------------------------


def quantize_blocks(
    block_vecs: torch.Tensor, block_ids: torch.Tensor
) -> Tuple[torch.Tensor, ...]:
    """Residual-quantize a chunk of blocks: block_vecs [nbc, S, d] f32
    (invalid rows zero), block_ids [nbc, S]. Returns (blocks_i8, centroids,
    cent_sq, block_scale, row_sq, valid)."""
    valid = block_ids >= 0                                    # [nbc, S]
    vf = valid.to(torch.float32)
    cnt = vf.sum(1).clamp_min(1.0)                            # [nbc]
    cent = torch.einsum("bsd,bs->bd", block_vecs, vf) / cnt[:, None]
    resid = torch.where(valid[:, :, None], block_vecs - cent[:, None, :], 0.0)
    amax = resid.abs().amax(dim=(1, 2))                       # [nbc]
    scale = amax.clamp_min(1e-30) / 127.0
    codes = torch.clamp(torch.round(resid / scale[:, None, None]),
                        -127, 127).to(torch.int8)
    # |recon|^2, not |row|^2: the l2 score is then exactly the distance to
    # the reconstructed point (the row norm would add a per-row bias
    # ~2|row|.err that scrambles ranking)
    recon = cent[:, None, :] + codes.to(torch.float32) * scale[:, None, None]
    row_sq = (recon * recon).sum(2)                           # [nbc, S]
    return (codes, cent, (cent * cent).sum(1), scale.to(torch.float32),
            row_sq, valid.any(1))


def _default_chunk_blocks(s: int, d: int) -> int:
    return _pow2_at_least(max(1, (1 << 26) // max(1, s * d * 4)))


def finalize_blocks(
    block_vecs: np.ndarray, block_ids: np.ndarray, chunk_blocks: int = 0,
    host_quantize: bool = False, device: Optional[torch.device] = None,
) -> IvfIndex:
    """The published index from laid-out fp32 blocks [nb, S, d] and their
    ids [nb, S]: quantized on ``device`` in chunks, or (host_quantize) in
    chunked numpy with only the final arrays uploaded."""
    dev = torch.device(device) if device is not None else get_device()
    nb, s, d = block_vecs.shape
    if chunk_blocks <= 0:
        chunk_blocks = _default_chunk_blocks(s, d)
    if host_quantize:
        codes_h = np.empty((nb, s, d), np.int8)
        cent_h = np.empty((nb, d), np.float32)
        scale_h = np.empty(nb, np.float32)
        rowsq_h = np.empty((nb, s), np.float32)
        valid_h = np.empty(nb, bool)
        for st in range(0, nb, chunk_blocks):
            en = min(st + chunk_blocks, nb)
            bv = block_vecs[st:en]
            ids = block_ids[st:en]
            vmask = ids >= 0
            cnt = np.maximum(vmask.sum(axis=1), 1)[:, None]
            cent = np.einsum("bsd,bs->bd", bv, vmask.astype(np.float32)) / cnt
            resid = np.where(vmask[:, :, None], bv - cent[:, None, :], 0.0)
            amax = np.abs(resid).max(axis=(1, 2))
            scale = np.maximum(amax, 1e-30) / 127.0
            codes = np.clip(
                np.round(resid / scale[:, None, None]), -127, 127
            ).astype(np.int8)
            recon = cent[:, None, :] + codes * scale[:, None, None]
            codes_h[st:en] = codes
            cent_h[st:en] = cent
            scale_h[st:en] = scale
            rowsq_h[st:en] = np.einsum("bsd,bsd->bs", recon, recon)
            valid_h[st:en] = vmask.any(axis=1)
        host = (cent_h, np.einsum("bd,bd->b", cent_h, cent_h), valid_h,
                codes_h, scale_h, rowsq_h, np.asarray(block_ids, np.int32))
        return IvfIndex(*(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                          for a in host))
    parts = [[] for _ in range(6)]
    for st in range(0, nb, chunk_blocks):
        en = min(st + chunk_blocks, nb)
        out = quantize_blocks(
            torch.from_numpy(np.ascontiguousarray(block_vecs[st:en],
                                                  np.float32)).to(dev),
            torch.from_numpy(np.ascontiguousarray(block_ids[st:en])).to(dev))
        for lst, arr in zip(parts, out):
            lst.append(arr)
    codes, cent, cent_sq, scale, row_sq, valid = (torch.cat(p) for p in parts)
    return IvfIndex(
        centroids=cent, cent_sq=cent_sq, block_valid=valid, blocks_i8=codes,
        block_scale=scale, row_sq=row_sq,
        block_ids=torch.from_numpy(
            np.ascontiguousarray(block_ids, np.int32)).to(dev),
    )


# --------------------------------------------------------------------------
# two-level fit
# --------------------------------------------------------------------------


def _assign_chunk2(
    xc: torch.Tensor,          # [n, d] f32
    a1: torch.Tensor,          # [n] level-1 assignment
    cents2: torch.Tensor,      # [C1, c2max, d] f32 level-2 centroid table
    c2_valid: torch.Tensor,    # [C1, c2max] bool
) -> torch.Tensor:
    """Second-level assignment: each row scores only its own cluster's
    level-2 centroids."""
    a1 = a1.long()
    ssq = (cents2 * cents2).sum(2)[a1]                        # [n, c2max]
    sub = _bf16(cents2)[a1]                                   # [n, c2max, d]
    dots = torch.bmm(sub, _bf16(xc)[:, :, None])[:, :, 0]
    dd = torch.where(c2_valid[a1], ssq - 2.0 * dots, INF)
    return torch.argmin(dd, dim=1).to(torch.int32)


def _cluster_row_tables(
    rows_src: np.ndarray, a: np.ndarray, n_clusters: int, r_max: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Up to ``r_max`` rows per cluster in a padded [C, r_max, d] table
    (host). Returns (tables, valid, sizes)."""
    order = np.argsort(a, kind="stable")
    a_sorted = a[order]
    sizes = np.bincount(a, minlength=n_clusters)
    starts = np.zeros(n_clusters + 1, np.int64)
    np.cumsum(sizes, out=starts[1:])
    rank = np.arange(len(a), dtype=np.int64) - starts[a_sorted]
    keep = rank < r_max
    tables = np.zeros((n_clusters, r_max, rows_src.shape[1]), np.float32)
    valid = np.zeros((n_clusters, r_max), bool)
    tables[a_sorted[keep], rank[keep]] = rows_src[order[keep]]
    valid[a_sorted[keep], rank[keep]] = True
    return tables, valid, sizes


def _assign_sample_device(
    sample_d: torch.Tensor, cent1: torch.Tensor, n_clusters: int
) -> np.ndarray:
    """Level-1 assignment of a device-resident sample; only the int32
    assignments come to the host."""
    n = int(sample_d.shape[0])
    chunk = int(np.clip((1 << 27) // max(n_clusters, 1), 4096, 262144))
    out = [_assign_chunk(sample_d[st:st + chunk].to(torch.float32), cent1)
           for st in range(0, n, chunk)]
    return torch.cat(out).cpu().numpy()


def principal_axis_device(sample_d: torch.Tensor) -> torch.Tensor:
    """principal_axis of a device-resident sample: only the d x d
    covariance comes to the host."""
    x = sample_d.to(torch.float32)
    x = x - x.mean(dim=0, keepdim=True)
    cov = (x.T @ x).cpu().numpy().astype(np.float64)
    _, v = np.linalg.eigh(cov)
    return torch.from_numpy(np.ascontiguousarray(v[:, -1], np.float32)).to(
        sample_d.device)


def _fit_two_level_device(
    sample_d: torch.Tensor,
    n_clusters: int,
    block_rows: int,
    est_total: int,
    *,
    kmeans_iters: int,
    seed: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, int]:
    """The two-level coarse quantizer fit from a device-resident sample:
    level-1 k-means, per-cluster level-2 tables scattered on the device, one
    batched level-2 fit, the thin-cluster fallback to level 1, and the
    principal axis. Returns (cent1, cents2, c2_valid, pc1, c2max)."""
    dev = sample_d.device
    n_s, d = int(sample_d.shape[0]), int(sample_d.shape[1])
    s = int(block_rows)
    cent1 = kmeans_fit(sample_d, n_clusters, iters=kmeans_iters, seed=seed)
    a1s = _assign_sample_device(sample_d, cent1, n_clusters)
    sizes_s = np.bincount(a1s, minlength=n_clusters)
    r_max = _pow2_at_least(min(4096, max(int(sizes_s.max()), 1)))
    while n_clusters * r_max * d * 4 > (768 << 20) and r_max > 256:
        r_max //= 2  # the [C, r_max, d] fit table stays ~768 MB
    order = np.argsort(a1s, kind="stable")
    a_sorted = a1s[order]
    starts = np.zeros(n_clusters + 1, np.int64)
    np.cumsum(sizes_s, out=starts[1:])
    rank = np.arange(n_s, dtype=np.int64) - starts[a_sorted]
    keep = rank < r_max
    tables = torch.zeros((n_clusters * r_max, d), dtype=torch.float32,
                         device=dev)
    slot = torch.from_numpy(a_sorted[keep].astype(np.int64) * r_max
                            + rank[keep]).to(dev)
    tables[slot] = sample_d[torch.from_numpy(order[keep]).to(dev)].to(
        torch.float32)
    tables = tables.reshape(n_clusters, r_max, d)
    valid = np.zeros((n_clusters, r_max), bool)
    valid[a_sorted[keep], rank[keep]] = True
    est = sizes_s * (est_total / max(1, n_s))
    c2 = np.maximum(1, -(-est.astype(np.int64) // s))
    c2 = np.minimum(c2, np.maximum(sizes_s, 1))
    c2max = int(_pow2_at_least(int(c2.max())))
    cents2 = kmeans_fit_batched(
        tables, torch.from_numpy(valid).to(dev), c2max,
        iters=max(4, kmeans_iters // 2), seed=seed,
    )
    del tables
    # a cluster the sample barely saw falls back to its level-1 centroid
    thin = torch.from_numpy(sizes_s < 2).to(dev)
    cents2[:, 0, :] = torch.where(thin[:, None], cent1, cents2[:, 0, :])
    c2_valid = torch.from_numpy(np.arange(c2max)[None, :] < c2[:, None]).to(
        dev)
    pc1 = principal_axis_device(sample_d)
    return cent1, cents2, c2_valid, pc1, c2max


def _two_level_pass(
    vectors: np.ndarray,
    rows_idx: Optional[np.ndarray],
    a1_of_rows: np.ndarray,
    cents2: torch.Tensor,
    c2_valid: torch.Tensor,
    chunk_rows: int,
) -> np.ndarray:
    """Chunked level-2 assignment of (a subset of) host rows. Returns the
    per-row sub-cell index."""
    dev = cents2.device
    n_rows = len(a1_of_rows)
    out = np.empty(n_rows, np.int32)
    for st in range(0, n_rows, chunk_rows):
        en = min(st + chunk_rows, n_rows)
        idx = slice(st, en) if rows_idx is None else rows_idx[st:en]
        xc = torch.from_numpy(np.ascontiguousarray(vectors[idx],
                                                   np.float32)).to(dev)
        a1c = torch.from_numpy(np.ascontiguousarray(a1_of_rows[st:en])).to(dev)
        out[st:en] = _assign_chunk2(xc, a1c, cents2, c2_valid).cpu().numpy()
    return out


def sample_refined_assign(
    vectors: np.ndarray,
    sample: np.ndarray,
    n_clusters: int,
    block_rows: int,
    *,
    est_total: Optional[int] = None,
    kmeans_iters: int = 12,
    seed: int = 0,
    chunk_rows: int = 0,
    fit_rows_cap: int = 4096,
    device: Optional[torch.device] = None,
) -> np.ndarray:
    """Two-level cell assignment with the level-2 centroids fit from the
    SAMPLE only (no per-cluster gathers over the corpus: the very-large-N
    path). Returns a densely renumbered cell assignment for ``vectors``."""
    dev = torch.device(device) if device is not None else get_device()
    s = block_rows
    n = vectors.shape[0] if est_total is None else est_total
    cent1 = kmeans_fit(torch.from_numpy(np.ascontiguousarray(sample)).to(dev),
                       n_clusters, iters=kmeans_iters, seed=seed)
    a1s = assign_clusters(sample, cent1,
                          chunk_rows=min(max(len(sample), 1), 262144))
    sizes_s = np.bincount(a1s, minlength=n_clusters)
    r_max = _pow2_at_least(min(fit_rows_cap, max(int(sizes_s.max()), 1)))
    d_fit = sample.shape[1]
    while n_clusters * r_max * d_fit * 4 > (768 << 20) and r_max > 256:
        r_max //= 2
    tables, valid, _ = _cluster_row_tables(sample, a1s, n_clusters, r_max)
    est = sizes_s * (n / max(1, len(sample)))
    c2 = np.maximum(1, -(-est.astype(np.int64) // s))
    c2 = np.minimum(c2, np.maximum(sizes_s, 1))  # no more cells than rows
    c2max = int(_pow2_at_least(int(c2.max())))
    cents2 = kmeans_fit_batched(
        torch.from_numpy(tables).to(dev), torch.from_numpy(valid).to(dev),
        c2max, iters=max(4, kmeans_iters // 2), seed=seed,
    )
    thin = torch.from_numpy(sizes_s < 2).to(dev)  # fall back to level 1
    cents2[:, 0, :] = torch.where(thin[:, None], cent1, cents2[:, 0, :])
    c2v = torch.from_numpy(np.arange(c2max)[None, :] < c2[:, None]).to(dev)
    d = vectors.shape[1]
    if chunk_rows <= 0:
        # the [chunk, c2max, d] level-2 gather stays ~1.5 GB
        chunk_rows = int(np.clip((3 << 28) // max(1, c2max * d), 16384,
                                 262144))
        chunk_rows = 1 << (chunk_rows.bit_length() - 1)
    out = np.empty(vectors.shape[0], np.int64)
    for st in range(0, vectors.shape[0], chunk_rows):
        en = min(st + chunk_rows, vectors.shape[0])
        xc = torch.from_numpy(np.ascontiguousarray(vectors[st:en],
                                                   np.float32)).to(dev)
        a1c = _assign_chunk(xc, cent1)
        a2c = _assign_chunk2(xc, a1c, cents2, c2v)
        out[st:en] = (a1c.long() * c2max + a2c).cpu().numpy()
    _, dense = np.unique(out, return_inverse=True)
    return dense.astype(np.int32)


def refine_oversized(
    vectors: np.ndarray,
    assign: np.ndarray,
    *,
    block_rows: int,
    seed: int = 0,
    iters: int = 6,
    max_span_blocks: int = 2,
    fit_rows_cap: int = 8192,
    chunk_rows: int = 32768,
    device: Optional[torch.device] = None,
) -> np.ndarray:
    """Second k-means level: every cluster spanning more than
    ``max_span_blocks`` blocks splits into ~size/S sub-cells, fit from a
    numpy-seeded subsample of its own rows (at most ``fit_rows_cap``), all
    clusters in one batched fit. Returns a densely renumbered assignment."""
    dev = torch.device(device) if device is not None else get_device()
    s = block_rows
    n_clusters = int(assign.max()) + 1 if len(assign) else 0
    sizes = np.bincount(assign, minlength=n_clusters)
    over = np.nonzero(sizes > max_span_blocks * s)[0]
    if not len(over):
        return assign.astype(np.int32)
    comp = np.full(n_clusters, -1, np.int64)
    comp[over] = np.arange(len(over))
    rows_idx = np.nonzero(comp[assign] >= 0)[0]
    a_comp = comp[assign[rows_idx]].astype(np.int32)
    r_max = _pow2_at_least(min(fit_rows_cap, int(sizes[over].max())))
    rng = np.random.default_rng(seed)
    perm = rng.permutation(len(rows_idx))
    tables, valid, _ = _cluster_row_tables(
        vectors[rows_idx[perm]], a_comp[perm], len(over), r_max
    )
    c2 = np.minimum(-(-sizes[over] // s), np.maximum(sizes[over], 1))
    c2max = int(_pow2_at_least(int(c2.max())))
    cents2 = kmeans_fit_batched(
        torch.from_numpy(tables).to(dev), torch.from_numpy(valid).to(dev),
        c2max, iters=iters, seed=seed,
    )
    c2_valid = torch.from_numpy(np.arange(c2max)[None, :] < c2[:, None]).to(
        dev)
    sub = _two_level_pass(vectors, rows_idx, a_comp, cents2, c2_valid,
                          chunk_rows)
    base = np.zeros(len(over) + 1, np.int64)
    np.cumsum(c2, out=base[1:])
    out = assign.astype(np.int64).copy()
    out[rows_idx] = n_clusters + base[a_comp] + sub
    _, dense = np.unique(out, return_inverse=True)
    return dense.astype(np.int32)


def _assign_proj_at(
    xc: torch.Tensor, cent1: torch.Tensor, cents2: torch.Tensor,
    c2_valid: torch.Tensor, pc1: torch.Tensor, c2max: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Level-1 + level-2 assignment (combined a1 * c2max + a2, int64) and
    the principal-axis projection of one chunk of rows."""
    xc = xc.to(torch.float32)
    a1 = _assign_chunk(xc, cent1)
    a2 = _assign_chunk2(xc, a1, cents2, c2_valid)
    return a1.long() * c2max + a2, xc @ pc1


# --------------------------------------------------------------------------
# builds
# --------------------------------------------------------------------------


def _f32_order_key(x: torch.Tensor) -> torch.Tensor:
    """int64 keys in [0, 2^32) ordered as the f32 values ``x`` compare
    (finite values; -0.0 is +0.0 first)."""
    bits = (x.to(torch.float32) + 0.0).view(torch.int32)
    ordered = bits ^ ((bits >> 31) & 0x7FFFFFFF)
    return ordered.to(torch.int64) + (1 << 31)


def _layout_plan(
    assign_d: torch.Tensor, proj_d: torch.Tensor, c2max: int, s: int,
    block_align: int, by_cluster: bool,
    pos_live: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray, int, int]:
    """The block layout of a two-level partition -> (order, pos, nb, nb_pad).

    Rows go cell-major (level 2 within level 1, principal axis within a
    cell): one stable device sort of (assignment, projection), the order of
    the JAX package's np.lexsort((proj, cell)), cell being the dense rank of
    the assignment. ``by_cluster`` pads blocks only at level-1 cluster
    boundaries (``assign // c2max``), else at every cell; empty groups take
    no block in ``plan_blocks``, so the keys need no dense rank. A block may
    then straddle adjacent cells of one cluster; its centroid and scale
    come from its actual members. ``pos_live`` restricts the plan to those
    rows; ``order`` indexes them (or all rows), ``pos`` is the slot of
    ``order``'s rows (``plan_blocks``)."""
    if pos_live is not None:
        live = torch.from_numpy(pos_live).to(assign_d.device)
        assign_d, proj_d = assign_d[live], proj_d[live]
    order = torch.sort((assign_d << 32) | _f32_order_key(proj_d),
                       stable=True).indices.cpu().numpy()
    group = (assign_d // c2max if by_cluster else assign_d).cpu().numpy()
    pos, nb, nb_pad = plan_blocks(group, order, s, block_align=block_align)
    return order, pos, nb, nb_pad


def build_ivf_device(
    dev_vectors: torch.Tensor,
    row_ids: Optional[np.ndarray] = None,
    *,
    present: Optional[np.ndarray] = None,
    block_rows: int = 1024,
    n_clusters: int = 0,
    kmeans_iters: int = 12,
    train_sample: int = 0,
    seed: int = 0x1BF,
    chunk_rows: int = 262144,
    chunk_blocks: int = 0,
    block_align: int = 0,
    timings: Optional[Dict[str, float]] = None,
) -> IvfIndex:
    """An IvfIndex from an already-uploaded [cap, d] mirror on its device.

    The k-means sample, the assignment products, the projection, the block
    gather, the row order (``_layout_plan``) and the quantization run on
    the device; only the O(cap) order and groups come to the host for
    ``plan_blocks``. Rows are addressed by position;
    ``present`` (bool [cap]) masks live rows, ``row_ids`` maps position to
    id (default: identity). ``timings``, when given, gains the seconds of
    each stage: ``sample_fit_s``, ``assign_s``, ``plan_s`` (the row order
    on the device, ``plan_blocks`` on the host) and ``quantize_s``."""
    dev = dev_vectors.device
    clock = _StageClock(dev, timings)
    cap, d = dev_vectors.shape
    s = int(block_rows)
    if row_ids is None:
        row_ids = np.arange(cap, dtype=np.int64)
    row_ids = np.asarray(row_ids, np.int64)
    if present is None:
        pos_live = np.arange(cap, dtype=np.int64)
    else:
        pos_live = np.nonzero(np.asarray(present))[0]
    n = len(pos_live)
    if n == 0:
        raise ValueError("build_ivf_device: no live rows")
    if n_clusters <= 0:
        n_clusters = int(np.clip(n // (s * 8), 8, 4096))
    n_clusters = min(n_clusters, max(1, n))
    if train_sample <= 0:
        train_sample = int(np.clip(256 * n_clusters, 131072, 4_000_000))
    train_sample = min(train_sample, max(1, n))
    stride = max(1, n // train_sample)
    samp_pos = torch.from_numpy(pos_live[::stride][:train_sample]).to(dev)
    sample_d = dev_vectors[samp_pos].to(torch.float32)
    cent1, cents2, c2v, pc1, c2max = _fit_two_level_device(
        sample_d, n_clusters, s, n, kmeans_iters=kmeans_iters, seed=seed)
    del sample_d, samp_pos
    clock("sample_fit_s")

    # the [chunk, c2max, d] level-2 gather stays ~1.5 GB
    chunk_rows = int(np.clip((3 << 28) // max(1, c2max * d), 16384,
                             chunk_rows))
    chunk_rows = min(1 << (chunk_rows.bit_length() - 1), cap)
    assign_d = torch.empty(cap, dtype=torch.int64, device=dev)
    proj_d = torch.empty(cap, dtype=torch.float32, device=dev)
    for st in range(0, cap, chunk_rows):
        en = min(st + chunk_rows, cap)
        assign_d[st:en], proj_d[st:en] = _assign_proj_at(
            dev_vectors[st:en], cent1, cents2, c2v, pc1, c2max)
    del cent1, cents2, c2v, pc1
    clock("assign_s")

    # Small builds (<= 4,096 blocks) allocate whole blocks per cell, large
    # ones per level-1 cluster (per-cell tails left blocks ~55% full at 10M
    # rows in the JAX package's measurements); large builds pad the block
    # count to a multiple of 1,024, small ones to a power of two.
    if block_align <= 0:
        block_align = 1024 if -(-n // s) > 4096 else 0
    order, pos, _nb, nb_pad = _layout_plan(
        assign_d, proj_d, c2max, s, block_align, by_cluster=block_align > 0,
        pos_live=pos_live)
    del assign_d, proj_d
    src_flat = np.full(nb_pad * s, -1, np.int64)   # slot -> device row
    src_flat[pos] = pos_live[order]
    ids_flat = np.full(nb_pad * s, -1, np.int64)   # slot -> row id
    ids_flat[pos] = row_ids[pos_live[order]]
    src2 = torch.from_numpy(src_flat.reshape(nb_pad, s)).to(dev)
    ids2 = torch.from_numpy(ids_flat.reshape(nb_pad, s).astype(np.int32)).to(
        dev)
    clock("plan_s")

    if chunk_blocks <= 0:
        chunk_blocks = _default_chunk_blocks(s, d)
    parts = [[] for _ in range(6)]
    for st in range(0, nb_pad, chunk_blocks):
        en = min(st + chunk_blocks, nb_pad)
        ids_c = ids2[st:en]
        bv = dev_vectors[src2[st:en].clamp_min(0).reshape(-1)].to(
            torch.float32).reshape(en - st, s, d)
        bv = torch.where((ids_c >= 0)[:, :, None], bv, 0.0)
        for lst, arr in zip(parts, quantize_blocks(bv, ids_c)):
            lst.append(arr)
    codes, cent, cent_sq, scale, row_sq, bvalid = (torch.cat(p)
                                                   for p in parts)
    clock("quantize_s")
    return IvfIndex(
        centroids=cent, cent_sq=cent_sq, block_valid=bvalid, blocks_i8=codes,
        block_scale=scale, row_sq=row_sq, block_ids=ids2,
    )


def build_ivf(
    vectors: np.ndarray,
    row_ids: Optional[np.ndarray] = None,
    *,
    block_rows: int = 1024,
    n_clusters: int = 0,
    kmeans_iters: int = 12,
    train_sample: int = 0,
    seed: int = 0x1BF,
    chunk_rows: int = 262144,
    refine: str = "auto",
    host_quantize: Optional[bool] = None,
    device: Optional[torch.device] = None,
) -> IvfIndex:
    """An IvfIndex on ``device`` from a host fp32 corpus [N, d].

    k-means into ``n_clusters`` coarse cells (default ~N/(8S)), a second
    k-means level inside oversized cells, a principal-axis sort within each
    cell, then S-row blocks. The host does the O(N) reorder; the device the
    assignment products, the fits and the quantization.

    refine: "exact" fits level 2 from each oversized cluster's own rows,
    "sample" from the training sample only (the very-large-N path), "none"
    skips it; "auto" is exact up to 20M rows."""
    dev = torch.device(device) if device is not None else get_device()
    vectors = np.ascontiguousarray(vectors, np.float32)
    n, d = vectors.shape
    s = int(block_rows)
    if row_ids is None:
        row_ids = np.arange(n, dtype=np.int64)
    row_ids = np.asarray(row_ids, np.int64)
    if n_clusters <= 0:
        n_clusters = int(np.clip(n // (s * 8), 8, 4096))
    n_clusters = min(n_clusters, max(1, n))
    if refine == "auto":
        refine = "exact" if n <= 20_000_000 else "sample"
    if train_sample <= 0:
        # level 2 in sample mode needs ~16x the rows per coarse cluster
        per = 256 if refine == "sample" else 32
        train_sample = int(np.clip(per * n_clusters, 131072, 4_000_000))

    stride = max(1, n // train_sample)
    sample = vectors[::stride][:train_sample]
    if refine == "sample":
        assign = sample_refined_assign(
            vectors, sample, n_clusters, s,
            kmeans_iters=kmeans_iters, seed=seed, device=dev,
        )
    else:
        cent = kmeans_fit(torch.from_numpy(np.ascontiguousarray(sample)).to(dev),
                          n_clusters, iters=kmeans_iters, seed=seed)
        assign = assign_clusters(vectors, cent, chunk_rows=chunk_rows)
        if refine == "exact":
            assign = refine_oversized(
                vectors, assign, block_rows=s, seed=seed,
                iters=max(4, kmeans_iters // 2), device=dev,
            )

    pc1 = principal_axis(sample)
    p = np.empty(n, np.float32)
    for st in range(0, n, chunk_rows):
        en = min(st + chunk_rows, n)
        p[st:en] = vectors[st:en] @ pc1
    order = np.lexsort((p, assign))
    pos, _nb, nb_pad = plan_blocks(assign, order, s)

    block_vecs = np.zeros((nb_pad * s, d), np.float32)
    ids_flat = np.full(nb_pad * s, -1, np.int64)
    ids_flat[pos] = row_ids[order]
    for st in range(0, n, chunk_rows):
        en = min(st + chunk_rows, n)
        block_vecs[pos[st:en]] = vectors[order[st:en]]
    if host_quantize is None:
        host_quantize = n > 20_000_000  # upload int8 codes, not fp32 blocks
    return finalize_blocks(
        block_vecs.reshape(nb_pad, s, d),
        ids_flat.reshape(nb_pad, s).astype(np.int32),
        host_quantize=host_quantize, device=dev,
    )


# --------------------------------------------------------------------------
# the tier beyond device memory: builds and rescoring from a chunk source
# --------------------------------------------------------------------------


def _stream_work_bytes(device: torch.device) -> int:
    """Bytes one sub-slice of a streaming pass may take: a sixteenth of the
    device's free memory, so the block store, which pass 3 fills, keeps
    its room."""
    return _work_bytes(device) // 4


def _acc_block_means(csum: torch.Tensor, cnt: torch.Tensor, xc: torch.Tensor,
                     dslot: torch.Tensor, s: int):
    """Adds the rows ``xc`` into their blocks' sums and counts, in place
    (``dslot``: each row's slot in the flat [nb * S] layout)."""
    blk = dslot // s
    csum.index_add_(0, blk, xc.to(torch.float32))
    cnt.index_add_(0, blk, torch.ones(blk.shape[0], dtype=torch.float32,
                                      device=blk.device))
    return csum, cnt


def _acc_block_amax(amax: torch.Tensor, xc: torch.Tensor, dslot: torch.Tensor,
                    cents: torch.Tensor, s: int) -> torch.Tensor:
    """Raises each block's largest |row - centroid| component to cover the
    rows ``xc``, in place."""
    blk = dslot // s
    r = (xc.to(torch.float32) - cents[blk]).abs().amax(1)
    return amax.scatter_reduce_(0, blk, r, "amax")


def _quant_scatter(codes: torch.Tensor, rowsq: torch.Tensor, xc: torch.Tensor,
                   dslot: torch.Tensor, cents: torch.Tensor,
                   scale: torch.Tensor, s: int):
    """Residual-codes the rows ``xc`` as ``quantize_blocks`` does and writes
    the codes and |reconstruction|^2 into their slots of the flat
    [nb * S, d] and [nb * S] stores, in place."""
    blk = dslot // s
    c = cents[blk]
    sc = scale[blk][:, None]
    r = xc.to(torch.float32) - c
    r.div_(sc).round_().clamp_(-127, 127)     # the codes, as f32
    codes.index_copy_(0, dslot, r.to(torch.int8))
    recon = r.mul_(sc).add_(c)                # c + q8 * scale
    rowsq.index_copy_(0, dslot, (recon * recon).sum(1))
    return codes, rowsq


def build_ivf_streaming(
    chunk_source: Callable[[int], torch.Tensor],
    n_chunks: int,
    *,
    block_rows: int = 1024,
    n_clusters: int = 0,
    kmeans_iters: int = 12,
    train_sample: int = 0,
    seed: int = 0x1BF,
    sub_rows: int = 262144,
    block_align: int = 1024,
    log_fn: Optional[Callable[[str], None]] = None,
    timings: Optional[Dict[str, float]] = None,
) -> IvfIndex:
    """An IvfIndex from a CHUNK SOURCE, never holding the fp32 corpus, not on
    the host and not on the device.

    ``chunk_source(ci)`` returns chunk ci as a [chunk_rows, d] tensor on the
    build's device and must be deterministic: the build reads the corpus in
    three passes (assignment; block means, then residual maxima; quantize
    and scatter), asking for each chunk again instead of keeping it. The
    residency is the int8 block store plus a chunk and its sub-slices
    (hnswlib, the reference, holds every fp32 vector, hnswalg.h addPoint).

    The partition is build_ivf_device's (a two-level fit from a sample),
    the sample taken from chunk 0, so chunks must be alike (generated
    corpora, shuffled datasets). Passes 2 and 3 update preallocated tensors
    in place, keyed by the host-planned slot of each row; sub-slices are
    sized from the device's free memory, at most ``sub_rows`` rows.
    ``block_align`` pads the block count to a multiple, not a power of two.
    ``timings``, when given, gains the seconds of each stage:
    ``sample_fit_s``, ``assign_s`` (pass 1), ``plan_s`` (the row order on
    the device, ``plan_blocks`` on the host), ``means_s``, ``amax_s``,
    ``quantize_s``."""
    def _log(msg):
        if log_fn is not None:
            log_fn(f"ivf-streaming: {msg}")

    probe = chunk_source(0)
    dev = probe.device
    clock = _StageClock(dev, timings)
    ch, d = probe.shape
    s = int(block_rows)
    n = n_chunks * ch
    if n_clusters <= 0:
        n_clusters = int(np.clip(n // (s * 8), 8, 4096))
    n_clusters = min(n_clusters, max(1, n))
    if train_sample <= 0:
        train_sample = int(np.clip(256 * n_clusters, 131072, 1_048_576))
    train_sample = min(train_sample, ch)
    _log(f"fit: {train_sample} sample rows, {n_clusters} clusters")
    cent1, cents2, c2v, pc1, c2max = _fit_two_level_device(
        probe[:train_sample].to(torch.float32), n_clusters, s, n,
        kmeans_iters=kmeans_iters, seed=seed)
    clock("sample_fit_s")

    # ---- pass 1: assignment + projection, chunk by chunk -------------------
    # per row: three [n_clusters] f32 level-1 temporaries, the [c2max, d]
    # f32 level-2 gather, the row's bf16 and widened copies
    per_row = 12 * n_clusters + c2max * (4 * d + 16) + 8 * d
    chunk_sub = max(1, min(ch, sub_rows, _stream_work_bytes(dev) // per_row))
    _log(f"fit done; pass 1 (assign), {chunk_sub}-row sub-slices")
    assign_d = torch.empty(n, dtype=torch.int64, device=dev)
    proj_d = torch.empty(n, dtype=torch.float32, device=dev)
    for ci in range(n_chunks):
        xc = probe if ci == 0 else chunk_source(ci)
        for st in range(ci * ch, (ci + 1) * ch, chunk_sub):
            en = min(st + chunk_sub, (ci + 1) * ch)
            assign_d[st:en], proj_d[st:en] = _assign_proj_at(
                xc[st - ci * ch:en - ci * ch], cent1, cents2, c2v, pc1, c2max)
    probe = xc = None
    del cent1, cents2, c2v, pc1
    clock("assign_s")

    # ---- layout plan ---------------------------------------------------------
    # blocks pad only at level-1 cluster boundaries: per-cell padding at ~1
    # block a cell wasted 38% of the block store in the JAX package's
    # measurements at ~100M
    _log("pass 1 done; layout plan")
    order, pos, _nb, nb_pad = _layout_plan(assign_d, proj_d, c2max, s,
                                           block_align, by_cluster=True)
    del assign_d, proj_d
    _log(f"layout: {_nb} blocks, padded {nb_pad} "
         f"({nb_pad * s * d / 2**30:.1f} GiB codes)")
    dst = np.empty(n, np.int64)
    dst[order] = pos                      # row -> slot in [nb_pad * s]
    ids_flat = np.full(nb_pad * s, -1, np.int64)
    ids_flat[pos] = order                 # slot -> row id (identity ids)
    del order, pos
    clock("plan_s")

    def _dst_dev(ci):
        return torch.from_numpy(dst[ci * ch:(ci + 1) * ch]).to(dev)

    # per row of a sub-slice in passes 2 and 3: the gathered centroid, the
    # residual, the codes
    qsub = max(1, min(ch, _stream_work_bytes(dev) // (d * 13 + 32)))

    # ---- pass 2: block means, then residual maxima --------------------------
    csum = torch.zeros((nb_pad, d), dtype=torch.float32, device=dev)
    cnt = torch.zeros((nb_pad,), dtype=torch.float32, device=dev)
    for ci in range(n_chunks):
        _acc_block_means(csum, cnt, chunk_source(ci), _dst_dev(ci), s)
    cents = csum / cnt.clamp_min(1.0)[:, None]
    del csum, cnt
    clock("means_s")
    _log("pass 2a (means) done")
    amax = torch.zeros((nb_pad,), dtype=torch.float32, device=dev)
    for ci in range(n_chunks):
        xc, dslot = chunk_source(ci), _dst_dev(ci)
        for st in range(0, ch, qsub):
            _acc_block_amax(amax, xc[st:st + qsub], dslot[st:st + qsub],
                            cents, s)
    scale = amax.clamp_min(1e-30) / 127.0
    del amax
    clock("amax_s")
    _log("pass 2b (residual max) done")

    # ---- pass 3: quantize + scatter into the block store --------------------
    nslot = nb_pad * s
    codes = torch.zeros((nslot, d), dtype=torch.int8, device=dev)
    rowsq = torch.zeros((nslot,), dtype=torch.float32, device=dev)
    for ci in range(n_chunks):
        xc, dslot = chunk_source(ci), _dst_dev(ci)
        for st in range(0, ch, qsub):
            _quant_scatter(codes, rowsq, xc[st:st + qsub],
                           dslot[st:st + qsub], cents, scale, s)
        if ci % 16 == 15:
            _log(f"pass 3 (quantize+scatter): chunk {ci + 1}/{n_chunks}")
    xc = dslot = None
    clock("quantize_s")
    _log("pass 3 done")
    ids2 = torch.from_numpy(ids_flat.reshape(nb_pad, s).astype(np.int32)).to(
        dev)
    return IvfIndex(
        centroids=cents,
        cent_sq=(cents * cents).sum(1),
        block_valid=(ids2 >= 0).any(1),
        blocks_i8=codes.view(nb_pad, s, d),
        block_scale=scale,
        row_sq=rowsq.view(nb_pad, s),
        block_ids=ids2,
    )


# --------------------------------------------------------------------------
# search
# --------------------------------------------------------------------------


def default_probe(index: IvfIndex) -> int:
    """The probe when search.ivf-probe is 0: 8 through 7,168 blocks, 16
    through 12,288 (the JAX package's measured crossover table), then
    ceil(nb / 384) clamped to [32, 512]. Coverage is a property of the block
    layout, so the step lives on the block count."""
    nb = index.n_blocks
    if nb <= 7168:
        return 8
    if nb <= 12288:
        return 16
    return int(min(512, max(32, -(-nb // 384))))


# Grouped stage 2 gathers [n_seg, S, d] int8; past this size the steps path
# serves. The JAX package's value: it routes, and so changes results (the
# port chunks both paths by free memory, so the cap bounds no allocation).
_GROUPED_GATHER_CAP_BYTES = 4 << 30


def _group_capacity(e: int, nb: int) -> int:
    """Capacity G of a segment: the largest power of two <= the average
    block multiplicity e / nb, in [2, 16]."""
    g = 1
    while g * 2 <= min(16, max(1, e // nb)):
        g *= 2
    return max(g, 2)


def _grouped_gather_bytes(
    b: int, eff_probe: int, nb: int, block_rows: int, d_bytes: int
) -> int:
    """The [n_seg, S, d] int8 gather grouped stage 2 makes: the same
    capacity math, so routing sees the same n_seg."""
    e = b * eff_probe
    g = _group_capacity(e, nb)
    n_seg = -(-(e + nb * (g - 1)) // g)
    return n_seg * block_rows * d_bytes


def ivf_search_batch(
    index: IvfIndex,
    queries: torch.Tensor,
    k: int,
    probe: int = 32,
    metric: str = "l2",
    probe_chunk: int = 8,
    filter_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pruned k-NN: [B, d] queries -> (dists [B, k] f32, row ids [B, k]
    int32) ascending, (+inf, -1) where fewer rows qualify.

    probe: blocks scanned per query (the recall/throughput dial). Stage 2
    runs grouped when the average block multiplicity B * probe / n_blocks
    is >= 2 and the grouped gather fits ``_GROUPED_GATHER_CAP_BYTES``, else
    the steps scan; the route counts under STATS ``ivf_stage2_grouped`` /
    ``ivf_stage2_steps``. "ip" scores are 1 - q.x (cosine callers pass
    normalized rows and use "ip"). filter_mask: optional bool [row-id space]
    shared by all queries, True = allowed (probing cannot see it)."""
    b = int(queries.shape[0])
    nb = index.n_blocks
    eff_probe = min(probe, nb)
    mult = (b * eff_probe) // max(nb, 1)
    if mult >= 2:
        gather_bytes = _grouped_gather_bytes(
            b, eff_probe, nb, index.block_rows, index.blocks_i8.shape[2])
        if gather_bytes <= _GROUPED_GATHER_CAP_BYTES:
            STATS.incr("ivf_stage2_grouped")
            return _ivf_search_batch_grouped(
                index, queries, k=k, probe=probe, metric=metric,
                filter_mask=filter_mask,
            )
    STATS.incr("ivf_stage2_steps")
    return _ivf_search_batch_steps(
        index, queries, k=k, probe=probe, metric=metric,
        probe_chunk=probe_chunk, filter_mask=filter_mask,
    )


def _stage1(index: IvfIndex, q: torch.Tensor, probe: int,
            metric: str) -> torch.Tensor:
    """The ``probe`` best blocks of each query by its block-centroid score
    (bf16 operands, f32 product), [B, probe] int64, in query chunks."""
    nb = index.n_blocks
    cbf = _bf16(index.centroids).T
    # per query: the f32 scores and topk_smallest's int64 key and scratch
    rows = _chunk(nb * 24, q.device)
    out = []
    with record_function("ivf.stage1"):
        for r0 in range(0, q.shape[0], rows):
            dots_c = _bf16(q[r0:r0 + rows]) @ cbf             # [b, nb]
            cd = (index.cent_sq[None, :] - 2.0 * dots_c if metric == "l2"
                  else -dots_c)
            cd = torch.where(index.block_valid[None, :], cd, INF)
            out.append(topk_smallest(cd, probe)[1])
        return torch.cat(out)


def _ivf_search_batch_grouped(
    index: IvfIndex,
    queries: torch.Tensor,
    k: int,
    probe: int,
    metric: str,
    filter_mask: Optional[torch.Tensor],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Block-major stage 2: (query, block) entries sorted by block and
    packed into capacity-G segments, so each selected block is read once
    and scored against its G queries in one batched product (int8 codes and
    bf16 queries widened to f32, exact there). Runs pad to whole segments,
    so no entry is dropped. Segments and queries go in chunks sized from
    free memory."""
    s, d = index.block_rows, index.blocks_i8.shape[2]
    nb = index.n_blocks
    dev = queries.device
    b = int(queries.shape[0])
    probe = min(probe, nb)
    e = b * probe
    g = _group_capacity(e, nb)
    e_pad = -(-(e + nb * (g - 1)) // g) * g
    n_seg = e_pad // g

    q = queries.to(torch.float32)
    qbf = _bf16(q)
    q_sq = (q * q).sum(1)                                     # [B]
    sel = _stage1(index, q, probe, metric)                    # [B, probe]

    # ---- inverted dispatch: sort entries by block, pack into segments ----
    with record_function("ivf.dispatch"):
        blk_e = sel.reshape(-1)                               # [e]
        q_e = torch.arange(b, device=dev).repeat_interleave(probe)
        order = torch.argsort(blk_e, stable=True)
        blk_s = blk_e[order]
        q_s = q_e[order]
        idx = torch.arange(e, device=dev)
        new_run = torch.ones(e, dtype=torch.bool, device=dev)
        new_run[1:] = blk_s[1:] != blk_s[:-1]
        run_start = torch.cummax(torch.where(new_run, idx, 0), dim=0).values
        rank = idx - run_start                                # within run
        counts = torch.bincount(blk_e, minlength=nb)          # [nb]
        padded = -(-counts // g) * g
        base = torch.cumsum(padded, 0) - padded               # exclusive
        pos = base[blk_s] + rank                              # unique slots
        pq = torch.full((e_pad,), -1, dtype=torch.int64, device=dev)
        pq[pos] = q_s
        pb = torch.full((e_pad,), -1, dtype=torch.int64, device=dev)
        pb[pos] = blk_s
        seg_blk = pb.reshape(n_seg, g).amax(1)                # -1 = all pad
        pq_seg = pq.reshape(n_seg, g)
        pos_orig = torch.empty(e, dtype=torch.int64, device=dev)
        pos_orig[order] = pos

    # ---- stage 2 in segment chunks; scores land entry-major [e_pad, S] ---
    ent_scores = torch.empty((e_pad, s), dtype=torch.float32, device=dev)
    # per segment: the int8 gather and its f32 widening, ~4 [S, g] f32
    # temporaries, the [g, d] query gather
    seg_chunk = _chunk(s * d * 5 + s * g * 16 + g * d * 8, dev)
    for c0 in range(0, n_seg, seg_chunk):
        c1 = min(c0 + seg_chunk, n_seg)
        with record_function("ivf.gather"):
            blk_c = seg_blk[c0:c1].clamp_min(0)
            pq_raw = pq_seg[c0:c1]
            pq_c = pq_raw.clamp_min(0)
            blkv = index.blocks_i8[blk_c].to(torch.float32)   # [n, S, d]
            qv = qbf[pq_c]                                    # [n, g, d]
        with record_function("ivf.product"):
            dots = torch.bmm(blkv, qv.transpose(1, 2))        # [n, S, g]
            del blkv, qv
            qdotc = torch.bmm(q[pq_c], index.centroids[blk_c][:, :, None])[
                :, :, 0]                                      # [n, g] f32
            qr = index.block_scale[blk_c][:, None, None] * dots
            bid = index.block_ids[blk_c]                      # [n, S]
            if metric == "l2":
                dd = (q_sq[pq_c][:, None, :] - 2.0 * qdotc[:, None, :]
                      - 2.0 * qr + index.row_sq[blk_c][:, :, None])
            else:
                dd = 1.0 - (qdotc[:, None, :] + qr)
            allowed = (bid >= 0)[:, :, None] & (pq_raw >= 0)[:, None, :]
            if filter_mask is not None:
                allowed &= filter_mask[bid.clamp_min(0).long()][:, :, None]
            dd = torch.where(allowed, dd, INF)
            ent_scores[c0 * g:c1 * g] = dd.transpose(1, 2).reshape(-1, s)
            del dots, qr, dd, allowed

    # ---- back to query-major: one top-k over each query's probe * S -----
    kk = min(k, probe * s)
    # per query: its probe * S scores and ids, topk_smallest's int64 key
    rows = _chunk(probe * s * 32, dev)
    out_d, out_i = [], []
    with record_function("ivf.topk"):
        for r0 in range(0, b, rows):
            r1 = min(r0 + rows, b)
            dd_q = ent_scores[pos_orig[r0 * probe:r1 * probe]].reshape(
                r1 - r0, probe * s)
            sd, ppos = topk_smallest(dd_q, kk)
            ids_q = index.block_ids[sel[r0:r1]].reshape(r1 - r0, probe * s)
            si = ids_q.gather(-1, ppos)
            out_d.append(sd)
            out_i.append(torch.where(torch.isfinite(sd), si, -1))
        return _pad_k(torch.cat(out_d), torch.cat(out_i).to(torch.int32), k)


def _ivf_search_batch_steps(
    index: IvfIndex,
    queries: torch.Tensor,
    k: int,
    probe: int = 32,
    metric: str = "l2",
    probe_chunk: int = 8,
    filter_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-query gather scan (the multiplicity < 2 regime): ``probe_chunk``
    blocks per step, a running top-k. The [B, probe_chunk, S, d] gather runs
    in query chunks sized from free memory."""
    dev = queries.device
    q = queries.to(torch.float32)
    b = q.shape[0]
    nb = index.n_blocks
    s, d = index.block_rows, index.blocks_i8.shape[2]
    probe = min(probe, nb)
    pc = max(1, min(probe_chunk, probe))
    n_steps = -(-probe // pc)
    probe_pad = n_steps * pc

    qbf = _bf16(q)
    q_sq = (q * q).sum(1)                                     # [B]
    sel = _stage1(index, q, probe, metric)                    # [B, probe]
    if probe_pad != probe:
        # pad slots repeat the best block for shape only; their scores are
        # masked to +inf below, so they cannot evict real candidates
        sel = torch.cat([sel, sel[:, :1].expand(b, probe_pad - probe)], 1)
    pad_slot = (torch.arange(probe_pad, device=dev) >= probe).reshape(
        n_steps, pc)

    # per query and step: the int8 gather and its f32 widening, ~4 [pc, S]
    # f32 temporaries
    rows = _chunk(pc * s * (d * 5 + 16), dev)
    out_d, out_i = [], []
    for r0 in range(0, b, rows):
        r1 = min(r0 + rows, b)
        bq = r1 - r0
        qc, qbfc, q_sqc = q[r0:r1], qbf[r0:r1], q_sq[r0:r1]
        run_d = torch.full((bq, k), INF, dtype=torch.float32, device=dev)
        run_i = torch.full((bq, k), -1, dtype=torch.int32, device=dev)
        for t in range(n_steps):
            sel_c = sel[r0:r1, t * pc:(t + 1) * pc]           # [bq, pc]
            with record_function("ivf.gather"):
                blk = index.blocks_i8[sel_c].to(torch.float32)  # [bq,pc,S,d]
            with record_function("ivf.product"):
                dots = torch.bmm(blk.reshape(bq, pc * s, d),
                                 qbfc[:, :, None]).reshape(bq, pc, s)
                del blk
                rsq = index.row_sq[sel_c]                     # [bq, pc, S]
                bid = index.block_ids[sel_c]                  # [bq, pc, S]
                bscale = index.block_scale[sel_c]             # [bq, pc]
                cvec = index.centroids[sel_c]                 # [bq, pc, d]
                qdotc = (cvec * qc[:, None, :]).sum(-1)       # [bq, pc]
                qr = bscale[:, :, None] * dots                # q.residual
                if metric == "l2":
                    dd = (q_sqc[:, None, None] - 2.0 * qdotc[:, :, None]
                          - 2.0 * qr + rsq)
                else:
                    dd = 1.0 - (qdotc[:, :, None] + qr)
                allowed = (bid >= 0) & ~pad_slot[t][None, :, None]
                if filter_mask is not None:
                    allowed &= filter_mask[bid.clamp_min(0).long()]
                dd = torch.where(allowed, dd, INF).reshape(bq, -1)
                bid = bid.reshape(bq, -1)
            with record_function("ivf.topk"):
                kk = min(k, dd.shape[-1])
                sd, ppos = topk_smallest(dd, kk)
                si = torch.where(torch.isfinite(sd), bid.gather(-1, ppos), -1)
                md = torch.cat([run_d, sd], 1)
                mi = torch.cat([run_i, si.to(torch.int32)], 1)
                run_d, ppos = topk_smallest(md, k)
                run_i = mi.gather(-1, ppos)
        out_d.append(run_d)
        out_i.append(run_i)
    return torch.cat(out_d), torch.cat(out_i)


def delta_overlay_merge(
    queries: torch.Tensor,      # [B, d] f32
    corpus: torch.Tensor,       # [cap, d] f32 (current snapshot)
    delta_ids: torch.Tensor,    # [m] rows written since the mirror build
    invalid: torch.Tensor,      # [cap] bool (True = not a result)
    base_d: torch.Tensor,       # [B, k] mirror-path distances
    base_i: torch.Tensor,       # [B, k] mirror-path ids
    k: int,
    metric: str = "l2",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact-score the delta rows (written since the mirror was built) and
    merge them into the mirror's results: exact read-your-writes between
    rebuilds. Callers exclude the delta ids from the mirror query, so no id
    appears twice."""
    with record_function("ivf.overlay"):
        q = queries.to(torch.float32)
        safe = delta_ids.clamp_min(0).long()
        vecs = corpus[safe]                                   # [m, d]
        dots = q @ vecs.T                                     # [B, m]
        if metric == "l2":
            cd = ((q * q).sum(1)[:, None] + (vecs * vecs).sum(1)[None, :]
                  - 2.0 * dots)
        else:
            cd = 1.0 - dots
        bad = invalid[safe] | (delta_ids < 0)
        cd = torch.where(bad[None, :], INF, cd)
        kk = min(k, cd.shape[-1])
        dd, pos = topk_smallest(cd, kk)
        di = delta_ids.to(torch.int32)[pos]
        di = torch.where(torch.isfinite(dd), di, -1)
        md = torch.cat([base_d, dd], 1)
        mi = torch.cat([base_i.to(torch.int32), di], 1)
        top, pos = topk_smallest(md, k)
        return top, mi.gather(-1, pos)


def ivf_search_rescored(
    index: IvfIndex,
    queries: torch.Tensor,
    corpus: torch.Tensor,
    k: int,
    probe: int = 32,
    metric: str = "l2",
    coarse_factor: int = 4,
    probe_chunk: int = 8,
    filter_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """IVF coarse retrieval of coarse_factor * k candidates, then the exact
    fp32 rescore against ``corpus`` [cap, d], indexed by the ids stored in
    the blocks (the engine path)."""
    kc = min(coarse_factor * k, index.block_rows * min(probe, index.n_blocks))
    cd, ci = ivf_search_batch(
        index, queries, k=kc, probe=probe, metric=metric,
        probe_chunk=probe_chunk, filter_mask=filter_mask,
    )
    with record_function("ivf.rescore"):
        return _rescore_exact(queries.to(torch.float32), corpus, ci, cd, k=k,
                              metric=metric)


def _rescore_from_chunk(best: torch.Tensor, q: torch.Tensor, xc: torch.Tensor,
                        cand: torch.Tensor, base: int, rows: int,
                        metric: str) -> torch.Tensor:
    """Exact-scores the candidates that lie in chunk [base, base + rows) and
    writes them into the running ``best`` [B, kc], in place. q [B, d] f32,
    xc [rows, d], cand [B, kc] int32 global row ids."""
    local = cand.long() - base
    inchunk = (cand >= 0) & (local >= 0) & (local < rows)
    rowsv = xc[local.clamp(0, rows - 1)]                     # [B, kc, d]
    dd = dist_ops.batched_candidate_scores(q, rowsv, metric)
    return best.copy_(torch.where(inchunk, dd, best))


def _rescored_merge(best: torch.Tensor, cand: torch.Tensor,
                    k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The final top-k over exactly rescored candidates, with an O(kc^2)
    duplicate mask (a row id repeated among the candidates ties with
    itself and would fill the top-k twice)."""
    same = (cand[:, None, :] == cand[:, :, None]) & (cand[:, None, :] >= 0)
    first = torch.argmax(same.to(torch.uint8), dim=-1)       # first copy
    kc = cand.shape[1]
    dup = first != torch.arange(kc, device=cand.device)[None, :]
    best = torch.where(dup, INF, best)
    out_d, pos = topk_smallest(best, min(k, kc))
    out_i = cand.gather(-1, pos)
    return out_d, torch.where(torch.isfinite(out_d), out_i, -1)


def ivf_search_rescored_streaming(
    index: IvfIndex,
    queries: torch.Tensor,
    chunk_source: Callable[[int], torch.Tensor],
    n_chunks: int,
    chunk_rows: int,
    k: int,
    probe: int = 32,
    metric: str = "l2",
    coarse_factor: int = 4,
    probe_chunk: int = 8,
    sync_every: int = 8,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The >= 0.99 recall tier for corpora past device memory: IVF coarse
    retrieval of coarse_factor * k candidates over the int8 blocks, then
    their EXACT fp32 rescore, each chunk asked again of the deterministic
    ``chunk_source`` (build_ivf_streaming's contract) and only candidate
    rows gathered from it. No fp32 corpus is resident; a query batch costs
    one pass over the chunk source. Row id i lies in chunk i // chunk_rows
    at offset i % chunk_rows (build_ivf_streaming's identity ids).
    ``sync_every`` is unused (the JAX package bounded its queued chunks
    with it); kept for the signature."""
    kc = min(coarse_factor * k, index.block_rows * min(probe, index.n_blocks))
    _, ci = ivf_search_batch(
        index, queries, k=kc, probe=probe, metric=metric,
        probe_chunk=probe_chunk,
    )
    q = queries.to(torch.float32)
    with record_function("ivf.rescore"):
        best = torch.full((q.shape[0], kc), INF, dtype=torch.float32,
                          device=q.device)
        for c in range(n_chunks):
            _rescore_from_chunk(best, q, chunk_source(c), ci, c * chunk_rows,
                                chunk_rows, metric)
        return _rescored_merge(best, ci, k)
