"""Fused coarse scans K1 (packed int8), K2 (bf16), K3 (int8): layout, plain versions, wrappers.

Counterpart of valkey_search_tpu/ops/pallas_scan.py. A coarse scan scores
every query against every corpus row and keeps, for each strided bucket of
rows, only its best (score, chunk) key, so the [B, N] score matrix never
reaches device memory. Lane ``l`` of a group of ``span * GROUP`` rows
collects rows ``{group_start + m * BUCKET + l}``; the chunk index ``m`` is
packed into the low bits of the key, so one int32 min per row is the whole
selection. That strided layout is the TPU kernel's, and it stays here as the
output contract: the keys of the port and of the JAX package agree bit for
bit (int8) or to the bf16 kernel's stated tolerance.

Each kernel has three parts in this module:

- the host half, unchanged in meaning: ``i8_packed_layout``, ``i8_layout``,
  the biases (``make_bias_i8_packed``, ``make_bias``, ``make_bias_i8``) and
  ``chunk_of_rows``;
- the plain PyTorch version (``*_plain``), which computes exactly what the
  kernel outputs;
- the wrapper (``bucket_min_scan_i8_packed``, ``bucket_min_scan``,
  ``bucket_min_scan_i8``), which
  checks its arguments and, for a CUDA tensor, launches the hand-written
  kernel from ``csrc/`` (built by ``ops/_build.py``) or raises. Only a CPU
  tensor takes the plain version.

K3 (``bucket_min_scan_i8``) has no caller in either package's search path:
the JAX package calls its TPU counterpart only from its tests. It is ported
at the kernel level so that every TPU kernel has a counterpart.

Rows at or past ``corpus.shape[0]`` (up to ``bias.shape[0]``) score as zero
vectors, exactly like the JAX package's zero-padded corpus, so callers pad
the bias, never the corpus.

Inside a traced launch (runtime/metrics.py ``CTX.launch``), K1's and K2's
wrappers record ``topk.scan`` into ``TRACE``: the host's time to check the
arguments and enqueue the kernel through ctypes (on a CPU tensor, to run
the plain version), on the clock the device trace is mapped onto.
"""

from __future__ import annotations

import contextlib
import ctypes
import threading
from typing import Dict, Iterator, Optional, Tuple

import torch

from valkey_search_tpu_torch.runtime.metrics import CTX, SPAN, TRACE, clock

INF = float("inf")
INVALID_ID = -1

BUCKET = 128   # lanes: survivor columns per group
GROUP = 16384  # rows per group of the bf16 scan (128 chunks of 128 rows)

_INT32_MAX = 2**31 - 1

# one count per kernel variant; a wrapper adds one where it launches its
# CUDA kernel and nowhere else (the plain version is not counted). A CUDA
# graph's capture runs no kernel: it counts its kernels into the thread's
# ``captured_launches``, and each replay of the graph adds them
# (``add_launches``).
_launch_lock = threading.Lock()
LAUNCHES: Dict[str, int] = {
    "bucket_scan_i8_packed[pre_shift=0]": 0,
    "bucket_scan_i8_packed[pre_shift>0]": 0,
    "bucket_scan_bf16": 0,
    "bucket_scan_i8": 0,
}


class _Captured(threading.local):
    counts: Optional[Dict[str, int]] = None


_CAPTURED = _Captured()


def _count_launch(name: str) -> None:
    if torch.cuda.is_current_stream_capturing():
        if _CAPTURED.counts is not None:
            _CAPTURED.counts[name] = _CAPTURED.counts.get(name, 0) + 1
        return
    with _launch_lock:
        LAUNCHES[name] += 1


@contextlib.contextmanager
def captured_launches() -> Iterator[Dict[str, int]]:
    """The kernels this thread captures into a CUDA graph inside the block,
    counted by name into the dict it yields."""
    _CAPTURED.counts = counts = {}
    try:
        yield counts
    finally:
        _CAPTURED.counts = None


def add_launches(counts: Dict[str, int]) -> None:
    """Count the launches ``counts`` holds (a replayed graph's kernels)."""
    with _launch_lock:
        for name, n in counts.items():
            LAUNCHES[name] += n


def reset_launches() -> None:
    with _launch_lock:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def launch_counts() -> Dict[str, int]:
    with _launch_lock:
        return dict(LAUNCHES)


# ---------------------------------------------------------------------------
# host half
# ---------------------------------------------------------------------------


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def chunk_bits(span: int) -> int:
    """Low key bits that carry the chunk index within a span group."""
    return (span * (GROUP // BUCKET) - 1).bit_length()


def i8_packed_layout(d: int, span: int) -> Tuple[int, int, int, int, int]:
    """(bias_offset, bias_clamp, sentinel, pre_shift, invalid_thresh) for the
    packed int8 scan at padded dim ``d`` (a multiple of 128).

    Scores are offset to be >= 0: score = (bias + DOTMAX) - dot, so keys
    order as plain ints and as their f32 bit views. pre_shift drops score
    bits until (max score << chunk_bits) fits in 31 bits."""
    dotmax = d * 127 * 127
    bias_clamp = 1 << 22
    sentinel = bias_clamp + 3 * dotmax + 4096
    cb = chunk_bits(span)
    pre_shift = 0
    while ((sentinel + dotmax) >> pre_shift) >= (1 << (31 - cb)):
        pre_shift += 1
    invalid_thresh = bias_clamp + 2 * dotmax + 2048
    return dotmax, bias_clamp, sentinel, pre_shift, invalid_thresh


def chunk_of_rows(n: int, span: int = 1,
                  device: Optional[torch.device] = None) -> torch.Tensor:
    """int32 [n]: the chunk index of every corpus row within its group of
    ``span * GROUP`` rows (the low key bits of that row's candidates)."""
    rows = torch.arange(n, dtype=torch.int32, device=device)
    return (rows % (span * GROUP)) // BUCKET


def make_bias_i8_packed(
    n: int,
    d_pad: int,
    span: int,
    metric: str,
    corpus_sq: Optional[torch.Tensor],
    inv_two_scales: torch.Tensor,
    invalid: Optional[torch.Tensor],
    filter_mask: Optional[torch.Tensor],
) -> torch.Tensor:
    """int32 [n] offset bias for the packed int8 scan: DOTMAX plus, for l2,
    round(||c||^2 / (2 s_q s_c)) clipped to BIAS_CLAMP; SENTINEL for rows
    that must never be returned. ``inv_two_scales`` is the f32 scalar
    1 / (2 s_q s_c); every step runs in f32 in the JAX package's order and
    rounds half to even, so the bias is bit-identical to its."""
    dotmax, bias_clamp, sentinel, _, _ = i8_packed_layout(d_pad, span)
    if metric == "l2":
        if corpus_sq is None:
            raise ValueError("l2 int8 bias needs corpus_sq")
        f = corpus_sq.to(torch.float32) * inv_two_scales
        bias = torch.clamp(torch.round(f), 0, bias_clamp).to(torch.int32)
    else:
        bias = torch.zeros((n,), dtype=torch.int32,
                           device=inv_two_scales.device)
    bias = bias + dotmax
    # a Python scalar, not a tensor made from one: no host copy, so a CUDA
    # graph can capture the bias
    if invalid is not None:
        bias = torch.where(invalid, sentinel, bias)
    if filter_mask is not None:
        bias = torch.where(filter_mask, bias, sentinel)
    return bias


def make_bias(
    n: int,
    metric: str,
    corpus_sq: Optional[torch.Tensor],
    invalid: Optional[torch.Tensor],
    filter_mask: Optional[torch.Tensor],
    device: Optional[torch.device] = None,
) -> torch.Tensor:
    """f32 [n] coarse-score bias for the bf16 scan: ||c||^2 for l2, 0 for
    ip/cosine; +inf for invalid rows and rows a shared pre-filter excludes."""
    if metric == "l2":
        if corpus_sq is None:
            raise ValueError("l2 bias needs corpus_sq")
        bias = corpus_sq.to(torch.float32)
    else:
        bias = torch.zeros((n,), dtype=torch.float32, device=device)
    if invalid is not None:
        bias = torch.where(invalid, INF, bias)
    if filter_mask is not None:
        bias = torch.where(filter_mask, bias, INF)
    return bias


def _pad_cols(x: torch.Tensor, n: int) -> torch.Tensor:
    if x.shape[1] == n:
        return x
    return torch.nn.functional.pad(x, (0, n - x.shape[1]))


def _flip(bits: torch.Tensor) -> torch.Tensor:
    """The total-order involution on f32 bit patterns (negatives reversed)."""
    return bits ^ ((bits >> 31) & 0x7FFFFFFF)


# ---------------------------------------------------------------------------
# K1: packed int8 scan
# ---------------------------------------------------------------------------


# The CUDA kernel's shared memory (csrc/bucket_scan_i8_packed.cu
# smem_bytes), shared by K1 and K3: a ring of K1_STAGES corpus boxes of 128
# rows x 128 int8, the resident query tile (d / 128 boxes of BQ rows), the
# ring's biases, the barriers, and 1024 bytes to align the swizzled tiles.
K1_STAGES = 4
K1_BOX_COLS = 128
K1_MAX_SMEM = 232448  # per-block shared memory on sm_90
K1_MAX_TILE = 128


def k1_smem_bytes(bq: int, d: int) -> int:
    kb = -(-d // K1_BOX_COLS)
    return (1024 + K1_STAGES * BUCKET * K1_BOX_COLS + kb * bq * 128
            + K1_STAGES * BUCKET * 4 + (2 * K1_STAGES + 1) * 8)


def k1_query_tile(b: int, d: int) -> int:
    """K1's and K3's query tile BQ (the N of their wgmma) for B queries of
    dim d: the multiple of 8 that covers min(B, 128), shrunk by 8 until the
    resident tile and the corpus ring fit in shared memory (d 768 still
    takes 128). Raises past the largest d that fits at BQ = 8."""
    bq = min(round_up(max(b, 1), 8), K1_MAX_TILE)
    while bq > 8 and k1_smem_bytes(bq, d) > K1_MAX_SMEM:
        bq -= 8
    if k1_smem_bytes(bq, d) > K1_MAX_SMEM:
        raise ValueError(f"the CUDA int8 scans take d up to "
                         f"{k1_max_dim()}, not {d}")
    return bq


def k1_max_dim() -> int:
    """The largest d (a multiple of 16) whose 8-query tile fits."""
    d = 16
    while k1_smem_bytes(8, d + 16) <= K1_MAX_SMEM:
        d += 16
    return d


def bucket_min_scan_i8_packed_plain(
    queries: torch.Tensor, corpus: torch.Tensor, bias: torch.Tensor, span: int
) -> torch.Tensor:
    """Plain version of K1: packed keys [B, n / (128 * span)] int32.

    dot = <q, c> in exact integers; key = ((bias - dot) >> pre_shift)
    << chunk_bits | chunk, min over each strided bucket. The dot runs as a
    float matmul, which is exact while every partial sum stays below 2^24
    (d_pad * 127^2 < 2^24, i.e. d_pad <= 1024); f64 past that. A TF32
    matmul would not be exact, so it is refused."""
    b, d = queries.shape
    n = bias.shape[0]
    d_pad = round_up(d, 128)
    _, _, _, pre_shift, _ = i8_packed_layout(d_pad, span)
    cb = chunk_bits(span)
    if queries.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("exact int8 dots need TF32 off (runtime.device)")
    ftype = torch.float32 if d_pad * 127 * 127 < (1 << 24) else torch.float64
    dots = (queries.to(ftype) @ corpus.to(ftype).T).to(torch.int32)
    dots = _pad_cols(dots, n)
    s = (bias[None, :] - dots) >> pre_shift
    sg = span * GROUP
    sb = s.reshape(b, n // sg, sg // BUCKET, BUCKET)
    col = torch.arange(sg // BUCKET, dtype=torch.int32, device=s.device)
    packed = (sb << cb) | col[None, None, :, None]
    return packed.amin(dim=2).reshape(b, n // (BUCKET * span))


def bucket_min_scan_i8_packed(
    queries: torch.Tensor, corpus: torch.Tensor, bias: torch.Tensor, span: int
) -> torch.Tensor:
    """K1: queries [B, d] int8, corpus [n_rows, d] int8, bias [n] int32
    (offset by +DOTMAX, SENTINEL = excluded; n % (span * GROUP) == 0,
    n_rows <= n) → packed keys [B, n / (128 * span)] int32.

    Decode of the key at survivor column ``c``:
      chunk = key & (span * 128 - 1); score = (key >> chunk_bits) << pre_shift
      row   = (c // 128) * span * GROUP + chunk * BUCKET + c % 128
    The layout constants come from d padded to 128, as in the JAX package.
    The CUDA kernel takes d % 16 == 0 up to ``k1_max_dim()`` and tiles the
    queries by ``k1_query_tile``.
    """
    launch = CTX.launch
    t0 = clock() if launch else 0
    _check_scan_args(queries, corpus, bias, torch.int8, torch.int32,
                     span * GROUP, align=16)
    if queries.device.type == "cpu":
        out = bucket_min_scan_i8_packed_plain(queries, corpus, bias, span)
    else:
        b, d = queries.shape
        n = bias.shape[0]
        _, _, _, pre_shift, _ = i8_packed_layout(round_up(d, 128), span)
        out = torch.empty((b, n // (BUCKET * span)), dtype=torch.int32,
                          device=queries.device)
        lib = _library("bucket_scan_i8_packed")
        with torch.cuda.device(queries.device):
            rc = lib.bucket_scan_i8_packed(
                queries.data_ptr(), corpus.data_ptr(), bias.data_ptr(),
                out.data_ptr(), b, d, corpus.shape[0], n, span, pre_shift,
                chunk_bits(span), k1_query_tile(b, d),
                torch.cuda.current_stream().cuda_stream,
            )
        _raise_on(lib, rc, "bucket_scan_i8_packed")
        _count_launch("bucket_scan_i8_packed[pre_shift=0]" if pre_shift == 0
                      else "bucket_scan_i8_packed[pre_shift>0]")
    if t0:
        TRACE.record(SPAN["topk.scan"], t0, clock(), CTX.rid, launch,
                     queries.shape[0])
    return out


# ---------------------------------------------------------------------------
# K2: bf16 scan
# ---------------------------------------------------------------------------


# The CUDA kernel's shared memory (csrc/bucket_scan_bf16.cu smem_bytes): a
# ring of K2_STAGES corpus boxes of 128 rows x 64 bf16, the resident query
# tile (d / 64 boxes of BQ rows), the ring's biases, the query norms, the
# barriers, and 1024 bytes to align the swizzled tiles.
K2_STAGES = 4
K2_BOX_COLS = 64
K2_MAX_SMEM = 232448  # per-block shared memory on sm_90
K2_MAX_TILE = 128


def k2_smem_bytes(bq: int, d: int) -> int:
    kb = -(-d // K2_BOX_COLS)
    return (1024 + K2_STAGES * BUCKET * K2_BOX_COLS * 2 + kb * bq * 128
            + K2_STAGES * BUCKET * 4 + 128 * 4 + (2 * K2_STAGES + 1) * 8)


def k2_query_tile(b: int, d: int) -> int:
    """K2's query tile BQ (the N of its wgmma) for B queries of dim d: the
    multiple of 8 that covers min(B, 128), shrunk by 8 until the resident
    tile and the corpus ring fit in shared memory (d 768 caps it at 104).
    Raises past the largest d that fits at BQ = 8."""
    bq = min(round_up(max(b, 1), 8), K2_MAX_TILE)
    while bq > 8 and k2_smem_bytes(bq, d) > K2_MAX_SMEM:
        bq -= 8
    if k2_smem_bytes(bq, d) > K2_MAX_SMEM:
        raise ValueError(f"the CUDA bf16 scan takes d up to "
                         f"{k2_max_dim()}, not {d}")
    return bq


def k2_max_dim() -> int:
    """The largest d (a multiple of 8) whose 8-query tile fits."""
    d = 8
    while k2_smem_bytes(8, d + 8) <= K2_MAX_SMEM:
        d += 8
    return d


def bucket_min_scan_plain(
    queries: torch.Tensor,
    qsq: torch.Tensor,
    corpus: torch.Tensor,
    bias: torch.Tensor,
    positive: bool,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K2: (vals [B, n/128] f32, idx [B, n/128] int32).

    s = <q, c> (f32 sum of exact bf16 products) + bias (+ qsq when
    ``positive``). The key is s's bits (``positive``) or their total-order
    flip, with the low 7 bits replaced by the chunk; min over each strided
    bucket. vals are the winning key with its low 7 bits cleared and the
    flip undone, i.e. quantized exactly as the kernel quantizes them. A bf16
    score just below 0 under ``positive`` has negative raw bits and so sorts
    first, as in the JAX kernel."""
    b = queries.shape[0]
    n = bias.shape[0]
    if queries.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("f32 dots need TF32 off (runtime.device)")
    dots = _pad_cols(queries.float() @ corpus.float().T, n)
    s = dots + bias[None, :]
    if positive:
        s = s + qsq[:, None]
    bits = s.view(torch.int32)
    key = bits if positive else _flip(bits)
    chunk = chunk_of_rows(n, 1, s.device)
    packed = (key & ~127) | chunk[None, :]
    best = packed.reshape(b, n // GROUP, GROUP // BUCKET, BUCKET).amin(dim=2)
    vbits = best & ~127
    if not positive:
        vbits = _flip(vbits)
    g = torch.arange(n // GROUP, dtype=torch.int32, device=s.device)
    lane = torch.arange(BUCKET, dtype=torch.int32, device=s.device)
    idx = g[None, :, None] * GROUP + (best & 127) * BUCKET + lane
    return (vbits.view(torch.float32).reshape(b, n // BUCKET),
            idx.reshape(b, n // BUCKET))


def bucket_min_scan(
    queries: torch.Tensor,
    qsq: torch.Tensor,
    corpus: torch.Tensor,
    bias: torch.Tensor,
    positive: bool,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2: queries [B, d] bf16 with alpha folded in, qsq [B] f32 (read only
    when ``positive``), corpus [n_rows, d] bf16, bias [n] f32 (+inf =
    excluded; n % GROUP == 0, n_rows <= n) → (vals [B, n/128] f32,
    idx [B, n/128] int32 absolute rows). The CUDA kernel takes d % 8 == 0
    up to ``k2_max_dim()`` and tiles the queries by ``k2_query_tile``."""
    launch = CTX.launch
    t0 = clock() if launch else 0
    _check_scan_args(queries, corpus, bias, torch.bfloat16, torch.float32,
                     GROUP, align=8)
    if qsq.dtype != torch.float32 or qsq.shape != (queries.shape[0],) \
            or qsq.device != queries.device or not qsq.is_contiguous():
        raise ValueError("qsq must be a contiguous f32 [B] on the query device")
    if queries.device.type == "cpu":
        vals, idx = bucket_min_scan_plain(queries, qsq, corpus, bias, positive)
    else:
        b, d = queries.shape
        n = bias.shape[0]
        bq = k2_query_tile(b, d)
        vals = torch.empty((b, n // BUCKET), dtype=torch.float32,
                           device=queries.device)
        idx = torch.empty((b, n // BUCKET), dtype=torch.int32,
                          device=queries.device)
        lib = _library("bucket_scan_bf16")
        with torch.cuda.device(queries.device):
            rc = lib.bucket_scan_bf16(
                queries.data_ptr(), qsq.data_ptr(), corpus.data_ptr(),
                bias.data_ptr(), vals.data_ptr(), idx.data_ptr(), b, d,
                corpus.shape[0], n, int(positive), bq,
                torch.cuda.current_stream().cuda_stream,
            )
        _raise_on(lib, rc, "bucket_scan_bf16")
        _count_launch("bucket_scan_bf16")
    if t0:
        TRACE.record(SPAN["topk.scan"], t0, clock(), CTX.rid, launch,
                     queries.shape[0])
    return vals, idx


# ---------------------------------------------------------------------------
# K3: int8 scan with (vals, idx) outputs
# ---------------------------------------------------------------------------


def i8_layout(d: int) -> Tuple[int, int, int, int]:
    """(bias_clamp, sentinel, pre_shift, invalid_thresh) of K3 at padded dim
    ``d``. Scores are bias - dot with no offset, so they may be negative;
    the 4096 slack keeps valid and invalid scores apart after the pre-shift
    (which can lower a score by up to 2^pre_shift - 1)."""
    dotmax = d * 127 * 127
    bias_clamp = 1 << 22
    sentinel = bias_clamp + 2 * dotmax + 4096
    pre_shift = 0
    while (sentinel + dotmax) >> pre_shift >= (1 << 24):
        pre_shift += 1
    invalid_thresh = bias_clamp + dotmax + 2048
    return bias_clamp, sentinel, pre_shift, invalid_thresh


def make_bias_i8(
    n: int,
    d_pad: int,
    metric: str,
    corpus_sq: Optional[torch.Tensor],
    inv_two_scales: torch.Tensor,
    invalid: Optional[torch.Tensor],
    filter_mask: Optional[torch.Tensor],
) -> torch.Tensor:
    """int32 [n] bias of K3: round(||c||^2 / (2 s_q s_c)) clipped to
    BIAS_CLAMP for l2, 0 for ip/cosine; SENTINEL for rows that must never be
    returned. f32 steps in the JAX package's order, half to even."""
    bias_clamp, sentinel, _, _ = i8_layout(d_pad)
    if metric == "l2":
        if corpus_sq is None:
            raise ValueError("l2 int8 bias needs corpus_sq")
        f = corpus_sq.to(torch.float32) * inv_two_scales
        bias = torch.clamp(torch.round(f), 0, bias_clamp).to(torch.int32)
    else:
        bias = torch.zeros((n,), dtype=torch.int32,
                           device=inv_two_scales.device)
    fill = torch.tensor(sentinel, dtype=torch.int32, device=bias.device)
    if invalid is not None:
        bias = torch.where(invalid, fill, bias)
    if filter_mask is not None:
        bias = torch.where(filter_mask, bias, fill)
    return bias


def bucket_min_scan_i8_plain(
    queries: torch.Tensor, corpus: torch.Tensor, bias: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K3: (vals [B, n/128] f32, idx [B, n/128] int32).

    s = ((bias - dot) >> pre_shift) << pre_shift with the dot in exact
    integers (an f32 matmul while d_pad * 127^2 < 2^24, f64 past that; TF32
    refused), then the min over each strided bucket and its first argmin
    (the lowest chunk on ties), as the JAX oracle
    ``bucket_min_scan_i8_reference`` computes."""
    b, d = queries.shape
    n = bias.shape[0]
    d_pad = round_up(d, 128)
    _, _, pre_shift, _ = i8_layout(d_pad)
    if queries.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("exact int8 dots need TF32 off (runtime.device)")
    ftype = torch.float32 if d_pad * 127 * 127 < (1 << 24) else torch.float64
    dots = (queries.to(ftype) @ corpus.to(ftype).T).to(torch.int32)
    dots = _pad_cols(dots, n)
    s = ((bias[None, :] - dots) >> pre_shift) << pre_shift
    sb = s.reshape(b, n // GROUP, GROUP // BUCKET, BUCKET)
    vals, amin = sb.min(dim=2)
    g = torch.arange(n // GROUP, dtype=torch.int32, device=s.device)
    lane = torch.arange(BUCKET, dtype=torch.int32, device=s.device)
    idx = g[None, :, None] * GROUP + amin.to(torch.int32) * BUCKET + lane
    return (vals.to(torch.float32).reshape(b, n // BUCKET),
            idx.reshape(b, n // BUCKET))


def bucket_min_scan_i8(
    queries: torch.Tensor, corpus: torch.Tensor, bias: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3: queries [B, d] int8, corpus [n_rows, d] int8, bias [n] int32
    (no offset; SENTINEL = excluded; n % GROUP == 0, n_rows <= n) →
    (vals [B, n/128] f32 integer-domain scores, de-pre-shifted; idx
    [B, n/128] int32 absolute rows). The layout constants come from d
    padded to 128, as in the JAX package; the CUDA kernel is K1's
    (``k1_query_tile``, ``k1_max_dim``)."""
    _check_scan_args(queries, corpus, bias, torch.int8, torch.int32, GROUP,
                     align=16)
    if queries.device.type == "cpu":
        return bucket_min_scan_i8_plain(queries, corpus, bias)
    b, d = queries.shape
    n = bias.shape[0]
    _, _, pre_shift, _ = i8_layout(round_up(d, 128))
    vals = torch.empty((b, n // BUCKET), dtype=torch.float32,
                       device=queries.device)
    idx = torch.empty((b, n // BUCKET), dtype=torch.int32,
                      device=queries.device)
    lib = _library("bucket_scan_i8_packed", "bucket_scan_i8")
    with torch.cuda.device(queries.device):
        rc = lib.bucket_scan_i8(
            queries.data_ptr(), corpus.data_ptr(), bias.data_ptr(),
            vals.data_ptr(), idx.data_ptr(), b, d, corpus.shape[0], n,
            pre_shift, k1_query_tile(b, d),
            torch.cuda.current_stream().cuda_stream,
        )
    _raise_on(lib, rc, "bucket_scan_i8_packed", "bucket_scan_i8")
    _count_launch("bucket_scan_i8")
    return vals, idx


# ---------------------------------------------------------------------------
# argument checks and binding
# ---------------------------------------------------------------------------


def _check_scan_args(queries, corpus, bias, in_dtype, bias_dtype, quantum,
                     align):
    if queries.dim() != 2 or corpus.dim() != 2 or bias.dim() != 1:
        raise ValueError("want queries [B, d], corpus [n_rows, d], bias [n]")
    if queries.dtype != in_dtype or corpus.dtype != in_dtype \
            or bias.dtype != bias_dtype:
        raise ValueError(
            f"want {in_dtype} queries and corpus and a {bias_dtype} bias, got "
            f"{queries.dtype}, {corpus.dtype}, {bias.dtype}"
        )
    if corpus.shape[1] != queries.shape[1]:
        raise ValueError("queries and corpus differ in dim")
    n = bias.shape[0]
    if n % quantum or corpus.shape[0] > n:
        raise ValueError(
            f"bias length {n} must be a multiple of {quantum} and cover the "
            f"{corpus.shape[0]} corpus rows"
        )
    if not (queries.device == corpus.device == bias.device):
        raise ValueError("queries, corpus and bias must share a device")
    if queries.device.type == "cpu":
        return
    if queries.device.type != "cuda":
        raise ValueError(f"unsupported device {queries.device}")
    if not (queries.is_contiguous() and corpus.is_contiguous()
            and bias.is_contiguous()):
        raise ValueError("the CUDA scan needs contiguous tensors")
    if queries.shape[1] % align:
        raise ValueError(f"the CUDA scan needs d % {align} == 0 (pad d)")
    for t in (queries, corpus, bias):
        if t.numel() and t.data_ptr() % 16:
            raise ValueError("the CUDA scan needs 16-byte aligned rows")


_bind_lock = threading.Lock()
_bound: Dict[Tuple[str, str], ctypes.CDLL] = {}

_P = ctypes.c_void_p
_SIGNATURES = {
    "bucket_scan_i8_packed": [
        _P, _P, _P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, _P,
    ],
    "bucket_scan_bf16": [
        _P, _P, _P, _P, _P, _P, ctypes.c_int, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, _P,
    ],
    "bucket_scan_i8": [
        _P, _P, _P, _P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, _P,
    ],
}


def _library(source: str, fn_name: Optional[str] = None) -> ctypes.CDLL:
    """The library built from ``csrc/<source>.cu`` with the C signature of
    its entry point ``fn_name`` (default: the source's name) declared."""
    fn_name = fn_name or source
    with _bind_lock:
        lib = _bound.get((source, fn_name))
        if lib is None:
            from valkey_search_tpu_torch.ops import _build

            lib = _build.load(source)
            fn = getattr(lib, fn_name)
            fn.argtypes = _SIGNATURES[fn_name]
            fn.restype = ctypes.c_int
            err = getattr(lib, f"{source}_error_string")
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            _bound[(source, fn_name)] = lib
        return lib


def _raise_on(lib: ctypes.CDLL, rc: int, source: str,
              fn_name: Optional[str] = None) -> None:
    if rc:
        msg = getattr(lib, f"{source}_error_string")(rc).decode()
        raise RuntimeError(
            f"{fn_name or source} launch failed: CUDA error {rc} ({msg})")
