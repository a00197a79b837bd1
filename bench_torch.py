#!/usr/bin/env python3
"""Benchmark of the PyTorch/CUDA port (``valkey_search_tpu_torch``) on one GPU.

The port's counterpart of ``bench.py``, with the measurements of
``scripts/crossover.py``, ``scripts/recall_shapes.py`` and
``scripts/traversal_bench.py`` folded in as sections. It imports torch,
numpy and the port, never JAX or the JAX package: the corpus recipes, the
fp64 ground truth and the child protocol are its own copies of bench.py's.

Run from the root of a checkout, on a machine with an NVIDIA card:

    python3 bench_torch.py            # every section, ~5 min on an H100
    python3 bench_torch.py --quick    # flat1m alone at 131,072 rows, B <= 2,048

Structure (as bench.py's):

  * the PARENT runs the host-only work (the text section through the port's
    Engine, the one-core CPU brute-force baseline through ``native/``'s
    ``bf_topk``), writes the shared corpus to /dev/shm, and runs one CHILD
    process a device section (``bench_torch.py --section NAME``), one after
    another, under a budget with a watchdog;
  * a child streams one JSON object a line on stdout: ``{"m": {...}}`` merges
    keys into the details, ``{"skip": "..."}`` marks the section dead (the
    parent records ``skip_<name>``), ``{"done": 1}`` ends it;
  * the last line of stdout is one JSON object of at most 1,500 characters
    (metric, value, unit, vs_baseline, device, one headline a section); the
    whole merged details go to ``bench_torch_out/details.json``.

Sections: flat1m (1M x 128 FLAT under int8, K1b, and bfloat16, K2: recall,
QPS of the device program and of search_batch at B = 1,024 and 16,384 as
the median of 5, per-batch service time, single-query latency, open-loop
load through the batcher, hybrid selectivity, a torch.profiler split);
big10m (10,092,544 rows made on the card: the fused int8 scan and IVF at
probe 8/16/32); crossover (scan against IVF at 1M, 2M, 4M); hnsw1m (the
device build of 1M rows, the scan route, the walk's batch x ef grid beside
the native walk); cosine (GloVe shape); shapes (three 1,048,576-row shapes,
the span x coarse-factor sweep); ivf100m (the streaming build of
100,925,440 rows and its searches).

Without a card the run exits non-zero before any section; the CPU is used
only under ``--device cpu`` (the tests). A section that dies leaves its
``skip_<section>`` marker and the run exits 3; the watchdog's exit is 2.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import signal
import subprocess
import sys
import threading
import time
from typing import Dict, List, NamedTuple, Optional

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

D = 128
K = 10
N_CENTERS = 1024
FULL_N = 1_000_000
QUICK_N = 131_072  # the smallest store the fused scan (K1, K2) serves
FULL_BATCH = 65536  # bench.py's BATCH: the query stream depends on it
QUICK_BATCH = 2048
N_GT = 256  # fp64 ground-truth queries a section
RECALL_FLOOR = 0.99
REPS = 5  # timed calls a point, after one warm-up call
LAST_LINE_MAX = 1500
SCAN_QUANTUM = 131072  # span 8 x 16,384 rows: no padded scan at >= 1M rows
METRIC = "SIFT1M-shape k-NN QPS on one GPU at recall@10 >= 0.99"
# flat1m's QPS timings run over noisy copies of the queries, as bench.py's
NOISY_COPIES = 5

_T0 = time.perf_counter()


class Opts(NamedTuple):
    quick: bool = False
    device: str = "cuda"
    n: int = FULL_N
    batch: int = FULL_BATCH
    budget_s: float = 2000.0
    out: str = os.path.join(REPO, "bench_torch_out")
    section: Optional[str] = None

    def argv(self) -> List[str]:
        """The command-line arguments that give these options."""
        out = ["--device", self.device, "--n", str(self.n), "--batch",
               str(self.batch), "--budget-s", str(self.budget_s), "--out",
               self.out]
        return out + (["--quick"] if self.quick else [])


def parse_args(argv) -> Opts:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--quick", action="store_true",
                   help="flat1m alone at 131,072 rows, B <= 2,048")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--n", type=int, default=None,
                   help="rows of the 1M corpus (every other size scales)")
    p.add_argument("--batch", type=int, default=None,
                   help="queries of the recipe (65,536; 2,048 quick)")
    p.add_argument("--budget-s", type=float, default=2000.0)
    p.add_argument("--out", default=os.path.join(REPO, "bench_torch_out"))
    p.add_argument("--section", default=None)
    a = p.parse_args(argv)
    n = a.n or (QUICK_N if a.quick else FULL_N)
    batch = a.batch or (QUICK_BATCH if a.quick else FULL_BATCH)
    return Opts(a.quick, a.device, n, batch, a.budget_s,
                os.path.abspath(a.out), a.section)


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


class Sizes(NamedTuple):
    """Every size the sections use. Full size at ``n`` = 1,000,000; a
    smaller ``n`` scales every row count by n / 1,000,000 (kept at the
    scan quantum at least) and caps every batch at the recipe's ``batch``;
    ``cuts`` lists what changed."""
    flat_batches: tuple
    service_batches: tuple
    latency_samples: int
    load_rates: tuple
    load_seconds: float
    big_n: int
    big_batches: tuple
    big_probes: tuple
    xover_ns: tuple
    xover_b: int
    xover_probes: tuple
    hnsw_n: int
    hnsw_batches: tuple
    hnsw_efs: tuple
    native_queries: int
    cos_n: int
    cos_queries: int
    shapes_n: int
    shapes_b: int
    stream_chunks: int
    stream_chunk: int
    stream_b: int
    stream_probes: tuple
    stream_rescored: tuple
    text_docs: int
    cpu_queries: int
    cuts: tuple


def sizes(opts: Opts) -> Sizes:
    r = min(1.0, opts.n / FULL_N)

    def rows(full: int, quantum: int = SCAN_QUANTUM) -> int:
        return full if r == 1.0 else round_up(max(quantum, int(full * r)),
                                               quantum)

    def bs_(*full):
        return tuple(sorted({min(b, opts.batch) for b in full}))

    s = Sizes(
        flat_batches=bs_(1024, 16384),
        service_batches=bs_(1, 8, 64, 512),
        latency_samples=200 if opts.quick else 1200,
        load_rates=(10_000, 50_000, 200_000),
        load_seconds=3.0,
        big_n=rows(round_up(10_000_000, SCAN_QUANTUM)),
        big_batches=bs_(1024, 16384),
        big_probes=(8, 16, 32),
        xover_ns=tuple(sorted({rows(round_up(m, SCAN_QUANTUM))
                               for m in (1_000_000, 2_000_000, 4_000_000)})),
        xover_b=min(16384, opts.batch),
        xover_probes=(8, 12, 16, 32),
        hnsw_n=opts.n,
        hnsw_batches=bs_(256, 1024),
        hnsw_efs=(10, 50, 100),
        native_queries=200,
        cos_n=1_183_514 if r == 1.0 else max(2048, int(1_183_514 * r)),
        cos_queries=4096,
        shapes_n=rows(1_048_576),
        shapes_b=min(16384, opts.batch),
        stream_chunks=154,
        stream_chunk=rows(10 * 65536, 1024),
        stream_b=min(512, opts.batch),
        stream_probes=(64, 128, 256),
        stream_rescored=(128, 256),
        text_docs=100_000 if r == 1.0 else max(2000, int(100_000 * r)),
        cpu_queries=8 if opts.quick else 16,
        cuts=(),
    )
    cuts = []
    if opts.quick:
        cuts.append(f"quick: flat1m alone at {opts.n} rows, batches "
                    f"{list(s.flat_batches)}, {s.latency_samples} latency "
                    "samples, no load or hybrid points")
    elif r < 1.0:
        cuts.append(f"every row count scaled by {opts.n}/{FULL_N} (floor "
                    f"{SCAN_QUANTUM} rows)")
    if opts.batch < FULL_BATCH and not opts.quick:
        cuts.append(f"batches capped at {opts.batch}")
    return s._replace(cuts=tuple(cuts))


# ---------------------------------------------------------------------------
# corpus recipes (copies of bench.py's, seeded; bit-identical to its streams)
# ---------------------------------------------------------------------------


def gen_centers() -> np.ndarray:
    rng = np.random.default_rng(42)
    return rng.standard_normal((N_CENTERS, D)).astype(np.float32) * 60 + 128


def gen_corpus_and_queries(n: int, batch: int):
    """SIFT-like data: byte-valued features with strong cluster structure
    (bench.py:83, seed 42; the stream of BASELINE_ref_1m.json). The queries
    are drawn after the corpus, ``batch`` of them, so the query stream
    depends on ``batch``."""
    rng = np.random.default_rng(42)
    centers = rng.standard_normal((N_CENTERS, D)).astype(np.float32) * 60 + 128
    assign = rng.integers(0, N_CENTERS, size=n)
    corpus = np.clip(
        centers[assign] + rng.standard_normal((n, D)).astype(np.float32) * 20,
        0, 255,
    ).astype(np.float32)
    q_assign = rng.integers(0, N_CENTERS, size=batch)
    queries = np.clip(
        centers[q_assign]
        + rng.standard_normal((batch, D)).astype(np.float32) * 20,
        0, 255,
    ).astype(np.float32)
    return centers, corpus, queries


def gen_cosine(n: int):
    """bench.py's cosine recipe (its section_cosine, seed 23): n rows of
    d 100 around 512 centers, and 4,096 queries."""
    gd = 100
    rngc = np.random.default_rng(23)
    gcent = rngc.standard_normal((512, gd)).astype(np.float32)
    gass = rngc.integers(0, 512, n)
    gcorp = gcent[gass] + rngc.standard_normal((n, gd)).astype(np.float32) * 0.6
    gq = gcent[rngc.integers(0, 512, 4096)] + \
        rngc.standard_normal((4096, gd)).astype(np.float32) * 0.6
    return gcorp, gq


def fp64_gt(corpus, queries, k):
    """fp64 ground truth via BLAS matvec (|c|^2 - 2 c.q ordering), on the
    host (bench.py's fp64_gt)."""
    c64 = np.asarray(corpus, np.float64)
    c64_sq = np.einsum("ij,ij->i", c64, c64)
    out = []
    for q in np.asarray(queries, np.float64):
        dd = c64_sq - 2.0 * (c64 @ q)  # + |q|^2 constant: same ordering
        part = np.argpartition(dd, k)[:k]
        out.append(part[np.argsort(dd[part])])
    return np.stack(out)


def shm_paths(opts: Opts, pid: int):
    shm = "/dev/shm" if os.access("/dev/shm", os.W_OK) else (
        os.environ.get("TMPDIR") or "/tmp")
    stem = os.path.join(shm, f"vstpu_torch_bench_{pid}_{opts.n}_{opts.batch}")
    return stem + "_corpus.npy", stem + "_queries.npy"


def load_shared(opts: Opts):
    """The parent's corpus and queries (mmapped), regenerated if absent."""
    corpus_p, queries_p = shm_paths(opts, os.getppid())
    if os.path.exists(corpus_p) and os.path.exists(queries_p):
        return np.load(corpus_p), np.load(queries_p)
    _, corpus, queries = gen_corpus_and_queries(opts.n, opts.batch)
    return corpus, queries


# ---------------------------------------------------------------------------
# child protocol: one JSON object per stdout line (bench.py's)
#   {"m": {...}}   merge these keys into the details
#   {"skip": "x"}  the section died; the parent records skip_<name>
#   {"done": 1}    clean completion
# ---------------------------------------------------------------------------


def _plain(x):
    if isinstance(x, np.generic):
        return x.item()
    if isinstance(x, np.ndarray):
        return x.tolist()
    raise TypeError(f"not JSON: {type(x).__name__}")


def emit_merge(d: dict) -> None:
    print(json.dumps({"m": d}, default=_plain), flush=True)


def emit_skip(reason) -> None:
    print(json.dumps({"skip": str(reason)[:500]}), flush=True)


def emit_done() -> None:
    print(json.dumps({"done": 1}), flush=True)


def read_child_lines(lines, details: dict):
    """Apply a child's stdout lines to ``details``; returns (skip reason or
    None, done). Lines that are not protocol JSON are ignored."""
    skipped, done = None, False
    for line in lines:
        line = line.strip()
        if not line:
            continue
        try:
            msg = json.loads(line)
        except ValueError:
            continue
        if not isinstance(msg, dict):
            continue
        if "m" in msg:
            details.update(msg["m"])
        elif "skip" in msg:
            skipped = msg["skip"]
        elif "done" in msg:
            done = True
    return skipped, done


def log(msg: str) -> None:
    tag = f" {_SECTION[0]}" if _SECTION[0] else ""
    print(f"[bench_torch{tag} {time.perf_counter() - _T0:7.1f}s] {msg}",
          file=sys.stderr, flush=True)


_SECTION: List[Optional[str]] = [None]


# ---------------------------------------------------------------------------
# device helpers (torch and the port are imported inside functions: this
# module is imported by the tests and by a parent that may have no card)
# ---------------------------------------------------------------------------


def child_device(opts: Opts):
    """torch and the section's device; raises when the card is missing."""
    import torch

    from valkey_search_tpu_torch.runtime.device import set_device

    if opts.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device (torch.cuda.is_available() is "
                           "False); --device cpu runs on the host")
    dev = set_device(opts.device)
    log(f"device {dev}"
        + (f" {torch.cuda.get_device_name(0)}" if dev.type == "cuda" else ""))
    return torch, dev


def sync(torch, dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def timed(torch, dev, fns):
    """One warm-up call of ``fns[0]``, then each of ``fns`` once: the last
    result and each call's seconds on the host clock, synchronised."""
    out = fns[0]()
    sync(torch, dev)
    times = []
    for fn in fns:
        t0 = time.perf_counter()
        out = fn()
        sync(torch, dev)
        times.append(time.perf_counter() - t0)
    return out, times


def qps_record(b: int, times, ids=None, gt=None) -> dict:
    med = float(np.median(times))
    rec = {"b": b, "qps": b / med, "qps_min": b / max(times),
           "qps_max": b / min(times), "ms": [t * 1e3 for t in times]}
    if ids is not None:
        rec["recall"] = recall(ids, gt)
    return rec


def events_ms(torch, dev, fn, reps: int) -> float:
    """Mean time of ``fn`` over ``reps`` calls after one warm-up: CUDA
    events on the card, the host clock on the CPU."""
    fn()
    sync(torch, dev)
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize(dev)
    return start.elapsed_time(end) / reps


def recall(ids, gt) -> float:
    """recall@K of ``ids`` [>= len(gt), >= K] against ``gt`` [n, K]."""
    ids = np.asarray(ids)
    return float(np.mean([
        len(set(ids[b, :K].tolist()) & set(np.asarray(gt[b]).tolist())) / K
        for b in range(len(gt))
    ]))


def fp64_gt_device(torch, corpus_t, queries, dev, metric: str = "l2",
                   allowed=None, rows: int = 1 << 20) -> np.ndarray:
    """Exact top-K of ``queries`` over ``corpus_t`` [n, d] in float64 on
    ``dev``, ``rows`` corpus rows at a time, among the rows ``allowed``
    (bool tensor [n]) when given: l2 by |c|^2 - 2 c.q, ip by -c.q."""
    q = torch.as_tensor(np.asarray(queries), device=dev).to(torch.float64)
    best_d = best_i = None
    for s in range(0, corpus_t.shape[0], rows):
        c = corpus_t[s:s + rows].to(torch.float64)
        dd = -(q @ c.T)
        if metric == "l2":
            dd = (c * c).sum(1)[None, :] + 2.0 * dd
        if allowed is not None:
            dd = dd.masked_fill(~allowed[s:s + rows][None, :], float("inf"))
        d, i = torch.topk(dd, min(K, dd.shape[1]), largest=False)
        i = i + s
        if best_d is not None:
            d, pos = torch.topk(torch.cat([best_d, d], 1), K, largest=False)
            i = torch.cat([best_i, i], 1).gather(1, pos)
        best_d, best_i = d, i
        del c, dd
    return best_i.cpu().numpy()


def device_mirrors(torch, vecs):
    """The FLAT store's scan mirrors of a device corpus: its int8 copy (the
    store's own ``_quantize_i8``), |c|^2 and an all-valid mask."""
    from valkey_search_tpu_torch.indexes.vector_base import _quantize_i8
    from valkey_search_tpu_torch.ops.distance import squared_norms

    i8, scale = _quantize_i8(vecs)
    return {"vectors": vecs, "vectors_i8": i8, "i8_scale": scale,
            "norms_sq": squared_norms(vecs),
            "invalid": torch.zeros(vecs.shape[0], dtype=torch.bool,
                                   device=vecs.device)}


def sift_rows(torch, dev, centers_t, m: int, seed: int):
    """``m`` rows of the SIFT-like recipe made on ``dev``: a cluster a row
    and N(0, 20^2) noise from a torch.Generator seeded ``seed``, clipped to
    [0, 255]. (jax.random has no torch counterpart: this stream differs
    from bench.py's device-made corpora; the recipe is the same.)"""
    gen = torch.Generator(device=dev).manual_seed(seed)
    a = torch.randint(0, N_CENTERS, (m,), generator=gen, device=dev)
    noise = torch.randn((m, D), generator=gen, device=dev)
    return (centers_t[a] + noise * 20).clamp_(0, 255)


def device_corpus(torch, dev, n: int, chunk: int = 1_000_000):
    """The SIFT-like recipe at ``n`` rows on ``dev``: bench's centers (seed
    42), then chunk c of ``chunk`` rows from generator seed 42,000 + c (the
    10M corpus of chip_smoke.py's ivf phase, row for row)."""
    centers_t = torch.as_tensor(gen_centers(), device=dev)
    out = torch.empty((n, D), dtype=torch.float32, device=dev)
    for c, s in enumerate(range(0, n, chunk)):
        out[s:s + chunk] = sift_rows(torch, dev, centers_t,
                                     min(chunk, n - s), 42_000 + c)
    return out


def fused_scan(topk_ops, snap, q_t, k: int = K, span=None, cf=None,
               filter_mask=None):
    """The fused scan over a whole mirror: what search_batch runs at these
    sizes (K1 on an int8 mirror, K2 on a bf16 one)."""
    cap = snap["vectors"].shape[0]
    return topk_ops.flat_topk_fused(
        q_t, snap["vectors"], snap.get("vectors_lp"), k=k, metric="l2",
        corpus_sq=snap["norms_sq"], invalid=snap["invalid"],
        filter_mask=filter_mask, block_rows=cap,
        corpus_i8=snap.get("vectors_i8"), i8_scale=snap.get("i8_scale"),
        span=span, coarse_factor=cf)


def flat_launch(topk_ops, config, snap, q_t, k: int = K, filter_mask=None):
    """bench.py's ``launch``: the device program search_batch runs on the
    store's snapshot, without the host copies around it."""
    cap = snap["vectors"].shape[0]
    blk = int(config.get("search.flat-block-size"))
    two_stage = (("vectors_lp" in snap or "vectors_i8" in snap)
                 and str(config.get("search.topk-mode")) == "approx")
    if two_stage and topk_ops.use_fused_scan(cap, filter_mask,
                                             snap["vectors"]):
        return topk_ops.flat_topk_fused(
            q_t, snap["vectors"], snap.get("vectors_lp"), k=k, metric="l2",
            corpus_sq=snap["norms_sq"], invalid=snap["invalid"],
            filter_mask=filter_mask, block_rows=max(blk, cap),
            corpus_i8=snap.get("vectors_i8"), i8_scale=snap.get("i8_scale"),
            span=int(config.get("search.scan-span")) or None,
            coarse_factor=int(config.get("search.scan-coarse-factor")) or None)
    if two_stage and "vectors_lp" in snap:
        return topk_ops.flat_topk_two_stage(
            q_t, snap["vectors"], snap["vectors_lp"], k=k, metric="l2",
            corpus_sq=snap["norms_sq"], invalid=snap["invalid"],
            filter_mask=filter_mask, block_rows=blk)
    return topk_ops.flat_topk(
        q_t, snap["vectors"], k=k, metric="l2", corpus_sq=snap["norms_sq"],
        invalid=snap["invalid"], filter_mask=filter_mask, block_rows=blk,
        mode=str(config.get("search.topk-mode")))


def build_flat(torch, dev, corpus, dtype: str, metric: str = "l2"):
    """A FlatVectorIndex over ``corpus`` under ``search.corpus-dtype``
    ``dtype``, published: (index, snapshot, seconds)."""
    from valkey_search_tpu_torch.indexes.flat import FlatVectorIndex
    from valkey_search_tpu_torch.runtime import config

    config.set_config("search.corpus-dtype", dtype)
    t0 = time.perf_counter()
    idx = FlatVectorIndex(dim=corpus.shape[1], metric=metric, device=dev)
    idx.bulk_load([f"doc:{i}" for i in range(len(corpus))], corpus)
    snap = idx.store.device_snapshot()
    sync(torch, dev)
    return idx, snap, time.perf_counter() - t0


@contextlib.contextmanager
def profiled_ranges(topk_ops):
    """record_function ranges around the fused path's torch stages, for
    profiled calls: ``bench.select`` (the survivor top-k) and
    ``bench.rescore`` (the fp32 gather, product and top-k; the top-k inside
    it counts there). The scans launch through ctypes and are matched by
    kernel name (``profile_split``)."""
    from torch.profiler import record_function

    inside = threading.local()
    saved = {"topk_smallest": topk_ops.topk_smallest,
             "_rescore_exact": topk_ops._rescore_exact}

    def wrap(fn, label, guard=False):
        def wrapped(*args, **kwargs):
            if getattr(inside, "rescore", False) and not guard:
                return fn(*args, **kwargs)
            with record_function(label):
                if guard:
                    inside.rescore = True
                try:
                    return fn(*args, **kwargs)
                finally:
                    if guard:
                        inside.rescore = False
        return wrapped

    topk_ops.topk_smallest = wrap(saved["topk_smallest"], "bench.select")
    topk_ops._rescore_exact = wrap(saved["_rescore_exact"], "bench.rescore",
                                   guard=True)
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(topk_ops, name, fn)


SCAN_KERNELS = ("scan_i8", "scan_bf16")  # K1 / K3 and K2's kernel names


def profile_split(torch, dev, fn, reps: int = 1) -> dict:
    """torch.profiler over ``reps`` calls of ``fn`` (after a warm-up), per
    call: wall ms, device busy ms (the kernels' summed durations), the
    hand-written scans (K1, K2: launched through ctypes, so matched by
    kernel name, not by range), the device ms under the other ``bench.*``
    ranges, the copies (Memcpy) and the rest; host = wall - device busy."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if dev.type != "cuda":
        return {"device": "not measured (cpu)"}
    fn()
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize(dev)
        wall = (time.perf_counter() - t0) * 1e3 / reps
    dev_events = [e for e in prof.events()
                  if e.device_type == DeviceType.CUDA
                  and not e.is_user_annotation]

    def ms(events):
        return sum(e.time_range.elapsed_us() for e in events) / 1e3 / reps

    busy = ms(dev_events)
    copies = ms([e for e in dev_events if e.name.startswith("Memcpy")])
    split = {"bench.scan": ms([e for e in dev_events
                               if any(k in e.name for k in SCAN_KERNELS)])}
    for e in prof.events():
        if e.device_type == DeviceType.CPU and e.name.startswith("bench."):
            split[e.name] = (split.get(e.name, 0.0)
                             + e.device_time_total / 1e3 / reps)
    kernels: Dict[str, float] = {}
    for e in dev_events:
        kernels[e.name[:80]] = (kernels.get(e.name[:80], 0.0)
                                + e.time_range.elapsed_us() / 1e3 / reps)
    top = dict(sorted(kernels.items(), key=lambda kv: -kv[1])[:12])
    return {"calls": reps, "wall_ms": wall, "device_busy_ms": busy,
            "copies_ms": copies, "by_range_ms": split,
            "other_kernels_ms": busy - copies - sum(split.values()),
            "host_ms": wall - busy, "device_share": busy / wall,
            "kernels_ms": top, "device_ops": len(dev_events) / reps}


# ---------------------------------------------------------------------------
# section: flat1m
# ---------------------------------------------------------------------------


def load_point(torch, batcher_mod, index, queries, rate_qps: int,
               seconds: float, n_threads: int = 8) -> dict:
    """Open-loop arrivals through the query batcher (bench.py's
    load_point): ``n_threads`` submitters share a schedule of 2 ms ticks
    at ``rate_qps``; each request is timed from the tick it was due at to
    its reply, so a generator that falls behind shows in the latency too,
    and how late each tick ran is kept. Past 50,000 requests in flight a
    request is shed, and the ticks still due when the ``seconds`` end are
    never sent (both counted, never timed)."""
    lats: List[float] = []
    late: List[float] = []
    lock = threading.Lock()
    counts = {"submitted": 0, "done": 0, "failed": 0, "shed": 0,
              "unsent": 0}
    per_tick = max(1, int(rate_qps * 0.002))
    spacing = 0.002 * n_threads
    max_inflight = 50_000
    pool = np.random.default_rng(13).integers(0, len(queries), 4096)

    def on_done(t_due):
        def cb(fut):
            dt = (time.perf_counter() - t_due) * 1e3
            with lock:
                counts["done"] += 1
                if fut.exception() is None:
                    lats.append(dt)
                else:
                    counts["failed"] += 1
        return cb

    t_start = time.perf_counter()
    stop_t = t_start + seconds

    def submitter(tid: int) -> None:
        rng = np.random.default_rng(100 + tid)
        due = t_start + tid * 0.002
        while due < stop_t:
            now = time.perf_counter()
            if now >= stop_t:  # the ticks still due were never sent
                with lock:
                    counts["unsent"] += per_tick * int(
                        -(-(stop_t - due) // spacing))
                return
            if now < due:
                time.sleep(min(due - now, 0.002))
                continue
            with lock:
                late.append((now - due) * 1e3)
            for _ in range(per_tick):
                with lock:
                    inflight = counts["submitted"] - counts["done"]
                    if inflight > max_inflight:
                        counts["shed"] += 1
                        continue
                    counts["submitted"] += 1
                qi = int(pool[rng.integers(0, 4096)])
                fut = batcher_mod.submit(index, queries[qi], K)
                fut.add_done_callback(on_done(due))
            due += spacing

    threads = [threading.Thread(target=submitter, args=(t,))
               for t in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    deadline = time.perf_counter() + 30
    while time.perf_counter() < deadline:
        with lock:
            if counts["done"] >= counts["submitted"]:
                break
        time.sleep(0.05)
    wall = time.perf_counter() - t_start
    lats.sort()
    late.sort()
    n = len(lats)
    pt = {"offered_qps": rate_qps, "seconds": seconds, **counts,
          "unanswered": counts["submitted"] - counts["done"],
          "achieved_qps": n / wall, "samples": n,
          "generator_late_ms_p50": late[len(late) // 2] if late else None,
          "generator_late_ms_max": late[-1] if late else None}
    if n:
        pt["p50_ms"] = lats[n // 2]
        pt["p99_ms"] = lats[min(n - 1, int(n * 0.99))]
    return pt


def flat_dtype(torch, dev, opts: Opts, sz: Sizes, dtype: str, corpus,
               corpus_t, queries, copies, gt) -> dict:
    """Every flat1m measurement under one ``search.corpus-dtype``."""
    from valkey_search_tpu_torch.ops import bucket_scan as bs
    from valkey_search_tpu_torch.ops import topk as topk_ops
    from valkey_search_tpu_torch.query import batcher as batcher_mod
    from valkey_search_tpu_torch.runtime import config

    bs.reset_launches()
    idx, snap, build_s = build_flat(torch, dev, corpus, dtype)
    cap = snap["vectors"].shape[0]
    out = {"dtype": dtype, "build_s": build_s, "capacity": cap,
           "fused_scan": topk_ops.use_fused_scan(cap, None, snap["vectors"])}
    log(f"flat {dtype}: bulk_load + publish {build_s:.2f} s, capacity {cap}")

    # recall of both routes at the headline batch, the first N_GT rows
    head = max(sz.flat_batches)
    _, ids_s = idx.search_batch(queries[:head], K)
    q_head = torch.from_numpy(queries[:head]).to(dev)
    _, ids_l = flat_launch(topk_ops, config, snap, q_head)
    ids_l = ids_l.cpu().numpy()
    out["recall"] = recall(ids_s[:N_GT], gt)
    out["recall_launch"] = recall(ids_l[:N_GT], gt)
    out["routes_equal_rows"] = float(np.mean(
        (ids_s == ids_l).all(axis=1)))
    log(f"flat {dtype}: recall@10 {out['recall']:.4f} (search_batch), "
        f"{out['recall_launch']:.4f} (device program), B={head}")

    # throughput: the device program and search_batch, REPS noisy copies
    qps = {}
    for b in sz.flat_batches:
        dev_copies = [torch.from_numpy(c[:b]).to(dev) for c in copies]
        _, times = timed(torch, dev, [
            (lambda qc=qc: flat_launch(topk_ops, config, snap, qc))
            for qc in dev_copies])
        qps[f"launch/B={b}"] = qps_record(b, times)
        _, times = timed(torch, dev, [
            (lambda c=c: idx.search_batch(c[:b], K)) for c in copies])
        qps[f"search_batch/B={b}"] = qps_record(b, times)
        del dev_copies
        log(f"flat {dtype} B={b}: device program "
            f"{qps[f'launch/B={b}']['qps']:.0f} qps, search_batch "
            f"{qps[f'search_batch/B={b}']['qps']:.0f} qps (median of "
            f"{len(times)})")
    out["qps"] = qps

    # per-batch service time of the device program: CUDA events over 20
    # back-to-back calls (the device timeline, with the gaps the host
    # leaves between launches), and the kernels' own time a call
    service, busy = {}, {}
    for b in sz.service_batches:
        qb = q_head[:b]

        def launch_b(qb=qb):
            return flat_launch(topk_ops, config, snap, qb)

        service[str(b)] = events_ms(torch, dev, launch_b, reps=20)
        prof = profile_split(torch, dev, launch_b, reps=10)
        busy[str(b)] = prof.get("device_busy_ms")
    out["service_ms"] = service
    out["service_device_busy_ms"] = busy
    out["qps_at_service_le_10ms"] = max(
        (int(b) / (ms / 1e3) for b, ms in service.items() if 0 < ms <= 10.0),
        default=0.0)
    log(f"flat {dtype} service ms: {json.dumps(service)}; device busy ms: "
        f"{json.dumps(busy)}")

    # single-query latency through search_batch, distinct queries
    lat = []
    for i in range(sz.latency_samples):
        q1 = queries[i % len(queries)][None, :]
        t0 = time.perf_counter()
        idx.search_batch(q1, K)
        lat.append((time.perf_counter() - t0) * 1e3)
    lat.sort()
    n_lat = len(lat)
    out["latency"] = {"samples": n_lat, "p50_ms": lat[n_lat // 2],
                      "p99_ms": lat[min(n_lat - 1, int(n_lat * 0.99))],
                      "max_ms": lat[-1]}
    log(f"flat {dtype} single query: {json.dumps(out['latency'])}")

    if not opts.quick:
        for _ in range(3):
            batcher_mod.submit(idx, queries[0], K).result()
        load = {}
        for rate in sz.load_rates:
            load[str(rate)] = load_point(torch, batcher_mod, idx, queries,
                                         rate, sz.load_seconds)
            log(f"flat {dtype} load {rate}: {json.dumps(load[str(rate)])}")
        out["load"] = load

        hybrid = {}
        rng3 = np.random.default_rng(11)
        n = len(corpus)
        for sel in (1, 10, 50):
            mask = torch.from_numpy(rng3.random(cap) < sel / 100).to(dev)
            gt_m = fp64_gt_device(torch, corpus_t, queries[:N_GT], dev,
                                  allowed=mask[:n])
            dev_copies = [torch.from_numpy(c[:head]).to(dev) for c in copies]
            _, times = timed(torch, dev, [
                (lambda qc=qc, m=mask: flat_launch(topk_ops, config, snap, qc,
                                                   filter_mask=m))
                for qc in dev_copies])
            _, ids = flat_launch(topk_ops, config, snap, q_head,
                                 filter_mask=mask)
            ids = ids.cpu().numpy()
            allowed = mask.cpu().numpy()
            rec = qps_record(head, times, ids[:N_GT], gt_m)
            rec["outside"] = int((~allowed[np.clip(ids, 0, cap - 1)]
                                  & (ids >= 0)).sum())
            hybrid[f"{sel}pct"] = rec
            log(f"flat {dtype} hybrid {sel}%: {rec['qps']:.0f} qps, recall "
                f"{rec['recall']:.4f}, {rec['outside']} outside")
            del dev_copies
        out["hybrid"] = hybrid

    q_prof = queries[:min(1024, len(queries))]
    with profiled_ranges(topk_ops):
        out["profile_b1024"] = profile_split(
            torch, dev, lambda: idx.search_batch(q_prof, K), reps=5)
    log(f"flat {dtype} profile B={len(q_prof)}: "
        + json.dumps(out["profile_b1024"]))
    out["launches"] = bs.launch_counts()
    del idx, snap
    return out


def section_flat1m(opts: Opts) -> None:
    torch, dev = child_device(opts)
    sz = sizes(opts)
    corpus, queries = load_shared(opts)
    corpus_t = torch.from_numpy(corpus).to(dev)
    gt = fp64_gt_device(torch, corpus_t, queries[:N_GT], dev)
    rng2 = np.random.default_rng(7)
    head = max(sz.flat_batches)
    copies = [np.ascontiguousarray(
        (queries + rng2.standard_normal(queries.shape).astype(np.float32)
         )[:head]) for _ in range(NOISY_COPIES)]
    emit_merge({"flat1m_n": len(corpus), "flat1m_gt_queries": N_GT,
                "flat1m_batches": list(sz.flat_batches)})
    for dtype in ("int8", "bfloat16"):
        res = flat_dtype(torch, dev, opts, sz, dtype, corpus, corpus_t,
                         queries, copies, gt)
        emit_merge({f"flat1m_{dtype}": res})


# ---------------------------------------------------------------------------
# section: big10m (bench.py's, the corpus made on the card)
# ---------------------------------------------------------------------------


def ivf_sweep(torch, dev, ivf_ops, iv, vecs, queries, gt, batches, probes):
    """ivf_search_rescored (the engine's route) at each probe and batch:
    QPS (median of REPS), recall, the stage-2 route taken."""
    from valkey_search_tpu_torch.runtime.metrics import STATS

    out = {}
    for probe in probes:
        for b in batches:
            q_t = torch.from_numpy(queries[:b]).to(dev)
            g0, s0 = (STATS.get("ivf_stage2_grouped"),
                      STATS.get("ivf_stage2_steps"))
            (_, ids), times = timed(torch, dev, [
                lambda: ivf_ops.ivf_search_rescored(iv, q_t, vecs, k=K,
                                                    probe=probe)] * REPS)
            rec = qps_record(b, times, ids.cpu().numpy()[:len(gt)], gt)
            rec["route"] = ("grouped" if STATS.get("ivf_stage2_grouped") > g0
                            else "steps" if STATS.get("ivf_stage2_steps") > s0
                            else "none")
            out[f"probe={probe}/B={b}"] = rec
            log(f"IVF probe {probe} B={b}: {rec['qps']:.0f} qps, recall "
                f"{rec['recall']:.4f} ({rec['route']})")
    return out


def build_ivf(torch, dev, ivf_ops, config, vecs):
    """build_ivf_device with the engine's options, timed by stage."""
    timings: Dict[str, float] = {}
    sync(torch, dev)
    t0 = time.perf_counter()
    iv = ivf_ops.build_ivf_device(
        vecs, block_rows=int(config.get("search.ivf-block-rows")),
        n_clusters=int(config.get("search.ivf-clusters")), timings=timings)
    sync(torch, dev)
    return iv, {"build_s": time.perf_counter() - t0, "stages_s": timings,
                "n_blocks": iv.n_blocks,
                "device_gib": iv.device_bytes() / 2**30}


def scan_points(torch, dev, topk_ops, snap, queries, gt, batches) -> dict:
    out = {}
    for b in batches:
        q_t = torch.from_numpy(queries[:b]).to(dev)
        (_, ids), times = timed(torch, dev,
                                [lambda: fused_scan(topk_ops, snap, q_t)] * REPS)
        out[f"B={b}"] = qps_record(b, times, ids.cpu().numpy()[:len(gt)], gt)
        log(f"scan {snap['vectors'].shape[0]} rows B={b}: "
            f"{out[f'B={b}']['qps']:.0f} qps, recall "
            f"{out[f'B={b}']['recall']:.4f}")
    return out


def section_big10m(opts: Opts) -> None:
    torch, dev = child_device(opts)
    from valkey_search_tpu_torch.ops import bucket_scan as bs
    from valkey_search_tpu_torch.ops import ivf as ivf_ops
    from valkey_search_tpu_torch.ops import topk as topk_ops
    from valkey_search_tpu_torch.runtime import config

    sz = sizes(opts)
    bs.reset_launches()
    _, queries = load_shared(opts)
    t0 = time.perf_counter()
    vecs = device_corpus(torch, dev, sz.big_n)
    snap = device_mirrors(torch, vecs)
    sync(torch, dev)
    ready_s = time.perf_counter() - t0
    gt = fp64_gt_device(torch, vecs, queries[:N_GT], dev)
    log(f"{sz.big_n} x {D} on the card in {ready_s:.1f} s; ground truth done")
    emit_merge({"big10m_n": sz.big_n, "big10m_corpus_ready_s": ready_s,
                "big10m_corpus": "made on the card: bench's centers (seed "
                                 "42), torch.Generator 42,000 + chunk a "
                                 "1,000,000-row chunk"})
    emit_merge({"big10m_scan": scan_points(torch, dev, topk_ops, snap,
                                           queries, gt, sz.big_batches)})
    emit_merge({"big10m_scan_launches": bs.launch_counts()})
    del snap
    iv, build = build_ivf(torch, dev, ivf_ops, config, vecs)
    log(f"IVF build {json.dumps(build)}")
    emit_merge({"big10m_ivf_build": build})
    emit_merge({"big10m_ivf": ivf_sweep(torch, dev, ivf_ops, iv, vecs,
                                        queries, gt, sz.big_batches,
                                        sz.big_probes),
                "big10m_launches": bs.launch_counts()})


# ---------------------------------------------------------------------------
# section: crossover (scripts/crossover.py: both routes at 1M, 2M, 4M)
# ---------------------------------------------------------------------------


def section_crossover(opts: Opts) -> None:
    torch, dev = child_device(opts)
    from valkey_search_tpu_torch.ops import bucket_scan as bs
    from valkey_search_tpu_torch.ops import ivf as ivf_ops
    from valkey_search_tpu_torch.ops import topk as topk_ops
    from valkey_search_tpu_torch.runtime import config

    sz = sizes(opts)
    bs.reset_launches()
    _, queries = load_shared(opts)
    points = {}
    for n in sz.xover_ns:
        vecs = device_corpus(torch, dev, n)
        snap = device_mirrors(torch, vecs)
        gt = fp64_gt_device(torch, vecs, queries[:N_GT], dev)
        scan = scan_points(torch, dev, topk_ops, snap, queries, gt,
                           (sz.xover_b,))[f"B={sz.xover_b}"]
        del snap
        iv, build = build_ivf(torch, dev, ivf_ops, config, vecs)
        sweep = ivf_sweep(torch, dev, ivf_ops, iv, vecs, queries, gt,
                          (sz.xover_b,), sz.xover_probes)
        ok = [r["qps"] for r in sweep.values() if r["recall"] >= RECALL_FLOOR]
        points[str(n)] = {"scan": scan, "ivf_build": build, "ivf": sweep,
                          "ivf_qps_at_recall99": max(ok, default=None)}
        emit_merge({"crossover": dict(points), "crossover_b": sz.xover_b})
        del vecs, iv
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    emit_merge({"crossover_launches": bs.launch_counts()})


# ---------------------------------------------------------------------------
# section: hnsw1m (bench.py's, scripts/traversal_bench.py's grid folded in)
# ---------------------------------------------------------------------------


def section_hnsw1m(opts: Opts) -> None:
    torch, dev = child_device(opts)
    from valkey_search_tpu_torch.indexes.hnsw import HnswVectorIndex
    from valkey_search_tpu_torch.ops import bucket_scan as bs
    from valkey_search_tpu_torch.runtime import config

    sz = sizes(opts)
    bs.reset_launches()
    corpus, queries = load_shared(opts)
    corpus = corpus[:sz.hnsw_n]
    n_gt = min(1024, len(queries))
    corpus_t = torch.from_numpy(corpus).to(dev)
    gt = fp64_gt_device(torch, corpus_t, queries[:n_gt], dev)
    del corpus_t
    config.set_config("search.hnsw-build-mode", "device")
    try:
        idx = HnswVectorIndex(dim=D, m=16, ef_construction=200, device=dev)
        t0 = time.perf_counter()
        idx.bulk_load([f"doc:{i}" for i in range(len(corpus))], corpus)
        sync(torch, dev)
        build_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        idx.device_graph()
        sync(torch, dev)
        publish_s = time.perf_counter() - t0
        log(f"HNSW build {len(corpus)} rows: {build_s:.1f} s "
            f"({json.dumps(idx.build_seconds)}), publish {publish_s:.2f} s")
        emit_merge({"hnsw1m_n": len(corpus), "hnsw1m_ef_construction": 200,
                    "hnsw1m_build_s": build_s,
                    "hnsw1m_build_vecs_per_s": len(corpus) / build_s,
                    "hnsw1m_build_stages_s": dict(idx.build_seconds),
                    "hnsw1m_publish_s": publish_s,
                    "hnsw1m_recall_queries": n_gt})

        hq = queries[:max(sz.hnsw_batches)]
        (_, docs), times = timed(
            torch, dev, [lambda: idx.search_batch(hq, K, ef=100)] * REPS)
        scan = qps_record(len(hq), times, docs[:n_gt], gt)
        scan["dtype"] = str(config.get("search.corpus-dtype"))
        log(f"HNSW scan route B={len(hq)}: {scan['qps']:.0f} qps, recall "
            f"{scan['recall']:.4f}")
        emit_merge({"hnsw1m_scan_route": scan,
                    "hnsw1m_scan_launches": bs.launch_counts()})

        native = {}
        nq = sz.native_queries
        for ef in sz.hnsw_efs:
            ids = np.full((nq, K), -1, np.int64)
            t0 = time.perf_counter()
            for i in range(nq):
                got = idx.builder.search(queries[i], K, ef=ef)[1]
                ids[i, :len(got)] = got
            secs = time.perf_counter() - t0
            # the builder answers nodes; after a bulk load node i is doc i
            native[f"ef={ef}"] = {"qps_1core": nq / secs,
                                  "recall": recall(ids, gt[:nq]),
                                  "queries": nq}
        log(f"native walk: {json.dumps(native)}")
        emit_merge({"hnsw1m_native_walk": native})

        config.set_config("search.hnsw-scan-threshold", 0)
        walk = {}
        for b in sz.hnsw_batches:
            for ef in sz.hnsw_efs:
                qb = queries[:b]
                (_, docs), times = timed(
                    torch, dev,
                    [lambda qb=qb, ef=ef: idx.search_batch(qb, K, ef=ef)]
                    * REPS)
                rec = qps_record(b, times, docs[:min(b, n_gt)],
                                 gt[:min(b, n_gt)])
                rec["aos"] = idx._aos_tables is not None
                walk[f"B={b}/ef={ef}"] = rec
                log(f"walk B={b} ef={ef}: {rec['qps']:.0f} qps, recall "
                    f"{rec['recall']:.4f}")
                emit_merge({"hnsw1m_walk": dict(walk)})
    finally:
        config.REGISTRY.reset_all()
    emit_merge({"hnsw1m_launches": bs.launch_counts()})


# ---------------------------------------------------------------------------
# section: cosine (bench.py's GloVe-shape datum)
# ---------------------------------------------------------------------------


def section_cosine(opts: Opts) -> None:
    torch, dev = child_device(opts)
    from valkey_search_tpu_torch.ops import bucket_scan as bs

    sz = sizes(opts)
    bs.reset_launches()
    gcorp, gq = gen_cosine(sz.cos_n)
    idx, snap, build_s = build_flat(torch, dev, gcorp, "int8",
                                    metric="cosine")
    gn = gcorp / np.linalg.norm(gcorp, axis=1, keepdims=True)
    qn = gq[:N_GT] / np.linalg.norm(gq[:N_GT], axis=1, keepdims=True)
    gn_t = torch.from_numpy(np.ascontiguousarray(gn, np.float32)).to(dev)
    gt = fp64_gt_device(torch, gn_t, qn, dev, metric="ip")
    del gn_t, gn
    (_, ids), times = timed(torch, dev,
                            [lambda: idx.search_batch(gq, K)] * REPS)
    rec = qps_record(len(gq), times, ids[:N_GT], gt)
    log(f"cosine {sz.cos_n} x {gcorp.shape[1]}: {rec['qps']:.0f} qps, "
        f"recall {rec['recall']:.4f}")
    emit_merge({"cosine_n": sz.cos_n, "cosine_d": int(gcorp.shape[1]),
                "cosine_build_s": build_s, "cosine": rec,
                "cosine_launches": bs.launch_counts()})


# ---------------------------------------------------------------------------
# section: shapes (scripts/recall_shapes.py)
# ---------------------------------------------------------------------------


SHAPES = ("clustered128", "uniform128", "lowrank768")
# the JAX package's recall at its defaults on a TPU (BASELINE.md:122-126)
SHAPES_REFERENCE = {"clustered128": 0.9938, "uniform128": 0.9984,
                    "lowrank768": 0.9969}


def gen_shape(torch, dev, name: str, n: int, n_queries: int):
    """(corpus [n, d], queries [n_queries, d]) of one shape on ``dev``
    (scripts/recall_shapes.py's recipes; torch.Generator streams seeded
    11 for the rows and 12 for the queries):

      clustered128  the bench's SIFT recipe (its 1,024 centers, seed 42)
      uniform128    iid uniform in [0, 255)
      lowrank768    rank-64 latents through a fixed [64, 768] projection
                    (numpy seed 7) plus N(0, 0.25^2) noise, unit rows
    """
    def rows(m: int, seed: int):
        gen = torch.Generator(device=dev).manual_seed(seed)
        if name == "clustered128":
            centers_t = torch.as_tensor(gen_centers(), device=dev)
            a = torch.randint(0, N_CENTERS, (m,), generator=gen, device=dev)
            z = torch.randn((m, D), generator=gen, device=dev)
            return (centers_t[a] + z * 20).clamp_(0, 255)
        if name == "uniform128":
            return torch.rand((m, D), generator=gen, device=dev) * 255.0
        if name == "lowrank768":
            r, d = 64, 768
            proj = torch.as_tensor(
                (np.random.default_rng(7).standard_normal((r, d))
                 / np.sqrt(r)).astype(np.float32), device=dev)
            lat = torch.randn((m, r), generator=gen, device=dev)
            z = torch.randn((m, d), generator=gen, device=dev) * 0.25
            x = lat @ proj + z
            return x / torch.linalg.norm(x, dim=1, keepdim=True)
        raise ValueError(name)

    return rows(n, 11), rows(n_queries, 12)


def section_shapes(opts: Opts) -> None:
    torch, dev = child_device(opts)
    from valkey_search_tpu_torch.ops import bucket_scan as bs
    from valkey_search_tpu_torch.ops import topk as topk_ops

    sz = sizes(opts)
    bs.reset_launches()
    out = {}
    for name in SHAPES:
        vecs, q_t = gen_shape(torch, dev, name, sz.shapes_n, sz.shapes_b)
        snap = device_mirrors(torch, vecs)
        gt = fp64_gt_device(torch, vecs, q_t[:N_GT].cpu().numpy(), dev)
        res = {"n": sz.shapes_n, "d": int(vecs.shape[1]),
               "reference_recall": SHAPES_REFERENCE[name]}

        def point(span=None, cf=None):
            (_, ids), times = timed(torch, dev, [
                lambda: fused_scan(topk_ops, snap, q_t, span=span, cf=cf)
            ] * REPS)
            return qps_record(sz.shapes_b, times,
                              ids.cpu().numpy()[:N_GT], gt)

        res["default"] = point()
        log(f"{name} default: {res['default']['qps']:.0f} qps, recall "
            f"{res['default']['recall']:.4f}")
        sweep = {}
        for span in (4, 8):
            for cf in (4, 5, 8):
                sweep[f"s{span}cf{cf}"] = point(span, cf)
        res["sweep"] = sweep
        out[name] = res
        emit_merge({"shapes": dict(out), "shapes_b": sz.shapes_b})
        del vecs, q_t, snap
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    emit_merge({"shapes_launches": bs.launch_counts()})


# ---------------------------------------------------------------------------
# section: ivf100m (bench.py's, the port's streaming tier)
# ---------------------------------------------------------------------------


IVF_BUILD_SEED = 0x1BF  # build_ivf_streaming's k-means seed


def section_ivf100m(opts: Opts) -> None:
    torch, dev = child_device(opts)
    from valkey_search_tpu_torch.ops import bucket_scan as bs
    from valkey_search_tpu_torch.ops import ivf as ivf_ops

    sz = sizes(opts)
    bs.reset_launches()
    _, queries = load_shared(opts)
    n_ch, ch = sz.stream_chunks, sz.stream_chunk
    n = n_ch * ch
    centers_t = torch.as_tensor(gen_centers(), device=dev)

    def chunk(ci):
        return sift_rows(torch, dev, centers_t, ch, 31_000 + ci)

    if not torch.equal(chunk(0), chunk(0)):
        raise RuntimeError("chunk 0 regenerated is not bit-equal")
    sync(torch, dev)
    before = torch.cuda.memory_allocated(dev) if dev.type == "cuda" else 0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    timings: Dict[str, float] = {}
    t0 = time.perf_counter()
    index = ivf_ops.build_ivf_streaming(
        chunk, n_ch, block_rows=1024, block_align=1024, seed=IVF_BUILD_SEED,
        timings=timings, log_fn=log)
    sync(torch, dev)
    build = {"rows": n, "chunks": n_ch, "chunk_rows": ch,
             "build_seed": IVF_BUILD_SEED, "chunk_seeds": "31,000 + chunk",
             "build_s": time.perf_counter() - t0, "stages_s": timings,
             "n_blocks": index.n_blocks,
             "index_gib": index.device_bytes() / 2**30,
             "corpus_gib": n * D * 4 / 2**30}
    if dev.type == "cuda":
        peak = torch.cuda.max_memory_allocated(dev)
        build["peak_gib"] = peak / 2**30
        build["build_peak_gib"] = (peak - before) / 2**30
    log(f"100M streaming build: {json.dumps(build)}")
    emit_merge({"ivf100m_build": build})

    # exact fp64 ground truth, chunk by chunk after the build; a chunk's
    # part is stored only once its device call has returned
    gtq = torch.from_numpy(queries[:N_GT]).to(dev).to(torch.float64)
    parts = {}
    for ci in range(n_ch):
        xc = chunk(ci).to(torch.float64)
        dd = (xc * xc).sum(1)[None, :] - 2.0 * (gtq @ xc.T)
        v, am = torch.topk(dd, K, largest=False)
        parts[ci] = (v.cpu().numpy(), am.cpu().numpy() + ci * ch)
        del xc, dd
    cand_v = np.concatenate([parts[c][0] for c in range(n_ch)], axis=1)
    cand_i = np.concatenate([parts[c][1] for c in range(n_ch)], axis=1)
    gt = np.take_along_axis(
        cand_i, np.argsort(cand_v, axis=1, kind="stable")[:, :K], 1)
    parts.clear()

    hq = torch.from_numpy(queries[:sz.stream_b]).to(dev)
    sweep = {}
    for probe in sz.stream_probes:
        (_, ids), times = timed(torch, dev, [
            lambda: ivf_ops.ivf_search_batch(index, hq, k=K, probe=probe,
                                             probe_chunk=2)] * REPS)
        sweep[f"probe={probe}"] = qps_record(
            sz.stream_b, times, ids.cpu().numpy()[:N_GT], gt)
        log(f"100M probe {probe}: {json.dumps(sweep[f'probe={probe}'])}")
        emit_merge({"ivf100m_sweep": dict(sweep)})
    for probe in sz.stream_rescored:
        (_, ids), times = timed(torch, dev, [
            lambda: ivf_ops.ivf_search_rescored_streaming(
                index, hq, chunk, n_ch, ch, k=K, probe=probe,
                probe_chunk=2)] * REPS)
        sweep[f"rescored/probe={probe}"] = qps_record(
            sz.stream_b, times, ids.cpu().numpy()[:N_GT], gt)
        log(f"100M rescored probe {probe}: "
            + json.dumps(sweep[f"rescored/probe={probe}"]))
        emit_merge({"ivf100m_sweep": dict(sweep)})
    emit_merge({"ivf100m_launches": bs.launch_counts()})


SECTIONS = {
    "flat1m": section_flat1m,
    "big10m": section_big10m,
    "crossover": section_crossover,
    "hnsw1m": section_hnsw1m,
    "cosine": section_cosine,
    "shapes": section_shapes,
    "ivf100m": section_ivf100m,
}
# (name, seconds needed to launch, cap): bench.py's order, the scripts' three
# folded in after the section each extends
PLAN = (("flat1m", 120, 700), ("big10m", 120, 600), ("crossover", 90, 500),
        ("hnsw1m", 200, 700), ("cosine", 60, 400), ("shapes", 90, 500),
        ("ivf100m", 120, 600))
QUICK_PLAN = (("flat1m", 30, 600),)


def child_main(name: str, opts: Opts) -> None:
    _SECTION[0] = name
    try:
        SECTIONS[name](opts)
    except BaseException as exc:  # noqa: BLE001 - reported as the skip
        import traceback

        traceback.print_exc(file=sys.stderr)
        emit_skip(f"{type(exc).__name__}: {exc}")
    emit_done()


# ---------------------------------------------------------------------------
# host-only work, in the parent
# ---------------------------------------------------------------------------


def run_text_section(details: dict, n_docs: int) -> None:
    """bench.py's full-text micro-bench through the port's Engine (host
    only): ingest of 12-word Zipf documents, then term, AND, prefix,
    tag + text, suffix, infix, fuzzy, phrase and SLOP 1 queries, and two
    FT.AGGREGATEs, each on one core."""
    from valkey_search_tpu_torch.server.engine import Engine

    tycoon = np.random.default_rng(5)
    vocab = [f"w{i:05d}" for i in range(20000)]
    zipf = np.minimum(tycoon.zipf(1.3, size=(20000, 12)) - 1, 19999)
    eng = Engine()
    eng.execute("FT.CREATE", "t", "ON", "HASH", "PREFIX", "1", "d:",
                "SCHEMA", "body", "TEXT", "tag", "TAG")
    t0 = time.perf_counter()
    for i in range(n_docs):
        words = zipf[i % 20000]
        eng.hset(f"d:{i}", {"body": " ".join(vocab[w] for w in words),
                            "tag": "even" if i % 2 == 0 else "odd"})
    ingest = n_docs / (time.perf_counter() - t0)

    def qps_of(queries_list, *extra):
        t0 = time.perf_counter()
        for q in queries_list:
            eng.ft_search("t", q, *extra, "NOCONTENT", "LIMIT", "0", "10")
        return len(queries_list) / (time.perf_counter() - t0)

    terms = [f"@body:{vocab[tycoon.integers(100, 5000)]}" for _ in range(500)]
    ands = [f"@body:({vocab[tycoon.integers(100, 2000)]} "
            f"{vocab[tycoon.integers(100, 2000)]})" for _ in range(300)]
    prefixes = [f"@body:w0{tycoon.integers(10, 99)}*" for _ in range(200)]
    hybrid_t = [f"(@tag:{{odd}} @body:{vocab[tycoon.integers(100, 2000)]})"
                for _ in range(300)]
    suffixes = [f"@body:*{tycoon.integers(100, 999)}" for _ in range(200)]
    infixes = [f"@body:*0{tycoon.integers(100, 999)}*" for _ in range(100)]
    fuzzy1 = [f"@body:%w{tycoon.integers(100, 5000):05d}%"
              for _ in range(100)]
    fuzzy2 = [f"@body:%%w{tycoon.integers(100, 5000):05d}%%"
              for _ in range(50)]
    phrases = []
    for _ in range(100):
        w = zipf[int(tycoon.integers(0, 20000))]
        phrases.append(f'@body:"{vocab[w[3]]} {vocab[w[4]]}"')
    out = {"text_docs": n_docs, "text_ingest_docs_per_s": ingest,
           "text_term_qps_1core": qps_of(terms),
           "text_and_qps_1core": qps_of(ands),
           "text_prefix_qps_1core": qps_of(prefixes),
           "text_hybrid_qps_1core": qps_of(hybrid_t),
           "text_suffix_qps_1core": qps_of(suffixes),
           "text_infix_qps_1core": qps_of(infixes),
           "text_fuzzy1_qps_1core": qps_of(fuzzy1),
           "text_fuzzy2_qps_1core": qps_of(fuzzy2),
           "text_phrase_qps_1core": qps_of(phrases),
           "text_phrase_slop1_qps_1core": qps_of(phrases, "SLOP", "1")}

    def agg_qps(q, reps=200):
        t0 = time.perf_counter()
        for _ in range(reps):
            eng.ft_aggregate("t", q, "LOAD", "1", "@tag", "GROUPBY", "1",
                             "@tag", "REDUCE", "COUNT", "0", "AS", "c")
        return reps / (time.perf_counter() - t0)

    out["aggregate_selective_qps_1core"] = agg_qps(f"@body:{vocab[3000]}")
    out["aggregate_hotterm_qps_1core"] = agg_qps(f"@body:{vocab[5]}")
    log("text: " + json.dumps(out))
    details.update(out)


# ---------------------------------------------------------------------------
# parent
# ---------------------------------------------------------------------------


_LIVE_CHILD: List[Optional[subprocess.Popen]] = [None]


def _kill_live_child() -> None:
    p = _LIVE_CHILD[0]
    if p is not None and p.poll() is None:
        try:
            p.terminate()
            try:
                p.wait(5)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait(5)
        except OSError:
            pass


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if proc.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {proc.stderr.strip()}")
    return proc.stdout.strip().splitlines()[0]


def run_section_child(name: str, details: dict, timeout_s: float,
                      opts: Opts) -> bool:
    """Run ``bench_torch.py --section name`` and merge its lines; True on a
    clean completion. A timeout or a crash records ``skip_<name>``; the
    sub-stages already merged stay."""
    log(f"section {name}: launching child (timeout {timeout_s:.0f}s)")
    t0 = time.perf_counter()
    p = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--section", name]
        + opts.argv(), stdout=subprocess.PIPE, stderr=None, text=True,
        bufsize=1)
    _LIVE_CHILD[0] = p
    lines: List[str] = []
    lock = threading.Lock()

    def reader():
        for line in p.stdout:
            with lock:
                lines.append(line)

    rt = threading.Thread(target=reader, daemon=True)
    rt.start()
    timed_out = False
    while rt.is_alive():
        if time.perf_counter() - t0 > timeout_s:
            log(f"section {name}: deadline, terminating the child")
            timed_out = True
            _kill_live_child()
            break
        rt.join(0.2)
    rt.join(5)
    rc = p.wait()
    _LIVE_CHILD[0] = None
    with lock:
        skipped, done = read_child_lines(list(lines), details)
    if timed_out:
        skipped = skipped or f"timeout after {timeout_s:.0f}s"
    return record_child(name, details, skipped, done, rc,
                        time.perf_counter() - t0)


def record_child(name: str, details: dict, skipped, done: bool, rc,
                 took: float) -> bool:
    details.setdefault("section_wall_s", {})[name] = took
    if skipped is not None:
        details[f"skip_{name}"] = skipped
        log(f"section {name}: SKIPPED after {took:.0f}s: {skipped}")
        return False
    if not done:
        details[f"skip_{name}"] = f"child exited rc={rc} without done marker"
        log(f"section {name}: died rc={rc} after {took:.0f}s")
        return False
    log(f"section {name}: complete in {took:.0f}s")
    return True


def _r(x, nd=1):
    return None if x is None else round(float(x), nd)


def headlines(details: dict) -> dict:
    """One short headline a section, from the merged details."""
    h = {}
    f8, fb = details.get("flat1m_int8"), details.get("flat1m_bfloat16")
    for tag, f in (("int8", f8), ("bf16", fb)):
        if f:
            top = max(int(k.split("=")[1]) for k in f["qps"]
                      if k.startswith("search_batch/"))
            h.setdefault("flat1m", {})[tag] = [
                _r(f["qps"][f"search_batch/B={top}"]["qps"]),
                _r(f["qps"][f"launch/B={top}"]["qps"]), _r(f["recall"], 4),
                sum(f["launches"].values())]
    scan, ivf = details.get("big10m_scan"), details.get("big10m_ivf")
    if scan:
        top = max(scan, key=lambda k: int(k.split("=")[1]))
        h["big10m"] = {"scan": [_r(scan[top]["qps"]),
                                _r(scan[top]["recall"], 4)]}
        if ivf:
            p16 = [k for k in ivf if k.startswith("probe=16/")]
            if p16:
                k16 = max(p16, key=lambda k: int(k.split("=")[2]))
                h["big10m"]["ivf16"] = [_r(ivf[k16]["qps"]),
                                        _r(ivf[k16]["recall"], 4)]
    xo = details.get("crossover")
    if xo:
        h["crossover"] = {n: [_r(p["scan"]["qps"]),
                              _r(p["ivf_qps_at_recall99"])]
                          for n, p in xo.items()}
    walk = details.get("hnsw1m_walk")
    if "hnsw1m_build_s" in details:
        h["hnsw1m"] = {"build_s": _r(details["hnsw1m_build_s"])}
        if walk:
            k100 = max((k for k in walk if k.endswith("/ef=100")),
                       key=lambda k: int(k.split("/")[0][2:]), default=None)
            if k100:
                h["hnsw1m"]["walk100"] = [_r(walk[k100]["qps"]),
                                          _r(walk[k100]["recall"], 4)]
    if details.get("cosine"):
        h["cosine"] = [_r(details["cosine"]["qps"]),
                       _r(details["cosine"]["recall"], 4)]
    if details.get("shapes"):
        h["shapes"] = {n: _r(s["default"]["recall"], 4)
                       for n, s in details["shapes"].items()}
    sw = details.get("ivf100m_sweep")
    if details.get("ivf100m_build"):
        h["ivf100m"] = {"build_s": _r(details["ivf100m_build"]["build_s"])}
        resc = [k for k in (sw or {}) if k.startswith("rescored/")]
        if resc:
            top = max(resc, key=lambda k: int(k.split("=")[1]))
            h["ivf100m"]["rescored"] = [_r(sw[top]["qps"]),
                                        _r(sw[top]["recall"], 4)]
    if "text_term_qps_1core" in details:
        h["text"] = [_r(details["text_ingest_docs_per_s"]),
                     _r(details["text_term_qps_1core"])]
    if "cpu_flat_qps_1core" in details:
        h["cpu"] = _r(details["cpu_flat_qps_1core"], 2)
    return h


def result_line(details: dict, device: dict, ref_qps: Optional[float],
                details_path: str) -> dict:
    """The last line: the headline value (int8 search_batch QPS at the
    largest batch where recall@10 >= 0.99, else 0 and the shortfall)."""
    f8 = details.get("flat1m_int8")
    value, short = 0.0, None
    if f8:
        top = max(int(k.split("=")[1]) for k in f8["qps"]
                  if k.startswith("search_batch/"))
        if f8["recall"] >= RECALL_FLOOR:
            value = f8["qps"][f"search_batch/B={top}"]["qps"]
        else:
            short = (f"int8 recall@10 {f8['recall']:.4f} < {RECALL_FLOOR} "
                     f"at B={top}")
    else:
        short = "flat1m int8 did not land"
    skips = {k[5:]: str(v)[:60] for k, v in details.items()
             if k.startswith("skip_")}
    metric = METRIC if device.get("platform") == "gpu" else (
        METRIC.replace("one GPU", "the host CPU (--device cpu)"))
    line = {"metric": metric, "value": round(value, 1), "unit": "qps",
            "vs_baseline": round(value / ref_qps, 2) if ref_qps else None,
            "baseline": ("reference hnswlib M16 efC200, 1 core, recall>=0.99 "
                         f"({ref_qps} qps, BASELINE_ref_1m.json)"),
            "device": device, "headlines": headlines(details),
            "details": details_path}
    if short:
        line["shortfall"] = short
    if skips:
        line["skips"] = skips
    if "fatal" in details:
        line["fatal"] = str(details["fatal"])[:120]
    return fit_line(line)


def fit_line(line: dict) -> dict:
    """Drop headlines, longest first, until the line fits LAST_LINE_MAX."""
    while len(json.dumps(line)) > LAST_LINE_MAX and line.get("headlines"):
        h = line["headlines"]
        del h[max(h, key=lambda k: len(json.dumps(h[k])))]
    return line


def ref_baseline() -> Optional[float]:
    """The best one-core QPS at recall@10 >= 0.99 of the reference's own
    engine (BASELINE_ref_1m.json: vendored hnswlib, M 16, efC 200)."""
    path = os.path.join(REPO, "BASELINE_ref_1m.json")
    try:
        with open(path) as f:
            ref = json.load(f)
    except (OSError, ValueError):
        return None
    cand = [q for q, r in ref.get("sweep", {}).values() if r >= RECALL_FLOOR]
    return max(cand) if cand else None


def exit_code(details: dict) -> int:
    """0 when every section landed, 3 (a partial result) otherwise."""
    if "fatal" in details or any(k.startswith("skip_") for k in details):
        return 3
    return 0


_STATE: Dict[str, object] = {}


def finish(state: dict) -> int:
    """Write the details and print the last line, once (the main thread,
    the watchdog or a signal may get there first); the exit code."""
    with state["lock"]:
        if state.get("emitted"):
            return int(state.get("rc", 3))
        state["emitted"] = True
    details = state["details"]
    opts = state["opts"]
    os.makedirs(opts.out, exist_ok=True)
    path = os.path.join(opts.out, "details.json")
    with open(path, "w") as f:
        json.dump(details, f, indent=1, default=_plain)
    line = result_line(details, state["device"], state.get("ref_qps"),
                       os.path.relpath(path, REPO)
                       if path.startswith(REPO) else path)
    if state.get("card"):
        print(state["card"], flush=True)
    print(json.dumps(line), flush=True)
    state["rc"] = exit_code(details)
    return state["rc"]


def describe_device(opts: Opts):
    """(device object, nvidia-smi line or None); raises SystemExit(2) when
    the card asked for is missing."""
    import torch

    if opts.device == "cpu":
        return {"platform": "cpu", "kind": "cpu", "count": 1}, None
    if not torch.cuda.is_available():
        print("bench_torch: no CUDA device (torch.cuda.is_available() is "
              "False); no section ran. --device cpu runs on the host.",
              file=sys.stderr, flush=True)
        raise SystemExit(2)
    card = card_line()
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
            "power_limit": card.split(",")[-1].strip()}, card


def parent_main(opts: Opts, runner=run_section_child) -> int:
    t_start = time.perf_counter()
    device, card = describe_device(opts)
    sz = sizes(opts)
    details: dict = {"watchdog": "fired before the sections completed"}
    state = {"details": details, "opts": opts, "device": device,
             "card": card, "ref_qps": ref_baseline(),
             "lock": threading.Lock()}
    _STATE["state"] = state
    log(f"device {json.dumps(device)}; budget {opts.budget_s:.0f}s")

    def watchdog():
        deadline = opts.budget_s * 1.25 + 120
        while time.perf_counter() - t_start < deadline:
            time.sleep(5)
            if state.get("done"):
                return
        log("WATCHDOG: budget exceeded, landing the partial result")
        _kill_live_child()
        details["fatal"] = "watchdog: budget exceeded"
        finish(state)
        os._exit(2)

    threading.Thread(target=watchdog, daemon=True).start()
    details.update({
        "n": opts.n, "d": D, "k": K, "batch": opts.batch,
        "quick": opts.quick, "device": device, "reduced": list(sz.cuts),
        "corpus": "sift-like clustered bytes (1024 centers, seed 42; "
                  "bench.py's recipe)",
        "datasets": "synthetic: real SIFT1M/GloVe files are not in the "
                    "repository",
        "baseline_source": "reference vendored hnswlib, M=16 efC=200, one "
                           "core (BASELINE_ref_1m.json)",
        "ref_hnsw_qps_1core_recall99": state["ref_qps"],
        "timing": "QPS: median of 5 calls, each synchronised (host clock); "
                  "service_ms: CUDA events",
    })
    if opts.device == "cuda":
        # one nvcc per source, at once; the children load the libraries
        from concurrent.futures import ThreadPoolExecutor

        from valkey_search_tpu_torch.ops import _build

        t0 = time.perf_counter()
        sources = ("bucket_scan_i8_packed", "bucket_scan_bf16")
        with ThreadPoolExecutor(len(sources)) as pool:
            list(pool.map(_build.load, sources))
        details["kernel_build_s"] = time.perf_counter() - t0
    else:
        from valkey_search_tpu_torch.runtime.device import set_device

        set_device("cpu")

    if not opts.quick:
        t0 = time.perf_counter()
        run_text_section(details, sz.text_docs)
        details.setdefault("section_wall_s", {})["text"] = (
            time.perf_counter() - t0)

    log(f"generating the corpus N={opts.n} d={D}, {opts.batch} queries")
    _, corpus, queries = gen_corpus_and_queries(opts.n, opts.batch)
    paths = shm_paths(opts, os.getpid())
    state["paths"] = paths
    np.save(paths[0], corpus)
    np.save(paths[1], queries)
    from valkey_search_tpu_torch.native_lib import cpu_brute_force_topk

    t0 = time.perf_counter()
    for i in range(sz.cpu_queries):
        cpu_brute_force_topk(corpus, queries[i], K)
    details["cpu_flat_qps_1core"] = sz.cpu_queries / (time.perf_counter()
                                                      - t0)
    log(f"CPU flat (1 core, native bf_topk): "
        f"{details['cpu_flat_qps_1core']:.2f} qps")
    del corpus, queries

    try:
        for name, need, cap in (QUICK_PLAN if opts.quick else PLAN):
            rem = opts.budget_s - (time.perf_counter() - t_start)
            if rem < need:
                details[f"skip_{name}"] = (
                    f"insufficient budget: {rem:.0f}s left, need {need}s")
                log(f"section {name}: skipped ({details[f'skip_{name}']})")
                continue
            runner(name, details, min(cap, rem + 120), opts)
    finally:
        for p in paths:
            try:
                os.unlink(p)
            except OSError:
                pass
    state["done"] = True
    details.pop("watchdog", None)
    details["wall_s"] = time.perf_counter() - t_start
    return finish(state)


def _term_handler(signum, frame):
    """SIGTERM / SIGINT still land the line: the live child dies first."""
    _kill_live_child()
    raise SystemExit(f"signal {signum}")


def main(argv=None) -> int:
    opts = parse_args(sys.argv[1:] if argv is None else argv)
    if opts.section:
        child_main(opts.section, opts)
        return 0
    signal.signal(signal.SIGTERM, _term_handler)
    signal.signal(signal.SIGINT, _term_handler)
    try:
        return parent_main(opts)
    except BaseException as exc:  # noqa: BLE001 - the line must land
        import traceback

        st = _STATE.get("state")
        if isinstance(exc, SystemExit) and st is None:
            raise  # no card: nothing ran, nothing to land
        traceback.print_exc(file=sys.stderr)
        if st is None:
            raise
        st["details"]["fatal"] = f"{type(exc).__name__}: {exc}"
        st["details"].pop("watchdog", None)
        st["done"] = True
        finish(st)
        return 3


if __name__ == "__main__":
    sys.exit(main())
