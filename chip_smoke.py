#!/usr/bin/env python3
"""Build the PyTorch/CUDA port's kernels and drive its FT.SEARCH path on one GPU.

Run from the root of a checkout, on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases (each failure exits non-zero; there is no CPU path):

1. device   - requires a CUDA device, selects it, prints name and power limit;
2. build    - one nvcc per source, all at once: K1 and K3
              (bucket_scan_i8_packed.cu) and K2 (bucket_scan_bf16.cu); the
              native text tier (g++) builds beside them;
3. kernels  - each kernel against its plain PyTorch version at
              N = 1,048,576 (1,000 padded rows), each case with its query
              tile BQ, kernel and plain times (CUDA events) and its share
              of the bound (bytes at 3.35 TB/s or operations at the int8 /
              bf16 tensor-core peak, whichever is larger): K1 at span 1
              and 8, d 128, B = 1, 7, 64, 256 and 1,024 with 5% of the rows
              excluded and B = 1 with 99% excluded (a hybrid request under
              a 1% filter), span 4 d 256 at B = 256, span 8 d 768 at B = 64
              and 256 (K1_CASES); K2 at B = 1 .. 1,024 (l2), ip, d 768 and
              B = 1 with 99% excluded (K2_CASES); K3 at d 128 and 768,
              B = 1, 256 and 1,024, with negative scores (K3_CASES). K1
              keys and K3 vals/idx bit-identical, K2 idx agreeing on
              >= 99% of columns and vals within rtol 4e-5, atol 1e-2. One
              PyTorch call times the product alone at B = 256 and 1,024
              (torch._int_mm for K1 and K3, a bf16 matmul for K2) as the
              kernels' library yardstick; the port never calls it;
4. slice    - FT.CREATE (v VECTOR FLAT, cat TAG, price NUMERIC) + 1,000,000
              HSETs of all three fields (the bench's seeded SIFT-like recipe,
              seeded tags and prices) + FT.SEARCH KNN 10 from 16 threads,
              under int8 (K1, pre_shift > 0) and bfloat16 (K2): unfiltered,
              then hybrid under a tag (~1%), two price ranges (~10%, ~50%)
              and their conjunction (~0.5%); and a 200,000-row int8 index
              with a TEXT field (K1, pre_shift = 0), unfiltered and under a
              text filter. recall@10 against fp64 ground truth restricted to
              the qualified rows, no key outside a filter, the kernels'
              launch counts, non-vector counts and SORTBY, DEL and update
              visibility (the tag mask cache included), latency and
              search_batch QPS; and where a hybrid request's time goes
              (profile_hybrid: 1 against 16 threads, the GIL switch
              interval, torch.profiler's device time per request);
5. hnsw     - (a) FT.CREATE ... VECTOR HNSW (M 16, EF_CONSTRUCTION 200) +
              cat TAG and 100,000 HSETs (native inserts): FT.SEARCH KNN 10
              EF_RUNTIME 100 from 16 threads on the scan route (pow2
              capacity 131,072: K1 at pre_shift 0, and K2), hybrid, DEL and
              update; then search.hnsw-scan-threshold 0: the AoS walk, the
              filtered SoA walk (inline) and the pre-filtered exact scan,
              each checked by its counters. (b) HnswVectorIndex.bulk_load of
              1,000,000 rows under build-mode device (candidate scan, prune,
              native bulk_build, bridging and publish timed); search_batch
              at B = 1,024 on the scan route (K1 at pre_shift > 0, K2) and
              the walk at ef 10, 50 and 100 beside the native walk over the
              same graph; the walk's device share under torch.profiler.

The next-to-last line is the card's name and power limit as nvidia-smi gives
them; the line before it the kernels' JSON record; the last line the result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

D = 128
N_BIG = 1_000_000
N_SMALL = 200_000
N_CENTERS = 1024
N_CATS = 100
N_WORDS = 40  # the 200k index's title vocabulary
N_QUERIES = 1024
N_GT = 256
K = 10
RECALL_FLOOR = 0.99
THREADS = 16
KERNEL_B = 256
KERNEL_N = 1_048_576
# K1's kernel-phase cases: (B, span, d, kept share of the rows)
K1_CASES = tuple((b, span, 128, 0.95) for span in (1, 8)
                 for b in (1, 7, 64, 256, 1024)) + (
    (1, 1, 128, 0.01), (1, 8, 128, 0.01), (256, 4, 256, 0.95),
    (64, 8, 768, 0.95), (256, 8, 768, 0.95))
# K3's: (B, d), 5% of the rows excluded, negative scores present
K3_CASES = tuple((b, d) for d in (128, 768) for b in (1, 256, 1024))
# K2's kernel-phase cases: (B, positive, d, kept share of the rows)
K2_CASES = ((1, True, 128, 0.95), (7, True, 128, 0.95), (64, True, 128, 0.95),
            (256, True, 128, 0.95), (1024, True, 128, 0.95),
            (1, False, 128, 0.95), (256, False, 128, 0.95),
            (64, True, 768, 0.95), (1, True, 128, 0.01))
QPS_BATCHES = (1024, 16384)
# the bound of a kernel (published H100 SXM peaks):
# device-memory bytes at 3.35 TB/s, dense int8 and bf16 tensor-core peaks
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
BF16_FLOPS_PER_S = 989e12
# batches at which one library call times the scans' product alone
LIBRARY_BATCHES = (256, 1024)
# the HNSW phase: the engine's index (pow2 capacity 131,072), the full-width
# index, the batch and ef values of its searches, the native walk's queries
N_HNSW = 100_000
N_HNSW_BIG = 1_000_000
HNSW_B = 1024
HNSW_EF = 100
HNSW_EFS = (10, 50, 100)
N_NATIVE = 200
# iterations between the walk's reads of its done flags, timed in turns
CHECK_EVERY_CASES = (1, 2, 4, 8, 16)
# the engine's walk routes are reported; this floor only catches breakage
HNSW_WALK_FLOOR = 0.9


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(proc.returncode == 0, f"nvidia-smi failed: {proc.stderr.strip()}")
    return proc.stdout.strip().splitlines()[0]


def log(msg: str, gpu: str = "") -> None:
    print(f"[{gpu}] {msg}" if gpu else msg, flush=True)


# ---------------------------------------------------------------------------
# data: the bench's SIFT-like recipe (byte-valued, 1,024 clusters, seed 42)
# ---------------------------------------------------------------------------


def sift_like(n: int, n_queries: int, seed: int = 42):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((N_CENTERS, D)).astype(np.float32) * 60 + 128
    assign = rng.integers(0, N_CENTERS, size=n)
    corpus = np.clip(
        centers[assign] + rng.standard_normal((n, D)).astype(np.float32) * 20,
        0, 255,
    ).astype(np.float32)
    q_assign = rng.integers(0, N_CENTERS, size=n_queries)
    queries = np.clip(
        centers[q_assign]
        + rng.standard_normal((n_queries, D)).astype(np.float32) * 20,
        0, 255,
    ).astype(np.float32)
    return corpus, queries


def seeded_fields(n: int, seed: int = 7):
    """The 1M index's TAG and NUMERIC values, seeded and independent of the
    vectors: category ids in [0, 100) and prices in [0, 1000)."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, N_CATS, n), rng.integers(0, 1000, n)


def seeded_titles(n: int, seed: int = 11) -> np.ndarray:
    """The 200k index's titles: 4 words each of a fixed vocabulary (w00 ..
    w39, too short to stem), as word ids [n, 4]."""
    return np.random.default_rng(seed).integers(0, N_WORDS, (n, 4))


def fp64_gt(torch, c64, csq, queries, k: int, device,
            allowed=None) -> np.ndarray:
    """Exact neighbours in float64 on the card (||c||^2 - 2 c.q ordering)
    among the rows ``allowed`` (bool [n]; all rows when None)."""
    bad = None if allowed is None else torch.as_tensor(~allowed, device=device)
    out = []
    for q0 in range(0, len(queries), 64):
        q = torch.as_tensor(queries[q0:q0 + 64], dtype=torch.float64,
                            device=device)
        dd = csq[None, :] - 2.0 * (q @ c64.T)
        if bad is not None:
            dd = dd.masked_fill(bad[None, :], float("inf"))
        out.append(torch.topk(dd, k, largest=False).indices.cpu().numpy())
    return np.concatenate(out)


def recall(ids: np.ndarray, gt: np.ndarray) -> float:
    k = gt.shape[1]
    return float(np.mean([
        len(set(ids[i][:k].tolist()) & set(gt[i].tolist())) / k
        for i in range(len(gt))
    ]))


def time_ms(torch, fn, reps: int = 5) -> float:
    """Mean device time of ``fn`` over ``reps`` calls after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def bound(bytes_moved: float, ops: float, peak: float):
    """(bound_ms, bound_by): the least time the card could take for the
    work, the larger of its bytes over HBM_BYTES_PER_S and its operations
    over ``peak``."""
    by_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    by_ops = ops / peak * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                            "operations")


def library_ms(torch, fn, gpu: str, what: str):
    """Time of one PyTorch call computing the product alone (the yardstick
    for the scans; the port never calls it), or None if it cannot run."""
    try:
        return time_ms(torch, fn, reps=3)
    except (RuntimeError, ValueError) as exc:
        log(f"library call {what} did not run: {exc}", gpu)
        return None


def kernel_phase(torch, bs, dev, gpu: str) -> dict:
    """Each kernel against its plain version on the card; returns per-kernel
    records keyed like bs.LAUNCHES."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    records = {}
    n = KERNEL_N
    n_rows = n - 1000  # the tail is padding: zero rows, SENTINEL bias

    def excluded_rows(kept: float):
        """bool [n]: rows outside a filter that keeps ``kept`` of them, and
        the padded tail."""
        out = torch.rand((n,), generator=gen, device=dev) >= kept
        out[n_rows:] = True
        return out

    corpora = {}

    def int8_corpus(d: int):
        """One seeded int8 corpus per dim, shared by K1's and K3's cases."""
        if d not in corpora:
            corpora.clear()
            torch.cuda.empty_cache()
            corpora[d] = torch.randint(-127, 128, (n_rows, d), generator=gen,
                                       device=dev, dtype=torch.int8)
        return corpora[d]

    library = {}  # torch._int_mm by B: the product of K1 and K3 alone
    # K1 over its grid (K1_CASES): bit-identical keys, kernel and plain
    # times, the share of the bound; B = 1 with 99% excluded is a hybrid
    # request (one launch per request, a 1% filter folded into the bias)
    for b, span, d, kept in K1_CASES:
        q = torch.randint(-127, 128, (b, d), generator=gen, device=dev,
                          dtype=torch.int8)
        c = int8_corpus(d)
        d_pad = bs.round_up(d, 128)
        dotmax, clamp, sentinel, pre_shift, _ = bs.i8_packed_layout(d_pad, span)
        bias = torch.randint(0, clamp, (n,), generator=gen, device=dev,
                             dtype=torch.int32) + dotmax
        bias = torch.where(excluded_rows(kept),
                           torch.full_like(bias, sentinel), bias)
        got = bs.bucket_min_scan_i8_packed(q, c, bias, span)
        torch.cuda.synchronize()
        want = bs.bucket_min_scan_i8_packed_plain(q, c, bias, span)
        torch.cuda.synchronize()
        same = torch.equal(got, want)
        n_bad = int((got != want).sum())
        del got, want
        ms = time_ms(torch, lambda: bs.bucket_min_scan_i8_packed(q, c, bias, span))
        plain_ms = time_ms(
            torch, lambda: bs.bucket_min_scan_i8_packed_plain(q, c, bias, span),
            reps=2)
        bound_ms, bound_by = bound(
            b * d + n_rows * d + 4 * n + 4 * b * n // (128 * span),
            2 * b * n_rows * d, INT8_OPS_PER_S)
        lib = None
        if b in LIBRARY_BATCHES and span == 1 and d == 128:
            lib = library_ms(torch, lambda: torch._int_mm(q, c.t()), gpu,
                             f"torch._int_mm B={b}")
        log(f"K1 span={span} d={d} pre_shift={pre_shift} B={b} "
            f"BQ={bs.k1_query_tile(b, d)} N={n} kept={kept}: bit-identical="
            f"{same} (mismatches {n_bad}), kernel {ms:.4f} ms, plain "
            f"{plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by}), share "
            f"{bound_ms / ms:.3f}"
            + (f", torch._int_mm {lib:.4f} ms" if lib is not None else ""), gpu)
        check(same, f"K1 B={b} span={span} d={d}: {n_bad} keys differ from "
              "plain")
        name = ("bucket_scan_i8_packed[pre_shift=0]" if pre_shift == 0
                else "bucket_scan_i8_packed[pre_shift>0]")
        # the main path's dim (128) at B = 256 is the one recorded; B = 1
        # under a 1% filter (the hybrid request) and B = 1,024 beside it
        if d == 128 and b == KERNEL_B and kept > 0.5:
            records.setdefault(name, {}).update({
                "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "bq": bs.k1_query_tile(b, d)})
        elif d == 128 and b == 1 and kept < 0.5:
            records.setdefault(name, {}).update({
                "ms_b1": ms, "plain_ms_b1": plain_ms, "bound_ms_b1": bound_ms})
        elif d == 128 and b == 1024:
            records.setdefault(name, {}).update({
                "ms_b1024": ms, "plain_ms_b1024": plain_ms,
                "bound_ms_b1024": bound_ms})
        if lib is not None:
            library[b] = lib
        del q, bias
    for name in ("bucket_scan_i8_packed[pre_shift=0]",
                 "bucket_scan_i8_packed[pre_shift>0]"):
        records[name]["library_ms"] = library.get(KERNEL_B)
        records[name]["library_ms_b1024"] = library.get(1024)
    corpora.clear()
    torch.cuda.empty_cache()

    # K2 at the query tiles the wrapper picks for B = 1 .. 1,024 (l2), ip,
    # d 768 (BQ capped by shared memory), and B = 1 with 99% excluded: the
    # hybrid request, whose times are recorded as ms_b1 / plain_ms_b1
    k2_err, by_b, hybrid, k2_lib = 0.0, {}, None, {}
    for b, positive, d, kept in K2_CASES:
        qf = torch.randn((b, d), generator=gen, device=dev)
        cf = torch.randn((n_rows, d), generator=gen, device=dev)
        alpha = -2.0 if positive else -1.0
        q = (qf * alpha).to(torch.bfloat16)
        c = cf.to(torch.bfloat16)
        qsq = ((qf * qf).sum(1) if positive
               else torch.zeros(b, device=dev)).contiguous()
        bias = torch.zeros(n, device=dev)
        bias[:n_rows] = (cf * cf).sum(1) if positive else 0.0
        bias = torch.where(excluded_rows(kept),
                           torch.full_like(bias, float("inf")), bias)
        del qf, cf
        vals, idx = bs.bucket_min_scan(q, qsq, c, bias, positive)
        torch.cuda.synchronize()
        pv, pi = bs.bucket_min_scan_plain(q, qsq, c, bias, positive)
        torch.cuda.synchronize()
        agree = idx == pi
        frac = float(agree.float().mean())
        finite = agree & torch.isfinite(pv)
        err = float((vals - pv).abs()[finite].max())
        inf_ok = bool(torch.equal(torch.isinf(vals[agree]),
                                  torch.isinf(pv[agree])))
        tol_ok = bool(torch.all(
            (vals - pv).abs()[finite] <= 1e-2 + 4e-5 * pv.abs()[finite]))
        del vals, idx, pv, pi, agree, finite
        torch.cuda.empty_cache()
        ms = time_ms(torch, lambda: bs.bucket_min_scan(q, qsq, c, bias,
                                                       positive))
        plain_ms = time_ms(
            torch, lambda: bs.bucket_min_scan_plain(q, qsq, c, bias, positive),
            reps=2)
        bound_ms, bound_by = bound(
            2 * b * d + 4 * b + 2 * n_rows * d + 4 * n + 8 * b * n // 128,
            2 * b * n_rows * d, BF16_FLOPS_PER_S)
        lib = None
        if b in LIBRARY_BATCHES and positive and d == 128 and kept > 0.5:
            lib = library_ms(torch, lambda: q @ c.t(), gpu,
                             f"bf16 q @ c.t() B={b}")
            k2_lib[b] = lib
        log(f"K2 positive={positive} B={b} d={d} BQ={bs.k2_query_tile(b, d)} "
            f"N={n} kept={kept}: idx agree {frac:.6f}, max |dval| {err:.6g} "
            f"where idx agree, kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, "
            f"bound {bound_ms:.4f} ms ({bound_by}), share "
            f"{bound_ms / ms:.3f}"
            + (f", bf16 matmul {lib:.4f} ms" if lib is not None else ""), gpu)
        check(frac >= 0.99, f"K2 B={b} d={d} idx agreement {frac} < 0.99")
        check(tol_ok and inf_ok,
              f"K2 B={b} d={d} vals outside rtol 4e-5, atol 1e-2")
        k2_err = max(k2_err, err)
        if kept < 0.5:  # the hybrid request
            hybrid = (ms, plain_ms, bound_ms)
        elif d == 128 and positive:  # l2 at the main path's dim
            by_b[b] = (ms, plain_ms, bound_ms, bound_by)
        del q, c, bias
        torch.cuda.empty_cache()
    records["bucket_scan_bf16"] = {
        "max_abs_err": k2_err, "ms": by_b[KERNEL_B][0],
        "plain_ms": by_b[KERNEL_B][1], "bound_ms": by_b[KERNEL_B][2],
        "bound_by": by_b[KERNEL_B][3], "library_ms": k2_lib.get(KERNEL_B),
        "bq": bs.k2_query_tile(KERNEL_B, 128),
        "ms_b1": hybrid[0], "plain_ms_b1": hybrid[1], "bound_ms_b1": hybrid[2],
        "ms_b1024": by_b[1024][0], "plain_ms_b1024": by_b[1024][1],
        "bound_ms_b1024": by_b[1024][2], "library_ms_b1024": k2_lib.get(1024)}
    log("K2 (kernel ms, plain ms, bound ms, bound by) by B, l2, d 128, 5% "
        "excluded: " + json.dumps(by_b), gpu)

    # K3 has no search path: its launches here are counted apart from the
    # main path's
    k3_before = bs.launch_counts()["bucket_scan_i8"]
    for b, d in K3_CASES:
        q = torch.randint(-127, 128, (b, d), generator=gen, device=dev,
                          dtype=torch.int8)
        c = int8_corpus(d)
        clamp, sentinel, pre_shift, _ = bs.i8_layout(d)
        # no +DOTMAX offset: small biases make many scores negative
        bias = torch.randint(0, clamp // 64, (n,), generator=gen, device=dev,
                             dtype=torch.int32)
        bias = torch.where(excluded_rows(0.95),
                           torch.full_like(bias, sentinel), bias)
        vals, idx = bs.bucket_min_scan_i8(q, c, bias)
        torch.cuda.synchronize()
        pv, pi = bs.bucket_min_scan_i8_plain(q, c, bias)
        torch.cuda.synchronize()
        same = bool(torch.equal(vals.view(torch.int32), pv.view(torch.int32))
                    and torch.equal(idx, pi))
        n_bad = int((idx != pi).sum()) + int((vals != pv).sum())
        negative = bool((vals < 0).any())
        del vals, idx, pv, pi
        ms = time_ms(torch, lambda: bs.bucket_min_scan_i8(q, c, bias))
        plain_ms = time_ms(
            torch, lambda: bs.bucket_min_scan_i8_plain(q, c, bias), reps=2)
        bound_ms, bound_by = bound(
            b * d + n_rows * d + 4 * n + 8 * b * n // 128,
            2 * b * n_rows * d, INT8_OPS_PER_S)
        log(f"K3 d={d} pre_shift={pre_shift} B={b} BQ="
            f"{bs.k1_query_tile(b, d)} N={n}: bit-identical={same} "
            f"(mismatches {n_bad}), negative scores {negative}, kernel "
            f"{ms:.4f} ms, plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms "
            f"({bound_by}), share {bound_ms / ms:.3f}", gpu)
        check(same, f"K3 B={b} d={d}: {n_bad} vals/idx differ from plain")
        check(negative, f"K3 B={b} d={d}: no negative score exercised")
        if d == 128 and b == KERNEL_B:  # the shape K1's record is taken at
            records["bucket_scan_i8"] = {
                "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": library.get(KERNEL_B),
                "bq": bs.k1_query_tile(b, d)}
        elif d == 128 and b == 1024:
            records["bucket_scan_i8"].update({
                "ms_b1024": ms, "plain_ms_b1024": plain_ms,
                "bound_ms_b1024": bound_ms,
                "library_ms_b1024": library.get(1024)})
        del q, bias
    records["bucket_scan_i8"]["check_launches"] = (
        bs.launch_counts()["bucket_scan_i8"] - k3_before)
    corpora.clear()
    torch.cuda.empty_cache()
    return records


# ---------------------------------------------------------------------------
# phase 4: the slice through Engine.execute
# ---------------------------------------------------------------------------


def ingest(engine, prefix: str, rows: np.ndarray, fields, gpu: str) -> None:
    """HSET every row with its vector and ``fields`` [(name, [str] per
    row)], all in one command per key."""
    t0 = time.perf_counter()
    for i in range(len(rows)):
        argv = ["HSET", f"{prefix}{i}", "v", rows[i].tobytes()]
        for name, values in fields:
            argv += [name, values[i]]
        engine.execute(*argv)
    dt = time.perf_counter() - t0
    log(f"HSET {len(rows)} rows under {prefix!r} (v + "
        f"{', '.join(name for name, _ in fields)}): {dt:.1f} s "
        f"({dt / len(rows) * 1e6:.1f} us/row)", gpu)


def knn(flt: str, k: int = K, ef: int = 0) -> str:
    runtime = f" EF_RUNTIME {ef}" if ef else ""
    return f"{flt}=>[KNN {k} @v $q{runtime}]"


def search_all(engine, index: str, queries: np.ndarray, flt: str = "*",
               ef: int = 0):
    """FT.SEARCH every query from THREADS threads; returns (the keys of
    each reply, per-request latencies in s)."""
    n = len(queries)
    keys = [None] * n
    lat = [0.0] * n
    errors = []

    def worker(tid: int) -> None:
        try:
            for i in range(tid, n, THREADS):
                t0 = time.perf_counter()
                reply = engine.execute(
                    "FT.SEARCH", index, knn(flt, ef=ef), "PARAMS", "2", "q",
                    queries[i].tobytes(), "NOCONTENT", "LIMIT", "0", str(K),
                )
                lat[i] = time.perf_counter() - t0
                keys[i] = reply[1:]
        except Exception as exc:  # reported below; the phase fails
            errors.append(repr(exc))

    threads = [threading.Thread(target=worker, args=(t,))
               for t in range(THREADS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    check(not any(t.is_alive() for t in threads), "FT.SEARCH threads hung")
    check(not errors, f"FT.SEARCH failed: {errors[:3]}")
    return keys, np.asarray(lat)


def key_ids(keys, prefix: str) -> np.ndarray:
    out = np.full((len(keys), K), -1, np.int64)
    for i, row in enumerate(keys):
        for j, key in enumerate(row[:K]):
            out[i, j] = int(key[len(prefix):])
    return out


def run_searches(torch, engine, bs, index, prefix, queries, gt, dtype,
                 expect, gpu: str, stats: dict, flt: str = "*",
                 allowed=None, ef: int = 0, floor: float = RECALL_FLOOR):
    """FT.SEARCH ``queries`` under ``flt`` (with EF_RUNTIME ``ef`` when
    set) from THREADS threads with the launch counts set to 0 just before;
    checks recall against ``gt`` (at least ``floor``), that every kernel in
    ``expect`` launched, and that no key lies outside ``allowed`` (bool [n]
    of the rows the filter qualifies)."""
    engine.config_set("search.corpus-dtype", dtype)
    # publish the mirror for this dtype before counting (not timed)
    engine.execute("FT.SEARCH", index, knn(flt, ef=ef), "PARAMS", "2",
                   "q", queries[0].tobytes(), "NOCONTENT")
    bs.reset_launches()
    keys, lat = search_all(engine, index, queries, flt, ef)
    counts = bs.launch_counts()
    ids = key_ids(keys, prefix)
    r = recall(ids[:len(gt)], gt)
    outside = 0 if allowed is None else int((~allowed[ids[ids >= 0]]).sum())
    p50, p99 = np.percentile(lat, 50) * 1e3, np.percentile(lat, 99) * 1e3
    log(f"FT.SEARCH {index} {knn(flt, ef=ef)!r} corpus-dtype={dtype}: "
        f"{len(queries)} queries from {THREADS} threads, recall@{K} "
        f"{r:.4f} on {len(gt)}, {outside} keys outside the filter, "
        f"p50 {p50:.3f} ms, p99 {p99:.3f} ms, launches {counts}", gpu)
    check(r >= floor, f"{index}/{dtype}/{flt}: recall {r} < {floor}")
    check(outside == 0, f"{index}/{dtype}/{flt}: {outside} keys outside")
    for name, count in counts.items():
        if name in expect:
            check(count > 0, f"{index}/{dtype}/{flt}: {name} never launched")
            stats["launches"][name] = stats["launches"].get(name, 0) + count
    stats[f"{index}/{dtype}/{flt}"] = {"recall": r, "p50_ms": p50,
                                       "p99_ms": p99}
    return keys


def batch_qps(torch, index, queries: np.ndarray, b: int, **search) -> float:
    """search_batch QPS over the first ``b`` queries (``search``: more
    arguments of search_batch, such as ef)."""
    reps = max(1, 8192 // b)
    qs = queries[:b]
    index.search_batch(qs, K, **search)  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        index.search_batch(qs, K, **search)  # host arrays: synchronised
    return reps * b / (time.perf_counter() - t0)


def profile_hybrid(torch, engine, queries: np.ndarray, gpu: str,
                   stats: dict, flt: str = "@cat:{c7}") -> None:
    """Where a hybrid request's time goes, under each dtype: one request at
    a time on the host clock; 16 threads at the default GIL switch interval
    and at 0.1 ms (a convoy on the GIL shows as throughput that rises when
    the interval falls); and torch.profiler over 10 requests (device time
    and device operations per request, the costliest kernels)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def one(i: int) -> None:
        engine.execute("FT.SEARCH", "idx", knn(flt), "PARAMS", "2", "q",
                       queries[i].tobytes(), "NOCONTENT")

    for dtype in ("int8", "bfloat16"):
        engine.config_set("search.corpus-dtype", dtype)
        one(0)  # publish the mirror for this dtype (not timed)
        lat = []
        for i in range(64):
            t0 = time.perf_counter()
            one(i)
            lat.append(time.perf_counter() - t0)
        rec = {"alone_p50_ms": float(np.percentile(lat, 50)) * 1e3,
               "alone_rps": len(lat) / sum(lat)}
        default = sys.getswitchinterval()
        for interval in (default, 1e-4):
            sys.setswitchinterval(interval)
            try:
                t0 = time.perf_counter()
                _, lat16 = search_all(engine, "idx", queries, flt)
                wall = time.perf_counter() - t0
            finally:
                sys.setswitchinterval(default)
            rec[f"threads16_rps@{interval}"] = len(queries) / wall
            rec[f"threads16_p50_ms@{interval}"] = (
                float(np.percentile(lat16, 50)) * 1e3)
        reps = 10
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for i in range(reps):
                one(i)
            torch.cuda.synchronize()
        dev_events = [e for e in prof.events()
                      if e.device_type == DeviceType.CUDA
                      and not e.is_user_annotation]
        by_name: dict = {}
        for e in dev_events:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
        rec["device_ms_per_request"] = (
            sum(by_name.values()) / reps / 1e3)
        rec["device_ops_per_request"] = len(dev_events) / reps
        rec["top_device_ms_per_request"] = {
            name[:60]: us / reps / 1e3 for name, us in top}
        log(f"profile {flt!r} corpus-dtype={dtype}: " + json.dumps(rec), gpu)
        stats[f"profile/{dtype}/{flt}"] = rec


def hybrid_mutations(engine, corpus, queries, gpu: str) -> None:
    """Under each dtype: a doc moved from c7 to c8 leaves the c7 KNN and
    joins the c8 one (the tag mask cache on the card); a deleted doc does
    not come back."""
    for j, dtype in enumerate(("int8", "bfloat16")):
        engine.config_set("search.corpus-dtype", dtype)
        q = queries[j].tobytes()

        def c7():
            return engine.execute("FT.SEARCH", "idx", knn("@cat:{c7}"),
                                  "PARAMS", "2", "q", q, "NOCONTENT")[1:]

        moved = c7()[0]
        engine.execute("HSET", moved, "cat", "c8")
        back = moved in c7()
        own = corpus[int(moved[len("doc:"):])].tobytes()
        found = engine.execute("FT.SEARCH", "idx", knn("@cat:{c8}", 1),
                               "PARAMS", "2", "q", own, "NOCONTENT")[1:]
        gone = c7()[0]
        check(engine.execute("DEL", gone) == 1, f"DEL {gone}")
        back_del = gone in c7()
        log(f"hybrid mutations ({dtype}): {moved} moved to c8: in the c7 "
            f"KNN {back}, first of the c8 KNN on its own vector "
            f"{found[:1] == [moved]}; {gone} deleted: in the c7 KNN "
            f"{back_del}", gpu)
        check(not back, f"{moved} moved to c8 still in the c7 KNN ({dtype})")
        check(found[:1] == [moved], f"{moved} not found under c8 ({dtype})")
        check(not back_del, f"deleted {gone} returned ({dtype})")


def slice_phase(torch, bs, dev, gpu: str) -> dict:
    from valkey_search_tpu_torch.server.engine import Engine

    stats = {"launches": {}}
    t0 = time.perf_counter()
    corpus, queries = sift_like(N_BIG, N_QUERIES + 16384)
    cats, prices = seeded_fields(N_BIG)
    small = corpus[:N_SMALL]
    titles = seeded_titles(N_SMALL)
    log(f"data: {N_BIG} x {D} corpus + {len(queries)} queries in "
        f"{time.perf_counter() - t0:.1f} s", gpu)
    qs = queries[:N_QUERIES]
    qs_gt = queries[:N_GT]
    filters = [  # (filter, the rows it qualifies)
        ("@cat:{c7}", cats == 7),
        ("@price:[0 99]", prices < 100),
        ("@price:[0 499]", prices < 500),
        ("(@cat:{c7} @price:[0 499])", (cats == 7) & (prices < 500)),
    ]
    text_filter = ("@title:w07", (titles == 7).any(axis=1))
    c64 = torch.as_tensor(corpus, dtype=torch.float64, device=dev)
    csq = (c64 * c64).sum(1)
    gt_big = fp64_gt(torch, c64, csq, qs_gt, K, dev)
    gt_filtered = [fp64_gt(torch, c64, csq, qs_gt, K, dev, allowed)
                   for _, allowed in filters]
    gt_small = fp64_gt(torch, c64[:N_SMALL], csq[:N_SMALL], qs_gt, K, dev)
    gt_text = fp64_gt(torch, c64[:N_SMALL], csq[:N_SMALL], qs_gt, K, dev,
                      text_filter[1])
    del c64, csq
    torch.cuda.empty_cache()
    for (flt, allowed) in filters + [text_filter]:
        log(f"filter {flt!r} qualifies {int(allowed.sum())} of "
            f"{len(allowed)} rows ({allowed.mean():.4f})", gpu)

    engine = Engine()
    check(engine.execute(
        "FT.CREATE", "idx", "ON", "HASH", "PREFIX", "1", "doc:", "SCHEMA",
        "v", "VECTOR", "FLAT", "6", "TYPE", "FLOAT32", "DIM", str(D),
        "DISTANCE_METRIC", "L2", "cat", "TAG", "price", "NUMERIC") == "OK",
        "FT.CREATE idx")
    ingest(engine, "doc:", corpus,
           [("cat", [f"c{c}" for c in cats]),
            ("price", [str(p) for p in prices])], gpu)
    info = engine.execute("FT.INFO", "idx")
    check(info[info.index("num_docs") + 1] == N_BIG, "FT.INFO num_docs")
    attrs = {a[3]: a for a in info[info.index("attributes") + 1]}
    check(all(attrs[name][7] == N_BIG for name in ("v", "cat", "price")),
          f"FT.INFO attributes {attrs}")

    k1_fused = "bucket_scan_i8_packed[pre_shift=0]"
    k1_shift = "bucket_scan_i8_packed[pre_shift>0]"
    k2 = "bucket_scan_bf16"
    run_searches(torch, engine, bs, "idx", "doc:", qs, gt_big, "int8",
                 {k1_shift}, gpu, stats)
    keys_bf16 = run_searches(torch, engine, bs, "idx", "doc:", qs, gt_big,
                             "bfloat16", {k2}, gpu, stats)

    index = engine.manager.get("idx").attribute("v").index
    for dtype in ("int8", "bfloat16"):
        engine.config_set("search.corpus-dtype", dtype)
        for b in QPS_BATCHES:
            qps = batch_qps(torch, index, queries, b)
            log(f"search_batch idx corpus-dtype={dtype} B={b}: "
                f"{qps:.1f} QPS", gpu)
            stats[f"qps/{dtype}/B={b}"] = qps

    # hybrid KNN: one search_batch launch per request, the filter's mask
    # folded into the scan's bias
    for dtype, kernel in (("int8", k1_shift), ("bfloat16", k2)):
        for (flt, allowed), gt in zip(filters, gt_filtered):
            run_searches(torch, engine, bs, "idx", "doc:", qs_gt, gt, dtype,
                         {kernel}, gpu, stats, flt=flt, allowed=allowed)
    profile_hybrid(torch, engine, qs_gt, gpu, stats)

    # non-vector queries resolve on the host
    reply = engine.execute("FT.SEARCH", "idx", "@cat:{c7}", "LIMIT", "0",
                           "10", "NOCONTENT")
    want = int((cats == 7).sum())
    log(f"FT.SEARCH idx '@cat:{{c7}}' LIMIT 0 10: total {reply[0]} "
        f"(numpy {want}), {len(reply) - 1} keys", gpu)
    check(reply[0] == want and len(reply) == 11, "@cat:{c7} count")
    reply = engine.execute("FT.SEARCH", "idx", "@price:[0 99]", "SORTBY",
                           "price", "RETURN", "1", "price")
    got = [float(row[1]) for row in reply[2::2]]
    log(f"FT.SEARCH idx '@price:[0 99]' SORTBY price: total {reply[0]}, "
        f"prices {got}", gpu)
    check(len(got) == 10 and got == sorted(got)
          and all(0 <= p <= 99 for p in got), "SORTBY price")

    # DEL 1,000 returned keys; none may come back under either dtype
    deleted = list(dict.fromkeys(key for row in keys_bf16 for key in row))
    deleted = deleted[:1000]
    check(len(deleted) == 1000, f"only {len(deleted)} distinct keys returned")
    check(engine.execute("DEL", *deleted) == len(deleted), "DEL count")
    gone = set(deleted)
    for dtype in ("bfloat16", "int8"):
        engine.config_set("search.corpus-dtype", dtype)
        keys, _ = search_all(engine, "idx", qs)
        back = sum(1 for row in keys for key in row if key in gone)
        log(f"after DEL of {len(gone)} keys, corpus-dtype={dtype}: "
            f"{back} deleted keys returned", gpu)
        check(back == 0, f"{back} deleted keys returned ({dtype})")
        # updated vector: found first, at distance 0 up to f32 rounding
        target = f"doc:{N_BIG - 1}"
        probe = queries[-1 if dtype == "int8" else -2]
        engine.execute("HSET", target, "v", probe.tobytes())
        reply = engine.execute(
            "FT.SEARCH", "idx", knn("*"), "PARAMS", "2", "q",
            probe.tobytes(), "RETURN", "1", "__v_score")
        dist = float(reply[2][1])
        log(f"updated {target} ({dtype}): top hit {reply[1]} at {dist}", gpu)
        check(reply[1] == target, f"updated vector not found first ({dtype})")
        check(abs(dist) <= 1e-5 * float(probe @ probe),
              f"updated vector at distance {dist}, not 0 ({dtype})")
    hybrid_mutations(engine, corpus, queries, gpu)

    check(engine.execute(
        "FT.CREATE", "small", "ON", "HASH", "PREFIX", "1", "small:", "SCHEMA",
        "v", "VECTOR", "FLAT", "6", "TYPE", "FLOAT32", "DIM", str(D),
        "DISTANCE_METRIC", "L2", "title", "TEXT") == "OK", "FT.CREATE small")
    ingest(engine, "small:", small,
           [("title", [" ".join(f"w{w:02d}" for w in row) for row in titles])],
           gpu)
    tier = ("native" if engine.manager.get("small").text_engine._nt
            is not None else "python")
    log(f"text tier serving 'small': {tier}", gpu)
    stats["text_tier"] = tier
    run_searches(torch, engine, bs, "small", "small:", qs, gt_small, "int8",
                 {k1_fused}, gpu, stats)
    run_searches(torch, engine, bs, "small", "small:", qs_gt, gt_text, "int8",
                 {k1_fused}, gpu, stats, flt=text_filter[0],
                 allowed=text_filter[1])
    return stats


# ---------------------------------------------------------------------------
# phase 5: HNSW, through Engine.execute and at full width at the index level
# ---------------------------------------------------------------------------


def _merge_launches(into: dict, launches: dict) -> None:
    for name, count in launches.items():
        into[name] = into.get(name, 0) + count


def hnsw_engine(torch, bs, dev, gpu: str, corpus, queries, cats,
                stats: dict) -> None:
    """(a) FT.CREATE ... VECTOR HNSW (M 16, EF_CONSTRUCTION 200) + TAG,
    N_HNSW HSETs (native inserts), FT.SEARCH KNN 10 EF_RUNTIME 100 from 16
    threads on the scan route (pow2 capacity 131,072: K1 at pre_shift 0,
    K2), hybrid, DEL and update; then search.hnsw-scan-threshold 0, where
    the graph walk serves: the AoS walk unfiltered, the filtered SoA walk
    under (-@cat:{c7}) (~99% qualify: inline), and the exact scan under
    @cat:{c7} (~1%: pre-filtered). Each route is checked by its counters."""
    from valkey_search_tpu_torch.runtime.metrics import STATS
    from valkey_search_tpu_torch.server.engine import Engine

    n, ef = N_HNSW, HNSW_EF
    rows, hcats = corpus[:n], cats[:n]
    qs, qs_gt = queries[:N_QUERIES], queries[:N_GT]
    c7 = hcats == 7
    c64 = torch.as_tensor(rows, dtype=torch.float64, device=dev)
    csq = (c64 * c64).sum(1)
    gt = fp64_gt(torch, c64, csq, qs_gt, K, dev)
    gt_c7 = fp64_gt(torch, c64, csq, qs_gt, K, dev, c7)
    k1_fused = "bucket_scan_i8_packed[pre_shift=0]"
    k2 = "bucket_scan_bf16"

    engine = Engine()
    check(engine.execute(
        "FT.CREATE", "hidx", "ON", "HASH", "PREFIX", "1", "h:", "SCHEMA",
        "v", "VECTOR", "HNSW", "10", "TYPE", "FLOAT32", "DIM", str(D),
        "DISTANCE_METRIC", "L2", "M", "16", "EF_CONSTRUCTION", "200",
        "cat", "TAG") == "OK", "FT.CREATE hidx")
    t0 = time.perf_counter()
    ingest(engine, "h:", rows, [("cat", [f"c{c}" for c in hcats])], gpu)
    stats["hset_us"] = (time.perf_counter() - t0) / n * 1e6
    info = engine.execute("FT.INFO", "hidx")
    attrs = {a[3]: a for a in info[info.index("attributes") + 1]}
    check(attrs["v"][5] == "HNSW" and attrs["v"][7] == n,
          f"FT.INFO hidx {attrs['v']}")
    index = engine.manager.get("hidx").attribute("v").index
    check(index.store.capacity == 131072, "hidx capacity")

    def routed(flt, dtype, gt_, expect, allowed=None, floor=RECALL_FLOOR):
        rec = {"launches": {}}
        keys = run_searches(torch, engine, bs, "hidx", "h:",
                            qs if flt == "*" else qs_gt, gt_, dtype, expect,
                            gpu, rec, flt=flt, allowed=allowed, ef=ef,
                            floor=floor)
        _merge_launches(stats["launches"], rec.pop("launches"))
        return keys, next(iter(rec.values()))

    # the scan route (search.hnsw-scan-threshold defaults to 2^30)
    _, stats["scan/int8"] = routed("*", "int8", gt, {k1_fused})
    keys_bf16, stats["scan/bfloat16"] = routed("*", "bfloat16", gt, {k2})
    for dtype, kernel in (("int8", k1_fused), ("bfloat16", k2)):
        _, stats[f"scan/{dtype}/@cat:{{c7}}"] = routed(
            "@cat:{c7}", dtype, gt_c7, {kernel}, allowed=c7)

    # DEL 1,000 returned keys: none comes back; an updated vector is first
    # (and is then set back, so the ground truth below holds)
    deleted = list(dict.fromkeys(k for row in keys_bf16 for k in row))[:1000]
    check(len(deleted) == 1000, f"only {len(deleted)} distinct keys")
    check(engine.execute("DEL", *deleted) == 1000, "DEL count (hidx)")
    gone = set(deleted)
    target = next(f"h:{i}" for i in range(n - 1, 0, -1)
                  if f"h:{i}" not in gone)
    probe = queries[-3]
    engine.execute("HSET", target, "v", probe.tobytes())
    for dtype in ("bfloat16", "int8"):
        engine.config_set("search.corpus-dtype", dtype)
        keys, _ = search_all(engine, "hidx", qs, ef=ef)
        back = sum(1 for row in keys for key in row if key in gone)
        reply = engine.execute("FT.SEARCH", "hidx", knn("*", ef=ef),
                               "PARAMS", "2", "q", probe.tobytes(),
                               "RETURN", "1", "__v_score")
        log(f"hidx after DEL of 1000 ({dtype}): {back} deleted keys "
            f"returned; updated {target}: top hit {reply[1]} at "
            f"{reply[2][1]}", gpu)
        check(back == 0, f"{back} deleted keys returned (hidx, {dtype})")
        check(reply[1] == target and abs(float(reply[2][1]))
              <= 1e-5 * float(probe @ probe), f"updated {target} not first")
    engine.execute("HSET", target, "v", rows[int(target[2:])].tobytes())

    # the graph walk serves: each route checked by its counters
    live = np.ones(n, bool)
    live[[int(k[2:]) for k in deleted]] = False
    engine.config_set("search.hnsw-scan-threshold", "0")
    engine.config_set("search.corpus-dtype", "int8")
    for flt, allowed, route in (("*", live, "aos"),
                                ("(-@cat:{c7})", live & ~c7, "soa"),
                                ("@cat:{c7}", live & c7, "scan")):
        gt_w = fp64_gt(torch, c64, csq, qs_gt, K, dev, allowed)
        before = {name: STATS.get(name) for name in (
            "hnsw_searches", "hnsw_served_by_scan",
            "vector_searches_prefiltered", "vector_searches_inline_filtered")}
        _, rec = routed(flt, "int8", gt_w,
                        {k1_fused} if route == "scan" else set(),
                        allowed=allowed, floor=HNSW_WALK_FLOOR)
        moved = {name: STATS.get(name) - v for name, v in before.items()}
        rec["counters"] = moved
        stats[f"walk/{route}/{flt}"] = rec
        log(f"hidx route {route} under {flt!r}: counters {moved}", gpu)
        check(moved["hnsw_served_by_scan"] == 0, f"{route}: served by scan")
        if route == "scan":
            check(moved["hnsw_searches"] == 0
                  and moved["vector_searches_prefiltered"] > 0,
                  f"{flt}: not the pre-filtered scan")
        else:
            check(moved["hnsw_searches"] >= len(qs_gt), f"{flt}: no walk")
        if route == "aos":
            check(index._aos_tables is not None, "the AoS mirror not built")
        if route == "soa":
            check(moved["vector_searches_inline_filtered"] > 0,
                  f"{flt}: not inline")
    engine.config_set("search.hnsw-scan-threshold", str(1 << 30))
    del c64, csq, engine, index
    torch.cuda.empty_cache()


def _device_share(torch, fn) -> dict:
    """torch.profiler over one call: device kernel time against the call's
    host-clock time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev_events = [e for e in prof.events()
                  if e.device_type == DeviceType.CUDA
                  and not e.is_user_annotation]
    busy = sum(e.time_range.elapsed_us() for e in dev_events) / 1e3
    return {"wall_ms": wall * 1e3, "device_ms": busy,
            "device_share": busy / (wall * 1e3),
            "device_ops": len(dev_events)}


def hnsw_index(torch, bs, dev, gpu: str, corpus, queries, stats: dict) -> None:
    """(b) HnswVectorIndex(dim 128, M 16, EF_CONSTRUCTION 200).bulk_load of
    N_BIG rows under build-mode device, each stage timed, and the publish;
    search_batch at B = 1,024, ef 100 on the scan route under int8 (K1 at
    pre_shift > 0) and bfloat16 (K2); the device walk at ef 10, 50 and 100
    beside the native walk over the same graph (N_NATIVE queries)."""
    from valkey_search_tpu_torch.indexes.hnsw import HnswVectorIndex
    from valkey_search_tpu_torch.ops import hnsw_search as hs_ops
    from valkey_search_tpu_torch.runtime import config

    n = len(corpus)
    qs = queries[:HNSW_B]
    c64 = torch.as_tensor(corpus, dtype=torch.float64, device=dev)
    gt = fp64_gt(torch, c64, (c64 * c64).sum(1), qs[:N_GT], K, dev)
    del c64
    torch.cuda.empty_cache()
    config.set_config("search.hnsw-build-mode", "device")
    index = HnswVectorIndex(dim=D, m=16, ef_construction=200, device=dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    index.bulk_load([f"k{i}" for i in range(n)], corpus)
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    graph = index.device_graph()
    torch.cuda.synchronize()
    publish_s = time.perf_counter() - t0
    build = {"rows": n, "bulk_load_s": build_s, "vec_per_s": n / build_s,
             **index.build_seconds, "publish_s": publish_s,
             "levels": len(graph.upper_links),
             "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30}
    stats["build"] = build
    log(f"HNSW bulk_load {n} x {D} (M 16, EF_CONSTRUCTION 200, device): "
        + json.dumps(build), gpu)
    check(index.node_count == n, "bulk_load node count")

    # the scan route, K1 (pre_shift > 0 at cap 1,048,576) and K2
    for dtype, kernel in (("int8", "bucket_scan_i8_packed[pre_shift>0]"),
                          ("bfloat16", "bucket_scan_bf16")):
        config.set_config("search.corpus-dtype", dtype)
        index.search_batch(qs, K, ef=HNSW_EF)  # publish this dtype's mirror
        bs.reset_launches()
        _, ids = index.search_batch(qs, K, ef=HNSW_EF)
        counts = bs.launch_counts()
        r = recall(ids[:N_GT], gt)
        qps = batch_qps(torch, index, qs, len(qs), ef=HNSW_EF)
        _merge_launches(stats["launches"], bs.launch_counts())
        stats[f"scan/{dtype}"] = {"recall": r, "qps": qps}
        log(f"HNSW {n} scan route corpus-dtype={dtype} B={len(qs)} ef "
            f"{HNSW_EF}: recall@{K} {r:.4f}, {qps:.1f} QPS, launches "
            f"{counts}", gpu)
        check(counts[kernel] > 0, f"HNSW {n} scan: {kernel} never launched")
        check(r >= RECALL_FLOOR, f"HNSW {n} scan ({dtype}) recall {r}")

    # the walk: check_every, then ef 10 / 50 / 100 beside the native walk
    config.set_config("search.hnsw-scan-threshold", 0)
    qt = torch.from_numpy(qs).to(dev)
    hs_ops.hnsw_search_batch(graph, qt, K, HNSW_EF)  # warm
    every = {ce: [] for ce in CHECK_EVERY_CASES}
    for rep in range(3):  # in turns, each order reversed every other round
        for ce in CHECK_EVERY_CASES[::1 if rep % 2 == 0 else -1]:
            t0 = time.perf_counter()
            hs_ops.hnsw_search_batch(graph, qt, K, HNSW_EF, check_every=ce)
            torch.cuda.synchronize()
            every[ce].append((time.perf_counter() - t0) * 1e3)
    every = {ce: sorted(v) for ce, v in every.items()}
    stats["walk_check_every_ms"] = every
    log(f"HNSW {n} SoA walk B={len(qs)} ef {HNSW_EF}, ms by check_every "
        f"(3 runs each, in turns; CHECK_EVERY={hs_ops.CHECK_EVERY}): "
        + json.dumps(every), gpu)
    native_q = qs[:N_NATIVE]
    walk = {}
    for ef in HNSW_EFS:
        _, ids = index.search_batch(qs, K, ef=ef)
        qps = batch_qps(torch, index, qs, len(qs), ef=ef)
        t0 = time.perf_counter()
        nat = [index.builder.search(q, K, ef)[1] for q in native_q]
        nat_s = time.perf_counter() - t0
        nat_ids = np.full((N_NATIVE, K), -1, np.int64)
        for i, row in enumerate(nat):
            nat_ids[i, :len(row)] = row
        walk[ef] = {"recall": recall(ids[:N_GT], gt),
                    "recall_200": recall(ids[:N_NATIVE], gt[:N_NATIVE]),
                    "qps": qps,
                    "native_recall_200": recall(nat_ids, gt[:N_NATIVE]),
                    "native_qps": N_NATIVE / nat_s}
        log(f"HNSW {n} walk ef {ef}: " + json.dumps(walk[ef]), gpu)
    stats["walk"] = walk
    share = _device_share(torch, lambda: index.search_batch(qs, K,
                                                             ef=HNSW_EF))
    stats["walk_profile"] = share
    log(f"HNSW {n} walk B={len(qs)} ef {HNSW_EF} under torch.profiler: "
        + json.dumps(share), gpu)
    top = walk[HNSW_EFS[-1]]
    check(top["recall_200"] >= top["native_recall_200"] - 0.02,
          f"device walk recall {top['recall_200']} more than 0.02 below "
          f"the native walk's {top['native_recall_200']}")
    config.set_config("search.hnsw-scan-threshold", 1 << 30)
    config.set_config("search.hnsw-build-mode", "auto")
    del index, graph, qt
    torch.cuda.empty_cache()


def hnsw_phase(torch, bs, dev, gpu: str) -> dict:
    stats = {"launches": {}}
    corpus, queries = sift_like(N_BIG, N_QUERIES + 16384)
    cats, _ = seeded_fields(N_BIG)
    t0 = time.perf_counter()
    hnsw_engine(torch, bs, dev, gpu, corpus, queries, cats, stats)
    stats["engine_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    hnsw_index(torch, bs, dev, gpu, corpus[:N_HNSW_BIG], queries, stats)
    stats["index_s"] = time.perf_counter() - t0
    for name in ("bucket_scan_i8_packed[pre_shift=0]",
                 "bucket_scan_i8_packed[pre_shift>0]", "bucket_scan_bf16"):
        check(stats["launches"].get(name, 0) > 0,
              f"{name} never launched in the HNSW phase")
    return stats


# ---------------------------------------------------------------------------


def main() -> int:
    import torch

    check(torch.cuda.is_available(), "no CUDA device: this script needs a GPU")
    try:
        from valkey_search_tpu_torch.ops import _build
        from valkey_search_tpu_torch.ops import bucket_scan as bs
        from valkey_search_tpu_torch.runtime import device
        from valkey_search_tpu_torch.text.lexer import Lexer
    except ImportError as exc:
        raise SmokeFailure(
            f"run from the root of a checkout of the repository ({exc})")

    gpu = card()
    dev = device.set_device("cuda")
    free, total = torch.cuda.mem_get_info(dev)
    log(f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}"
        f", torch {torch.__version__}, CUDA {torch.version.cuda}, memory "
        f"free {free / 2**30:.1f} GiB of {total / 2**30:.1f} GiB", gpu)

    t0 = time.perf_counter()
    # the native text tier (g++) builds beside the kernels; without it the
    # text index serves from its Python tier, which the slice reports
    text_tier = threading.Thread(target=lambda: Lexer().tokenize("warm up"))
    text_tier.start()
    sources = ("bucket_scan_i8_packed", "bucket_scan_bf16")
    with ThreadPoolExecutor(len(sources)) as pool:  # one nvcc per source
        list(pool.map(_build.load, sources))
    for name in sources:
        secs, report = _build.BUILD_INFO[name]
        log(f"built {name} in {secs:.1f} s; ptxas: "
            + " | ".join(line.strip() for line in report.splitlines()
                         if "registers" in line or "spill" in line), gpu)
    text_tier.join()
    log(f"build phase {time.perf_counter() - t0:.1f} s", gpu)

    t0 = time.perf_counter()
    records = kernel_phase(torch, bs, dev, gpu)
    log(f"kernel phase {time.perf_counter() - t0:.1f} s", gpu)

    t0 = time.perf_counter()
    stats = slice_phase(torch, bs, dev, gpu)
    log(f"slice phase {time.perf_counter() - t0:.1f} s", gpu)
    log("slice stats " + json.dumps(stats), gpu)
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    hnsw = hnsw_phase(torch, bs, dev, gpu)
    log(f"hnsw phase {time.perf_counter() - t0:.1f} s", gpu)
    log("hnsw stats " + json.dumps(hnsw), gpu)
    _merge_launches(stats["launches"], hnsw["launches"])

    replaces = {
        "bucket_scan_i8_packed[pre_shift=0]":
            ("valkey_search_tpu_torch/csrc/bucket_scan_i8_packed.cu",
             "valkey_search_tpu/ops/pallas_scan.py:418"),
        "bucket_scan_i8_packed[pre_shift>0]":
            ("valkey_search_tpu_torch/csrc/bucket_scan_i8_packed.cu",
             "valkey_search_tpu/ops/pallas_scan.py:442"),
        "bucket_scan_bf16":
            ("valkey_search_tpu_torch/csrc/bucket_scan_bf16.cu",
             "valkey_search_tpu/ops/pallas_scan.py:164"),
        "bucket_scan_i8":
            ("valkey_search_tpu_torch/csrc/bucket_scan_i8_packed.cu",
             "valkey_search_tpu/ops/pallas_scan.py:589"),
    }
    kernels = []
    for name, (source, tpu) in replaces.items():
        rec = records[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": tpu,
            # the main path's count; K3 has no search path, so its 0 stands
            # beside the kernel phase's check_launches
            "launches": stats["launches"].get(name, 0), **rec,
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(gpu, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"FAIL: {exc}", flush=True)
        sys.exit(1)
