"""The cost of one of the program's span points on this host's CPU.

    python3 benchmark/span_cost.py [--n 200000] [--repeats 5]

Times a loop of span points written as the program writes them (the
thread's request id read, a clock read at the start and at the end, the
record) into a ring of its own, for a traced request and for one that is
not traced, a loop of the record call alone, and an empty loop; each the
best of ``--repeats``. It prints one JSON line: ns a span point of a traced
request (``span_ns``) and of one not traced (``untraced_ns``), and of the
record call alone (``record_ns``), the empty loop taken off. The benchmark's
own runs never call this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def loop_ns(n: int, ring, ctx, clock, name: int) -> float:
    t = time.perf_counter_ns()
    for _ in range(n):
        rid = ctx.rid
        t0 = clock() if rid else 0
        if rid:
            ring.record(name, t0, clock(), rid, ctx.launch)
    return (time.perf_counter_ns() - t) / n


def record_ns(n: int, ring, name: int) -> float:
    t = time.perf_counter_ns()
    for i in range(n):
        ring.record(name, i, i, 1, 2)
    return (time.perf_counter_ns() - t) / n


def empty_ns(n: int) -> float:
    t = time.perf_counter_ns()
    for _ in range(n):
        pass
    return (time.perf_counter_ns() - t) / n


def one_span(n: int, repeats: int) -> dict:
    from valkey_search_tpu_torch.runtime.metrics import (
        SPAN,
        SpanContext,
        SpanRecorder,
        clock,
    )

    ring = SpanRecorder(1 << 16)
    ctx = SpanContext()
    name = SPAN["topk.scan"]
    best = {}
    for rid in (1, 0):
        ctx.rid = rid
        best[rid] = min(loop_ns(n, ring, ctx, clock, name)
                        for _ in range(repeats))
    alone = min(record_ns(n, ring, name) for _ in range(repeats))
    base = min(empty_ns(n) for _ in range(repeats))
    return {"span_ns": best[1] - base, "untraced_ns": best[0] - base,
            "record_ns": alone - base, "empty_loop_ns": base, "n": n,
            "cpus": os.cpu_count(), "python": sys.version.split()[0]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=200_000)
    ap.add_argument("--repeats", type=int, default=5)
    args = ap.parse_args(argv)
    print(json.dumps(one_span(args.n, args.repeats)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
