"""Global metrics: counters + latency histograms.

Models the reference's Metrics singleton (src/metrics.h:29-155 — ~70
counters and 12 HDR latency samplers) and vmsdk::LatencySampler
(vmsdk/src/latency_sampler.h — hdrhistogram, ~1% precision, sampled 1-in-N).

Here: a plain thread-safe counter table plus a log-bucketed histogram
(64 buckets/decade ≈ 1.1% relative error — same ballpark as the reference's
precision-2 hdrhistogram) with 1-in-N sampling on the hot paths.

The port's own copy of valkey_search_tpu/runtime/metrics.py: the same
names, defaults and behaviour, with its imports pointing into
valkey_search_tpu_torch.
"""

from __future__ import annotations

import math
import threading
import time
from collections import defaultdict
from typing import Dict, Optional


class LatencySampler:
    """Log-bucketed latency histogram over microseconds.

    Bucket b holds values in [2^(b/G), 2^((b+1)/G)) µs with G buckets per
    octave; G=64 gives ~1.1% relative error, comparable to the reference's
    hdrhistogram precision 2 (src/metrics.h:17-18) at a fraction of the
    memory.
    """

    GRANULARITY = 64
    MAX_EXP = 32  # up to 2^32 µs ≈ 71 min

    def __init__(self, sample_every_n: int = 1):
        self._buckets: Dict[int, int] = defaultdict(int)
        self._count = 0
        self._calls = 0
        self._sample_every_n = max(1, sample_every_n)
        self._lock = threading.Lock()

    def observe_usec(self, usec: float) -> None:
        with self._lock:
            self._calls += 1
            if self._calls % self._sample_every_n:
                return
            usec = max(usec, 1e-3)
            b = int(math.log2(usec) * self.GRANULARITY)
            self._buckets[b] += 1
            self._count += 1

    def percentile(self, p: float) -> Optional[float]:
        with self._lock:
            if not self._count:
                return None
            target = p / 100.0 * self._count
            seen = 0
            for b in sorted(self._buckets):
                seen += self._buckets[b]
                if seen >= target:
                    return 2.0 ** ((b + 0.5) / self.GRANULARITY)
            return 2.0 ** ((max(self._buckets) + 0.5) / self.GRANULARITY)

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    def summary(self) -> Dict[str, Optional[float]]:
        return {
            "p50_usec": self.percentile(50),
            "p99_usec": self.percentile(99),
            "count": self.count,
        }


class Stats:
    """Counter + sampler table; mirrors Metrics::GetStats() (src/metrics.h:156)."""

    def __init__(self):
        self._counters: Dict[str, int] = defaultdict(int)
        self._samplers: Dict[str, LatencySampler] = {}
        self._lock = threading.Lock()

    def incr(self, name: str, by: int = 1) -> None:
        with self._lock:
            self._counters[name] += by

    def get(self, name: str) -> int:
        with self._lock:
            return self._counters[name]

    def sampler(self, name: str, sample_every_n: int = 1) -> LatencySampler:
        with self._lock:
            if name not in self._samplers:
                self._samplers[name] = LatencySampler(sample_every_n)
            return self._samplers[name]

    def snapshot(self) -> Dict[str, object]:
        with self._lock:
            out: Dict[str, object] = dict(self._counters)
            for name, s in self._samplers.items():
                out[f"{name}_latency"] = s.summary()
            return out

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._samplers.clear()


STATS = Stats()


class timed:
    """Context manager: record elapsed µs into a sampler."""

    def __init__(self, sampler: LatencySampler):
        self._sampler = sampler

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._sampler.observe_usec((time.perf_counter() - self._t0) * 1e6)
        return False
