"""Per-thread CPU monitoring (vmsdk ThreadMonitor parity).

The reference samples per-thread CPU% for every pool thread and exports
pool averages through INFO (vmsdk/src/thread_monitoring.h:15,
thread_pool.h:111, wired at valkey_search.cc:537-552). Here the same
observability comes from /proc/self/task/<tid>/stat: Python threads carry
their native tid (threading.native_id), so utime+stime deltas between
snapshots give each thread's CPU share, grouped by thread-name prefix
(reader pool, ingestion workers, RESP connections, gossip...).

The port's own copy of valkey_search_tpu/runtime/threadmon.py, with its imports
pointing into valkey_search_tpu_torch.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, Tuple

_CLK_TCK = os.sysconf("SC_CLK_TCK") if hasattr(os, "sysconf") else 100


def _thread_cpu_seconds(tid: int) -> float:
    """utime+stime of one native thread, in seconds; 0.0 if gone."""
    try:
        with open(f"/proc/self/task/{tid}/stat", "rb") as f:
            data = f.read()
    except OSError:
        return 0.0
    # fields after the parenthesized comm (which may contain spaces)
    try:
        rest = data[data.rindex(b")") + 2 :].split()
        utime, stime = int(rest[11]), int(rest[12])
    except (ValueError, IndexError):
        return 0.0
    return (utime + stime) / _CLK_TCK


def _pool_of(name: str) -> str:
    """Group thread names into pools (reader-0 → reader, Thread-7 → other)."""
    base = name.split(":")[0]
    for sep in ("-", "_"):
        head, _, tail = base.rpartition(sep)
        if head and tail.isdigit():
            base = head
            break
    return base or "other"


class ThreadCpuMonitor:
    """Snapshot-diff CPU% per pool of named Python threads."""

    def __init__(self):
        self._lock = threading.Lock()
        self._last: Dict[int, Tuple[float, str]] = {}
        self._last_wall = time.monotonic()
        self._percent: Dict[str, float] = {}

    def sample(self) -> Dict[str, float]:
        """Take a snapshot; returns {pool: cpu_percent} since last call."""
        now = time.monotonic()
        threads = [
            t for t in threading.enumerate() if t.native_id is not None
        ]
        cur: Dict[int, Tuple[float, str]] = {
            t.native_id: (_thread_cpu_seconds(t.native_id), _pool_of(t.name))
            for t in threads
        }
        with self._lock:
            wall = max(now - self._last_wall, 1e-6)
            usage: Dict[str, float] = {}
            for tid, (cpu, pool) in cur.items():
                prev = self._last.get(tid)
                delta = cpu - prev[0] if prev else 0.0
                if delta > 0:
                    usage[pool] = usage.get(pool, 0.0) + delta
            self._percent = {
                pool: round(100.0 * d / wall, 2) for pool, d in usage.items()
            }
            self._last = cur
            self._last_wall = now
            return dict(self._percent)

    def percents(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._percent)


MONITOR = ThreadCpuMonitor()
