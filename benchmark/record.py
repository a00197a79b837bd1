"""What one run measured, as the metric readers see it.

Each reader under ``metrics/`` is a function ``read(run)`` of a ``Run``; it
returns a number, or None when it finds nothing to read (the harness then
leaves the metric out of the line).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np


class Run:
    def __init__(self, config: dict, traffic: dict, t0: float, t1: float,
                 setup_s: float, requests: List[list], recall: np.ndarray,
                 spans=None, device_slice=None, device_kind: str = "",
                 counters: Optional[Dict[str, Dict[str, int]]] = None):
        self.config = config
        self.traffic = traffic
        self.t0, self.t1 = t0, t1
        self.setup_s = setup_s
        self.requests = requests  # the client records judged
        self.recall = recall  # per entry of ``requests``
        self.spans = spans  # tracing.Spans, traced runs only
        self.device_slice = device_slice  # tracing.DeviceSlice or None
        self.device_kind = device_kind
        self.counters = counters or {}

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0

    def in_window(self, t: Optional[float]) -> bool:
        return t is not None and self.t0 <= t <= self.t1

    def answered(self) -> List[int]:
        """Indices into ``requests`` of the replies answered in the window."""
        return [n for n, r in enumerate(self.requests)
                if r[5] is not None and self.in_window(r[4])]

    def latencies_s(self) -> np.ndarray:
        return np.asarray([self.requests[n][4] - self.requests[n][3]
                           for n in self.answered()], np.float64)

    def ft_search_spans(self) -> list:
        if self.spans is None:
            return []
        return [(s, e) for s, e in self.spans.ft_search if self.in_window(e)]

    def search_batch_spans(self) -> list:
        if self.spans is None:
            return []
        return [s for s in self.spans.search_batch if self.in_window(s.end)]

    def rows_admitted(self, span) -> int:
        """Rows a ``search_batch`` span's filter admits (all rows without)."""
        return int(self.config["rows"]) if span.admitted < 0 else span.admitted
