"""Cancellation tokens: deadline- or caller-driven query abort.

Reference: src/utils/cancel.{h,cc} — cancel::Token is a shared flag set
by a timeout timer or the gRPC context, checked inside the search hot
loops (search.cc:449,672) and inside hnswlib via a cancellation functor
(hnswlib.h:152-158); expired queries raise and count
`search_query_timeouts`.

On TPU a launched kernel is not interruptible — the token guards the
host-side loops around it (per-shard fanout, non-vector scans, content
resolution, retry loops), which is where long queries actually spend
host time.

The port's own copy of valkey_search_tpu/utils/cancel.py: the same
names, defaults and behaviour, with its imports pointing into
valkey_search_tpu_torch.
"""

from __future__ import annotations

import time
from typing import Optional


class CancelledError(TimeoutError):
    pass


class Token:
    __slots__ = ("_deadline", "_cancelled", "reason")

    def __init__(self, timeout_ms: Optional[float] = None):
        self._deadline = (
            time.monotonic() + timeout_ms / 1000.0
            if timeout_ms is not None else None
        )
        self._cancelled = False
        self.reason = ""

    def cancel(self, reason: str = "cancelled") -> None:
        self._cancelled = True
        self.reason = reason

    def expired(self) -> bool:
        if self._cancelled:
            return True
        if self._deadline is not None and time.monotonic() > self._deadline:
            self._cancelled = True
            # reference client-visible error string (search.cc TimedOut →
            # "Search operation cancelled due to timeout", drilled by
            # integration/test_cancel.py)
            self.reason = "Search operation cancelled due to timeout"
            return True
        return False

    def check(self) -> None:
        """Raise if cancelled/expired (hot-loop checkpoint)."""
        if self.expired():
            from valkey_search_tpu_torch.runtime.metrics import STATS

            STATS.incr("query_timeouts")
            raise CancelledError(self.reason or "query cancelled")


def from_timeout_ms(timeout_ms: Optional[float]) -> Token:
    from valkey_search_tpu_torch.runtime import config
    from valkey_search_tpu_torch.runtime.debug import CONTROLLED, TEST_COUNTERS

    if CONTROLLED.is_true("ForceTimeout"):
        # forced-cancel drill (reference CONTROLLED_BOOLEAN ForceTimeout +
        # TimeoutPollFrequency, drilled by integration/
        # test_ft_search_partition_consistency_controls.py): every query
        # observes an already-expired deadline and counts a ForceCancel
        TEST_COUNTERS.incr("ForceCancels")
        t = Token(None)
        t.cancel("Search operation cancelled due to timeout")
        return t
    if timeout_ms is None:
        timeout_ms = float(config.get("search.timeout-ms"))
    return Token(timeout_ms)
