"""Pausepoints + controlled variables (test/fault-injection hooks).

Reference: vmsdk/src/debug.{h,cc} — named pausepoints background threads
block on (BACKGROUND_PAUSEPOINT marks in search/ingest paths,
search.cc:115,435,657,881) and CONTROLLED_* variables that force failure
branches (e.g. ForceInvalidSlotFingerprint, fanout.cc:48), both driven
through FT._DEBUG (ft_debug.cc:95-365) and gated behind
search.debug-mode. Integration tests use them to freeze threads at named
points and to take forced-error branches deterministically (SURVEY.md
§4.2 determinism tools).

The port's own copy of valkey_search_tpu/runtime/debug.py: the same
names, defaults and behaviour, with its imports pointing into
valkey_search_tpu_torch.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional


class PausePointRegistry:
    """Named gates. `pause(name)` arms one; worker code calls `test(name)`
    which blocks while armed and records the hit count."""

    def __init__(self):
        self._lock = threading.Lock()
        self._armed: Dict[str, threading.Event] = {}  # set() = released
        self._hits: Dict[str, int] = {}
        self._waiting: Dict[str, int] = {}

    def pause(self, name: str) -> None:
        with self._lock:
            ev = self._armed.get(name)
            if ev is None or ev.is_set():
                self._armed[name] = threading.Event()

    def resume(self, name: str) -> None:
        with self._lock:
            ev = self._armed.pop(name, None)
            self._hits.pop(name, None)
        if ev is not None:
            ev.set()

    def is_paused(self, name: str) -> bool:
        with self._lock:
            ev = self._armed.get(name)
            return ev is not None and not ev.is_set()

    def hits(self, name: str) -> int:
        with self._lock:
            return self._hits.get(name, 0)

    def waiting(self, name: str) -> int:
        """Threads currently blocked at the point (the reference's
        pausepoint_hit barrier, integration/utils.py:91)."""
        with self._lock:
            return self._waiting.get(name, 0)

    def list(self) -> List[str]:
        with self._lock:
            return sorted(n for n, ev in self._armed.items() if not ev.is_set())

    def test(self, name: str, timeout: Optional[float] = 30.0) -> None:
        """Called from background code at a named point; blocks while armed."""
        with self._lock:
            ev = self._armed.get(name)
            self._hits[name] = self._hits.get(name, 0) + 1
            if ev is None or ev.is_set():
                return
            self._waiting[name] = self._waiting.get(name, 0) + 1
        try:
            ev.wait(timeout)
        finally:
            with self._lock:
                self._waiting[name] -= 1

    def reset_all(self) -> None:
        with self._lock:
            evs = list(self._armed.values())
            self._armed.clear()
            self._hits.clear()
        for ev in evs:
            ev.set()


class ControlledVariables:
    """Typed test overrides checked at forced-failure branches."""

    def __init__(self):
        self._lock = threading.Lock()
        self._vars: Dict[str, object] = {}

    def set(self, name: str, value: object) -> None:
        with self._lock:
            self._vars[name] = value

    def get(self, name: str, default: object = None) -> object:
        with self._lock:
            return self._vars.get(name, default)

    def is_true(self, name: str) -> bool:
        v = self.get(name, False)
        return str(v).lower() in ("1", "true", "yes", "on")

    def clear(self, name: str) -> None:
        with self._lock:
            self._vars.pop(name, None)

    def list(self) -> Dict[str, object]:
        with self._lock:
            return dict(self._vars)

    def reset_all(self) -> None:
        with self._lock:
            self._vars.clear()


class TestCounters:
    """TEST_COUNTER equivalents (debug.h:178-181): named counters bumped
    at interesting code points, readable through FT._DEBUG."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counts: Dict[str, int] = {}

    def incr(self, name: str, by: int = 1) -> None:
        with self._lock:
            self._counts[name] = self._counts.get(name, 0) + by

    def get(self, name: str) -> int:
        with self._lock:
            return self._counts.get(name, 0)

    def list(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counts)

    def reset_all(self) -> None:
        with self._lock:
            self._counts.clear()


PAUSEPOINTS = PausePointRegistry()
CONTROLLED = ControlledVariables()
TEST_COUNTERS = TestCounters()


def reset_all() -> None:
    PAUSEPOINTS.reset_all()
    CONTROLLED.reset_all()
    TEST_COUNTERS.reset_all()
