"""Intrusive-style LRU cache (reference src/utils/lru.h — used by the
VectorExternalizer's denormalized-vector cache, vector_externalizer.h:31
kLRUCapacity=100).

The port's own copy of valkey_search_tpu/utils/lru.py: the same
names, defaults and behaviour, with its imports pointing into
valkey_search_tpu_torch.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Generic, Optional, TypeVar

K = TypeVar("K")
V = TypeVar("V")


class LRU(Generic[K, V]):
    def __init__(self, capacity: int):
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        self.capacity = capacity
        self._d: "OrderedDict[K, V]" = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def get(self, key: K) -> Optional[V]:
        with self._lock:
            if key in self._d:
                self._d.move_to_end(key)
                self.hits += 1
                return self._d[key]
            self.misses += 1
            return None

    def put(self, key: K, value: V) -> None:
        with self._lock:
            self._d[key] = value
            self._d.move_to_end(key)
            while len(self._d) > self.capacity:
                self._d.popitem(last=False)

    def remove(self, key: K) -> None:
        with self._lock:
            self._d.pop(key, None)

    def __len__(self) -> int:
        with self._lock:
            return len(self._d)
