"""Numeric index: doc -> value, with range predicates on a device column.

Counterpart of valkey_search_tpu/indexes/numeric.py (reference
src/indexes/numeric.{h,cc}). The host keeps each doc's value as a Python
float; planner counts and host id lists come from a lazily rebuilt sorted
array (``range_count``, ``range_docs_array``). Range predicates evaluate on
an fp32 column over doc ids (NaN = no value) on the index's device.

The column is synced incrementally: a mutation marks its doc dirty, and the
next ``device_column`` writes only the dirty docs into the device column in
place (the JAX package builds a new array per scatter). Readers never see a
half-written column: the scatter and every mask built from the column run
under the index lock, and each mask is a new tensor. The column is uploaded
whole only when its capacity changes.

``device_mask`` compares in fp32, as the JAX package does: a Python-float
bound is cast to the column's dtype (JAX weak typing; torch wrapped
scalars), so masks agree bit for bit, values above 2^24 included. The
host-side check (``query/predicate.py`` ``NumericPredicate.matches``)
compares the float64 value, as the JAX package's does.
"""

from __future__ import annotations

import math
import threading
from typing import Dict, Optional, Set

import numpy as np
import torch

from valkey_search_tpu_torch.runtime import config
from valkey_search_tpu_torch.utils.interning import KeyInterner
from valkey_search_tpu_torch.indexes.base import (
    EntriesFetcher,
    IndexBase,
    RecordResult,
)
from valkey_search_tpu_torch.runtime.device import get_device


def _parse_number(value) -> Optional[float]:
    # overlong numeric strings are invalid data (reference
    # max-numeric-field-length, ft_create_parser.cc:66, default 128)
    if isinstance(value, (str, bytes, bytearray)) and len(value) > int(
        config.get("search.max-numeric-field-length")
    ):
        return None
    try:
        v = float(value)
    except (TypeError, ValueError):
        return None
    if math.isnan(v):
        return None
    return v


def _pow2_capacity(n: int) -> int:
    return max(2048, 1 << int(np.ceil(np.log2(max(n, 1)))))


class NumericIndex(IndexBase):
    kind = "NUMERIC"
    mutation_weight = 1.0

    def __init__(self, interner: Optional[KeyInterner] = None,
                 device: Optional[torch.device] = None):
        self._owns_interner = interner is None
        self.interner = interner if interner is not None else KeyInterner()
        self.device = torch.device(device) if device is not None \
            else get_device()
        self._values: Dict[int, float] = {}  # doc -> value
        self._tracked: Dict[str, int] = {}
        self._untracked: Set[str] = set()
        self._sorted: Optional[np.ndarray] = None  # cached sorted values
        self._sorted_docs: Optional[np.ndarray] = None
        self._column = np.full(2048, np.nan, np.float32)
        self._dirty: set = set()
        self._device_col: Optional[torch.Tensor] = None
        self._lock = threading.RLock()
        self.epoch = 0

    def memory_bytes(self) -> int:
        with self._lock:
            b = self._column.nbytes + 72 * (
                len(self._values) + len(self._tracked) + len(self._untracked)
            )
            if self._sorted is not None:
                b += self._sorted.nbytes
            if self._sorted_docs is not None:
                b += self._sorted_docs.nbytes
            return b

    # -- mutation ------------------------------------------------------------
    def add_record(self, key: str, value) -> RecordResult:
        v = _parse_number(value)
        with self._lock:
            existed = key in self._tracked
            if v is None:
                # unparsable -> INVALID_DATA: the schema drops the key from
                # every index (index_schema.cc:729)
                if existed:
                    self._remove_locked(key)
                self._untracked.add(key)
                return RecordResult.INVALID_DATA
            doc = self.interner.intern(key)
            self._untracked.discard(key)
            self._tracked[key] = doc
            self._values[doc] = v
            self._set_col(doc, v)
            self._sorted = None
            self.epoch += 1
            return RecordResult.MODIFIED if existed else RecordResult.ADDED

    def modify_record(self, key: str, value) -> RecordResult:
        return self.add_record(key, value)

    def remove_record(self, key: str) -> RecordResult:
        with self._lock:
            self._untracked.discard(key)
            if key not in self._tracked:
                return RecordResult.SKIPPED
            self._remove_locked(key)
            return RecordResult.REMOVED

    def _remove_locked(self, key: str) -> None:
        doc = self._tracked.pop(key)
        self._values.pop(doc, None)
        self._set_col(doc, float("nan"))
        if self._owns_interner:
            self.interner.release(key)
        self._sorted = None
        self.epoch += 1

    def _grow_col(self, cap: int) -> None:
        col = np.full(_pow2_capacity(cap), np.nan, np.float32)
        col[: self._column.shape[0]] = self._column
        self._column = col
        self._device_col = None  # capacity changed: full upload

    def _set_col(self, doc: int, v: float) -> None:
        if doc >= self._column.shape[0]:
            self._grow_col(doc + 1)
        self._column[doc] = np.float32(v)
        self._dirty.add(doc)

    # -- planner estimates and host ids ----------------------------------------
    def _ensure_sorted(self):
        if self._sorted is None:
            docs = np.fromiter(self._values.keys(), np.int64, len(self._values))
            vals = np.fromiter(self._values.values(), np.float64,
                               len(self._values))
            order = np.argsort(vals, kind="stable")
            self._sorted = vals[order]
            self._sorted_docs = docs[order]

    def _range_slice(self, lo, hi, lo_open, hi_open) -> slice:
        self._ensure_sorted()
        left = np.searchsorted(self._sorted, lo, "right" if lo_open else "left")
        right = np.searchsorted(self._sorted, hi, "left" if hi_open else "right")
        return slice(int(left), max(int(left), int(right)))

    def range_count(self, lo: float, hi: float, lo_open: bool = False,
                    hi_open: bool = False) -> int:
        """Count of docs with a value in the range (planner sizing)."""
        with self._lock:
            if not self._values:
                return 0
            s = self._range_slice(lo, hi, lo_open, hi_open)
            return s.stop - s.start

    def range_fetch(self, lo: float, hi: float, lo_open: bool = False,
                    hi_open: bool = False) -> EntriesFetcher:
        with self._lock:
            if not self._values:
                return EntriesFetcher((), size=0)
            ids = self._sorted_docs[self._range_slice(lo, hi, lo_open,
                                                      hi_open)]
            return EntriesFetcher(ids.tolist(), size=len(ids))

    def range_docs_array(self, lo: float, hi: float, lo_open: bool = False,
                         hi_open: bool = False) -> np.ndarray:
        """Sorted doc ids in range (one value per doc, so already unique)."""
        with self._lock:
            if not self._values:
                return np.empty(0, np.int64)
            s = self._range_slice(lo, hi, lo_open, hi_open)
            return np.sort(self._sorted_docs[s].astype(np.int64))

    # -- device predicate ----------------------------------------------------
    def _device_column_locked(self, cap: int) -> torch.Tensor:
        if cap > self._column.shape[0]:
            self._grow_col(cap)
        col = self._column
        if self._device_col is None:
            self._device_col = torch.from_numpy(col).to(self.device,
                                                        copy=True)
            self._dirty.clear()
        elif self._dirty:
            idx = np.fromiter(self._dirty, np.int64, len(self._dirty))
            self._device_col[torch.from_numpy(idx).to(self.device)] = \
                torch.from_numpy(col[idx]).to(self.device)
            self._dirty.clear()
        return self._device_col[:cap]

    def device_column(self, cap: int) -> torch.Tensor:
        """fp32 [cap] column (NaN = no value) on the index's device. The
        view is written in place by later syncs: read it under the lock or
        copy it."""
        with self._lock:
            return self._device_column_locked(cap).clone()

    def device_mask(self, lo: float, hi: float, cap: int,
                    lo_open: bool = False, hi_open: bool = False
                    ) -> torch.Tensor:
        """bool [cap]: docs whose fp32 value lies in the range."""
        with self._lock:
            col = self._device_column_locked(cap)
            lo_ok = (col > lo) if lo_open else (col >= lo)
            hi_ok = (col < hi) if hi_open else (col <= hi)
            return lo_ok & hi_ok & ~torch.isnan(col)

    # -- IndexBase -----------------------------------------------------------
    def tracked_keys(self) -> Set[str]:
        with self._lock:
            return set(self._tracked)

    def tracks(self, key: str) -> bool:
        with self._lock:
            return key in self._tracked

    def untracked_keys(self) -> Set[str]:
        with self._lock:
            return set(self._untracked)

    def count(self) -> int:
        with self._lock:
            return len(self._tracked)

    def value_of(self, key: str) -> Optional[float]:
        with self._lock:
            doc = self._tracked.get(key)
            return self._values.get(doc) if doc is not None else None

    def all_docs(self) -> Set[int]:
        with self._lock:
            return set(self._tracked.values())
