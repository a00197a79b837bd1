"""Key interning: document keys ↔ dense int32 doc ids.

TPU-native rethink of the reference's StringInternStore
(src/utils/string_interning.h:40-100) + per-vector-index key↔internal-id
maps (src/indexes/vector_base.h:263-276). On TPU every per-attribute index
must address documents by position in device arrays, so the id space is
*shared per index schema*: one dense doc-id space that vector rows, tag
postings, numeric columns and predicate bitmasks all align to. Freed ids
are recycled through a free list so capacity stays dense under churn
(reference hnswlib allow_replace_deleted semantics, hnswalg.h:1260-1300).

The port's own copy of valkey_search_tpu/utils/interning.py: the same
names, defaults and behaviour, with its imports pointing into
valkey_search_tpu_torch.
"""

from __future__ import annotations

import threading
from typing import Dict, Iterator, List, Optional


class KeyInterner:
    """Dense doc-id allocator shared by all attribute indexes of a schema."""

    def __init__(self):
        self._key_to_id: Dict[str, int] = {}
        self._id_to_key: List[Optional[str]] = []
        self._free: List[int] = []
        self._lock = threading.RLock()
        self.epoch = 0  # bumped per id-space change (valid-mask cache key)

    def memory_bytes(self) -> int:
        with self._lock:
            return sum(
                120 + 2 * len(k) for k in self._key_to_id
            ) + 8 * len(self._id_to_key)

    def intern(self, key: str) -> int:
        """Return the doc id for key, allocating one if new."""
        with self._lock:
            doc = self._key_to_id.get(key)
            if doc is not None:
                return doc
            if self._free:
                doc = self._free.pop()
                self._id_to_key[doc] = key
            else:
                doc = len(self._id_to_key)
                self._id_to_key.append(key)
            self._key_to_id[key] = doc
            self.epoch += 1
            return doc

    def intern_many(self, keys) -> "list":
        """Batch intern: one lock hold and bound dict methods (the
        per-key ``intern`` call loop was a large slice of 10M-row
        bulk_load host time). Returns a list of doc ids aligned to
        ``keys``."""
        out = [0] * len(keys)
        with self._lock:
            k2i = self._key_to_id
            i2k = self._id_to_key
            free = self._free
            get = k2i.get
            append = i2k.append
            for i, key in enumerate(keys):
                doc = get(key)
                if doc is None:
                    if free:
                        doc = free.pop()
                        i2k[doc] = key
                    else:
                        doc = len(i2k)
                        append(key)
                    k2i[key] = doc
                out[i] = doc
            self.epoch += 1
        return out

    def lookup(self, key: str) -> Optional[int]:
        with self._lock:
            return self._key_to_id.get(key)

    def key_of(self, doc: int) -> Optional[str]:
        with self._lock:
            if 0 <= doc < len(self._id_to_key):
                return self._id_to_key[doc]
            return None

    def ids_array(self):
        """Sorted-unique ndarray of every live doc id, memoized per epoch
        (the match-all/negation fast path — rebuilding a 100k-id array per
        query was the negation bottleneck)."""
        import numpy as np

        with self._lock:
            cached = getattr(self, "_ids_cache", None)
            if cached is not None and cached[0] == self.epoch:
                return cached[1]
            arr = np.fromiter(self._key_to_id.values(), np.int64,
                              len(self._key_to_id))
            arr.sort()
            self._ids_cache = (self.epoch, arr)
            return arr

    def keys_of(self, docs) -> list:
        """Batch key_of: one lock acquisition for a whole result window
        (the per-row lock round-trip was ~30% of the non-vector reply
        loop). None for out-of-range/released ids."""
        with self._lock:
            table = self._id_to_key
            n = len(table)
            return [table[d] if 0 <= d < n else None for d in docs]

    def release(self, key: str) -> Optional[int]:
        """Free a key's id (document fully removed). Returns the freed id."""
        with self._lock:
            doc = self._key_to_id.pop(key, None)
            if doc is None:
                return None
            self._id_to_key[doc] = None
            self._free.append(doc)
            self.epoch += 1
            return doc

    def restore(self, mapping: Dict[str, int], capacity: Optional[int] = None) -> None:
        """Reset to an exact key→id assignment (checkpoint load: the saved
        id space must be reproduced verbatim so vector rows, graph nodes and
        predicate masks still line up — reference SaveTrackedKeys key→id
        maps, vector_base.h:263-276)."""
        with self._lock:
            cap = capacity if capacity is not None else (
                max(mapping.values()) + 1 if mapping else 0
            )
            if mapping and max(mapping.values()) >= cap:
                raise ValueError("interner capacity smaller than max doc id")
            self._key_to_id = dict(mapping)
            self._id_to_key = [None] * cap
            for key, doc in mapping.items():
                if self._id_to_key[doc] is not None:
                    raise ValueError(f"duplicate doc id {doc}")
                self._id_to_key[doc] = key
            self._free = [i for i in range(cap - 1, -1, -1)
                          if self._id_to_key[i] is None]
            self.epoch += 1

    def valid_ids_np(self, cap: int):
        """bool [cap]: allocated doc ids — vectorized (allocated = below
        the high-water mark and not on the free list)."""
        import numpy as np

        with self._lock:
            out = np.zeros(cap, bool)
            hw = min(len(self._id_to_key), cap)
            out[:hw] = True
            if self._free:
                free = np.asarray(self._free, np.int64)
                out[free[free < cap]] = False
            return out

    @property
    def capacity(self) -> int:
        """High-water mark of allocated ids (device arrays size to this)."""
        with self._lock:
            return len(self._id_to_key)

    @property
    def count(self) -> int:
        with self._lock:
            return len(self._key_to_id)

    def items(self) -> Iterator[tuple]:
        with self._lock:
            return iter(list(self._key_to_id.items()))
