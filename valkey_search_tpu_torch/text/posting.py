"""Postings: one word's (doc -> ordered positions, per-position field mask).

Copied unchanged from valkey_search_tpu/text/posting.py.

Reference: src/indexes/text/posting.h — "an ordered list of Keys and for
each Key an ordered list of Positions; each position is tagged with a
bitmask of fields" (FieldMask, 64 fields max), with KeyIterator /
PositionIterator used by the streaming term/proximity iterators.

Here docs are dense int doc-ids (the schema KeyInterner space), so the
key list is a sorted dict and the per-doc position map is a plain
dict[pos -> mask]; iteration yields sorted views. Mask bits are the
per-schema text-field bits (TextEngine.fields)."""

from __future__ import annotations

from typing import Dict, Iterator, List, Tuple

MAX_TEXT_FIELDS = 64  # reference FieldMask is uint64 (posting.h:52)


class Postings:
    __slots__ = ("_docs", "_doc_mask", "_position_count", "_cache")

    def __init__(self):
        self._docs: Dict[int, Dict[int, int]] = {}  # doc -> {position -> field mask}
        # aggregate OR of all position masks per doc: lets docs()/contains()
        # answer without iterating positions (the query hot path)
        self._doc_mask: Dict[int, int] = {}
        self._position_count = 0
        # lazily-built numpy view (sorted doc ids + aggregate masks);
        # invalidated on mutation — the vectorized query fast path
        self._cache = None

    def is_empty(self) -> bool:
        return not self._docs

    def key_count(self) -> int:
        return len(self._docs)

    def position_count(self) -> int:
        return self._position_count

    def add(self, doc: int, position: int, field_bit: int) -> None:
        pm = self._docs.setdefault(doc, {})
        prev = pm.get(position)
        if prev is None:
            pm[position] = field_bit
            self._position_count += 1
        else:
            pm[position] = prev | field_bit
        self._doc_mask[doc] = self._doc_mask.get(doc, 0) | field_bit
        self._cache = None

    def remove_field(self, doc: int, field_bit: int) -> None:
        """Drop one field's positions for a doc (re-index of that field)."""
        pm = self._docs.get(doc)
        if pm is None:
            return
        dead = []
        agg = 0
        for pos, mask in pm.items():
            mask &= ~field_bit
            if mask:
                pm[pos] = mask
                agg |= mask
            else:
                dead.append(pos)
        for pos in dead:
            del pm[pos]
            self._position_count -= 1
        if not pm:
            del self._docs[doc]
            del self._doc_mask[doc]
        else:
            self._doc_mask[doc] = agg
        self._cache = None

    def remove_doc(self, doc: int) -> None:
        pm = self._docs.pop(doc, None)
        if pm:
            self._position_count -= len(pm)
            self._doc_mask.pop(doc, None)
            self._cache = None

    def arrays(self):
        """(doc_ids int64[], agg_masks int64[]) — built lazily, cached until
        the next mutation. The vectorized replacement for per-position
        Python iteration on the query path."""
        import numpy as np

        c = self._cache
        if c is None:
            ids = np.fromiter(self._doc_mask.keys(), np.int64,
                              len(self._doc_mask))
            masks = np.fromiter(self._doc_mask.values(), np.int64,
                                len(self._doc_mask))
            c = self._cache = (ids, masks)
        return c

    def docs_array(self, field_mask: int = ~0):
        """Doc ids (unsorted) where the word appears in any field of
        field_mask, as a numpy int64 array."""
        ids, masks = self.arrays()
        if field_mask == ~0 or not len(ids):
            return ids
        return ids[(masks & field_mask) != 0]

    def docs(self, field_mask: int = ~0) -> Iterator[int]:
        """Docs where this word appears in any field of field_mask
        (KeyIterator.ContainsFields, posting.h:118)."""
        for doc, mask in self._doc_mask.items():
            if mask & field_mask:
                yield doc

    def contains(self, doc: int, field_mask: int = ~0) -> bool:
        return bool(self._doc_mask.get(doc, 0) & field_mask)

    def positions(self, doc: int, field_mask: int = ~0) -> List[int]:
        """Sorted positions of this word in doc restricted to field_mask."""
        pm = self._docs.get(doc)
        if pm is None:
            return []
        return sorted(p for p, m in pm.items() if m & field_mask)

    def items(self) -> Iterator[Tuple[int, Dict[int, int]]]:
        return iter(self._docs.items())
