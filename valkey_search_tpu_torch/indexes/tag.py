"""Tag index: normalized tag values -> doc-id postings, device bool masks.

Counterpart of valkey_search_tpu/indexes/tag.py (reference
src/indexes/tag.{h,cc}). The host keeps tag -> doc-id sets and a sorted tag
list for prefix patterns (``pre*``). A query's tag disjunction becomes a
bool tensor over doc ids on the index's device, built from one cached mask
per stored tag. A mutation drops the masks of the tags it touches; a change
of the requested capacity drops them all. The cache is shared by every
searching thread, so each read and write of it holds the index lock.

Beside the postings the index keeps a raw-value column: per doc the interned
id of the unparsed field value, which answers FT.AGGREGATE's columnar
GROUPBY + COUNT (``value_counts``) with no keyspace fetch. It lives on the
host, as every group key is a Python string.
"""

from __future__ import annotations

import bisect
import threading
from typing import Dict, Iterable, List, Optional, Set

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


def parse_tags(raw: str, separator: str, case_sensitive: bool) -> List[str]:
    """Split a tag field value: split on the separator, trim whitespace,
    casefold unless case-sensitive, drop empties and over-long tags."""
    out = []
    max_len = int(config.get("search.max-tag-field-len"))
    for part in raw.split(separator):
        t = part.strip()
        if not t or len(t) > max_len:
            continue
        out.append(t if case_sensitive else t.casefold())
    return out


class TagIndex(IndexBase):
    kind = "TAG"
    mutation_weight = 1.0

    def __init__(
        self,
        interner: Optional[KeyInterner] = None,
        separator: str = ",",
        case_sensitive: bool = False,
        device: Optional[torch.device] = None,
    ):
        if len(separator) != 1:
            raise ValueError("tag separator must be a single character")
        self.separator = separator
        self.case_sensitive = case_sensitive
        self._owns_interner = interner is None
        self.interner = interner if interner is not None else KeyInterner()
        self.device = torch.device(device) if device is not None \
            else get_device()
        self._postings: Dict[str, Set[int]] = {}
        self._doc_tags: Dict[int, Set[str]] = {}
        self._tracked: Dict[str, int] = {}
        self._untracked: Set[str] = set()  # keys seen with no usable tag
        # raw-value column: GROUPBY groups by the raw document string, not
        # by the normalized tag set
        self._doc_val = np.full(64, -1, np.int32)
        self._vals: List[str] = []
        self._val_ids: Dict[str, int] = {}
        # untracked keys still carry a raw value the generic GROUPBY would
        # group under; they own no doc id here, so they sit in a side map
        self._untracked_raw: Dict[str, str] = {}
        self._lock = threading.RLock()
        self._mask_cache: Dict[str, torch.Tensor] = {}
        self._mask_cache_cap = 0
        self._docs_cache: Dict[str, tuple] = {}
        self._sorted_cache: Optional[List[str]] = None
        self.epoch = 0

    def memory_bytes(self) -> int:
        with self._lock:
            b = 0
            for tag, docs in self._postings.items():
                b += 64 + len(tag) + 32 * len(docs)
            for tags in self._doc_tags.values():
                b += 64 + 48 * len(tags)
            b += 72 * (len(self._tracked) + len(self._untracked))
            b += self._doc_val.nbytes
            b += sum(120 + len(v) for v in self._vals)
            b += sum(96 + len(k) + len(v)
                     for k, v in self._untracked_raw.items())
            return b

    # -- mutation ------------------------------------------------------------
    def add_record(self, key: str, value) -> RecordResult:
        # hash values arrive as bytes; tags are parsed as strict UTF-8
        if isinstance(value, (bytes, bytearray)):
            # the raw column holds what the generic GROUPBY's content fetch
            # would coerce to; tag parsing keeps strict UTF-8
            raw = bytes(value).decode(errors="surrogateescape")
            try:
                value = bytes(value).decode("utf-8")
            except UnicodeDecodeError:
                value = ""
        else:
            raw = str(value)
        tags = parse_tags(str(value), self.separator, self.case_sensitive)
        with self._lock:
            existed = key in self._tracked
            if not tags:
                if existed:
                    self._remove_locked(key)
                self._untracked.add(key)
                self._untracked_raw[key] = raw
                return RecordResult.SKIPPED
            doc = self.interner.intern(key)
            if existed:
                self._clear_doc(doc)
            self._untracked.discard(key)
            self._untracked_raw.pop(key, None)
            self._tracked[key] = doc
            self._doc_tags[doc] = set(tags)
            self._set_raw(doc, raw)
            for t in tags:
                if t not in self._postings:
                    self._postings[t] = set()
                    self._sorted_cache = None
                self._postings[t].add(doc)
                self._mask_cache.pop(t, None)
            self.epoch += 1
            return RecordResult.MODIFIED if existed else RecordResult.ADDED

    def modify_record(self, key: str, value) -> RecordResult:
        return self.add_record(key, value)

    def remove_record(self, key: str) -> RecordResult:
        with self._lock:
            self._untracked.discard(key)
            self._untracked_raw.pop(key, None)
            if key not in self._tracked:
                return RecordResult.SKIPPED
            self._remove_locked(key)
            return RecordResult.REMOVED

    def _remove_locked(self, key: str) -> None:
        doc = self._tracked.pop(key)
        self._clear_doc(doc)
        if doc < len(self._doc_val):
            self._doc_val[doc] = -1
        if self._owns_interner:
            self.interner.release(key)
        self.epoch += 1

    def _set_raw(self, doc: int, raw: str) -> None:
        """Record the raw field value of ``doc`` in the column."""
        vid = self._val_ids.get(raw)
        if vid is None:
            vid = len(self._vals)
            self._vals.append(raw)
            self._val_ids[raw] = vid
        if doc >= len(self._doc_val):
            grow = max(64, len(self._doc_val), doc + 1 - len(self._doc_val))
            self._doc_val = np.concatenate(
                [self._doc_val, np.full(grow, -1, np.int32)]
            )
        self._doc_val[doc] = vid

    def value_counts(self, docs: np.ndarray):
        """Columnar GROUPBY + COUNT: for the ascending doc-id array of a
        match set, ``[(raw_value_or_None, count)]`` in first-occurrence
        order, the groups and order the per-row pipeline would produce. Docs
        outside the column group under None. Returns None while untracked
        keys with raw values exist (their doc ids are not owned here, so
        the caller falls back to the per-row path)."""
        with self._lock:
            if self._untracked_raw:
                return None
            col = self._doc_val
            v = np.full(docs.shape, -1, np.int32)
            inb = docs < len(col)
            v[inb] = col[docs[inb]]
            vals, first, counts = np.unique(
                v, return_index=True, return_counts=True
            )
            order = np.argsort(first, kind="stable")
            out = []
            for j in order:
                vid = int(vals[j])
                out.append((
                    self._vals[vid] if vid >= 0 else None, int(counts[j])
                ))
            return out

    def _clear_doc(self, doc: int) -> None:
        for t in self._doc_tags.pop(doc, ()):
            s = self._postings.get(t)
            if s is not None:
                s.discard(doc)
                if not s:
                    del self._postings[t]
                    self._sorted_cache = None
                self._mask_cache.pop(t, None)

    # -- query side ----------------------------------------------------------
    def normalize_query_tag(self, tag: str) -> str:
        t = tag.strip()
        return t if self.case_sensitive else t.casefold()

    def _match_tags(self, pattern: str) -> List[str]:
        """Stored tags one query pattern names: a trailing ``*`` is a prefix
        walk over the sorted tags, else an exact tag. Caller holds the lock."""
        p = self.normalize_query_tag(pattern)
        if p.endswith("*") and len(p) > 1:
            prefix = p[:-1]
            tags = self._sorted_tags()
            out = []
            # walk while the prefix holds: a sentinel upper bound would sort
            # below supplementary-plane continuations
            for t in tags[bisect.bisect_left(tags, prefix):]:
                if not t.startswith(prefix):
                    break
                out.append(t)
            return out
        return [p] if p in self._postings else []

    def _sorted_tags(self) -> List[str]:
        if self._sorted_cache is None:
            self._sorted_cache = sorted(self._postings)
        return self._sorted_cache

    def posting(self, tag: str) -> Set[int]:
        with self._lock:
            return set(self._postings.get(self.normalize_query_tag(tag), ()))

    def _union(self, tags: Iterable[str]) -> Set[int]:
        acc: Set[int] = set()
        for pat in tags:
            for t in self._match_tags(pat):
                acc |= self._postings.get(t, set())
        return acc

    def search(self, tags: Iterable[str]) -> EntriesFetcher:
        """OR over tag patterns (reference Tag::Search {a|b*})."""
        with self._lock:
            acc = self._union(tags)
            return EntriesFetcher(acc, size=len(acc))

    def docs_array(self, tags: Iterable[str]) -> np.ndarray:
        """Sorted doc ids of a tag union, memoized per index epoch."""
        key = "\x00".join(sorted(tags))
        with self._lock:
            hit = self._docs_cache.get(key)
            if hit is not None and hit[0] == self.epoch:
                return hit[1]
            acc = self._union(tags)
            arr = np.fromiter(acc, np.int64, len(acc))
            arr.sort()
            if len(self._docs_cache) >= 256:
                self._docs_cache.clear()  # epoch-keyed: droppable
            self._docs_cache[key] = (self.epoch, arr)
            return arr

    def estimate(self, tags: Iterable[str]) -> int:
        """Upper bound of the qualified count (posting sizes summed)."""
        with self._lock:
            return sum(
                len(self._postings.get(t, ()))
                for pat in tags
                for t in self._match_tags(pat)
            )

    def device_mask(self, tags: Iterable[str], cap: int) -> torch.Tensor:
        """bool [cap] on the index's device: docs carrying any queried tag.

        A new tensor on every call: the cached per-tag masks are never
        handed out, so a caller may write the result in place."""
        with self._lock:
            if self._mask_cache_cap != cap:
                self._mask_cache.clear()
                self._mask_cache_cap = cap
            acc = None
            for pat in tags:
                for tn in self._match_tags(pat):
                    m = self._mask_cache.get(tn)
                    if m is None:
                        host = np.zeros(cap, bool)
                        ids = [d for d in self._postings.get(tn, ()) if d < cap]
                        if ids:
                            host[np.fromiter(ids, np.int64, len(ids))] = True
                        m = torch.from_numpy(host).to(self.device)
                        self._mask_cache[tn] = m
                    acc = m.clone() if acc is None else acc.logical_or_(m)
            if acc is None:
                acc = torch.zeros(cap, dtype=torch.bool, device=self.device)
            return acc

    def doc_matches(self, doc: int, patterns: Iterable[str]) -> bool:
        """Host-side re-check of one doc (content resolution)."""
        with self._lock:
            tags = self._doc_tags.get(doc)
            if not tags:
                return False
            for pat in patterns:
                p = self.normalize_query_tag(pat)
                if p.endswith("*") and len(p) > 1:
                    if any(t.startswith(p[:-1]) for t in tags):
                        return True
                elif p in tags:
                    return True
            return False

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

    def unique_tags(self) -> int:
        with self._lock:
            return len(self._postings)

    def all_docs(self) -> Set[int]:
        with self._lock:
            return set(self._tracked.values())

