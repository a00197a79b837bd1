"""Schema-level full-text engine + per-field TEXT index facade.

Copied from valkey_search_tpu/text/text_index.py with its imports re-pointed;
``TextEngine.device_mask`` returns a bool tensor on the schema's device.
The native tier is bound by the port's own ``native_lib``.

Reference: src/indexes/text/text_index.{h,cc} — TextIndexSchema owns a
prefix rax (+ optional suffix rax) mapping word -> Postings, a stem tree
mapping stem -> parent words, and per-key staged updates committed
atomically (StageAttributeData/CommitKeyData, text_index.h:95-100);
src/indexes/text.{h,cc} is the per-field facade carrying weight /
no-stem / suffix-trie flags. Query-side streaming iterators
(term/proximity/fuzzy, src/indexes/text/{term,proximity,fuzzy}*) resolve
matchers to key sets with positional SLOP/INORDER checks.

Every matcher resolves to a doc-id set / bool tensor, which the coarse
scans take as a pre-filter like tag and numeric masks; the dictionary
structures stay on the host (see the package docstring)."""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from valkey_search_tpu_torch.runtime import config
from valkey_search_tpu_torch.indexes.base import (
    EntriesFetcher,
    IndexBase,
    RecordResult,
)
from valkey_search_tpu_torch.text.lexer import (
    DEFAULT_MIN_STEM_SIZE,
    DEFAULT_PUNCTUATION,
    DEFAULT_STOP_WORDS,
    Lexer,
)
from valkey_search_tpu_torch.text.posting import MAX_TEXT_FIELDS, Postings
from valkey_search_tpu_torch.text.radix import RadixTree

ALL_FIELDS_MASK = (1 << MAX_TEXT_FIELDS) - 1


@dataclasses.dataclass
class TextOptions:
    """Per-schema text parameters (reference PerIndexTextParams,
    ft_create_parser.h:56-63; index_schema.proto punctuation/stop_words/
    with_offsets/min_stem_size fields)."""

    punctuation: str = DEFAULT_PUNCTUATION
    stop_words: Sequence[str] = DEFAULT_STOP_WORDS
    min_stem_size: int = DEFAULT_MIN_STEM_SIZE
    with_offsets: bool = True


@dataclasses.dataclass
class FieldInfo:
    alias: str
    bit_index: int
    weight: float = 1.0
    no_stem: bool = False
    with_suffix_trie: bool = True

    @property
    def bit(self) -> int:
        return 1 << self.bit_index


class _NativePosting:
    """Postings view over the native index for one word — same read API as
    posting.Postings; mutation happens inside native update/remove calls."""

    __slots__ = ("_nt", "_word")

    def __init__(self, nt, word: str):
        self._nt = nt
        self._word = word

    def key_count(self) -> int:
        return self._nt.key_count(self._word)

    def position_count(self) -> int:
        return self._nt.position_count(self._word)

    def is_empty(self) -> bool:
        return self.key_count() == 0

    def docs_array(self, field_mask: int = ~0):
        return self._nt.docs_union([self._word], field_mask)

    def docs(self, field_mask: int = ~0):
        return iter(self.docs_array(field_mask).tolist())

    def contains(self, doc: int, field_mask: int = ~0) -> bool:
        return self._nt.contains(self._word, doc, field_mask)

    def positions(self, doc: int, field_mask: int = ~0) -> List[int]:
        return self._nt.positions(self._word, doc, field_mask)


class TextEngine:
    """One per IndexSchema; owns the dictionary shared by all TEXT fields."""

    def __init__(self, schema, options=None):
        self.schema = schema
        if isinstance(options, dict):
            # ft_create parser hands the raw option dict (None → default).
            sw = options.get("stop_words")
            options = TextOptions(
                punctuation=options.get("punctuation") or DEFAULT_PUNCTUATION,
                stop_words=tuple(sw) if sw is not None else DEFAULT_STOP_WORDS,
                min_stem_size=options.get("min_stem_size", DEFAULT_MIN_STEM_SIZE),
                with_offsets=options.get("with_offsets", True),
            )
        self.options = options or TextOptions()
        self.lexer = Lexer(
            punctuation=self.options.punctuation,
            stop_words=self.options.stop_words,
            min_stem_size=self.options.min_stem_size,
        )
        self.fields: Dict[str, FieldInfo] = {}
        self.dictionary = RadixTree()          # word -> Postings (walks)
        # O(1) exact-lookup mirror of the dictionary: the radix tree serves
        # structure walks (prefix/fuzzy/count); per-token get/insert on the
        # ingest hot path goes through a plain dict (reference: rax lookup
        # is O(len) C — a Python char-walk is ~7us/token, the dict ~60ns)
        self._words: Dict[str, Postings] = {}
        self.suffix = RadixTree()              # reversed word -> set(words)
        self._stems: Dict[str, Dict[str, int]] = {}  # stem -> {word: refcount}
        self._doc_tokens: Dict[int, Dict[str, List[str]]] = {}  # doc -> alias -> tokens
        # per-field record counts for the FT.INFO attribute gauges
        # (reference per-attribute num_records / user_indexed_memory)
        self._field_records: Dict[str, int] = {}
        self._lock = threading.RLock()
        self.revision = 0
        # cross-query matcher cache: (kind, term, field) -> sorted doc-id
        # numpy array, valid for the revision it was built at (reference
        # analog: none — rax walks are cheap in C; here wildcard expansion
        # + posting unions are the 1-core hot path, so repeated matchers
        # must not re-walk the tree)
        self._matcher_cache: Dict[tuple, tuple] = {}
        self._matcher_cache_cap = 512
        # native C++ dictionary/postings/stems (native/text_index.cpp):
        # one C call per (doc, field) on ingest, numpy unions on query.
        # None -> pure-Python structures (identical semantics).
        self._nt = self._make_native()

    def _make_native(self):
        try:
            native = self.lexer._native_lexer()
            if native is None:
                return None
            from valkey_search_tpu_torch.native_lib import NativeTextIndex

            return NativeTextIndex(native)
        except Exception:
            return None

    def _apply_word_events(self, added, removed) -> None:
        """Mirror native word birth/death into the Python radix/suffix
        trees (which serve prefix/fuzzy/suffix walks).

        Removals MUST apply before additions: within one native call every
        '-word' death (emitted while clearing the doc's previous tokens)
        precedes every '+word' rebirth (emitted while adding the new
        tokens), so a doc update that drops a word's last posting and then
        re-adds the same word must leave it IN the dictionary. The binding
        flattens the ordered event blob into two lists, so applying added
        first silently deleted such words from the radix/suffix mirrors
        forever (every term/prefix query for them returned empty)."""
        if not added and not removed:
            return
        any_suffix = self._any_suffix_trie()
        for word in removed:
            self._words.pop(word, None)
            self.dictionary.remove(word)
            rev = word[::-1]
            bag = self.suffix.get(rev)
            if bag is not None:
                bag.discard(word)
                if not bag:
                    self.suffix.remove(rev)
        for word in added:
            p = _NativePosting(self._nt, word)
            self._words[word] = p
            self.dictionary.insert(word, p)
            if any_suffix:
                rev = word[::-1]
                bag = self.suffix.get(rev)
                if bag is None:
                    self.suffix.insert(rev, {word})
                else:
                    bag.add(word)

    # -- field registry --------------------------------------------------------
    def register_field(
        self,
        alias: str,
        weight: float = 1.0,
        no_stem: bool = False,
        with_suffix_trie: bool = True,
    ) -> FieldInfo:
        with self._lock:
            if alias in self.fields:
                return self.fields[alias]
            if len(self.fields) >= MAX_TEXT_FIELDS:
                raise ValueError(f"more than {MAX_TEXT_FIELDS} TEXT fields")
            fi = FieldInfo(
                alias=alias,
                bit_index=len(self.fields),
                weight=weight,
                no_stem=no_stem,
                with_suffix_trie=with_suffix_trie,
            )
            self.fields[alias] = fi
            self._suffix_cached = any(
                f.with_suffix_trie for f in self.fields.values()
            )
            return fi

    def _any_suffix_trie(self) -> bool:
        # cached at register time: this sits on the per-word ingest path
        return getattr(self, "_suffix_cached", False)

    def field_mask(self, alias: Optional[str]) -> int:
        if alias is None:
            mask = 0
            for f in self.fields.values():
                mask |= f.bit
            return mask or ALL_FIELDS_MASK
        fi = self.fields.get(alias)
        if fi is None:
            raise ValueError(f"@{alias} is not a TEXT attribute")
        return fi.bit

    # -- write path -------------------------------------------------------------
    def update_field(self, key: str, alias: str, text: str) -> RecordResult:
        """Re-index one field of one document (staged + committed under the
        engine lock — the atomic-commit equivalent of CommitKeyData)."""
        fi = self.fields[alias]
        doc = self.schema.interner.intern(key)
        if self._nt is not None:
            with self._lock:
                self.revision += 1
                res = self._nt.update_field(doc, fi.bit_index, fi.no_stem, text)
                if res is None:  # non-ASCII: tokenize in Python, index in C
                    pairs = []
                    for w in self.lexer.tokenize(
                        text, stemming_enabled=not fi.no_stem
                    ):
                        st = "" if fi.no_stem else self.lexer.stem(w)
                        pairs.append((w, "" if st == w else st))
                    res = self._nt.update_field_tokens(
                        doc, fi.bit_index, fi.no_stem, pairs
                    )
                code, added, removed = res
                self._apply_word_events(added, removed)
                if code != "M":
                    self._field_records[alias] = \
                        self._field_records.get(alias, 0) + 1
            return RecordResult.MODIFIED if code == "M" else RecordResult.ADDED
        stem_map: Dict[str, Set[str]] = {}
        tokens = self.lexer.tokenize(
            text, stemming_enabled=not fi.no_stem, stem_map=stem_map
        )
        with self._lock:
            self.revision += 1
            existed = alias in self._doc_tokens.get(doc, {})
            self._remove_field_locked(doc, alias)
            self._doc_tokens.setdefault(doc, {})[alias] = tokens
            for pos, word in enumerate(tokens):
                self._index_word(word, doc, pos, fi)
            for st, words in stem_map.items():
                for w in words:
                    self._stem_link(st, w, +1)
            if not existed:
                self._field_records[alias] = \
                    self._field_records.get(alias, 0) + 1
        return RecordResult.MODIFIED if existed else RecordResult.ADDED

    def remove_field(self, key: str, alias: str) -> RecordResult:
        doc = self.schema.interner.lookup(key)
        if doc is None:
            return RecordResult.SKIPPED
        if self._nt is not None:
            fi = self.fields[alias]
            with self._lock:
                self.revision += 1
                code, _added, removed = self._nt.remove_field(
                    doc, fi.bit_index, fi.no_stem)
                self._apply_word_events([], removed)
                if code == "R":
                    self._field_records[alias] = max(
                        0, self._field_records.get(alias, 0) - 1)
            return (RecordResult.REMOVED if code == "R"
                    else RecordResult.SKIPPED)
        with self._lock:
            self.revision += 1
            if alias not in self._doc_tokens.get(doc, {}):
                return RecordResult.SKIPPED
            self._remove_field_locked(doc, alias)
            if not self._doc_tokens.get(doc):
                self._doc_tokens.pop(doc, None)
            self._field_records[alias] = max(
                0, self._field_records.get(alias, 0) - 1)
            return RecordResult.REMOVED

    def _index_word(self, word: str, doc: int, pos: int, fi: FieldInfo) -> None:
        postings = self._words.get(word)
        if postings is None:
            postings = Postings()
            self._words[word] = postings
            self.dictionary.insert(word, postings)
            if self._any_suffix_trie():
                rev = word[::-1]
                bag = self.suffix.get(rev)
                if bag is None:
                    self.suffix.insert(rev, {word})
                else:
                    bag.add(word)
        postings.add(doc, pos, fi.bit)

    def _remove_field_locked(self, doc: int, alias: str) -> None:
        fi = self.fields[alias]
        old = self._doc_tokens.get(doc, {}).pop(alias, None)
        if not old:
            return
        for word in set(old):
            postings = self._words.get(word)
            if postings is None:
                continue
            postings.remove_field(doc, fi.bit)
            if postings.is_empty():
                self._drop_word(word)
        if not fi.no_stem:
            for word in set(old):
                st = self.lexer.stem(word)
                if st != word:
                    self._stem_link(st, word, -1)

    def _drop_word(self, word: str) -> None:
        self._words.pop(word, None)
        self.dictionary.remove(word)
        rev = word[::-1]
        bag = self.suffix.get(rev)
        if bag is not None:
            bag.discard(word)
            if not bag:
                self.suffix.remove(rev)

    def _stem_link(self, st: str, word: str, delta: int) -> None:
        bag = self._stems.get(st)
        if bag is None:
            if delta <= 0:
                return
            bag = {}
            self._stems[st] = bag
        n = bag.get(word, 0) + delta
        if n > 0:
            bag[word] = n
        else:
            bag.pop(word, None)
            if not bag:
                del self._stems[st]

    # -- matcher resolution ------------------------------------------------------
    def expand_words(self, pred) -> List[str]:
        """Dictionary words one matcher touches (reference term.h /
        fuzzy.h / radix WordIterator walks)."""
        match = pred.match
        # reference max-term-expansions config caps prefix/suffix/fuzzy
        # word expansion (options.cc:330, default 200)
        max_exp = int(config.get("search.max-term-expansions"))
        if match == "term":
            return self._expand_term(pred.term, pred.field)
        if self._nt is not None and match in ("prefix", "suffix", "infix",
                                              "fuzzy"):
            # native ordered-vocabulary walk (tix_expand): same
            # lexicographic order and liveness semantics as the Python
            # radix mirrors below, one C call instead of a tree walk
            if match == "suffix":
                self._check_suffix_allowed(pred)
            dist = max(1, int(getattr(pred, "distance", 1) or 1))
            return self._nt.expand(
                match, self.lexer.normalize(pred.term), dist, max_exp
            )
        if match == "prefix":
            words = []
            for w in self.dictionary.keys(self.lexer.normalize(pred.term)):
                words.append(w)
                if len(words) >= max_exp:
                    break
            return words
        if match == "suffix":
            self._check_suffix_allowed(pred)
            suf = self.lexer.normalize(pred.term)
            words = []
            if self._any_suffix_trie():
                for _, bag in self.suffix.items(suf[::-1]):
                    for w in bag:
                        if w.endswith(suf):
                            words.append(w)
                            if len(words) >= max_exp:
                                return words
                return words
            # no suffix trie anywhere: brute dictionary scan (the reference
            # requires WITHSUFFIXTRIE for tree-accelerated walks; semantics
            # stay available either way)
            for w in self.dictionary.keys():
                if w.endswith(suf):
                    words.append(w)
                    if len(words) >= max_exp:
                        break
            return words
        if match == "infix":
            sub = self.lexer.normalize(pred.term)
            words = []
            for w in self.dictionary.keys():
                if sub in w:
                    words.append(w)
                    if len(words) >= max_exp:
                        break
            return words
        if match == "fuzzy":
            target = self.lexer.normalize(pred.term)
            dist = max(1, int(pred.distance))
            out = []
            for w, _, _ in self.dictionary.fuzzy(target, dist):
                out.append(w)
                if len(out) >= max_exp:
                    break
            return out
        if match == "phrase":
            raise ValueError("phrase expands per word")
        raise ValueError(f"unknown text match kind {pred.match!r}")

    def _check_suffix_allowed(self, pred) -> None:
        """A field-scoped suffix search against a NOSUFFIXTRIE field is an
        error (docs/topics/search-query.md: "If a field specifier is added
        to a suffix term search and that particular field was declared
        with NOSUFFIXTRIE then an error will be issued")."""
        if pred.field is not None:
            fi = self.fields.get(pred.field)
            if fi is not None and not fi.with_suffix_trie:
                raise ValueError(
                    f"@{pred.field}: suffix search requires "
                    "WITHSUFFIXTRIE on the field"
                )

    def _expand_term(self, term: str, field: Optional[str]) -> List[str]:
        no_stem = bool(field) and self.fields[field].no_stem
        word, st = self.lexer.query_term(term, stemming_enabled=not no_stem)
        if self.lexer.is_stop_word(word):
            return []
        words = {word} if word in self._words else set()
        if not no_stem:
            # run ~ running ~ runs: the query stem's parent words, plus the
            # stem itself if indexed (reference stem tree, text_index.h).
            if self._nt is not None:
                words.update(self._nt.stem_parents(st))
            else:
                bag = self._stems.get(st)
                if bag:
                    words.update(bag.keys())
            if st in self._words:
                words.add(st)
            # query word may itself be a parent of the stem of indexed words
            if st != word and word in self._words:
                words.add(word)
        return sorted(words)

    def _phrase_word_groups(self, pred) -> List[List[str]]:
        """Per phrase slot, acceptable dictionary words."""
        groups: List[List[str]] = []
        for raw in pred.phrase:
            w = self.lexer.normalize(raw)
            if self.lexer.is_stop_word(w):
                continue  # stop words vanish from phrase (lexer drops them)
            groups.append(
                self._expand_term(w, pred.field)
            )
        return groups

    # -- query API (predicate.TextPredicate contract) -----------------------------
    def _effective(self, pred):
        """Punctuation-joined query terms split with the schema's lexer and
        behave as an exact phrase (Redisearch tokenizes query terms with the
        document rules: 'office#home' == "office home"); escaped punctuation
        stays in-word (r'degree\\%cold' matches the single indexed token
        'degree%cold'), mirroring ingest-side escape handling."""
        cached = getattr(pred, "_effective_cache", None)
        if cached is not None and cached[0] is self:
            return cached[1]
        eff = self._effective_uncached(pred)
        try:
            pred._effective_cache = (self, eff)
        except AttributeError:
            pass
        return eff

    def _effective_uncached(self, pred):
        import dataclasses as _dc

        if pred.match == "term":
            words = self.lexer.split_words(pred.term)
            if len(words) > 1:
                return _dc.replace(pred, match="phrase", phrase=tuple(words))
            if words and words[0] != pred.term:
                return _dc.replace(pred, term=words[0])
        elif "\\" in pred.term:
            # prefix/suffix/infix/fuzzy: strip escapes, no splitting
            clean = _unescape(pred.term)
            return _dc.replace(pred, term=clean)
        return pred

    def fetch_ids(self, pred) -> EntriesFetcher:
        return EntriesFetcher(self._doc_ids_sorted(self._effective(pred)))

    def doc_ids_array(self, pred) -> "np.ndarray":
        """Sorted-unique doc ids for a text predicate as an ndarray — the
        boolean-combinator fast path (predicate.py ids_and/ids_or)."""
        return self._doc_ids_sorted(self._effective(pred))

    def estimate(self, pred) -> int:
        pred = self._effective(pred)
        mask = self.field_mask(pred.field)
        if pred.match == "phrase":
            groups = self._phrase_word_groups(pred)
            if not groups:
                return 0
            return min(
                sum(self._postings_count(w) for w in g) for g in groups
            )
        if pred.match == "prefix":
            # O(len) planner sizing via subtree counts — word count as a
            # proxy for doc count (reference prefix-count planning).
            nwords = self.dictionary.prefix_count(self.lexer.normalize(pred.term))
            if nwords == 0:
                return 0
        total = 0
        for w in self.expand_words(pred):
            total += self._postings_count(w, mask)
        return total

    def _postings_count(self, word: str, mask: int = ALL_FIELDS_MASK) -> int:
        p = self._words.get(word)
        return p.key_count() if p is not None else 0

    def _doc_set(self, pred) -> Set[int]:
        mask = self.field_mask(pred.field)
        if pred.match == "phrase":
            return set(self._phrase_doc_ids(pred, mask).tolist())
        return set(self._doc_ids_sorted(pred).tolist())

    def _phrase_doc_ids(self, pred, mask: int) -> "np.ndarray":
        """Sorted doc ids matching a phrase predicate. Native path: ONE C
        call does per-slot unions, candidate intersection, and the
        positional walk (tix_phrase_docs) — the per-candidate Python
        position checks below were the 3.6-qps phrase bottleneck
        (BENCH r4 flat run). The Python tier stays as the differential
        oracle and the no-native fallback."""
        groups = self._phrase_word_groups(pred)
        if not groups:
            return np.empty(0, np.int64)
        slop = int(getattr(pred, "slop", 0))
        inorder = bool(getattr(pred, "inorder", True))
        if self._nt is not None:
            return self._nt.phrase_docs(groups, mask, slop, inorder)
        return np.fromiter(
            sorted(self._phrase_docs(pred, mask)), np.int64
        )

    def _doc_ids_sorted(self, pred) -> "np.ndarray":
        """Sorted unique doc-id array for one matcher — the vectorized
        union over expanded words, memoized across queries per engine
        revision (wide wildcard expansions dominate the 1-core text QPS;
        re-walking the tree per query or per result row is the round-1
        127-qps prefix bottleneck)."""
        if pred.match == "phrase":
            return self._phrase_doc_ids(pred, self.field_mask(pred.field))
        key = (pred.match, pred.term, pred.field,
               getattr(pred, "distance", 0),
               int(config.get("search.max-term-expansions")))
        with self._lock:
            hit = self._matcher_cache.get(key)
            if hit is not None and hit[0] == self.revision:
                return hit[1]
            # capture the revision BEFORE computing: a concurrent write
            # during the (unlocked) union below must invalidate this
            # entry, not get stamped onto stale results
            rev = self.revision
        mask = self.field_mask(pred.field)
        if self._nt is not None and pred.match in (
            "prefix", "suffix", "infix", "fuzzy"
        ):
            # fused native expansion + union: one C call resolves the
            # whole wide matcher (tix_docs_union_expand) — no Python tree
            # walk, no per-word ctypes crossings
            if pred.match == "suffix":
                self._check_suffix_allowed(pred)
            dist = max(1, int(getattr(pred, "distance", 1) or 1))
            ids = self._nt.docs_union_expand(
                pred.match, self.lexer.normalize(pred.term), dist,
                int(config.get("search.max-term-expansions")), mask,
            )
            with self._lock:
                if self.revision == rev:
                    if len(self._matcher_cache) >= self._matcher_cache_cap:
                        self._matcher_cache.clear()
                    self._matcher_cache[key] = (rev, ids)
            return ids
        words = self.expand_words(pred)
        if self._nt is not None:
            ids = self._nt.docs_union(words, mask)  # one C call, sorted
        else:
            arrays = []
            for w in words:
                p = self._words.get(w)
                if p is not None:
                    a = p.docs_array(mask)
                    if len(a):
                        arrays.append(a)
            if arrays:
                ids = np.unique(np.concatenate(arrays))
            else:
                ids = np.empty(0, np.int64)
        with self._lock:
            if self.revision == rev:
                if len(self._matcher_cache) >= self._matcher_cache_cap:
                    self._matcher_cache.clear()  # revision-keyed: droppable
                self._matcher_cache[key] = (rev, ids)
        return ids

    def _phrase_docs(self, pred, mask: int) -> Set[int]:
        groups = self._phrase_word_groups(pred)
        if not groups:
            return set()
        # Candidate docs: intersection over slots of the union-of-variants.
        cand: Optional[Set[int]] = None
        for g in groups:
            docs: Set[int] = set()
            for w in g:
                p = self._words.get(w)
                if p is not None:
                    docs.update(p.docs(mask))
            cand = docs if cand is None else (cand & docs)
            if not cand:
                return set()
        assert cand is not None
        slop = int(getattr(pred, "slop", 0))
        inorder = bool(getattr(pred, "inorder", True))
        if len(groups) == 1:
            return cand
        out: Set[int] = set()
        for doc in cand:
            if self._phrase_positions_ok(groups, doc, mask, slop, inorder):
                out.add(doc)
        return out

    def _phrase_positions_ok(
        self, groups: List[List[str]], doc: int, mask: int, slop: int, inorder: bool
    ) -> bool:
        """Positional SLOP/INORDER check (reference proximity.{h,cc}).

        A phrase must land inside a single field: position spaces are
        per-field, so the check runs per field bit of ``mask``."""
        bits = [1 << i for i in range(MAX_TEXT_FIELDS) if mask & (1 << i)]
        return any(
            self._phrase_positions_ok_one_field(groups, doc, bit, slop, inorder)
            for bit in bits
        )

    def _phrase_positions_ok_one_field(
        self, groups: List[List[str]], doc: int, mask: int, slop: int, inorder: bool
    ) -> bool:
        pos_lists: List[List[int]] = []
        for g in groups:
            merged: Set[int] = set()
            for w in g:
                p = self._words.get(w)
                if p is not None:
                    merged.update(p.positions(doc, mask))
            if not merged:
                return False
            pos_lists.append(sorted(merged))
        n = len(pos_lists)
        if inorder:
            # Greedy min-next per start: exact for ordered existence.
            for p0 in pos_lists[0]:
                t = p0
                ok = True
                for i in range(1, n):
                    nxt = _min_greater(pos_lists[i], t)
                    if nxt is None:
                        ok = False
                        break
                    t = nxt
                if ok and (t - p0) - (n - 1) <= slop:
                    return True
            return False
        # Unordered: sliding window of width n+slop containing one distinct
        # position per slot (greedy bipartite check over small windows).
        events = sorted(
            {p for lst in pos_lists for p in lst}
        )
        width = n + slop
        for start in events:
            window = [
                [p for p in lst if start <= p < start + width]
                for lst in pos_lists
            ]
            if all(window) and _distinct_assignment(window):
                return True
        return False

    def doc_matches(self, pred, doc: int) -> bool:
        orig = pred
        pred = self._effective(pred)
        if pred.match != "phrase":
            # Content re-verification calls this once per result row
            # (reference ProcessNeighborsForReply re-evaluates the
            # predicate per key); re-expanding a prefix/fuzzy pattern over
            # the radix tree per row turns wide prefixes into O(rows *
            # expansion) — memoize the sorted doc-id array per (engine
            # revision, predicate) and answer by binary search.
            cache = getattr(orig, "_docset_cache", None)
            if cache is None or cache[0] is not self or cache[1] != self.revision:
                cache = (self, self.revision, self._doc_ids_sorted(pred))
                try:
                    orig._docset_cache = cache
                except AttributeError:
                    pass
            ids = cache[2]
            i = int(np.searchsorted(ids, doc))
            return i < len(ids) and int(ids[i]) == doc
        mask = self.field_mask(pred.field)
        groups = self._phrase_word_groups(pred)
        if not groups:
            return False
        slop = int(getattr(pred, "slop", 0))
        inorder = bool(getattr(pred, "inorder", True))
        if self._nt is not None:
            return self._nt.phrase_check(groups, doc, mask, slop, inorder)
        for g in groups:
            if not any(
                (p := self._words.get(w)) is not None
                and p.contains(doc, mask)
                for w in g
            ):
                return False
        if len(groups) == 1:
            return True
        return self._phrase_positions_ok(groups, doc, mask, slop, inorder)

    def device_mask(self, pred, cap: int) -> torch.Tensor:
        """bool [cap] on the schema's device: the matcher's doc ids."""
        host = np.zeros(cap, bool)
        ids = self._doc_ids_sorted(self._effective(pred))
        host[ids[ids < cap]] = True
        return torch.from_numpy(host).to(self.schema.device)

    def bytes_used(self) -> int:
        """Resident bytes of the text structures (dictionary/postings/
        stems from the native index when present, else a Python-side
        estimate) + the radix trees — the text MemoryPool of the engine's
        accounting (reference text_index.h:50-55 MemoryPools)."""
        with self._lock:
            b = self.dictionary.memory_bytes() + self.suffix.memory_bytes()
            if self._nt is not None:
                return b + self._nt.bytes_used()
            for word, p in self._words.items():
                b += 80 + 2 * len(word)
                b += 72 * p.key_count() + 24 * p.position_count()
            for st, bag in self._stems.items():
                b += 80 + 2 * len(st) + 72 * len(bag)
            for _doc, fields in self._doc_tokens.items():
                b += 64 + sum(64 + 8 * len(t) for t in fields.values())
            return b

    # -- stats -------------------------------------------------------------------
    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "distinct_words": len(self._words),
                "suffix_entries": len(self.suffix),
                "stem_entries": (self._nt.stem_count() if self._nt is not None
                                 else len(self._stems)),
                "docs_with_text": (self._nt.doc_count() if self._nt is not None
                                   else len(self._doc_tokens)),
            }


def _unescape(s: str) -> str:
    out = []
    i = 0
    while i < len(s):
        if s[i] == "\\" and i + 1 < len(s):
            out.append(s[i + 1])
            i += 2
        else:
            out.append(s[i])
            i += 1
    return "".join(out)


def _min_greater(sorted_list: List[int], t: int) -> Optional[int]:
    import bisect

    i = bisect.bisect_right(sorted_list, t)
    return sorted_list[i] if i < len(sorted_list) else None


def _distinct_assignment(window: List[List[int]]) -> bool:
    """Can each slot pick a distinct position from its window list?
    Greedy on slots sorted by fewest options (windows are tiny)."""
    order = sorted(range(len(window)), key=lambda i: len(window[i]))
    used: Set[int] = set()

    def rec(k: int) -> bool:
        if k == len(order):
            return True
        for p in window[order[k]]:
            if p not in used:
                used.add(p)
                if rec(k + 1):
                    return True
                used.discard(p)
        return False

    return rec(0)


class TextFieldIndex(IndexBase):
    """Per-field TEXT facade (reference src/indexes/text.{h,cc}): carries
    weight / no-stem / suffix-trie flags, delegates to the schema
    TextEngine."""

    kind = "TEXT"
    mutation_weight = 2.0

    def __init__(
        self,
        engine: TextEngine,
        alias: str,
        no_stem: bool = False,
        with_suffix_trie: bool = True,
        weight: float = 1.0,
    ):
        self.engine = engine
        self.alias = alias
        self.info = engine.register_field(
            alias, weight=weight, no_stem=no_stem, with_suffix_trie=with_suffix_trie
        )
        self._tracked: Set[str] = set()

    def add_record(self, key: str, value) -> RecordResult:
        if value is None:
            return self.remove_record(key)
        try:
            text = value.decode() if isinstance(value, bytes) else str(value)
        except Exception:
            return RecordResult.INVALID_DATA
        r = self.engine.update_field(key, self.alias, text)
        self._tracked.add(key)
        return r

    def modify_record(self, key: str, value) -> RecordResult:
        return self.add_record(key, value)

    def remove_record(self, key: str) -> RecordResult:
        r = self.engine.remove_field(key, self.alias)
        self._tracked.discard(key)
        return r

    def tracked_keys(self) -> Set[str]:
        return set(self._tracked)

    def tracks(self, key: str) -> bool:
        return key in self._tracked

    def count(self) -> int:
        return len(self._tracked)

    def memory_bytes(self) -> int:
        """This field's share of the text engine's resident bytes,
        apportioned by per-field record counts (the engine's dictionary/
        postings are shared across TEXT fields; reference reports
        user_indexed_memory per attribute, test_info_primary.py)."""
        eng = self.engine
        with eng._lock:
            total = sum(eng._field_records.values())
            mine = eng._field_records.get(self.alias, 0)
        if total == 0 or mine == 0:
            return 0
        return max(1, int(eng.bytes_used() * mine / total))
