"""Stateless text lexer: punctuation split -> case fold -> stop words -> stem.

Copied from valkey_search_tpu/text/lexer.py with its imports re-pointed;
the native tier is bound by the port's own ``native_lib``.

Reference: src/indexes/text/lexer.{h,cc} — a 256-entry punctuation bitmap
(whitespace + control chars always split; configurable punctuation set,
default ft_create_parser.h:27), backslash escapes inside words, ASCII +
UTF-8 lowercase fold, stop-word removal (default list
ft_create_parser.h:32-36), snowball English stemming gated on
min_stem_size (default 4, ft_create_parser.h:28). The lexer itself is
stateless; per-schema configuration is passed in (TextOptions).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Set, Tuple

from valkey_search_tpu_torch.text.stemmer import stem as _stem

# Reference defaults (ft_create_parser.h:27-36).
DEFAULT_PUNCTUATION = ",.<>{}[]\"':;!@#$%^&*()-+=~/\\|?"
DEFAULT_MIN_STEM_SIZE = 4
DEFAULT_STOP_WORDS = (
    "a", "is", "the", "an", "and", "are", "as", "at", "be",
    "but", "by", "for", "if", "in", "into", "it", "no", "not",
    "of", "on", "or", "such", "that", "their", "then", "there", "these",
    "they", "this", "to", "was", "will", "with",
)


def _build_split_table(punctuation: str) -> frozenset:
    chars = {chr(i) for i in range(256) if chr(i).isspace() or i < 32 or i == 127}
    chars.update(punctuation)
    return frozenset(chars)


class Lexer:
    """Tokenizer shared by ingestion and query-term normalization."""

    def __init__(
        self,
        punctuation: str = DEFAULT_PUNCTUATION,
        stop_words: Sequence[str] = DEFAULT_STOP_WORDS,
        min_stem_size: int = DEFAULT_MIN_STEM_SIZE,
    ):
        self._split = _build_split_table(punctuation)
        self._stop: Set[str] = {w.casefold() for w in stop_words}
        self.min_stem_size = max(0, int(min_stem_size))
        self._stem_cache: dict = {}
        self._punctuation = punctuation
        self._stop_words = tuple(stop_words)
        self._native = None       # lazy (native/text_core.cpp fast path)
        self._native_tried = False

    def is_stop_word(self, lowercase_word: str) -> bool:
        return lowercase_word in self._stop

    def normalize(self, word: str) -> str:
        """Case-fold one word (reference NormalizeLowerCaseInPlace + ICU
        fold for non-ASCII)."""
        return word.casefold()

    def stem(self, lowercase_word: str) -> str:
        """Stem if long enough (reference StemWordInPlace min_stem_size
        gate); returns the input when stemming doesn't apply. Memoized:
        corpora are Zipf-distributed, so the cache hit rate is high (the
        reference amortizes differently — a thread-local C stemmer)."""
        cached = self._stem_cache.get(lowercase_word)
        if cached is not None:
            return cached
        if len(lowercase_word) < self.min_stem_size:
            out = lowercase_word
        elif not lowercase_word.isascii():
            out = lowercase_word
        else:
            out = _stem(lowercase_word)
        if len(self._stem_cache) < 200_000:
            self._stem_cache[lowercase_word] = out
        return out

    def split_words(self, text: str) -> List[str]:
        """Punctuation/whitespace split with backslash escapes
        (reference Tokenize main loop, lexer.cc)."""
        words: List[str] = []
        cur: List[str] = []
        i, n = 0, len(text)
        while i < n:
            c = text[i]
            if c == "\\" and i + 1 < n:
                cur.append(text[i + 1])
                i += 2
                continue
            if c in self._split:
                if cur:
                    words.append("".join(cur))
                    cur = []
                i += 1
                continue
            cur.append(c)
            i += 1
        if cur:
            words.append("".join(cur))
        return words

    # -- native fast path (native/text_core.cpp) -----------------------------
    def _native_lexer(self):
        if self._native_tried:
            return self._native
        self._native_tried = True
        try:
            if not (self._punctuation.isascii()
                    and all(w.isascii() for w in self._stop_words)):
                return None
            from valkey_search_tpu_torch import native_lib

            self._native = native_lib.NativeLexer(
                self._punctuation, self._stop_words, self.min_stem_size
            )
        except Exception:
            self._native = None
        return self._native

    def tokenize(
        self,
        text: str,
        stemming_enabled: bool = True,
        stem_map: Optional[Dict[str, Set[str]]] = None,
    ) -> List[str]:
        """Full pipeline: split -> lowercase -> drop stop words -> stem.

        Returns the token stream in order (positions = indexes into the
        returned list). When ``stem_map`` is given, records
        stemmed_word -> {original words} for the schema stem tree
        (reference InProgressStemMap, lexer.h:44-50); the *original*
        lowercase word is what lands in the token stream — stems are a
        side index, matching text_index.h StageAttributeData.

        ASCII documents run through the native tokenizer+stemmer
        (native/text_core.cpp, the reference's all-C++ ingest pipeline);
        non-ASCII falls back to this Python pipeline with identical
        semantics.
        """
        if text.isascii():
            native = self._native_lexer()
            if native is not None:
                pairs = native.tokenize(text)
                if pairs is not None:
                    out = [w for w, _ in pairs]
                    if stemming_enabled and stem_map is not None:
                        for w, st in pairs:
                            if st and st != w:
                                stem_map.setdefault(st, set()).add(w)
                    return out
        out: List[str] = []
        for raw in self.split_words(text):
            w = self.normalize(raw)
            if not w or w in self._stop:
                continue
            out.append(w)
            if stemming_enabled and stem_map is not None:
                st = self.stem(w)
                if st != w:
                    stem_map.setdefault(st, set()).add(w)
        return out

    def query_term(self, term: str, stemming_enabled: bool = True) -> Tuple[str, str]:
        """Normalize a query term. Returns (word, stem) — stem == word when
        stemming is off or doesn't change the word."""
        w = self.normalize(term)
        if not stemming_enabled:
            return w, w
        return w, self.stem(w)
