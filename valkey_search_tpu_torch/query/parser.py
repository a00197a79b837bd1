"""Recursive-descent parser for the FT.SEARCH filter dialect.

Copied from valkey_search_tpu/query/parser.py, building the port's predicate
nodes.

Reference: src/commands/filter_parser.{h,cc} (1054 LoC) parsing the
Redisearch dialect-2 grammar documented in docs/topics/search-query.md:

    <filter>      ::= <logical-or>
    <logical-or>  ::= <logical-and> | <logical-or> "|" <logical-and>
    <logical-and> ::= <logical-not> | <logical-and> " " <logical-not>
    <logical-not> ::= <matcher> | "-" <logical-not>
    <matcher>     ::= @f:{tags} | @f:[lo hi] | term | term* | *term |
                      "phrase" | %fuzzy% | "(" <logical-or> ")"

plus the vector clause split on "=>" with `[KNN k @field $param
[EF_RUNTIME e] [AS name]]` (reference PreParseQueryString search.cc:1069,
ParseKNN :1047) and $-parameter substitution (PostParseQueryString :1177).
Depth and term-count limits mirror search.max-query-depth /
search.max-query-terms.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

from valkey_search_tpu_torch.query import predicate as P
from valkey_search_tpu_torch.runtime import config


class QuerySyntaxError(ValueError):
    pass


# '-' breaks a term: an unescaped mid-term hyphen starts a negation
# (Redisearch dialect: 'minus-subtract' == 'minus -subtract';
# escape as '\-' to keep it in-word).
_TERM_SPECIALS = set(' \t\n\r(){}[]|":%-')


@dataclasses.dataclass
class KnnClause:
    k: int
    field: str
    param: str           # $-parameter carrying the query vector
    ef_runtime: Optional[int] = None
    score_as: Optional[str] = None
    vector: Optional[bytes] = None  # resolved from PARAMS


class FilterParser:
    def __init__(self, text: str, params: Optional[Dict[str, object]] = None):
        self.text = text
        self.pos = 0
        self.params = params or {}
        self.max_depth = int(config.get("search.max-query-depth"))
        self.max_terms = int(config.get("search.max-query-terms"))
        self.terms = 0
        max_bytes = int(config.get("search.query-string-bytes"))
        if len(text.encode("utf-8", "surrogateescape")) > max_bytes:
            raise QuerySyntaxError(
                f"query string exceeds search.query-string-bytes "
                f"({max_bytes})"
            )

    # -- scanning helpers ----------------------------------------------------
    def _peek(self) -> str:
        return self.text[self.pos] if self.pos < len(self.text) else ""

    def _next(self) -> str:
        c = self._peek()
        self.pos += 1
        return c

    def _skip_ws(self) -> None:
        while self._peek() in (" ", "\t", "\n", "\r") and self._peek():
            self.pos += 1

    def _error(self, msg: str):
        raise QuerySyntaxError(f"{msg} at position {self.pos}: {self.text!r}")

    def _subst(self, token: str) -> str:
        if token.startswith("$"):
            name = token[1:]
            if name not in self.params:
                self._error(f"unknown parameter ${name}")
            v = self.params[name]
            return v.decode() if isinstance(v, (bytes, bytearray)) else str(v)
        return token

    def _count_term(self):
        self.terms += 1
        if self.terms > self.max_terms:
            self._error("too many terms in query")

    # -- grammar -------------------------------------------------------------
    def parse(self) -> P.Predicate:
        self._skip_ws()
        if not self.text.strip():
            self._error("empty query")
        if self.text.strip() == "*":
            return P.MatchAll()
        self._check_verbatim_quotes()
        node = self._parse_or(0)
        self._skip_ws()
        if self.pos < len(self.text):
            self._error("trailing characters")
        return node

    def _check_verbatim_quotes(self) -> None:
        """Redisearch's lexer treats an unescaped ``'`` as a verbatim-quote
        delimiter: the first intra-token apostrophe opens a quote that runs
        to end-of-string (tolerated), but a second one closes it mid-token
        and the trailing characters are a syntax error (oracle: every
        two-apostrophe query in the punctuation pickle is rejected, e.g.
        ``great'wall great'wall``). Apostrophes at token edges (a real
        ``'...'`` verbatim phrase) are not affected."""
        n = len(self.text)
        seps = " \t\n()|@{}[]"
        count = 0
        for i, ch in enumerate(self.text):
            if ch != "'":
                continue
            if i > 0 and self.text[i - 1] == "\\":
                continue  # escaped
            prev_in = i > 0 and self.text[i - 1] not in seps
            next_in = i + 1 < n and self.text[i + 1] not in seps
            if prev_in and next_in:
                count += 1
                if count >= 2:
                    self._error("unbalanced verbatim quote")

    def _parse_or(self, depth: int) -> P.Predicate:
        if depth > self.max_depth:
            self._error("query too deep")
        children = [self._parse_and(depth)]
        while True:
            self._skip_ws()
            if self._peek() == "|":
                self.pos += 1
                children.append(self._parse_and(depth))
            else:
                break
        return children[0] if len(children) == 1 else P.Or(children)

    def _parse_and(self, depth: int) -> P.Predicate:
        children = []
        while True:
            self._skip_ws()
            c = self._peek()
            if not c or c in (")", "|"):
                break
            children.append(self._parse_not(depth + 1))
        if not children:
            self._error("expected a matcher")
        return children[0] if len(children) == 1 else P.And(children)

    def _parse_not(self, depth: int) -> P.Predicate:
        if depth > self.max_depth:
            self._error("query too deep")
        self._skip_ws()
        if self._peek() == "-":
            self.pos += 1
            return P.Negate(self._parse_not(depth + 1))
        return self._parse_matcher(depth)

    def _parse_matcher(self, depth: int) -> P.Predicate:
        self._skip_ws()
        c = self._peek()
        if c == "(":
            self.pos += 1
            node = self._parse_or(depth + 1)
            self._skip_ws()
            if self._next() != ")":
                self._error("expected ')'")
            return node
        if c == "@":
            return self._parse_field_matcher(depth)
        if c == '"':
            return self._parse_phrase(None)
        if c == "%":
            return self._parse_fuzzy(None)
        return self._parse_term(None)

    def _parse_field_matcher(self, depth: int) -> P.Predicate:
        self.pos += 1  # '@'
        field = self._read_ident()
        if not field:
            self._error("expected field name after '@'")
        self._skip_ws()
        if self._next() != ":":
            self._error(f"expected ':' after @{field}")
        self._skip_ws()
        c = self._peek()
        if c == "{":
            return self._parse_tag(field)
        if c == "[":
            return self._parse_numeric(field)
        if c == "(":
            # @t:(a b|c) — field-scoped text group
            self.pos += 1
            node = self._parse_or(depth + 1)
            self._skip_ws()
            if self._next() != ")":
                self._error("expected ')'")
            self._bind_field(node, field)
            return node
        if c == '"':
            return self._parse_phrase(field)
        if c == "%":
            return self._parse_fuzzy(field)
        return self._parse_term(field)

    def _bind_field(self, node: P.Predicate, field: str) -> None:
        if isinstance(node, P.TextPredicate):
            node.field = field
        elif isinstance(node, (P.And, P.Or)):
            for ch in node.children:
                self._bind_field(ch, field)
        elif isinstance(node, P.Negate):
            self._bind_field(node.child, field)
        else:
            self._error(f"only text matchers allowed inside @{field}:(...)")

    def _read_ident(self) -> str:
        start = self.pos
        while self._peek() and (self._peek().isalnum() or self._peek() in "_-."):
            self.pos += 1
        return self.text[start : self.pos]

    # -- tag -----------------------------------------------------------------
    def _parse_tag(self, field: str) -> P.Predicate:
        assert self._next() == "{"
        values: List[str] = []
        cur: List[str] = []
        esc_last = False  # True when the value's final char was escaped
        while True:
            c = self._next()
            if not c:
                self._error("unterminated '{'")
            if c == "\\":
                cur.append(self._next())
                esc_last = True
            elif c == "|":
                values.append(("".join(cur), esc_last))
                cur, esc_last = [], False
            elif c == "}":
                values.append(("".join(cur), esc_last))
                break
            else:
                cur.append(c)
                esc_last = False
        out = []
        min_prefix = int(config.get("search.tag-min-prefix-length"))
        for v, escaped_tail in values:
            v = self._subst(v.strip())
            if v:
                # prefix wildcards need a minimum stem (reference
                # tag.cc:160-167: tags of length <= min+1 incl. the '*'
                # are "too short for prefix wildcard"); an ESCAPED
                # trailing '*' is a literal character, not a wildcard
                if (not escaped_tail and v.endswith("*") and len(v) > 1
                        and len(v) - 1 < min_prefix):
                    self._error(
                        f"Tag string `{v}` is too short for prefix wildcard."
                    )
                out.append(v)
        if not out:
            self._error("empty tag set")
        self._count_term()
        return P.TagPredicate(field, out)

    # -- numeric -------------------------------------------------------------
    def _parse_numeric(self, field: str) -> P.Predicate:
        assert self._next() == "["
        body_start = self.pos
        while self._peek() and self._peek() != "]":
            self.pos += 1
        if self._next() != "]":
            self._error("unterminated '['")
        body = self.text[body_start : self.pos - 1]
        parts = body.split()
        if len(parts) != 2:
            self._error("numeric range needs exactly two bounds")
        lo, lo_open = self._parse_bound(parts[0])
        hi, hi_open = self._parse_bound(parts[1])
        self._count_term()
        return P.NumericPredicate(field, lo, hi, lo_open, hi_open)

    def _parse_bound(self, tok: str) -> Tuple[float, bool]:
        open_ = tok.startswith("(")
        if open_:
            tok = tok[1:]
        tok = self._subst(tok)
        t = tok.lower()
        if t in ("inf", "+inf", "infinity", "+infinity"):
            return math.inf, open_
        if t in ("-inf", "-infinity"):
            return -math.inf, open_
        try:
            return float(tok), open_
        except ValueError:
            self._error(f"bad numeric bound {tok!r}")

    # -- text ----------------------------------------------------------------
    def _parse_phrase(self, field: Optional[str]) -> P.Predicate:
        assert self._next() == '"'
        chars: List[str] = []
        while True:
            c = self._next()
            if not c:
                self._error("unterminated phrase quote")
            if c == "\\":
                chars.append(self._next())
            elif c == '"':
                break
            else:
                chars.append(c)
        words = "".join(chars).split()
        if not words:
            self._error("empty phrase")
        self._count_term()
        return P.TextPredicate(
            term=" ".join(words), field=field, match="phrase", phrase=tuple(words)
        )

    def _parse_fuzzy(self, field: Optional[str]) -> P.Predicate:
        lead = 0
        while self._peek() == "%":
            self.pos += 1
            lead += 1
        word, escaped = self._read_term_chars_tracked()
        trail = 0
        while self._peek() == "%":
            self.pos += 1
            trail += 1
        if lead != trail:
            self._error("mismatched '%' fuzzy markers")
        if lead > int(config.get("search.fuzzy-max-distance")):
            self._error("fuzzy distance too large")
        if not word:
            self._error("empty fuzzy term")
        # same escape/special-char treatment as bare terms (r2 review:
        # fuzzy silently dropped escape markers, so %a\\-b% tokenized
        # differently from the equivalent term and unescaped '@'/'$'
        # slipped through validation); whole-token $param still resolves
        is_param_ref = word.startswith("$") and 0 not in escaped
        for i, ch in enumerate(word):
            if i in escaped:
                continue
            if ch in "@;" or (ch == "$" and not (is_param_ref and i == 0)):
                self._error(f"unescaped special character {ch!r} in term")
        if is_param_ref:
            word = self._subst(word)
        else:
            word = "".join(
                ("\\" + c) if i in escaped else c for i, c in enumerate(word)
            )
        self._count_term()
        return P.TextPredicate(
            term=word, field=field, match="fuzzy", distance=lead
        )

    def _read_term_chars(self) -> str:
        word, _ = self._read_term_chars_tracked()
        return word

    def _read_term_chars_tracked(self):
        """Returns (word, escaped_positions) — escaped chars are literal and
        exempt from special-character validation."""
        chars: List[str] = []
        escaped = set()
        while True:
            c = self._peek()
            if not c or c in _TERM_SPECIALS:
                break
            if c == "\\":
                self.pos += 1
                escaped.add(len(chars))
                chars.append(self._next())
            else:
                chars.append(self._next())
        return "".join(chars), escaped

    def _parse_term(self, field: Optional[str]) -> P.Predicate:
        suffix = False
        if self._peek() == "*":
            self.pos += 1
            suffix = True
        word, escaped = self._read_term_chars_tracked()
        if not word:
            self._error("expected a term")
        # Redisearch dialect: '$' (parameter marker, except a whole-token
        # parameter reference) and '@' (field marker) inside a bare term are
        # syntax errors unless escaped (compatibility-oracle behavior).
        is_param_ref = word.startswith("$") and 0 not in escaped
        for i, ch in enumerate(word):
            if i in escaped:
                continue
            if ch in "@;" or (ch == "$" and not (is_param_ref and i == 0)):
                self._error(f"unescaped special character {ch!r} in term")
        prefix = word.endswith("*") and (len(word) - 1) not in escaped
        if prefix:
            word = word[:-1]
        if is_param_ref:
            word = self._subst(word)
        else:
            # keep escapes in the predicate term: the text engine tokenizes
            # query terms with the schema lexer (escape-aware), so escaped
            # punctuation stays inside the word exactly like at ingest
            word = "".join(
                ("\\" + c) if i in escaped else c for i, c in enumerate(word)
            )
        if not word:
            self._error("empty term")
        self._count_term()
        if suffix and prefix:
            match = "infix"
        elif suffix:
            match = "suffix"
        elif prefix:
            match = "prefix"
        else:
            match = "term"
        return P.TextPredicate(term=word, field=field, match=match)


def split_vector_clause(query: str) -> Tuple[str, Optional[str]]:
    """Split 'filter=>[KNN ...]' (reference PreParseQueryString search.cc:1069).

    Returns (filter_part, knn_part or None). Only the last top-level '=>' is
    significant."""
    depth = 0
    i = 0
    split_at = -1
    while i < len(query) - 1:
        c = query[i]
        if c in "([{":
            depth += 1
        elif c in ")]}":
            depth -= 1
        elif c == "=" and query[i + 1] == ">" and depth == 0:
            split_at = i
        i += 1
    if split_at < 0:
        return query, None
    return query[:split_at], query[split_at + 2 :]


def parse_knn_clause(
    clause: str, params: Dict[str, object]
) -> KnnClause:
    """Parse '[KNN k @field $param [EF_RUNTIME e] [AS name]]'
    (reference ParseKNN, search.cc:1047)."""
    s = clause.strip()
    if not (s.startswith("[") and s.endswith("]")):
        raise QuerySyntaxError(f"vector clause must be bracketed: {clause!r}")
    toks = s[1:-1].split()
    if len(toks) < 3 or toks[0].upper() != "KNN":
        raise QuerySyntaxError(f"expected [KNN k @field $param ...]: {clause!r}")
    try:
        k = int(toks[1])
    except ValueError:
        raise QuerySyntaxError(f"bad KNN k {toks[1]!r}")
    if k <= 0:
        raise QuerySyntaxError("KNN k must be positive")
    max_knn = int(config.get("search.max-vector-knn"))
    if k > max_knn:
        # reference max-vector-knn guard (ft_search_parser.cc:34)
        raise QuerySyntaxError(f"KNN k exceeds search.max-vector-knn "
                               f"({max_knn})")
    if not toks[2].startswith("@"):
        raise QuerySyntaxError("expected @field in KNN clause")
    field = toks[2][1:]
    if len(toks) < 4 or not toks[3].startswith("$"):
        raise QuerySyntaxError("expected $parameter in KNN clause")
    param = toks[3][1:]
    knn = KnnClause(k=k, field=field, param=param)
    i = 4
    while i < len(toks):
        t = toks[i].upper()
        if t == "EF_RUNTIME" and i + 1 < len(toks):
            try:
                knn.ef_runtime = int(toks[i + 1])
            except ValueError:
                raise QuerySyntaxError(f"bad EF_RUNTIME {toks[i+1]!r}")
            if knn.ef_runtime <= 0:
                raise QuerySyntaxError("EF_RUNTIME must be positive")
            i += 2
        elif t == "AS" and i + 1 < len(toks):
            knn.score_as = toks[i + 1]
            i += 2
        else:
            raise QuerySyntaxError(f"unexpected token {toks[i]!r} in KNN clause")
    if param not in params:
        raise QuerySyntaxError(f"missing PARAMS value for ${param}")
    v = params[param]
    if isinstance(v, (bytes, bytearray, memoryview)):
        knn.vector = bytes(v)
    else:
        raise QuerySyntaxError(f"parameter ${param} must be a binary fp32 blob")
    return knn


def parse_query(
    query: str, params: Optional[Dict[str, object]] = None
) -> Tuple[P.Predicate, Optional[KnnClause]]:
    """Full query: (filter predicate, optional KNN clause)."""
    params = params or {}
    try:
        filt, knn_part = split_vector_clause(query)
        filt = filt.strip()
        if knn_part is not None:
            knn = parse_knn_clause(knn_part, params)
            pred = (
                P.MatchAll()
                if (not filt or filt == "*")
                else FilterParser(filt, params).parse()
            )
            return pred, knn
        return FilterParser(filt, params).parse(), None
    except RecursionError:
        # the configured max depth (parity with the reference's 1000)
        # can exceed python's recursion headroom; surface the same
        # typed error either way
        raise QuerySyntaxError("query too deep")
