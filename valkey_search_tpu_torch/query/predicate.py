"""Predicate tree: typed filter nodes with device-bitmask evaluation.

Counterpart of valkey_search_tpu/query/predicate.py (reference
src/query/predicate.h:41-377). A predicate evaluates three ways:
``estimate`` (host-side qualified-count bound for the planner),
``device_mask`` (a bool tensor [cap] over the doc-id space on the schema's
device; And/Or/Negate are elementwise &, |, ~) and ``matches`` (host-side
single-doc check during content resolution).

Tag, numeric and text nodes evaluate against the port's indexes
(``indexes/tag.py``, ``indexes/numeric.py``, ``text/text_index.py``); a
node naming an attribute of another kind raises the JAX package's errors.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch


class EvalContext:
    """Binds a predicate to a schema + doc-id-space capacity."""

    def __init__(self, schema, cap: Optional[int] = None):
        self.schema = schema
        self.cap = cap if cap is not None else schema.doc_capacity()
        self._valid_mask = None

    def attribute(self, alias: str):
        return self.schema.attribute(alias)

    def valid_mask(self) -> torch.Tensor:
        if self._valid_mask is None:
            self._valid_mask = self.schema.docs_valid_mask(self.cap)
        return self._valid_mask


def ids_set(x):
    """Normalize a host_ids result (set | sorted-unique ndarray) to a set."""
    return x if isinstance(x, set) else set(x.tolist())


def ids_and(a, b):
    """Intersect two host_ids results; ndarray∩ndarray stays vectorized
    (text posting unions are sorted unique, so assume_unique holds)."""
    if isinstance(a, np.ndarray) and isinstance(b, np.ndarray):
        return np.intersect1d(a, b, assume_unique=True)
    return ids_set(a) & ids_set(b)


def ids_or(a, b):
    if isinstance(a, np.ndarray) and isinstance(b, np.ndarray):
        return np.union1d(a, b)
    return ids_set(a) | ids_set(b)


def ids_sub(a, b):
    if isinstance(a, np.ndarray) and isinstance(b, np.ndarray):
        return np.setdiff1d(a, b, assume_unique=True)
    return ids_set(a) - ids_set(b)


class Predicate:
    kind = "base"

    def estimate(self, ctx: EvalContext) -> int:
        raise NotImplementedError

    def device_mask(self, ctx: EvalContext) -> torch.Tensor:
        raise NotImplementedError

    def host_ids(self, ctx: EvalContext):
        """Qualified doc ids — a host set OR a sorted-unique int ndarray
        (the reference's fetcher-scan path, search.cc:607 — non-vector
        queries never touch the device; device_mask exists for fusing
        predicates into vector kernels). Combinators use the ids_* helpers
        so pure-text boolean trees stay vectorized end-to-end."""
        raise NotImplementedError

    def matches(self, ctx: EvalContext, doc: int) -> bool:
        raise NotImplementedError

    def matches_content(self, ctx: EvalContext, fields, doc: int):
        """Re-evaluate against the *fetched record content* instead of the
        index — the revalidation the reference runs on reply keys that have
        an in-flight mutation, so a blocked/backed-up mutation queue can
        never leak stale matches (ProcessNeighborsForReply /
        predicate re-evaluation, src/indexes/index_base.h EvaluateFilter).

        Tri-state: True/False = evaluated against content; None = the
        content is unparseable for this predicate (the reference drops such
        keys without recording a revalidation). Predicates with no
        content-only evaluation (text matchers need positional postings)
        fall back to the index-side check."""
        return self.matches(ctx, doc)

    def to_dict(self) -> Dict:
        raise NotImplementedError

    # -- wire format (fanout serialization; reference coordinator.proto:92-147
    #    serializes the full predicate tree into SearchIndexPartition) -------
    @staticmethod
    def from_dict(d: Dict) -> "Predicate":
        k = d["kind"]
        if k == "tag":
            return TagPredicate(d["field"], d["values"])
        if k == "numeric":
            return NumericPredicate(
                d["field"], d["lo"], d["hi"], d["lo_open"], d["hi_open"]
            )
        if k == "text":
            return TextPredicate(
                d["term"], d.get("field"), d.get("match", "term"),
                d.get("distance", 0), tuple(d.get("phrase", ())),
                d.get("slop", 0), d.get("inorder", True),
            )
        if k == "and":
            return And([Predicate.from_dict(c) for c in d["children"]])
        if k == "or":
            return Or([Predicate.from_dict(c) for c in d["children"]])
        if k == "negate":
            return Negate(Predicate.from_dict(d["child"]))
        if k == "all":
            return MatchAll()
        raise ValueError(f"unknown predicate kind {k!r}")


@dataclasses.dataclass
class TagPredicate(Predicate):
    """@field:{a|b|pre*} — OR over tag patterns (predicate.h TagPredicate)."""

    field: str
    values: List[str]
    kind = "tag"

    def _index(self, ctx):
        attr = ctx.attribute(self.field)
        if attr.kind != "TAG":
            raise ValueError(f"@{self.field} is not a TAG attribute")
        return attr.index

    def estimate(self, ctx):
        return self._index(ctx).estimate(self.values)

    def device_mask(self, ctx):
        return self._index(ctx).device_mask(self.values, ctx.cap)

    def matches(self, ctx, doc):
        return self._index(ctx).doc_matches(doc, self.values)

    def matches_content(self, ctx, fields, doc):
        from valkey_search_tpu_torch.indexes.tag import parse_tags

        attr = ctx.attribute(self.field)
        raw = ctx.schema.data_type.fetch(fields, attr.identifier)
        if raw is None:
            return False  # field absent from the new content
        if isinstance(raw, (bytes, bytearray)):
            try:
                raw = bytes(raw).decode("utf-8")
            except UnicodeDecodeError:
                return None
        if not isinstance(raw, str):
            return None
        idx = self._index(ctx)
        tags = parse_tags(raw, idx.separator, idx.case_sensitive)
        if not tags:
            return False
        for pat in self.values:
            p = idx.normalize_query_tag(pat)
            if p.endswith("*") and len(p) > 1:
                if any(t.startswith(p[:-1]) for t in tags):
                    return True
            elif p in tags:
                return True
        return False

    def fetch_ids(self, ctx):
        return self._index(ctx).search(self.values)

    def host_ids(self, ctx):
        # epoch-memoized sorted-unique ndarray (tag.py docs_array)
        return self._index(ctx).docs_array(self.values)

    def to_dict(self):
        return {"kind": "tag", "field": self.field, "values": list(self.values)}


@dataclasses.dataclass
class NumericPredicate(Predicate):
    """@field:[lo hi] with per-bound openness (predicate.h NumericPredicate)."""

    field: str
    lo: float
    hi: float
    lo_open: bool = False
    hi_open: bool = False
    kind = "numeric"

    def _index(self, ctx):
        attr = ctx.attribute(self.field)
        if attr.kind != "NUMERIC":
            raise ValueError(f"@{self.field} is not a NUMERIC attribute")
        return attr.index

    def estimate(self, ctx):
        return self._index(ctx).range_count(
            self.lo, self.hi, self.lo_open, self.hi_open
        )

    def device_mask(self, ctx):
        return self._index(ctx).device_mask(
            self.lo, self.hi, ctx.cap, self.lo_open, self.hi_open
        )

    def matches(self, ctx, doc):
        idx = self._index(ctx)
        key = ctx.schema.interner.key_of(doc)
        if key is None:
            return False
        v = idx.value_of(key)
        if v is None:
            return False
        lo_ok = v > self.lo if self.lo_open else v >= self.lo
        hi_ok = v < self.hi if self.hi_open else v <= self.hi
        return lo_ok and hi_ok

    def matches_content(self, ctx, fields, doc):
        attr = ctx.attribute(self.field)
        raw = ctx.schema.data_type.fetch(fields, attr.identifier)
        if raw is None:
            return False  # field absent from the new content
        if isinstance(raw, (bytes, bytearray)):
            try:
                raw = bytes(raw).decode("utf-8")
            except UnicodeDecodeError:
                return None
        try:
            v = float(raw)
        except (TypeError, ValueError):
            return None  # unparseable numeric → invalid content
        if v != v:
            return None  # NaN never indexes
        lo_ok = v > self.lo if self.lo_open else v >= self.lo
        hi_ok = v < self.hi if self.hi_open else v <= self.hi
        return lo_ok and hi_ok

    def fetch_ids(self, ctx):
        return self._index(ctx).range_fetch(
            self.lo, self.hi, self.lo_open, self.hi_open
        )

    def host_ids(self, ctx):
        idx = self._index(ctx)
        fn = getattr(idx, "range_docs_array", None)
        if fn is not None:
            return fn(self.lo, self.hi, self.lo_open, self.hi_open)
        return set(self.fetch_ids(ctx))

    def to_dict(self):
        return {
            "kind": "numeric", "field": self.field, "lo": self.lo,
            "hi": self.hi, "lo_open": self.lo_open, "hi_open": self.hi_open,
        }


@dataclasses.dataclass
class TextPredicate(Predicate):
    """Text matchers: term / prefix / suffix / fuzzy / phrase.

    ``field=None`` searches every TEXT attribute (reference predicate.h text
    nodes + field-mask semantics). Resolution delegates to the schema-level
    text engine (indexes/text); until a TEXT attribute exists queries using
    these raise at evaluation, matching the reference's parse-time
    validation.
    """

    term: str
    field: Optional[str] = None
    match: str = "term"  # term|prefix|suffix|infix|fuzzy|phrase
    distance: int = 0    # fuzzy edit distance
    phrase: Sequence[str] = ()
    slop: int = 0        # phrase: extra gap allowance (reference proximity.h)
    inorder: bool = True  # phrase: require document order
    kind = "text"

    def _engine(self, ctx):
        eng = getattr(ctx.schema, "text_engine", None)
        if eng is None:
            raise ValueError("index has no TEXT attributes")
        return eng

    def estimate(self, ctx):
        return self._engine(ctx).estimate(self)

    def device_mask(self, ctx):
        return self._engine(ctx).device_mask(self, ctx.cap)

    def matches(self, ctx, doc):
        return self._engine(ctx).doc_matches(self, doc)

    def fetch_ids(self, ctx):
        return self._engine(ctx).fetch_ids(self)

    def host_ids(self, ctx):
        # sorted-unique ndarray straight from the memoized posting union —
        # no Python-set materialization on the text hot path (the round-1
        # per-query set() over 10k+ ids was a top-3 cost)
        return self._engine(ctx).doc_ids_array(self)

    def to_dict(self):
        return {
            "kind": "text", "term": self.term, "field": self.field,
            "match": self.match, "distance": self.distance,
            "phrase": list(self.phrase), "slop": self.slop,
            "inorder": self.inorder,
        }


@dataclasses.dataclass
class And(Predicate):
    children: List[Predicate]
    kind = "and"

    def estimate(self, ctx):
        return min(c.estimate(ctx) for c in self.children)

    def device_mask(self, ctx):
        m = self.children[0].device_mask(ctx)
        for c in self.children[1:]:
            m = m & c.device_mask(ctx)
        return m

    # when the next conjunct's posting is much larger than the running
    # result, probing each surviving doc (hash lookups) beats materializing
    # the big set and intersecting (reference iterator-style conjunction:
    # the smallest fetcher drives and the rest answer ContainsKey)
    _PROBE_FACTOR = 4

    # probing each survivor beats materializing the next conjunct when the
    # running result is tiny AND the conjunct's id array would have to be
    # built from scratch (numeric range slices, nested trees). Memoized
    # array producers (text posting unions, epoch-cached tag unions) are
    # ~free to fetch, so intersect1d wins there at any size ratio.
    _PROBE_MIN = 64

    def host_ids(self, ctx):
        kids = sorted(self.children, key=lambda c: c.estimate(ctx))
        out = kids[0].host_ids(ctx)
        for c in kids[1:]:
            if len(out) == 0:
                break
            memoized = c.kind in ("text", "tag")
            if isinstance(out, np.ndarray) and (
                memoized or len(out) >= self._PROBE_MIN
                or c.estimate(ctx) <= self._PROBE_FACTOR * len(out)
            ):
                out = ids_and(out, c.host_ids(ctx))
            elif c.estimate(ctx) > self._PROBE_FACTOR * len(out):
                if isinstance(out, np.ndarray):
                    keep = [d for d in out.tolist() if c.matches(ctx, d)]
                    out = np.asarray(keep, np.int64)
                else:
                    out = {d for d in out if c.matches(ctx, d)}
            else:
                out = ids_and(out, c.host_ids(ctx))
        return out

    def matches(self, ctx, doc):
        return all(c.matches(ctx, doc) for c in self.children)

    def matches_content(self, ctx, fields, doc):
        out = True
        for c in self.children:
            r = c.matches_content(ctx, fields, doc)
            if r is False:
                return False
            if r is None:
                out = None  # invalid dominates unless a conjunct is False
        return out

    def to_dict(self):
        return {"kind": "and", "children": [c.to_dict() for c in self.children]}


@dataclasses.dataclass
class Or(Predicate):
    children: List[Predicate]
    kind = "or"

    def estimate(self, ctx):
        return sum(c.estimate(ctx) for c in self.children)

    def device_mask(self, ctx):
        m = self.children[0].device_mask(ctx)
        for c in self.children[1:]:
            m = m | c.device_mask(ctx)
        return m

    def host_ids(self, ctx):
        got = [c.host_ids(ctx) for c in self.children]
        if not got:
            return set()
        if all(isinstance(g, np.ndarray) for g in got):
            # one concatenate+unique beats pairwise union1d (which
            # re-sorts the accumulated result per child)
            return np.unique(np.concatenate(got)) if len(got) > 1 else got[0]
        out = got[0]
        for g in got[1:]:
            out = ids_or(out, g)
        return out

    def matches(self, ctx, doc):
        return any(c.matches(ctx, doc) for c in self.children)

    def matches_content(self, ctx, fields, doc):
        out = False
        for c in self.children:
            r = c.matches_content(ctx, fields, doc)
            if r is True:
                return True
            if r is None:
                out = None  # invalid dominates unless a disjunct is True
        return out

    def to_dict(self):
        return {"kind": "or", "children": [c.to_dict() for c in self.children]}


@dataclasses.dataclass
class Negate(Predicate):
    """-pred: all *indexed* docs not matching, including docs lacking the
    field (reference negate-via-untracked-keys; a zero bit in the child mask
    already covers field-absent docs)."""

    child: Predicate
    kind = "negate"

    def estimate(self, ctx):
        return max(0, ctx.schema.num_docs() - self.child.estimate(ctx))

    def device_mask(self, ctx):
        return ctx.valid_mask() & ~self.child.device_mask(ctx)

    def host_ids(self, ctx):
        return ids_sub(MatchAll().host_ids(ctx), self.child.host_ids(ctx))

    def matches(self, ctx, doc):
        return not self.child.matches(ctx, doc)

    def matches_content(self, ctx, fields, doc):
        r = self.child.matches_content(ctx, fields, doc)
        return None if r is None else (not r)

    def to_dict(self):
        return {"kind": "negate", "child": self.child.to_dict()}


@dataclasses.dataclass
class MatchAll(Predicate):
    """'*' — the universal set (reference UniversalSetFetcher)."""

    kind = "all"

    def estimate(self, ctx):
        return ctx.schema.num_docs()

    def device_mask(self, ctx):
        return ctx.valid_mask()

    def host_ids(self, ctx):
        # epoch-memoized sorted ndarray so negation (`-@f:...` = ALL minus
        # child) stays on the vectorized setdiff path
        return ctx.schema.interner.ids_array()

    def matches(self, ctx, doc):
        return ctx.schema.interner.key_of(doc) is not None

    def to_dict(self):
        return {"kind": "all"}


def query_operations(pred: Predicate) -> Dict[str, int]:
    """Count node kinds (reference QueryOperations bitmask from the parser)."""
    out: Dict[str, int] = {}

    def walk(p: Predicate):
        out[p.kind] = out.get(p.kind, 0) + 1
        for c in getattr(p, "children", []):
            walk(c)
        child = getattr(p, "child", None)
        if child is not None:
            walk(child)

    walk(pred)
    return out
