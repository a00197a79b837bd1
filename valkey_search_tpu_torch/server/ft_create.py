"""FT.CREATE argument parsing → IndexSchema.

Copied from valkey_search_tpu/server/ft_create.py, building the port's
IndexSchema (TAG, NUMERIC, TEXT, VECTOR FLAT and VECTOR HNSW with its M,
EF_CONSTRUCTION and EF_RUNTIME).

Reference: src/commands/ft_create_parser.cc (892 LoC) parsing the grammar in
docs/commands/ft.create.md. Index-level options LANGUAGE/SCORE/SCORE_FIELD/
MINSTEMSIZE/STOPWORDS/PUNCTUATION/WITHOFFSETS feed the text engine;
SORTABLE is accepted-and-ignored like the reference.
"""

from __future__ import annotations

from typing import List, Tuple

from valkey_search_tpu_torch.schema.index_schema import IndexSchema


class FTCreateError(ValueError):
    pass


_TAG_SEPARATORS = set(",.<>{}[]\"':;!@#$%^&*()-+=~")


class _Args:
    def __init__(self, args: List[str]):
        self.args = args
        self.i = 0

    def done(self) -> bool:
        return self.i >= len(self.args)

    def peek(self) -> str:
        return self.args[self.i] if not self.done() else ""

    def next(self, what: str = "argument") -> str:
        if self.done():
            raise FTCreateError(f"missing {what}")
        v = self.args[self.i]
        self.i += 1
        return v

    def next_int(self, what: str) -> int:
        v = self.next(what)
        try:
            return int(v)
        except ValueError:
            raise FTCreateError(f"bad {what}: {v!r}")

    def next_float(self, what: str) -> float:
        v = self.next(what)
        try:
            return float(v)
        except ValueError:
            raise FTCreateError(f"bad {what}: {v!r}")


def parse_ft_create(args: List[str]) -> Tuple[IndexSchema, bool]:
    """Returns (schema, skip_initial_scan)."""
    a = _Args(args)
    name = a.next("index name")
    on = "HASH"
    prefixes: List[str] = []
    skip_scan = False
    text_opts = {
        "language": "english",
        "min_stem_size": 4,
        "with_offsets": True,
        "stop_words": None,  # None → language default
        "punctuation": None,
        "score": 1.0,
        "score_field": None,
    }

    while not a.done():
        tok = a.peek().upper()
        if tok == "ON":
            a.next()
            on = a.next("ON type").upper()
            if on not in ("HASH", "JSON"):
                raise FTCreateError(f"ON must be HASH or JSON, got {on}")
        elif tok == "PREFIX":
            a.next()
            n = a.next_int("prefix count")
            prefixes = [a.next("prefix") for _ in range(n)]
        elif tok == "SKIPINITIALSCAN":
            a.next()
            skip_scan = True
        elif tok == "LANGUAGE":
            a.next()
            lang = a.next("language").lower()
            if lang != "english":
                raise FTCreateError("only LANGUAGE ENGLISH is supported")
            text_opts["language"] = lang
        elif tok == "SCORE":
            a.next()
            v = a.next_float("score")
            if not 0.0 <= v <= 1.0:
                raise FTCreateError("SCORE must be between 0.0 and 1.0")
            text_opts["score"] = v
        elif tok == "SCORE_FIELD":
            a.next()
            text_opts["score_field"] = a.next("score field")
        elif tok == "MINSTEMSIZE":
            a.next()
            text_opts["min_stem_size"] = a.next_int("min stem size")
        elif tok in ("WITHOFFSETS", "NOOFFSETS"):
            a.next()
            text_opts["with_offsets"] = tok == "WITHOFFSETS"
        elif tok == "NOSTOPWORDS":
            a.next()
            text_opts["stop_words"] = []
        elif tok == "STOPWORDS":
            a.next()
            n = a.next_int("stopword count")
            text_opts["stop_words"] = [a.next("stopword") for _ in range(n)]
        elif tok == "PUNCTUATION":
            a.next()
            text_opts["punctuation"] = a.next("punctuation")
        elif tok in ("FILTER", "LANGUAGE_FIELD", "PAYLOAD_FIELD"):
            # explicitly rejected, like the reference
            # (NotSupportedParamErrorMsg, ft_create_parser.cc:279,647)
            raise FTCreateError(f"{tok} is not supported")
        elif tok == "SCHEMA":
            a.next()
            break
        else:
            raise FTCreateError(f"unexpected token {a.peek()!r}")
    else:
        raise FTCreateError("missing SCHEMA clause")

    schema = IndexSchema(name, prefixes=prefixes or ("",), on=on)
    schema.text_options = dict(text_opts)

    n_fields = 0
    while not a.done():
        identifier = a.next("field identifier")
        alias = identifier
        if not a.done() and a.peek().upper() == "AS":
            a.next()
            alias = a.next("field alias")
        ftype = a.next("field type").upper()
        if ftype == "NUMERIC":
            schema.add_numeric_attribute(alias, identifier)
        elif ftype == "TAG":
            sep = ","
            cs = False
            while not a.done() and a.peek().upper() in ("SEPARATOR", "CASESENSITIVE"):
                t = a.next().upper()
                if t == "SEPARATOR":
                    sep = a.next("separator")
                    if len(sep) != 1 or sep not in _TAG_SEPARATORS:
                        raise FTCreateError(f"bad SEPARATOR {sep!r}")
                else:
                    cs = True
            schema.add_tag_attribute(alias, identifier, separator=sep,
                                     case_sensitive=cs)
        elif ftype == "TEXT":
            opts = {"no_stem": False, "with_suffix_trie": True, "weight": 1.0}
            while not a.done() and a.peek().upper() in (
                "NOSTEM", "WITHSUFFIXTRIE", "NOSUFFIXTRIE", "WEIGHT"
            ):
                t = a.next().upper()
                if t == "NOSTEM":
                    opts["no_stem"] = True
                elif t == "WITHSUFFIXTRIE":
                    opts["with_suffix_trie"] = True
                elif t == "NOSUFFIXTRIE":
                    opts["with_suffix_trie"] = False
                else:
                    w = a.next_float("weight")
                    if w != 1.0:
                        raise FTCreateError("WEIGHT must be 1.0")
            schema.add_text_attribute(alias, identifier, **opts)
        elif ftype == "VECTOR":
            algo = a.next("vector algorithm").upper()
            if algo not in ("HNSW", "FLAT"):
                raise FTCreateError(f"unknown vector algorithm {algo}")
            n_attrs = a.next_int("attribute count")
            if n_attrs % 2:
                raise FTCreateError("vector attribute count must be even")
            kv = {}
            for _ in range(n_attrs // 2):
                k = a.next("attr name").upper()
                kv[k] = a.next("attr value")
            if "DIM" not in kv:
                raise FTCreateError("vector field requires DIM")
            if kv.get("TYPE", "FLOAT32").upper() != "FLOAT32":
                raise FTCreateError("only TYPE FLOAT32 is supported")
            if "DISTANCE_METRIC" not in kv:
                raise FTCreateError("vector field requires DISTANCE_METRIC")
            metric = kv["DISTANCE_METRIC"].lower()
            if metric not in ("l2", "ip", "cosine"):
                raise FTCreateError(f"bad DISTANCE_METRIC {kv['DISTANCE_METRIC']}")
            from valkey_search_tpu_torch.runtime import config as _cfg

            # reference limit configs (ft_create_parser.cc:62-93)
            max_dim = int(_cfg.get("search.max-vector-dimensions"))
            if int(kv["DIM"]) > max_dim:
                raise FTCreateError(
                    f"DIM exceeds search.max-vector-dimensions ({max_dim})")
            # the configs ARE the limits (reference ft_create_parser.cc
            # registers the limit configs with kMaxM/kMaxEf* defaults;
            # operators can lower them, and raising past the registry max
            # is refused at CONFIG SET)
            max_m = int(_cfg.get("search.max-vector-m"))
            m = int(kv.get("M", 16))
            if not 1 <= m <= max_m:
                raise FTCreateError(f"M must be in [1, {max_m}]")
            max_efc = int(_cfg.get("search.max-vector-ef-construction"))
            efc = int(kv.get("EF_CONSTRUCTION", 200))
            if not 1 <= efc <= max_efc:
                raise FTCreateError(
                    f"EF_CONSTRUCTION must be in [1, {max_efc}]")
            max_efr = int(_cfg.get("search.max-vector-ef-runtime"))
            efr = int(kv["EF_RUNTIME"]) if "EF_RUNTIME" in kv else None
            if efr is not None and not 1 <= efr <= max_efr:
                raise FTCreateError(f"EF_RUNTIME must be in [1, {max_efr}]")
            schema.add_vector_attribute(
                alias,
                identifier,
                algorithm=algo,
                dim=int(kv["DIM"]),
                metric=metric,
                m=m,
                ef_construction=efc,
                ef_runtime=efr,
                initial_cap=int(kv.get("INITIAL_CAP", 0)),
            )
        else:
            raise FTCreateError(f"unknown field type {ftype!r}")
        if not a.done() and a.peek().upper() == "SORTABLE":
            a.next()  # accepted for compatibility, no effect (ft.create.md)
        n_fields += 1
    if n_fields == 0:
        raise FTCreateError("SCHEMA requires at least one field")
    return schema, skip_scan
