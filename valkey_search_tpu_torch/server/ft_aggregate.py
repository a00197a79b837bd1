"""FT.AGGREGATE: staged record pipeline over search results.

Reference: src/commands/ft_aggregate*.{h,cc} (~1,530 LoC) — query → LOAD
records → sequential stages APPLY / FILTER / LIMIT / SORTBY(+MAX) /
GROUPBY+reducers (Stage, ft_aggregate_parser.h:147; reducer table
ft_aggregate_exec.cc:406-413: AVG COUNT COUNT_DISTINCT MIN MAX STDDEV SUM).
STDDEV is the n-1 sample deviation, 0 for n≤1 (ft_aggregate_exec.cc:311).
Reducers default their output name to "NAME(arg,...)"
(ft_aggregate_exec.cc:392-399).

The port's own copy of valkey_search_tpu/server/ft_aggregate.py, with its imports
pointing into valkey_search_tpu_torch.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple, Union

from valkey_search_tpu_torch.query import expr as E
from valkey_search_tpu_torch.query.search import SearchParameters, execute_search
from valkey_search_tpu_torch.runtime.metrics import STATS
from valkey_search_tpu_torch.server import ft_search as fts

Value = Union[str, bytes, int, float]
Record = Dict[str, E.Value]


class FTAggregateError(ValueError):
    pass


def _s(v: Value) -> str:
    return v.decode() if isinstance(v, bytes) else str(v)


# --------------------------------------------------------------------------
# reducers
# --------------------------------------------------------------------------


class _Reducer:
    def __init__(self, name: str, args: List[E.Expression], alias: str):
        self.name = name
        self.args = args
        self.alias = alias

    def make(self):
        return _REDUCER_IMPL[self.name]()


class _Count:
    def __init__(self):
        self.n = 0

    def add(self, vals):
        self.n += 1

    def result(self):
        return float(self.n)


class _Sum:
    def __init__(self):
        self.s = 0.0

    def add(self, vals):
        v = E.to_number(vals[0])
        if v is not None:
            self.s += v

    def result(self):
        return self.s


class _Min:
    def __init__(self):
        self.v = None

    def add(self, vals):
        v = E.to_number(vals[0])
        if v is not None and (self.v is None or v < self.v):
            self.v = v

    def result(self):
        return self.v


class _Max:
    def __init__(self):
        self.v = None

    def add(self, vals):
        v = E.to_number(vals[0])
        if v is not None and (self.v is None or v > self.v):
            self.v = v

    def result(self):
        return self.v


class _Avg:
    def __init__(self):
        self.s = 0.0
        self.n = 0

    def add(self, vals):
        v = E.to_number(vals[0])
        if v is not None:
            self.s += v
            self.n += 1

    def result(self):
        return self.s / self.n if self.n else 0.0


class _Stddev:
    def __init__(self):
        self.s = 0.0
        self.sq = 0.0
        self.n = 0

    def add(self, vals):
        v = E.to_number(vals[0])
        if v is not None:
            self.s += v
            self.sq += v * v
            self.n += 1

    def result(self):
        if self.n <= 1:
            return 0.0
        var = (self.sq - (self.s * self.s) / self.n) / (self.n - 1)
        return math.sqrt(max(var, 0.0))


class _CountDistinct:
    def __init__(self):
        self.seen = set()

    def add(self, vals):
        if vals[0] is not None:
            self.seen.add(vals[0])

    def result(self):
        return float(len(self.seen))


_REDUCER_IMPL = {
    "COUNT": _Count,
    "SUM": _Sum,
    "MIN": _Min,
    "MAX": _Max,
    "AVG": _Avg,
    "STDDEV": _Stddev,
    "COUNT_DISTINCT": _CountDistinct,
}
_REDUCER_NARGS = {
    "COUNT": (0, 0), "SUM": (1, 1), "MIN": (1, 1), "MAX": (1, 1),
    "AVG": (1, 1), "STDDEV": (1, 1), "COUNT_DISTINCT": (1, 1),
}


# --------------------------------------------------------------------------
# stages
# --------------------------------------------------------------------------


class _Stage:
    def run(self, records: List[Record], params) -> List[Record]:
        raise NotImplementedError


class _Apply(_Stage):
    def __init__(self, expr: E.Expression, field: str):
        self.expr = expr
        self.field = field

    def run(self, records, params):
        STATS.incr("agg_apply_stages")
        STATS.incr("agg_apply_records", len(records))
        for r in records:
            r[self.field] = self.expr.eval(E.StrictRecord(r), params)
        return records


class _Filter(_Stage):
    def __init__(self, expr: E.Expression):
        self.expr = expr

    def run(self, records, params):
        STATS.incr("agg_filter_stages")
        STATS.incr("agg_filter_input_records", len(records))
        out = [
            r for r in records
            if E.truthy(self.expr.eval(E.StrictRecord(r), params))
        ]
        STATS.incr("agg_filter_output_records", len(out))
        return out


class _Limit(_Stage):
    def __init__(self, offset: int, num: int):
        self.offset = offset
        self.num = num

    def run(self, records, params):
        STATS.incr("agg_limit_stages")
        STATS.incr("agg_limit_input_records", len(records))
        out = records[self.offset : self.offset + self.num]
        STATS.incr("agg_limit_output_records", len(out))
        return out


class _SortBy(_Stage):
    def __init__(self, keys: List[Tuple[E.Expression, bool]], max_n: Optional[int]):
        self.keys = keys
        self.max_n = max_n

    def run(self, records, params):
        STATS.incr("agg_sort_by_stages")
        STATS.incr("agg_sort_by_records", len(records))

        def sort_key(r):
            out = []
            for expr, desc in self.keys:
                v = expr.eval(r, params)
                n = E.to_number(v)
                if n is not None:
                    k = (0, n, "")
                elif v is None:
                    k = (2, 0.0, "")
                else:
                    k = (1, 0.0, str(v))
                out.append((k, desc))
            return out

        # stable multi-key sort honoring per-key direction: sort by keys in
        # reverse significance order
        for idx in range(len(self.keys) - 1, -1, -1):
            expr, desc = self.keys[idx]

            def one_key(r, e=expr):
                v = e.eval(r, params)
                n = E.to_number(v)
                if n is not None:
                    return (0, n, "")
                if v is None:
                    return (2, 0.0, "")
                return (1, 0.0, str(v))

            records.sort(key=one_key, reverse=desc)
        if self.max_n is not None:
            records = records[: self.max_n]
        return records


class _GroupBy(_Stage):
    def __init__(self, fields: List[str], reducers: List[_Reducer]):
        self.fields = fields
        self.reducers = reducers

    def run(self, records, params):
        STATS.incr("agg_group_by_stages")
        STATS.incr("agg_group_by_input_records", len(records))
        buckets: Dict[tuple, list] = {}
        order: List[tuple] = []
        # arg expressions evaluated once per (reducer, row) — hoist the
        # no-arg case (COUNT, the most common hot-term shape) out of the
        # row loop entirely
        red_args = [red.args for red in self.reducers]
        any_args = any(red_args)
        single = self.fields[0] if len(self.fields) == 1 else None
        for r in records:
            if single is not None:
                key = (E.to_string(r.get(single)),)
            else:
                key = tuple(E.to_string(r.get(f)) for f in self.fields)
            insts = buckets.get(key)
            if insts is None:
                insts = buckets[key] = [red.make() for red in self.reducers]
                order.append(key)
            if any_args:
                for red, inst in zip(self.reducers, insts):
                    vals = [a.eval(r, params) for a in red.args]
                    inst.add(vals)
            else:
                for inst in insts:
                    inst.add(())
        out = []
        for key in order:
            rec: Record = {}
            for f, v in zip(self.fields, key):
                if v is not None:
                    rec[f] = v
            for red, inst in zip(self.reducers, buckets[key]):
                rec[red.alias] = inst.result()
            out.append(rec)
        # one reducer-stage tick per reducer per emitted group (reference
        # GroupBy::Execute increments reducers_.size() as each group's
        # record is finalized, ft_aggregate_exec.cc:227)
        STATS.incr("agg_reducer_stages", len(out) * len(self.reducers))
        STATS.incr("agg_group_by_output_records", len(out))
        return out


# --------------------------------------------------------------------------
# command
# --------------------------------------------------------------------------


class AggregateSpec:
    """Parsed FT.AGGREGATE request (split from execution so the cluster
    fanout can run the same pipeline over merged per-shard rows — the
    reference routes FT.AGGREGATE through the identical QueryCommand
    fanout as FT.SEARCH, ft_aggregate.cc:462 / commands.cc:172)."""

    __slots__ = ("index_name", "query", "params", "load_fields",
                 "load_all", "stages", "timeout_ms", "implicit_fields",
                 "dialect")


def parse_ft_aggregate(args: List[Value]) -> AggregateSpec:
    if len(args) < 2:
        raise FTAggregateError("FT.AGGREGATE requires index and query")
    index_name = _s(args[0])
    query = _s(args[1])
    params: Dict[str, object] = {}
    load_fields: Optional[List[str]] = None  # None → LOAD nothing extra
    load_all = False
    stages: List[_Stage] = []
    timeout_ms = None
    dialect = 2
    # properties referenced anywhere in the pipeline are implicitly
    # resolved from document contents — the reference registers every
    # parsed @field (GROUPBY keys, reducer args, APPLY/FILTER/SORTBY
    # expressions) in record_indexes_by_alias_ and populates exactly those
    # (ft_aggregate.cc CreateRecordsFromNeighbors); LOAD only adds extras
    implicit: List[str] = []

    def note(names: List[str]) -> None:
        for nm in names:
            if nm not in implicit:
                implicit.append(nm)

    i = 2
    while i < len(args):
        tok = _s(args[i]).upper()
        if tok == "DIALECT":
            try:
                dialect = int(_s(args[i + 1]))
            except (ValueError, IndexError):
                dialect = -1
            if dialect < 2 or dialect > 4:
                # reference range check ft_aggregate.cc:115-117
                raise FTAggregateError(
                    "Only Dialects 2, 3 and 4 are supported")
            i += 2
        elif tok in ("VERBATIM", "INORDER"):
            params[f"__{tok.lower()}"] = True
            i += 1
        elif tok == "SLOP":
            params["__slop"] = int(_s(args[i + 1]))
            i += 2
        elif tok == "TIMEOUT":
            timeout_ms = int(_s(args[i + 1]))
            i += 2
        elif tok == "PARAMS":
            n = int(_s(args[i + 1]))
            if n % 2:
                raise FTAggregateError("PARAMS count must be even")
            vals = args[i + 2 : i + 2 + n]
            if len(vals) != n:
                raise FTAggregateError("PARAMS count mismatch")
            for j in range(0, n, 2):
                params[_s(vals[j])] = vals[j + 1]
            i += 2 + n
        elif tok == "LOAD":
            spec = _s(args[i + 1])
            if spec == "*":
                load_all = True
                i += 2
            else:
                n = int(spec)
                load_fields = [_s(a) for a in args[i + 2 : i + 2 + n]]
                if len(load_fields) != n:
                    raise FTAggregateError("LOAD count mismatch")
                i += 2 + n
        elif tok == "APPLY":
            expr = _compile(_s(args[i + 1]))
            if i + 2 >= len(args) or _s(args[i + 2]).upper() != "AS":
                raise FTAggregateError("APPLY requires AS <field>")
            note(expr.identifiers())
            stages.append(_Apply(expr, _s(args[i + 3])))
            i += 4
        elif tok == "FILTER":
            fexpr = _compile(_s(args[i + 1]))
            note(fexpr.identifiers())
            stages.append(_Filter(fexpr))
            i += 2
        elif tok == "LIMIT":
            stages.append(_Limit(int(_s(args[i + 1])), int(_s(args[i + 2]))))
            i += 3
        elif tok == "SORTBY":
            n = int(_s(args[i + 1]))
            i += 2
            keys: List[Tuple[E.Expression, bool]] = []
            consumed = 0
            while consumed < n:
                expr = _compile(_s(args[i]))
                note(expr.identifiers())
                i += 1
                consumed += 1
                desc = False
                if i < len(args) and _s(args[i]).upper() in ("ASC", "DESC"):
                    desc = _s(args[i]).upper() == "DESC"
                    i += 1
                    consumed += 1
                keys.append((expr, desc))
            # SORTBY uses a bounded sorter; MAX defaults to 10 (reference
            # ft_aggregate_parser.h:291 `size_t max_{10}`; MAX 0 = unbounded)
            max_n = 10
            if i < len(args) and _s(args[i]).upper() == "MAX":
                max_n = int(_s(args[i + 1]))
                i += 2
            stages.append(_SortBy(keys, max_n or None))
        elif tok == "GROUPBY":
            n = int(_s(args[i + 1]))
            fields = []
            for a in args[i + 2 : i + 2 + n]:
                f = _s(a)
                if not f.startswith("@"):
                    raise FTAggregateError("GROUPBY fields must start with '@'")
                fields.append(f[1:])
            note(fields)
            i += 2 + n
            reducers: List[_Reducer] = []
            while i < len(args) and _s(args[i]).upper() == "REDUCE":
                name = _s(args[i + 1]).upper()
                if name not in _REDUCER_IMPL:
                    raise FTAggregateError(f"unknown reducer {name}")
                cnt = int(_s(args[i + 2]))
                lo, hi = _REDUCER_NARGS[name]
                if not lo <= cnt <= hi:
                    raise FTAggregateError(
                        f"incorrect number of arguments ({cnt}) to reducer {name}"
                    )
                arg_texts = [_s(a) for a in args[i + 3 : i + 3 + cnt]]
                exprs = [_compile(t) for t in arg_texts]
                for ex in exprs:
                    note(ex.identifiers())
                i += 3 + cnt
                if i < len(args) and _s(args[i]).upper() == "AS":
                    alias = _s(args[i + 1])
                    i += 2
                else:
                    alias = f"{name}({','.join(arg_texts)})"
                reducers.append(_Reducer(name, exprs, alias))
            stages.append(_GroupBy(fields, reducers))
        else:
            raise FTAggregateError(f"unknown FT.AGGREGATE token {tok!r}")

    spec = AggregateSpec()
    spec.index_name = index_name
    spec.query = query
    spec.params = params
    spec.load_fields = load_fields
    spec.load_all = load_all
    spec.stages = stages
    spec.timeout_ms = timeout_ms
    spec.implicit_fields = implicit
    spec.dialect = dialect
    return spec


def validate_load_fields(schema, spec: "AggregateSpec") -> None:
    """LOAD of a VECTOR field is unsupported — error instead of replying
    with raw vector bytes (reference ft_aggregate.cc:71-74; drilled by
    integration/test_aggregate_load_text_vector.py, where it used to
    crash the server on the indexer type)."""
    for f in spec.load_fields or ():
        name = f.lstrip("@")
        if name == "__key":
            continue
        attr = schema.attributes.get(name)
        if attr is not None and getattr(attr.index, "dim", None) is not None:
            raise FTAggregateError(
                f"Loading of vector fields is not supported (field `{name}`)"
            )


def run_ft_aggregate(engine, args: List[Value]) -> list:
    # every request counts; EVERY failure path (parse, unknown index,
    # timeout/cancel, stage errors) counts one aggregate_error — otherwise
    # a timed-out FT.AGGREGATE reads as a success in INFO
    STATS.incr("aggregate_queries")
    try:
        return _run_ft_aggregate_inner(engine, args)
    except Exception:
        STATS.incr("aggregate_errors")
        raise


def _columnar_groupby_index(schema, spec: AggregateSpec):
    """(group_field, index) when the request is the columnar GROUPBY shape:
    first stage groups by ONE field whose schema attribute is an indexed
    TAG (alias == identifier, so the raw field the index ingested is the
    field the generic path would fetch), and every reducer is arg-less
    COUNT. The index's raw-value column then answers the whole GROUPBY
    with one vectorized pass — no keyspace fetch per row."""
    from valkey_search_tpu_torch.indexes.tag import TagIndex

    if spec.load_all or not spec.stages:
        return None
    if getattr(schema, "on", "HASH") != "HASH":
        # ON JSON group values pass through JSONPath extraction (arrays,
        # bracket wrapping) that the ingest-time raw column does not model
        return None
    g = spec.stages[0]
    if not isinstance(g, _GroupBy) or len(g.fields) != 1:
        return None
    if not all(r.name == "COUNT" and not r.args for r in g.reducers):
        return None
    gf = g.fields[0]
    if gf == "__key":
        return None
    attr = schema.attributes.get(gf)
    if attr is None or attr.identifier != gf:
        return None
    if not isinstance(attr.index, TagIndex):
        return None
    return gf, attr.index


def _engine_quiescent(engine, schema, resp) -> bool:
    """Same currency proof as resolve_content's epoch fast path: nothing
    mutated since the snapshot search, no pending ingestion, and no TTLs
    that could lazily expire a matched key."""
    if engine is None:
        return False
    if resp.epoch < 0 or resp.epoch != getattr(schema, "mutation_epoch", -2):
        return False
    queue = getattr(engine, "_ingestion", None)
    if queue is not None and queue.pending():
        return False
    return not engine._expiry and not engine._field_expiry


def _run_ft_aggregate_inner(engine, args: List[Value]) -> list:
    spec = parse_ft_aggregate(args)

    # ---- step 1: query ----------------------------------------------------
    schema = engine.manager.get(spec.index_name)
    validate_load_fields(schema, spec)
    columnar = _columnar_groupby_index(schema, spec)
    sp = SearchParameters(
        index_name=spec.index_name, query=spec.query, params=spec.params,
        timeout_ms=spec.timeout_ms, no_content=False,
        limit_offset=0, limit_num=10**9,
        docs_only=columnar is not None,
    )
    # one deadline covers query + content resolution + stage pipeline
    # (reference: a single cancellation token spans the whole FT.AGGREGATE,
    # checked at stage boundaries — integration/test_cancel.py aggregate
    # timeout drills)
    from valkey_search_tpu_torch.utils import cancel

    token = cancel.from_timeout_ms(spec.timeout_ms)
    resp = execute_search(schema, sp, token=token)

    # ---- index-columnar GROUPBY+COUNT (zero keyspace fetches) -------------
    if (
        columnar is not None
        and resp.knn is None
        and resp.doc_array is not None
        and _engine_quiescent(engine, schema, resp)
    ):
        gf, index = columnar
        token.check()
        counts = index.value_counts(resp.doc_array)
        if counts is not None:
            g = spec.stages[0]
            n_rows = int(resp.doc_array.size)
            STATS.incr("agg_input_records", n_rows)
            STATS.incr("agg_group_by_stages")
            STATS.incr("agg_group_by_input_records", n_rows)
            records: List[Record] = []
            for key, cnt in counts:
                rec: Record = {}
                if key is not None:
                    rec[gf] = key
                for red in g.reducers:
                    rec[red.alias] = float(cnt)
                records.append(rec)
            STATS.incr("agg_reducer_stages", len(records) * len(g.reducers))
            STATS.incr("agg_group_by_output_records", len(records))
            eparams = {k: v for k, v in spec.params.items()
                       if not k.startswith("__")}
            for st in spec.stages[1:]:
                token.check()
                records = st.run(records, eparams)
            STATS.incr("agg_output_records", len(records))
            return _shape_reply(spec, schema, records)

    # fallback: a docs_only response must grow its Neighbor rows before
    # the generic per-row pipeline can run
    if resp.doc_array is not None:
        from valkey_search_tpu_torch.query.search import materialize_neighbors

        materialize_neighbors(schema, resp)
    rows = fts.resolve_content(engine, schema, resp)
    return aggregate_rows(schema, spec, rows, resp.score_field, resp.knn,
                          token=token)


def aggregate_rows(schema, spec: AggregateSpec, rows, score_field,
                   knn, token=None) -> list:
    """Steps 2-3: LOAD records from resolved rows, run the stage pipeline,
    shape the reply. ``rows``: [(neighbor, fields-dict-or-None)] — from a
    local search or a cluster fanout merge."""
    params = spec.params
    load_fields = spec.load_fields
    load_all = spec.load_all
    stages = spec.stages
    if knn is not None:
        rows = sorted(rows, key=lambda r: r[0].distance or 0.0)

    # ---- step 2: LOAD records ---------------------------------------------
    records: List[Record] = []
    eparams = {k: v for k, v in params.items() if not k.startswith("__")}
    def fetch_field(fields, name):
        """LOAD resolution: raw field, or schema attribute alias resolved
        through the attribute data type (ON JSON loads by JSONPath —
        reference JsonAttributeDataType, attribute_data_type.h:117)."""
        if name in fields:
            return fields[name]
        attr = schema.attributes.get(name)
        if attr is not None:
            return schema.data_type.fetch(fields, attr.identifier)
        return schema.data_type.fetch(fields, name)

    # ---- columnar fast path: GROUPBY <field> + COUNT-only reducers --------
    # The hot-term shape (thousands of rows, one group field, COUNT):
    # per-row record dicts and reducer dispatch dominate the generic
    # pipeline. Count group keys directly with collections.Counter and
    # synthesize the grouped records — semantically identical to _GroupBy
    # (same fetch/None/to_string rules), ~2x the end-to-end throughput.
    if (
        not load_all
        and stages
        and isinstance(stages[0], _GroupBy)
        and len(stages[0].fields) == 1
        and all(r.name == "COUNT" and not r.args for r in stages[0].reducers)
        and stages[0].fields[0] != score_field
    ):
        g = stages[0]
        gf = g.fields[0]
        if token is not None:
            token.check()  # stage-boundary cancel checkpoint (parity
            # with the generic pipeline's pre-stage check)
        counts: Dict[Optional[str], int] = {}  # insertion-ordered
        if gf == "__key":
            for nb, _fields in rows:
                counts[nb.key] = counts.get(nb.key, 0) + 1
        else:
            for nb, fields in rows:
                fv = fetch_field(fields or {}, gf)
                key = E.to_string(_coerce(fv) if fv is not None else None)
                counts[key] = counts.get(key, 0) + 1
        STATS.incr("agg_input_records", len(rows))
        STATS.incr("agg_group_by_stages")
        STATS.incr("agg_group_by_input_records", len(rows))
        records = []
        for key, cnt in counts.items():
            rec: Record = {}
            if key is not None:
                rec[gf] = key
            for red in g.reducers:
                rec[red.alias] = float(cnt)
            records.append(rec)
        STATS.incr("agg_reducer_stages", len(records) * len(g.reducers))
        STATS.incr("agg_group_by_output_records", len(records))
        for st in stages[1:]:
            if token is not None:
                token.check()
            records = st.run(records, eparams)
        STATS.incr("agg_output_records", len(records))
        return _shape_reply(spec, schema, records)

    for nb, fields in rows:
        rec: Record = {}
        fields = fields or {}
        if load_all:
            # LOAD * returns the raw stored fields — for ON JSON that is the
            # single '$' document blob (oracle behavior); explicit LOAD
            # resolves aliases through the data type instead
            for f, v in fields.items():
                rec[f] = _coerce(v)
        elif load_fields:
            for f in load_fields:
                fname = f.lstrip("@")
                if fname == "__key":
                    rec["__key"] = nb.key
                    continue
                v = fetch_field(fields, fname)
                if v is not None:
                    rec[fname] = _coerce(v)
                elif score_field and fname == score_field:
                    rec[score_field] = nb.distance
        # pipeline-referenced properties resolve implicitly from the doc
        # (reference CreateRecordsFromNeighbors fills every registered
        # record index from attribute_contents; LOAD only adds extras).
        # Under ON JSON + LOAD *, attribute_contents is the single raw '$'
        # blob with no per-attribute extraction, so pipeline fields stay
        # unresolved and expressions over them error (oracle behavior).
        json_load_all = load_all and schema.on == "JSON"
        for fname in spec.implicit_fields:
            if fname in rec or fname == "__key":
                continue
            v = fields.get(fname) if json_load_all else fetch_field(
                fields, fname)
            if v is not None:
                rec[fname] = _coerce(v)
        if score_field is not None and nb.distance is not None:
            rec.setdefault(score_field, nb.distance)
        records.append(rec)

    # ---- step 3: stages ---------------------------------------------------
    STATS.incr("agg_input_records", len(records))
    for st in stages:
        if token is not None:
            token.check()  # stage-boundary cancel checkpoint
        records = st.run(records, eparams)
    STATS.incr("agg_output_records", len(records))

    return _shape_reply(spec, schema, records)


def _shape_reply(spec, schema, records) -> list:
    # Under DIALECT 3/4 every scalar value of an ON JSON schema is wrapped
    # in brackets ("[v]") — HASH values and arrays are never wrapped
    # (reference ReplyWithValue, ft_aggregate.cc:209-216; drilled by
    # integration/test_aggregate_array_reply.py test_dialect_3_json_wrapping)
    wrap_json = (getattr(spec, "dialect", 2) >= 3
                 and getattr(schema, "on", "HASH") == "JSON")
    reply: list = [len(records)]
    for rec in records:
        row: list = []
        for f, v in rec.items():
            # nil values are emitted as RESP nils, not dropped (expr
            # oracle: APPLY lower(0) keeps the field with a nil value)
            if v is None:
                row += [f, None]
                continue
            if isinstance(v, list):
                # array values serialize as nested RESP arrays and are
                # never bracket-wrapped (reference ReplyWithValue checks
                # IsArray before the dialect branch, ft_aggregate.cc:170)
                row += [f, [E.to_string(x) for x in v]]
                continue
            s = E.to_string(v)
            if wrap_json:
                s = f"[{s}]"
            row += [f, s]
        reply.append(row)
    return reply


def _coerce(v: Value) -> E.Value:
    if isinstance(v, bytes):
        try:
            return v.decode()
        except UnicodeDecodeError:
            return v.decode(errors="surrogateescape")
    if isinstance(v, (int, float)):
        return float(v)
    if isinstance(v, list):
        # JSON array value: kept as a list so the reply serializes it as
        # a real RESP array (reference SerializeArrayToResp,
        # ft_aggregate.cc:134-148); expressions over array fields see the
        # element list and error in arithmetic like the reference
        return [_coerce(x) for x in v]
    return str(v)


def _compile(text: str) -> E.Expression:
    try:
        return E.Expression(text)
    except E.ExprError as e:
        raise FTAggregateError(str(e))
