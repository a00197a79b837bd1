"""FT.SEARCH argument parsing, execution, and reply construction.

The port's own copy of valkey_search_tpu/server/ft_search.py (reference
src/commands/ft_search_parser.cc, ft_search.cc SendReply, and content
resolution: fetch document contents on reply, re-verify the predicate, drop
stale keys, park on in-flight mutations of result keys), with its imports
pointing into valkey_search_tpu_torch.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple, Union

from valkey_search_tpu_torch.query import predicate as P
from valkey_search_tpu_torch.runtime import config
from valkey_search_tpu_torch.runtime.metrics import (
    CTX,
    SPAN,
    STATS,
    TRACE,
    clock,
)
from valkey_search_tpu_torch.query.search import (
    Neighbor,
    SearchParameters,
    SearchResponse,
    execute_search,
)

Value = Union[str, bytes, int, float]


class FTSearchError(ValueError):
    pass


def _s(v: Value) -> str:
    return v.decode() if isinstance(v, bytes) else str(v)


def parse_ft_search_args(args: List[Value]) -> SearchParameters:
    if len(args) < 2:
        raise FTSearchError("FT.SEARCH requires index and query")
    sp = SearchParameters(index_name=_s(args[0]), query=_s(args[1]))
    i = 2
    while i < len(args):
        tok = _s(args[i]).upper()
        if tok == "NOCONTENT":
            sp.no_content = True
            i += 1
        elif tok == "LIMIT":
            if i + 2 >= len(args):
                raise FTSearchError("LIMIT needs offset and num")
            try:
                sp.limit_offset = int(_s(args[i + 1]))
                sp.limit_num = int(_s(args[i + 2]))
            except ValueError:
                raise FTSearchError("bad LIMIT values")
            if sp.limit_offset < 0 or sp.limit_num < 0:
                raise FTSearchError("LIMIT values must be non-negative")
            i += 3
        elif tok == "PARAMS":
            if i + 1 >= len(args):
                raise FTSearchError("PARAMS needs a count")
            try:
                n = int(_s(args[i + 1]))
            except ValueError:
                raise FTSearchError("bad PARAMS count")
            if n % 2:
                raise FTSearchError("PARAMS count must be even")
            vals = args[i + 2 : i + 2 + n]
            if len(vals) != n:
                raise FTSearchError("PARAMS count mismatch")
            for j in range(0, n, 2):
                sp.params[_s(vals[j])] = vals[j + 1]
            i += 2 + n
        elif tok == "RETURN":
            if i + 1 >= len(args):
                raise FTSearchError("RETURN needs a count")
            try:
                n = int(_s(args[i + 1]))
            except ValueError:
                raise FTSearchError("bad RETURN count")
            i += 2
            fields: List[Tuple[str, str]] = []
            taken = 0
            while taken < n:
                if i >= len(args):
                    raise FTSearchError("RETURN count mismatch")
                f = _s(args[i])
                as_name = f
                i += 1
                if i + 1 < len(args) and _s(args[i]).upper() == "AS":
                    as_name = _s(args[i + 1])
                    i += 2
                fields.append((f, as_name))
                taken += 1
            sp.return_fields = fields
            if n == 0:
                sp.no_content = True  # RETURN 0 == NOCONTENT (ft.search.md)
        elif tok == "TIMEOUT":
            if i + 1 >= len(args):
                raise FTSearchError("TIMEOUT needs a value")
            try:
                sp.timeout_ms = int(_s(args[i + 1]))
            except ValueError:
                raise FTSearchError("bad TIMEOUT")
            i += 2
        elif tok == "SORTBY":
            if i + 1 >= len(args):
                raise FTSearchError("SORTBY needs a field")
            sp.sortby = _s(args[i + 1])
            i += 2
            if i < len(args) and _s(args[i]).upper() in ("ASC", "DESC"):
                sp.sortby_desc = _s(args[i]).upper() == "DESC"
                i += 1
        elif tok == "WITHSORTKEYS":
            sp.withsortkeys = True
            i += 1
        elif tok == "DIALECT":
            if i + 1 >= len(args):
                raise FTSearchError("DIALECT needs a value")
            if _s(args[i + 1]) not in ("2", "3", "4"):
                # reference range (ft_search_parser.cc): DIALECT in [2, 4]
                raise FTSearchError(
                    "DIALECT requires a non negative integer >=2 and <= 4"
                )
            i += 2
        elif tok in ("ALLSHARDS", "SOMESHARDS", "CONSISTENT", "INCONSISTENT",
                     "VERBATIM", "INORDER"):
            # cluster-consistency + text options; INORDER/VERBATIM feed the
            # text engine; SOMESHARDS maps to partial-results policy.
            if tok == "SOMESHARDS":
                sp.params["__partial_results"] = True
            if tok == "ALLSHARDS":
                sp.params["__partial_results"] = False
            if tok == "CONSISTENT":
                # per-query slot/index fingerprint enforcement (reference
                # consistency controls, test_ft_search_partition_
                # consistency_controls.py)
                sp.params["__consistent"] = True
            if tok == "INCONSISTENT":
                sp.params["__consistent"] = False
            if tok == "VERBATIM":
                sp.params["__verbatim"] = True
            if tok == "INORDER":
                sp.params["__inorder"] = True
            i += 1
        elif tok == "SLOP":
            if i + 1 >= len(args):
                raise FTSearchError("SLOP needs a value")
            sp.params["__slop"] = int(_s(args[i + 1]))
            i += 2
        elif tok == "LOCALONLY":
            sp.local_only = True
            i += 1
        else:
            raise FTSearchError(f"unknown FT.SEARCH option {tok!r}")
    return sp


def _sort_key(value) -> Tuple:
    """Mixed-type stable sort key: numbers before strings (reference
    ApplySorting, ft_search.cc:189-250)."""
    try:
        return (0, float(value))
    except (TypeError, ValueError):
        return (1, _s(value))


def resolve_content(
    engine, schema, resp: SearchResponse, no_content: bool = False
) -> List[Tuple[Neighbor, Optional[Dict[str, Value]]]]:
    """Fetch current document contents and re-verify the predicate, dropping
    keys whose value changed since the snapshot search ran
    (reference ProcessNeighborsForReply / PerformKeyContentionCheck,
    index_schema.cc:1917). Result keys with an in-flight mutation park on
    its completion first (bounded by a shared 250ms budget) — the
    reference re-queues the query onto the mutation's waiting_queries
    list and retries on completion."""
    import time as _time

    ctx = P.EvalContext(schema)
    out = []
    queue = getattr(engine, "_ingestion", None) if engine is not None else None
    if (
        resp.epoch >= 0
        and resp.epoch == getattr(schema, "mutation_epoch", -2)
        and (queue is None or not queue.pending())
    ):
        # nothing mutated since the snapshot: every result key is provably
        # current (epoch check replaces the reference's per-key sequence
        # comparison, index_schema.cc:1917) — except passive TTL expiry,
        # which bumps no epoch until touched, so each key still gets the
        # lazy-expiry probe. NOCONTENT skips the field fetch.
        fast: List[Tuple[Neighbor, Optional[Dict[str, Value]]]] = []
        no_ttls = (engine is not None
                   and not engine._expiry and not engine._field_expiry)
        if engine is not None and not no_content and no_ttls:
            # batch content read: one lock for the whole window instead of
            # two lock round-trips per row (hgetall + expiry probe were
            # ~55% of a 10k-row aggregate's LOAD time)
            # lru/lfu access bookkeeping only matters when an eviction
            # policy can consult it; with noeviction (the default) the
            # three dict ops per row are pure overhead on wide aggregates
            track = (
                str(config.get("search.maxmemory-policy")) != "noeviction"
            )
            with engine._lock:
                ks = engine.keyspace
                touch = engine._touch
                for nb in resp.neighbors:
                    doc = ks.get(nb.key)
                    if doc:
                        if track:
                            touch(nb.key)
                        fast.append((nb, dict(doc)))
            return fast
        for nb in resp.neighbors:
            if engine is not None and engine._expire_if_due(nb.key):
                continue
            if engine is not None and not no_content:
                fields = engine.hgetall(nb.key)
                if not fields:
                    continue  # deleted/expired since snapshot
                fast.append((nb, fields))
            else:
                fast.append((nb, None))
        return fast
    park_deadline = _time.monotonic() + 0.25
    for nb in resp.neighbors:
        still_pending = False
        if queue is not None and queue.pending_for_key(schema, nb.key):
            budget = park_deadline - _time.monotonic()
            if budget > 0:
                queue.wait_for_key(schema, nb.key, budget)
                STATS.incr("queries_parked_on_mutations")
            # the queue is blocked/backed up past the park budget: the
            # index rows for this key are stale, so the index-side check
            # below would pass values the keyspace no longer holds
            still_pending = queue.pending_for_key(schema, nb.key)
        fields = engine.hgetall(nb.key) if engine is not None else None
        if fields is not None and not fields:
            continue  # key deleted since snapshot
        if (
            resp.predicate is not None
            and not isinstance(resp.predicate, P.MatchAll)
            and nb.doc >= 0
        ):
            if still_pending and fields is not None:
                # revalidate against the fetched content, not the stale
                # index (reference ProcessNeighborsForReply re-evaluates
                # the predicate on the record; unparseable new content
                # drops the key without recording a revalidation)
                r = resp.predicate.matches_content(ctx, fields, nb.doc)
                if r is None:
                    continue
                STATS.incr("predicate_revalidation")
                if not r:
                    continue
                out.append((nb, fields))
                continue
            try:
                if not resp.predicate.matches(ctx, nb.doc):
                    continue
            except ValueError:
                pass
        out.append((nb, fields))
    return out


def _trim_results(resp: SearchResponse, sp: SearchParameters) -> None:
    """Trim to LIMIT x buffer-multiplier BEFORE content resolution
    (reference SearchResult::TrimResults, search.cc:744-779: the
    multiplier leaves headroom for rows dropped by re-verification;
    resolving thousands of rows to answer LIMIT 0 10 is the
    round-1 text-QPS bottleneck). SORTBY keeps the full window —
    sort keys come from document content."""
    if resp.knn is not None or sp.sortby is not None:
        return
    mult = max(1, int(config.get("search.search-result-buffer-multiplier")))
    cap = (sp.limit_offset + sp.limit_num) * mult
    if len(resp.neighbors) > cap:
        resp.neighbors = resp.neighbors[:cap]


def _contains_text(pred) -> bool:
    if isinstance(pred, P.TextPredicate):
        return True
    if any(_contains_text(c) for c in getattr(pred, "children", [])):
        return True
    child = getattr(pred, "child", None)
    return child is not None and _contains_text(child)


def _check_not_dropped(engine, schema, sp: SearchParameters) -> None:
    """A parked query whose index was dropped errors instead of answering
    (reference ResolveContent step 2 / IsMarkedDestructing,
    content_resolution.cc:29-35; drilled by
    integration/test_fulltext_inflight_blocking.py
    test_dropindex_with_blocked_queries)."""
    if engine is None:
        return
    try:
        current = engine.manager.get(sp.index_name, getattr(engine, "db", 0))
    except Exception:
        current = None
    if current is not schema:
        raise FTSearchError(f"Index with name '{sp.index_name}' not found")


def _block_on_text_contention(engine, schema, sp, resp) -> SearchResponse:
    """Text queries park on in-flight mutations of their result keys, then
    RE-EXECUTE against the settled index (reference ResolveContent step 3 →
    PerformKeyContentionCheck, content_resolution.cc:37-48,
    index_schema.cc:1917-1941: postings have no per-key content
    revalidation, so instead of postfiltering the query moves onto the
    mutation's waiting_queries list and reruns on completion).
    text_query_blocked_cnt counts first-time parks per query;
    text_query_retry_cnt counts every park (metrics.h:153-154)."""
    import time as _time

    queue = getattr(engine, "_ingestion", None) if engine is not None else None
    if queue is None or resp.predicate is None:
        return resp
    if not _contains_text(resp.predicate):
        return resp
    timeout_ms = sp.timeout_ms or int(config.get("search.timeout-ms"))
    deadline = _time.monotonic() + timeout_ms / 1000.0
    blocked = False
    while True:
        contended = next(
            (
                nb.key
                for nb in resp.neighbors
                if queue.pending_for_key(schema, nb.key)
            ),
            None,
        )
        if contended is None:
            return resp
        if not blocked:
            STATS.incr("text_query_blocked")
            blocked = True
        STATS.incr("text_query_retry")
        # park in bounded slices so FT.DROPINDEX and the deadline are
        # noticed promptly (the reference's waiting_queries re-dispatch is
        # event-driven; slices approximate it without an engine-wide hook)
        while queue.pending_for_key(schema, contended):
            budget = deadline - _time.monotonic()
            if budget <= 0:
                # degrade: fall through to postfilter revalidation rather
                # than blocking past the query timeout
                return resp
            _check_not_dropped(engine, schema, sp)
            queue.wait_for_key(schema, contended, min(0.05, budget))
        _check_not_dropped(engine, schema, sp)
        resp = execute_search(schema, sp)
        _trim_results(resp, sp)


def run_ft_search(engine, schema, sp: SearchParameters) -> list:
    """Execute and shape the reply: [count, key, [field, value, ...], ...]."""
    from valkey_search_tpu_torch.server import externalizer

    resp = execute_search(schema, sp)
    rid = CTX.rid
    t0 = clock() if rid else 0
    _trim_results(resp, sp)
    resp = _block_on_text_contention(engine, schema, sp, resp)
    if externalizer.index_serves_return_fields(schema, sp, resp):
        # RETURN fields served straight from index state — no keyspace
        # fetch (reference MaybeAddIndexedContent, search.cc:497)
        rows = [
            (nb, externalizer.indexed_content(schema, sp, nb, resp))
            for nb in resp.neighbors
        ]
    else:
        # SORTBY must fetch content even under NOCONTENT — the sort key
        # comes from the document (reference sorts resolved rows before
        # shaping, ft_search.cc:189-250; NOCONTENT only affects the reply)
        rows = resolve_content(
            engine, schema, resp,
            no_content=sp.no_content and sp.sortby is None,
        )
        augment_json_sortby(schema, sp, rows)
    reply = shape_reply(rows, resp, sp)
    if rid:
        TRACE.record(SPAN["reply.shape"], t0, clock(), rid)
    return reply


def augment_json_sortby(schema, sp: SearchParameters, rows) -> None:
    """ON JSON + SORTBY: Redisearch projects the sort field's resolved value
    into the reply alongside '$' (oracle behavior)."""
    if schema.on != "JSON" or sp.sortby is None:
        return
    attr = schema.attributes.get(sp.sortby)
    for _nb, fields in rows:
        if fields is None or sp.sortby in fields:
            continue
        ident = attr.identifier if attr is not None else sp.sortby
        v = schema.data_type.fetch(fields, ident)
        if v is not None:
            fields[sp.sortby] = v if isinstance(v, str) else str(v)


def shape_reply(
    rows: List[Tuple[Neighbor, Optional[Dict[str, Value]]]],
    resp: SearchResponse,
    sp: SearchParameters,
    total_override: Optional[int] = None,
) -> list:
    """Sort/trim/shape pre-resolved rows (split out so the cluster fanout
    can merge per-shard rows before shaping — reference
    SearchPartitionResultsTracker drains its merge heap through the same
    reply path, fanout.cc:177)."""
    # SORTBY (applied before LIMIT; stable; ft.search.md)
    if sp.sortby is not None:
        score_name = resp.score_field

        def keyfn(row):
            nb, fields = row
            if score_name is not None and sp.sortby == score_name:
                return (0, nb.distance if nb.distance is not None else 0.0)
            v = (fields or {}).get(sp.sortby)
            if v is None:
                return (2, "")
            return _sort_key(v)

        rows.sort(key=keyfn, reverse=sp.sortby_desc)
    elif resp.knn is not None:
        rows.sort(key=lambda r: (r[0].distance if r[0].distance is not None else 0.0))

    if total_override is not None:
        total = total_override
    elif resp.knn is None:
        # rows that content resolution dropped (deleted or changed since
        # the snapshot search) leave the count too; the JAX package counts
        # them and replies a total above its keys
        total = resp.total - (len(resp.neighbors) - len(rows))
    else:
        total = len(rows)
    window = rows[sp.limit_offset : sp.limit_offset + sp.limit_num]

    # record content caps (reference max-search-result-fields-count /
    # max-search-result-record-size, response_generator.cc:40-75:
    # oversized records return truncated content rather than blowing up
    # the reply) — both content branches respect them
    max_fields = int(config.get("search.max-search-result-fields-count"))
    max_bytes = int(config.get("search.max-search-result-record-size"))

    def _vbytes(f, v):
        return len(f) + (len(v) if isinstance(v, (str, bytes)) else 8)

    reply: list = [total]
    for nb, fields in window:
        reply.append(nb.key)
        if sp.no_content:
            if sp.withsortkeys and sp.sortby is not None:
                reply.append(_sortkey_value(nb, fields, sp, resp))
            continue
        pairs: list = []
        nbytes = 0
        if sp.return_fields is not None:
            for f, as_name in sp.return_fields:
                if resp.score_field is not None and f == resp.score_field:
                    pairs += [as_name, _fmt_num(nb.distance)]
                    continue
                v = (fields or {}).get(f)
                if v is not None:
                    if len(pairs) // 2 >= max_fields:
                        break
                    nbytes += _vbytes(f, v)
                    if nbytes > max_bytes:
                        break
                    pairs += [as_name, v]
        else:
            for f, v in sorted((fields or {}).items()):
                if len(pairs) // 2 >= max_fields:
                    break
                nbytes += _vbytes(f, v)
                if nbytes > max_bytes:
                    break
                pairs += [f, v]
        if resp.score_field is not None and (
            sp.return_fields is None
            or not any(f == resp.score_field for f, _ in sp.return_fields)
        ):
            pairs += [resp.score_field, _fmt_num(nb.distance)]
        if sp.withsortkeys and sp.sortby is not None:
            reply.append(_sortkey_value(nb, fields, sp, resp))
        reply.append(pairs)
    return reply


def _sortkey_value(nb, fields, sp, resp):
    # '$'-prefixed sort key (Redisearch WITHSORTKEYS wire format; the
    # oracle shows b'$-5' for SORTBY n1)
    if resp.score_field is not None and sp.sortby == resp.score_field:
        return "$" + _fmt_num(nb.distance)
    v = (fields or {}).get(sp.sortby)
    return None if v is None else "$" + _s(v)


def _fmt_num(v: Optional[float]) -> str:
    if v is None:
        return ""
    return repr(float(v))
