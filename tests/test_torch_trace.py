"""The port's spans of an FT.SEARCH, from the RESP handler down to the scan
launch (runtime/metrics.py ``TRACE``), on the CPU.

A ``RespServer`` over an ``Engine`` holds a FLAT index of 3,000 rows (int8
mirror, a TAG field). Searches go over real sockets; the spans they leave
in the ring are read back with ``TRACE.spans``. The fused scan serves from
131,072 rows, so these tests route the launch to it at this size
(``use_fused_scan`` answers yes), where K1's plain version runs on the CPU:
the launch then records every span an eager launch records on the card
(where an unfiltered launch of up to 128 queries replays a CUDA graph
instead, tests/test_torch_cuda.py).

- one search leaves every span of its path under one request id, each
  inside its parent and in the order the work runs; an unfiltered search
  goes through the batcher, a filtered one masks and launches alone;
- eight connections at once: no two requests share an id, each launch's
  rows are the ``batcher.queue`` spans linked to it, and the counters
  ``search_batch_launches`` and ``batched_queries`` count those launches
  and rows;
- one command in ``TRACE.every`` is traced, whole, and the others record
  nothing; ``search.trace-spans no`` records nothing;
- the ring wraps, counts what it overwrote and says when a window lost
  spans; concurrent writers lose no record;
- INFO's query latencies come from the engine's span.
"""

import sys
import threading
import time

import numpy as np
import pytest

from valkey_search_tpu_torch.ops import topk as topk_ops
from valkey_search_tpu_torch.runtime import config, metrics
from valkey_search_tpu_torch.runtime.device import set_device
from valkey_search_tpu_torch.runtime.metrics import (
    SPAN_NAMES,
    STATS,
    TRACE,
    SpanRecorder,
    clock,
)
from valkey_search_tpu_torch.server.engine import Engine
from valkey_search_tpu_torch.server.resp import RespServer
from torch_resp_pair import RawClient, parse

ROWS, DIM, K = 3000, 16, 5

# each span's parent: the span it lies inside
PARENT = {
    "resp.write": "resp.command",
    "reader.queue": "resp.command",
    "reader.return": "resp.command",
    "engine.ft_search": "resp.command",
    "query.parse": "engine.ft_search",
    "query.mask": "engine.ft_search",
    "batcher.queue": "engine.ft_search",
    "batcher.return": "engine.ft_search",
    "reply.shape": "engine.ft_search",
    "flat.search_batch": "engine.ft_search",
    "flat.prepare": "flat.search_batch",
    "topk.bias": "flat.search_batch",
    "topk.plan": "flat.search_batch",
    "topk.scan": "flat.search_batch",
    "topk.select": "flat.search_batch",
    "topk.rescore": "flat.search_batch",
    "flat.sync": "flat.search_batch",
}
# spans that run one after another: (earlier, later)
ORDER = [
    ("reader.queue", "engine.ft_search"),
    ("engine.ft_search", "reader.return"),
    ("batcher.queue", "flat.search_batch"),
    ("flat.search_batch", "batcher.return"),
    ("flat.prepare", "topk.plan"),
    ("topk.plan", "topk.bias"),
    ("topk.bias", "topk.scan"),
    ("topk.scan", "topk.select"),
    ("topk.select", "topk.rescore"),
    ("topk.rescore", "flat.sync"),
    ("query.mask", "flat.search_batch"),
]
LAUNCH_SPANS = {"flat.search_batch", "flat.prepare", "topk.bias", "topk.plan",
                "topk.scan", "topk.select", "topk.rescore", "flat.sync"}
# a CUDA graph's spans: a launch on the CPU runs eagerly
GRAPH_SPANS = {"topk.replay", "topk.capture"}


@pytest.fixture(scope="module")
def served():
    set_device("cpu")
    saved = config.get("search.corpus-dtype")
    config.set_config("search.corpus-dtype", "int8")
    rng = np.random.default_rng(17)
    vectors = rng.standard_normal((ROWS, DIM)).astype(np.float32)
    engine = Engine()
    engine.execute("FT.CREATE", "idx", "ON", "HASH", "PREFIX", "1", "doc:",
                   "SCHEMA", "v", "VECTOR", "FLAT", "6", "TYPE", "FLOAT32",
                   "DIM", str(DIM), "DISTANCE_METRIC", "L2", "cat", "TAG")
    for i, row in enumerate(vectors):
        engine.execute("HSET", f"doc:{i}", "v", row.tobytes(),
                       "cat", f"c{i % 10}")
    srv = RespServer(engine, port=0).start()
    try:
        yield srv, vectors
    finally:
        srv.close()
        config.set_config("search.corpus-dtype", saved)


@pytest.fixture()
def fused(monkeypatch):
    """Route every launch with a shared (or no) mask to the fused scan, and
    trace every command."""
    monkeypatch.setattr(topk_ops, "use_fused_scan",
                        lambda cap, mask, corpus: mask is None
                        or mask.dim() == 1)
    config.set_config("search.trace-spans", True)
    monkeypatch.setattr(TRACE, "every", 1)


def knn(vec, flt="*"):
    return ("FT.SEARCH", "idx", f"{flt}=>[KNN {K} @v $q]", "PARAMS", "2",
            "q", vec.tobytes(), "RETURN", "1", "__v_score")


def by_name(table, rid):
    """{name: [(start, end, link, arg, arg2)]} of request ``rid``."""
    out = {}
    for n in np.flatnonzero(table.rid == rid):
        out.setdefault(table.names[table.name[n]], []).append(
            (int(table.start[n]), int(table.end[n]), int(table.link[n]),
             int(table.arg[n]), int(table.arg2[n])))
    return out


def last_request(table):
    """The request id of the last ``resp.command`` in ``table``."""
    return int(table.rid[table.of("resp.command")][-1])


def spans_of(t0, commands=1):
    """The spans that ended since ``t0``, once ``commands`` commands have
    recorded theirs: a command's span ends after its reply is flushed, so
    the client can read its reply first."""
    deadline = time.monotonic() + 10
    while True:
        table = TRACE.spans(t0)
        if table.of("resp.command").sum() >= commands:
            return table
        assert time.monotonic() < deadline, "no resp.command recorded"
        time.sleep(0.001)


@pytest.mark.parametrize("flt, absent", [
    ("*", {"query.mask"} | GRAPH_SPANS),
    ("@cat:{c3}", {"batcher.queue", "batcher.return"} | GRAPH_SPANS),
], ids=["unfiltered", "filtered"])
def test_one_search_leaves_every_span_under_one_request_id(served, fused,
                                                           flt, absent):
    srv, vectors = served
    c = RawClient(srv.port)
    try:
        t0 = clock()
        reply = parse(c.cmd(*knn(vectors[13], flt)))  # row 13 is in c3
    finally:
        c.close()
    assert reply[0] == K and reply[1] in (b"doc:13", "doc:13")
    table = spans_of(t0)
    spans = by_name(table, last_request(table))
    assert set(spans) == set(SPAN_NAMES) - absent
    # one of each, but query.parse (FT.SEARCH's arguments, then the query)
    assert len(spans["query.parse"]) == 2
    assert all(len(v) == 1 for n, v in spans.items() if n != "query.parse")
    for name, rows in spans.items():
        if name == "resp.command":
            continue
        (p0, p1, *_), = spans[PARENT[name]]
        for s, e, *_ in rows:
            assert p0 <= s <= e <= p1, (name, PARENT[name])
    for first, then in ORDER:
        if first in spans and then in spans:
            assert spans[first][-1][1] <= spans[then][0][0], (first, then)
    # the launch: its id links its spans (and the batcher's), one query row
    (_, _, launch, rows, k), = spans["flat.search_batch"]
    assert launch > 0 and (rows, k) == (1, K)
    linked = LAUNCH_SPANS | ({"batcher.queue", "batcher.return"} - absent)
    for name in linked:
        assert all(r[2] == launch for r in spans[name]), name
    assert spans["topk.scan"][0][3] == 1
    if "query.mask" in spans:
        assert spans["query.mask"][0][3] == ROWS // 10  # rows admitted


def test_the_graph_spans_are_named():
    """A replayed launch records ``topk.replay``, a capturing one
    ``topk.capture`` (ops/fused_graphs.py), each under its own id."""
    names = list(SPAN_NAMES)
    assert {"topk.replay", "topk.capture"} <= set(names)
    assert len(set(names)) == len(names)
    assert metrics.SPAN["topk.replay"] != metrics.SPAN["topk.capture"]


def test_the_ring_holds_a_minute_at_a_thousand_requests_a_second(served,
                                                                 fused):
    srv, vectors = served
    c = RawClient(srv.port)
    try:
        t0 = clock()
        c.cmd(*knn(vectors[1]))
    finally:
        c.close()
    table = spans_of(t0)
    per_request = int((table.rid == last_request(table)).sum())
    assert per_request == 18
    assert TRACE.capacity >= 60 * 1000 * per_request


def test_concurrent_connections_get_their_own_ids(served, fused):
    srv, vectors = served
    n_conn, per_conn = 8, 12
    errors = []
    launched = STATS.get("search_batch_launches")
    batched = STATS.get("batched_queries")
    t0 = clock()

    def client(j):
        c = RawClient(srv.port)
        try:
            for i in range(per_conn):
                row = (j * per_conn + i) % ROWS
                reply = parse(c.cmd(*knn(vectors[row])))
                if reply[1] not in (f"doc:{row}".encode(), f"doc:{row}"):
                    errors.append((row, reply[:2]))
        except Exception as exc:  # reported below
            errors.append(repr(exc))
        finally:
            c.close()

    threads = [threading.Thread(target=client, args=(j,))
               for j in range(n_conn)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not any(t.is_alive() for t in threads)
    assert not errors
    table = spans_of(t0, n_conn * per_conn)
    commands = table.rid[table.of("resp.command")]
    assert commands.size == n_conn * per_conn
    assert np.unique(commands).size == commands.size
    for name in ("engine.ft_search", "batcher.queue", "batcher.return"):
        rids = table.rid[table.of(name)]
        assert sorted(rids) == sorted(commands), name
    queued = table.link[table.of("batcher.queue")]
    launches = table.of("flat.search_batch")
    assert table.arg[launches].sum() == commands.size
    for launch, rows in zip(table.link[launches], table.arg[launches]):
        assert (queued == launch).sum() == rows
        # the launch's spans carry the id of one of its queries
        first = table.rid[launches][table.link[launches] == launch][0]
        assert first in table.rid[table.of("batcher.queue")
                                  & (table.link == launch)]
    # the counters, at the same boundaries: rows a launch is their ratio
    assert STATS.get("search_batch_launches") - launched == launches.sum()
    assert STATS.get("batched_queries") - batched == commands.size


@pytest.mark.parametrize("every", [1, 4])
def test_one_command_in_every_n_is_traced(served, fused, monkeypatch,
                                          every):
    srv, vectors = served
    monkeypatch.setattr(TRACE, "every", every)
    n = 8
    sampler = STATS.sampler("vector_search_usec")
    count = sampler.count
    c = RawClient(srv.port)
    try:
        t0 = clock()
        for row in range(n):
            c.cmd(*knn(vectors[row]))
    finally:
        c.close()
    table = spans_of(t0, n // every)
    time.sleep(0.05)  # a command not traced would have recorded by now
    table = TRACE.spans(t0)
    rids = table.rid[table.of("resp.command")]
    assert rids.size == n // every
    # a traced request is traced whole; the others leave no span at all
    assert set(table.rid.tolist()) == set(rids.tolist())
    for rid in rids:
        assert int((table.rid == rid).sum()) == 18
    assert table.of("flat.search_batch").sum() == n // every
    # INFO's latency counts every search, traced or not
    assert sampler.count == count + n


def test_switched_off_records_nothing(served, fused):
    srv, vectors = served
    c = RawClient(srv.port)
    try:
        assert parse(c.cmd("CONFIG", "SET", "search.trace-spans", "no")) \
            in ("OK", b"OK")
        c.cmd("PING")  # its handler has recorded CONFIG SET's span by now
        before = TRACE.taken()
        c.cmd(*knn(vectors[2]))
        c.cmd(*knn(vectors[3], "@cat:{c3}"))
        c.cmd("PING")
        assert TRACE.taken() == before
    finally:
        config.set_config("search.trace-spans", True)
        c.close()


@pytest.mark.parametrize("written", [40, 64, 100, 300])
def test_the_ring_wraps_and_counts_what_it_overwrote(monkeypatch, written):
    ring = SpanRecorder(capacity=64)
    monkeypatch.setattr(metrics, "TRACE", ring)  # STATS reads this ring
    for n in range(written):
        ring.record(1, 1000 + n, 2000 + n, n)
    dropped = max(0, written - 64)
    assert ring.dropped == dropped
    assert STATS.get("trace_spans_dropped") == dropped
    assert STATS.snapshot().get("trace_spans_dropped", 0) == dropped
    table = ring.spans()
    assert list(table.rid) == list(range(dropped, written))  # oldest first
    assert table.complete == (dropped == 0)
    # the overwritten records ended at 2000 + n for n < dropped: a window
    # that starts past them, by the reordering allowed, lost none
    oldest_left = 2000 + dropped
    assert ring.spans(oldest_left).complete == (dropped == 0)
    later = oldest_left + metrics.REORDER_NS + 1
    assert ring.spans(later).complete
    assert ring.spans(later).rid.size == 0


def test_concurrent_writers_lose_no_record():
    ring = SpanRecorder(capacity=1 << 16)
    threads, per = 16, 2000
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def write(j):
            for n in range(per):
                ring.record(2, n, n + 1, j, 0, n)

        pool = [threading.Thread(target=write, args=(j,))
                for j in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in pool)
    table = ring.spans()
    assert table.complete and table.rid.size == threads * per
    pairs = set(zip(table.rid.tolist(), table.arg.tolist()))
    assert pairs == {(j, n) for j in range(threads) for n in range(per)}


@pytest.mark.parametrize("flt, sampler, field", [
    ("*=>[KNN 3 @v $q]", "vector_search_usec",
     "search_vector_latency_usec_p50"),
    ("@cat:{c1}", "nonvector_search_usec",
     "search_nonvector_latency_usec_p50"),
], ids=["vector", "nonvector"])
def test_info_latency_comes_from_the_engine_span(served, flt, sampler, field):
    srv, vectors = served
    sampler = STATS.sampler(sampler)
    count = sampler.count
    engine = srv.engine
    for row in range(3):
        engine.execute("FT.SEARCH", "idx", flt, "PARAMS", "2", "q",
                       vectors[row].tobytes(), "NOCONTENT")
    assert sampler.count == count + 3
    assert engine.info()[field] > 0
