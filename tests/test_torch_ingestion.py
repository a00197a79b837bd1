"""Asynchronous ingestion, the cron and the query batcher's repairs.

Each scenario below is one function that drives a package (its Engine,
IngestionEngine, config registry, pause points and counters) and returns
what it observed; it is run on the JAX package and on the port and the two
observations must be equal, and equal to the stated expectation. The flows
are those of ``test_ingestion.py`` (combining, priorities and the
high-priority weight, suspend/resume, backfill by cron batches, a delete
during backfill, read after ``drain()``, a query parked on an in-flight
mutation) and ``test_text_inflight_blocking.py`` (text queries that block
and re-run, FT.DROPINDEX under a blocked query).

The repairs are the port's alone. The batcher: a dispatcher that dies gives
its count back, and a cancelled waiter does not fail its batch. The queue:
one queue however many clients arrive together, a key that is mid-apply is
not handed to a second writer, and the pending check is a lookup.
"""

import threading
import time
import types
from concurrent.futures import Future

import numpy as np
import pytest

import valkey_search_tpu.runtime.config as jconfig
import valkey_search_tpu.runtime.debug as jdebug
import valkey_search_tpu.runtime.metrics as jmetrics
import valkey_search_tpu.schema.index_schema as jschema
import valkey_search_tpu.schema.ingestion as jingest
import valkey_search_tpu.server.engine as jengine
import valkey_search_tpu_torch.query.batcher as tbatcher
import valkey_search_tpu_torch.runtime.config as tconfig
import valkey_search_tpu_torch.runtime.debug as tdebug
import valkey_search_tpu_torch.runtime.metrics as tmetrics
import valkey_search_tpu_torch.schema.index_schema as tschema
import valkey_search_tpu_torch.schema.ingestion as tingest
import valkey_search_tpu_torch.server.engine as tengine
from valkey_search_tpu_torch.runtime.device import set_device


def _package(engine, ingest, schema, config, debug, metrics):
    return types.SimpleNamespace(
        Engine=engine.Engine, IngestionEngine=ingest.IngestionEngine,
        IndexSchema=schema.IndexSchema, config=config,
        PAUSEPOINTS=debug.PAUSEPOINTS, STATS=metrics.STATS)


PACKAGES = {
    "jax": _package(jengine, jingest, jschema, jconfig, jdebug, jmetrics),
    "port": _package(tengine, tingest, tschema, tconfig, tdebug, tmetrics),
}


@pytest.fixture(autouse=True)
def _cpu_and_clean_state():
    set_device("cpu")
    yield
    for pkg in PACKAGES.values():
        pkg.PAUSEPOINTS.reset_all()
        pkg.config.REGISTRY.reset_all()


def _wait_for(fn, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if fn():
            return True
        time.sleep(0.01)
    return False


class _SpySchema:
    """Records the order mutations apply in."""

    def __init__(self):
        self.applied = []
        self.lock = threading.Lock()

    def upsert(self, key, fields):
        with self.lock:
            self.applied.append(key)

    def delete(self, key):
        with self.lock:
            self.applied.append(("del", key))


# -- the queue alone ------------------------------------------------------------------


def combine_and_apply(pkg):
    s = pkg.IndexSchema("i")
    s.add_numeric_attribute("n")
    q = pkg.IngestionEngine(num_workers=1)
    assert q.suspend()
    combined0 = pkg.STATS.get("mutations_combined")
    for v in range(50):
        q.enqueue_upsert(s, "k", {"n": str(v)})
    pending = q.pending()
    q.resume()
    assert q.drain(timeout=10)
    q.shutdown()
    return (s.attributes["n"].index.value_of("k"), pending,
            pkg.STATS.get("mutations_combined") - combined0)


def delete_after_upsert(pkg):
    s = pkg.IndexSchema("i")
    s.add_numeric_attribute("n")
    q = pkg.IngestionEngine(num_workers=2)
    q.enqueue_upsert(s, "a", {"n": "1"})
    q.enqueue_upsert(s, "b", {"n": "2"})
    q.enqueue_delete(s, "a")
    assert q.drain(timeout=10)
    q.shutdown()
    idx = s.attributes["n"].index
    return idx.value_of("a"), idx.value_of("b"), q.pending()


def priority_strict(pkg):
    s = _SpySchema()
    q = pkg.IngestionEngine(num_workers=1)
    assert q.suspend()
    for i in range(5):
        q.enqueue_upsert(s, f"low{i}", {}, priority="low")
    for i in range(5):
        q.enqueue_upsert(s, f"high{i}", {}, priority="high")
    q.enqueue_upsert(s, "urgent", {}, priority="max")
    q.resume()
    assert q.drain(timeout=10)
    q.shutdown()
    return s.applied


def priority_weighted(pkg):
    out = {}
    for weight in (50, 75, 0):
        pkg.config.set_config("search.high-priority-weight", weight)
        s = _SpySchema()
        q = pkg.IngestionEngine(num_workers=1)
        assert q.suspend()
        for i in range(8):
            q.enqueue_upsert(s, f"low{i}", {}, priority="low")
            q.enqueue_upsert(s, f"high{i}", {}, priority="high")
        q.resume()
        assert q.drain(timeout=10)
        q.shutdown()
        out[weight] = s.applied
    return out


def live_write_supersedes_backfill_row(pkg):
    s = _SpySchema()
    q = pkg.IngestionEngine(num_workers=1)
    assert q.suspend()
    q.enqueue_upsert(s, "k", {"v": "old"}, priority="low")
    for i in range(3):
        q.enqueue_upsert(s, f"filler{i}", {}, priority="low")
    q.enqueue_upsert(s, "k", {"v": "new"}, priority="high")
    q.resume()
    assert q.drain(timeout=10)
    q.shutdown()
    return s.applied


def suspend_and_resume(pkg):
    s = _SpySchema()
    q = pkg.IngestionEngine(num_workers=3)
    assert q.suspend(timeout=5)
    q.enqueue_upsert(s, "a", {})
    time.sleep(0.15)
    seen = (list(s.applied), q.pending(), q.suspended)
    q.resume()
    assert q.drain(timeout=10)
    again = q.suspend(timeout=5)
    q.resume()
    q.shutdown()
    return seen, s.applied, again


def multi_group_keeps_order(pkg):
    s = _SpySchema()
    q = pkg.IngestionEngine(num_workers=1)
    assert q.suspend()
    q.enqueue_upsert(s, "k", {})
    q.enqueue_multi([jingest.Mutation(s, "k", {"a": 1}),
                     jingest.Mutation(s, "k", None),
                     jingest.Mutation(s, "j", {"a": 2})]
                    if pkg is PACKAGES["jax"] else
                    [tingest.Mutation(s, "k", {"a": 1}),
                     tingest.Mutation(s, "k", None),
                     tingest.Mutation(s, "j", {"a": 2})])
    pending = (q.pending(), q.pending_for_key(s, "k"),
               q.pending_for_key(s, "zz"))
    q.resume()
    assert q.drain(timeout=10)
    q.shutdown()
    return pending, s.applied


# -- through the engine ---------------------------------------------------------------


def async_engine_end_to_end(pkg):
    rng = np.random.default_rng(0)
    e = pkg.Engine(sync_ingest=False)
    e.execute("FT.CREATE", "i", "SCHEMA", "v", "VECTOR", "HNSW", "6", "TYPE",
              "FLOAT32", "DIM", "8", "DISTANCE_METRIC", "L2", "n", "NUMERIC")
    vecs = rng.standard_normal((100, 8)).astype(np.float32)
    for i, v in enumerate(vecs):
        e.hset(f"k{i}", {"v": v.tobytes(), "n": str(i)})
    e.drain()
    res = e.ft_search("i", "@n:[20 29]=>[KNN 3 @v $q]", "PARAMS", "2", "q",
                      vecs[25].tobytes(), "NOCONTENT")
    info = e.ft_info("i")
    d = dict(zip(info[::2], info[1::2]))
    plain = e.execute("FT.SEARCH", "i", "*=>[KNN 5 @v $q]", "PARAMS", "2",
                      "q", vecs[7].tobytes(), "NOCONTENT")
    fut = e.ft_search_async("i", "*=>[KNN 5 @v $q]", "PARAMS", "2", "q",
                            vecs[7].tobytes(), "NOCONTENT")
    return (res[:2], d["num_docs"], d["mutation_queue_size"], plain,
            fut.result(30))


def backfill_by_cron_batches(pkg):
    e = pkg.Engine(sync_ingest=False)
    for i in range(50):
        e.hset(f"k:{i}", {"t": "a"})
    e.drain()
    pkg.config.set_config("search.backfill-batch-size", 20)
    e.execute("FT.CREATE", "i", "ON", "HASH", "PREFIX", "1", "k:", "SCHEMA",
              "t", "TAG")
    schema = e.manager.get("i")
    seen = [schema.backfill_in_progress,
            e.execute("FT.SEARCH", "i", "@t:{a}", "NOCONTENT")[0],
            e.cron()["backfilled"], schema.backfill_in_progress]
    schema.paused_by_oom = True  # a pause freezes the cursor
    seen.append(e.cron()["backfilled"])
    schema.paused_by_oom = False
    seen += [e.cron()["backfilled"], e.cron()["backfilled"]]
    info = dict(zip(*[iter(e.ft_info("i"))] * 2))
    seen += [info["backfill_in_progress"], info["backfill_complete_percent"]]
    e.drain()
    e.cron()  # the settling tick: complete means applied
    seen.append(schema.backfill_in_progress)
    seen.append(e.execute("FT.SEARCH", "i", "@t:{a}", "NOCONTENT", "LIMIT",
                          "0", "100")[0])
    return seen


def cron_thread_completes_backfill(pkg):
    e = pkg.Engine(sync_ingest=False)
    for i in range(30):
        e.hset(f"k:{i}", {"t": "z"})
    e.drain()
    e.execute("FT.CREATE", "i", "ON", "HASH", "PREFIX", "1", "k:", "SCHEMA",
              "t", "TAG")
    e.start_cron(interval_s=0.01)
    try:
        _wait_for(lambda: e.execute("FT.SEARCH", "i", "@t:{z}", "NOCONTENT",
                                    "LIMIT", "0", "100")[0] == 30)
        _wait_for(lambda: not e.manager.get("i").backfill_in_progress)
        names = sorted(t.name for t in threading.enumerate()
                       if t.name == "server-cron")
        return (e.execute("FT.SEARCH", "i", "@t:{z}", "NOCONTENT", "LIMIT",
                          "0", "100")[0],
                e.manager.get("i").backfill_in_progress, names[:1])
    finally:
        e.stop_cron()


def backfill_rides_the_low_queue(pkg):
    e = pkg.Engine(sync_ingest=False)
    for i in range(30):
        e.execute("HSET", f"d:{i}", "n", str(i))
    e.drain()
    e.execute("FT.CREATE", "bf", "ON", "HASH", "PREFIX", "1", "d:", "SCHEMA",
              "n", "NUMERIC")
    q = e._queue()
    assert q.suspend(timeout=5)
    e.cron()
    low_pending = len(q._queues["low"])
    q.resume()
    e.drain()
    while e.cron()["backfilled"]:
        e.drain()
    e.drain()
    r = e.execute("FT.SEARCH", "bf", "@n:[0 100]", "NOCONTENT", "LIMIT", "0",
                  "0")
    return low_pending, r


def delete_during_backfill(pkg):
    e = pkg.Engine(sync_ingest=False)
    for i in range(10):
        e.execute("HSET", f"d:{i}", "n", str(i))
    e.drain()
    e.execute("FT.CREATE", "rz", "ON", "HASH", "PREFIX", "1", "d:", "SCHEMA",
              "n", "NUMERIC")
    q = e._queue()
    assert q.suspend(timeout=5)
    e.cron()  # the batch enqueues refreshes at low priority
    e.execute("DEL", "d:3")  # while its refresh is queued
    q.resume()
    e.drain()
    while e.cron()["backfilled"]:
        e.drain()
    e.drain()
    r = e.execute("FT.SEARCH", "rz", "@n:[0 100]", "NOCONTENT", "LIMIT", "0",
                  "100")
    return r[0], sorted(r[1:])


def backfill_completion_waits_for_applies(pkg):
    e = pkg.Engine(sync_ingest=False)
    for i in range(12):
        e.execute("HSET", f"d:{i}", "n", str(i))
    e.drain()
    e.execute("FT.CREATE", "bw", "ON", "HASH", "PREFIX", "1", "d:", "SCHEMA",
              "n", "NUMERIC")
    schema = e.manager.get("bw")
    q = e._queue()
    assert q.suspend(timeout=5)
    for _ in range(5):
        e.cron()
    queued = schema.backfill_in_progress  # queued is not done
    q.resume()
    e.drain()
    e.cron()
    r = e.execute("FT.SEARCH", "bw", "@n:[0 100]", "NOCONTENT", "LIMIT", "0",
                  "0")
    return queued, schema.backfill_in_progress, r


def contended_query_parks_on_mutation(pkg):
    e = pkg.Engine(sync_ingest=False)
    e.execute("FT.CREATE", "idx", "ON", "HASH", "PREFIX", "1", "p:", "SCHEMA",
              "tags", "TAG", "note", "TAG")
    e.hset("p:1", {"tags": "hot", "note": "old"})
    e.drain()
    pkg.PAUSEPOINTS.pause("ingest.before_apply")
    try:
        e.hset("p:1", {"tags": "hot", "note": "new"})  # held in the queue
        assert _wait_for(
            lambda: pkg.PAUSEPOINTS.waiting("ingest.before_apply") > 0)
        parked0 = pkg.STATS.get("queries_parked_on_mutations")
        results = {}
        t = threading.Thread(target=lambda: results.update(
            r=e.ft_search("idx", "@tags:{hot}")))
        t.start()
        t.join(0.1)
        pkg.PAUSEPOINTS.resume("ingest.before_apply")
        t.join(5)
        assert not t.is_alive()
        reply = results["r"]
        return (reply[0], dict(zip(reply[2][::2], reply[2][1::2])),
                pkg.STATS.get("queries_parked_on_mutations") > parked0)
    finally:
        pkg.PAUSEPOINTS.resume("ingest.before_apply")
        e.drain()


def stale_row_is_revalidated_against_content(pkg):
    """The queue stays blocked past the park budget: the index still holds
    the old tag, and the fetched content decides."""
    e = pkg.Engine(sync_ingest=False)
    e.execute("FT.CREATE", "idx", "ON", "HASH", "PREFIX", "1", "p:", "SCHEMA",
              "tags", "TAG", "n", "NUMERIC")
    e.hset("p:1", {"tags": "hot", "n": "1"})
    e.hset("p:2", {"tags": "hot", "n": "2"})
    e.drain()
    pkg.PAUSEPOINTS.pause("block_mutation_queue")
    try:
        e.hset("p:1", {"tags": "cold", "n": "1"})
        reval0 = pkg.STATS.get("predicate_revalidation")
        reply = e.ft_search("idx", "@tags:{hot}", "NOCONTENT")
        both = e.ft_search("idx", "@tags:{hot} @n:[0 5]", "NOCONTENT")
        return (reply, both,
                pkg.STATS.get("predicate_revalidation") - reval0)
    finally:
        pkg.PAUSEPOINTS.resume("block_mutation_queue")
        e.drain()


def multi_writer_text_ingest(pkg):
    pkg.config.set_config("search.writer-threads", 4)
    e = pkg.Engine(sync_ingest=False)
    e.execute("FT.CREATE", "mw", "ON", "HASH", "PREFIX", "1", "w:", "SCHEMA",
              "body", "TEXT")
    for i in range(500):
        e.hset(f"w:{i}",
               {"body": f"word{i % 37} common shared token{i % 11}"})
    e.drain()
    writers = sorted(t.name for t in threading.enumerate()
                     if t.name.startswith("vstpu-writer-"))
    counts = [e.execute("FT.SEARCH", "mw", f"@body:word{i}", "NOCONTENT",
                        "LIMIT", "0", "0")[0] for i in range(37)]
    common = e.execute("FT.SEARCH", "mw", "@body:common", "NOCONTENT",
                       "LIMIT", "0", "0")[0]
    return (counts, common,
            e.manager.get("mw").text_engine.stats()["docs_with_text"],
            len(set(writers)) >= 4)


def multi_exec_is_one_ordered_group(pkg):
    e = pkg.Engine(sync_ingest=False)
    e.execute("FT.CREATE", "i", "ON", "HASH", "PREFIX", "1", "k:", "SCHEMA",
              "n", "NUMERIC")
    tx = e.multi()
    for i in range(10):
        tx.hset(f"k:{i}", {"n": str(i)})
    tx.hset("k:3", {"n": "33"}).delete("k:4")
    n = tx.exec()
    e.drain()
    r = e.execute("FT.SEARCH", "i", "@n:[0 100]", "NOCONTENT", "LIMIT", "0",
                  "100")
    try:
        tx.exec()
        again = None
    except Exception as exc:  # noqa: BLE001 - compared across packages
        again = (type(exc).__name__, str(exc))
    return n, r[0], sorted(r[1:]), e.execute("HGET", "k:3", "n"), again


# -- text queries block on in-flight mutations ------------------------------------------


def _stat(e, name):
    return e.info(include_dev=True)[name]


def text_query_blocks_and_retries(pkg):
    pkg.config.set_config("search.debug-mode", True)
    e = pkg.Engine(sync_ingest=False)
    e.execute("FT.CREATE", "idx", "SCHEMA", "content", "TEXT")
    e.hset("doc:1", {"content": "hello world"})
    e.hset("doc:2", {"content": "hello there"})
    e.drain()
    before = e.ft_search("idx", "@content:hello", "NOCONTENT")[0]
    blocked0 = _stat(e, "search_text_query_blocked_count")
    # doc:1's update parks in flight at the processing gate
    e.execute("FT._DEBUG", "PAUSEPOINT", "SET", "mutation_processing")
    e.hset("doc:1", {"content": "updated1"})
    assert _wait_for(
        lambda: pkg.PAUSEPOINTS.waiting("mutation_processing") > 0)
    # doc:2's update stays queued behind the earlier gate
    e.execute("FT._DEBUG", "PAUSEPOINT", "SET", "block_mutation_queue")
    e.hset("doc:2", {"content": "updated2 hello"})
    res, err = [], []

    def search():
        try:
            res.append(e.ft_search("idx", "@content:hello"))
        except Exception as ex:  # noqa: BLE001
            err.append(ex)

    t = threading.Thread(target=search)
    t.start()
    assert _wait_for(
        lambda: _stat(e, "search_text_query_blocked_count") > blocked0)
    parked = t.is_alive() and not res
    retry0 = _stat(e, "search_text_query_retry_count")
    e.execute("FT._DEBUG", "PAUSEPOINT", "RESET", "mutation_processing")
    assert _wait_for(
        lambda: _stat(e, "search_text_query_retry_count") > retry0)
    still_parked = t.is_alive() and not res
    e.execute("FT._DEBUG", "PAUSEPOINT", "RESET", "block_mutation_queue")
    t.join(timeout=10)
    assert not t.is_alive() and not err
    e.drain()
    return (before, parked, still_parked, res[0],
            _stat(e, "search_text_query_blocked_count") - blocked0)


def hybrid_text_knn_blocks(pkg):
    pkg.config.set_config("search.debug-mode", True)
    e = pkg.Engine(sync_ingest=False)
    e.execute("FT.CREATE", "idx", "SCHEMA", "content", "TEXT", "vec",
              "VECTOR", "FLAT", "6", "TYPE", "FLOAT32", "DIM", "4",
              "DISTANCE_METRIC", "L2")
    v1, v2 = np.zeros(4, np.float32), np.ones(4, np.float32)
    e.hset("doc:1", {"content": "hello world", "vec": v1.tobytes()})
    e.drain()
    e.execute("FT._DEBUG", "PAUSEPOINT", "SET", "mutation_processing")
    e.hset("doc:1", {"content": "updated", "vec": v2.tobytes()})
    assert _wait_for(
        lambda: pkg.PAUSEPOINTS.waiting("mutation_processing") > 0)
    res = []
    t = threading.Thread(target=lambda: res.append(e.ft_search(
        "idx", "(@content:hello)=>[KNN 1 @vec $q]", "PARAMS", "2", "q",
        v1.tobytes(), "NOCONTENT")))
    t.start()
    time.sleep(0.3)
    parked = t.is_alive() and not res
    e.execute("FT._DEBUG", "PAUSEPOINT", "RESET", "mutation_processing")
    t.join(timeout=10)
    assert not t.is_alive()
    e.drain()
    return parked, res[0]


def non_text_queries_do_not_block(pkg):
    pkg.config.set_config("search.debug-mode", True)
    e = pkg.Engine(sync_ingest=False)
    e.execute("FT.CREATE", "idx", "SCHEMA", "n", "NUMERIC", "t", "TAG")
    for i in range(4):
        e.hset(f"k:{i}", {"n": str(i), "t": "a"})
    e.drain()
    e.execute("FT._DEBUG", "PAUSEPOINT", "SET", "block_mutation_queue")
    e.hset("k:0", {"n": "0", "t": "a"})
    blocked0 = _stat(e, "search_text_query_blocked_count")
    t0 = time.monotonic()
    r = e.ft_search("idx", "@n:[0 1]", "NOCONTENT")
    quick = time.monotonic() - t0 < 2.0
    blocked = _stat(e, "search_text_query_blocked_count") - blocked0
    e.execute("FT._DEBUG", "PAUSEPOINT", "RESET", "block_mutation_queue")
    e.drain()
    return r[0], sorted(r[1:]), quick, blocked


def dropindex_while_query_blocked(pkg):
    pkg.config.set_config("search.debug-mode", True)
    e = pkg.Engine(sync_ingest=False)
    e.execute("FT.CREATE", "idx", "SCHEMA", "content", "TEXT")
    e.hset("doc:1", {"content": "hello world"})
    e.drain()
    e.execute("FT._DEBUG", "PAUSEPOINT", "SET", "mutation_processing")
    e.hset("doc:1", {"content": "updated"})
    assert _wait_for(
        lambda: pkg.PAUSEPOINTS.waiting("mutation_processing") > 0)
    res, err = [], []

    def search():
        try:
            res.append(e.ft_search("idx", "@content:hello"))
        except Exception as ex:  # noqa: BLE001
            err.append((type(ex).__name__, str(ex)))

    blocked0 = _stat(e, "search_text_query_blocked_count")
    t = threading.Thread(target=search)
    t.start()
    assert _wait_for(
        lambda: _stat(e, "search_text_query_blocked_count") > blocked0)
    e.execute("FT.DROPINDEX", "idx")
    e.execute("FT._DEBUG", "PAUSEPOINT", "RESET", "mutation_processing")
    t.join(timeout=10)
    assert not t.is_alive()
    e.drain()
    return res, err


SCENARIOS = {
    combine_and_apply: (49, 1, 49),
    delete_after_upsert: (None, 2, 0),
    priority_strict: (["urgent"] + [f"high{i}" for i in range(5)]
                      + [f"low{i}" for i in range(5)]),
    priority_weighted: None,
    live_write_supersedes_backfill_row: ["k", "filler0", "filler1",
                                         "filler2"],
    suspend_and_resume: (([], 1, True), ["a"], True),
    multi_group_keeps_order: ((4, True, False),
                              ["k", "k", ("del", "k"), "j"]),
    async_engine_end_to_end: None,
    backfill_by_cron_batches: [True, 0, 20, True, 0, 20, 10, 1, "0.000000",
                               False, 50],
    cron_thread_completes_backfill: (30, False, ["server-cron"]),
    backfill_rides_the_low_queue: (30, [30]),
    delete_during_backfill: (9, [f"d:{i}" for i in range(10) if i != 3]),
    backfill_completion_waits_for_applies: (True, False, [12]),
    contended_query_parks_on_mutation: (
        1, {"tags": "hot", "note": "new"}, True),
    stale_row_is_revalidated_against_content: ([2, "p:2"], [2, "p:2"], 2),
    multi_writer_text_ingest: (
        [sum(1 for k in range(500) if k % 37 == i) for i in range(37)], 500,
        500, True),
    multi_exec_is_one_ordered_group: (
        12, 9, sorted(f"k:{i}" for i in range(10) if i != 4), "33",
        ("CommandError", "transaction already finished")),
    text_query_blocks_and_retries: (
        2, True, True, [1, "doc:2", ["content", "updated2 hello"]], 1),
    hybrid_text_knn_blocks: (True, [0]),
    non_text_queries_do_not_block: None,
    dropindex_while_query_blocked: (
        [], [("FTSearchError", "Index with name 'idx' not found")]),
}


# the port's reply where it repairs the JAX package: a row that content
# resolution drops (here p:1, whose fetched content no longer matches)
# leaves the count too; the JAX package still counts it
REPAIRED_IN_THE_PORT = {
    stale_row_is_revalidated_against_content: ([1, "p:2"], [1, "p:2"], 2),
}


@pytest.mark.parametrize("scenario", list(SCENARIOS),
                         ids=[f.__name__ for f in SCENARIOS])
def test_scenario_matches_the_reference(scenario):
    want = scenario(PACKAGES["jax"])
    got = scenario(PACKAGES["port"])
    assert got == REPAIRED_IN_THE_PORT.get(scenario, want)
    if SCENARIOS[scenario] is not None:
        assert want == SCENARIOS[scenario]


def test_weighted_priorities_mix_highs_and_lows():
    out = priority_weighted(PACKAGES["port"])
    head = out[50][:6]
    assert any(k.startswith("low") for k in head)
    assert any(k.startswith("high") for k in head)
    assert out[0][:8] == [f"low{i}" for i in range(8)]
    assert sum(k.startswith("high") for k in out[75][:8]) == 6


def test_writer_threads_leave_device_tensors_to_the_publish():
    """Writer threads write host structures only: after an asynchronous
    load nothing is published; the first search publishes the snapshot."""
    e = tengine.Engine(sync_ingest=False)
    e.execute("FT.CREATE", "i", "SCHEMA", "v", "VECTOR", "FLAT", "6", "TYPE",
              "FLOAT32", "DIM", "4", "DISTANCE_METRIC", "L2")
    store = e.manager.get("i").attribute("v").index.store
    assert store._device is None and store.epoch == 0
    for i in range(64):
        e.hset(f"k{i}", {"v": np.full(4, i, np.float32).tobytes()})
    e.drain()
    assert e._queue_size() == 0
    # 64 rows written by the writer pool, none published
    assert store._device is None and store.epoch == 0
    assert len(store._dirty) == 64
    reply = e.execute("FT.SEARCH", "i", "*=>[KNN 2 @v $q]", "PARAMS", "2",
                      "q", np.full(4, 9.2, np.float32).tobytes(),
                      "NOCONTENT")
    assert reply == [2, "k9", "k10"]
    assert store.epoch == 1 and not store._dirty
    # a publish hands out a whole new mirror: the one a search holds stays
    held = store.device_snapshot()
    e.hset("k9", {"v": np.full(4, 100, np.float32).tobytes()})
    e.drain()
    fresh = store.device_snapshot()
    assert fresh is not held and store.epoch == 2
    assert float(held["vectors"][e.manager.get("i").interner.lookup("k9")][0]) == 9.0


def test_writers_and_searchers_under_stress_settle_on_the_keyspace():
    """More threads than cores, a short switch interval: 8 producers write
    and delete 25 keys each while 4 searchers run KNN and tag queries
    through the batcher and the writer pool. After ``drain()`` the indexes
    hold exactly what the keyspace holds (a mutation lost or reordered in
    the queue would break that), and no search raised or returned a torn
    reply. Each producer owns its keys: two clients writing ONE key at once
    can reach the queue in the other order than the keyspace, in both
    packages (the engine notifies outside its lock), and a server serialises
    a key's writes before they get here. Fails without the port's two
    repairs: one queue however many clients arrive together, and no delete
    overtaking its key's upsert on a second writer."""
    import sys

    e = tengine.Engine(sync_ingest=False)
    e.execute("FT.CREATE", "i", "ON", "HASH", "PREFIX", "1", "k:", "SCHEMA",
              "v", "VECTOR", "FLAT", "6", "TYPE", "FLOAT32", "DIM", "4",
              "DISTANCE_METRIC", "L2", "t", "TAG")
    stop = threading.Event()
    errors = []

    def producer(tid):
        rng = np.random.default_rng(tid)
        try:
            for step in range(400):
                key = f"k:{tid}:{int(rng.integers(0, 25))}"
                if rng.random() < 0.25:
                    e.execute("DEL", key)
                else:
                    e.execute("HSET", key, "v", rng.standard_normal(4).astype(
                        np.float32).tobytes(), "t", f"t{step % 3}")
        except Exception as exc:  # noqa: BLE001 - reported below
            errors.append(repr(exc))

    def searcher(tid):
        q = np.full(4, tid, np.float32).tobytes()
        try:
            while not stop.is_set():
                reply = e.execute("FT.SEARCH", "i", "*=>[KNN 5 @v $q]",
                                  "PARAMS", "2", "q", q, "NOCONTENT")
                assert reply[0] == len(reply) - 1 <= 5, reply
                reply = e.execute("FT.SEARCH", "i", "@t:{t1}=>[KNN 5 @v $q]",
                                  "PARAMS", "2", "q", q)
                assert len(reply) == 1 + 2 * reply[0], reply
        except Exception as exc:  # noqa: BLE001 - reported below
            errors.append(repr(exc))

    before = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        producers = [threading.Thread(target=producer, args=(t,))
                     for t in range(8)]
        searchers = [threading.Thread(target=searcher, args=(t,))
                     for t in range(4)]
        for t in producers + searchers:
            t.start()
        for t in producers:
            t.join(120)
        stop.set()
        for t in searchers:
            t.join(60)
    finally:
        sys.setswitchinterval(before)
    assert not any(t.is_alive() for t in producers + searchers)
    assert not errors, errors[:3]
    assert e._ingestion.drain(timeout=60)
    assert e._queue_size() == 0
    live = {k: f for k, f in e.keyspace.items()}
    reply = e.execute("FT.SEARCH", "i", "*", "NOCONTENT", "LIMIT", "0", "1000")
    assert reply[0] == len(live) and set(reply[1:]) == set(live)
    for tag in ("t0", "t1", "t2"):
        reply = e.execute("FT.SEARCH", "i", f"@t:{{{tag}}}", "NOCONTENT",
                          "LIMIT", "0", "1000")
        assert set(reply[1:]) == {k for k, f in live.items()
                                  if f["t"] == tag}, tag
    # each key's indexed vector is the keyspace's
    for key in list(live)[:50]:
        reply = e.execute("FT.SEARCH", "i", "*=>[KNN 1 @v $q]", "PARAMS", "2",
                          "q", live[key]["v"], "RETURN", "1", "__v_score")
        assert abs(float(reply[2][1])) <= 1e-5, (key, reply)
    e._ingestion.shutdown()


def test_clients_that_arrive_together_share_one_queue(monkeypatch):
    """The first writes of eight clients reach an engine that has no queue
    yet: one is created. The JAX package checks and creates without a lock,
    so each client may start a queue of its own."""
    made = []
    real = tingest.IngestionEngine

    class Slow(real):
        def __init__(self, *args, **kwargs):
            time.sleep(0.05)  # widen the window between check and create
            super().__init__(*args, **kwargs)
            made.append(self)

    monkeypatch.setattr(tingest, "IngestionEngine", Slow)
    e = tengine.Engine(sync_ingest=False)
    barrier = threading.Barrier(8)
    queues = []

    def client():
        barrier.wait(5)
        queues.append(e._queue())

    threads = [threading.Thread(target=client) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(10)
    assert not any(t.is_alive() for t in threads)
    assert len(made) == 1 and all(q is made[0] for q in queues)
    pools = []
    futures = [e.ft_search_async("nosuch", "*") for _ in range(4)]
    for f in futures:
        with pytest.raises(Exception, match="not found"):
            f.result(10)
        pools.append(e._reader_pool)
    assert all(p is pools[0] for p in pools)
    made[0].shutdown()


def test_a_key_mid_apply_is_not_handed_to_a_second_writer():
    """An upsert is still applying when the key's delete is queued: the
    delete waits for it, while the free writer serves other keys. The JAX
    package's queue hands the delete out at once, and the upsert lands
    after it."""
    started, release = threading.Event(), threading.Event()
    spy = _SpySchema()
    plain_upsert = spy.upsert

    def slow_upsert(key, fields):
        if key == "k" and not started.is_set():
            started.set()
            release.wait(10)
        plain_upsert(key, fields)

    spy.upsert = slow_upsert
    q = tingest.IngestionEngine(num_workers=2)
    try:
        q.enqueue_upsert(spy, "k", {"n": "1"})
        assert started.wait(5)
        q.enqueue_delete(spy, "k")
        q.enqueue_upsert(spy, "other", {})
        assert _wait_for(lambda: "other" in spy.applied, timeout=5)
        time.sleep(0.05)
        assert ("del", "k") not in spy.applied  # held behind the upsert
        assert q.pending() == 2 and q.pending_for_key(spy, "k")
        release.set()
        assert q.drain(timeout=10)
    finally:
        release.set()
        q.shutdown()
    assert spy.applied == ["other", "k", ("del", "k")]


def test_pending_check_looks_keys_up_and_does_not_scan_the_queues():
    """A key's MULTI/EXEC entries sit under three-part queue keys; the port
    counts them in a side table, so ``pending_for_key`` is a lookup. The JAX
    package walks every queue for them: a backfill tick, which checks each
    key of its batch against the batch it is queueing, is then quadratic in
    the batch size."""
    from collections import OrderedDict

    class Counting(OrderedDict):
        walks = 0

        def __iter__(self):
            Counting.walks += 1
            return super().__iter__()

    s = _SpySchema()
    q = tingest.IngestionEngine(num_workers=2)
    try:
        assert q.suspend()
        q._queues = {p: Counting() for p in q._queues}
        q.enqueue_multi([tingest.Mutation(s, "k", {"a": 1}),
                         tingest.Mutation(s, "k", None)])
        for i in range(200):
            q.enqueue_refresh(s, f"b{i}", lambda key: {})
        q.enqueue_refresh(s, "k", lambda key: {})  # pending: dropped
        assert q.pending() == 202
        assert q.pending_for_key(s, "k") and q.pending_for_key(s, "b7")
        assert not q.pending_for_key(s, "zz")
        assert Counting.walks == 0
        q.resume()
        assert q.drain(timeout=10)
        assert not q.pending_for_key(s, "k") and not q._multi_queued
    finally:
        q.resume()
        q.shutdown()
    assert [a for a in s.applied if a in ("k", ("del", "k"))] == \
        ["k", ("del", "k")]


# -- the batcher's repairs --------------------------------------------------------------


class _Index:
    def __init__(self):
        self.calls = 0

    def search_batch(self, queries, k, ef=None):
        self.calls += 1
        n = queries.shape[0]
        return (np.repeat(queries.sum(1, keepdims=True), k, axis=1),
                np.full((n, k), n, np.int64))


def test_a_dead_dispatcher_gives_its_count_back(monkeypatch):
    """An error outside the launch (here: reading the batch window) kills the
    dispatcher; the next submit for the signature must start a new one
    instead of waiting on a count that names a dead thread."""
    batcher = tbatcher.VectorQueryBatcher()
    index = _Index()
    real_get = tbatcher.config.get
    state = {"fail": True}

    def flaky_get(name):
        if name == "search.query-batch-window-us" and state["fail"]:
            state["fail"] = False
            raise RuntimeError("registry unavailable")
        return real_get(name)

    monkeypatch.setattr(tbatcher.config, "get", flaky_get)
    monkeypatch.setattr(threading, "excepthook", lambda args: None)
    first = batcher.submit(index, np.ones(4, np.float32), 2, None)
    assert _wait_for(lambda: not batcher._workers, timeout=5)
    second = batcher.submit(index, np.full(4, 2, np.float32), 2, None)
    d, ids = second.result(5)
    assert d.tolist() == [8.0, 8.0]
    # the first query was still queued: the new dispatcher served it too
    assert first.result(5)[0].tolist() == [4.0, 4.0]


def test_a_cancelled_waiter_does_not_fail_its_batch():
    batcher = tbatcher.VectorQueryBatcher()
    index = _Index()
    gate = threading.Event()
    real = index.search_batch

    def gated(queries, k, ef=None):
        gate.wait(5)
        return real(queries, k, ef=ef)

    index.search_batch = gated
    warm = batcher.submit(index, np.zeros(4, np.float32), 2, None)
    # these three queue up behind the gated launch and form one batch
    assert _wait_for(lambda: not batcher._queues.get((id(index), 2, None)))
    futures = [batcher.submit(index, np.full(4, i, np.float32), 2, None)
               for i in (1, 2, 3)]
    assert futures[0].cancel()
    gate.set()
    warm.result(5)
    assert futures[1].result(5)[0].tolist() == [8.0, 8.0]
    assert futures[2].result(5)[0].tolist() == [12.0, 12.0]
    assert futures[0].cancelled()
    assert isinstance(futures[1], Future)
