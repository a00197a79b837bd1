"""INFO, ACL, the log, the thread monitor and FT._DEBUG of the port.

The flows of ``test_info_fields.py`` and the ACL, log, thread-monitor and
FT._DEBUG flows of ``test_runtime_aux.py``, through the JAX package and the
port: the INFO field names are equal (with and without developer fields),
the state-derived values are equal and the counters move by equal amounts;
ACL errors are equal in type and message; every FT._DEBUG subcommand gives an
equal reply, but for PROFILE (the port captures a ``torch.profiler`` trace,
checked on its own) and the counter values of METRICS (each package counts
its own history; the names it shares are checked).
"""

import logging
import os
import threading
import time

import numpy as np
import pytest

from valkey_search_tpu.runtime import log as jlog
from valkey_search_tpu.runtime import threadmon as jthreadmon
from valkey_search_tpu.runtime.debug import reset_all as jreset
from valkey_search_tpu.runtime.info import format_si_bytes as jformat
from valkey_search_tpu.server import acl as jacl
from valkey_search_tpu_torch.runtime import config as tconfig
from valkey_search_tpu_torch.runtime import info as tinfo
from valkey_search_tpu_torch.runtime import log as tlog
from valkey_search_tpu_torch.runtime import threadmon as tthreadmon
from valkey_search_tpu_torch.runtime.debug import CONTROLLED, PAUSEPOINTS
from valkey_search_tpu_torch.runtime.debug import reset_all as treset
from valkey_search_tpu_torch.runtime.device import set_device
from valkey_search_tpu_torch.server import acl as tacl
from valkey_search_tpu_torch.server.engine import Engine
from valkey_search_tpu_torch.server.ft_debug import FTDebugError
from torch_port_both import Both, Errored, outcome
from torch_port_config import saved_options, set_both

# the reference's INFO spelling (valkey_search.cc:93-160), by value type
INTEGER_FIELDS = [
    "search_query_queue_size", "search_writer_queue_size",
    "search_worker_pool_suspend_cnt", "search_writer_resumed_cnt",
    "search_reader_resumed_cnt", "search_writer_suspension_expired_cnt",
    "search_rdb_load_success_cnt", "search_rdb_load_failure_cnt",
    "search_rdb_save_success_cnt", "search_rdb_save_failure_cnt",
    "search_successful_requests_count", "search_failure_requests_count",
    "search_hybrid_requests_count", "search_inline_filtering_requests_count",
    "search_hnsw_add_exceptions_count", "search_hnsw_remove_exceptions_count",
    "search_hnsw_modify_exceptions_count",
    "search_hnsw_search_exceptions_count",
    "search_hnsw_create_exceptions_count",
    "search_string_interning_store_size",
    "search_vector_externing_entry_count",
    "search_vector_externing_hash_extern_errors",
    "search_vector_externing_generated_value_cnt",
    "search_vector_externing_num_lru_entries",
    "search_vector_externing_lru_promote_cnt",
    "search_vector_externing_deferred_entry_cnt",
    "search_number_of_attributes", "search_number_of_indexes",
    "search_total_indexed_documents", "search_total_active_write_threads",
    "search_used_memory_bytes", "search_index_reclaimable_memory",
]
STATE_FIELDS = [
    "search_number_of_indexes", "search_number_of_attributes",
    "search_total_indexed_documents", "search_string_interning_store_size",
    "search_keyspace_keys", "search_background_indexing_status",
    "search_backfills_in_progress", "search_mutation_queue_size",
    "search_writer_queue_size", "search_query_queue_size",
    "search_total_active_write_threads", "search_memory_pool_tag_bytes",
    "search_memory_pool_keyspace_bytes", "search_memory_pool_interner_bytes",
]


@pytest.fixture(autouse=True)
def _cpu_and_clean_state():
    set_device("cpu")
    jreset()
    treset()
    with saved_options("search.debug-mode", "search.corpus-dtype",
                       "search.log-level"):
        set_both("search.corpus-dtype", "float32")
        yield
    jreset()
    treset()


@pytest.fixture
def both():
    b = Both()
    b.same("FT.CREATE", "idx", "SCHEMA", "v", "VECTOR", "HNSW", "6", "TYPE",
           "FLOAT32", "DIM", "4", "DISTANCE_METRIC", "L2", "t", "TAG")
    for i in range(8):
        b.same("HSET", f"k{i}", "v", np.float32([i, 0, 0, 0]).tobytes(), "t",
               "x")
    return b


def _infos(b, include_dev=True):
    return [e.info(include_dev=include_dev) for e in b.engines]


# -- INFO -------------------------------------------------------------------------


@pytest.mark.parametrize("include_dev", [True, False])
def test_info_field_names_match_the_reference(both, include_dev):
    jinfo, pinfo = _infos(both, include_dev)
    assert sorted(pinfo) == sorted(jinfo)
    assert "<error>" not in [v for v in pinfo.values() if isinstance(v, str)]
    assert ("search_hnsw_graph_rebuilds" in pinfo) == include_dev
    if include_dev:
        for f in INTEGER_FIELDS:
            int(pinfo[f])
        for f in ("search_used_read_cpu", "search_used_write_cpu"):
            float(pinfo[f])
        assert str(pinfo["search_used_memory_human"]).endswith(("B", "iB"))
        assert isinstance(pinfo["search_thread_pool_cpu_percent"], str)


def test_info_follows_debug_mode(both):
    assert "search_hnsw_graph_rebuilds" not in both.port.info()
    set_both("search.debug-mode", True)
    jinfo, pinfo = (e.info() for e in both.engines)
    assert sorted(pinfo) == sorted(jinfo)
    assert "search_hnsw_graph_rebuilds" in pinfo
    assert sorted(both.port.execute("INFO")) == sorted(pinfo)


def test_info_state_values_match_the_reference(both):
    jinfo, pinfo = _infos(both)
    for f in STATE_FIELDS:
        assert pinfo[f] == jinfo[f], f
    assert pinfo["search_number_of_indexes"] == 1
    assert pinfo["search_number_of_attributes"] == 2
    assert pinfo["search_total_indexed_documents"] == 8
    assert pinfo["search_background_indexing_status"] == "NO_ACTIVITY"
    assert int(pinfo["search_used_memory_bytes"]) > 0


REQUESTS = [
    ("FT.SEARCH", "idx", "*=>[KNN 3 @v $q]", "PARAMS", "2", "q",
     np.zeros(4, np.float32).tobytes(), "NOCONTENT"),
    ("FT.SEARCH", "idx", "(@t:{x})=>[KNN 3 @v $q]", "PARAMS", "2", "q",
     np.zeros(4, np.float32).tobytes(), "NOCONTENT"),
    ("FT.SEARCH", "idx", "@nope:[bad"),
    ("FT.SEARCH", "idx", "@t:{x}", "NOCONTENT"),
    ("FT.AGGREGATE", "idx", "@t:{x}", "GROUPBY", "1", "@t", "REDUCE", "COUNT",
     "0"),
    ("FT.AGGREGATE", "idx", "@t:{x}", "TIMEOUT", "0"),
    ("HSET", "k0", "v", b"short"),
    ("DEL", "k1"),
]
MOVING = [
    "search_queries_total", "search_vector_queries",
    "search_nonvector_queries", "search_hybrid_queries_prefilter",
    "search_hybrid_queries_inline", "search_query_errors",
    "search_aggregate_queries", "search_aggregate_errors",
    "search_successful_requests_count", "search_failure_requests_count",
    "search_hybrid_requests_count", "search_documents_dropped_invalid",
    "search_vector_records_removed", "search_agg_group_by_stages",
    "search_agg_input_records", "search_agg_output_records",
]


@pytest.mark.parametrize("request_no", range(len(REQUESTS)))
def test_info_counters_move_as_the_reference(both, request_no):
    jbase, pbase = _infos(both)
    both.same(*REQUESTS[request_no])
    jnow, pnow = _infos(both)
    moved = {f: pnow[f] - pbase[f] for f in MOVING}
    assert moved == {f: jnow[f] - jbase[f] for f in MOVING}
    assert any(moved.values()), moved


def test_two_engines_do_not_alias_and_si_bytes():
    e1, e2 = Engine(), Engine()
    e1.execute("FT.CREATE", "a", "ON", "HASH", "SCHEMA", "t", "TAG")
    assert e1.info()["search_number_of_indexes"] == 1
    assert e2.info()["search_number_of_indexes"] == 0
    for n in (0, 512, 2048, 3 * 1024 * 1024, 5 * 2**30, 7 * 2**40, 2**60):
        assert tinfo.format_si_bytes(n) == jformat(n)
    assert tinfo.format_si_bytes(2048) == "2.00KiB"
    registry = tinfo.InfoRegistry()
    registry.field("a", lambda: 1)
    registry.field("hidden", lambda: 2, dev=True)
    registry.field("broken", lambda: 1 / 0)
    registry.field("never", lambda: 3, visible_if=lambda: False)
    assert registry.collect(include_dev=False) == {"a": 1, "broken": "<error>"}
    with pytest.raises(ValueError, match="duplicate info field 'a'"):
        registry.field("a", lambda: 1)


def test_allocator_level_memory_fields():
    info = Engine().info()
    for f in ("search_process_rss_bytes", "search_heap_allocated_bytes"):
        assert str(info[f]).endswith(("B", "iB")) and info[f] != "0B"


def test_asynchronous_engine_reports_its_queue_and_writers():
    b = Both(sync_ingest=False)
    b.same("FT.CREATE", "i", "ON", "HASH", "PREFIX", "1", "k:", "SCHEMA", "t",
           "TAG")
    for e in b.engines:
        e._queue().suspend()
    for i in range(5):
        b.same("HSET", f"k:{i}", "t", "a")
    jinfo, pinfo = _infos(b)
    for f in ("search_mutation_queue_size", "search_writer_queue_size",
              "search_total_active_write_threads"):
        assert pinfo[f] == jinfo[f], f
    assert pinfo["search_mutation_queue_size"] == 5
    info = b.same("FT.INFO", "i")
    assert dict(zip(info[::2], info[1::2]))["mutation_queue_size"] == 5
    for e in b.engines:
        e._queue().resume()
    b.drain()
    assert b.same("FT.SEARCH", "i", "@t:{a}", "NOCONTENT")[0] == 5
    assert b.port.info()["search_mutation_queue_size"] == 0
    b.shutdown()


# -- ACL --------------------------------------------------------------------------

ACL_RULES = [
    ("alice", "on", "~doc:*"), ("alice", "allkeys"), ("bob", "off", "~*"),
    ("carol", "on", "~doc:*", "+@search"), ("dan", "on", ">pw", "~*", "+@all",
                                            "-@admin"),
    ("dan", "+@admin"), ("eve", "on", "-FT.DROPINDEX"), ("eve", "bogus"),
    ("fay", "on", "%RW~x:*", "nopass", "resetpass", "&chan", "+get",
     "resetkeys", "~y:*", "-@all"),
]


def test_acl_manager_matches_the_reference():
    managers = (jacl.AclManager(), tacl.AclManager())
    for rules in ACL_RULES:
        got = [outcome(m.setuser, *rules) for m in managers]
        assert [g[0] for g in got] == [got[0][0]] * 2, rules
        if got[0][0] == "error":
            assert got[1] == got[0], rules
        else:
            assert vars(got[1][1]) == vars(got[0][1]), rules
    probes = [("check_index_access", "alice", ["doc:"]),
              ("check_index_access", "alice", [""]),
              ("check_index_access", "bob", ["doc:"]),
              ("check_index_access", "carol", ["other:", "doc:a"]),
              ("check_index_access", "nobody", ["doc:"]),
              ("check_command", "carol", "FT.SEARCH"),
              ("check_command", "alice", "FT.SEARCH"),
              ("check_command", "bob", "FT.CREATE"),
              ("check_command", "dan", "FT._DEBUG"),
              ("check_command", "fay", "FT.INFO"),
              ("check_command", "carol", "HSET"),
              ("deluser", "default"), ("deluser", "alice"),
              ("getuser", "alice")]
    for method, *args in probes:
        got = [outcome(getattr(m, method), *args) for m in managers]
        assert got[1] == got[0], (method, args)
    user = managers[1].getuser("dan")
    assert user.has_category("search") and user.has_category("admin")
    assert user.check_password("pw") and not user.check_password("no")
    assert user.may_touch_key("anything")
    assert tacl.COMMAND_CATEGORIES == jacl.COMMAND_CATEGORIES
    assert issubclass(tacl.AclError, PermissionError)


def test_acl_enforced_on_commands(both):
    for e in both.engines:
        e.acl.setuser("carol", "on", "~doc:*", "+@search")
        e.acl.setuser("reader", "on", "~*", "+@read")
    b = both
    assert b.same("FT.CREATE", "mine", "ON", "HASH", "PREFIX", "1", "doc:",
                  "SCHEMA", "t", "TAG", user="carol") == "OK"
    b.same("HSET", "doc:1", "t", "x")
    assert b.same("FT.SEARCH", "mine", "@t:{x}", "NOCONTENT",
                  user="carol")[0] == 1
    b.same("FT.CREATE", "all", "ON", "HASH", "SCHEMA", "t", "TAG")
    denied = [
        ("FT.CREATE", "theirs", "ON", "HASH", "PREFIX", "1", "sec:", "SCHEMA",
         "t", "TAG"),
        ("FT.SEARCH", "all", "@t:{x}"), ("FT.INFO", "all"),
        ("FT.DROPINDEX", "all"),
        ("FT.AGGREGATE", "all", "*", "GROUPBY", "1", "@t", "REDUCE", "COUNT",
         "0"),
    ]
    for argv in denied:
        got = b.same(*argv, user="carol")
        assert isinstance(got, Errored) and got.type == "AclError", argv
    for argv in (("FT.SEARCH", "mine", "@t:{x}"), ("FT._LIST",),
                 ("FT.INFO", "mine"), ("FT._DEBUG", "STRING_POOL_STATS")):
        b.same(*argv, user="nobody")
        got = [outcome(e.execute, *argv, user="reader") for e in b.engines]
        assert got[1][0] == got[0][0], argv
        if got[0][0] == "error":
            assert got[1] == got[0], argv
    # INFO carries process gauges, so only its outcome kind is compared
    for user in ("nobody", "reader", "carol"):
        got = [outcome(e.execute, "INFO", user=user) for e in b.engines]
        assert got[1][0] == got[0][0], user
        if got[0][0] == "error":
            assert got[1] == got[0], user
        else:
            assert sorted(got[1][1]) == sorted(got[0][1])
    for e in b.engines:
        got = outcome(e.ft_search, "all", "@t:{x}", user="carol")
        assert got[:2] == ("error", "AclError")
        # 8 keys of the fixture and doc:1 carry the tag
        assert e.ft_search_async("all", "@t:{x}", "NOCONTENT").result(30)[0] \
            == 9
    # the default user is unaffected
    assert b.same("FT.SEARCH", "all", "@t:{x}", "NOCONTENT")[0] == 9


# -- log and thread monitor ---------------------------------------------------------


def test_log_matches_the_reference(caplog):
    assert sorted(n for n in vars(tlog) if not n.startswith("__")) == \
        sorted(n for n in vars(jlog) if not n.startswith("__"))
    for mod, name in ((jlog, "valkey_search_tpu"),
                      (tlog, "valkey_search_tpu_torch")):
        with caplog.at_level(logging.DEBUG, logger=name):
            caplog.clear()
            for i in range(5):
                mod.log_every_n_sec("k", 60, logging.WARNING, "once %d", i)
            mod.log("notice", "plain %s", "line")
            records = [(r.levelno, r.getMessage()) for r in caplog.records
                       if r.name == name]
        if mod is jlog:
            want = records
    assert records == want and records


def test_thread_cpu_monitor_samples_pools():
    for mod in (jthreadmon, tthreadmon):
        assert mod._pool_of("reader-3") == "reader"
        assert mod._pool_of("vstpu-writer-2") == jthreadmon._pool_of(
            "vstpu-writer-2")
        assert mod._pool_of("vstpu-query-dispatch-0") == jthreadmon._pool_of(
            "vstpu-query-dispatch-0")
        assert mod._pool_of("MainThread") == "MainThread"
    mon = tthreadmon.ThreadCpuMonitor()
    stop = threading.Event()

    def burn():
        x = 0
        while not stop.is_set():
            x += 1

    t = threading.Thread(target=burn, name="burner-0")
    t.start()
    try:
        time.sleep(0.05)
        mon.sample()  # the baseline, with the thread alive
        # a busy thread shows real CPU%; on a loaded host a 0.3 s window
        # may hold no scheduler tick of it, so look at up to ten windows
        pct = {}
        for _ in range(10):
            time.sleep(0.3)
            pct = mon.sample()
            if pct.get("burner", 0) > 5.0:
                break
    finally:
        stop.set()
        t.join()
    assert pct.get("burner", 0) > 5.0, pct
    assert mon.percents() == pct
    assert Engine().cron()["expired"] == 0  # the cron samples MONITOR


# -- FT._DEBUG ----------------------------------------------------------------------


@pytest.fixture
def text_both():
    b = Both()
    b.same("FT.CREATE", "i", "ON", "HASH", "PREFIX", "1", "k:", "SCHEMA", "t",
           "TAG", "title", "TEXT")
    b.same("FT.CREATE", "plain", "ON", "HASH", "PREFIX", "1", "p:", "SCHEMA",
           "n", "NUMERIC")
    b.same("HSET", "k:1", "t", "a", "title", "hello helping worlds")
    b.same("HSET", "k:2", "t", "b", "title", "hello again")
    return b


DEBUG_COMMANDS = [
    (), ("NOSUCH",), ("HELP",),
    ("PAUSEPOINT",), ("PAUSEPOINT", "LIST"), ("PAUSEPOINT", "SET"),
    ("PAUSEPOINT", "SET", "pt"), ("PAUSEPOINT", "LIST"),
    ("PAUSEPOINT", "TEST", "pt"), ("PAUSEPOINT", "RESET", "pt"),
    ("PAUSEPOINT", "TEST", "pt"), ("PAUSEPOINT", "BOGUS", "pt"),
    ("CONTROLLED_VARIABLE",), ("CONTROLLED_VARIABLE", "SET", "force_x"),
    ("CONTROLLED_VARIABLE", "SET", "force_x", "true"),
    ("CONTROLLED_VARIABLE", "GET", "force_x"), ("CONTROLLED_VARIABLE", "GET"),
    ("CONTROLLED_VARIABLE", "LIST"), ("CONTROLLED_VARIABLE", "BOGUS"),
    ("TEST_COUNTER",), ("TEST_COUNTER", "GET"), ("TEST_COUNTER", "GET", "x"),
    ("SHOW_INDEX", "i"), ("SHOW_INDEX", "nosuch"), ("SHOW_INDEX",),
    ("SHOW_INDEXSCHEMAS",), ("SHOW_METADATA",), ("STRING_POOL_STATS",),
    ("STRINGPOOLSTATS",), ("CONFIG",), ("CONFIG", "NAMES_ONLY"),
    ("LIST_CONFIGS", "VERBOSE"), ("TEXTINFO", "i"),
    ("TEXTINFO", "plain", "PREFIX", "x"), ("TEXTINFO", "nosuch", "PREFIX", "x"),
    ("TEXTINFO", "i", "PREFIX", "hel"),
    ("TEXTINFO", "i", "PREFIX", "hello", "WITHKEYS", "WITHPOSITIONS"),
    ("TEXTINFO", "i", "PREFIX", "hello", "WITHKEYS"),
    ("TEXTINFO", "i", "SUFFIX", "lo"), ("TEXTINFO", "i", "STEM", "help"),
    ("TEXTINFO", "i", "BOGUS", "x"), ("PROFILE",), ("PROFILE", "BOGUS"),
    ("PROFILE", "START"), ("RESET",), ("PAUSEPOINT", "LIST"),
    ("CONTROLLED_VARIABLE", "LIST"),
]


def _same_debug(b, argv):
    if argv[:1] in (("CONFIG",), ("LIST_CONFIGS",)):
        return _same_configs(b, argv)
    got = b.same("FT._DEBUG", *argv)
    if argv == ("HELP",):
        assert got[-4:-2] == ["FT._DEBUG PROFILE START <dir> | STOP",
                              "torch.profiler trace capture"]
    return got


def _same_configs(b, argv):
    """The config listing: the reference's entries, then the port's own
    options (``PORT_OPTIONS``), which only the port lists."""
    want = b.jax.execute("FT._DEBUG", *argv)
    got = b.port.execute("FT._DEBUG", *argv)
    names_only = "NAMES_ONLY" in argv
    step = 1 if names_only else 2
    own = [n for n in range(0, len(got), step)
           if got[n] in tconfig.PORT_OPTIONS]
    assert [got[n] for n in own] == list(tconfig.PORT_OPTIONS)
    kept = [x for n, x in enumerate(got) if n - n % step not in own]
    assert kept == want
    return got


def test_ft_debug_replies_match_the_reference(text_both, monkeypatch):
    # the HELP row of PROFILE names each package's own profiler
    real = text_both.jax.execute

    def jax_execute(*argv, **kw):
        reply = real(*argv, **kw)
        if argv[:2] == ("FT._DEBUG", "HELP"):
            reply = ["torch.profiler trace capture" if x == "XLA trace capture"
                     else x for x in reply]
        return reply

    monkeypatch.setattr(text_both.jax, "execute", jax_execute)
    set_both("search.debug-mode", True)
    for argv in DEBUG_COMMANDS:
        _same_debug(text_both, argv)
    assert not CONTROLLED.list() and not PAUSEPOINTS.list()
    show = text_both.same("FT._DEBUG", "SHOW_INDEX", "i")
    shown = dict(zip(show[::2], show[1::2]))
    assert shown["name"] == "i" and shown["num_docs"] == 2
    # SHOW_INFO: the same fields; METRICS: counters of each package's own
    # history, the shared names present in both
    infos = [e.execute("FT._DEBUG", "SHOW_INFO") for e in text_both.engines]
    assert infos[1][::2] == infos[0][::2]
    names = [e.execute("FT._DEBUG", "LIST_METRICS", "APP", "NAMES_ONLY")
             for e in text_both.engines]
    assert all(isinstance(n, str) for n in names[1])
    values = text_both.port.execute("FT._DEBUG", "METRICS")
    assert values[::2] == names[1]
    assert {"queries_total", "mutations_enqueued"} & set(names[0]) <= \
        set(names[1])


def test_ft_debug_control_requires_debug_mode(text_both):
    set_both("search.debug-mode", False)
    for argv in (("PAUSEPOINT", "SET", "x"), ("CONTROLLED_VARIABLE", "LIST"),
                 ("TEST_COUNTER",), ("PROFILE", "START", "d"), ("RESET",)):
        got = text_both.same("FT._DEBUG", *argv)
        assert got == Errored(
            "FTDebugError",
            "FT._DEBUG control requires CONFIG SET search.debug-mode yes")
    # inspection needs no debug mode
    assert text_both.same("FT._DEBUG", "STRING_POOL_STATS")[1] == 2


def test_pausepoint_freezes_asynchronous_ingest():
    set_both("search.debug-mode", True)
    b = Both(sync_ingest=False)
    b.same("FT.CREATE", "i", "ON", "HASH", "PREFIX", "1", "k:", "SCHEMA", "t",
           "TAG")
    b.same("FT._DEBUG", "PAUSEPOINT", "SET", "ingest.before_apply")
    b.same("HSET", "k:1", "t", "a")
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline and \
            PAUSEPOINTS.waiting("ingest.before_apply") == 0:
        time.sleep(0.01)
    assert PAUSEPOINTS.waiting("ingest.before_apply") == 1
    assert b.port.execute("FT.SEARCH", "i", "@t:{a}", "NOCONTENT")[0] == 0
    b.same("FT._DEBUG", "PAUSEPOINT", "RESET", "ingest.before_apply")
    b.drain()
    assert b.same("FT.SEARCH", "i", "@t:{a}", "NOCONTENT") == [1, "k:1"]
    b.shutdown()


def test_profile_writes_a_torch_profiler_trace(tmp_path):
    set_both("search.debug-mode", True)
    e = Engine()
    e.execute("FT.CREATE", "i", "SCHEMA", "v", "VECTOR", "FLAT", "6", "TYPE",
              "FLOAT32", "DIM", "4", "DISTANCE_METRIC", "L2")
    for i in range(16):
        e.execute("HSET", f"k{i}", "v", np.full(4, i, np.float32).tobytes())
    out = tmp_path / "trace"
    with pytest.raises(FTDebugError, match="no PROFILE capture is running"):
        e.execute("FT._DEBUG", "PROFILE", "STOP")
    assert e.execute("FT._DEBUG", "PROFILE", "START", str(out)) == "OK"
    with pytest.raises(FTDebugError, match="already running"):
        e.execute("FT._DEBUG", "PROFILE", "START", str(out))
    e.execute("FT.SEARCH", "i", "*=>[KNN 2 @v $q]", "PARAMS", "2", "q",
              np.full(4, 3.2, np.float32).tobytes(), "NOCONTENT")
    assert e.execute("FT._DEBUG", "PROFILE", "STOP") == "OK"
    traces = os.listdir(out)
    assert len(traces) == 1 and traces[0].endswith(".json")
    assert os.path.getsize(out / traces[0]) > 1000
