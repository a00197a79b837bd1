"""Keyspace, expiry, hash-field expiry, JSON, MULTI, COPY and the memory cap.

The flows of ``test_expiry.py``, ``test_hfe.py``, ``test_json_datatype.py``,
``test_oom.py`` and the keyspace part of ``test_engine_e2e.py``: the same
argv goes through the JAX Engine and the port's, and the replies, error
types and error messages must be equal. ``time.time`` is replaced by one
hand-driven clock that both packages read, so deadlines fall at the same
instant in both; eviction draws from ``random``, seeded alike before each
engine's turn.
"""

import json
import random
import time

import numpy as np
import pytest

from valkey_search_tpu.runtime.metrics import STATS as JSTATS
from valkey_search_tpu_torch.runtime.device import set_device
from valkey_search_tpu_torch.runtime.metrics import STATS as TSTATS
from valkey_search_tpu_torch.server.engine import (
    CommandError,
    OutOfMemoryError,
    Transaction,
)
from torch_port_both import Both, Errored, outcome
from torch_port_config import saved_options, set_both


class Clock:
    def __init__(self, now=1_700_000_000.0):
        self.now = now

    def __call__(self):
        return self.now

    def advance(self, seconds):
        self.now += seconds


@pytest.fixture(autouse=True)
def clock(monkeypatch):
    set_device("cpu")
    c = Clock()
    monkeypatch.setattr(time, "time", c)
    with saved_options("search.max-memory-bytes", "search.maxmemory-policy",
                       "search.corpus-dtype"):
        set_both("search.corpus-dtype", "float32")
        yield c


@pytest.fixture
def both():
    b = Both()
    b.same("FT.CREATE", "i", "ON", "HASH", "PREFIX", "1", "k:", "SCHEMA", "t",
           "TAG", "n", "NUMERIC")
    b.same("HSET", "k:1", "t", "a", "n", "1")
    b.same("HSET", "k:2", "t", "a", "n", "2")
    return b


def _events(b):
    """Record the keyspace events each engine emits."""
    logs = ([], [])
    for e, log in zip(b.engines, logs):
        e.event_observer = lambda ev, key, klass, log=log: log.append(
            (ev, key, klass))
    return logs


# -- plain keyspace commands ------------------------------------------------------

KEYSPACE = [
    ("HGET", "k:1", "t"), ("HGET", "k:1", "nope"), ("HGET", "ghost", "t"),
    ("HGET", "k:1"), ("HMGET", "k:1", "t", "nope", "n"), ("HMGET", "k:1"),
    ("HGETALL", "k:1"), ("HGETALL", "ghost"), ("HGETALL",),
    ("EXISTS", "k:1", "k:2", "ghost"), ("EXISTS",), ("TYPE", "k:1"),
    ("TYPE", "ghost"), ("TYPE", "j:1"), ("KEYS", "*"), ("KEYS", "k:*"),
    ("KEYS", "?:1"), ("KEYS",), ("SCAN", "0"), ("SCAN", "0", "COUNT", "2"),
    ("SCAN", "2", "COUNT", "2"), ("SCAN", "0", "MATCH", "k:*", "COUNT", "50"),
    ("SCAN", "0", "TYPE", "hash"), ("SCAN", "0", "BOGUS", "1"),
    ("SCAN", "x"), ("HDEL", "k:1", "n"), ("HDEL", "k:1", "n"),
    ("HDEL", "k:1"), ("HDEL", "ghost", "f"), ("HDEL", "k:2", "t", "n"),
    ("EXISTS", "k:2"), ("DEL", "k:1", "ghost"), ("DEL",),
    ("HSET", "k:3", "t"), ("HSET", "k:3", "t", "b", "n", "x"),
    ("COPY", "k:3", "k:4"), ("COPY", "k:3", "k:4"),
    ("COPY", "k:3", "k:4", "REPLACE"), ("COPY", "ghost", "k:5"), ("COPY", "a"),
    ("JSON.GET", "j:1"), ("JSON.GET", "j:1", "$.a.b"), ("JSON.GET", "ghost"),
    ("JSON.GET",), ("JSON.SET", "j:1", "$"), ("JSON.SET", "j:2", "$", "{bad"),
    ("JSON.SET", "j:1", "$.a.c", "[1, 2]"), ("JSON.GET", "j:1", "$.a"),
    ("TTL", "k:3"), ("TTL",), ("EXPIRE", "k:3"), ("EXPIRE", "k:3", "x"),
    ("PERSIST", "k:3"), ("NOSUCH", "x"), ("MULTI",), ("EXEC",),
    ("FT.SEARCH", "i", "@t:{a|b}", "NOCONTENT"),
    ("FT.SEARCH", "i", "@n:[0 9]", "NOCONTENT"),
    ("FT.INFO", "i"),
]


def test_keyspace_commands_match_the_reference(both):
    both.same("JSON.SET", "j:1", "$", '{"a": {"b": 7}, "s": "x"}')
    logs = _events(both)
    for argv in KEYSPACE:
        both.same(*argv)
    assert logs[1] == logs[0] and logs[1]
    both.same()  # the empty command


def test_save_commands_are_what_stays_unported(both):
    # SAVE and BGSAVE are RESP server commands in both packages (server/
    # resp.py): Engine.execute answers them as the JAX Engine does
    for cmd in ("SAVE", "BGSAVE"):
        got = both.same(cmd)
        assert got.type == "CommandError" and "unknown command" in got.message
        with pytest.raises(CommandError, match="unknown command"):
            both.port.execute(cmd)


def test_copy_indexes_destination(both):
    both.same("FT.CREATE", "ci", "ON", "HASH", "PREFIX", "1", "c:", "SCHEMA",
              "t", "TAG")
    both.same("HSET", "c:src", "t", "gold")
    assert both.same("COPY", "c:src", "c:dst") == 1
    assert both.same("FT.SEARCH", "ci", "@t:{gold}", "NOCONTENT")[0] == 2
    both.same("HSET", "c:other", "t", "silver")
    assert both.same("COPY", "c:other", "c:dst") == 0
    assert both.same("COPY", "c:other", "c:dst", "REPLACE") == 1
    assert both.same("FT.SEARCH", "ci", "@t:{gold}", "NOCONTENT")[0] == 1
    assert both.same("FT.SEARCH", "ci", "@t:{silver}", "NOCONTENT")[0] == 2
    both.call("flushall")
    assert both.same("FT._LIST") == []
    assert both.same("KEYS", "*") == []


# -- key expiry ---------------------------------------------------------------------


def test_ttl_contract(both, clock):
    assert both.same("TTL", "missing") == -2
    assert both.same("TTL", "k:1") == -1
    assert both.same("EXPIRE", "k:1", "100") == 1
    clock.advance(10)
    assert both.same("TTL", "k:1") == 90.0
    assert both.same("PERSIST", "k:1") == 1
    assert both.same("PERSIST", "k:1") == 0
    assert both.same("TTL", "k:1") == -1
    assert both.same("EXPIRE", "missing", "5") == 0
    assert both.same("PEXPIRE", "k:1", "1500") == 1
    assert both.same("TTL", "k:1") == 1.5


def test_lazy_expiry_on_access(both, clock):
    logs = _events(both)
    both.same("PEXPIRE", "k:1", "10")
    clock.advance(0.03)
    assert both.same("HGETALL", "k:1") == {}
    assert both.same("FT.SEARCH", "i", "@t:{a}", "NOCONTENT") == [1, "k:2"]
    assert logs[1] == logs[0] == [("expire", "k:1", "g"),
                                  ("expired", "k:1", "x")]


def test_active_sweep_and_cron(both, clock):
    both.same("PEXPIRE", "k:1", "5")
    both.same("PEXPIRE", "k:2", "5")
    clock.advance(0.03)
    expired0 = TSTATS.get("keys_expired"), JSTATS.get("keys_expired")
    assert both.call("sweep_expired") == 2
    assert both.same("FT.SEARCH", "i", "@t:{a}", "NOCONTENT")[0] == 0
    assert TSTATS.get("keys_expired") - expired0[0] == 2
    assert JSTATS.get("keys_expired") - expired0[1] == 2
    both.same("HSET", "k:9", "t", "a")
    both.same("PEXPIRE", "k:9", "5")
    clock.advance(1)
    stats = both.call("cron")
    assert stats["expired"] == 1 and stats["backfilled"] == 0


def test_search_and_aggregate_never_return_expired(both, clock):
    both.same("PEXPIRE", "k:2", "5")
    clock.advance(0.03)
    # no access, no sweep: content resolution drops the key; the JAX
    # package still counts it, the port takes it out of the count too
    want = both.jax.execute("FT.SEARCH", "i", "@t:{a}")
    reply = both.port.execute("FT.SEARCH", "i", "@t:{a}")
    assert (want[0], reply[0]) == (2, 1) and reply[1:] == want[1:]
    assert "k:2" not in reply[1::2]
    both.same("HSET", "k:3", "t", "a", "n", "3")
    both.same("PEXPIRE", "k:3", "5")
    clock.advance(0.03)
    reply = both.same("FT.AGGREGATE", "i", "@t:{a}", "LOAD", "1", "@__key",
                      "GROUPBY", "1", "@t", "REDUCE", "COUNT", "0", "AS", "c")
    assert reply == [1, ["t", "a", "c", "1"]]


def test_write_after_expiry_reindexes(both, clock):
    both.same("PEXPIRE", "k:1", "5")
    clock.advance(0.03)
    both.call("sweep_expired")
    both.same("HSET", "k:1", "t", "b")
    assert both.same("TTL", "k:1") == -1
    assert both.same("FT.SEARCH", "i", "@t:{b}", "NOCONTENT") == [1, "k:1"]


def test_copy_carries_source_ttl(both, clock):
    both.same("HSET", "src", "f", "v")
    both.same("EXPIRE", "src", "50")
    assert both.same("COPY", "src", "dst") == 1
    assert both.same("TTL", "dst") == 50.0
    both.same("HSET", "gone", "f", "v")
    both.same("EXPIRE", "gone", "1")
    clock.advance(2)
    assert both.same("COPY", "gone", "dst2") == 0


def test_exists_type_keys_scan_hide_expired(both, clock):
    both.same("EXPIRE", "k:1", "1")
    clock.advance(2)
    assert both.same("EXISTS", "k:1") == 0
    both.same("HSET", "k:1", "t", "a")
    both.same("EXPIRE", "k:1", "1")
    clock.advance(2)
    assert both.same("TYPE", "k:1") == "none"
    both.same("HSET", "k:1", "t", "a")
    both.same("EXPIRE", "k:1", "1")
    clock.advance(2)
    assert both.same("KEYS", "*") == ["k:2"]
    both.same("HSET", "k:1", "t", "a")
    both.same("EXPIRE", "k:1", "1")
    clock.advance(2)
    assert both.same("SCAN", "0", "COUNT", "100") == ["0", ["k:2"]]


# -- hash-field expiry ----------------------------------------------------------------


def test_hash_field_expiration_updates_index(both, clock):
    logs = _events(both)
    both.same("HSET", "k:h", "t", "mytag", "n", "7")
    assert both.same("FT.SEARCH", "i", "@t:{mytag}")[0] == 1
    assert both.same("HEXPIRE", "k:h", "0.05", "FIELDS", "1", "t") == [1]
    clock.advance(0.08)
    assert both.call("sweep_expired") == 1
    assert both.same("FT.SEARCH", "i", "@t:{mytag}")[0] == 0
    assert both.same("FT.SEARCH", "i", "@n:[7 7]")[0] == 1
    info = both.same("FT.INFO", "i")
    assert dict(zip(info[::2], info[1::2]))["num_docs"] == 3
    assert both.same("HGETALL", "k:h") == {"n": "7"}
    assert logs[1] == logs[0]


def test_hexpire_last_field_deletes_key(both, clock):
    logs = _events(both)
    both.same("HSET", "k:solo", "t", "solo")
    both.same("HEXPIRE", "k:solo", "0.05", "FIELDS", "1", "t")
    clock.advance(0.08)
    both.call("sweep_expired")
    assert both.same("HGETALL", "k:solo") == {}
    assert both.same("FT.SEARCH", "i", "@t:{solo}")[0] == 0
    assert logs[1] == logs[0]
    assert ("hexpired", "k:solo", "g") in logs[1]


HFE_CONTRACT = [
    (("HEXPIRE", "ghost", "5", "FIELDS", "1", "t"), [-2]),
    (("HTTL", "k:1", "FIELDS", "2", "t", "nope"), [-1, -2]),
    (("HEXPIRE", "k:1", "100", "FIELDS", "1", "t"), [1]),
    (("HTTL", "k:1", "FIELDS", "1", "t"), [100]),
    (("HPTTL", "k:1", "FIELDS", "1", "t"), [100000]),
    (("HPERSIST", "k:1", "FIELDS", "1", "t"), [1]),
    (("HPERSIST", "k:1", "FIELDS", "1", "t"), [-1]),
    (("HPERSIST", "k:1", "FIELDS", "1", "nope"), [-2]),
    (("HPEXPIRE", "k:1", "400", "FIELDS", "1", "t"), [1]),
    (("HTTL", "k:1", "FIELDS", "1", "t"), [1]),  # rounds up
    (("HPTTL", "k:1", "FIELDS", "1", "t"), [400]),
    (("HEXPIRE", "k:1", "0", "FIELDS", "1", "t"), [2]),  # deleted at once
    (("HGETALL", "k:1"), {"n": "1"}),
    (("HEXPIRE", "k:1", "0", "FIELDS", "1", "n"), [2]),  # the last field
    (("EXISTS", "k:1"), 0),
    (("HEXPIRE", "k:2", "5", "FIELDS", "2", "t"), None),
    (("HEXPIRE", "k:2", "5", "FIELD", "1", "t"), None),
    (("HEXPIRE", "k:2", "FIELDS", "1", "t"), None),
    (("HTTL", "k:2"), None),
    (("HEXPIRE", "k:2", "x", "FIELDS", "1", "t"), None),
]


def test_hfe_contract(both):
    for argv, want in HFE_CONTRACT:
        got = both.same(*argv)
        if want is not None:
            assert got == want, argv
        else:
            assert isinstance(got, Errored), argv


def test_hset_clears_field_ttl_and_lazy_field_expiry(both, clock):
    both.same("HSET", "k:3", "t", "x")
    both.same("HEXPIRE", "k:3", "0.05", "FIELDS", "1", "t")
    both.same("HSET", "k:3", "t", "y")  # the rewrite clears the TTL
    clock.advance(0.08)
    both.call("sweep_expired")
    assert both.same("HGETALL", "k:3") == {"t": "y"}
    assert both.same("FT.SEARCH", "i", "@t:{y}")[0] == 1
    both.same("HSET", "k:4", "t", "zed", "n", "4")
    both.same("HEXPIRE", "k:4", "0.05", "FIELDS", "1", "t")
    clock.advance(0.08)
    # no sweep: the TTL read expires the field
    assert both.same("HTTL", "k:4", "FIELDS", "1", "t") == [-2]
    assert both.same("HGETALL", "k:4") == {"n": "4"}
    assert both.same("FT.SEARCH", "i", "@t:{zed}")[0] == 0


# -- JSON -----------------------------------------------------------------------------


@pytest.fixture
def jboth():
    rng = np.random.default_rng(3)
    b = Both()
    b.same("FT.CREATE", "jidx", "ON", "JSON", "PREFIX", "1", "j:", "SCHEMA",
           "$.vec", "AS", "vec", "VECTOR", "FLAT", "6", "TYPE", "FLOAT32",
           "DIM", "4", "DISTANCE_METRIC", "L2", "$.meta.color", "AS", "color",
           "TAG", "$.meta.price", "AS", "price", "NUMERIC", "$.title", "AS",
           "title", "TEXT")
    b.vecs = rng.standard_normal((20, 4)).astype(np.float32)
    for i, v in enumerate(b.vecs):
        b.same("JSON.SET", f"j:{i}", "$", json.dumps({
            "vec": [float(x) for x in v],
            "meta": {"color": ["red", "blue"][i % 2], "price": i},
            "title": f"document number {i} about searching"}))
    return b


def test_json_documents_match_the_reference(jboth):
    b = jboth
    q = b.vecs[7].tobytes()
    reply = b.close("FT.SEARCH", "jidx", "*=>[KNN 3 @vec $q]", "PARAMS", "2",
                    "q", q, "RETURN", "1", "__vec_score")
    assert reply[1] == "j:7"
    assert b.same("FT.SEARCH", "jidx", "@color:{red}", "NOCONTENT", "LIMIT",
                  "0", "50")[0] == 10
    b.same("FT.SEARCH", "jidx", "@price:[5 8]")
    assert b.same("FT.SEARCH", "jidx", "@title:searching", "NOCONTENT",
                  "LIMIT", "0", "50")[0] == 20
    # SORTBY projects the sort field beside '$'
    b.same("FT.SEARCH", "jidx", "@price:[5 8]", "SORTBY", "price", "DESC")
    b.same("FT.SEARCH", "jidx", "@price:[5 8]", "SORTBY", "price",
           "WITHSORTKEYS", "NOCONTENT")
    # a nested update moves the tag and leaves the vector
    b.same("JSON.SET", "j:3", "$.meta.color", '"gold"')
    assert b.same("FT.SEARCH", "jidx", "@color:{gold}", "NOCONTENT") == \
        [1, "j:3"]
    assert b.same("FT.SEARCH", "jidx", "*=>[KNN 1 @vec $q]", "PARAMS", "2",
                  "q", b.vecs[3].tobytes(), "NOCONTENT")[1] == "j:3"
    assert json.loads(b.same("JSON.GET", "j:1", "$.meta.color")) == "blue"
    assert json.loads(b.same("JSON.GET", "j:1"))["meta"]["price"] == 1
    assert b.same("JSON.GET", "nope") is None
    assert b.same("TYPE", "j:1") == "ReJSON-RL"
    b.same("DEL", "j:3")
    assert b.same("FT.SEARCH", "jidx", "@color:{gold}", "NOCONTENT")[0] == 0
    # no vector in the document: indexed by the rest, never a KNN result
    b.same("JSON.SET", "j:100", "$", json.dumps(
        {"title": "no vector here", "meta": {"color": "green", "price": 1}}))
    assert b.same("FT.SEARCH", "jidx", "@color:{green}", "NOCONTENT") == \
        [1, "j:100"]
    reply = b.same("FT.SEARCH", "jidx", "*=>[KNN 21 @vec $q]", "PARAMS", "2",
                   "q", b.vecs[0].tobytes(), "NOCONTENT")
    assert "j:100" not in reply[1:]
    b.same("COPY", "j:1", "j:copy")
    assert b.same("FT.SEARCH", "jidx", "@price:[1 1]", "NOCONTENT")[0] == 3


def test_hash_schema_ignores_json_docs_and_wildcard_tag_arrays():
    b = Both()
    b.same("FT.CREATE", "h", "ON", "HASH", "PREFIX", "1", "k:", "SCHEMA", "t",
           "TAG")
    b.same("JSON.SET", "k:1", "$", '{"t": "x"}')
    assert b.same("FT.SEARCH", "h", "@t:{x}", "NOCONTENT")[0] == 0
    b.same("HSET", "k:2", "t", "x")
    assert b.same("FT.SEARCH", "h", "@t:{x}", "NOCONTENT") == [1, "k:2"]
    b.same("FT.CREATE", "jw", "ON", "JSON", "PREFIX", "1", "j:", "SCHEMA",
           "$.tags[*]", "AS", "tags", "TAG", "$.items[*].color", "AS",
           "color", "TAG")
    b.call("json_set", "j:1", "$", json.dumps(
        {"tags": ["red", "sale"],
         "items": [{"color": "blue"}, {"color": "green"}]}))
    b.call("json_set", "j:2", "$", json.dumps(
        {"tags": ["sale"], "items": [{"color": "blue"}]}))
    assert b.same("FT.SEARCH", "jw", "@tags:{red}", "NOCONTENT") == [1, "j:1"]
    assert b.same("FT.SEARCH", "jw", "@tags:{sale}", "NOCONTENT")[0] == 2
    assert b.same("FT.SEARCH", "jw", "@color:{green}", "NOCONTENT") == \
        [1, "j:1"]
    assert b.same("FT.SEARCH", "jw", "@color:{blue}", "NOCONTENT")[0] == 2


# -- MULTI ------------------------------------------------------------------------------


def test_transaction_matches_the_reference(both):
    results = []
    for e in both.engines:
        tx = e.multi()
        tx.hset("k:10", {"t": "m", "n": "10"}).hset("k:11", {"t": "m"})
        tx.delete("k:1").json_set("j:t", "$", '{"a": 1}')
        n = tx.exec()
        results.append((n, sorted(e.keyspace), outcome(tx.exec)))
        dropped = e.multi().hset("k:12", {"t": "never"})
        dropped.discard()
        results[-1] += (outcome(dropped.exec),)
    assert results[1] == results[0]
    assert results[1][0] == 4
    assert isinstance(both.port.multi(), Transaction)
    assert both.same("FT.SEARCH", "i", "@t:{m}", "NOCONTENT") == \
        [2, "k:10", "k:11"]
    assert both.same("EXISTS", "k:1", "k:12", "j:t") == 1


# -- the memory cap -------------------------------------------------------------------


def _seeded(b, method, *args):
    """One Engine method on both, ``random`` seeded alike before each."""
    out = []
    for e in b.engines:
        random.seed(11)
        out.append(outcome(getattr(e, method), *args))
    assert out[1] == out[0], method
    return out[1]


def test_memory_pools_and_ft_info_memory_match(both):
    both.same("FT.CREATE", "txt", "ON", "HASH", "PREFIX", "1", "x:", "SCHEMA",
              "body", "TEXT", "t", "TAG")
    for i in range(40):
        both.same("HSET", f"x:{i}", "body",
                  " ".join(f"word{i}x{j}" for j in range(10)), "t",
                  f"A{i % 4}, b" if i % 5 else "  ")
    pools = both.call("memory_pools")
    assert pools["tag"] > 0 and pools["numeric"] > 0 and pools["text"] > 0
    assert pools["keyspace"] > 0
    assert both.call("used_memory_bytes") == sum(pools.values())
    # TAG user_indexed_memory, raw-value column included
    for index in ("i", "txt"):
        both.same("FT.INFO", index)


def test_writes_denied_above_cap(both):
    both.same("HSET", "k:big", "t", "a" * 100)
    used = both.call("used_memory_bytes")
    set_both("search.max-memory-bytes", max(1, used - 1))
    rejections0 = TSTATS.get("oom_rejections")
    for argv in (("HSET", "k:3", "t", "b"),
                 ("JSON.SET", "k:4", "$", '{"t": 1}'),
                 ("COPY", "k:1", "k:5")):
        assert both.same(*argv).type == "OutOfMemoryError", argv
    with pytest.raises(OutOfMemoryError, match="search.max-memory-bytes"):
        both.port.execute("HSET", "k:3", "t", "b")
    assert all(e.manager.get("i").paused_by_oom for e in both.engines)
    assert both.same("FT.SEARCH", "i", "@t:{a}", "NOCONTENT")[0] == 2
    both.same("DEL", "k:big")
    set_both("search.max-memory-bytes", 10_000_000)
    both.same("HSET", "k:3", "t", "b")
    assert not any(e.manager.get("i").paused_by_oom for e in both.engines)
    assert TSTATS.get("oom_rejections") - rejections0 >= 4
    info = [e.info(include_dev=True) for e in both.engines]
    for name in ("search_worker_pool_suspend_cnt",):
        assert info[1][name] >= 1


@pytest.mark.parametrize("policy", [
    "allkeys-random", "allkeys-lru", "allkeys-lfu", "volatile-ttl",
    "volatile-random", "volatile-lru", "volatile-lfu", "noeviction"])
def test_eviction_policy_matches_the_reference(policy):
    b = Both()
    b.same("FT.CREATE", "ev", "ON", "HASH", "PREFIX", "1", "k:", "SCHEMA",
           "t", "TAG", "n", "NUMERIC")
    for i in range(120):
        b.same("HSET", f"k:{i}", "t", "x" * 50, "n", str(i))
    for i in range(30):
        b.same("EXPIRE", f"k:{i}", str(10_000 + i))
    for _ in range(3):
        for i in range(100, 120):
            b.same("HGETALL", f"k:{i}")
    used = b.call("used_memory_bytes")
    set_both("search.maxmemory-policy", policy)
    set_both("search.max-memory-bytes", int(used * 0.9))
    evicted0 = TSTATS.get("keys_evicted")
    got = _seeded(b, "hset", "k:new", {"t": "fits", "n": "1"})
    survivors = [sorted(e.keyspace) for e in b.engines]
    assert survivors[1] == survivors[0]
    if policy == "noeviction":
        assert got[:2] == ("error", "OutOfMemoryError")
        assert len(survivors[1]) == 120
    else:
        assert got == ("ok", 2)
        assert TSTATS.get("keys_evicted") > evicted0
        assert len(survivors[1]) < 121
    if policy.startswith("volatile"):
        assert {f"k:{i}" for i in range(30, 120)} <= set(survivors[1])
    if policy == "volatile-ttl":
        assert "k:0" not in survivors[1]
    if policy in ("allkeys-lru", "allkeys-lfu"):
        assert {f"k:{i}" for i in range(100, 120)} <= set(survivors[1])
    # the indexes lost what the keyspace lost
    reply = b.same("FT.SEARCH", "ev", "@n:[0 1000]", "NOCONTENT", "LIMIT",
                   "0", "500")
    assert set(reply[1:]) <= set(survivors[1])
