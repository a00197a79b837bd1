"""The port's socket cluster against the JAX package's, reply for reply.

Each test starts a reference trio and a port trio (three ``NodeServer``s of
each package on ephemeral ports, mutual gossip; ``tests/torch_cluster_pair.py``)
with the same node ids, sends each command through both ``ClusterClient``s
or to the same node of each side over a raw RESP connection, and compares
replies (byte for byte on the raw path), error types and messages, with each
side's ports written as ``PORT<i>``. The flows are ``tests/test_transport.py``'s
that run on three nodes (create and route, fanout KNN, non-vector with LIMIT,
gossip without a client push, INFO fanout, partial results on a node down,
DROPINDEX, FT.AGGREGATE, single-slot indexes, FT.INTERNAL_UPDATE, MOVED,
CLUSTER SLOTS/SHARDS/NODES, a slot-map client, MULTI/EXEC and its query
guard, consistency and timeout controls, FT.INFO PRIMARY, DBSIZE and
FLUSHALL, SAVE and BGSAVE) and the cluster cases of ``test_dbnum``,
``test_info_fields`` and ``test_script``. The port's shards run on the CPU.
"""

import json
import os

import numpy as np
import pytest

from valkey_search_tpu.cluster import node as jnode
from valkey_search_tpu.cluster.metadata import encode_version
from valkey_search_tpu.persistence import load_engine as jload
from valkey_search_tpu.runtime import config as jconfig
from valkey_search_tpu.runtime import debug as jdebug
from valkey_search_tpu.runtime.metrics import STATS as JSTATS
from valkey_search_tpu_torch.persistence import load_engine as tload
from valkey_search_tpu_torch.runtime import config as tconfig
from valkey_search_tpu_torch.runtime import debug as tdebug
from valkey_search_tpu_torch.runtime.device import set_device
from valkey_search_tpu_torch.runtime.metrics import STATS as TSTATS
from torch_cluster_pair import TrioPair, wait
from torch_port_config import set_both

DIM = 8
DEBUG = (jdebug, tdebug)
STATS = (JSTATS, TSTATS)


@pytest.fixture(autouse=True)
def _clean():
    set_device("cpu")
    for dbg in DEBUG:
        dbg.reset_all()
    yield
    for dbg in DEBUG:
        dbg.reset_all()
    jconfig.REGISTRY.reset_all()
    tconfig.REGISTRY.reset_all()


@pytest.fixture()
def pair():
    p = TrioPair()
    try:
        yield p
    finally:
        p.close()


def _controlled(name, value):
    for dbg in DEBUG:
        if value is None:
            dbg.CONTROLLED.clear(name)
        else:
            dbg.CONTROLLED.set(name, value)


def _stat(name):
    return [s.get(name) for s in STATS]


def _mk_index(pair, dim=DIM):
    assert pair.same(
        "FT.CREATE", "idx", "ON", "HASH", "PREFIX", "1", "doc:", "SCHEMA",
        "emb", "VECTOR", "FLAT", "6", "TYPE", "FLOAT32", "DIM", str(dim),
        "DISTANCE_METRIC", "L2", "tags", "TAG") == "OK"


def _fill(pair, vecs, tags=lambda i: "even" if i % 2 == 0 else "odd"):
    for i, v in enumerate(vecs):
        assert pair.same("HSET", f"doc:{i}", "emb", v.tobytes(), "tags",
                         tags(i)) == 2


def _text(v):
    return v.decode() if isinstance(v, bytes) else v


def _num(key) -> int:
    return int((key.decode() if isinstance(key, bytes) else key).split(
        ":")[1])


def _keyspaces(pair):
    return [[sorted(n.engine.keyspace) for n in side.nodes]
            for side in pair.sides]


# -- create, route, fan out ---------------------------------------------------------


def test_create_converges_and_routes(pair):
    _mk_index(pair)
    for side in pair.sides:
        assert all("idx" in n.engine.ft_list() for n in side.nodes)
    vecs = np.random.default_rng(5).standard_normal((30, DIM)).astype(
        np.float32)
    _fill(pair, vecs)
    ks = _keyspaces(pair)
    assert ks[1] == ks[0] and all(k for k in ks[1])
    assert pair.same("HGETALL", "doc:3")[1] == vecs[3].tobytes()
    assert pair.same("EXISTS", *[f"doc:{i}" for i in range(30)]) == 30
    assert pair.same("EXISTS", "doc:1", "nope", "doc:2") == 2
    pair.same("HGET", "doc:7", "tags")
    pair.same("HMGET", "doc:7", "tags", "nope")
    pair.same("TYPE", "doc:7")
    pair.same("DEL", "doc:7", "doc:8", "nope")
    pair.same("FT._LIST")
    pair.same("PING")
    # the metadata entry, and so the gossiped fingerprint, is the same
    fps = pair.each(lambda side: [side.conn(i).cmd("_META.FP")
                                  for i in range(3)])
    assert len(set(fps)) == 1
    assert pair.jax.nodes[0].metadata.top_fingerprint() == (
        pair.port.nodes[0].metadata.top_fingerprint())


@pytest.mark.parametrize("route", ["client", "node0", "node2"])
def test_fanout_knn_equal_in_order(pair, route):
    _mk_index(pair)
    rng = np.random.default_rng(6)
    vecs = rng.standard_normal((60, DIM)).astype(np.float32)
    _fill(pair, vecs)
    pair.learned()
    if route == "client":
        def same(*argv, rtol=0.0):
            return pair.same(*argv, rtol=rtol)
    else:
        i = int(route[-1])

        def same(*argv, rtol=0.0):
            return pair.node_same(i, *argv, rtol=rtol)
    for _ in range(2):
        q = rng.standard_normal(DIM).astype(np.float32)
        gt = set(np.argsort(((vecs - q) ** 2).sum(1))[:10].tolist())
        reply = same("FT.SEARCH", "idx", "*=>[KNN 10 @emb $q]", "PARAMS",
                     "2", "q", q.tobytes(), "NOCONTENT")
        assert reply[0] == 10
        assert {_num(k) for k in reply[1:]} == gt
        reply = same("FT.SEARCH", "idx", "@tags:{odd}=>[KNN 5 @emb $q]",
                     "PARAMS", "2", "q", q.tobytes(), "NOCONTENT")
        assert all(_num(k) % 2 for k in reply[1:])
        # the distances each package computes agree to f32 rounding
        same("FT.SEARCH", "idx", "*=>[KNN 3 @emb $q]", "PARAMS", "2", "q",
             q.tobytes(), rtol=1e-5)
        same("FT.SEARCH", "idx", "*=>[KNN 3 @emb $q]", "PARAMS", "2", "q",
             q.tobytes(), "RETURN", "1", "__emb_score", rtol=1e-5)


@pytest.mark.parametrize("limit", [("0", "7"), ("5", "10"), ("38", "5"),
                                   ("0", "0")])
def test_nonvector_fanout_with_limit(pair, limit):
    _mk_index(pair)
    rng = np.random.default_rng(7)
    _fill(pair, rng.standard_normal((40, DIM)).astype(np.float32),
          tags=lambda i: "x")
    reply = pair.same("FT.SEARCH", "idx", "@tags:{x}", "LIMIT", *limit,
                      "NOCONTENT")
    assert reply[0] == 40
    pair.learned()
    pair.node_same(1, "FT.SEARCH", "idx", "@tags:{x}", "LIMIT", *limit,
                   "NOCONTENT")


def test_gossip_converges_without_client_push(pair):
    created = pair.each(lambda side: side.conn(0).cmd(
        "FT.CREATE", "gidx", "ON", "HASH", "SCHEMA", "t", "TAG"))
    assert created == "OK"
    for side in pair.sides:
        wait(lambda: all("gidx" in n.engine.ft_list() for n in side.nodes),
             what="gossip to carry gidx")
    entries = pair.each(lambda side: [
        sorted((k, e.version, e.fingerprint)
               for k, e in n.metadata.entries().items())
        for n in side.nodes])
    assert len({tuple(e) for e in entries}) == 1


@pytest.mark.parametrize("mode", ["CLUSTER", "PRIMARY", "LOCAL"])
def test_info_fanout_aggregates(pair, mode):
    _mk_index(pair)
    rng = np.random.default_rng(8)
    _fill(pair, rng.standard_normal((12, DIM)).astype(np.float32))
    info = pair.call("ft_info", "idx", mode)
    if mode != "LOCAL":
        d = dict(zip(info[::2], info[1::2]))
        assert int(d["num_docs"]) == 12
    pair.call("ft_info", "nope", mode)


def test_partial_results_on_node_down(pair):
    _mk_index(pair)
    rng = np.random.default_rng(9)
    vecs = rng.standard_normal((30, DIM)).astype(np.float32)
    _fill(pair, vecs)
    q = rng.standard_normal(DIM).astype(np.float32)
    argv = ("FT.SEARCH", "idx", "*=>[KNN 10 @emb $q]", "PARAMS", "2", "q",
            q.tobytes(), "NOCONTENT")
    for side in pair.sides:
        side.nodes[2].close()
    set_both("search.enable-partial-results", "yes")
    reply = pair.same(*argv)
    assert 0 < reply[0] <= 10
    set_both("search.enable-partial-results", "no")
    err = pair.same(*argv)
    assert err.type in ("EOFError", "ConnectionResetError", "ReplyError",
                        "BrokenPipeError")


def test_dropindex_converges(pair):
    _mk_index(pair)
    assert pair.same("FT.DROPINDEX", "idx") == "OK"
    for side in pair.sides:
        assert all("idx" not in n.engine.ft_list() for n in side.nodes)
    pair.same("FT.DROPINDEX", "idx")
    pair.same("FT.SEARCH", "idx", "*")


@pytest.mark.parametrize("argv", [
    ("*", "LOAD", "1", "@tags", "GROUPBY", "1", "@tags", "REDUCE", "COUNT",
     "0", "AS", "cnt", "SORTBY", "2", "@cnt", "DESC"),
    ("*", "GROUPBY", "1", "@tags", "REDUCE", "COUNT", "0", "AS", "cnt",
     "SORTBY", "2", "@tags", "ASC"),
    ("*=>[KNN 6 @emb $q]", "PARAMS", "2", "q", None, "LOAD", "1", "@tags",
     "GROUPBY", "1", "@tags", "REDUCE", "COUNT", "0", "AS", "n",
     "SORTBY", "2", "@tags", "ASC"),
])
def test_aggregate_fanout(pair, argv):
    _mk_index(pair)
    rng = np.random.default_rng(12)
    vecs = rng.standard_normal((30, DIM)).astype(np.float32)
    _fill(pair, vecs)
    argv = [vecs[3].tobytes() if a is None else a for a in argv]
    reply = pair.same("FT.AGGREGATE", "idx", *argv)
    if argv[0] == "*":
        rows = [dict(zip(r[::2], r[1::2])) for r in reply[1:]]
        assert {_text(r["tags"]): int(r["cnt"]) for r in rows} == {
            "even": 15, "odd": 15}
    pair.learned()
    pair.node_same(2, "FT.AGGREGATE", "idx", *argv)
    pair.same("FT.AGGREGATE", "nope", "*")


def test_single_slot_index_routing(pair):
    name = "idx{route}"
    assert pair.same("FT.CREATE", name, "ON", "HASH", "PREFIX", "1",
                     "doc{route}:", "SCHEMA", "tags", "TAG") == "OK"
    for i in range(8):
        pair.same("HSET", f"doc{{route}}:{i}", "tags", "x")
    before = _stat("single_slot_queries")
    assert pair.same("FT.SEARCH", name, "@tags:{x}", "NOCONTENT")[0] == 8
    assert _stat("single_slot_queries") == [b + 1 for b in before]
    owners = pair.each(lambda side: [
        i for i, n in enumerate(side.nodes)
        if n.slots[0] <= jnode.key_slot(name) < n.slots[1]])
    assert len(owners) == 1


def test_ft_internal_update_command(pair):
    _mk_index(pair)
    entry = pair.jax.nodes[0].metadata.entries()["idx"]
    raw = json.dumps({"name": "idx", "version": entry.version + 1,
                      "payload": entry.payload})
    assert pair.node_same(1, "FT.INTERNAL_UPDATE", raw) == 1
    pair.node_same(1, "FT.INTERNAL_UPDATE", raw)  # an older entry: 0
    versions = pair.each(lambda side: side.nodes[1].metadata.get(
        "idx").version)
    assert versions == entry.version + 1
    pair.node_same(1, "FT.INTERNAL_UPDATE", "not json")
    pair.node_same(1, "FT.INTERNAL_UPDATE")
    set_both("search.skip-corrupted-internal-update-entries", "yes")
    assert pair.node_same(1, "FT.INTERNAL_UPDATE", "not json") == 0


# -- the cluster surface over the wire -------------------------------------------------


def test_moved_redirect(pair):
    pair.learned()
    slot = jnode.key_slot("somekey")
    owner = next(i for i, n in enumerate(pair.port.nodes)
                 if n.slots[0] <= slot < n.slots[1])
    wrong = (owner + 1) % 3
    err = pair.node_same(wrong, "HSET", "somekey", "f", "v")
    assert str(err) == f"MOVED {slot} 127.0.0.1:PORT{owner}"
    pair.node_same(wrong, "HGETALL", "somekey")
    pair.node_same(wrong, "HSET")
    assert pair.node_same(owner, "HSET", "somekey", "f", "v") == 1
    pair.same("HGETALL", "somekey")


@pytest.mark.parametrize("sub", ["SLOTS", "SHARDS", "NODES", "MYID", "INFO",
                                 "NOPE"])
def test_cluster_command_surface(pair, sub):
    pair.learned()
    for i in range(3):
        pair.node_same(i, "CLUSTER", sub)
    if sub == "SLOTS":
        slots = pair.node_same(0, "CLUSTER", "SLOTS")
        covered = sorted((r[0], r[1]) for r in slots)
        assert covered[0][0] == 0 and covered[-1][1] == 16383


def test_slot_map_client_e2e(pair):
    """A redis-cluster client's bootstrap (CLUSTER SLOTS), per-key routing
    with MOVED, and FT.SEARCH fanout from any node."""
    pair.learned()
    slot_maps = []
    for side in pair.sides:
        c = side.conn(0)
        slot_maps.append([(r[0], r[1], int(r[2][1]))
                          for r in c.cmd("CLUSTER", "SLOTS")])
    for side, slot_map in zip(pair.sides, slot_maps):
        c = side.conn(0)
        assert c.cmd("FT.CREATE", "cidx", "ON", "HASH", "SCHEMA", "t",
                     "TAG") == "OK"
        for n in side.nodes:
            n.gossip_once()
        by_port = {n.port: side.conn(i) for i, n in enumerate(side.nodes)}
        for i in range(30):
            s = jnode.key_slot(f"k{i}")
            port = next(p for lo, hi, p in slot_map if lo <= s <= hi)
            assert by_port[port].cmd("HSET", f"k{i}", "t",
                                     "even" if i % 2 == 0 else "odd") == 1
    wait(lambda: pair.each(lambda side: side.conn(1).cmd(
        "FT.SEARCH", "cidx", "@t:{even}", "NOCONTENT", "LIMIT", "0",
        "0")[0]) == 15, what="the fanout to count 15")
    pair.node_same(2, "FT.SEARCH", "cidx", "@t:{odd}", "NOCONTENT", "LIMIT",
                   "0", "20")


def test_multi_exec_moved_in_transaction(pair):
    pair.learned()
    lo, hi = pair.port.nodes[0].slots
    key = next(f"mk{i}" for i in range(10000)
               if not lo <= jnode.key_slot(f"mk{i}") < hi)
    local = next(f"mk{i}" for i in range(10000)
                 if lo <= jnode.key_slot(f"mk{i}") < hi)
    assert pair.node_same(0, "MULTI") == "OK"
    pair.node_same(0, "HSET", key, "f", "1")
    pair.node_same(0, "HSET", local, "f", "2")
    res = pair.node_same(0, "EXEC")
    assert any("MOVED" in str(x) for x in res)
    for side in pair.sides:
        assert key not in side.nodes[0].engine.keyspace
        assert local in side.nodes[0].engine.keyspace


def test_multi_exec_query_guard_cme(pair):
    pair.same("FT.CREATE", "plainidx", "ON", "HASH", "PREFIX", "1", "pg:",
              "SCHEMA", "n", "NUMERIC")
    pair.node_same(0, "MULTI")
    pair.node_same(0, "FT.SEARCH", "plainidx", "@n:[0 10]")
    err = pair.node_same(0, "EXEC")
    assert "not supported in CME mode" in str(err)
    tag_idx = owner = None
    for t in range(200):
        name = "{t%d}idx" % t
        slot = jnode.key_slot(name)
        owner = next((i for i, n in enumerate(pair.port.nodes)
                      if n.slots[0] <= slot < n.slots[1]), None)
        if owner is not None:
            tag_idx = name
            break
    prefix = "{%s}d:" % tag_idx.split("}")[0][1:]
    pair.node_same(owner, "FT.CREATE", tag_idx, "ON", "HASH", "PREFIX", "1",
                   prefix, "SCHEMA", "n", "NUMERIC")
    pair.node_same(owner, "HSET", prefix + "1", "n", "3")
    pair.node_same(owner, "MULTI")
    pair.node_same(owner, "FT.SEARCH", tag_idx, "@n:[0 10]")
    assert pair.node_same(owner, "EXEC")[0][0] == 1
    non_owner = (owner + 1) % 3
    pair.node_same(non_owner, "MULTI")
    pair.node_same(non_owner, "FT.SEARCH", tag_idx, "@n:[0 10]")
    assert "not supported in CME mode" in str(
        pair.node_same(non_owner, "EXEC"))


def test_ft_search_consistency_controls(pair):
    pair.same("FT.CREATE", "cc", "ON", "HASH", "PREFIX", "1", "cc:",
              "SCHEMA", "n", "NUMERIC")
    for i in range(30):
        pair.same("HSET", f"cc:{i}", "n", str(i))
    assert pair.same("FT.SEARCH", "cc", "@n:[0 29]", "NOCONTENT")[0] == 30
    assert pair.same("FT.SEARCH", "cc", "@n:[0 29]", "NOCONTENT",
                     "CONSISTENT")[0] == 30
    _controlled("force_invalid_index_fingerprint", "yes")
    assert pair.same("FT.SEARCH", "cc", "@n:[0 29]", "NOCONTENT",
                     "INCONSISTENT")[0] == 30
    err = pair.same("FT.SEARCH", "cc", "@n:[0 29]", "NOCONTENT",
                    "CONSISTENT")
    assert err.message == "Index or slot consistency check failed"
    _controlled("force_invalid_index_fingerprint", None)
    _controlled("force_invalid_slot_fingerprint", "yes")
    pair.same("FT.SEARCH", "cc", "@n:[0 29]", "NOCONTENT", "CONSISTENT")
    pair.same("FT.SEARCH", "cc", "@n:[0 29]", "NOCONTENT", "INCONSISTENT")


def test_ft_search_partition_timeout_controls(pair):
    pair.same("FT.CREATE", "tc", "ON", "HASH", "PREFIX", "1", "tc:",
              "SCHEMA", "n", "NUMERIC")
    for i in range(12):
        pair.same("HSET", f"tc:{i}", "n", str(i))
    assert pair.same("FT.SEARCH", "tc", "@n:[0 11]", "NOCONTENT")[0] == 12
    base = [d.TEST_COUNTERS.get("ForceCancels") for d in DEBUG]
    _controlled("ForceTimeout", "yes")
    err = pair.same("FT.SEARCH", "tc", "@n:[0 11]", "NOCONTENT", "ALLSHARDS")
    assert "cancelled due to timeout" in err.message
    assert all(d.TEST_COUNTERS.get("ForceCancels") > b
               for d, b in zip(DEBUG, base))
    assert pair.same("FT.SEARCH", "tc", "@n:[0 11]", "NOCONTENT",
                     "SOMESHARDS")[0] == 0
    _controlled("ForceTimeout", None)
    assert pair.same("FT.SEARCH", "tc", "@n:[0 11]", "NOCONTENT")[0] == 12


def test_ft_info_primary_mode_and_retry(pair):
    pair.same("FT.CREATE", "index1", "ON", "HASH", "PREFIX", "1", "doc:",
              "SCHEMA", "price", "NUMERIC")
    for i in range(5):
        pair.same("HSET", f"doc:{i}", "price", str(10 + i))
    info = dict(zip(*(iter(pair.call("ft_info", "index1", "PRIMARY")),) * 2))
    assert info["mode"] == "primary" and int(info["num_docs"]) == 5
    for var, n in (("ForceIndexNotFoundError", 3), ("ForceRemoteFailCount", 1)):
        before = _stat("info_fanout_retries")
        _controlled(var, n)
        pair.call("ft_info", "index1", "PRIMARY")
        assert _stat("info_fanout_retries") == [b + n for b in before]
        _controlled(var, None)
    _controlled("ForceRemoteFailCount", 20)
    pair.call("ft_info", "index1", "PRIMARY")  # retries run out: the error


def test_ft_info_primary_attribute_gauges(pair):
    pair.same("FT.CREATE", "index2", "ON", "HASH", "PREFIX", "1", "ad:",
              "SCHEMA", "title", "TEXT", "body", "TEXT")
    pair.same("HSET", "ad:1", "title", "hello", "body", "world")
    pair.same("HSET", "ad:2", "title", "valkey")
    info = dict(zip(*(iter(pair.call("ft_info", "index2", "PRIMARY")),) * 2))
    assert int(info["num_docs"]) == 2


def test_dbsize_flushall_and_indexes_kept(pair):
    pair.same("FT.CREATE", "kidx", "ON", "HASH", "PREFIX", "1", "fk:",
              "SCHEMA", "n", "NUMERIC")
    for i in range(12):
        pair.same("HSET", f"fk:{i}", "n", str(i))
    assert pair.same("DBSIZE") == 12
    for i in range(3):
        pair.node_same(i, "DBSIZE")
    assert pair.same("FLUSHALL") == "OK"
    assert pair.same("DBSIZE") == 0
    for side in pair.sides:
        for n in side.nodes:
            assert "kidx" in [str(x) for x in n.engine.ft_list()]
            assert n.engine.manager.get("kidx").num_docs() == 0
    pair.same("FT.SEARCH", "kidx", "@n:[0 20]", "NOCONTENT")


def test_save_bgsave_over_wire(pair, tmp_path):
    pair.node_same(0, "FT.CREATE", "sidx", "ON", "HASH", "SCHEMA", "t", "TAG")
    lo, hi = pair.port.nodes[0].slots
    key = next(f"k{i}" for i in range(1000)
               if lo <= jnode.key_slot(f"k{i}") < hi)
    pair.node_same(0, "HSET", key, "t", "a")
    paths = [str(tmp_path / f"{name}.vstpu") for name in ("jax", "port")]
    for (jc, pc) in [pair.raw(0)]:
        assert jc.cmd("SAVE", paths[0]) == pc.cmd("SAVE", paths[1]) == b"+OK\r\n"
    pair.node_same(0, "SAVE")  # no checkpoint path: the same error
    # either file loads in either package
    for path in paths:
        for load in (jload, tload):
            e = load(path)
            assert "sidx" in e.ft_list() and e.hgetall(key)
    jc, pc = pair.raw(0)
    assert jc.cmd("BGSAVE", paths[0] + ".bg") == pc.cmd(
        "BGSAVE", paths[1] + ".bg")
    wait(lambda: all(os.path.exists(p + ".bg") for p in paths),
         what="BGSAVE files")


# -- cluster-mode cases of test_dbnum, test_info_fields, test_script -----------------


def test_dbnum_cluster(pair):
    pair.node_same(1, "SELECT", "1")
    pair.node_same(1, "FT.CREATE", "index1", "SCHEMA", "t", "TAG")
    pair.node_same(0, "FT.CREATE", "index0", "SCHEMA", "t", "TAG")
    for side in pair.sides:
        wait(lambda: all(
            n.engine.manager.list_names() == ["index0"]
            and n.resp.engine_for(1).manager.list_names() == ["index1"]
            for n in side.nodes), what="both dbs' indexes on every node")
    assert pair.node_same(0, "FT._LIST") == [b"index0"]
    assert pair.node_same(1, "FT._LIST") == [b"index1"]
    pair.node_same(2, "SELECT", "1")
    assert pair.node_same(2, "FT._LIST") == [b"index1"]
    pair.node_same(2, "SELECT", "0")
    versions = pair.each(lambda side: (
        side.nodes[0].metadata.get("index1").min_version,
        side.nodes[0].metadata.get("index0").min_version))
    assert versions == (encode_version(1, 1), encode_version(1, 0))
    slot = jnode.key_slot("0")
    owner = next(i for i, n in enumerate(pair.port.nodes)
                 if n.slots[0] <= slot < n.slots[1])
    pair.node_same(owner, "SELECT", "0")
    pair.node_same(owner, "HSET", "0", "t", "tag0")
    pair.node_same(owner, "SELECT", "1")
    pair.node_same(owner, "HSET", "0", "t", "tag1")
    assert pair.node_same(owner, "FT.SEARCH", "index1", "@t:{tag1}",
                          "NOCONTENT")[0] == 1
    assert pair.node_same(owner, "FT.SEARCH", "index1", "@t:{tag0}",
                          "NOCONTENT")[0] == 0
    pair.node_same(owner, "SELECT", "0")
    assert pair.node_same(owner, "FT.SEARCH", "index0", "@t:{tag0}",
                          "NOCONTENT")[0] == 1
    pair.node_same(owner, "SELECT", "1")
    pair.node_same(owner, "FT.DROPINDEX", "index1")
    for side in pair.sides:
        wait(lambda: all(n.resp.engine_for(1).manager.list_names() == []
                         for n in side.nodes), what="the drop of index1")


def test_cross_db_name_collision_and_drop_guards(pair):
    pair.node_same(0, "FT.CREATE", "guard", "SCHEMA", "t", "TAG")
    pair.node_same(0, "SELECT", "1")
    assert "already exists" in str(
        pair.node_same(0, "FT.CREATE", "guard", "SCHEMA", "t", "TAG"))
    pair.node_same(0, "SELECT", "0")
    assert pair.node_same(0, "FT._LIST") == [b"guard"]
    pair.node_same(0, "SELECT", "5")
    assert "not found" in str(pair.node_same(0, "FT.DROPINDEX", "guard"))
    pair.node_same(0, "SELECT", "0")
    assert pair.node_same(0, "FT.DROPINDEX", "guard") == "OK"
    pair.node_same(0, "FT.DROPINDEX")


def test_coordinator_partition_counters(pair):
    pair.same("FT.CREATE", "cidx", "ON", "HASH", "PREFIX", "1", "cd:",
              "SCHEMA", "n", "NUMERIC")
    for i in range(6):
        pair.same("HSET", f"cd:{i}", "n", str(i))
    s0 = _stat("coordinator_server_partition_successes")
    c0 = _stat("coordinator_client_partition_successes")
    assert pair.same("FT.SEARCH", "cidx", "@n:[0 3]", "NOCONTENT")[0] == 4
    assert _stat("coordinator_server_partition_successes") == [
        s + 3 for s in s0]
    assert _stat("coordinator_client_partition_successes") == [
        c + 3 for c in c0]


def test_eval_single_slot_restriction_cluster(pair):
    pair.node_same(0, "FT.CREATE", "fanidx", "ON", "HASH", "SCHEMA", "t",
                   "TAG")
    script = "return redis.call('FT.SEARCH', 'fanidx', '@t:{x}')"
    err = pair.node_same(0, "EVAL", script, "0")
    assert "single-slot" in str(err)
