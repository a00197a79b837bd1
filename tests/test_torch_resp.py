"""The port's RESP server against the JAX package's, byte for byte on the wire.

Each test starts a reference ``RespServer`` over a JAX Engine and a port
``RespServer`` over a port Engine on the CPU (``tests/torch_resp_pair.py``),
sends the same argv to both and compares the raw reply bytes, over the flows
of the reference's ``test_resp_server``, ``test_pubsub``, ``test_script``,
``test_lua`` (through EVAL), the standalone part of ``test_dbnum`` and the
checkpoint cases of ``test_versioning``: PING, ECHO, HELLO 2/3, inline
commands and binary HSET; KNN over the wire and concurrent connections
coalescing into one launch; error replies, MULTI/EXEC/EXECABORT, CONFIG
GET/SET and INFO; AUTH, requirepass and ACL; SELECT, SWAPDB and a multi-db
SAVE restored by either package; CLIENT ID/LIST/KILL of a connection whose
query is parked; FLUSHALL; pub/sub and keyspace notifications; EVAL, EVALSHA
and SCRIPT. Where a reply carries a value that differs by nature (HELLO's
connection id, INFO's memory and CPU figures), the rest of it is compared.
"""

import threading
import time

import numpy as np
import pytest

from valkey_search_tpu.server.engine import Engine as JaxEngine
from valkey_search_tpu_torch.query import batcher as tbatcher
from valkey_search_tpu_torch.runtime.device import set_device
from valkey_search_tpu_torch.runtime.metrics import STATS
from valkey_search_tpu_torch.server.engine import Engine
from valkey_search_tpu_torch.server import resp as resp_mod
from torch_port_config import saved_options
from torch_resp_pair import Pair, RawClient, ReplyError, parse

DIM = 8


@pytest.fixture(autouse=True)
def _cpu():
    set_device("cpu")


@pytest.fixture()
def pair():
    p = Pair().start()
    try:
        yield p
    finally:
        p.close()


def _wait(cond, timeout=30.0):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, "timed out"
        time.sleep(0.01)


def test_ping_echo_hello_inline_and_binary(pair):
    c = pair.client()
    assert c.same("PING") == "PONG"
    assert c.same("PING", b"\x00bin\xff") == b"\x00bin\xff"
    assert c.same("ECHO", "hello") == b"hello"
    c.same("PING", "a", "b")
    assert c.send_raw(b"PING\r\n") == "PONG"
    assert c.send_raw(b'ECHO "two words"\r\n') == b"two words"
    blob = np.arange(4, dtype=np.float32).tobytes() + b"\r\n\x00"
    assert c.same("HSET", "doc:1", "emb", blob, "title", "hi") == 2
    assert c.same("HGETALL", "doc:1") == [b"emb", blob, b"title", b"hi"]
    assert c.same("DBSIZE") == 1
    c.same("HGET", "doc:1", "nope")
    for proto in ("3", "2"):
        jax, port = (parse(r) for r in c.both("HELLO", proto))
        assert _hello(port) == _hello(jax)
        c.same("HGETALL", "missing")
        c.same("HGET", "doc:1", "nope")
        c.same("HMGET", "doc:1", "title", "nope")
        c.same("CONFIG", "GET", "search.reader-threads")
    c.same("HELLO", "4")
    assert c.same("QUIT") == "OK"
    for side in (c.jax, c.port):
        with pytest.raises(EOFError):
            side.cmd("PING")


def _hello(reply):
    """HELLO's reply without the connection id (a thread ident)."""
    if isinstance(reply, dict):
        return {k: v for k, v in reply.items() if k != b"id"}
    pairs = dict(zip(reply[::2], reply[1::2]))
    pairs.pop(b"id")
    return pairs


def _knn_pair(pair, rows=200):
    c = pair.client()
    c.same("CONFIG", "SET", "search.corpus-dtype", "float32")
    c.same("FT.CREATE", "idx", "ON", "HASH", "PREFIX", "1", "doc:",
           "SCHEMA", "emb", "VECTOR", "FLAT", "6", "TYPE", "FLOAT32", "DIM",
           str(DIM), "DISTANCE_METRIC", "L2", "tags", "TAG", "n", "NUMERIC")
    vecs = np.random.default_rng(3).standard_normal(
        (rows, DIM)).astype(np.float32)
    for i, v in enumerate(vecs):
        c.same("HSET", f"doc:{i}", "emb", v.tobytes(),
               "tags", "even" if i % 2 == 0 else "odd", "n", str(i))
    return c, vecs


def test_knn_over_the_wire(pair):
    with saved_options("search.corpus-dtype"):
        c, vecs = _knn_pair(pair)
        q = vecs[7].tobytes()
        reply = c.same("FT.SEARCH", "idx", "*=>[KNN 3 @emb $q]", "PARAMS",
                       "2", "q", q, "NOCONTENT", "DIALECT", "2")
        assert reply[:2] == [3, b"doc:7"]
        reply = c.same("FT.SEARCH", "idx", "@tags:{odd}=>[KNN 5 @emb $q]",
                       "PARAMS", "2", "q", q, "NOCONTENT")
        assert all(int(k.split(b":")[1]) % 2 for k in reply[1:])
        c.same("FT.SEARCH", "idx", "(@tags:{even} @n:[0 99])=>"
               "[KNN 4 @emb $q AS d]", "PARAMS", "2", "q", q, "NOCONTENT")
        c.same("FT.SEARCH", "idx", "@n:[10 20]", "SORTBY", "n", "DESC",
               "LIMIT", "0", "4")
        c.same("FT.AGGREGATE", "idx", "@n:[0 199]", "GROUPBY", "1", "@tags",
               "REDUCE", "COUNT", "0", "AS", "c", "SORTBY", "2", "@tags",
               "ASC")
        # distances are each package's own arithmetic: equal keys, close
        jax, port = (parse(r) for r in c.both(
            "FT.SEARCH", "idx", "*=>[KNN 5 @emb $q]", "PARAMS", "2", "q", q,
            "RETURN", "1", "__emb_score"))
        assert port[1::2] == jax[1::2]
        np.testing.assert_allclose(
            [float(r[1]) for r in port[2::2]],
            [float(r[1]) for r in jax[2::2]], rtol=1e-5, atol=1e-6)
        c.same("FT.INFO", "idx")
        c.same("FT._LIST")


def test_concurrent_connections_coalesce_into_one_launch(pair):
    """16 connections search at once while the first launch is held: the
    other 15 queue in the batcher and go out together; every connection
    gets the reply the reference server gives it."""
    with saved_options("search.corpus-dtype", "search.reader-threads"):
        c, vecs = _knn_pair(pair)
        # 16 reader threads (the pool starts at the first search): every
        # connection's search reaches the batcher
        c.same("CONFIG", "SET", "search.reader-threads", "4")
        index = pair.port.engine.manager.get("idx").attribute("emb").index
        calls, gate = [], threading.Event()
        real = index.search_batch

        def held(queries, k, **kw):
            calls.append(len(queries))
            if len(calls) == 1:
                gate.wait(30)
            return real(queries, k, **kw)

        index.search_batch = held
        coalesced = STATS.snapshot().get("query_batches_coalesced", 0)
        replies = {}

        def one(i):
            c = RawClient(pair.port.port)
            try:
                replies[i] = c.cmd("FT.SEARCH", "idx", "*=>[KNN 3 @emb $q]",
                                   "PARAMS", "2", "q", vecs[i].tobytes(),
                                   "NOCONTENT")
            finally:
                c.close()

        threads = [threading.Thread(target=one, args=(i,)) for i in range(16)]
        try:
            for t in threads:
                t.start()
            # the first launch is held; every other request waits queued
            _wait(lambda: calls and sum(
                len(q) for q in tbatcher._GLOBAL._queues.values())
                == 16 - calls[0])
        finally:
            gate.set()
            for t in threads:
                t.join(30)
        assert sum(calls) == 16 and len(calls) <= 2
        assert STATS.snapshot()["query_batches_coalesced"] > coalesced
        ref = RawClient(pair.jax.port)
        try:
            for i in range(16):
                assert replies[i] == ref.cmd(
                    "FT.SEARCH", "idx", "*=>[KNN 3 @emb $q]", "PARAMS", "2",
                    "q", vecs[i].tobytes(), "NOCONTENT")
        finally:
            ref.close()


def test_error_replies_and_transactions(pair):
    c = pair.client()
    for argv in (("NOSUCH",), ("FT.INFO", "ghost"), ("HSET", "k"),
                 ("EXEC",), ("DISCARD",), ("SELECT", "16"), ("SELECT", "x"),
                 ("SWAPDB", "0"), ("CLIENT", "NOPE"), ("CONFIG",),
                 ("CONFIG", "SET", "search.nope", "1"), ("ACL", "NOPE"),
                 ("FT.SEARCH", "ghost", "*"), ("EVAL", "return 1 +", "0"),
                 ("PUBSUB", "NOPE"), ("SCRIPT", "NOPE"),
                 ("FT.CREATE", "x", "SCHEMA", "v", "VECTOR", "FLAT", "6",
                  "TYPE", "FLOAT32", "DIM", "0", "DISTANCE_METRIC", "L2")):
        assert isinstance(c.same(*argv), ReplyError), argv
    assert c.same("MULTI") == "OK"
    assert c.same("HSET", "k1", "f", "1") == "QUEUED"
    c.same("HSET", "k2", "f", "2")
    c.same("DBSIZE")
    c.same("MULTI")
    assert c.same("EXEC") == [1, 1, 2]
    c.same("MULTI")
    c.same("HSET", "k3", "f", "3")
    assert c.same("DISCARD") == "OK"
    assert c.same("DBSIZE") == 2
    # strict queue order: a read after a write sees it
    c.same("HSET", "mk", "f", "old")
    c.same("MULTI")
    for argv in (("HSET", "mk", "f", "new"), ("HGETALL", "mk"),
                 ("DEL", "mk"), ("HGETALL", "mk"), ("HSET", "mk")):
        c.same(*argv)
    assert c.same("EXEC")[:4] == [0, [b"f", b"new"], 1, []]
    # a bad command at queue time aborts the whole transaction
    c.same("MULTI")
    c.same("NOSUCHCMD", "x")
    c.same("HSET", "ek", "f", "1")
    assert isinstance(c.same("EXEC"), ReplyError)
    assert c.same("EXISTS", "ek") == 0
    # FT.SEARCH inside MULTI runs inline
    c.same("FT.CREATE", "m", "SCHEMA", "emb", "VECTOR", "FLAT", "6", "TYPE",
           "FLOAT32", "DIM", "4", "DISTANCE_METRIC", "L2")
    blob = np.asarray([1, 0, 0, 0], np.float32).tobytes()
    c.same("MULTI")
    c.same("HSET", "v:1", "emb", blob)
    c.same("FT.SEARCH", "m", "*=>[KNN 1 @emb $q]", "PARAMS", "2", "q", blob)
    c.same("EXEC")


def test_config_info_and_command(pair):
    c = pair.client()
    with saved_options("search.timeout-ms"):
        c.same("CONFIG", "GET", "search.reader-threads")
        assert c.same("CONFIG", "SET", "search.timeout-ms", "1234") == "OK"
        assert c.same("CONFIG", "GET", "search.timeout-ms")[1] == b"1234"
        c.same("CONFIG", "GET", "search.*threads*")
        c.same("CONFIG", "GET", "search.nothing-matches-*")
        c.same("CONFIG", "RESETSTAT")
    assert c.same("INFO", "replication") == b"\r\n"
    c.same("INFO", "server")
    jax, port = (parse(r).decode().split("\r\n") for r in c.both("INFO"))
    assert [line.split(":")[0] for line in port] == \
        [line.split(":")[0] for line in jax]
    assert port[0] == "# search"
    assert c.same("COMMAND", "COUNT") == len(resp_mod._COMMANDS)
    c.same("COMMAND")
    c.same("COMMAND", "DOCS")
    c.same("FT.CREATE", "a", "ON", "HASH", "SCHEMA", "t", "TAG")
    assert c.same("FT._LIST") == [b"a"]
    assert c.same("FT.DROPINDEX", "a") == "OK"
    c.same("JSON.SET", "j:1", "$", '{"a": 1}')
    c.same("JSON.GET", "j:1")
    c.same("HSET", "e", "f", "v")
    c.same("EXPIRE", "e", "100")
    c.same("PERSIST", "e")
    c.same("TTL", "e")
    c.same("EXISTS", "e", "ghost")
    c.same("TYPE", "e")
    c.same("KEYS", "*")
    c.same("SCAN", "0", "COUNT", "10")


def test_auth_requirepass_and_acl(pair):
    c = pair.client()
    c.same("AUTH", "whatever")
    c.same("AUTH", "alice", "whatever")
    with saved_options("search.requirepass"):
        c.same("CONFIG", "SET", "search.requirepass", "sekret")
        gate = pair.client()
        for argv in (("DBSIZE",), ("FLUSHALL",), ("SHUTDOWN",),
                     ("AUTH", "wrong")):
            assert isinstance(gate.same(*argv), ReplyError)
        assert gate.same("AUTH", "sekret") == "OK"
        gate.same("DBSIZE")
        assert gate.same("RESET") == "RESET"
        gate.same("DBSIZE")
        hello = pair.client()
        jax, port = (parse(r) for r in hello.both("HELLO", "2", "AUTH",
                                                  "default", "sekret"))
        assert _hello(port) == _hello(jax)
        hello.same("DBSIZE")
        c.same("CONFIG", "SET", "search.requirepass", "")
    assert c.same("ACL", "WHOAMI") == b"default"
    c.same("ACL", "SETUSER", "bob", "on", ">pw1", "~doc:*")
    c.same("ACL", "LIST")
    c.same("ACL", "GETUSER", "bob")
    c.same("ACL", "CAT")
    c.same("AUTH", "bob", "bad")
    assert c.same("AUTH", "bob", "pw1") == "OK"
    assert c.same("ACL", "WHOAMI") == b"bob"
    c.same("FT.CREATE", "other", "PREFIX", "1", "x:", "SCHEMA", "t", "TAG")
    c.same("ACL", "SETUSER", "bob", "+@search")
    c.same("FT.CREATE", "other", "PREFIX", "1", "x:", "SCHEMA", "t", "TAG")
    c.same("FT.CREATE", "mine", "PREFIX", "1", "doc:", "SCHEMA", "t", "TAG")
    c.same("RESET")
    assert c.same("ACL", "DELUSER", "bob", "ghost") == 2


def test_select_swapdb_and_multidb_save_restore(pair, tmp_path):
    c = pair.client()
    c.same("HSET", "k", "f", "zero")
    assert c.same("SELECT", "1") == "OK"
    c.same("EXISTS", "k")
    c.same("HSET", "k", "f", "one")
    c.same("FT.CREATE", "idx1", "ON", "HASH", "SCHEMA", "f", "TAG")
    assert c.same("FT.SEARCH", "idx1", "@f:{one}", "NOCONTENT") == [1, b"k"]
    c.same("SELECT", "0")
    c.same("FT.SEARCH", "idx1", "@f:{one}", "NOCONTENT")
    assert c.same("SWAPDB", "0", "1") == "OK"
    assert c.same("HGET", "k", "f") == b"one"
    c.same("FT.SEARCH", "idx1", "@f:{one}", "NOCONTENT")
    c.same("SELECT", "1")
    c.same("RESET")
    c.same("HGET", "k", "f")
    c.same("SELECT", "3")
    c.same("FT.CREATE", "i3", "ON", "HASH", "SCHEMA", "f", "TAG")
    c.same("HSET", "b", "f", "db3")
    paths = {side: str(tmp_path / f"{side}.vstpu") for side in ("jax", "port")}
    assert parse(c.jax.cmd("SAVE", paths["jax"])) == "OK"
    assert parse(c.port.cmd("SAVE", paths["port"])) == "OK"
    # each package restores the other's checkpoint set
    for writer in ("jax", "port"):
        restored = Pair(JaxEngine(), Engine())
        restored.jax.load_all(paths[writer])
        restored.port.load_all(paths[writer])
        restored.start()
        try:
            r = restored.client()
            for db in ("0", "1", "3"):
                r.same("SELECT", db)
                r.same("DBSIZE")
                r.same("HGETALL", "k")
                r.same("HGETALL", "b")
                r.same("FT._LIST")
                r.same("FT.SEARCH", "idx1", "@f:{zero|one}", "NOCONTENT")
                r.same("FT.SEARCH", "i3", "@f:{db3}", "NOCONTENT")
        finally:
            restored.close()


def test_client_id_list_and_kill_of_a_parked_query(pair):
    """CLIENT KILL ID of a connection whose FT.SEARCH is parked inside its
    launch: the killed connection sees its socket close; the others go on."""
    with saved_options("search.corpus-dtype"):
        c, vecs = _knn_pair(pair, rows=16)
        victim, killer = pair.client(), pair.client()
        ids = victim.same("CLIENT", "ID")
        victim.same("CLIENT", "SETNAME", "victim")
        victim.same("CLIENT", "GETNAME")
        assert f"id={ids} name=victim".encode() in killer.same("CLIENT",
                                                               "LIST")
        gates = []
        for srv in (pair.jax, pair.port):
            index = srv.engine.manager.get("idx").attribute("emb").index
            gate, real = threading.Event(), index.search_batch
            parked = threading.Event()

            def held(queries, k, _real=real, _gate=gate, _parked=parked,
                     **kw):
                _parked.set()
                _gate.wait(30)
                return _real(queries, k, **kw)

            index.search_batch = held
            gates.append((gate, parked))
        for side in (victim.jax, victim.port):
            side.send_raw(b"*7\r\n$9\r\nFT.SEARCH\r\n$3\r\nidx\r\n$18\r\n"
                          b"*=>[KNN 1 @emb $q]\r\n$6\r\nPARAMS\r\n$1\r\n2\r\n"
                          b"$1\r\nq\r\n")
        try:
            # the query's last argument completes the command: it parks
            for side in (victim.jax, victim.port):
                side.send_raw(b"$%d\r\n" % (4 * DIM) + vecs[1].tobytes()
                              + b"\r\n")
            for _, parked in gates:
                assert parked.wait(30)
            assert killer.same("CLIENT", "KILL", "ID", str(ids)) == 1
            for side in (victim.jax, victim.port):
                with pytest.raises((EOFError, OSError)):
                    side.read()
                    side.cmd("PING")
        finally:
            for gate, _ in gates:
                gate.set()
        assert isinstance(killer.same("CLIENT", "KILL", "ID", "99999"),
                          ReplyError)
        killer.same("CLIENT", "KILL", "BAD")
        assert killer.same("PING") == "PONG"


def test_flushall_drops_indexes(pair):
    c = pair.client()
    c.same("FT.CREATE", "fidx", "SCHEMA", "n", "NUMERIC")
    c.same("HSET", "fk", "n", "1")
    assert c.same("FT._LIST") == [b"fidx"]
    assert c.same("FLUSHALL") == "OK"
    assert c.same("FT._LIST") == []
    assert c.same("DBSIZE") == 0
    c.same("HSET", "x", "n", "2")
    c.same("FLUSHDB")
    c.same("DBSIZE")


def _pushes(sub, n):
    out = []
    for _ in range(n):
        want, got = sub.jax.read(), sub.port.read()
        assert got == want
        out.append(parse(got))
    return out


def test_pubsub_and_keyspace_notifications(pair):
    c = pair.client()
    sub = pair.client()
    assert sub.same("SUBSCRIBE", "news") == [b"subscribe", b"news", 1]
    assert c.same("PUBLISH", "news", "hello") == 1
    assert _pushes(sub, 1) == [[b"message", b"news", b"hello"]]
    sub.same("PSUBSCRIBE", "n*")
    c.same("PUBLISH", "news", "two")
    _pushes(sub, 2)
    c.same("PUBSUB", "CHANNELS")
    c.same("PUBSUB", "NUMSUB", "news", "other")
    c.same("PUBSUB", "NUMPAT")
    # a RESP2 subscriber runs only the pub/sub family
    assert isinstance(sub.same("HSET", "k", "f", "v"), ReplyError)
    sub.same("PING")
    sub.same("UNSUBSCRIBE")
    sub.same("PUNSUBSCRIBE")
    sub.same("UNSUBSCRIBE")
    with saved_options("search.notify-keyspace-events"):
        c.same("CONFIG", "SET", "search.notify-keyspace-events", "KEA")
        ks = pair.client()
        ks.same("PSUBSCRIBE", "__key*@0__:*")
        c.same("HSET", "k1", "f", "v")
        c.same("EXPIRE", "k1", "100")
        c.same("DEL", "k1")
        events = _pushes(ks, 6)
        assert [e[2] for e in events] == [
            b"__keyspace@0__:k1", b"__keyevent@0__:hset",
            b"__keyspace@0__:k1", b"__keyevent@0__:expire",
            b"__keyspace@0__:k1", b"__keyevent@0__:del"]
        c.same("CONFIG", "SET", "search.notify-keyspace-events", "Kg")
        c.same("HSET", "k2", "f", "v")
        c.same("DEL", "k2")
        assert [e[2] for e in _pushes(ks, 1)] == [b"__keyspace@0__:k2"]
        c.same("CONFIG", "SET", "search.notify-keyspace-events", "")
    # RESP3 multiplexes pushes with replies
    r3 = pair.client()
    r3.both("HELLO", "3")
    r3.same("SUBSCRIBE", "chan")
    r3.same("HSET", "k3", "f", "v")
    c.same("PUBLISH", "chan", "x")
    _pushes(r3, 1)
    c.same("MULTI")
    c.same("SUBSCRIBE", "inside")
    c.same("DISCARD")


_SCRIPTS = [
    ("return 42", "0"),
    ("return 3.7", "0"),
    ("return 'pong'", "0"),
    ("return ARGV[1]", "0", "zz"),
    ("return {1, 'two', {3}, nil, 5}", "0"),
    ("return redis.status_reply('GOOD')", "0"),
    ("return redis.error_reply('boom')", "0"),
    ("return {err='MOVED 1 x'}", "0"),
    ("redis.call('HSET', KEYS[1], 'f', ARGV[1])\n"
     "redis.call('HSET', KEYS[2], 'f', ARGV[2])\n"
     "return redis.call('HGET', KEYS[2], 'f')", "2", "ka", "kb", "va", "vb"),
    ("redis.call('HSET', KEYS[1], 'f', 'x')\nredis.call('NOSUCHCMD')\n"
     "redis.call('HSET', KEYS[1], 'f', 'y')", "1", "kc"),
    ("return redis.call('HGET', 'kc', 'f')", "0"),
    ("local e = redis.pcall('NOSUCHCMD')\n"
     "if e.err then return e.err end return 'missed'", "0"),
    ("local e = redis.pcall('HSET', 'k')\nreturn e", "0"),
    ("for i=1,5 do redis.call('HSET', 'it:'..i, 'n', tostring(i)) end", "0"),
    ("local t = {}\nfor i=1,5 do\n"
     "  local v = redis.call('HGET', 'it:'..i, 'n')\n"
     "  if tonumber(v) % 2 == 1 then table.insert(t, v) end\nend\n"
     "return cjson.encode(t)", "0"),
    ("return cjson.decode('{\"a\": [1, 2, {\"b\": null}]}').a[2]", "0"),
    ("return string.format('%5.2f|%d|%s', 3.14159, 42, 'x')", "0"),
    ("local n = 0 for w in string.gmatch('a,b,c', '[^,]+') do n = n + 1 "
     "end return n", "0"),
    ("return {string.find('hello world', 'o w')}", "0"),
    ("local function f(n) if n < 2 then return n end return f(n-1) + "
     "f(n-2) end return f(15)", "0"),
    ("return bit.band(0xFF, 0x0F)", "0"),
    ("math.randomseed(42) return math.random(1000)", "0"),
    ("return -7 % 3", "0"),
    ("return tostring(1e20)", "0"),
    ("return redis.sha1hex('abc')", "0"),
    ("os.execute('rm -rf /tmp/x')", "0"),
    ("redis.call('EVAL', 'return 1', '0')", "0"),
    ("return {} + 1", "0"),
    ("return 1 +", "0"),
    ("return", "-1"),
    ("return KEYS", "5", "a"),
    ("return redis.call('FT._LIST')", "0"),
]


def test_eval_evalsha_and_script(pair):
    c = pair.client()
    for script in _SCRIPTS:
        c.same("EVAL", *script)
    # ingest then query inside one script: FT.* through redis.call
    c.same("EVAL", "return redis.call('FT.CREATE', 'idx', 'SCHEMA', "
           "'price', 'NUMERIC', 'title', 'TEXT', 'v', 'VECTOR', 'FLAT', '6', "
           "'TYPE', 'FLOAT32', 'DIM', '4', 'DISTANCE_METRIC', 'L2')", "0")
    blob = np.asarray([1, 2, 3, 4], np.float32).tobytes()
    reply = c.same(
        "EVAL", "redis.call('HSET', KEYS[1], 'price', '42', 'title', "
        "'hello world', 'v', ARGV[1])\n"
        "return redis.call('FT.SEARCH', 'idx', '*=>[KNN 1 @v $q]', "
        "'PARAMS', '2', 'q', ARGV[1], 'RETURN', '1', '__v_score')",
        "1", "doc:1", blob)
    # as inside EXEC, a script's writes reach the index when it ends
    assert reply == [0]
    reply = c.same("EVAL", "return redis.call('FT.SEARCH', 'idx', "
                   "'*=>[KNN 1 @v $q]', 'PARAMS', '2', 'q', ARGV[1], "
                   "'RETURN', '1', '__v_score')", "0", blob)
    assert reply == [1, b"doc:1", [b"__v_score", b"0.0"]]
    c.same("EVAL", "return redis.call('FT.SEARCH', 'idx', "
           "'@price:[40 50] @title:hello')", "0")
    c.same("EVAL", "return redis.call('FT.AGGREGATE', 'idx', '@price:[5 50]',"
           " 'LOAD', '1', 'price')", "0")
    sha = c.same("SCRIPT", "LOAD", "return redis.call('DBSIZE')")
    assert len(sha) == 40
    assert c.same("SCRIPT", "EXISTS", sha, "0" * 40) == [1, 0]
    c.same("EVALSHA", sha, "0")
    c.same("EVALSHA", "f" * 40, "0")
    c.same("SCRIPT", "LOAD", "return 1 +")
    c.same("SCRIPT", "FLUSH")
    assert c.same("SCRIPT", "EXISTS", sha) == [0]
    assert pair.port._script_ast_cache == {}
    c.same("EVAL", "return 1")


def test_shutdown_closes_the_listener(pair):
    c = pair.client()
    ports = (pair.jax.port, pair.port.port)
    assert c.same("SHUTDOWN") == "OK"
    _wait(lambda: pair.port._server is None and pair.jax._server is None)
    for port in ports:
        with pytest.raises(OSError):
            RawClient(port, timeout=5)
