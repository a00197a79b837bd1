"""The slice as a whole: the same commands through the JAX Engine and the port's.

FT.CREATE, 3,000 HSETs, DELs, updates and FT.SEARCH (NOCONTENT, RETURN,
LIMIT, full content) go through both engines' ``execute``; the replies must
agree (float32: equal keys, scores within rtol 1e-5; bfloat16: the keys at
recall >= 0.99), and the error probes must raise the same error types.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from valkey_search_tpu.server.engine import Engine as JaxEngine
from valkey_search_tpu_torch.runtime.device import set_device
from valkey_search_tpu_torch.server.engine import CommandError, Engine
from torch_port_config import saved_options, set_both

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIM, ROWS = 32, 3000


@pytest.fixture(autouse=True)
def _cpu_and_config():
    set_device("cpu")
    with saved_options("search.corpus-dtype"):
        yield


def _create(metric):
    return ("FT.CREATE", "idx", "ON", "HASH", "PREFIX", "1", "doc:", "SCHEMA",
            "v", "VECTOR", "FLAT", "6", "TYPE", "FLOAT32", "DIM", str(DIM),
            "DISTANCE_METRIC", metric)


def _both(rng, metric):
    engines = (JaxEngine(), Engine())
    rows = rng.standard_normal((ROWS, DIM)).astype(np.float32)
    for e in engines:
        assert e.execute(*_create(metric)) == "OK"
        for i, row in enumerate(rows):
            e.execute("HSET", f"doc:{i}", "v", row.tobytes(), "tag", str(i))
    deleted = [f"doc:{i}" for i in range(0, ROWS, 61)]
    updated = rng.standard_normal((40, DIM)).astype(np.float32)
    for e in engines:
        assert e.execute("DEL", *deleted) == len(deleted)
        for j, row in enumerate(updated):
            e.execute("HSET", f"doc:{j * 7 + 1}", "v", row.tobytes())
    return engines, set(deleted)


def _searches(q):
    blob = q.tobytes()
    knn = "*=>[KNN 10 @v $q]"
    return [
        ("FT.SEARCH", "idx", knn, "PARAMS", "2", "q", blob, "NOCONTENT"),
        ("FT.SEARCH", "idx", knn, "PARAMS", "2", "q", blob,
         "RETURN", "1", "__v_score"),
        ("FT.SEARCH", "idx", "*=>[KNN 10 @v $q AS dist]", "PARAMS", "2", "q",
         blob, "LIMIT", "2", "5"),
        ("FT.SEARCH", "idx", knn, "PARAMS", "2", "q", blob,
         "RETURN", "2", "v", "dist"),
    ]


def _same_reply(got, want):
    assert got[0] == want[0] and len(got) == len(want)
    for g, w in zip(got[1:], want[1:]):
        if isinstance(w, list):
            assert len(g) == len(w)
            for gv, wv in zip(g, w):
                if isinstance(wv, str) and wv[:1].isdigit() or \
                        isinstance(wv, str) and wv.startswith("-"):
                    np.testing.assert_allclose(float(gv), float(wv),
                                               rtol=1e-5)
                else:
                    assert gv == wv
        else:
            assert g == w


@pytest.mark.parametrize("metric", ["L2", "IP", "COSINE"])
def test_float32_replies_match(rng, metric):
    set_both("search.corpus-dtype", "float32")
    (jeng, teng), deleted = _both(rng, metric)
    for q in rng.standard_normal((4, DIM)).astype(np.float32):
        for cmd in _searches(q):
            want = jeng.execute(*cmd)
            got = teng.execute(*cmd)
            _same_reply(got, want)
            assert not deleted & set(x for x in got if isinstance(x, str))
    for cmd in (("FT.SEARCH", "idx", "*", "LIMIT", "0", "7", "NOCONTENT"),
                ("FT.SEARCH", "idx", "*", "LIMIT", "3", "2")):
        assert teng.execute(*cmd) == jeng.execute(*cmd)
    assert teng.execute("FT.INFO", "idx")[:14] == \
        jeng.execute("FT.INFO", "idx")[:14]
    assert teng.execute("FT._LIST") == jeng.execute("FT._LIST") == ["idx"]


@pytest.mark.parametrize("metric", ["L2", "IP", "COSINE"])
def test_bfloat16_keys_match(rng, metric):
    set_both("search.corpus-dtype", "bfloat16")
    (jeng, teng), deleted = _both(rng, metric)
    hits = total = 0
    for q in rng.standard_normal((8, DIM)).astype(np.float32):
        cmd = _searches(q)[0]
        want, got = jeng.execute(*cmd), teng.execute(*cmd)
        hits += len(set(got[1:]) & set(want[1:]))
        total += len(want) - 1
        assert not deleted & set(got[1:])
    assert hits / total >= 0.99


def test_updated_vector_found_first(rng):
    set_both("search.corpus-dtype", "float32")
    (jeng, teng), _ = _both(rng, "L2")
    probe = (np.arange(DIM, dtype=np.float32) - 10) / 7
    for e in (jeng, teng):
        e.execute("HSET", "doc:5", "v", probe.tobytes())
        reply = e.execute("FT.SEARCH", "idx", "*=>[KNN 3 @v $q]", "PARAMS",
                          "2", "q", probe.tobytes(), "RETURN", "1",
                          "__v_score")
        assert reply[1] == "doc:5"
        assert abs(float(reply[2][1])) <= 1e-4
    for e in (jeng, teng):
        assert e.execute("FT.DROPINDEX", "idx") == "OK"
        assert e.execute("FT._LIST") == []


def _error_type(engine, *argv):
    with pytest.raises(Exception) as info:
        engine.execute(*argv)
    return type(info.value).__name__


def test_error_probes_raise_the_same_types(rng):
    set_both("search.corpus-dtype", "float32")
    engines = (JaxEngine(), Engine())
    q = rng.standard_normal(DIM).astype(np.float32).tobytes()
    short = rng.standard_normal(DIM // 2).astype(np.float32).tobytes()
    probes = [
        ("FT.SEARCH", "nosuch", "*=>[KNN 3 @v $q]", "PARAMS", "2", "q", q),
        ("FT.SEARCH", "idx", "*=>[KNN 3 @v $q]", "PARAMS", "2", "q", short),
        ("FT.SEARCH", "idx", "*=>[KNN 3 @nope $q]", "PARAMS", "2", "q", q),
        ("FT.SEARCH", "idx", "*=>[KNN 3 @v $q]"),
        ("FT.CREATE", "idx", "SCHEMA", "v", "VECTOR", "FLAT", "2", "DIM", "4"),
        ("HSET", "doc:1", "v"),
    ]
    for e in engines:
        e.execute(*_create("L2"))
        e.execute("HSET", "doc:1", "v", q)
    for argv in probes:
        assert _error_type(engines[1], *argv) == _error_type(engines[0], *argv)


def test_unported_surface_raises_typed_errors(tmp_path):
    """Nothing of the Engine is left unported: SAVE and BGSAVE are RESP
    server commands in both packages, so ``execute`` answers them with the
    same error type and message as the JAX Engine, and ``save``/``load``
    round-trip in the port."""
    jeng, teng = JaxEngine(), Engine()
    for cmd in ("SAVE", "BGSAVE", "save", "bgsave"):
        want, got = (_error(e, cmd) for e in (jeng, teng))
        assert want[0] == "CommandError" and "unknown command" in want[1]
        assert got == want
    # the rest of the surface answers: keyspace, expiry, JSON, ACL, debug
    assert teng.execute("HSET", "k", "f", "1", "g", "2") == 2
    assert teng.execute("HDEL", "k", "f") == 1
    assert teng.execute("HGET", "k", "g") == "2"
    assert teng.execute("EXPIRE", "k", "100") == 1
    assert teng.execute("JSON.SET", "j", "$", '{"a": 1}') == "OK"
    assert teng.execute("FT._DEBUG", "STRING_POOL_STATS")[-1] == 2
    teng.acl.setuser("alice", "on", "~doc:*", "+@search")
    assert teng.execute("FT._LIST", user="alice") == []
    assert _error(teng, "MULTI") == _error(jeng, "MULTI")
    assert teng.execute("FT.CREATE", "h", "SCHEMA", "v", "VECTOR", "HNSW",
                        "6", "TYPE", "FLOAT32", "DIM", "4",
                        "DISTANCE_METRIC", "L2") == "OK"
    assert teng.execute("FT.CREATE", "t", "SCHEMA", "tag", "TAG", "n",
                        "NUMERIC", "title", "TEXT") == "OK"
    assert teng.execute("HSET", "d", "v", np.ones(4, np.float32).tobytes(),
                        "tag", "x", "n", "3", "title", "red fox") == 4
    path = str(tmp_path / "e.vstpu")
    assert teng.save(path) == {"schemas": 2, "keys": 3}
    back = Engine.load(path)
    assert back.execute("FT._LIST") == ["h", "t"]
    assert back.execute("FT.AGGREGATE", "t", "*", "GROUPBY", "1", "@tag",
                        "REDUCE", "COUNT", "0", "AS", "n") == [
        1, ["tag", "x", "n", "1"]]
    assert back.execute("FT.SEARCH", "h", "*=>[KNN 1 @v $q]", "PARAMS", "2",
                        "q", np.ones(4, np.float32).tobytes(),
                        "NOCONTENT") == [1, "d"]
    assert 0 < float(back.execute("TTL", "k")) <= 100


def _error(engine, *argv):
    try:
        engine.execute(*argv)
    except Exception as exc:  # noqa: BLE001 - the error is the outcome
        return type(exc).__name__, str(exc)
    return None


_GUARD = r"""
import sys

_BLOCKED = ("jax", "jaxlib", "valkey_search_tpu")

class _NoJax:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in _BLOCKED:
            raise ImportError("blocked: " + name)

sys.meta_path.insert(0, _NoJax())
import numpy as np
from valkey_search_tpu_torch.runtime.device import set_device
set_device("cpu")
from valkey_search_tpu_torch.server.engine import Engine
e = Engine()
e.execute("FT.CREATE", "i", "SCHEMA", "v", "VECTOR", "FLAT", "6", "TYPE",
          "FLOAT32", "DIM", "4", "DISTANCE_METRIC", "L2", "t", "TAG",
          "n", "NUMERIC", "title", "TEXT")
for i in range(5):
    e.execute("HSET", f"k{i}", "v", np.full(4, i, np.float32).tobytes(),
              "t", "even" if i % 2 == 0 else "odd", "n", str(i),
              "title", "running fox" if i < 3 else "sleeping dog")
q = np.full(4, 3.2, np.float32).tobytes()
reply = e.execute("FT.SEARCH", "i", "*=>[KNN 2 @v $q]", "PARAMS", "2", "q",
                  q, "NOCONTENT")
assert reply == [2, "k3", "k4"], reply
reply = e.execute("FT.SEARCH", "i", "(@t:{even} @n:[0 3])=>[KNN 2 @v $q]",
                  "PARAMS", "2", "q", q, "NOCONTENT")
assert reply == [2, "k2", "k0"], reply
reply = e.execute("FT.SEARCH", "i", "@title:run=>[KNN 5 @v $q]", "PARAMS",
                  "2", "q", q, "NOCONTENT")
assert reply == [3, "k2", "k1", "k0"], reply
reply = e.execute("FT.SEARCH", "i", "@title:run", "NOCONTENT")
assert reply[0] == 3 and set(reply[1:]) == {"k0", "k1", "k2"}, reply
reply = e.execute("FT.SEARCH", "i", "@n:[1 4]", "SORTBY", "n", "DESC",
                  "NOCONTENT")
assert reply == [4, "k4", "k3", "k2", "k1"], reply
reply = e.execute("FT.AGGREGATE", "i", "*=>[KNN 4 @v $q]", "PARAMS", "2", "q",
                  q, "LOAD", "1", "@t", "GROUPBY", "1", "@t", "REDUCE",
                  "COUNT", "0", "AS", "c", "SORTBY", "2", "@t", "ASC")
assert reply == [2, ["t", "even", "c", "2"], ["t", "odd", "c", "2"]], reply
reply = e.execute("FT.AGGREGATE", "i", "@n:[0 4]", "GROUPBY", "1", "@t",
                  "REDUCE", "COUNT", "0", "AS", "c")
assert reply == [2, ["t", "even", "c", "3"], ["t", "odd", "c", "2"]], reply
e.execute("FT.CREATE", "h", "ON", "HASH", "PREFIX", "1", "h:", "SCHEMA", "v",
          "VECTOR", "HNSW", "10", "TYPE", "FLOAT32", "DIM", "4",
          "DISTANCE_METRIC", "L2", "M", "4", "EF_CONSTRUCTION", "20")
for i in range(40):
    e.execute("HSET", f"h:{i}", "v", np.full(4, i, np.float32).tobytes())
for knn in ("[KNN 2 @v $q]", "[KNN 2 @v $q EF_RUNTIME 8]"):
    reply = e.execute("FT.SEARCH", "h", "*=>" + knn, "PARAMS", "2", "q", q,
                      "NOCONTENT")
    assert reply == [2, "h:3", "h:4"], reply
e.config_set("search.hnsw-scan-threshold", "0")  # the graph walk serves
reply = e.execute("FT.SEARCH", "h", "*=>[KNN 2 @v $q EF_RUNTIME 8]",
                  "PARAMS", "2", "q", q, "NOCONTENT")
assert reply == [2, "h:3", "h:4"], reply
a = Engine(sync_ingest=False)
a.execute("FT.CREATE", "i", "SCHEMA", "v", "VECTOR", "FLAT", "6", "TYPE",
          "FLOAT32", "DIM", "4", "DISTANCE_METRIC", "L2")
for i in range(5):
    a.execute("HSET", f"k{i}", "v", np.full(4, i, np.float32).tobytes())
a.drain()
reply = a.execute("FT.SEARCH", "i", "*=>[KNN 2 @v $q]", "PARAMS", "2", "q",
                  q, "NOCONTENT")
assert reply == [2, "k3", "k4"], reply
assert a.cron()["expired"] == 0
info = e.execute("INFO")
assert info["search_number_of_indexes"] == 2, info
assert info["search_aggregate_queries"] == 2, info
import os, socket, tempfile
from valkey_search_tpu_torch.server.resp import RespServer
srv = RespServer(e, port=0).start()
try:
    sock = socket.create_connection(("127.0.0.1", srv.port), timeout=30)
    argv = [b"FT.SEARCH", b"i", b"@t:{odd}=>[KNN 2 @v $q]", b"PARAMS", b"2",
            b"q", q, b"NOCONTENT"]
    sock.sendall(b"*%d\r\n" % len(argv) + b"".join(
        b"$%d\r\n%s\r\n" % (len(a), a) for a in argv))
    buf = b""
    while buf.count(b"\r\n") < 5:
        buf += sock.recv(4096)
    assert buf == b"*3\r\n:2\r\n$2\r\nk3\r\n$2\r\nk1\r\n", buf
    sock.close()
finally:
    srv.close()
path = os.path.join(tempfile.mkdtemp(), "e.vstpu")
e.save(path)
back = Engine.load(path)
reply = back.execute("FT.SEARCH", "i", "(@t:{even} @n:[0 3])=>[KNN 2 @v $q]",
                     "PARAMS", "2", "q", q, "NOCONTENT")
assert reply == [2, "k2", "k0"], reply
assert not [m for m in sys.modules if m.split(".")[0] in _BLOCKED]
print("no-jax-ok")
"""


def test_port_runs_with_jax_blocked():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", _GUARD], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "no-jax-ok" in proc.stdout


def test_a_delete_during_content_resolution_leaves_the_count():
    """A DEL that lands between the search and content resolution (injected
    by wrapping ``resolve_content``): the JAX package replies the count of
    its search snapshot beside the keys left (10 with 9); the port takes
    the dropped row out of the count too (9 with 9)."""
    from valkey_search_tpu.server import ft_search as jfts
    from valkey_search_tpu_torch.server import ft_search as tfts

    got = {}
    for mod, engine in ((jfts, JaxEngine()), (tfts, Engine())):
        engine.execute("FT.CREATE", "g", "ON", "HASH", "PREFIX", "1", "d:",
                       "SCHEMA", "grp", "TAG")
        for i in range(10):
            engine.execute("HSET", f"d:{i}", "grp", "a")
        real = mod.resolve_content

        def torn(eng, schema, resp, *args, _real=real, **kwargs):
            assert eng.execute("DEL", "d:3") == 1
            return _real(eng, schema, resp, *args, **kwargs)

        mod.resolve_content = torn
        try:
            got[mod] = engine.execute("FT.SEARCH", "g", "@grp:{a}",
                                      "NOCONTENT")
        finally:
            mod.resolve_content = real
    keys = sorted(f"d:{i}" for i in range(10) if i != 3)
    assert got[jfts][0] == 10 and sorted(got[jfts][1:]) == keys
    assert got[tfts][0] == 9 and sorted(got[tfts][1:]) == keys
