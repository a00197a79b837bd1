"""Checkpoints, the op journal and BGSAVE of the port, against the JAX package.

- A checkpoint written by either package loads in the other: the same
  commands build a FLAT and an HNSW index (2,000 x 16 each, TAG, NUMERIC
  and TEXT fields, deletes, updates, key and hash-field TTLs) in both
  packages; each saves, each file loads in both, and FT.SEARCH (KNN,
  hybrid, TEXT prefix and fuzzy, SORTBY), FT.AGGREGATE, FT.INFO, HGETALL
  and the TTLs answer alike (float32 corpus: equal keys, distances within
  rtol 1e-5; equal replies within one package). A JSON schema crosses too.
- The port's own round trip keeps doc ids, and under int8 and bfloat16
  answers what the saved engine answered; the first search after a restore
  publishes the whole store once.
- ``skip_vector_payload`` / ``search.skip-rdb-load``, refused files (bad
  magic, truncated, a future ``min_compat_version``, the
  ``override_min_version`` controlled variable) with the reference's error
  types and messages, and a failed load that leaves no index behind.
- The op journal: torn tail, files read across packages, TTL rebasing,
  ``truncate_upto``, and a kill -9 drill on a port server subprocess.
- BGSAVE through the port's RespServer: the forked child's point in time,
  suspended and resumed writers, an overlap refused, the thread route with
  ``search.bgsave-fork`` off, and a child that finishes while other
  threads hold every lock outside the fork barrier.
"""

import json
import os
import signal
import struct
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from valkey_search_tpu.persistence import checkpoint as jckpt
from valkey_search_tpu.persistence import journal as jjournal
from valkey_search_tpu.runtime.debug import CONTROLLED as JCONTROLLED
from valkey_search_tpu.server.engine import Engine as JaxEngine
from valkey_search_tpu_torch.persistence import checkpoint as tckpt
from valkey_search_tpu_torch.persistence import journal as tjournal
from valkey_search_tpu_torch.runtime import config as tconfig
from valkey_search_tpu_torch.runtime.debug import CONTROLLED as TCONTROLLED
from valkey_search_tpu_torch.runtime.device import set_device
from valkey_search_tpu_torch.runtime.metrics import STATS
from valkey_search_tpu_torch.server.engine import Engine
from valkey_search_tpu_torch.server.resp import RespServer
from torch_port_both import Both, outcome
from torch_port_config import saved_options, set_both
from torch_resp_pair import RawClient, parse

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIM, ROWS = 16, 2000
TITLES = ("running fast", "sleeping dog", "quick search engine",
          "runner wins", "sound of silence")


@pytest.fixture(autouse=True)
def _cpu():
    set_device("cpu")


def _wait(cond, timeout=30.0):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, "timed out"
        time.sleep(0.02)


# -- the two indexes, written by both packages --------------------------------


def _populate(both, rng):
    both.same("FT.CREATE", "flat", "ON", "HASH", "PREFIX", "1", "f:",
              "SCHEMA", "v", "VECTOR", "FLAT", "6", "TYPE", "FLOAT32",
              "DIM", str(DIM), "DISTANCE_METRIC", "L2", "cat", "TAG",
              "price", "NUMERIC", "title", "TEXT")
    both.same("FT.CREATE", "hnsw", "ON", "HASH", "PREFIX", "1", "h:",
              "SCHEMA", "v", "VECTOR", "HNSW", "10", "TYPE", "FLOAT32",
              "DIM", str(DIM), "DISTANCE_METRIC", "COSINE", "M", "8",
              "EF_CONSTRUCTION", "40", "cat", "TAG", "title", "TEXT")
    vecs = rng.standard_normal((ROWS, DIM)).astype(np.float32)
    for prefix in ("f:", "h:"):
        for i, v in enumerate(vecs):
            for e in both.engines:
                e.execute("HSET", f"{prefix}{i}", "v", v.tobytes(),
                          "cat", f"c{i % 7}", "price", str(i % 1000),
                          "title", TITLES[i % len(TITLES)])
    for prefix in ("f:", "h:"):
        both.same("DEL", *[f"{prefix}{i}" for i in range(0, 200, 3)])
        for i in range(300, 340):
            both.same("HSET", f"{prefix}{i}", "v",
                      vecs[(i + 900) % ROWS].tobytes(), "cat", "moved",
                      "title", "updated document")
    both.same("EXPIRE", "f:10", "1000")
    both.same("HEXPIRE", "h:11", "2000", "FIELDS", "1", "title")
    return vecs


def _info_counts(reply):
    """FT.INFO's counts: num_docs, num_records and each attribute's
    num_records (an index's memory depends on its insertion history, which
    a restore replays differently)."""
    info = dict(zip(reply[::2], reply[1::2]))
    return (info["num_docs"], info["num_records"],
            [a[:8] for a in info["attributes"]])


def _suite(both, vecs, rtol=1e-5, whole_info=True):
    """The query suite through ``both``: an equal outcome in the two
    engines, distances within ``rtol``; FT.INFO whole, or its counts."""
    q = vecs[33].tobytes()
    for index, ef in (("flat", ""), ("hnsw", " EF_RUNTIME 50")):
        both.close("FT.SEARCH", index, f"*=>[KNN 10 @v $q{ef}]", "PARAMS",
                   "2", "q", q, "RETURN", "1", "__v_score", rtol=rtol)
        both.close("FT.SEARCH", index, f"@cat:{{c3}}=>[KNN 5 @v $q{ef}]",
                   "PARAMS", "2", "q", q, "RETURN", "1", "__v_score",
                   rtol=rtol)
        both.same("FT.SEARCH", index, "@title:run*", "NOCONTENT", "LIMIT",
                  "0", "50")
        both.same("FT.SEARCH", index, "@title:%dgo%", "NOCONTENT", "LIMIT",
                  "0", "50")
        if whole_info:
            both.same("FT.INFO", index)
        else:
            assert (_info_counts(both.port.execute("FT.INFO", index))
                    == _info_counts(both.jax.execute("FT.INFO", index)))
    both.close("FT.SEARCH", "flat", "(@cat:{c2} @price:[0 499])=>"
               "[KNN 5 @v $q]", "PARAMS", "2", "q", q, "RETURN", "1",
               "__v_score", rtol=rtol)
    both.same("FT.SEARCH", "flat", "@price:[100 200]", "SORTBY", "price",
              "DESC", "RETURN", "1", "price", "LIMIT", "0", "20")
    both.same("FT.AGGREGATE", "flat", "@price:[0 999]", "GROUPBY", "1",
              "@cat", "REDUCE", "COUNT", "0", "AS", "n", "SORTBY", "2",
              "@cat", "ASC")
    for key in ("f:1", "f:3", "f:301", "h:5", "h:11", "h:320", "f:10"):
        both.same("HGETALL", key)
    both.close("TTL", "f:10", rtol=1e-3)
    both.close("HTTL", "h:11", "FIELDS", "1", "title", rtol=1e-3)
    both.same("TTL", "f:1")
    both.same("FT._LIST")


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    set_device("cpu")
    with saved_options("search.corpus-dtype"):
        set_both("search.corpus-dtype", "float32")
        both = Both()
        vecs = _populate(both, np.random.default_rng(5))
        d = tmp_path_factory.mktemp("ckpt")
        paths = {"jax": str(d / "jax.vstpu"), "port": str(d / "port.vstpu")}
        assert both.jax.save(paths["jax"]) == both.port.save(paths["port"])
        yield both, vecs, paths
        both.shutdown()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_loads_in_either_package(saved, writer):
    both, vecs, paths = saved
    with saved_options("search.corpus-dtype"):
        set_both("search.corpus-dtype", "float32")
        # the two engines that wrote the files answer alike
        _suite(both, vecs)
        restored = Both.of(JaxEngine.load(paths[writer]),
                           Engine.load(paths[writer]))
        _suite(restored, vecs)
        # against the engine that wrote it, within its own package
        writer_pair = (Both.of(both.jax, restored.jax) if writer == "jax"
                       else Both.of(restored.port, both.port))
        _suite(writer_pair, vecs, rtol=0, whole_info=False)


def test_both_packages_write_the_same_sections(saved):
    _, _, paths = saved
    from valkey_search_tpu_torch.persistence.format import ChunkReader

    def sections(path):
        """Each section's header and arrays; a TTL's absolute deadline
        (set when each engine ran its EXPIRE) to the second."""
        out = []
        with ChunkReader(path) as r:
            for meta, arrays in r.sections():
                if meta["type"] in ("expiry", "field_expiry"):
                    arrays = arrays[:-1] + [np.round(arrays[-1])]
                out.append((json.dumps(meta, sort_keys=True),
                            [a.tobytes() for a in arrays]))
        return out

    assert sections(paths["port"]) == sections(paths["jax"])


def test_round_trip_keeps_doc_ids(saved, tmp_path):
    both, _, paths = saved
    restored = Engine.load(paths["port"])
    for name in ("flat", "hnsw"):
        s1 = both.port.manager.get(name)
        s2 = restored.manager.get(name)
        assert dict(s2.interner.items()) == dict(s1.interner.items())
        assert s2.interner.capacity == s1.interner.capacity
        assert s2.mutation_epoch == s1.mutation_epoch
        i1, i2 = s1.attribute("v").index, s2.attribute("v").index
        assert i2._tracked == i1._tracked
        np.testing.assert_array_equal(i2.store.vectors, i1.store.vectors)
    hnsw = restored.manager.get("hnsw").attribute("v").index
    assert hnsw._device_graph is None and hnsw._graph_dirty
    assert (hnsw.builder.export_graph()["count"]
            == both.port.manager.get("hnsw").attribute("v").index
            .builder.export_graph()["count"])


@pytest.mark.parametrize("dtype", ["int8", "bfloat16"])
def test_restore_answers_as_the_saved_engine(tmp_path, rng, dtype):
    with saved_options("search.corpus-dtype"):
        tconfig.set_config("search.corpus-dtype", dtype)
        e = Engine()
        e.execute("FT.CREATE", "i", "SCHEMA", "v", "VECTOR", "FLAT", "6",
                  "TYPE", "FLOAT32", "DIM", str(DIM), "DISTANCE_METRIC",
                  "L2", "t", "TAG")
        vecs = rng.standard_normal((ROWS, DIM)).astype(np.float32)
        for i, v in enumerate(vecs):
            e.execute("HSET", f"k{i}", "v", v.tobytes(), "t", f"t{i % 5}")
        queries = [vecs[i].tobytes() for i in range(0, 400, 40)]

        def replies(engine):
            return [engine.execute("FT.SEARCH", "i", flt, "PARAMS", "2",
                                   "q", q, "RETURN", "1", "__v_score")
                    for q in queries
                    for flt in ("*=>[KNN 10 @v $q]",
                                "@t:{t2}=>[KNN 10 @v $q]")]

        before = replies(e)
        path = str(tmp_path / "d.vstpu")
        e.save(path)
        r = Engine.load(path)
        st = r.manager.get("i").attribute("v").index.store
        assert st._device is None
        uploads = STATS.snapshot().get("vector_store_full_uploads", 0)
        after = replies(r)
        assert STATS.snapshot()["vector_store_full_uploads"] == uploads + 1
        assert st._device["vectors"].device.type == "cpu"
        if dtype == "int8":
            # one full publish of the same rows on each side: one scale
            saved_st = e.manager.get("i").attribute("v").index.store
            assert (float(st._device["i8_scale"])
                    == float(saved_st._device["i8_scale"]))
        assert after == before


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_json_schema_crosses_packages(tmp_path, rng, writer):
    with saved_options("search.corpus-dtype"):
        set_both("search.corpus-dtype", "float32")
        both = Both()
        both.same("FT.CREATE", "j", "ON", "JSON", "PREFIX", "1", "j:",
                  "SCHEMA", "$.v", "AS", "v", "VECTOR", "FLAT", "6", "TYPE",
                  "FLOAT32", "DIM", "8", "DISTANCE_METRIC", "COSINE",
                  "$.tags[*]", "AS", "t", "TAG", "$.score", "AS", "s",
                  "NUMERIC")
        vecs = rng.standard_normal((60, 8)).astype(np.float32)
        for i, v in enumerate(vecs):
            both.same("JSON.SET", f"j:{i}", "$", json.dumps({
                "v": [float(x) for x in v],
                "tags": ["a", "b"] if i % 2 else ["c"], "score": i}))
        path = str(tmp_path / "j.vstpu")
        getattr(both, writer).save(path)
        restored = Both.of(JaxEngine.load(path), Engine.load(path))
        q = vecs[7].tobytes()
        for pair in (restored, both):
            pair.close("FT.SEARCH", "j", "(@t:{c})=>[KNN 5 @v $q]",
                       "PARAMS", "2", "q", q, "RETURN", "1", "__v_score")
            pair.same("FT.SEARCH", "j", "@s:[10 12]", "NOCONTENT")
            pair.same("JSON.GET", "j:3")
        restored.same("JSON.SET", "j:new", "$", json.dumps({
            "v": [float(x) for x in vecs[0]], "tags": ["zz"], "score": 999}))
        restored.same("FT.SEARCH", "j", "@t:{zz}", "NOCONTENT")


@pytest.mark.parametrize("how", ["argument", "config"])
def test_skip_vector_payload_rebuilds_through_ingest(saved, how):
    both, vecs, paths = saved
    with saved_options("search.skip-rdb-load", "search.corpus-dtype"):
        set_both("search.corpus-dtype", "float32")
        if how == "config":
            set_both("search.skip-rdb-load", True)
            pair = Both.of(JaxEngine.load(paths["jax"]),
                           Engine.load(paths["jax"]))
        else:
            pair = Both.of(JaxEngine.load(paths["jax"],
                                          skip_vector_payload=True),
                           Engine.load(paths["jax"], skip_vector_payload=True))
        _suite(pair, vecs)
        # the vector rows were re-ingested, not imported
        idx = pair.port.manager.get("flat").attribute("v").index
        assert idx.count() == both.port.manager.get("flat") \
            .attribute("v").index.count()
        q = vecs[33].tobytes()
        want = both.port.execute("FT.SEARCH", "flat", "*=>[KNN 10 @v $q]",
                                 "PARAMS", "2", "q", q, "NOCONTENT")
        assert pair.port.execute("FT.SEARCH", "flat", "*=>[KNN 10 @v $q]",
                                 "PARAMS", "2", "q", q, "NOCONTENT") == want


def _load_outcomes(path):
    return [outcome(JaxEngine.load, path), outcome(Engine.load, path)]


@pytest.mark.parametrize("damage", ["magic", "truncated", "future"])
def test_refused_files_raise_the_reference_errors(saved, tmp_path, damage):
    _, _, paths = saved
    p = tmp_path / f"{damage}.vstpu"
    if damage == "magic":
        p.write_bytes(b"NOTAMAGIC trailing garbage")
    elif damage == "truncated":
        raw = open(paths["port"], "rb").read()
        p.write_bytes(raw[: len(raw) // 2])
    else:
        p.write_bytes(b"VSTPURDB" + struct.pack("<II", 99, 99)
                      + struct.pack("<I", 0))
    jax, port = _load_outcomes(str(p))
    assert jax[0] == "error" and jax[1] == "FormatError"
    assert port == jax


def test_override_min_version_controlled_variable(tmp_path):
    with saved_options("search.debug-mode"):
        set_both("search.debug-mode", True)
        _override_min_version(tmp_path)


def _override_min_version(tmp_path):
    pair = Both()
    pair.same("FT.CREATE", "i", "SCHEMA", "n", "NUMERIC")
    pair.same("HSET", "d:1", "n", "1")
    paths = [str(tmp_path / f"{side}.vstpu") for side in ("jax", "port")]
    for value in ("7", "-1"):
        pair.same("FT._DEBUG", "CONTROLLED_VARIABLE", "SET",
                  "override_min_version", value)
        for e, path in zip(pair.engines, paths):
            e.save(path)
        JCONTROLLED.clear("override_min_version")
        TCONTROLLED.clear("override_min_version")
        outcomes = [_load_outcomes(path) for path in paths]
        assert outcomes[0][0][0] == outcomes[1][1][0]
        if value == "7":
            for (jax, port) in outcomes:
                assert jax[:2] == ("error", "FormatError")
                assert port == jax
                assert "requires format >= 7" in jax[2]
        else:
            assert all(o[0] == "ok" for pair_ in outcomes for o in pair_)


def test_a_failed_load_leaves_no_index(tmp_path, rng):
    both = Both()
    for j in range(2):
        both.same("FT.CREATE", f"idx{j}", "ON", "HASH", "PREFIX", "1",
                  f"d{j}:", "SCHEMA", "v", "VECTOR", "HNSW", "6", "TYPE",
                  "FLOAT32", "DIM", "4", "DISTANCE_METRIC", "L2",
                  "n", "NUMERIC")
        for i in range(4):
            both.same("HSET", f"d{j}:{i}", "v",
                      rng.standard_normal(4).astype(np.float32).tobytes(),
                      "n", str(i))
    path = str(tmp_path / "u.vstpu")
    both.port.save(path)
    data = bytearray(open(path, "rb").read())
    kind = data.find(b'"kind"', data.find(b'"name": "idx1"'))
    data[kind + 1: kind + 5] = b"kinq"
    open(path, "wb").write(bytes(data))
    targets = (JaxEngine(), Engine())
    got = [outcome(mod.load_engine, path, engine=t)
           for mod, t in zip((jckpt, tckpt), targets)]
    assert got[0][0] == "error" and got[1] == got[0]
    assert [t.ft_list() for t in targets] == [[], []]
    assert [len(t.keyspace) for t in targets] == [0, 0]


# -- the op journal ------------------------------------------------------------


def test_journal_torn_tail_and_files_read_across_packages(tmp_path):
    recs_in = [([b"HSET", b"k1", b"f", b"v1"], 0), ([b"DEL", b"k2"], 3),
               (["FT.CREATE", "idx", "SCHEMA", "t", "TAG"], 0)]
    for writer, reader in ((tjournal, jjournal), (jjournal, tjournal)):
        p = str(tmp_path / f"{writer.__name__}.journal")
        j = writer.OpJournal(p, fsync_ms=0)
        for argv, db in recs_in:
            j.append(argv, db=db)
        j.close()
        recs = list(reader.read_records(p))
        assert [(db, argv) for _, db, argv in recs] == [
            (0, [b"HSET", b"k1", b"f", b"v1"]), (3, [b"DEL", b"k2"]),
            (0, [b"FT.CREATE", b"idx", b"SCHEMA", b"t", b"TAG"])]
        with open(p, "ab") as f:  # a crash mid-write
            f.write(b"\x55" * 13)
        assert len(list(tjournal.read_records(p))) == 3
        j2 = tjournal.OpJournal(p, fsync_ms=0)  # reopening chops the tail
        j2.append([b"HSET", b"k3", b"f", b"v"])
        j2.close()
        recs = list(jjournal.read_records(p))
        assert len(recs) == 4 and recs[-1][2][1] == b"k3"


def test_journal_replay_rebases_relative_ttls(tmp_path):
    p = str(tmp_path / "ops.journal")
    j = tjournal.OpJournal(p, fsync_ms=0)
    j.append([b"HSET", b"k1", b"f", b"v"])
    j.close()
    with open(p, "ab") as f:  # journaled 40 s ago with 100 s to live
        f.write(tjournal._encode(int((time.time() - 40) * 1000), 0,
                                 [b"EXPIRE", b"k1", b"100"]))
        f.write(tjournal._encode(int((time.time() - 40) * 1000), 0,
                                 [b"PEXPIRE", b"k2", b"100000"]))
    srv = RespServer(port=0)
    assert srv._replay_journal(tjournal.read_records(p)) == 3
    assert 50 <= float(srv.engine.execute("TTL", "k1")) <= 70


def test_journal_truncate_upto_keeps_tail(tmp_path):
    p = str(tmp_path / "j.journal")
    j = tjournal.OpJournal(p, fsync_ms=0)
    j.append([b"HSET", b"one", b"f", b"1"])
    off = j.size()
    j.append([b"HSET", b"two", b"f", b"2"])
    j.truncate_upto(off)
    assert [r for _, _, r in tjournal.read_records(p)] == [
        [b"HSET", b"two", b"f", b"2"]]
    j.append([b"HSET", b"three", b"f", b"3"])
    assert [r[1] for _, _, r in tjournal.read_records(p)] == [b"two",
                                                              b"three"]
    j.close()


_JOURNAL_SERVER = """
import sys, time
from valkey_search_tpu_torch.runtime import config
from valkey_search_tpu_torch.runtime.device import set_device
from valkey_search_tpu_torch.server.resp import RespServer
set_device("cpu")
config.set_config("search.journal-path", sys.argv[1])
config.set_config("search.journal-fsync-ms", 0)
config.set_config("search.checkpoint-path", sys.argv[2])
srv = RespServer(port=0)
srv.start()
print("READY", srv.port, flush=True)
while True:
    time.sleep(1)
"""


def _spawn_journal_server(tmp_path):
    script = tmp_path / "journal_server.py"
    script.write_text(_JOURNAL_SERVER)
    env = dict(os.environ, PYTHONPATH=REPO)
    p = subprocess.Popen(
        [sys.executable, str(script), str(tmp_path / "ops.journal"),
         str(tmp_path / "ckpt.vstpu")],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, env=env,
        text=True)
    line = p.stdout.readline().strip()
    assert line.startswith("READY "), line
    return p, int(line.split()[1])


def test_journal_kill9_drill(tmp_path, rng):
    """kill -9 between checkpoints loses nothing (fsync on every append):
    the restarted port server restores the checkpoint and replays the
    journal, vectors included."""
    vecs = rng.standard_normal((40, 4)).astype(np.float32)
    p, port = _spawn_journal_server(tmp_path)
    try:
        c = RawClient(port)
        assert parse(c.cmd("FT.CREATE", "idx", "ON", "HASH", "PREFIX", "1",
                           "d:", "SCHEMA", "t", "TAG", "n", "NUMERIC", "v",
                           "VECTOR", "FLAT", "6", "TYPE", "FLOAT32", "DIM",
                           "4", "DISTANCE_METRIC", "L2")) == "OK"
        for i in range(20):
            c.cmd("HSET", f"d:{i}", "t", "even" if i % 2 == 0 else "odd",
                  "n", str(i), "v", vecs[i].tobytes())
        assert parse(c.cmd("SAVE")) == "OK"
        for i in range(20, 35):
            c.cmd("HSET", f"d:{i}", "t", "post", "n", str(i), "v",
                  vecs[i].tobytes())
        c.cmd("DEL", "d:0")
        c.cmd("EXPIRE", "d:1", "500")
        c.cmd("MULTI")
        c.cmd("HSET", "d:100", "t", "txn", "n", "100", "v",
              vecs[36].tobytes())
        c.cmd("HSET", "d:101", "t", "txn", "n", "101")
        assert parse(c.cmd("EXEC")) == [3, 2]
        c.close()
    finally:
        p.send_signal(signal.SIGKILL)
        p.wait(10)
    p2, port2 = _spawn_journal_server(tmp_path)
    try:
        c = RawClient(port2)

        def count(q):
            return parse(c.cmd("FT.SEARCH", "idx", q, "NOCONTENT",
                               "LIMIT", "0", "0"))[0]

        assert count("*") == 20 + 15 + 2 - 1
        assert count("@t:{post}") == 15 and count("@t:{txn}") == 2
        assert parse(c.cmd("HGET", "d:0", "t")) is None
        assert 400 < float(parse(c.cmd("TTL", "d:1"))) <= 500
        reply = parse(c.cmd("FT.SEARCH", "idx", "*=>[KNN 1 @v $q]",
                            "PARAMS", "2", "q", vecs[36].tobytes(),
                            "NOCONTENT"))
        assert reply == [1, b"d:100"]
        cmds = [a[0] for _, _, a in tjournal.read_records(
            str(tmp_path / "ops.journal"))]
        assert b"FT.CREATE" not in cmds  # inside the checkpoint
        c.close()
    finally:
        p2.send_signal(signal.SIGKILL)
        p2.wait(10)


# -- BGSAVE --------------------------------------------------------------------


def _whole(path) -> bool:
    """The checkpoint at ``path`` is written to its end marker (read with
    the JAX package's reader, which takes none of the port's locks)."""
    from valkey_search_tpu.persistence.format import ChunkReader

    if not os.path.exists(path):
        return False
    try:
        with ChunkReader(path) as r:
            for _ in r.sections():
                pass
        return True
    except (IOError, ValueError):
        return False


def test_bgsave_fork_point_in_time(tmp_path):
    jpath = str(tmp_path / "ops.journal")
    ckpt = str(tmp_path / "ckpt.vstpu")
    with saved_options("search.journal-path", "search.journal-fsync-ms",
                       "search.checkpoint-path"):
        tconfig.set_config("search.journal-path", jpath)
        tconfig.set_config("search.journal-fsync-ms", 0)
        tconfig.set_config("search.checkpoint-path", ckpt)
        srv = RespServer(port=0).start()
        try:
            c = RawClient(srv.port)
            c.cmd("HSET", "k:pre", "f", "before-fork")
            assert parse(c.cmd("BGSAVE")) == "Background saving started"
            c.cmd("HSET", "k:post", "f", "after-fork")
            _wait(lambda: srv.bgsave_pid is None)
            assert srv.bgsave_status == "ok"
            restored = Engine.load(ckpt)
            assert restored.execute("HGET", "k:pre", "f") == b"before-fork"
            assert restored.execute("HGET", "k:post", "f") is None
            flat = [b" ".join(a) for _, _, a in tjournal.read_records(jpath)]
            assert any(b"k:post" in x for x in flat)
            assert not any(b"k:pre" in x for x in flat)
            c.close()
        finally:
            srv.close()


def test_bgsave_fork_suspends_and_resumes_writers(tmp_path):
    srv = RespServer(Engine(sync_ingest=False), port=0)
    eng = srv.engine
    eng.execute("FT.CREATE", "i", "SCHEMA", "t", "TAG")
    for i in range(50):
        eng.execute("HSET", f"a{i}", "t", "x")
    q = eng._queue()
    srv.bgsave_forked(str(tmp_path / "c2.vstpu"))
    _wait(lambda: srv.bgsave_pid is None)
    assert srv.bgsave_status == "ok"
    assert not q.suspended
    eng.execute("HSET", "b", "t", "y")
    eng.drain()
    assert eng.execute("FT.SEARCH", "i", "@t:{y}", "NOCONTENT") == [1, "b"]
    restored = Engine.load(str(tmp_path / "c2.vstpu"))
    assert restored.execute("FT.SEARCH", "i", "@t:{x}", "NOCONTENT",
                            "LIMIT", "0", "0") == [50]
    eng._ingestion.shutdown()


def test_bgsave_overlap_refused(tmp_path):
    from valkey_search_tpu_torch.server.resp import RespError

    srv = RespServer(port=0)
    srv.engine.execute("HSET", "a", "f", "1")
    srv.bgsave_forked(str(tmp_path / "o.vstpu"))
    if srv.bgsave_pid is not None:
        with pytest.raises(RespError, match="already in progress"):
            srv.bgsave_forked(str(tmp_path / "o2.vstpu"))
    _wait(lambda: srv.bgsave_pid is None)
    assert srv.bgsave_status == "ok"
    srv.bgsave_forked(str(tmp_path / "o3.vstpu"))
    _wait(lambda: srv.bgsave_pid is None)
    assert srv.bgsave_status == "ok"


def test_bgsave_thread_route_with_fork_off(tmp_path):
    path = str(tmp_path / "t.vstpu")
    forks = STATS.snapshot().get("bgsave_forks", 0)
    with saved_options("search.bgsave-fork"):
        srv = RespServer(port=0).start()
        try:
            c = RawClient(srv.port)
            assert parse(c.cmd("CONFIG", "SET", "search.bgsave-fork",
                               "no")) == "OK"
            c.cmd("HSET", "k", "f", "v")
            assert parse(c.cmd("BGSAVE", path)) == \
                "Background saving started"
            _wait(lambda: _whole(path))
            assert Engine.load(path).execute("HGET", "k", "f") == b"v"
            assert STATS.snapshot().get("bgsave_forks", 0) == forks
            c.close()
        finally:
            srv.close()


def test_bgsave_child_takes_no_lock_outside_its_barrier(tmp_path, rng):
    """The child's save path needs no lock that the fork barrier leaves to
    other threads: with every vector store's lock, the metrics lock, the
    config registry's and the controlled variables' held by another thread
    for the whole fork, the child still writes a whole checkpoint."""
    srv = RespServer(port=0)
    eng = srv.engine
    eng.execute("FT.CREATE", "h", "SCHEMA", "v", "VECTOR", "HNSW", "6",
                "TYPE", "FLOAT32", "DIM", "4", "DISTANCE_METRIC", "L2")
    eng.execute("FT.CREATE", "f", "SCHEMA", "w", "VECTOR", "FLAT", "6",
                "TYPE", "FLOAT32", "DIM", "4", "DISTANCE_METRIC", "L2")
    for i in range(30):
        eng.execute("HSET", f"k{i}", "v",
                    rng.standard_normal(4).astype(np.float32).tobytes(),
                    "w", rng.standard_normal(4).astype(np.float32).tobytes())
    stores = [eng.manager.get(n).attribute(a).index.store
              for n, a in (("h", "v"), ("f", "w"))]
    held = [st._lock for st in stores] + [
        STATS._lock, tconfig.REGISTRY._lock, TCONTROLLED._lock]
    taken, release = threading.Event(), threading.Event()

    def holder():
        for lk in held:
            lk.acquire()
        taken.set()
        release.wait(60)
        for lk in reversed(held):
            lk.release()

    path = str(tmp_path / "locked.vstpu")
    t = threading.Thread(target=holder)
    t.start()
    taken.wait(10)
    # the parent's own STATS.incr after the fork waits for the holder
    forker = threading.Thread(target=srv.bgsave_forked, args=(path,))
    try:
        forker.start()
        _wait(lambda: _whole(path))
    finally:
        release.set()
        t.join(10)
        forker.join(10)
    _wait(lambda: srv.bgsave_pid is None)
    assert srv.bgsave_status == "ok"
    restored = Engine.load(path)
    assert restored.execute("FT.SEARCH", "h", "*", "NOCONTENT", "LIMIT",
                            "0", "0") == [30]


def test_fork_barrier_takes_locks_in_the_serving_order(rng):
    """The barrier's order is the one serving threads nest the locks in, so
    the forking thread never holds one that a thread it waits for wants
    next: the schema manager first; an HNSW index's graph lock before its
    index lock (the graph publish takes both), the native builder's after
    it (an insert takes it under the index lock); the interner after every
    index lock of its schema (an index interns under its own lock)."""
    from valkey_search_tpu_torch.server.resp import _engine_aux_locks

    e = Engine()
    e.execute("FT.CREATE", "h", "SCHEMA", "v", "VECTOR", "HNSW", "6", "TYPE",
              "FLOAT32", "DIM", "4", "DISTANCE_METRIC", "L2", "t", "TAG",
              "title", "TEXT")
    e.execute("HSET", "k", "v", rng.standard_normal(4).astype(
        np.float32).tobytes(), "t", "x", "title", "red fox")
    schema = e.manager.get("h")
    hnsw = schema.attribute("v").index
    order = {id(lk): i for i, lk in enumerate(_engine_aux_locks(e))}
    pos = [order[id(lk)] for lk in (
        e.manager._lock, hnsw._graph_lock, hnsw._lock, hnsw.builder._lock,
        schema.interner._lock)]
    assert pos == sorted(pos)
    assert all(order[id(a.index._lock)] < order[id(schema.interner._lock)]
               for a in schema.attributes.values()
               if hasattr(a.index, "_lock"))
