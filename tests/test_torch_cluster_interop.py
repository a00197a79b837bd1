"""Replication, failover, processes and mixed clusters: the port against the
JAX package, and the two packages in one cluster.

- Replicas over the socket transport, each flow through a primary and a
  replica of each package with the same commands (``tests/test_transport.py``
  and the replica cases of ``test_hfe`` and ``test_dbnum``): read scaling,
  MULTI/EXEC writes, stream ordering, full sync under writes, slot
  migration, READONLY replicas, multi-db streams.
- The two repairs of the port's transport, each held against the JAX
  package's reply on the same flow, waiting first until the replica's
  gossip has learnt its primary's slot range: through a replica each
  document counts once (the JAX package counts it twice), and a promoted
  replica serves without dialing its dead primary, 20 times of 20 (the JAX
  package's FT.SEARCH fails with ``Connection refused``).
- Node processes of the port (``python -m
  valkey_search_tpu_torch.cluster.transport --device cpu``): a two-node
  cluster and a kill -9 with journal replay; ``--device cuda`` without a
  card exits at start and never serves.
- Mixed clusters: a port ``ClusterClient`` over one reference node and two
  port nodes, and the reverse, converge to one metadata fingerprint and
  answer KNN as an all-reference cluster does; a ``ClusterEngine``
  checkpoint saved by either package loads in the other.
"""

import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from valkey_search_tpu.cluster import node as jnode
from valkey_search_tpu.cluster import transport as jtr
from valkey_search_tpu.runtime import config as jconfig
from valkey_search_tpu.runtime import debug as jdebug
from valkey_search_tpu.runtime.metrics import STATS as JSTATS
from valkey_search_tpu_torch.cluster import node as tnode
from valkey_search_tpu_torch.cluster import transport as ttr
from valkey_search_tpu_torch.runtime import config as tconfig
from valkey_search_tpu_torch.runtime import debug as tdebug
from valkey_search_tpu_torch.runtime.device import set_device
from valkey_search_tpu_torch.runtime.metrics import STATS as TSTATS
from torch_cluster_pair import free_ports, normalize, wait
from torch_port_both import Both, outcome
from torch_port_config import set_both

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIDES = (jtr, ttr)
N_DOCS = 50


@pytest.fixture(autouse=True)
def _clean():
    set_device("cpu")
    for dbg in (jdebug, tdebug):
        dbg.reset_all()
    yield
    for dbg in (jdebug, tdebug):
        dbg.reset_all()
    jconfig.REGISTRY.reset_all()
    tconfig.REGISTRY.reset_all()


class _Pair:
    """A primary and a replica NodeServer of one package; the replica's
    port above the primary's, so both packages order them alike."""

    def __init__(self, tr, gossip_s=0.05, docs=0):
        self.tr = tr
        p_port, r_port = free_ports(2)
        self.primary = tr.NodeServer("p", port=p_port).start()
        self.pc = tr.RespConnection(("127.0.0.1", self.primary.port))
        if docs:
            self.pc.cmd("FT.CREATE", "fo", "ON", "HASH", "SCHEMA", "t", "TAG")
            for i in range(docs):
                self.pc.cmd("HSET", f"fok{i}", "t", "alive")
        self.replica = tr.NodeServer("r", port=r_port,
                                     gossip_interval_s=gossip_s).start()
        self.addr = f"127.0.0.1:{self.primary.port}"
        self.ports = [p_port, r_port]
        self._conns = [self.pc]

    def attach(self, docs=0, gossip=False, index="fo"):
        """become_replica_of; wait for the full sync of ``docs`` keys and
        ``index`` (when ``docs``), and for the first gossip round to learn
        the primary's slot range (when ``gossip``)."""
        self.replica.become_replica_of(self.addr)
        wait(lambda: len(self.replica.engine.keyspace) >= docs
             and (not docs or index in self.replica.engine.ft_list())
             and (not gossip or self.addr in self.replica._peer_slots),
             what="the full sync and the first gossip round")
        return self

    def rc(self):
        c = self.tr.RespConnection(("127.0.0.1", self.replica.port))
        self._conns.append(c)
        return c

    def close(self):
        for c in self._conns:
            try:
                c.close()
            except OSError:
                pass
        self.replica.close()
        self.primary.close()


def _both(fn):
    """``fn(tr)`` for each package; equal outcomes; the port's value."""
    got = [outcome(fn, tr) for tr in SIDES]
    assert got[1] == got[0], f"port {got[1]!r} != jax {got[0]!r}"
    return got[1][1] if got[1][0] == "ok" else got[1]


def _drained(primary):
    with primary._repl_cv:
        empty = not primary._repl_log
    return empty and all(r.ready and not r.backlog
                         for r in list(primary._replica_conns.values()))


# -- replicas -------------------------------------------------------------------------


def test_socket_replica_read_scaling():
    def flow(tr):
        pr = _Pair(tr)
        try:
            pr.pc.cmd("FT.CREATE", "idx", "ON", "HASH", "SCHEMA", "tags",
                      "TAG")
            pr.pc.cmd("HSET", "k0", "tags", "old")
            pr.attach(docs=1, index="idx")
            pr.pc.cmd("HSET", "k1", "tags", "fresh")
            wait(lambda: "k1" in pr.replica.engine.keyspace)
            client = tr.ClusterClient(
                [pr.addr], replica_addrs=[[f"127.0.0.1:{pr.replica.port}"]])
            try:
                (jconfig if tr is jtr else tconfig).set_config(
                    "search.fanout-target-mode", "replica")
                out = [client.execute("FT.SEARCH", "idx", "@tags:{fresh}",
                                      "NOCONTENT"),
                       client.execute("FT.SEARCH", "idx", "@tags:{old}"),
                       sorted(pr.replica.engine.hgetall("k0").items())]
            finally:
                client.close()
            return out
        finally:
            pr.close()

    out = _both(flow)
    assert out[0] == [1, "k1"]


def test_multi_exec_writes_replicate():
    def flow(tr):
        pr = _Pair(tr).attach()
        try:
            pr.pc.sock.sendall(b"*1\r\n$5\r\nMULTI\r\n")
            res = [pr.pc._read(), pr.pc.cmd("HSET", "tx1", "f", "1"),
                   pr.pc.cmd("HSET", "tx2", "f", "2")]
            pr.pc.sock.sendall(b"*1\r\n$4\r\nEXEC\r\n")
            res.append(pr.pc._read())
            wait(lambda: {"tx1", "tx2"} <= set(pr.replica.engine.keyspace))
            res.append([pr.replica.engine.hgetall(k) for k in ("tx1", "tx2")])
            return res
        finally:
            pr.close()

    assert _both(flow)[3] == [1, 1]


def test_replica_stream_ordering_under_concurrency():
    for tr in SIDES:
        pr = _Pair(tr).attach()
        conns = [tr.RespConnection(("127.0.0.1", pr.primary.port))
                 for _ in range(4)]
        try:
            def storm(conn, tag):
                for i in range(60):
                    conn.cmd("HSET", "hot", "f", f"{tag}:{i}")

            threads = [threading.Thread(target=storm, args=(c, t))
                       for t, c in enumerate(conns)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            wait(lambda: _drained(pr.primary) and pr.replica.engine.hgetall(
                "hot") == pr.primary.engine.hgetall("hot"),
                what=f"{tr.__name__}: the replica to converge")
        finally:
            for c in conns:
                c.close()
            pr.close()


def test_replica_full_sync_during_write_storm():
    for tr in SIDES:
        pr = _Pair(tr)
        for i in range(150):
            pr.pc.cmd("HSET", f"pre{i}", "f", str(i))
        stop = threading.Event()
        wc = tr.RespConnection(("127.0.0.1", pr.primary.port))

        def writer():
            i = 0
            while not stop.is_set():
                wc.cmd("HSET", f"pre{i % 150}", "f", f"new{i}")
                i += 1

        wt = threading.Thread(target=writer)
        wt.start()
        try:
            pr.replica.become_replica_of(pr.addr)
            time.sleep(0.2)
        finally:
            stop.set()
            wt.join()
        try:
            wait(lambda: _drained(pr.primary) and not [
                k for k in pr.primary.engine.keyspace
                if pr.replica.engine.hgetall(k)
                != pr.primary.engine.hgetall(k)],
                what=f"{tr.__name__}: the replica to converge")
        finally:
            wc.close()
            pr.close()


def test_slot_migration_moved_during_write_storm():
    for tr, stats in zip(SIDES, (JSTATS, TSTATS)):
        n0 = tr.NodeServer("m0", port=0).start()
        n1 = tr.NodeServer("m1", port=0).start()
        half = 8192
        n0.slots, n1.slots = (0, half), (half, 16384)
        a0, a1 = f"127.0.0.1:{n0.port}", f"127.0.0.1:{n1.port}"
        n0._peer_slots[a1] = (half, 16384)
        n1._peer_slots[a0] = (0, half)
        client = tr.ClusterClient([a0, a1])
        try:
            client.execute("FT.CREATE", "mig", "ON", "HASH", "SCHEMA", "t",
                           "TAG")
            keys = [k for k in (f"migk{i}" for i in range(4000))
                    if jnode.key_slot(k) < half][:80]
            stop, errors, written = threading.Event(), [], []

            def writer():
                i = 0
                while not stop.is_set():
                    k = keys[i % len(keys)]
                    try:
                        client.execute("HSET", k, "t", f"v{i}")
                        written.append((k, f"v{i}"))
                    except Exception as exc:  # noqa: BLE001 - reported
                        errors.append(exc)
                    i += 1

            moved0 = stats.get("moved_redirects")
            t = threading.Thread(target=writer)
            t.start()
            time.sleep(0.1)
            n1.slots = (0, 16384)
            n0.slots = (16384, 16384)
            n0._peer_slots[a1] = (0, 16384)
            n1._peer_slots.pop(a0, None)
            with n0.engine._lock:
                snapshot = {k: dict(v) for k, v in n0.engine.keyspace.items()}
            for k, fields in snapshot.items():
                with n1.engine._lock:
                    if k not in n1.engine.keyspace:
                        n1.engine.hset(k, fields)
            time.sleep(0.2)
            stop.set()
            t.join()
            assert not errors, errors[:3]
            assert stats.get("moved_redirects") > moved0
            last = dict(written)
            got = n1.engine.hgetall
            assert not [k for k, v in last.items()
                        if got(k).get("t") not in (v, v.encode())]
        finally:
            client.close()
            n0.close()
            n1.close()


@pytest.mark.parametrize("argv", [
    ("FT.CREATE", "ridx", "SCHEMA", "n", "NUMERIC"),
    ("FT.DROPINDEX", "fo"), ("HSET", "wk", "f", "v"), ("DEL", "fok1"),
    ("HEXPIRE", "wk", "5", "FIELDS", "1", "f"),
    ("HPERSIST", "wk", "FIELDS", "1", "f"), ("EXPIRE", "fok1", "5"),
    ("HGETALL", "fok1"), ("FT.SEARCH", "fo", "@t:{alive}", "NOCONTENT"),
])
def test_replica_is_read_only_until_promoted(argv):
    """Each command through a replica that has run its first gossip round
    (so the JAX package's replica fans out over itself and its primary),
    then after its promotion. FT.SEARCH's count through the replica is each
    package's own: the JAX package's double count, the port's repaired one;
    the rest of every outcome is compared."""
    counts = {}

    def flow(tr):
        pr = _Pair(tr, docs=3).attach(docs=3, gossip=True)
        try:
            rc = pr.rc()
            before = outcome(rc.cmd, *argv)
            if argv[0] == "FT.SEARCH" and before[0] == "ok":
                counts[tr] = before[1][0]
                before = ("ok", sorted(set(before[1][1:])))
            pr.pc.cmd("HSET", "wk", "f", "v1")
            wait(lambda: "wk" in pr.replica.engine.keyspace)
            pr.replica.promote_to_primary(pr.addr)
            after = outcome(rc.cmd, *argv)
            return before, after, outcome(rc.cmd, "HGETALL", "wk")
        finally:
            pr.close()

    before, after, _ = _both(flow)
    if argv[0] == "FT.SEARCH":
        assert before == ("ok", [b"fok0", b"fok1", b"fok2"])
        assert counts == {jtr: 6, ttr: 3}  # the reference's double count
        assert after[1][0] == 3
    elif argv[0] != "HGETALL":
        assert "read only replica" in before[2]


def test_multidb_replication_stream():
    def flow(tr):
        pr = _Pair(tr)
        try:
            pr.pc.cmd("HSET", "k0", "f", "zero")
            pr.pc.cmd("SELECT", "1")
            pr.pc.cmd("HSET", "k1", "f", "one")
            pr.attach()
            e1 = pr.replica.resp.engine_for(1)
            wait(lambda: "k1" in e1.keyspace)
            pr.pc.cmd("HSET", "k1b", "f", "live1")
            pr.pc.cmd("SELECT", "0")
            pr.pc.cmd("HSET", "k0b", "f", "live0")
            wait(lambda: "k0b" in pr.replica.engine.keyspace
                 and "k1b" in e1.keyspace)
            return (sorted(pr.replica.engine.keyspace), sorted(e1.keyspace))
        finally:
            pr.close()

    assert _both(flow) == (["k0", "k0b"], ["k1", "k1b"])


def test_multidb_replication_under_concurrent_writers():
    def flow(tr):
        pr = _Pair(tr).attach()
        try:
            def writer(db):
                c = tr.RespConnection(("127.0.0.1", pr.primary.port))
                if db:
                    c.cmd("SELECT", str(db))
                for i in range(80):
                    c.cmd("HSET", f"w{db}:{i}", "f", f"v{db}-{i}")
                c.close()

            ts = [threading.Thread(target=writer, args=(d,)) for d in (0, 2)]
            for t in ts:
                t.start()
            for t in ts:
                t.join()
            e0, e2 = pr.replica.engine, pr.replica.resp.engine_for(2)
            wait(lambda: len(e0.keyspace) == 80 and len(e2.keyspace) == 80)
            return sorted(e0.keyspace), sorted(e2.keyspace), e2.hgetall("w2:7")
        finally:
            pr.close()

    _both(flow)


# -- the two repairs --------------------------------------------------------------------


def _count(conn):
    return conn.cmd("FT.SEARCH", "fo", "@t:{alive}", "NOCONTENT", "LIMIT",
                    "0", "0")[0]


def test_a_replica_counts_each_document_once():
    """The replica's first gossip round stores its primary's slot range,
    its own: the JAX package then fans FT.SEARCH and FT.AGGREGATE out over
    [replica, primary] and counts every document twice; the port leaves the
    primary it replicates from out of the fanout."""
    got = {}
    for tr in SIDES:
        pr = _Pair(tr, docs=N_DOCS).attach(docs=N_DOCS, gossip=True)
        try:
            rc = pr.rc()
            agg = rc.cmd("FT.AGGREGATE", "fo", "@t:{alive}", "GROUPBY", "1",
                         "@t", "REDUCE", "COUNT", "0", "AS", "n")
            got[tr] = (_count(rc), int(agg[1][3]),
                       [normalize(rc.cmd("CLUSTER", sub), pr.ports)
                        for sub in ("SLOTS", "SHARDS", "NODES")],
                       _count(pr.pc))
        finally:
            pr.close()
    assert got[jtr][:2] == (2 * N_DOCS, 2 * N_DOCS)  # the reference's fault
    assert got[ttr][:2] == (N_DOCS, N_DOCS)
    # CLUSTER SLOTS, SHARDS and NODES through the replica, and the
    # primary's own count, are the reference's
    assert got[ttr][2:] == got[jtr][2:]
    assert got[ttr][3] == N_DOCS


def _failover(tr, gossip):
    pr = _Pair(tr, docs=N_DOCS).attach(docs=N_DOCS, gossip=gossip)
    try:
        pr.primary.close()
        pr.replica.promote_to_primary()
        rc = pr.rc()
        out = [outcome(_count, rc)]
        out.append(outcome(rc.cmd, "HSET", "fok_new", "t", "alive"))
        out.append(outcome(_count, rc))
        return out
    finally:
        pr.close()


def test_replica_failover_promotion():
    """tests/test_transport.py's flow as it stands: the primary dies, the
    promoted replica serves reads and writes for its slots."""
    assert _failover(ttr, gossip=False) == [("ok", N_DOCS), ("ok", 1),
                                            ("ok", N_DOCS + 1)]


def test_promoted_replica_never_dials_its_dead_primary():
    """After the replica's first gossip round, promote_to_primary() without
    dead_peer: the JAX package's next FT.SEARCH builds a coordinator over
    [replica, dead primary] and fails to connect; the port's serves from its
    own data, 20 times of 20."""
    ref = _failover(jtr, gossip=True)
    assert ref[0][0] == "error" and "Connection refused" in ref[0][2]
    for _ in range(20):
        assert _failover(ttr, gossip=True) == [
            ("ok", N_DOCS), ("ok", 1), ("ok", N_DOCS + 1)]


@pytest.mark.parametrize("dead_peer", [False, True])
def test_promotion_drops_the_primary_from_the_peers(dead_peer):
    pr = _Pair(ttr, docs=3).attach(docs=3, gossip=True)
    try:
        pr.primary.close()
        pr.replica.promote_to_primary(pr.addr if dead_peer else "")
        assert pr.addr not in pr.replica.peers
        assert pr.addr not in pr.replica._peer_slots
        assert pr.addr not in pr.replica._peer_conns
        assert not pr.replica._query_fans_out()
        assert pr.replica._fanout_peers() == []
    finally:
        pr.close()


def test_a_replica_in_a_trio_fans_out_to_the_other_shards():
    """A replica that also gossips with the other primaries fans out to
    them and to itself, never to its own primary: each document once."""
    ports = free_ports(4)
    nodes = [ttr.NodeServer(f"n{i}", port=p, gossip_interval_s=0.05)
             for i, p in enumerate(ports[:3])]
    for (lo, hi), n in zip(ttr.assign_slot_ranges(3), nodes):
        n.slots = (lo, hi)
        n.start()
    addrs = [f"127.0.0.1:{n.port}" for n in nodes]
    replica = ttr.NodeServer("r0", port=ports[3], peers=addrs[1:],
                             gossip_interval_s=0.05).start()
    client = ttr.ClusterClient(addrs)
    try:
        client.execute("FT.CREATE", "fo", "ON", "HASH", "SCHEMA", "t", "TAG")
        for i in range(60):
            client.execute("HSET", f"fok{i}", "t", "alive")
        replica.become_replica_of(addrs[0])
        wait(lambda: len(replica._peer_slots) == 3
             and len(replica.engine.keyspace)
             == len(nodes[0].engine.keyspace))
        assert replica._fanout_peers() == sorted(addrs[1:])
        rc = ttr.RespConnection(("127.0.0.1", replica.port))
        assert _count(rc) == 60
        rc.close()
    finally:
        client.close()
        replica.close()
        for n in nodes:
            n.close()


# -- node processes -----------------------------------------------------------------------


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    return env


def _spawn(node_id, slots, *extra):
    p = subprocess.Popen(
        [sys.executable, "-m", "valkey_search_tpu_torch.cluster.transport",
         "--node-id", node_id, "--port", "0", "--slots",
         f"{slots[0]}:{slots[1]}", "--device", "cpu", *extra],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, env=_env(),
        text=True)
    line = p.stdout.readline().strip()
    assert line.startswith("READY "), line
    return p, int(line.split()[1])


def _stop(procs):
    for p in procs:
        if p.poll() is None:
            p.terminate()
    for p in procs:
        try:
            p.wait(timeout=10)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait(timeout=10)


def test_device_cuda_without_a_card_exits_and_never_serves():
    proc = subprocess.run(
        [sys.executable, "-m", "valkey_search_tpu_torch.cluster.transport",
         "--node-id", "x", "--port", "0"],
        capture_output=True, text=True, env=_env(), timeout=120)
    assert proc.returncode != 0
    assert "READY" not in proc.stdout
    assert "torch.cuda.is_available() is False" in proc.stderr


def test_multiprocess_cluster():
    procs = []
    try:
        ranges = ttr.assign_slot_ranges(2)
        ports = []
        for i in range(2):
            p, port = _spawn(f"p{i}", ranges[i])
            procs.append(p)
            ports.append(port)
        client = ttr.ClusterClient([f"127.0.0.1:{pt}" for pt in ports])
        assert client.execute(
            "FT.CREATE", "idx", "ON", "HASH", "SCHEMA", "emb", "VECTOR",
            "FLAT", "6", "TYPE", "FLOAT32", "DIM", "4", "DISTANCE_METRIC",
            "L2") == "OK"
        vecs = np.eye(4, dtype=np.float32)
        for i in range(4):
            client.execute("HSET", f"k{i}", "emb", vecs[i].tobytes())
        reply = client.execute("FT.SEARCH", "idx", "*=>[KNN 2 @emb $q]",
                               "PARAMS", "2", "q", vecs[1].tobytes(),
                               "NOCONTENT")
        assert reply[0] == 2 and reply[1] == "k1"
        assert [c.cmd("_NODE.ID") for c in client.conns] == [b"p0", b"p1"]
        client.close()
    finally:
        _stop(procs)


def test_cluster_node_kill9_journal_replay(tmp_path):
    ranges = ttr.assign_slot_ranges(2)
    jpath, cpath = str(tmp_path / "b.journal"), str(tmp_path / "b.ckpt")
    procs, replica = [], None
    try:
        pa, port_a = _spawn("pa", ranges[0])
        procs.append(pa)
        pb, port_b = _spawn("pb", ranges[1], "--journal", jpath,
                            "--checkpoint", cpath)
        procs.append(pb)
        client = ttr.ClusterClient([f"127.0.0.1:{port_a}",
                                    f"127.0.0.1:{port_b}"])
        assert client.execute("FT.CREATE", "idx", "ON", "HASH", "SCHEMA",
                              "t", "TAG") == "OK"

        def owned_by_b(key):
            return ranges[1][0] <= jnode.key_slot(key) < ranges[1][1]

        for i in range(40):
            client.execute("HSET", f"k{i}", "t", "even" if i % 2 == 0
                           else "odd")
        cb = ttr.RespConnection(("127.0.0.1", port_b), timeout=10)
        assert cb.cmd("SAVE") == "OK"
        cb.close()
        post_save_b = [f"k{i}" for i in range(40, 80) if owned_by_b(f"k{i}")]
        for i in range(40, 80):
            client.execute("HSET", f"k{i}", "t", "post")
        victim = next(f"k{i}" for i in range(40) if owned_by_b(f"k{i}"))
        client.execute("DEL", victim)
        total = client.execute("FT.SEARCH", "idx", "*", "NOCONTENT", "LIMIT",
                               "0", "0")[0]
        assert total == 79
        client.close()
        pb.send_signal(signal.SIGKILL)
        pb.wait(10)
        pb2, port_b2 = _spawn("pb", ranges[1], "--journal", jpath,
                              "--checkpoint", cpath, "--peers",
                              f"127.0.0.1:{port_a}")
        procs.append(pb2)
        client2 = ttr.ClusterClient([f"127.0.0.1:{port_a}",
                                     f"127.0.0.1:{port_b2}"])
        assert client2.execute("FT.SEARCH", "idx", "*", "NOCONTENT", "LIMIT",
                               "0", "0")[0] == total
        assert client2.execute("HGET", post_save_b[0], "t") == b"post"
        assert client2.execute("HGET", victim, "t") is None
        assert client2.execute("FT.CREATE", "idx2", "ON", "HASH", "SCHEMA",
                               "u", "TAG") == "OK"
        client2.execute("HSET", "fresh:1", "u", "x", "t", "x")
        assert client2.execute("FT.SEARCH", "idx2", "@u:{x}", "NOCONTENT",
                               "LIMIT", "0", "0")[0] == 1
        replica = ttr.NodeServer("r0", port=0, gossip_interval_s=0.05).start()
        replica.become_replica_of(f"127.0.0.1:{port_b2}")
        wait(lambda: post_save_b[0] in replica.engine.keyspace)
        assert victim not in replica.engine.keyspace
        client2.close()
    finally:
        if replica is not None:
            replica.close()
        _stop(procs)


# -- the two packages in one cluster ------------------------------------------------------


def _mixed(trs, vecs):
    """Three NodeServers, node i of package trs[i], gossiping; a
    ClusterClient of trs[0]'s package over them, the index created through
    it and ``vecs`` written through it."""
    ports = free_ports(3)
    nodes = [tr.NodeServer(f"n{i}", port=p, gossip_interval_s=0.05)
             for i, (tr, p) in enumerate(zip(trs, ports))]
    addrs = [f"127.0.0.1:{p}" for p in ports]
    for i, ((lo, hi), n) in enumerate(zip(ttr.assign_slot_ranges(3), nodes)):
        n.slots = (lo, hi)
        n.peers = [a for j, a in enumerate(addrs) if j != i]
        n.start()
    client = trs[0].ClusterClient(addrs)
    client.execute("FT.CREATE", "idx", "ON", "HASH", "PREFIX", "1", "doc:",
                   "SCHEMA", "emb", "VECTOR", "FLAT", "6", "TYPE", "FLOAT32",
                   "DIM", str(vecs.shape[1]), "DISTANCE_METRIC", "L2",
                   "tags", "TAG")
    for i, v in enumerate(vecs):
        client.execute("HSET", f"doc:{i}", "emb", v.tobytes(), "tags",
                       "even" if i % 2 == 0 else "odd")
    return nodes, client


@pytest.mark.parametrize("trs", [(ttr, jtr, ttr), (jtr, ttr, jtr)],
                         ids=["port_client", "reference_client"])
def test_mixed_cluster_converges_and_answers_as_the_reference(trs):
    rng = np.random.default_rng(21)
    vecs = rng.standard_normal((60, 8)).astype(np.float32)
    queries = rng.standard_normal((4, 8)).astype(np.float32)
    argvs = [("FT.SEARCH", "idx", f"{flt}=>[KNN 10 @emb $q]", "PARAMS", "2",
              "q", q.tobytes(), "NOCONTENT")
             for q in queries for flt in ("*", "@tags:{odd}")]
    argvs.append(("FT.SEARCH", "idx", "@tags:{even}", "NOCONTENT", "LIMIT",
                  "0", "100"))
    argvs.append(("FT.AGGREGATE", "idx", "*", "GROUPBY", "1", "@tags",
                  "REDUCE", "COUNT", "0", "AS", "n", "SORTBY", "2", "@tags",
                  "ASC"))
    replies = []
    for kinds in (trs, (jtr, jtr, jtr)):
        nodes, client = _mixed(kinds, vecs)
        try:
            # a node created after the client's push: gossip carries it
            c0 = kinds[1].RespConnection(("127.0.0.1", nodes[1].port))
            c0.cmd("FT.CREATE", "late", "ON", "HASH", "PREFIX", "1", "doc:",
                   "SCHEMA", "tags", "TAG")
            c0.close()
            wait(lambda: all("late" in n.engine.ft_list() for n in nodes))
            wait(lambda: len({n.metadata.top_fingerprint()
                              for n in nodes}) == 1,
                 what="one metadata fingerprint")
            got = [client.execute(*argv) for argv in argvs]
            got.append(client.execute("FT.SEARCH", "late", "@tags:{odd}",
                                      "NOCONTENT", "LIMIT", "0", "0"))
            got.append(nodes[0].metadata.top_fingerprint())
            replies.append(got)
        finally:
            client.close()
            for n in nodes:
                n.close()
    assert replies[0] == replies[1]
    assert replies[0][0][0] == 10 and replies[0][-2] == [30]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_cluster_checkpoint_crosses_packages(tmp_path, writer):
    rng = np.random.default_rng(22)
    vecs = rng.standard_normal((70, 8)).astype(np.float32)
    both = Both.of(jnode.ClusterEngine(n_nodes=3),
                   tnode.ClusterEngine(n_nodes=3))
    for i, v in enumerate(vecs):
        both.call("hset", f"doc:{i}", {"emb": v.tobytes(), "n": str(i),
                                       "color": ["red", "blue"][i % 2]})
    both.call("ft_create", "idx", "ON", "HASH", "PREFIX", "1", "doc:",
              "SCHEMA", "emb", "VECTOR", "HNSW", "6", "TYPE", "FLOAT32",
              "DIM", "8", "DISTANCE_METRIC", "L2", "color", "TAG",
              "n", "NUMERIC")
    both.call("ft_create", "idx", "ON", "HASH", "PREFIX", "1", "doc:",
              "SCHEMA", "emb", "VECTOR", "FLAT", "6", "TYPE", "FLOAT32",
              "DIM", "8", "DISTANCE_METRIC", "L2", "color", "TAG",
              "n", "NUMERIC")  # a recreate: version 2
    src = both.jax if writer == "jax" else both.port
    d = str(tmp_path / "ckpt")
    src.save(d)
    restored = Both.of(jnode.ClusterEngine.load(d), tnode.ClusterEngine.load(d))
    for q in (0, 33):
        argv = ("FT.SEARCH", "idx", "*=>[KNN 6 @emb $q]", "PARAMS", "2", "q",
                vecs[q].tobytes(), "NOCONTENT")
        assert restored.same(*argv) == both.same(*argv)
    restored.same("FT.SEARCH", "idx", "@color:{red} @n:[0 30]", "NOCONTENT",
                  "LIMIT", "0", "50")
    restored.same("FT.INFO", "idx", "CLUSTER")
    entries = [{n: (e.version, e.fingerprint, e.payload)
                for n, e in c.nodes[i].metadata.entries().items()}
               for c in restored.engines for i in range(3)]
    assert all(e == entries[0] for e in entries)
    assert entries[0]["idx"][0] == 2
    assert [n.slots for n in restored.port.nodes] == [
        n.slots for n in restored.jax.nodes]
    set_both("search.fanout-target-mode", "primary")
    restored.call("hset", "doc:900", {"emb": vecs[0].tobytes(),
                                      "color": "gold", "n": "1"})
    assert restored.same("FT.SEARCH", "idx", "@color:{gold}",
                         "NOCONTENT") == [1, "doc:900"]
