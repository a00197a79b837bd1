"""Cross-process cluster transport over real sockets.

The reference's distributed backend has two planes (SURVEY.md §2.4):
a gRPC point-to-point data plane (``SearchIndexPartition`` /
``GetGlobalMetadata`` / ``InfoIndexPartition``, src/coordinator/
coordinator.proto:21-31, port = valkey port + 20294) and the valkey
cluster-bus gossip control plane (top-level metadata fingerprint
broadcast, metadata_manager.h:74-76).

Here both planes ride the node's own RESP listener as internal commands
(the socket-RPC analog of the gRPC service methods, server.cc):

- ``_PART.SEARCH <ver> <fp> <FT.SEARCH argv...>`` — one shard's partition
  search: index fingerprint/version + slot-ownership checks (mismatch →
  ``-MISMATCH`` reply = FAILED_PRECONDITION, server.h:60-65), then local
  search + content resolution on the owning shard, rows returned with
  raw distances for the coordinator's k-bounded merge (fanout.cc:69-222).
- ``_PART.INFO <name>`` — InfoIndexPartition.
- ``_META.FP`` / ``_META.PULL`` / ``_META.PUSH`` — gossip fingerprint
  probe, GetGlobalMetadata pull, and direct entry push (the
  FT.INTERNAL_UPDATE-style replication write).
- ``_SLOTS.SET/_SLOTS.GET`` — slot-range ownership (CLUSTER ADDSLOTS).

Each ``NodeServer`` runs a pull-based gossip loop: poll every peer's
``_META.FP``; on mismatch pull ``_META.PULL`` and reconcile per-entry
last-writer-wins — the same convergence the reference reaches with
broadcast+pull, but symmetric (both sides poll, so a one-way partition
still converges when it heals).

``ClusterClient`` is the coordinator-side facade: slot-routed keyspace
commands, FT.CREATE with a consistency-check fanout (ft_create.cc:21-80),
and scatter/gather FT.SEARCH with retry-on-mismatch + the
partial-results policy (fanout.cc:177-221).

The port's copy of valkey_search_tpu/cluster/transport.py. Start a node
with

    python -m valkey_search_tpu_torch.cluster.transport --node-id n0
        --port 7000 --slots 0:5461 [--peers host:port,...]
        [--replica-of host:port] [--device cuda|cpu]

Its engine's stores live on ``cuda:0`` unless ``--device cpu`` is given; a
node told ``cuda`` on a machine without a card exits at start.

The module is the JAX package's statement for statement, apart from two
repairs of one cause, a replica that records its own primary as a peer
shard, and the command line's ``--device``:

- a replica never fans a query out to the primary it replicates from
  (``_fanout_peers``, used by ``_query_fans_out`` and ``_coordinator``):
  the primary holds the replica's own slot range, so the JAX package counts
  every document twice through a replica once gossip has learnt that
  range;
- promotion forgets the primary, with or without ``dead_peer``
  (``become_replica_of`` records it, ``promote_to_primary`` drops it from
  the peers): the JAX package keeps it and its next FT.SEARCH dials the
  dead node (``Connection refused``).
"""

from __future__ import annotations

import collections
import json
import socket
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

from valkey_search_tpu_torch.cluster.metadata import (
    ClusterBus,
    MetadataEntry,
    MetadataManager,
    _V1_0,
    _entry_fingerprint,
    fingerprint64,
)
from valkey_search_tpu_torch.cluster.node import NUM_SLOTS, ConsistencyError, key_slot
from valkey_search_tpu_torch.runtime import config
from valkey_search_tpu_torch.runtime.debug import CONTROLLED
from valkey_search_tpu_torch.runtime.log import log
from valkey_search_tpu_torch.runtime.metrics import STATS
from valkey_search_tpu_torch.server.engine import Engine
from valkey_search_tpu_torch.server.resp import RespError, RespServer, SimpleString


def _s(v) -> str:
    return v.decode("utf-8", "surrogateescape") if isinstance(v, bytes) else str(v)


def _has_hashtag(name: str) -> bool:
    i = name.find("{")
    return i >= 0 and name.find("}", i + 1) > i + 1


# ---------------------------------------------------------------------------
# Minimal binary-safe RESP client (library-side; tests reuse it)
# ---------------------------------------------------------------------------

class ReplyError(Exception):
    def __init__(self, message: str):
        super().__init__(message)
        self.code = message.split(" ", 1)[0] if message else ""


class RespConnection:
    """One client connection speaking RESP2 to a node."""

    def __init__(self, addr: Tuple[str, int], timeout: float = 30.0):
        self.addr = addr
        self.sock = socket.create_connection(addr, timeout=timeout)
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self.f = self.sock.makefile("rwb")
        self._lock = threading.Lock()

    def close(self) -> None:
        try:
            self.f.close()
        finally:
            self.sock.close()

    def reconnect(self, timeout: float = 30.0) -> None:
        """Re-dial after a transport failure (EOF/ECONNRESET): the broken
        socket is unusable for every later retry otherwise."""
        with self._lock:
            try:
                self.close()
            except OSError:
                pass
            self.sock = socket.create_connection(self.addr, timeout=timeout)
            self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self.f = self.sock.makefile("rwb")

    def cmd(self, *argv):
        with self._lock:
            enc = b"*%d\r\n" % len(argv)
            for a in argv:
                if isinstance(a, str):
                    a = a.encode("utf-8", "surrogateescape")
                elif isinstance(a, (int, float)):
                    a = repr(a).encode() if isinstance(a, float) else str(a).encode()
                elif isinstance(a, (bytearray, memoryview)):
                    a = bytes(a)
                enc += b"$%d\r\n" % len(a) + a + b"\r\n"
            self.f.write(enc)
            self.f.flush()
            return self._read()

    def _read(self):
        line = self.f.readline()
        if not line:
            raise EOFError("connection closed")
        t, rest = line[:1], line[1:-2]
        if t == b"+":
            return rest.decode()
        if t == b"-":
            raise ReplyError(rest.decode())
        if t == b":":
            return int(rest)
        if t == b"$":
            n = int(rest)
            if n == -1:
                return None
            data = self.f.read(n + 2)
            if len(data) != n + 2:
                raise EOFError("short read")
            return data[:-2]
        if t == b"*":
            n = int(rest)
            if n == -1:
                return None
            return [self._read() for _ in range(n)]
        if t == b"_":
            return None
        raise ReplyError(f"unexpected reply type {line!r}")


# ---------------------------------------------------------------------------
# Node server
# ---------------------------------------------------------------------------

class _Replica:
    """Primary-side state for one registered replica connection.

    ``ready=False`` while the initial full sync replays: live writes that
    arrive meanwhile are buffered in ``backlog`` (in sequence order) and
    flushed after the snapshot, so a newer live write can never be
    overwritten by a stale snapshot replay. ``min_seq`` is the replication
    sequence at registration time — log entries at or below it are already
    contained in the snapshot and must not be re-sent (re-sending an older
    write after the snapshot could permanently regress a key)."""

    __slots__ = ("addr", "conn", "ready", "backlog", "min_seq", "lock",
                 "last_db")

    def __init__(self, addr: str, conn: "RespConnection"):
        self.addr = addr
        self.conn = conn
        self.ready = False
        self.backlog: collections.deque = collections.deque()
        self.min_seq = 0
        self.lock = threading.Lock()  # serializes sends to this conn
        self.last_db = 0  # db the stream conn last SELECTed


class NodeServer:
    """One cluster shard as a network server: Engine + metadata + gossip.

    The reference equivalent is one valkey-server process with the search
    module loaded: RESP on the client port, gRPC coordinator on port+20294;
    here both surfaces share one listener.
    """

    def __init__(
        self,
        node_id: str,
        host: str = "127.0.0.1",
        port: int = 0,
        peers: Sequence[str] = (),
        sync_ingest: bool = True,
        gossip_interval_s: float = 0.2,
    ):
        self.node_id = node_id
        self.engine = Engine(sync_ingest=sync_ingest)
        self.bus = ClusterBus()  # local-only; cross-process gossip is TCP
        self.metadata = MetadataManager(node_id, self.bus, on_apply=self._apply)
        self.engine.metadata = self.metadata
        self.slots: Tuple[int, int] = (0, NUM_SLOTS)
        self.peers: List[str] = list(peers)
        self.resp = RespServer(self.engine, host=host, port=port)
        self.resp.extra_commands.update({
            # cluster mode: FT.CREATE/FT.DROPINDEX go through the metadata
            # manager so entries exist to gossip (schema_manager.cc
            # CreateIndexSchema cluster branch → MetadataManager::CreateEntry)
            "FT.CREATE": self._cmd_ft_create,
            "FT.DROPINDEX": self._cmd_ft_dropindex,
            # node-side coordinator: FT.SEARCH/FT.AGGREGATE arriving from
            # ANY client on ANY node scatter/gathers across the cluster (the
            # reference coordinator lives in every node, coordinator/
            # server.cc — a plain cluster client never fans out itself)
            "FT.SEARCH": self._cmd_ft_search_coord,
            "FT.AGGREGATE": self._cmd_ft_aggregate_coord,
            "_PART.SEARCH": self._cmd_part_search,
            "_PART.INFO": self._cmd_part_info,
            "_META.FP": self._cmd_meta_fp,
            "_META.PULL": self._cmd_meta_pull,
            "_META.PUSH": self._cmd_meta_push,
            "_SLOTS.SET": self._cmd_slots_set,
            "_SLOTS.GET": self._cmd_slots_get,
            "_NODE.ID": lambda rest: self.node_id,
            "_REPL.REGISTER": self._cmd_repl_register,
            "_REPL.STREAM": self._cmd_repl_stream,
            "CLUSTER": self._cmd_cluster,
            # keyspace commands get cluster slot checks: a key in a slot
            # this node doesn't own answers -MOVED <slot> <host:port>
            # (valkey cluster redirect semantics), so real redis-cluster
            # clients can drive nodes directly
            **{
                c: self._keyspace_interceptor(c)
                for c in ("HSET", "DEL", "HGETALL", "HGET", "HMGET", "HDEL",
                          "EXISTS", "TYPE", "JSON.SET", "JSON.GET",
                          "EXPIRE", "PEXPIRE", "TTL", "PERSIST", "COPY",
                          "HEXPIRE", "HPEXPIRE", "HTTL", "HPTTL",
                          "HPERSIST")
            },
            # replicated metadata-update command (reference
            # ft_internal_update.cc:55 — the AOF/replica path for cluster
            # metadata; corrupted entries optionally skipped by config)
            "FT.INTERNAL_UPDATE": self._cmd_internal_update,
        })
        self.host = host
        # peer addr → (lo, hi) owned slot range (learned by gossip)
        self._peer_slots: Dict[str, Tuple[int, int]] = {}
        self._gossip_interval = gossip_interval_s
        self._gossip_stop = threading.Event()
        self._gossip_thread: Optional[threading.Thread] = None
        self._peer_conns: Dict[str, RespConnection] = {}
        # replication (P7 replica read scaling): primaries forward their
        # write stream to registered replicas; each replica's engine
        # indexes its own copy (index content is never replicated,
        # docs/topics/search.md "Index Replication").
        # The stream is strictly ordered: writes are captured into
        # _repl_log UNDER the engine lock (write_observer contract) with a
        # monotonic sequence, and a single forwarder thread sends them in
        # sequence order — concurrent writes can never reach a replica in
        # an order different from the apply order on this primary.
        self._replica_conns: Dict[str, _Replica] = {}
        self._repl_lock = threading.Lock()
        self._repl_log: "collections.deque" = collections.deque()
        self._repl_seq = 0
        self._repl_cv = threading.Condition()
        self._repl_stop = threading.Event()
        self._repl_thread: Optional[threading.Thread] = None
        self.resp.write_observer = self._forward_write
        self.resp.key_router = self._check_slot
        self.resp.multi_query_guard = self._multi_query_ok
        self.resp.engine_factory = self._make_db_engine

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "NodeServer":
        self.resp.start()
        self._ensure_gossip_thread()
        return self

    def _ensure_gossip_thread(self) -> None:
        if self.peers and self._gossip_thread is None:
            self._gossip_thread = threading.Thread(
                target=self._gossip_loop, daemon=True,
                name=f"gossip:{self.node_id}",
            )
            self._gossip_thread.start()

    def close(self) -> None:
        self._gossip_stop.set()
        self._repl_stop.set()
        with self._repl_cv:
            self._repl_cv.notify_all()
        if self._gossip_thread is not None:
            self._gossip_thread.join(2)
            self._gossip_thread = None
        if self._repl_thread is not None:
            self._repl_thread.join(2)
            self._repl_thread = None
        coord = getattr(self, "_coord", None)
        if coord is not None:
            try:
                coord.close()
            except OSError:
                pass
            self._coord = None
        for c in self._peer_conns.values():
            try:
                c.close()
            except OSError:
                pass
        self._peer_conns.clear()
        with self._repl_lock:
            reps = list(self._replica_conns.values())
            self._replica_conns.clear()
        for rep in reps:
            try:
                rep.conn.close()
            except OSError:
                pass
        self.resp.close()

    @property
    def port(self) -> int:
        return self.resp.port

    def promote_to_primary(self, dead_peer: str = "") -> None:
        """Failover: this replica keeps serving its slot range as the new
        primary. Its engine already holds the full dataset (each replica
        indexes its own copy of the write stream — index content is never
        replicated, docs/topics/search.md \"Index Replication\"), so
        promotion is a control-plane change: forget the primary it
        replicated from (and ``dead_peer``, when given) so that no gossip
        round or fanout dials it again, and accept writes (slot ownership
        was adopted at become_replica_of time)."""
        self.is_replica = False
        for dead in {dead_peer, getattr(self, "replica_of", "")} - {""}:
            self.peers = [p for p in self.peers if p != dead]
            self._peer_slots.pop(dead, None)
            conn = self._peer_conns.pop(dead, None)
            if conn is not None:
                try:
                    conn.close()
                except OSError:
                    pass

    def become_replica_of(self, primary_addr: str) -> None:
        """Attach to a primary: adopt its slots, gossip with it (metadata
        only: ``_fanout_peers`` leaves it out of every fanout), and
        receive an initial full sync + the ongoing write stream."""
        self.is_replica = True
        self.replica_of = primary_addr
        host, port_s = primary_addr.rsplit(":", 1)
        conn = RespConnection((host, int(port_s)), timeout=30.0)
        lo, hi, _nid = conn.cmd("_SLOTS.GET")
        self.slots = (int(lo), int(hi))
        if primary_addr not in self.peers:
            self.peers.append(primary_addr)
        self._ensure_gossip_thread()  # peers may arrive after start()
        conn.cmd("_REPL.REGISTER", f"{self.resp.host}:{self.port}")
        conn.close()

    def _my_replicas(self) -> List[Tuple[str, int]]:
        """(host, port) of ready replicas registered on this primary."""
        with self._repl_lock:
            reps = [r for r in self._replica_conns.values() if r.ready]
        out = []
        for r in reps:
            host, port_s = r.addr.rsplit(":", 1)
            out.append((host, int(port_s)))
        return out

    # -- node-side query coordinator ------------------------------------------
    def _fanout_peers(self) -> List[str]:
        """The gossip-learned peers a query fans out to: every one but the
        primary this node replicates (or replicated) from, which holds
        this node's own slot range — fanning out to it as well would
        count each of the range's documents twice."""
        primary = getattr(self, "replica_of", "")
        return sorted(a for a in list(self._peer_slots) if a != primary)

    def _query_fans_out(self) -> bool:
        """Fan out unless: single-node (no peer shard but this node's own
        primary), coordinator disabled, or the query runs inside
        MULTI/EXEC (the engine lock is held by THIS thread — a socket hop
        back to self would need a second handler thread that blocks on
        it; the guard already restricted EXEC queries to single-slot local
        indexes)."""
        if not self._fanout_peers():
            return False
        if not bool(config.get("search.use-coordinator")):
            return False
        from valkey_search_tpu_torch.server.resp import CURRENT_CONN

        h = getattr(CURRENT_CONN, "handler", None)
        return not (h is not None and getattr(h, "_in_exec", False))

    def _coordinator(self) -> "ClusterClient":
        """Cached fanout client over self + the peer shards, rebuilt when
        the gossip-learned peer set changes."""
        addrs = [f"{self.resp.host}:{self.port}"] + self._fanout_peers()
        cur = getattr(self, "_coord", None)
        if cur is not None and cur.addrs == addrs:
            return cur
        if cur is not None:
            try:
                cur.close()
            except OSError:
                pass
        self._coord = ClusterClient(addrs)
        return self._coord

    def _cmd_ft_search_coord(self, rest: List[bytes]):
        if not self._query_fans_out():
            return self.engine.ft_search(*rest)
        return self._coordinator().ft_search(*rest)

    def _cmd_ft_aggregate_coord(self, rest: List[bytes]):
        if not self._query_fans_out():
            return self.engine.ft_aggregate(*rest)
        return self._coordinator().ft_aggregate(*rest)

    def _cmd_cluster(self, rest: List[bytes]):
        """CLUSTER SLOTS/SHARDS/NODES/MYID/INFO for redis-cluster client
        compat: an off-the-shelf cluster client bootstraps its slot map
        from these exact reply shapes (the reference side gets them from
        valkey-server itself; vmsdk/src/cluster_map.cc consumes CLUSTER
        SLOTS the same way). Replicas registered on THIS primary are
        listed after the master entry (valkey reply contract)."""
        sub = _s(rest[0]).upper() if rest else "INFO"
        my_reps = self._my_replicas()
        ranges = [(self.slots[0], self.slots[1],
                   self.resp.host, self.port, self.node_id, my_reps)]
        for addr, (lo, hi) in sorted(self._peer_slots.items()):
            host, port_s = addr.rsplit(":", 1)
            ranges.append((lo, hi, host, int(port_s), addr, []))
        if sub == "SLOTS":
            return [
                [lo, hi - 1, [host, port, nid]]
                + [[rh, rp, f"{rh}:{rp}"] for rh, rp in reps]
                for lo, hi, host, port, nid, reps in sorted(ranges)
            ]
        if sub == "SHARDS":
            return [
                ["slots", [lo, hi - 1], "nodes",
                 [["id", nid, "endpoint", host, "port", port,
                   "role", "master", "health", "online"]]
                 + [["id", f"{rh}:{rp}", "endpoint", rh, "port", rp,
                     "role", "replica", "health", "online"]
                    for rh, rp in reps]]
                for lo, hi, host, port, nid, reps in sorted(ranges)
            ]
        if sub == "NODES":
            # the legacy text form many clients still parse:
            # <id> <ip:port@cport> <flags> <master> <ping> <pong> <epoch>
            # <state> <slot ranges...>
            lines = []
            for lo, hi, host, port, nid, reps in sorted(ranges):
                me = nid == self.node_id
                flags = ("myself," if me else "") + "master"
                lines.append(
                    f"{nid} {host}:{port}@{port} {flags} - 0 0 1 "
                    f"connected {lo}-{hi - 1}"
                )
                for rh, rp in reps:
                    lines.append(
                        f"{rh}:{rp} {rh}:{rp}@{rp} slave {nid} 0 0 1 "
                        "connected"
                    )
            return "\n".join(lines) + "\n"
        if sub == "MYID":
            return self.node_id
        if sub == "INFO":
            known = 1 + len(self._peer_slots) + len(my_reps)
            return (
                "cluster_enabled:1\r\ncluster_state:ok\r\n"
                f"cluster_known_nodes:{known}\r\n"
                f"cluster_size:{1 + len(self._peer_slots)}\r\n"
            )
        raise RespError(f"Unknown CLUSTER subcommand {sub!r}")

    def _check_slot(self, key: str) -> None:
        """Raises -MOVED when this node doesn't own the key's slot (owner
        best-known from gossip). Shared by the keyspace interceptors and
        the RESP server's MULTI/EXEC path (resp.key_router)."""
        slot = key_slot(key)
        if self.slots[0] <= slot < self.slots[1]:
            return
        owner = None
        for addr, (lo, hi) in self._peer_slots.items():
            if lo <= slot < hi:
                owner = addr
                break
        raise RespError(f"{slot} {owner or 'unknown:0'}", code="MOVED")

    def _multi_query_ok(self, index_name: str) -> bool:
        """MULTI/EXEC query guard (resp.multi_query_guard): in cluster
        mode a transaction-wrapped FT.SEARCH/FT.AGGREGATE is allowed only
        against a single-slot ({hash-tagged}) index whose slot this node
        owns (reference CME MULTI/Lua restriction, commands.cc:99-136 +
        integration/test_multi_lua.py)."""
        if not _has_hashtag(index_name):
            return False
        slot = key_slot(index_name)
        return self.slots[0] <= slot < self.slots[1]

    def _keyspace_interceptor(self, cmd: str):
        """Slot-checked keyspace command: execute locally when this node
        owns the key's slot, else -MOVED to the owner (best-known from
        gossip)."""
        writes = {"HSET", "HDEL", "DEL", "JSON.SET", "EXPIRE", "PEXPIRE",
                  "PERSIST", "COPY", "HEXPIRE", "HPEXPIRE", "HPERSIST"}

        def run(rest: List[bytes]):
            if not rest:
                raise RespError(f"wrong number of arguments for {cmd}")
            if cmd in writes and getattr(self, "is_replica", False):
                # replicas refuse client writes; the primary's replication
                # stream is exempt — the link announced itself with
                # _REPL.STREAM (valkey replica-read-only semantics;
                # reference delegates this to valkey-server)
                from valkey_search_tpu_torch.server.resp import CURRENT_CONN

                h = getattr(CURRENT_CONN, "handler", None)
                if not getattr(h, "is_repl_link", False):
                    raise RespError(
                        "You can't write against a read only replica.",
                        code="READONLY",
                    )
            self._check_slot(_s(rest[0]))
            if cmd == "COPY" and len(rest) >= 2:
                # cluster COPY: destination must hash to an owned slot too
                self._check_slot(_s(rest[1]))
            from valkey_search_tpu_torch.server.resp import CURRENT_CONN, _ok

            # logical-db routing (valkey 9 cluster dbnum): the command
            # executes against the connection's SELECTed db engine
            db = getattr(getattr(CURRENT_CONN, "handler", None), "db", 0)
            eng = self.engine if db == 0 else self.resp.engine_for(db)
            journal = self.resp.journal
            if cmd in writes and (
                self.resp.write_observer is not None or journal is not None
            ):
                # apply + capture under the engine lock so the replica
                # stream order equals the apply order; the op journal
                # appends at the same point (journal order == apply order
                # == stream order) — cluster-routed writes used to bypass
                # the journal entirely (r4 kill -9 drill caught it: every
                # post-checkpoint write on the node was lost)
                with eng._lock:
                    result = eng.execute(cmd, *rest)
                    argv = [cmd.encode()] + list(rest)
                    if self.resp.write_observer is not None:
                        self.resp.write_observer(argv, db=db)
                    if journal is not None:
                        journal.append(argv, db=db)
            else:
                result = eng.execute(cmd, *rest)
            return _ok(result)

        return run

    def _cmd_internal_update(self, rest: List[bytes]):
        if not rest:
            raise RespError("FT.INTERNAL_UPDATE payload")
        skip = bool(config.get(
            "search.skip-corrupted-internal-update-entries"
        ))
        try:
            changed = self.metadata.internal_update(rest[0], skip_corrupted=skip)
        except Exception as exc:
            raise RespError(f"corrupted internal update entry: {exc}")
        return int(changed)

    def _cmd_repl_stream(self, rest: List[bytes]):
        """Replica side: the primary announces this connection as its
        replication stream — keyspace writes on it bypass the replica's
        READONLY guard (the analog of valkey's master link flag)."""
        from valkey_search_tpu_torch.server.resp import CURRENT_CONN

        h = getattr(CURRENT_CONN, "handler", None)
        if h is not None:
            h.is_repl_link = True
        return SimpleString("OK")

    def _cmd_repl_register(self, rest: List[bytes]):
        """Primary side: record the replica and stream a full sync of the
        current keyspace (the reference uses replica full-sync over the
        same RDB path; here the keyspace replays as writes).

        Ordering: the replica registers (not-ready) and the keyspace
        snapshot is taken under ONE engine-lock critical section, so every
        write is either (a) in the snapshot (seq ≤ min_seq, forwarder
        skips it) or (b) sequenced after it (buffered in the replica's
        backlog until the snapshot finishes replaying, then flushed in
        order). A live-forwarded newer value can therefore never be
        clobbered by a stale snapshot row."""
        if not rest:
            raise RespError("_REPL.REGISTER host:port")
        addr = _s(rest[0])
        host, port_s = addr.rsplit(":", 1)
        conn = RespConnection((host, int(port_s)), timeout=30.0)
        try:
            conn.cmd("_REPL.STREAM")  # mark the link: exempt from READONLY
        except (OSError, ReplyError):
            pass
        rep = _Replica(addr, conn)
        # min_seq and EVERY db snapshot are captured inside one critical
        # section spanning all engine locks (sorted db order; write paths
        # never nest engine locks, so this cannot deadlock). A write with
        # seq <= min_seq is then provably inside its db's snapshot and a
        # later one provably not — required because replayed COPY/EXPIRE
        # entries are not idempotent over newer snapshot content.
        import contextlib

        db_snapshots = {}
        with contextlib.ExitStack() as stack:
            # _db_lock is held ACROSS registration + min_seq capture + all
            # snapshots: a lazily-created db engine (first SELECT+write)
            # blocks in engine_for until the section ends, so no engine —
            # hence no write — can slip between the snapshot set and the
            # replica becoming visible to _forward_write (ADVICE r2). Lock
            # order everywhere is _db_lock -> engine._lock, never nested
            # the other way, so this cannot deadlock.
            stack.enter_context(self.resp._db_lock)
            extra_dbs = sorted(
                (d, e) for d, e in self.resp.engines.items() if d != 0
            )
            stack.enter_context(self.engine._lock)
            for _d, eng in extra_dbs:
                stack.enter_context(eng._lock)
            with self._repl_lock:
                old = self._replica_conns.pop(addr, None)
                self._replica_conns[addr] = rep
            with self._repl_cv:
                rep.min_seq = self._repl_seq
            snapshot = {k: dict(v) for k, v in self.engine.keyspace.items()}
            for d, eng in extra_dbs:
                db_snapshots[d] = {
                    k: dict(v) for k, v in eng.keyspace.items()
                }
        if old is not None:
            try:
                old.conn.close()
            except OSError:
                pass
        self._ensure_repl_thread()
        # metadata first so indexes exist before documents arrive
        try:
            conn.cmd("_META.PUSH", self._cmd_meta_pull([]))
        except (OSError, ReplyError):
            pass
        sync_failed = False

        def _replay(db, snap):
            try:
                if rep.last_db != db:
                    conn.cmd("SELECT", str(db))
                    rep.last_db = db
            except (OSError, ReplyError):
                return False
            for key, fields in snap.items():
                argv = ["HSET", key]
                for f, v in fields.items():
                    argv += [f, v]
                try:
                    conn.cmd(*argv)
                except (OSError, ReplyError):
                    return False
            return True

        if not _replay(0, snapshot):
            sync_failed = True
        for d, snap in db_snapshots.items():
            if sync_failed:
                break
            if not _replay(d, snap):
                sync_failed = True
        # flush writes that raced the snapshot replay, then go live. A
        # send failure anywhere in the sync must NOT mark the replica
        # ready — a ready replica that missed backlog entries diverges
        # silently forever; drop the registration instead so the replica
        # re-registers and gets a fresh full sync.
        if not sync_failed:
            with rep.lock:
                while rep.backlog:
                    _seq, bdb, argv = rep.backlog.popleft()
                    try:
                        if rep.last_db != bdb:
                            conn.cmd("SELECT", str(bdb))
                            rep.last_db = bdb
                        conn.cmd(*argv)
                    except (OSError, EOFError, ReplyError):
                        sync_failed = True
                        break
                if not sync_failed:
                    rep.ready = True
        if sync_failed:
            with self._repl_lock:
                if self._replica_conns.get(addr) is rep:
                    self._replica_conns.pop(addr)
            raise ValueError("full sync aborted: replica link failed")
        return SimpleString("OK")

    def _forward_write(self, argv: List[bytes], db: int = 0) -> None:
        """write_observer hook — called UNDER the owning engine's lock
        right after a write applies. Appends to the ordered replication
        log (with the logical db, valkey 9 cluster dbnum); the forwarder
        thread drains it in sequence order.

        The emptiness check is re-taken under _repl_cv (ADVICE r2): the
        unlocked fast-path could observe the pre-registration state while
        _cmd_repl_register was mid-flight and silently drop the write from
        the stream. Registration holds every engine lock (and _db_lock)
        while inserting the replica, and this hook runs under the owning
        engine's lock, so under the cv the view is current."""
        with self._repl_cv:
            if not self._replica_conns:
                return
            self._repl_seq += 1
            self._repl_log.append((self._repl_seq, int(db), list(argv)))
            self._repl_cv.notify()

    def _ensure_repl_thread(self) -> None:
        if self._repl_thread is None or not self._repl_thread.is_alive():
            self._repl_stop.clear()
            self._repl_thread = threading.Thread(
                target=self._repl_forwarder, daemon=True,
                name=f"repl-fwd:{self.node_id}",
            )
            self._repl_thread.start()

    def _repl_forwarder(self) -> None:
        """Single sender: preserves the apply order captured in _repl_log
        across every replica (syncing replicas get entries buffered into
        their backlog; per-conn locks keep backlog-flush vs live sends
        serialized)."""
        while not self._repl_stop.is_set():
            with self._repl_cv:
                while not self._repl_log and not self._repl_stop.is_set():
                    self._repl_cv.wait(0.2)
                if not self._repl_log:
                    continue
                seq, db, argv = self._repl_log.popleft()
            with self._repl_lock:
                reps = list(self._replica_conns.items())
            dead: List[tuple] = []
            for addr, rep in reps:
                if seq <= rep.min_seq:
                    continue  # already contained in this replica's snapshot
                with rep.lock:
                    if not rep.ready:
                        rep.backlog.append((seq, db, argv))
                        continue
                    try:
                        if rep.last_db != db:
                            rep.conn.cmd("SELECT", str(db))
                            rep.last_db = db
                        rep.conn.cmd(*argv)
                    except (OSError, EOFError, ReplyError):
                        # dead replica: drop it; it re-registers on restart
                        dead.append((addr, rep))
            for addr, failed_rep in dead:
                with self._repl_lock:
                    # pop only OUR dead registration — the replica may
                    # have re-registered under the same address already,
                    # and removing the fresh entry would silently stop
                    # its replication
                    if self._replica_conns.get(addr) is failed_rep:
                        self._replica_conns.pop(addr)
                try:
                    failed_rep.conn.close()
                except OSError:
                    pass

    # -- metadata apply (index create/drop landed via gossip or local) --------
    def _apply(self, name: str, payload: Optional[Dict]) -> None:
        from valkey_search_tpu_torch.persistence.checkpoint import _build_schema
        from valkey_search_tpu_torch.schema.schema_manager import SchemaError

        # tombstones carry no payload (and so no db): drop the name from
        # every db engine — cluster index names are unique across dbs in
        # this runtime (metadata entries are keyed by name)
        engines = [self.engine]
        with self.resp._db_lock:
            engines += [e for d, e in self.resp.engines.items() if d != 0]
        for eng in engines:
            try:
                eng.manager.drop(name)
            except SchemaError:
                pass
        if payload is None:
            return
        db = int(payload.get("db", 0) or 0)
        eng = self.engine if db == 0 else self.resp.engine_for(db)
        # within a db's engine schemas register under db 0 — the logical
        # db is carried by WHICH engine holds them (RespServer multidb
        # convention); the metadata payload keeps the real db for routing
        pl = dict(payload)
        pl["db"] = 0
        schema = _build_schema(pl)
        eng.manager.create(schema)
        eng.manager.backfill(schema, eng.keyspace)

    # -- gossip loop -----------------------------------------------------------
    def _peer_conn(self, addr: str) -> RespConnection:
        conn = self._peer_conns.get(addr)
        if conn is None:
            host, port_s = addr.rsplit(":", 1)
            conn = RespConnection((host, int(port_s)), timeout=5.0)
            self._peer_conns[addr] = conn
        return conn

    def _gossip_loop(self) -> None:
        while not self._gossip_stop.wait(self._gossip_interval):
            self.gossip_once()

    def gossip_once(self) -> None:
        """One gossip round: probe each peer's fingerprint, pull+reconcile
        on mismatch (metadata_manager.h:74-76 broadcast → pull, made
        symmetric/pull-based for the socket transport)."""
        my_fp = self.metadata.top_fingerprint()
        for addr in self.peers:
            if self._gossip_stop.is_set():
                return
            try:
                conn = self._peer_conn(addr)
                if addr not in self._peer_slots:
                    lo, hi, _nid = conn.cmd("_SLOTS.GET")
                    self._peer_slots[addr] = (int(lo), int(hi))
                peer_fp = int(_s(conn.cmd("_META.FP")))
                if peer_fp == my_fp:
                    continue
                raw = conn.cmd("_META.PULL")
                self.metadata.reconcile(_decode_entries(raw))
            except (OSError, EOFError, ValueError, ReplyError):
                # peer down or mid-restart: drop the cached connection and
                # try again next round (the reference's gossip is equally
                # best-effort; convergence resumes when the peer returns)
                conn = self._peer_conns.pop(addr, None)
                if conn is not None:
                    try:
                        conn.close()
                    except OSError:
                        pass

    # -- cluster-mode index lifecycle ------------------------------------------
    def _engine_for_index(self, name: str):
        """The db engine holding a cluster index, resolved through the
        metadata entry's db (valkey 9 cluster dbnum)."""
        entry = self.metadata.get(name)
        db = 0
        if entry is not None and entry.payload is not None:
            db = int(entry.payload.get("db", 0) or 0)
        return self.engine if db == 0 else self.resp.engine_for(db)

    def _make_db_engine(self):
        """engine_factory for per-db engines on this node: they share the
        node's cluster identity (metadata ref marks cluster semantics —
        e.g. FLUSHALL keeps index definitions)."""
        eng = Engine(sync_ingest=getattr(self.engine, "_sync_ingest", True))
        eng.metadata = self.metadata
        return eng

    def _deny_replica_write(self) -> None:
        """FT.CREATE/FT.DROPINDEX are refused on replicas — index metadata
        flows primary→replica through replication/gossip only (reference
        ft_create.cc replica check; integration/test_ft_create.py
        ft_create_fails_on_replica)."""
        if getattr(self, "is_replica", False):
            raise RespError(
                "You can't write against a read only replica.",
                code="READONLY",
            )

    def _cmd_ft_create(self, rest: List[bytes]):
        from valkey_search_tpu_torch.persistence.checkpoint import _schema_definition
        from valkey_search_tpu_torch.server import ft_create as ft_create_mod

        self._deny_replica_write()

        schema, _skip = ft_create_mod.parse_ft_create([_s(a) for a in rest])
        payload = _schema_definition(schema)
        payload.pop("mutation_epoch", None)
        # the connection's SELECTed db rides in the metadata payload
        # (valkey 9 cluster dbnum; reference IndexSchema proto db_num —
        # also drives the 1.1 minimum metadata version)
        from valkey_search_tpu_torch.server.resp import CURRENT_CONN

        payload["db"] = getattr(
            getattr(CURRENT_CONN, "handler", None), "db", 0)
        existing = self.metadata.get(schema.name)
        if existing is not None and existing.payload is not None:
            # cluster index names are unique across dbs (metadata entries
            # key by name): re-creating must error, never silently destroy
            # the other db's index
            raise RespError(f"Index {schema.name} already exists")
        # normalize through JSON so the entry fingerprint is identical no
        # matter which process computed it (tuples→lists etc.)
        payload = json.loads(json.dumps(payload, sort_keys=True))
        self.metadata.create_entry(schema.name, payload)
        return SimpleString("OK")

    def _cmd_ft_dropindex(self, rest: List[bytes]):
        self._deny_replica_write()
        if not rest:
            raise RespError("wrong number of arguments for FT.DROPINDEX")
        name = _s(rest[0])
        entry = self.metadata.get(name)
        if entry is not None and entry.payload is not None:
            from valkey_search_tpu_torch.server.resp import CURRENT_CONN

            conn_db = getattr(
                getattr(CURRENT_CONN, "handler", None), "db", 0)
            if int(entry.payload.get("db", 0) or 0) != conn_db:
                # the index lives in another db: per-db isolation
                raise RespError(f"Index with name '{name}' not found")
        if self.metadata.get(name) is None:
            raise RespError(f"Index with name '{name}' not found")
        self.metadata.drop_entry(name)
        return SimpleString("OK")

    # -- internal RPC handlers ---------------------------------------------------
    def slot_fingerprint(self) -> int:
        if CONTROLLED.is_true("force_invalid_slot_fingerprint"):
            return 0xBAD
        return fingerprint64(f"{self.slots[0]}:{self.slots[1]}".encode())

    def _cmd_part_search(self, rest: List[bytes]):
        """SearchIndexPartition (coordinator.proto:24, server.cc): check
        consistency scalars, run the local shard search, return rows with
        raw distances for the coordinator merge. Success/failure counters
        + latency samplers mirror server.cc:85-92."""
        import time as _time

        t0 = _time.perf_counter()
        try:
            reply = self._part_search_inner(rest)
        except Exception:
            STATS.incr("coordinator_server_partition_failures")
            STATS.sampler("coordinator_server_partition_failure_usec", 1) \
                .observe_usec((_time.perf_counter() - t0) * 1e6)
            raise
        STATS.incr("coordinator_server_partition_successes")
        STATS.sampler("coordinator_server_partition_success_usec", 1) \
            .observe_usec((_time.perf_counter() - t0) * 1e6)
        return reply

    def _part_search_inner(self, rest: List[bytes]):
        from valkey_search_tpu_torch.query.search import execute_search
        from valkey_search_tpu_torch.server import ft_search as ft_search_mod

        if len(rest) < 4:
            raise RespError("_PART.SEARCH ver fp index query [args...]")
        expected_ver = int(_s(rest[0]))
        expected_fp = int(_s(rest[1]))
        argv = rest[2:]

        sp = ft_search_mod.parse_ft_search_args(list(argv))
        # metadata (version, fingerprint) is validated unconditionally —
        # the reference's FAILED_PRECONDITION retry loop; the slot/index
        # fingerprint drills apply only under CONSISTENT (reference
        # consistency controls: INCONSISTENT queries return valid results
        # even with ForceInvalid*Fingerprint set)
        # CONSISTENT is the default (docs/commands/ft.search.md:23),
        # overridable by search.prefer-consistent-results
        consistent = bool(sp.params.get(
            "__consistent", config.get("search.prefer-consistent-results")))
        if consistent and CONTROLLED.is_true("force_invalid_index_fingerprint"):
            STATS.incr("fanout_inconsistent")
            raise RespError(
                "index fingerprint mismatch (forced)", code="MISMATCH"
            )
        mine = self.metadata.get(sp.index_name)
        if mine is None or (mine.version, mine.fingerprint) != (
            expected_ver, expected_fp
        ):
            STATS.incr("fanout_inconsistent")
            raise RespError(
                f"{self.node_id}: index metadata mismatch", code="MISMATCH"
            )
        if consistent and self.slot_fingerprint() == 0xBAD:
            STATS.incr("fanout_inconsistent")
            raise RespError(
                f"{self.node_id}: slot ownership mismatch", code="MISMATCH"
            )

        # per-shard LIMIT window: each shard returns the merged window's
        # worth of rows (fanout.cc:322-358)
        import dataclasses as _dc

        shard_sp = _dc.replace(
            sp, limit_offset=0, limit_num=sp.limit_offset + sp.limit_num
        )
        eng = self._engine_for_index(sp.index_name)
        schema = eng.manager.get(sp.index_name)
        resp = execute_search(schema, shard_sp)
        rows = ft_search_mod.resolve_content(eng, schema, resp)
        enc_rows = []
        for nb, fields in rows:
            f_enc = None
            if fields is not None:
                f_enc = []
                for k, v in fields.items():
                    f_enc.append(k)
                    f_enc.append(v)
            enc_rows.append([
                nb.key,
                "" if nb.distance is None else repr(float(nb.distance)),
                f_enc,
            ])
        return [
            resp.total,
            -1 if resp.knn is None else resp.knn.k,
            resp.score_field or "",
            enc_rows,
        ]

    def _cmd_part_info(self, rest: List[bytes]):
        if not rest:
            raise RespError("_PART.INFO index")
        # forced-failure drills (reference CONTROLLED_INTs
        # ForceIndexNotFoundError / ForceRemoteFailCount, drilled by
        # integration/test_info_primary.py): fail the next N InfoIndex-
        # Partition RPCs, then recover — the coordinator must retry
        for var, msg in (("ForceIndexNotFoundError", "Index not found"),
                         ("ForceRemoteFailCount", "forced remote failure")):
            n = CONTROLLED.get(var)
            if n is not None and int(str(n)) > 0:
                CONTROLLED.set(var, int(str(n)) - 1)
                raise RespError(msg)
        name = _s(rest[0])
        return self._engine_for_index(name).ft_info(name)

    def _cmd_meta_fp(self, rest: List[bytes]):
        return str(self.metadata.top_fingerprint())

    def _cmd_meta_pull(self, rest: List[bytes]):
        out = {}
        for name, e in self.metadata.entries().items():
            out[name] = {"version": e.version, "payload": e.payload,
                         "min_version": e.min_version}
        return json.dumps(out, sort_keys=True)

    def _cmd_meta_push(self, rest: List[bytes]):
        if not rest:
            raise RespError("_META.PUSH json")
        changed = self.metadata.reconcile(_decode_entries(rest[0]))
        return int(changed)

    def _cmd_slots_set(self, rest: List[bytes]):
        if len(rest) != 2:
            raise RespError("_SLOTS.SET lo hi")
        self.slots = (int(_s(rest[0])), int(_s(rest[1])))
        return SimpleString("OK")

    def _cmd_slots_get(self, rest: List[bytes]):
        return [self.slots[0], self.slots[1], self.node_id]


def _decode_entries(raw) -> Dict[str, MetadataEntry]:
    d = json.loads(_s(raw))
    out = {}
    for name, m in d.items():
        payload = m["payload"]
        out[name] = MetadataEntry(
            name, int(m["version"]), _entry_fingerprint(name, payload),
            payload, int(m.get("min_version", _V1_0)),
        )
    return out


# ---------------------------------------------------------------------------
# Coordinator-side client
# ---------------------------------------------------------------------------

class ClusterClient:
    """Slot-routing, fanning-out cluster client over node sockets."""

    def __init__(
        self,
        addrs: Sequence[str],
        timeout: float = 180.0,
        replica_addrs: Optional[Sequence[Sequence[str]]] = None,
    ):
        # a generous default: the first search on a node builds its
        # kernels and publishes its stores before it answers
        if not addrs:
            raise ValueError("need at least one node address")
        self.addrs = list(addrs)
        self.conns: List[RespConnection] = []
        for a in self.addrs:
            host, port_s = a.rsplit(":", 1)
            self.conns.append(RespConnection((host, int(port_s)), timeout))
        # replica read scaling: replica_addrs[i] lists shard i's replicas
        # (reference FanoutTargetMode random/primary/replica,
        # cluster_map.h:38-46)
        self.replica_conns: List[List[RespConnection]] = []
        for i in range(len(self.addrs)):
            reps = []
            for a in (replica_addrs[i] if replica_addrs else []):
                host, port_s = a.rsplit(":", 1)
                reps.append(RespConnection((host, int(port_s)), timeout))
            self.replica_conns.append(reps)
        self._pool = ThreadPoolExecutor(
            max_workers=max(4, len(self.conns)),
            thread_name_prefix="fanout",
        )
        self.refresh_slots()

    def _search_targets(
        self, index_name: Optional[str] = None
    ) -> List[RespConnection]:
        """One connection per shard by target-selection mode. A hash-tagged
        index name ({tag}) confines the index to one slot — the query
        targets only that slot's shard, no fanout (reference
        single_slot_number_, commands.cc:99-136)."""
        import random as _random

        mode = str(config.get("search.fanout-target-mode"))
        if CONTROLLED.is_true("force_replicas_only"):
            mode = "replica"

        def pick(i):
            primary = self.conns[i]
            reps = self.replica_conns[i]
            if mode == "primary" or not reps:
                return primary
            if mode == "replica":
                return _random.choice(reps)
            return _random.choice([primary] + reps)

        if index_name and _has_hashtag(index_name):
            slot = key_slot(index_name)
            for i, (lo, hi) in enumerate(self.slot_ranges):
                if lo <= slot < hi:
                    STATS.incr("single_slot_queries")
                    return [pick(i)]
        return [pick(i) for i in range(len(self.conns))]

    def close(self) -> None:
        self._pool.shutdown(wait=False)
        for c in self.conns:
            try:
                c.close()
            except OSError:
                pass
        for reps in getattr(self, "replica_conns", []):
            for c in reps:
                try:
                    c.close()
                except OSError:
                    pass

    # -- routing ----------------------------------------------------------------
    def refresh_slots(self) -> None:
        """Snapshot slot ownership from the nodes (CLUSTER SLOTS analog,
        vmsdk/src/cluster_map.h)."""
        self.slot_ranges: List[Tuple[int, int]] = []
        for c in self.conns:
            lo, hi, _nid = c.cmd("_SLOTS.GET")
            self.slot_ranges.append((int(lo), int(hi)))

    def _conn_for_key(self, key: str) -> RespConnection:
        slot = key_slot(key)
        for (lo, hi), conn in zip(self.slot_ranges, self.conns):
            if lo <= slot < hi:
                return conn
        raise ConsistencyError(f"slot {slot} unowned")

    # -- keyspace ----------------------------------------------------------------
    def _keyspace_cmd(self, key: str, *argv):
        """Slot-routed command following -MOVED redirects (valkey cluster
        client semantics: a redirect means ownership moved — refresh the
        slot map and retry against the answering owner)."""
        for _attempt in range(4):
            try:
                return self._conn_for_key(key).cmd(*argv)
            except ReplyError as exc:
                if exc.code != "MOVED":
                    raise
                STATS.incr("moved_redirects")
                # -MOVED <slot> <host:port>: prefer the named owner, else
                # re-snapshot ownership from every node
                parts = str(exc).split()
                target = parts[2] if len(parts) >= 3 else ""
                if ":" in target and not target.startswith("unknown"):
                    host, port_s = target.rsplit(":", 1)
                    for i, c in enumerate(self.conns):
                        if c.addr == (host, int(port_s)):
                            lo, hi, _nid = c.cmd("_SLOTS.GET")
                            self.slot_ranges[i] = (int(lo), int(hi))
                            break
                self.refresh_slots()
        return self._conn_for_key(key).cmd(*argv)

    def execute(self, *argv):
        """Slot-routed single-key commands + cluster FT.* dispatch."""
        cmd = _s(argv[0]).upper()
        if cmd in ("HSET", "HGETALL", "HGET", "HMGET", "HDEL", "DEL",
                   "EXISTS", "TYPE", "JSON.SET", "JSON.GET",
                   "EXPIRE", "PEXPIRE", "TTL", "PERSIST",
                   "HEXPIRE", "HPEXPIRE", "HTTL", "HPTTL", "HPERSIST"):
            if cmd in ("DEL", "EXISTS") and len(argv) > 2:
                # multi-key forms fan out per key: keys may hash to
                # different nodes (ADVICE r4: EXISTS routed by argv[1] only
                # silently counted on the first key's node)
                return sum(
                    self._keyspace_cmd(_s(k), cmd, k) for k in argv[1:]
                )
            return self._keyspace_cmd(_s(argv[1]), *argv)
        if cmd == "FT.CREATE":
            return self.ft_create(*argv[1:])
        if cmd == "FT.DROPINDEX":
            return self.ft_dropindex(*argv[1:])
        if cmd == "FT.SEARCH":
            return self.ft_search(*argv[1:])
        if cmd == "FT.AGGREGATE":
            return self.ft_aggregate(*argv[1:])
        if cmd == "FT.INFO":
            return self.ft_info(*argv[1:])
        if cmd == "FT._LIST":
            return self.conns[0].cmd("FT._LIST")
        if cmd == "DBSIZE":
            return sum(int(c.cmd("DBSIZE")) for c in self.conns)
        if cmd == "FLUSHALL":
            for c in self.conns:
                c.cmd("FLUSHALL")
            return "OK"
        # anything else: first node answers (PING, CONFIG, INFO...)
        return self.conns[0].cmd(*argv)

    # -- metadata path -------------------------------------------------------------
    def ft_create(self, *args, timeout_s: float = 10.0) -> str:
        """FT.CREATE on one node, push the entry to the rest, then the
        consistency-check fanout: retry until every node reports the new
        (version, fingerprint) (ft_create.cc:21-80)."""
        r = self.conns[0].cmd("FT.CREATE", *args)
        blob = self.conns[0].cmd("_META.PULL")
        entries = _decode_entries(blob)
        for c in self.conns[1:]:
            try:
                c.cmd("_META.PUSH", _s(blob))
            except (OSError, ReplyError):
                pass  # gossip will converge it; fanout below verifies
        name = _s(args[0])
        want = entries.get(name)
        deadline = time.time() + timeout_s
        while True:
            ok = True
            for c in self.conns:
                try:
                    remote = _decode_entries(c.cmd("_META.PULL")).get(name)
                except (OSError, EOFError, ReplyError):
                    ok = False
                    break
                if remote is None or want is None or (
                    remote.version, remote.fingerprint
                ) != (want.version, want.fingerprint):
                    ok = False
                    break
            if ok:
                return r if isinstance(r, str) else "OK"
            if time.time() >= deadline:
                raise ConsistencyError(
                    f"index {name!r} metadata did not converge"
                )
            STATS.incr("fanout_retries")
            time.sleep(0.02)

    def ft_dropindex(self, name, timeout_s: float = 10.0) -> str:
        r = self.conns[0].cmd("FT.DROPINDEX", name)
        blob = self.conns[0].cmd("_META.PULL")
        for c in self.conns[1:]:
            try:
                c.cmd("_META.PUSH", _s(blob))
            except (OSError, ReplyError):
                pass
        deadline = time.time() + timeout_s
        name_s = _s(name)
        while time.time() < deadline:
            if all(
                name_s not in {_s(x) for x in c.cmd("FT._LIST")}
                for c in self.conns
            ):
                return r if isinstance(r, str) else "OK"
            time.sleep(0.02)
        raise ConsistencyError(f"drop of {name_s!r} did not converge")

    # -- scatter/gather search --------------------------------------------------------
    def ft_search(self, *args, max_retries: int = 3):
        from valkey_search_tpu_torch.server import ft_search as ft_search_mod

        sp = ft_search_mod.parse_ft_search_args(list(args))
        if sp.local_only:
            return self.conns[0].cmd("FT.SEARCH", *args)
        STATS.incr("fanout_queries")
        expected = _decode_entries(self.conns[0].cmd("_META.PULL")).get(
            sp.index_name
        )
        if expected is None or expected.payload is None:
            raise ReplyError(
                f"ERR Index with name '{sp.index_name}' not found"
            )
        partial_ok = bool(
            config.get("search.enable-partial-results")
            or config.get("search.prefer-partial-results")
        )
        # per-query SOMESHARDS/ALLSHARDS override the config policy
        # (reference query flags, test_cancel.py search_command)
        pp = sp.params.get("__partial_results")
        if pp is not None:
            partial_ok = bool(pp)
        last_err: Optional[Exception] = None
        for _attempt in range(max_retries):
            if _attempt:
                # refresh the expected (version, fingerprint) — the index
                # may have been recreated mid-query; retrying with stale
                # scalars would re-mismatch forever even though the
                # cluster converged (reference coordinator retries
                # FAILED_PRECONDITION with refreshed metadata)
                fresh = _decode_entries(
                    self.conns[0].cmd("_META.PULL")
                ).get(sp.index_name)
                if fresh is not None and fresh.payload is not None:
                    expected = fresh
            futures = [
                self._pool.submit(
                    c.cmd, "_PART.SEARCH",
                    str(expected.version), str(expected.fingerprint), *args,
                )
                for c in self._search_targets(sp.index_name)
            ]
            rows, totals, score_field, knn_k = [], [], None, -1
            failures: List[Exception] = []
            timeout_s = int(config.get("search.timeout-ms")) / 1000.0
            for fut in futures:
                try:
                    total, kk, sf, enc_rows = fut.result(timeout=timeout_s)
                except (ReplyError, OSError, EOFError, TimeoutError) as exc:
                    # reference coordinator_client_search_index_partition_
                    # failure_cnt (client.cc:182)
                    STATS.incr("coordinator_client_partition_failures")
                    failures.append(exc)
                    continue
                STATS.incr("coordinator_client_partition_successes")
                totals.append(int(total))
                if _s(sf):
                    score_field = _s(sf)
                if int(kk) >= 0:
                    knn_k = int(kk)
                for key, dist, f_enc in enc_rows:
                    fields = None
                    if f_enc is not None:
                        fields = {
                            _s(f_enc[i]): f_enc[i + 1]
                            for i in range(0, len(f_enc), 2)
                        }
                    rows.append((
                        _Row(_s(key),
                             None if not _s(dist) else float(_s(dist))),
                        fields,
                    ))
            hard = [
                f for f in failures
                if not (isinstance(f, ReplyError) and f.code == "MISMATCH")
            ]
            mismatches = len(failures) - len(hard)
            if not failures:
                return self._shape(rows, totals, score_field, knn_k, sp)
            last_err = failures[0]
            if partial_ok:
                STATS.incr("partial_results")
                return self._shape(rows, totals, score_field, knn_k, sp)
            if mismatches:
                # push convergence before retrying (reference: coordinator
                # retries FAILED_PRECONDITION until timeout) — replicas
                # included, since target modes may route reads to them
                STATS.incr("fanout_retries")
                blob = self.conns[0].cmd("_META.PULL")
                extras = [c for reps in self.replica_conns for c in reps]
                for c in self.conns[1:] + extras:
                    try:
                        c.cmd("_META.PUSH", _s(blob))
                    except (OSError, ReplyError):
                        pass
                time.sleep(0.02)
                continue
            break  # hard failures don't retry without partial_ok
        if sp.params.get(
            "__consistent", config.get("search.prefer-consistent-results")
        ) and isinstance(
            last_err, ReplyError
        ) and last_err.code == "MISMATCH":
            # reference client error string for CONSISTENT queries
            # (test_cancel.py expect_consistency_error)
            raise ReplyError("Index or slot consistency check failed")
        raise last_err  # type: ignore[misc]

    def _shape(self, rows, totals, score_field, knn_k, sp) -> list:
        from valkey_search_tpu_torch.query.search import SearchResponse
        from valkey_search_tpu_torch.server import ft_search as ft_search_mod

        merged = SearchResponse(
            total=sum(totals), neighbors=[], score_field=score_field
        )
        if knn_k >= 0:
            rows.sort(
                key=lambda r: r[0].distance if r[0].distance is not None else 0.0
            )
            rows = rows[:knn_k]
            merged.knn = _KnnStub(knn_k)
            total_override = len(rows)
        else:
            merged.knn = None
            total_override = sum(totals)
        return ft_search_mod.shape_reply(
            rows, merged, sp, total_override=total_override
        )

    # -- aggregate fanout --------------------------------------------------------
    def ft_aggregate(self, *args):
        """Cluster FT.AGGREGATE: fan the underlying search out through
        _PART.SEARCH (synthesized FT.SEARCH argv, full row window), merge,
        run the pipeline locally. The schema for LOAD alias resolution is
        rebuilt from the gossiped metadata payload."""
        from valkey_search_tpu_torch.persistence.checkpoint import _build_schema
        from valkey_search_tpu_torch.server import ft_aggregate as agg

        spec = agg.parse_ft_aggregate(list(args))
        expected = _decode_entries(self.conns[0].cmd("_META.PULL")).get(
            spec.index_name
        )
        if expected is None or expected.payload is None:
            raise ReplyError(
                f"ERR Index with name '{spec.index_name}' not found"
            )
        search_argv = [spec.index_name, spec.query,
                       "LIMIT", "0", str(10**9)]
        if spec.timeout_ms is not None:
            search_argv += ["TIMEOUT", str(spec.timeout_ms)]
        kv = [(k, v) for k, v in spec.params.items()
              if not k.startswith("__")]
        if kv:
            search_argv += ["PARAMS", str(2 * len(kv))]
            for k, v in kv:
                search_argv += [k, v]
        timeout_s = (
            spec.timeout_ms / 1000.0 if spec.timeout_ms
            else int(config.get("search.timeout-ms")) / 1000.0
        )
        partial_ok = bool(
            config.get("search.enable-partial-results")
            or config.get("search.prefer-partial-results")
        )
        last_err: Optional[Exception] = None
        # same retry-on-MISMATCH / partial-results policy as ft_search
        # (the reference routes FT.AGGREGATE through the same fanout
        # machinery as FT.SEARCH)
        for _attempt in range(3):
            if _attempt:
                fresh = _decode_entries(
                    self.conns[0].cmd("_META.PULL")
                ).get(spec.index_name)
                if fresh is not None and fresh.payload is not None:
                    expected = fresh
            futures = [
                self._pool.submit(
                    c.cmd, "_PART.SEARCH",
                    str(expected.version), str(expected.fingerprint),
                    *search_argv,
                )
                for c in self._search_targets(spec.index_name)
            ]
            rows, score_field, knn_k = [], None, -1
            failures: List[Exception] = []
            for fut in futures:
                try:
                    _total, kk, sf, enc_rows = fut.result(timeout=timeout_s)
                except (ReplyError, OSError, EOFError, TimeoutError) as exc:
                    failures.append(exc)
                    continue
                if _s(sf):
                    score_field = _s(sf)
                if int(kk) >= 0:
                    knn_k = int(kk)
                for key, dist, f_enc in enc_rows:
                    fields = None
                    if f_enc is not None:
                        fields = {
                            _s(f_enc[i]): f_enc[i + 1]
                            for i in range(0, len(f_enc), 2)
                        }
                    rows.append((
                        _Row(_s(key),
                             None if not _s(dist) else float(_s(dist))),
                        fields,
                    ))
            mismatches = sum(
                1 for f in failures
                if isinstance(f, ReplyError) and f.code == "MISMATCH"
            )
            if not failures or partial_ok:
                if failures:
                    STATS.incr("partial_results")
                schema = _build_schema(expected.payload)
                return agg.aggregate_rows(
                    schema, spec, rows, score_field,
                    _KnnStub(knn_k) if knn_k >= 0 else None,
                )
            last_err = failures[0]
            if mismatches:
                STATS.incr("fanout_retries")
                blob = self.conns[0].cmd("_META.PULL")
                extras = [c for reps in self.replica_conns for c in reps]
                for c in self.conns[1:] + extras:
                    try:
                        c.cmd("_META.PUSH", _s(blob))
                    except (OSError, ReplyError):
                        pass
                time.sleep(0.02)
                continue
            break  # hard failures don't retry without partial_ok
        raise last_err  # type: ignore[misc]

    # -- info fanout ----------------------------------------------------------------
    def ft_info(self, name, mode: str = "CLUSTER", max_retries: int = 8) -> list:
        """FT.INFO LOCAL|CLUSTER|PRIMARY. CLUSTER/PRIMARY fan out
        InfoIndexPartition to every primary and aggregate; transient
        per-shard failures are retried, each counted in
        search_info_fanout_retry_count (reference info fanout retry,
        integration/test_info_primary.py)."""
        mode = _s(mode).upper()
        if mode == "LOCAL":
            return self.conns[0].cmd("FT.INFO", name)
        infos = []
        deadline = time.time() + (
            int(config.get("search.ft-info-timeout-ms")) / 1000.0
        )
        for c in self.conns:
            for attempt in range(max_retries + 1):
                try:
                    i = c.cmd("_PART.INFO", name)
                    break
                except (ReplyError, OSError, EOFError) as exc:
                    # transient transport failures retry like -ERR replies
                    # (the _PART.SEARCH path catches the same set); a
                    # broken connection is re-dialed before the next try
                    if attempt == max_retries or time.time() >= deadline:
                        raise
                    STATS.incr("info_fanout_retries")
                    if not isinstance(exc, ReplyError):
                        try:
                            c.reconnect()
                        except OSError:
                            pass
                    time.sleep(0.01)
            infos.append({_s(i[j]): i[j + 1] for j in range(0, len(i), 2)})
        agg = infos[0]
        for k in ("num_docs", "num_records"):
            agg[k] = sum(int(i[k]) for i in infos)
        # per-attribute gauges aggregate across shards too (reference
        # test_ft_info_primary_attribute: num_records/user_indexed_memory
        # summed over the partitions)
        if "attributes" in agg:
            def _attr_maps(inf):
                out = {}
                for a in inf.get("attributes", ()):
                    d = {_s(a[j]): a[j + 1] for j in range(0, len(a), 2)}
                    out[_s(d.get("attribute"))] = d
                return out

            merged = _attr_maps(agg)
            for i in infos[1:]:
                for name, d in _attr_maps(i).items():
                    m = merged.setdefault(name, d)
                    if m is not d:
                        for k in ("num_records", "user_indexed_memory"):
                            if k in d:
                                m[k] = int(m.get(k, 0)) + int(d[k])
            agg["attributes"] = [
                [x for kv in d.items() for x in kv]
                for d in merged.values()
            ]
        agg["backfill_in_progress"] = max(
            int(i["backfill_in_progress"]) for i in infos
        )
        agg["mode"] = mode.lower()  # reference reports "primary"/"cluster"
        out: list = []
        for k, v in agg.items():
            out += [k, v]
        return out


class _Row:
    """Neighbor stand-in for merged remote rows (key + distance)."""

    __slots__ = ("key", "distance", "doc")

    def __init__(self, key: str, distance: Optional[float]):
        self.key = key
        self.distance = distance
        self.doc = -1


class _KnnStub:
    __slots__ = ("k",)

    def __init__(self, k: int):
        self.k = k


# ---------------------------------------------------------------------------
# Process entry point
# ---------------------------------------------------------------------------

def assign_slot_ranges(n_nodes: int) -> List[Tuple[int, int]]:
    per = NUM_SLOTS // n_nodes
    return [
        (i * per, (i + 1) * per if i < n_nodes - 1 else NUM_SLOTS)
        for i in range(n_nodes)
    ]


def main(argv: Optional[List[str]] = None) -> None:
    import argparse

    ap = argparse.ArgumentParser(description="valkey-search-tpu cluster node")
    ap.add_argument("--node-id", required=True)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--slots", default="0:16384", help="lo:hi owned range")
    ap.add_argument("--peers", default="", help="comma-separated host:port")
    ap.add_argument("--replica-of", default="",
                    help="primary host:port to replicate from")
    ap.add_argument("--async-ingest", action="store_true")
    ap.add_argument("--journal", default="",
                    help="op-journal path (AOF analog): replayed on boot, "
                         "appended under the engine lock")
    ap.add_argument("--checkpoint", default="",
                    help="checkpoint path for SAVE/BGSAVE")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the vector stores live (cuda: cuda:0, the "
                         "default; without a card the node exits)")
    ns = ap.parse_args(argv)

    from valkey_search_tpu_torch.runtime.device import set_device

    set_device(ns.device)
    if ns.journal:
        config.set_config("search.journal-path", ns.journal)
        config.set_config("search.journal-fsync-ms", 0)  # appendfsync=always
    if ns.checkpoint:
        config.set_config("search.checkpoint-path", ns.checkpoint)
    lo, hi = (int(x) for x in ns.slots.split(":"))
    peers = [p for p in ns.peers.split(",") if p]
    node = NodeServer(
        ns.node_id, host=ns.host, port=ns.port, peers=peers,
        sync_ingest=not ns.async_ingest,
    )
    node.slots = (lo, hi)
    node.start()
    if ns.replica_of:
        node.become_replica_of(ns.replica_of)
    # handshake line for the parent/orchestrator (flush immediately)
    print(f"READY {node.port}", flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        node.close()


if __name__ == "__main__":
    main()
