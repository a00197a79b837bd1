"""ClusterNode + ClusterEngine: N-shard engine with slot routing + fanout.

Reference mapping:
- slot routing: keyspace hash slots, CRC16(XMODEM) mod 16384 with {hash
  tag} extraction (valkey cluster semantics; vmsdk/src/cluster_map.h
  snapshots slot→shard ownership with slot fingerprints :80-86).
- FT.CREATE in cluster mode goes through MetadataManager.CreateEntry →
  gossip → every node builds the index locally and backfills its own
  keys (schema_manager.cc CreateIndexSchema cluster branch; index
  content is never replicated, docs/topics/search.md "Index Replication").
  A consistency-check fanout then retries until every node reports the
  new (version, fingerprint) before OK is returned (ft_create.cc:21-80).
- FT.SEARCH scatter/gathers: per-shard search + content resolution on
  the owning shard, k-bounded merge, index-fingerprint/version and
  slot-ownership checks per shard with retry on mismatch, and the
  partial-results policy (fanout.cc:312-415, server.h:60-65).
- Per-shard LIMIT optimization for non-vector queries (fanout.cc:322-358).

The port's copy of valkey_search_tpu/cluster/node.py, statement for
statement. Each ``ClusterNode`` owns an ``Engine`` whose stores live on the
default device (``runtime.device.get_device()``, ``cuda:0`` unless set), so
all shards of one process share one CUDA context; the fanout runs the
shards one after another, one FT.SEARCH scan a shard. This module is the
host-level multi-node engine semantics, testable in-process.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

from valkey_search_tpu_torch.cluster.metadata import (
    ClusterBus,
    MetadataManager,
    fingerprint64,
)
from valkey_search_tpu_torch.persistence.checkpoint import (
    _build_schema,
    _schema_definition,
)
from valkey_search_tpu_torch.runtime import config
from valkey_search_tpu_torch.runtime.debug import CONTROLLED
from valkey_search_tpu_torch.runtime.metrics import STATS
from valkey_search_tpu_torch.server.engine import Engine

NUM_SLOTS = 16384


def _crc16_tab():
    tab = []
    for i in range(256):
        crc = i << 8
        for _ in range(8):
            crc = ((crc << 1) ^ 0x1021) if (crc & 0x8000) else (crc << 1)
            crc &= 0xFFFF
        tab.append(crc)
    return tab


_CRC16 = _crc16_tab()


def crc16(data: bytes) -> int:
    crc = 0
    for b in data:
        crc = ((crc << 8) & 0xFFFF) ^ _CRC16[((crc >> 8) ^ b) & 0xFF]
    return crc


def key_slot(key: str) -> int:
    """Valkey cluster slot with {hash tag} extraction."""
    s = key.find("{")
    if s >= 0:
        e = key.find("}", s + 1)
        if e > s + 1:
            key = key[s + 1 : e]
    return crc16(key.encode()) % NUM_SLOTS


class ConsistencyError(RuntimeError):
    """FAILED_PRECONDITION equivalent: fingerprint/version mismatch."""


class ClusterNode:
    """One shard: an Engine + its MetadataManager."""

    def __init__(self, node_id: str, bus: ClusterBus, sync_ingest: bool = True):
        self.node_id = node_id
        self.engine = Engine(sync_ingest=sync_ingest)
        self.metadata = MetadataManager(node_id, bus, on_apply=self._apply)
        self.engine.metadata = self.metadata  # FT._DEBUG SHOW_METADATA
        self.slots: Tuple[int, int] = (0, 0)  # [lo, hi) owned slot range

    def slot_fingerprint(self) -> int:
        """Fingerprint over the owned slot range (cluster_map.h:80-86)."""
        if CONTROLLED.is_true("force_invalid_slot_fingerprint"):
            return 0xBAD
        return fingerprint64(f"{self.slots[0]}:{self.slots[1]}".encode())

    def _apply(self, name: str, payload: Optional[Dict]) -> None:
        """Metadata entry landed (create, recreate, or tombstone): converge
        the local index. Losing definitions are dropped and rebuilt from
        the local keyspace by backfill (metadata_manager.h:138 semantics)."""
        from valkey_search_tpu_torch.schema.schema_manager import SchemaError

        mgr = self.engine.manager
        try:
            mgr.drop(name)
        except SchemaError:
            pass
        if payload is None:
            return
        schema = _build_schema(payload)
        mgr.create(schema)
        mgr.backfill(schema, self.engine.keyspace)


class ClusterEngine:
    """Facade over N primary shards (+ optional replicas); the
    client-visible cluster surface."""

    def __init__(
        self,
        n_nodes: int = 3,
        sync_ingest: bool = True,
        replicas_per_shard: int = 0,
    ):
        if n_nodes < 1:
            raise ValueError("need at least one node")
        self.bus = ClusterBus()
        self.nodes: List[ClusterNode] = [
            ClusterNode(f"node{i}", self.bus, sync_ingest)
            for i in range(n_nodes)
        ]
        # replica read scaling (P7): each replica indexes its own copy of
        # the replication stream — index content is NOT replicated
        # (docs/topics/search.md "Index Replication"); metadata reaches
        # replicas through the same gossip (FT.INTERNAL_UPDATE path).
        self.replicas: List[List[ClusterNode]] = [
            [
                ClusterNode(f"node{i}r{j}", self.bus, sync_ingest)
                for j in range(replicas_per_shard)
            ]
            for i in range(n_nodes)
        ]
        per = NUM_SLOTS // n_nodes
        for i, node in enumerate(self.nodes):
            lo = i * per
            hi = (i + 1) * per if i < n_nodes - 1 else NUM_SLOTS
            node.slots = (lo, hi)
            for r in self.replicas[i]:
                r.slots = (lo, hi)
        self._lock = threading.RLock()

    # -- routing ---------------------------------------------------------------
    def _shard_of(self, key: str) -> int:
        slot = key_slot(key)
        for i, node in enumerate(self.nodes):
            if node.slots[0] <= slot < node.slots[1]:
                return i
        raise RuntimeError("unowned slot")  # unreachable

    def owner(self, key: str) -> ClusterNode:
        return self.nodes[self._shard_of(key)]

    def _targets(self) -> List[ClusterNode]:
        """One node per shard by target-selection mode (reference
        FanoutTargetMode: random/primary/replica, cluster_map.h:38-46;
        ForceReplicasOnly controlled variable, commands.cc:96)."""
        import random as _random

        mode = str(config.get("search.fanout-target-mode"))
        if CONTROLLED.is_true("force_replicas_only"):
            mode = "replica"
        out: List[ClusterNode] = []
        for i, primary in enumerate(self.nodes):
            reps = self.replicas[i]
            if mode == "primary" or not reps:
                out.append(primary)
            elif mode == "replica":
                out.append(_random.choice(reps))
            else:
                out.append(_random.choice([primary] + reps))
        return out

    # -- keyspace --------------------------------------------------------------
    def hset(self, key: str, mapping: Dict[str, object]) -> int:
        i = self._shard_of(key)
        n = self.nodes[i].engine.hset(key, mapping)
        for r in self.replicas[i]:
            r.engine.hset(key, mapping)  # replication stream apply
        return n

    def delete(self, key: str) -> int:
        i = self._shard_of(key)
        n = self.nodes[i].engine.delete(key)
        for r in self.replicas[i]:
            r.engine.delete(key)
        return n

    def hgetall(self, key: str) -> Dict[str, object]:
        return self.owner(key).engine.hgetall(key)

    def drain(self) -> None:
        for node in self.nodes:
            node.engine.drain()
        for reps in self.replicas:
            for r in reps:
                r.engine.drain()

    # -- metadata path -----------------------------------------------------------
    def ft_create(self, *args, timeout_s: float = 5.0) -> str:
        from valkey_search_tpu_torch.server import ft_create as ft_create_mod

        schema, _skip = ft_create_mod.parse_ft_create([_s(a) for a in args])
        payload = _schema_definition(schema)
        payload.pop("mutation_epoch", None)
        entry = self.nodes[0].metadata.create_entry(schema.name, payload)
        self._await_consistency(schema.name, entry, timeout_s)
        return "OK"

    def ft_dropindex(self, name: str, timeout_s: float = 5.0) -> str:
        name = _s(name)
        self.nodes[0].metadata.get(name) or self._missing(name)
        self.nodes[0].metadata.drop_entry(name)
        deadline = time.time() + timeout_s
        while time.time() < deadline:
            if all(n.metadata.get(name) is None for n in self._all_nodes()):
                return "OK"
            self.nodes[0].metadata.broadcast()
        raise ConsistencyError(f"drop of {name!r} did not converge")

    def _missing(self, name: str):
        raise KeyError(f"unknown index {name!r}")

    def _all_nodes(self) -> List[ClusterNode]:
        out = list(self.nodes)
        for reps in self.replicas:
            out.extend(reps)
        return out

    def _await_consistency(self, name: str, entry, timeout_s: float) -> None:
        """FT.CREATE consistency-check fanout (ft_create.cc:21-80): retry
        until every node reports the new (version, fingerprint)."""
        deadline = time.time() + timeout_s
        while True:
            ok = all(
                (e := n.metadata.get(name)) is not None
                and (e.version, e.fingerprint)
                == (entry.version, entry.fingerprint)
                for n in self._all_nodes()
            )
            if ok:
                return
            if time.time() >= deadline:
                raise ConsistencyError(
                    f"Unable to contact all cluster members: index "
                    f"{name!r} metadata did not converge"
                )
            STATS.incr("fanout_retries")
            self.nodes[0].metadata.broadcast()

    def ft_list(self) -> List[str]:
        return self.nodes[0].engine.ft_list()

    # -- queries -------------------------------------------------------------------
    def ft_search(self, *args, max_retries: int = 3) -> list:
        from valkey_search_tpu_torch.query.search import SearchResponse
        from valkey_search_tpu_torch.server import ft_search as ft_search_mod

        sp = ft_search_mod.parse_ft_search_args(list(args))
        if sp.local_only:
            node = self.nodes[0]
            return node.engine.ft_search(*args)
        STATS.incr("fanout_queries")
        expected = self.nodes[0].metadata.get(sp.index_name)
        if expected is None:
            self._missing(sp.index_name)

        # per-shard LIMIT optimization (non-vector): each shard returns the
        # merged window worth of rows (fanout.cc:322-358)
        shard_sp = sp
        import dataclasses as _dc

        shard_sp = _dc.replace(
            sp, limit_offset=0, limit_num=sp.limit_offset + sp.limit_num
        )

        partial_ok = bool(
            config.get("search.enable-partial-results")
            or config.get("search.prefer-partial-results")
        )
        from valkey_search_tpu_torch.utils import cancel

        token = cancel.from_timeout_ms(sp.timeout_ms)
        last_err: Optional[Exception] = None
        for _attempt in range(max_retries):
            token.check()
            rows, totals, score_field, knn, failures = [], [], None, None, []
            for node in self._targets():
                try:
                    r, t, sf, kn = self._search_partition(
                        node, shard_sp, expected, token
                    )
                except ConsistencyError as exc:
                    failures.append(exc)
                    continue
                rows.extend(r)
                totals.append(t)
                if sf is not None:
                    score_field = sf
                if kn is not None:
                    knn = kn
            if not failures:
                return self._shape(rows, totals, score_field, knn, sp)
            last_err = failures[0]
            if partial_ok:
                STATS.incr("partial_results")
                return self._shape(rows, totals, score_field, knn, sp)
            STATS.incr("fanout_retries")
            self.nodes[0].metadata.broadcast()  # push convergence, retry
        raise last_err  # type: ignore[misc]

    def _search_partition(self, node: ClusterNode, sp, expected, token=None):
        """One shard's SearchIndexPartition (server.cc): fingerprint checks
        then local search + content resolution on the owning shard."""
        from valkey_search_tpu_torch.query.search import execute_search
        from valkey_search_tpu_torch.server import ft_search as ft_search_mod

        if token is not None:
            token.check()

        # slot/index fingerprint drills honor the per-query CONSISTENT
        # flag (INCONSISTENT returns valid results even when forced —
        # reference consistency controls); default is consistent here to
        # preserve the strict in-process simulation semantics
        consistent = sp.params.get(
            "__consistent", config.get("search.prefer-consistent-results"))
        if consistent and CONTROLLED.is_true("force_invalid_index_fingerprint"):
            raise ConsistencyError("forced index fingerprint mismatch")
        mine = node.metadata.get(sp.index_name)
        if mine is None or (mine.version, mine.fingerprint) != (
            expected.version, expected.fingerprint
        ):
            STATS.incr("fanout_inconsistent")
            raise ConsistencyError(
                f"{node.node_id}: index metadata mismatch"
            )
        if consistent and node.slot_fingerprint() == 0xBAD:
            STATS.incr("fanout_inconsistent")
            raise ConsistencyError(f"{node.node_id}: slot ownership mismatch")
        schema = node.engine.manager.get(sp.index_name)
        resp = execute_search(schema, sp)
        rows = ft_search_mod.resolve_content(node.engine, schema, resp)
        return rows, resp.total, resp.score_field, resp.knn

    def _shape(self, rows, totals, score_field, knn, sp) -> list:
        from valkey_search_tpu_torch.query.search import SearchResponse
        from valkey_search_tpu_torch.server import ft_search as ft_search_mod

        merged = SearchResponse(
            total=sum(totals), neighbors=[], score_field=score_field
        )
        merged.knn = knn
        if knn is not None:
            rows.sort(
                key=lambda r: r[0].distance if r[0].distance is not None else 0.0
            )
            rows = rows[: knn.k]
            total_override = len(rows)
        else:
            total_override = sum(totals)
        return ft_search_mod.shape_reply(
            rows, merged, sp, total_override=total_override
        )

    # -- aggregate fanout ----------------------------------------------------------
    def ft_aggregate(self, *args, max_retries: int = 3) -> list:
        """FT.AGGREGATE over the cluster: fan out the underlying search to
        every shard (no per-shard LIMIT optimization — aggregation needs
        all matching rows), then run the stage pipeline on the coordinator
        over the merged rows (reference: FT.AGGREGATE routes through the
        same QueryCommand fanout as FT.SEARCH, ft_aggregate.cc:462)."""
        from valkey_search_tpu_torch.query.search import SearchParameters
        from valkey_search_tpu_torch.server import ft_aggregate as agg

        spec = agg.parse_ft_aggregate(list(args))
        expected = self.nodes[0].metadata.get(spec.index_name)
        if expected is None:
            self._missing(spec.index_name)
        sp = SearchParameters(
            index_name=spec.index_name, query=spec.query,
            params=spec.params, timeout_ms=spec.timeout_ms,
            no_content=False, limit_offset=0, limit_num=10**9,
        )
        STATS.incr("fanout_queries")
        last_err = None
        for _attempt in range(max_retries):
            rows, score_field, knn, failures = [], None, None, []
            for node in self._targets():
                try:
                    r, _t, sf, kn = self._search_partition(
                        node, sp, expected
                    )
                except ConsistencyError as exc:
                    failures.append(exc)
                    continue
                rows.extend(r)
                if sf is not None:
                    score_field = sf
                if kn is not None:
                    knn = kn
            if not failures:
                schema = self.nodes[0].engine.manager.get(spec.index_name)
                return agg.aggregate_rows(schema, spec, rows, score_field, knn)
            last_err = failures[0]
            STATS.incr("fanout_retries")
            self.nodes[0].metadata.broadcast()
        raise last_err

    # -- info fanout -------------------------------------------------------------
    def ft_info(self, name: str, mode: str = "CLUSTER") -> list:
        """FT.INFO with LOCAL/PRIMARY/CLUSTER aggregation
        (ft_info_parser.cc modes)."""
        name = _s(name)
        mode = mode.upper()
        if mode == "LOCAL":
            return self.nodes[0].engine.ft_info(name)
        infos = [dict(zip(i[::2], i[1::2]))
                 for i in (n.engine.ft_info(name) for n in self.nodes)]
        agg = infos[0]
        agg["num_docs"] = sum(i["num_docs"] for i in infos)
        agg["num_records"] = sum(i["num_records"] for i in infos)
        agg["hash_indexing_failures"] = max(
            i["hash_indexing_failures"] for i in infos
        )
        agg["backfill_in_progress"] = max(
            i["backfill_in_progress"] for i in infos
        )
        agg["mode"] = mode
        out: list = []
        for k, v in agg.items():
            out += [k, v]
        return out

    # -- persistence --------------------------------------------------------------
    def save(self, directory: str) -> Dict[str, int]:
        """Cluster-wide checkpoint: one chunked file per shard plus a
        manifest (slot layout + metadata entries). The reference's
        equivalent is each node BGSAVE-ing its own aux-RDB; metadata
        reconverges by gossip on restart."""
        import json as _json
        import os

        os.makedirs(directory, exist_ok=True)
        totals = {"schemas": 0, "keys": 0}
        manifest = {"nodes": [], "metadata": {}}
        for i, node in enumerate(self.nodes):
            path = os.path.join(directory, f"node{i}.vstpu")
            s = node.engine.save(path)
            totals["schemas"] = max(totals["schemas"], s["schemas"])
            totals["keys"] += s["keys"]
            manifest["nodes"].append({
                "node_id": node.node_id, "file": f"node{i}.vstpu",
                "slots": list(node.slots),
            })
        for name, e in self.nodes[0].metadata.entries().items():
            manifest["metadata"][name] = {
                "version": e.version, "payload": e.payload,
            }
        with open(os.path.join(directory, "manifest.json"), "w") as f:
            _json.dump(manifest, f)
        return totals

    @classmethod
    def load(cls, directory: str, sync_ingest: bool = True) -> "ClusterEngine":
        """Restore a cluster checkpoint: per-shard engines come back from
        their chunked files; index metadata re-registers through each
        node's MetadataManager so gossip state is converged from the
        start."""
        import json as _json
        import os

        from valkey_search_tpu_torch.persistence import load_engine

        with open(os.path.join(directory, "manifest.json")) as f:
            manifest = _json.load(f)
        cluster = cls(n_nodes=len(manifest["nodes"]), sync_ingest=sync_ingest)
        for i, info in enumerate(manifest["nodes"]):
            node = cluster.nodes[i]
            node.slots = tuple(info["slots"])
            # schemas rebuild from the checkpoint (drop the freshly
            # created empty engine state first)
            node.engine = type(node.engine)(sync_ingest=sync_ingest)
            load_engine(os.path.join(directory, info["file"]),
                        engine=node.engine)
            node.engine.metadata = node.metadata
        # re-seed the metadata maps so entries carry their saved versions
        # (schemas were already restored from the checkpoints, so entries
        # are written directly instead of through on_apply; gossip keeps
        # them converged from here)
        from valkey_search_tpu_torch.cluster.metadata import (
            MetadataEntry,
            _entry_fingerprint,
        )

        for name, m in manifest["metadata"].items():
            entry = MetadataEntry(
                name, int(m["version"]),
                _entry_fingerprint(name, m["payload"]), m["payload"],
            )
            for node in cluster._all_nodes():
                with node.metadata._lock:
                    node.metadata._entries[name] = entry
        return cluster

    # -- generic dispatch -----------------------------------------------------------
    def execute(self, *argv):
        cmd = _s(argv[0]).upper()
        rest = list(argv[1:])
        if cmd == "HSET":
            mapping = {_s(rest[i]): rest[i + 1] for i in range(1, len(rest), 2)}
            return self.hset(_s(rest[0]), mapping)
        if cmd == "DEL":
            return sum(self.delete(_s(k)) for k in rest)
        if cmd == "HGETALL":
            return self.hgetall(_s(rest[0]))
        if cmd == "FT.CREATE":
            return self.ft_create(*rest)
        if cmd == "FT.DROPINDEX":
            return self.ft_dropindex(*rest)
        if cmd == "FT.SEARCH":
            return self.ft_search(*rest)
        if cmd == "FT.AGGREGATE":
            return self.ft_aggregate(*rest)
        if cmd == "FT.INFO":
            return self.ft_info(*rest)
        if cmd == "FT._LIST":
            return self.ft_list()
        raise ValueError(f"unknown cluster command {cmd!r}")


def _s(v) -> str:
    return v.decode() if isinstance(v, bytes) else str(v)
