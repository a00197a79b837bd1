"""MetadataManager: versioned, fingerprinted index metadata with gossip.

Reference: src/coordinator/metadata_manager.{h,cc} — each node holds a
map of metadata entries (index definitions) tagged (version,
fingerprint); a keyed 64-bit highwayhash over the whole map is broadcast
on the cluster bus (metadata_manager.h:74-76); a node seeing an unknown
top-level fingerprint pulls GetGlobalMetadata from the sender and
reconciles per entry by last-writer-wins on (version, fingerprint)
(ReconcileMetadata, metadata_manager.h:138; docs/topics/search.md "Index
Consistency"). Losing nodes delete and recreate indexes; content is
rebuilt by backfill (§5.3 elastic recovery). Replicas receive entries
via the FT.INTERNAL_UPDATE replication command (ft_internal_update.cc).

The port's copy of valkey_search_tpu/cluster/metadata.py, statement for
statement: ``_FP_KEY``, ``MODULE_VERSION`` and ``fingerprint64`` are the
JAX package's, so a node of either package gossips the same fingerprint
for the same map and the two converge in one cluster.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import threading
from typing import Callable, Dict, List, Optional, Tuple

from valkey_search_tpu_torch.runtime.debug import CONTROLLED
from valkey_search_tpu_torch.runtime.metrics import STATS

_FP_KEY = b"valkey-search-tpu-metadata"  # stand-in for the highwayhash key


def encode_version(major: int, minor: int, patch: int = 0) -> int:
    """Reference vmsdk::ValkeyVersion packing (major<<16 | minor<<8 |
    patch, valkey_module_api utils)."""
    return (major << 16) | (minor << 8) | patch


# module semantic version: bumped when the metadata encoding grows
# features older modules can't interpret (reference kModuleVersion)
MODULE_VERSION = encode_version(1, 2, 0)
_V1_0 = encode_version(1, 0)
_V1_1 = encode_version(1, 1)
_V1_2 = encode_version(1, 2)


def min_version_for_payload(payload: Optional[Dict]) -> int:
    """Minimum module version able to interpret this entry (reference
    IndexSchema::GetMinVersion, index_schema.cc:2186-2215: text index →
    release 1.2, non-zero db → 1.1, else 1.0; the override_min_version
    controlled variable forces a value for versioning drills)."""
    ov = CONTROLLED.get("override_min_version")
    if ov is not None and int(str(ov)) != -1:
        return int(str(ov))
    if payload is None:
        return _V1_0
    if any(a.get("kind") == "TEXT" for a in payload.get("attributes", ())):
        return _V1_2
    if payload.get("db", 0) != 0:
        return _V1_1
    return _V1_0


def fingerprint64(data: bytes) -> int:
    """Keyed 64-bit fingerprint (reference: highwayhash keyed 64-bit,
    metadata_manager.h:67-69). blake2b with a key, truncated to 64 bits."""
    h = hashlib.blake2b(data, digest_size=8, key=_FP_KEY)
    return int.from_bytes(h.digest(), "little")


@dataclasses.dataclass
class MetadataEntry:
    name: str
    version: int
    fingerprint: int
    payload: Optional[Dict]  # None == tombstone (dropped index)
    # minimum module version required to interpret this entry (reference
    # GlobalMetadataEntry.min_version, coordinator.proto / metadata_manager
    # .cc:225-233); stamped at create time so the override drill survives
    # gossip hops
    min_version: int = _V1_0

    def encode(self) -> bytes:
        return json.dumps(
            {"name": self.name, "version": self.version,
             "payload": self.payload},
            sort_keys=True,
        ).encode()


def _entry_fingerprint(name: str, payload: Optional[Dict]) -> int:
    return fingerprint64(
        json.dumps({"name": name, "payload": payload}, sort_keys=True).encode()
    )


class ClusterBus:
    """In-process gossip/RPC hub connecting node callbacks by id."""

    def __init__(self):
        self._lock = threading.Lock()
        self._nodes: Dict[str, "MetadataManager"] = {}

    def join(self, manager: "MetadataManager") -> None:
        with self._lock:
            self._nodes[manager.node_id] = manager

    def leave(self, node_id: str) -> None:
        with self._lock:
            self._nodes.pop(node_id, None)

    def nodes(self) -> List[str]:
        with self._lock:
            return sorted(self._nodes)

    def peer(self, node_id: str) -> "MetadataManager":
        with self._lock:
            return self._nodes[node_id]

    def broadcast_fingerprint(self, sender: str, fingerprint: int,
                              top_min_version: int = _V1_0) -> None:
        """Cluster-bus gossip: deliver the sender's top-level fingerprint
        + minimum interpretable version to every other node (reference
        BroadcastMetadata; GlobalMetadataVersionHeader.top_level_min_version,
        metadata_manager.cc:248-250)."""
        with self._lock:
            targets = [m for nid, m in self._nodes.items() if nid != sender]
        for m in targets:
            m.on_fingerprint(sender, fingerprint, top_min_version)


class MetadataManager:
    """Per-node metadata store + reconciliation."""

    def __init__(
        self,
        node_id: str,
        bus: ClusterBus,
        on_apply: Optional[Callable[[str, Optional[Dict]], None]] = None,
    ):
        self.node_id = node_id
        self.bus = bus
        self.on_apply = on_apply  # (name, payload-or-None) → create/drop
        self._lock = threading.RLock()
        self._entries: Dict[str, MetadataEntry] = {}
        bus.join(self)

    # -- local state ---------------------------------------------------------
    def entries(self) -> Dict[str, MetadataEntry]:
        with self._lock:
            return dict(self._entries)

    def get(self, name: str) -> Optional[MetadataEntry]:
        with self._lock:
            e = self._entries.get(name)
            return e if e is not None and e.payload is not None else None

    def top_fingerprint(self) -> int:
        """Fingerprint over the whole map (broadcast payload)."""
        if CONTROLLED.is_true("force_invalid_metadata_fingerprint"):
            return 0xBAD
        with self._lock:
            blob = b"|".join(
                e.encode() for _, e in sorted(self._entries.items())
            )
        return fingerprint64(blob)

    def top_min_version(self) -> int:
        """Maximum per-entry min_version — the minimum module version able
        to interpret the whole map (reference ComputeMinVersion,
        metadata_manager.cc:830-843)."""
        with self._lock:
            return max(
                (e.min_version for e in self._entries.values()),
                default=_V1_0,
            )

    # -- mutation (the FT.CREATE/FT.DROPINDEX path) ----------------------------
    def create_entry(self, name: str, payload: Dict) -> MetadataEntry:
        with self._lock:
            prev = self._entries.get(name)
            version = (prev.version + 1) if prev is not None else 1
            entry = MetadataEntry(
                name, version, _entry_fingerprint(name, payload), payload,
                min_version_for_payload(payload),
            )
            self._entries[name] = entry
            self._apply_local(entry)
        self.broadcast()
        return entry

    def drop_entry(self, name: str) -> None:
        with self._lock:
            prev = self._entries.get(name)
            version = (prev.version + 1) if prev is not None else 1
            entry = MetadataEntry(
                name, version, _entry_fingerprint(name, None), None
            )
            self._entries[name] = entry
            self._apply_local(entry)
        self.broadcast()

    def _apply_local(self, entry: MetadataEntry) -> None:
        if self.on_apply is not None:
            self.on_apply(entry.name, entry.payload)

    # -- gossip / reconcile -----------------------------------------------------
    def broadcast(self) -> None:
        STATS.incr("metadata_broadcasts")
        self.bus.broadcast_fingerprint(
            self.node_id, self.top_fingerprint(), self.top_min_version()
        )

    def on_fingerprint(self, sender: str, fingerprint: int,
                       top_min_version: int = _V1_0) -> None:
        if top_min_version > MODULE_VERSION:
            # sender's map needs a newer module than this node runs:
            # ignore the broadcast entirely (reference metadata_manager
            # .cc:401-409; drilled by integration/test_versioning.py CME)
            STATS.incr("metadata_version_rejected")
            return
        if fingerprint == self.top_fingerprint():
            return
        try:
            remote = self.bus.peer(sender).get_global_metadata()
        except KeyError:
            return
        changed = self.reconcile(remote)
        if changed:
            # converged state may still be unknown to others; re-gossip
            self.broadcast()

    def get_global_metadata(self) -> Dict[str, MetadataEntry]:
        """The GetGlobalMetadata RPC (coordinator.proto:22)."""
        with self._lock:
            return {
                n: MetadataEntry(e.name, e.version, e.fingerprint,
                                 None if e.payload is None else dict(e.payload),
                                 e.min_version)
                for n, e in self._entries.items()
            }

    def reconcile(self, remote: Dict[str, MetadataEntry]) -> bool:
        """Per-entry last-writer-wins on (version, fingerprint)
        (reference ReconcileMetadata, metadata_manager.h:138). Ties on
        version break on the larger fingerprint so all nodes converge to
        the same winner deterministically."""
        changed = False
        to_apply: List[MetadataEntry] = []
        with self._lock:
            for name, r in remote.items():
                if r.min_version > MODULE_VERSION:
                    # entry encoded by a newer module; refuse to apply
                    # (reference top_level_min_version gate, metadata_
                    # manager.cc:401-409, applied per entry on the pull
                    # path since the socket transport reconciles directly)
                    STATS.incr("metadata_version_rejected")
                    continue
                mine = self._entries.get(name)
                if mine is not None and (mine.version, mine.fingerprint) >= (
                    r.version, r.fingerprint
                ):
                    continue
                self._entries[name] = r
                to_apply.append(r)
                changed = True
        for e in to_apply:
            self._apply_local(e)
        if changed:
            STATS.incr("metadata_reconciles")
        return changed

    # -- replication (FT.INTERNAL_UPDATE path) -----------------------------------
    def internal_update(self, raw: bytes, skip_corrupted: bool = False) -> bool:
        """Apply one replicated entry (reference ft_internal_update.cc:55;
        skip-corrupted-internal-update-entries config gates bad entries)."""
        try:
            d = json.loads(raw)
            entry = MetadataEntry(
                d["name"], int(d["version"]),
                _entry_fingerprint(d["name"], d["payload"]), d["payload"],
                int(d.get("min_version", _V1_0)),
            )
        except Exception:
            STATS.incr("internal_update_corrupted")
            if skip_corrupted:
                return False
            raise
        return self.reconcile({entry.name: entry})
