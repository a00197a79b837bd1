"""Cluster layer: metadata gossip, slot routing, cross-shard query fanout.

The port's copy of valkey_search_tpu/cluster/. Reference: src/coordinator/
(SURVEY.md §2.4), a gRPC data plane (GetGlobalMetadata /
SearchIndexPartition / InfoIndexPartition, coordinator.proto:21-31) plus
cluster-bus gossip of a top-level fingerprint over all index definitions;
mismatching nodes pull and reconcile per entry, last writer wins
(metadata_manager.h:138). Every cross-shard search carries the index's
fingerprint and version and a slot-ownership fingerprint; a mismatch fails
the partition (FAILED_PRECONDITION) and the coordinator retries
(server.h:60-65).

This package is host code. Each shard is an ``Engine`` whose vector stores
live on the card (``cuda:0`` unless ``runtime.device.set_device("cpu")``
was called), so a fanned-out KNN runs one scan a shard on the device:
``ClusterEngine`` (node.py) holds N shards in one process over an in-process
bus, and ``NodeServer`` / ``ClusterClient`` (transport.py) put each shard
behind its own RESP listener. Several node processes on one card each hold
their own CUDA context. A single index sharded across several devices
(the reference's parallel/) is not part of the port yet.
"""

from valkey_search_tpu_torch.cluster.metadata import (
    ClusterBus,
    MetadataEntry,
    MetadataManager,
    fingerprint64,
)
from valkey_search_tpu_torch.cluster.node import ClusterEngine, ClusterNode

__all__ = [
    "ClusterBus",
    "MetadataEntry",
    "MetadataManager",
    "fingerprint64",
    "ClusterNode",
    "ClusterEngine",
]
