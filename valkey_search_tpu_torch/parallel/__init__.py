"""Sharded search over a mesh of torch devices, driven from one process.

Counterpart of valkey_search_tpu/parallel/: the coordinator's fanout and
merge (reference src/query/fanout.cc) over corpus shards, one shard a
device (or several shards a device), with per-shard version scalars for
the coordinator's consistency check (reference
src/coordinator/server.h:60-65). ``mesh`` holds the programs, ``fanout``
the sharded HNSW index.
"""
