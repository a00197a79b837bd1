"""Checkpoint / restore of the port's Engine (the reference's aux-RDB).

The port's own copy of valkey_search_tpu/persistence/. The vector state is
host numpy in both packages (each store's fp32 rows, norms, magnitudes and
presence, and the native HNSW graph), so a checkpoint is the same framed
stream of (json section header, raw ndarray chunks) in both, and a file
written by either package loads in the other. No device tensor is read or
written: a restored store publishes to its device at the first search.
"""

from valkey_search_tpu_torch.persistence.format import ChunkReader, ChunkWriter, FormatError
from valkey_search_tpu_torch.persistence.checkpoint import (
    CheckpointError,
    load_engine,
    save_engine,
)

__all__ = [
    "ChunkReader",
    "ChunkWriter",
    "FormatError",
    "CheckpointError",
    "save_engine",
    "load_engine",
]
