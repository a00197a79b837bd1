"""Version of the port and the checkpoint format it reads and writes.

The port's own copy of valkey_search_tpu/version.py: both packages write
and accept the same checkpoint versions, so a checkpoint moves between
them.
"""

__version__ = "0.1.0"

# Minimum checkpoint semantic version this build can load; mirrors the
# reference's min-semantic-version RDB header idea (reference:
# src/rdb_serialization.h:68, rfc/rdb-format.md).
CHECKPOINT_FORMAT_VERSION = 1
MIN_SUPPORTED_CHECKPOINT_VERSION = 1
