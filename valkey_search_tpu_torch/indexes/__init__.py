"""Index structures of the port: FLAT and HNSW vectors, tags and numbers on torch.

Counterpart of valkey_search_tpu/indexes/ (text indexes live in
``valkey_search_tpu_torch.text``).
"""

from valkey_search_tpu_torch.indexes.base import IndexBase, RecordResult  # noqa: F401
from valkey_search_tpu_torch.indexes.flat import FlatVectorIndex  # noqa: F401
from valkey_search_tpu_torch.indexes.hnsw import HnswVectorIndex  # noqa: F401
from valkey_search_tpu_torch.indexes.numeric import NumericIndex  # noqa: F401
from valkey_search_tpu_torch.indexes.tag import TagIndex  # noqa: F401
