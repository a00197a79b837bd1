"""Client API surface of the port: FT.* command dispatch over a keyspace,
and the standalone RESP server in front of it.

Counterpart of valkey_search_tpu/server/. Start the server with
``python -m valkey_search_tpu_torch.server.resp [--async-ingest]``.
"""

from valkey_search_tpu_torch.server.engine import Engine  # noqa: F401
from valkey_search_tpu_torch.server.resp import RespServer  # noqa: F401
