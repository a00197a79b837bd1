"""Full-text search of the port: host structures, device masks.

Counterpart of valkey_search_tpu/text/. The lexer, stemmer, radix tree and
postings are host code, copied with their imports re-pointed (the port
imports nothing of the JAX package); each text matcher resolves to a bool tensor over the
doc-id space, which the vector scans take as a pre-filter like tag and
numeric masks.
"""

from valkey_search_tpu_torch.text.lexer import (  # noqa: F401
    DEFAULT_PUNCTUATION,
    DEFAULT_STOP_WORDS,
    Lexer,
)
from valkey_search_tpu_torch.text.posting import Postings  # noqa: F401
from valkey_search_tpu_torch.text.radix import RadixTree  # noqa: F401
from valkey_search_tpu_torch.text.stemmer import stem  # noqa: F401
from valkey_search_tpu_torch.text.text_index import (  # noqa: F401
    TextEngine,
    TextFieldIndex,
    TextOptions,
)
