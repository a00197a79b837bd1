"""valkey_search_tpu_torch — the vector search engine on PyTorch and CUDA.

The port of ``valkey_search_tpu`` (JAX on a TPU) to PyTorch on one NVIDIA
H100. Subpackages keep the reference package's names (``runtime``, ``ops``,
``indexes``, ``query``, ``schema``, ``server``) so each module has an
obvious counterpart; the inside is PyTorch idiom: plain functions on
tensors, an explicit ``torch.device`` carried by every vector store, and
hand-written CUDA kernels (``csrc/``) where the reference had Pallas.

This package imports ``torch`` and never ``jax``, and nothing of
``valkey_search_tpu``, not even its modules that import no JAX. Where it
needs one of those (``runtime.{config,metrics,debug}``,
``utils.{interning,cancel,lru,patricia}``, ``query.{batcher,planner}``,
``schema.attribute_data_type``, the native text tier's binding
``native_lib``) it keeps its own copy at the same path, so its config
registry, metrics and query batcher are its own even when both packages run
in one process. The native C++ sources under ``native/`` are
repository-level and built by ``native/build.py`` for either package.
"""

from valkey_search_tpu_torch.version import __version__  # noqa: F401

__all__ = ["__version__"]
