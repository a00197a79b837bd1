"""valkey_search_tpu_torch — the vector search engine on PyTorch and CUDA.

The port of ``valkey_search_tpu`` (JAX on a TPU) to PyTorch on one NVIDIA
H100. Subpackages keep the reference package's names (``runtime``, ``ops``,
``indexes``, ``query``, ``schema``, ``server``) so each module has an
obvious counterpart; the inside is PyTorch idiom: plain functions on
tensors, an explicit ``torch.device`` carried by every vector store, and
hand-written CUDA kernels (``csrc/``) where the reference had Pallas.

This package imports ``torch`` and never ``jax``. It reuses, by import, the
reference modules that are JAX-free (``runtime.config``,
``runtime.metrics``, ``utils.{interning,cancel,lru,patricia}``,
``query.{batcher,planner}``, ``schema.attribute_data_type`` and the native
text tier ``native_lib``), so the config registry, the metrics and the query
batcher are shared with the reference when both run in one process.
"""
