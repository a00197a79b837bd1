"""Query engine of the port: parser -> predicate tree -> execution.

Counterpart of valkey_search_tpu/query/. The batcher and planner are the
port's own copies of the JAX package's.
"""
