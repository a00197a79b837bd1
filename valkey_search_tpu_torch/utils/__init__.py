"""Host utilities of the port (its own copies of valkey_search_tpu/utils/)."""
