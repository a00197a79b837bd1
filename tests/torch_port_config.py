"""Options for tests that drive the JAX package and its PyTorch port together.

Each package keeps its own config registry, so a test that compares the two
sets an option in both, through ``set_both``, and restores both afterwards
with ``saved_options``: no test sets one side by accident.
"""

import contextlib

from valkey_search_tpu.runtime import config as jax_config
from valkey_search_tpu_torch.runtime import config as port_config


def set_both(name, value) -> None:
    jax_config.set_config(name, value)
    port_config.set_config(name, value)


@contextlib.contextmanager
def saved_options(*names):
    """Restore ``names`` in both registries on exit."""
    before = [(name, jax_config.get(name), port_config.get(name))
              for name in names]
    try:
        yield
    finally:
        for name, jax_value, port_value in before:
            jax_config.set_config(name, jax_value)
            port_config.set_config(name, port_value)
