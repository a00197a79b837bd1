"""Drive the JAX Engine and the port's Engine with the same commands.

``Both`` holds one engine of each package. ``same(*argv)`` sends one
redis-style command to both and asserts an equal outcome: an equal reply, or
an error of the same type name with the same message (returned as an
``Errored``, not raised, so a list of commands may hold failing ones). Replies are compared
as they come (floats in replies are strings, so equal strings);
``close(*argv)`` compares numeric strings within a relative tolerance, for
replies that carry distances computed on either package's own device code.
"""

import collections
import math

import numpy as np

from valkey_search_tpu.server.engine import Engine as JaxEngine
from valkey_search_tpu_torch.server.engine import Engine as PortEngine


Errored = collections.namedtuple("Errored", "type message")


def _value(got):
    return got[1] if got[0] == "ok" else Errored(got[1], got[2])


def outcome(call, *args, **kwargs):
    """("ok", value) or ("error", type name, message) of one call."""
    try:
        return ("ok", call(*args, **kwargs))
    except Exception as exc:  # noqa: BLE001 - the error is the outcome
        return ("error", type(exc).__name__, str(exc))


def _is_number(text):
    try:
        float(text)
        return True
    except (TypeError, ValueError):
        return False


def assert_close(got, want, rtol, path="reply"):
    """Equal structure; numeric strings and floats within ``rtol``."""
    if isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_close(g, w, rtol, f"{path}[{i}]")
    elif isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), path
        for k in want:
            assert_close(got[k], want[k], rtol, f"{path}[{k!r}]")
    elif isinstance(want, float) or (
            isinstance(want, str) and isinstance(got, str)
            and want != got and _is_number(want) and _is_number(got)):
        g, w = float(got), float(want)
        if math.isnan(w):
            assert math.isnan(g), path
        else:
            np.testing.assert_allclose(g, w, rtol=rtol, atol=1e-6,
                                       err_msg=path)
    else:
        assert got == want, f"{path}: {got!r} != {want!r}"


class Both:
    """One engine of each package, fed the same commands."""

    def __init__(self, **kwargs):
        self.jax = JaxEngine(**kwargs)
        self.port = PortEngine(**kwargs)
        self.engines = (self.jax, self.port)

    @classmethod
    def of(cls, jax_engine, port_engine) -> "Both":
        """A pair over two engines that exist already (restored ones)."""
        both = cls.__new__(cls)
        both.jax, both.port = jax_engine, port_engine
        both.engines = (jax_engine, port_engine)
        return both

    def same(self, *argv, **kwargs):
        """Equal outcome on both; returns the port's reply, or its error as
        an ``Errored``."""
        want = outcome(self.jax.execute, *argv, **kwargs)
        got = outcome(self.port.execute, *argv, **kwargs)
        assert got == want, f"{argv[:3]}: port {got!r} != jax {want!r}"
        return _value(got)

    def close(self, *argv, rtol=1e-5, **kwargs):
        """As ``same``, numeric strings within ``rtol``."""
        want = outcome(self.jax.execute, *argv, **kwargs)
        got = outcome(self.port.execute, *argv, **kwargs)
        assert got[0] == want[0], f"{argv[:3]}: port {got!r} != jax {want!r}"
        if want[0] == "error":
            assert got == want
        else:
            assert_close(got[1], want[1], rtol)
        return _value(got)

    def call(self, method, *args, **kwargs):
        """The same Engine method on both, equal outcome."""
        want = outcome(getattr(self.jax, method), *args, **kwargs)
        got = outcome(getattr(self.port, method), *args, **kwargs)
        assert got == want, f"{method}: port {got!r} != jax {want!r}"
        return _value(got)

    def drain(self):
        for e in self.engines:
            e.drain()

    def shutdown(self):
        for e in self.engines:
            e.stop_cron()
            if e._ingestion is not None:
                e._ingestion.shutdown()
