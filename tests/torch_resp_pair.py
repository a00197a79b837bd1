"""Drive the JAX package's RESP server and the port's over real sockets.

``RawClient`` is a minimal binary-safe RESP client that returns each reply as
the raw bytes the server wrote, so two servers' replies compare byte for
byte; ``parse`` turns raw bytes into Python values for assertions. ``Pair``
runs one reference ``RespServer`` over a JAX Engine and one port
``RespServer`` over a port Engine (on the CPU), both on ephemeral ports;
``Pair.client()`` opens one connection to each, and ``same(*argv)`` sends
the argv to both and asserts byte-equal replies. Each server has its own
config registry, so CONFIG SET over a pair sets both.
"""

import socket

from valkey_search_tpu.server.engine import Engine as JaxEngine
from valkey_search_tpu.server.resp import RespServer as JaxServer
from valkey_search_tpu_torch.server.engine import Engine as PortEngine
from valkey_search_tpu_torch.server.resp import RespServer as PortServer


def encode_argv(argv) -> bytes:
    out = b"*%d\r\n" % len(argv)
    for a in argv:
        if isinstance(a, str):
            a = a.encode()
        elif isinstance(a, (int, float)):
            a = str(a).encode()
        out += b"$%d\r\n" % len(a) + bytes(a) + b"\r\n"
    return out


class RawClient:
    """One connection; each call returns one whole reply's raw bytes."""

    def __init__(self, port: int, timeout: float = 30.0):
        self.sock = socket.create_connection(("127.0.0.1", port),
                                             timeout=timeout)
        self.f = self.sock.makefile("rwb")

    def close(self) -> None:
        try:
            self.f.close()
        finally:
            self.sock.close()

    def send_raw(self, data: bytes) -> None:
        self.f.write(data)
        self.f.flush()

    def cmd(self, *argv) -> bytes:
        self.send_raw(encode_argv(argv))
        return self.read()

    def read(self) -> bytes:
        line = self.f.readline()
        if not line:
            raise EOFError("connection closed")
        kind, rest = line[:1], line[1:-2]
        if kind == b"$":
            n = int(rest)
            return line if n < 0 else line + self.f.read(n + 2)
        if kind in (b"*", b">", b"%"):
            n = int(rest)
            parts = [line]
            for _ in range(max(n, 0) * (2 if kind == b"%" else 1)):
                parts.append(self.read())
            return b"".join(parts)
        return line


class ReplyError(Exception):
    pass


def parse(raw: bytes):
    """The Python value of one raw reply (errors become ``ReplyError``
    values, not raised)."""
    value, end = _parse(raw, 0)
    assert end == len(raw), raw
    return value


def _parse(raw: bytes, pos: int):
    end = raw.index(b"\r\n", pos)
    kind, rest = raw[pos:pos + 1], raw[pos + 1:end]
    pos = end + 2
    if kind == b"+":
        return rest.decode(), pos
    if kind == b"-":
        return ReplyError(rest.decode()), pos
    if kind == b":":
        return int(rest), pos
    if kind == b"_":
        return None, pos
    if kind == b"#":
        return rest == b"t", pos
    if kind == b",":
        return float(rest), pos
    if kind == b"$":
        n = int(rest)
        if n < 0:
            return None, pos
        return raw[pos:pos + n], pos + n + 2
    if kind in (b"*", b">"):
        out = []
        for _ in range(max(int(rest), 0)):
            item, pos = _parse(raw, pos)
            out.append(item)
        return out, pos
    if kind == b"%":
        out = {}
        for _ in range(int(rest)):
            k, pos = _parse(raw, pos)
            v, pos = _parse(raw, pos)
            out[k] = v
        return out, pos
    raise AssertionError(f"unknown reply type {raw[pos - 1:pos + 20]!r}")


class PairClient:
    """One connection to each server of a ``Pair``."""

    def __init__(self, pair: "Pair"):
        self.jax = RawClient(pair.jax.port)
        self.port = RawClient(pair.port.port)

    def close(self) -> None:
        self.jax.close()
        self.port.close()

    def both(self, *argv):
        """(reference raw reply, port raw reply)."""
        return self.jax.cmd(*argv), self.port.cmd(*argv)

    def same(self, *argv):
        """Byte-equal replies; returns the parsed reply."""
        want, got = self.both(*argv)
        assert got == want, (f"{argv[:3]}: port {got[:300]!r} != "
                             f"jax {want[:300]!r}")
        return parse(got)

    def send_raw(self, data: bytes):
        self.jax.send_raw(data)
        self.port.send_raw(data)
        want, got = self.jax.read(), self.port.read()
        assert got == want, f"{data[:40]!r}: port {got!r} != jax {want!r}"
        return parse(got)


class Pair:
    """A reference RespServer and a port RespServer, started on port 0 and
    closed (with every client opened through ``client``) by ``close``."""

    def __init__(self, jax_engine=None, port_engine=None):
        self.jax = JaxServer(jax_engine if jax_engine is not None
                             else JaxEngine(), port=0)
        self.port = PortServer(port_engine if port_engine is not None
                               else PortEngine(), port=0)
        self._clients = []

    def start(self) -> "Pair":
        self.jax.start()
        try:
            self.port.start()
        except BaseException:
            self.jax.close()
            raise
        return self

    def client(self) -> PairClient:
        c = PairClient(self)
        self._clients.append(c)
        return c

    def close(self) -> None:
        for c in self._clients:
            c.close()
        self._clients.clear()
        self.jax.close()
        self.port.close()
