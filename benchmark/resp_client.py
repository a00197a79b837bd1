"""RESP encoding and an incremental reply parser, for plain sockets.

The reply grammar is chip_smoke.py's ``Resp.read`` (RESP2 and RESP3 types),
recast to parse from a buffer that may hold only part of a reply, so that one
thread can drive many non-blocking connections. It imports only the standard
library, so a load process that uses it carries neither torch nor the program.
"""

from __future__ import annotations


class ReplyError(RuntimeError):
    pass


class Incomplete(Exception):
    """The buffer ends inside a reply."""


def encode(argv) -> bytes:
    out = [b"*%d\r\n" % len(argv)]
    for a in argv:
        a = a.encode() if isinstance(a, str) else bytes(a)
        out.append(b"$%d\r\n%s\r\n" % (len(a), a))
    return b"".join(out)


def parse(buf, i: int = 0):
    """(reply, index after it) of the reply that starts at ``buf[i]``; an
    error reply comes back as a ``ReplyError`` value. Raises ``Incomplete``
    when the buffer ends first."""
    j = buf.find(b"\r\n", i)
    if j < 0:
        raise Incomplete
    kind, rest, i = buf[i:i + 1], buf[i + 1:j], j + 2
    if kind == b"+":
        return bytes(rest).decode(), i
    if kind == b"-":
        return ReplyError(bytes(rest).decode()), i
    if kind == b":":
        return int(rest), i
    if kind == b"$":
        n = int(rest)
        if n < 0:
            return None, i
        if len(buf) < i + n + 2:
            raise Incomplete
        return bytes(buf[i:i + n]), i + n + 2
    if kind in (b"*", b">", b"%"):
        n = int(rest) * (2 if kind == b"%" else 1)
        out = []
        for _ in range(n):
            v, i = parse(buf, i)
            out.append(v)
        if kind == b"%":
            return dict(zip(out[::2], out[1::2])), i
        return out, i
    if kind == b"_":
        return None, i
    if kind == b",":
        return float(rest), i
    if kind == b"#":
        return bytes(rest) == b"t", i
    raise ReplyError(f"unknown reply type {bytes(buf[i - 2 - len(rest) - 1:i])!r}")
