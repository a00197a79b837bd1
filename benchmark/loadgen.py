"""One load process: closed-loop FT.SEARCH over RESP connections.

Started by run.py as ``python3 benchmark/loadgen.py``, outside the server's
process, so the load does not share the server's interpreter lock. It imports
the standard library and ``resp_client`` only: neither torch nor the program.
Like valkey-benchmark, one thread drives every connection of the process
through non-blocking sockets.

Standard input carries one JSON header line, then the query pool as raw
little-endian float32 rows. Each connection draws a query (and a filter
value) from a generator seeded by the run's seed and the connection's index,
sends the FT.SEARCH, and sends the next when the reply has arrived. Once
every connection has ``warmup`` replies the process prints ``warm``; on the
line ``stop`` the connections send nothing more, the requests in flight are
waited for (``drain_s`` at most), and the process prints every request as
one JSON line: ``[conn, query, j, t_send, t_recv, keys, scores]`` (``keys``
None and ``scores`` the error's text for an error reply, ``t_recv`` None too
for a request that got no reply), times on the system's monotonic clock.
The header's ``cpus``, when given, are the CPUs the process runs on.
"""

from __future__ import annotations

import json
import os
import random
import selectors
import socket
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark.resp_client import Incomplete, ReplyError, encode, parse  # noqa: E402


def filter_clause(flt, j) -> str:
    """The query's filter for value ``j`` of the traffic's ``filter``."""
    if not flt:
        return "*"
    if flt["kind"] == "tag":
        return "@%s:{%s}" % (flt["field"], flt["value"].replace("<j>", str(j)))
    if flt["kind"] == "numeric":
        return "@%s:[%s %s]" % (flt["field"], flt["min"], flt["max"])
    raise ValueError(f"unknown filter kind {flt['kind']!r}")


def draw(seed: int, conn: int, pool_n: int, flt):
    """The endless (query, j) stream of connection ``conn``."""
    rng = random.Random(f"{seed}:{conn}")
    lo, hi = (flt.get("j", [0, 1]) if flt else [0, 1])
    while True:
        yield rng.randrange(pool_n), rng.randrange(lo, hi)


def parse_reply(reply, prefix: str):
    """(keys as row numbers, scores) of a reply to FT.SEARCH ... RETURN 1
    <score>; a key without ``prefix`` reads -1."""
    keys, scores = [], []
    for key, fields in zip(reply[1::2], reply[2::2]):
        key = key.decode()
        keys.append(int(key[len(prefix):]) if key.startswith(prefix) else -1)
        scores.append(float(fields[1]))
    return keys, scores


class Connection:
    """One closed-loop connection: a request in flight at a time."""

    def __init__(self, hdr: dict, conn: int, pool: bytes):
        self.hdr, self.conn, self.pool = hdr, conn, pool
        self.stream = draw(hdr["seed"], conn, hdr["pool_n"], hdr["filter"])
        vf, k = hdr["vector_field"], hdr["k"]
        self.head = [b"FT.SEARCH", hdr["index"]]
        self.knn = f"=>[KNN {k} @{vf} $q]"
        self.tail = [b"RETURN", b"1", f"__{vf}_score", b"LIMIT", b"0", str(k)]
        self.sock = socket.create_connection(("127.0.0.1", hdr["port"]))
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self.sock.setblocking(False)
        self.out = b""
        self.buf = bytearray()
        self.inflight = None  # [conn, query, j, t_send]
        self.replies = 0

    def send_next(self) -> None:
        qi, j = next(self.stream)
        d4 = self.hdr["dim"] * 4
        self.out = encode(self.head + [
            filter_clause(self.hdr["filter"], j) + self.knn, b"PARAMS", b"2",
            b"q", self.pool[qi * d4:(qi + 1) * d4]] + self.tail)
        self.inflight = [self.conn, qi, j, time.monotonic()]
        self.flush()

    def flush(self) -> None:
        if self.out:
            n = self.sock.send(self.out)
            self.out = self.out[n:]

    def receive(self, records: list) -> bool:
        """Read what has arrived; True once the reply in flight is whole."""
        data = self.sock.recv(1 << 20)
        if not data:
            raise EOFError("connection closed")
        self.buf += data
        try:
            reply, end = parse(self.buf)
        except Incomplete:
            return False
        t_recv = time.monotonic()
        del self.buf[:end]
        if isinstance(reply, ReplyError):
            records.append(self.inflight + [t_recv, None, str(reply)])
        else:
            keys, scores = parse_reply(reply, self.hdr["key_prefix"])
            records.append(self.inflight + [t_recv, keys, scores])
        self.inflight = None
        self.replies += 1
        return True


def main() -> int:
    stdin = sys.stdin.buffer
    hdr = json.loads(stdin.readline())
    if hdr.get("cpus"):
        os.sched_setaffinity(0, hdr["cpus"])
    pool = stdin.read(hdr["pool_n"] * hdr["dim"] * 4)
    records: list = []
    sel = selectors.DefaultSelector()
    conns = [Connection(hdr, c, pool) for c in hdr["conn_ids"]]
    for c in conns:
        c.send_next()
        sel.register(c.sock, selectors.EVENT_READ | (
            selectors.EVENT_WRITE if c.out else 0), c)
    sel.register(stdin, selectors.EVENT_READ, None)
    warm = stopping = False
    deadline = None
    while True:
        if stopping and (not any(c.inflight for c in conns)
                         or time.monotonic() > deadline):
            break
        for key, events in sel.select(timeout=0.5):
            c = key.data
            if c is None:  # "stop", or end of input when the parent is gone
                stdin.readline()
                sel.unregister(stdin)
                stopping = True
                deadline = time.monotonic() + hdr.get("drain_s", 60.0)
                continue
            try:
                if events & selectors.EVENT_WRITE:
                    c.flush()
                if events & selectors.EVENT_READ and c.receive(records):
                    if not stopping:
                        c.send_next()
                sel.modify(c.sock, selectors.EVENT_READ | (
                    selectors.EVENT_WRITE if c.out else 0), c)
            except (OSError, EOFError) as exc:
                if c.inflight:
                    records.append(c.inflight + [time.monotonic(), None,
                                                 repr(exc)])
                    c.inflight = None
                sel.unregister(c.sock)
        if not warm and all(c.replies >= hdr["warmup"] for c in conns):
            warm = True
            sys.stdout.write("warm\n")
            sys.stdout.flush()
    # a request still without its reply is a failure, not a late answer
    for c in conns:
        if c.inflight:
            records.append(c.inflight + [None, None, "no reply"])
        c.sock.close()
    sys.stdout.write(json.dumps({"records": records}) + "\n")
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
