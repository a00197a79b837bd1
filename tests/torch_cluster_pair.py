"""Drive a socket cluster of the JAX package and one of the port side by side.

``Trio(transport)`` starts three ``NodeServer``s of one package on ephemeral
ports, as ``tests/test_transport.py``'s ``trio`` fixture does (slot ranges
from ``assign_slot_ranges(3)``, mutual gossip every 0.05 s), with a
``ClusterClient`` over them. ``TrioPair`` holds a reference trio and a port
trio with the same node ids. ``same(*argv)`` sends one argv through both
``ClusterClient``s and asserts an equal outcome (an equal reply, or an error
of the same type name and message); ``node_same(i, *argv)`` sends it to node
``i`` of each side over a ``RawClient`` and asserts byte-equal replies. Each
side's ports are written as ``PORT0``..``PORT2`` before a comparison (an
ephemeral port has five digits, so a bulk string keeps its length), since
the two trios listen on different ports; on each side node i has the i-th
lowest port, so both sides order their peers alike.
"""

import re
import socket
import threading
import time

from valkey_search_tpu.cluster import transport as jtransport
from valkey_search_tpu_torch.cluster import transport as ttransport
from torch_port_both import Errored, assert_close, outcome
from torch_resp_pair import RawClient, parse

NODE_IDS = ("n0", "n1", "n2")


def wait(cond, timeout=10.0, what="condition"):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.01)


def free_ports(n):
    """``n`` free ports, ascending. A node-side coordinator orders its
    peers by address, so two trios whose node i has the i-th lowest port
    merge the shards of a non-vector reply in the same order."""
    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return sorted(s.getsockname()[1] for s in socks)
    finally:
        for s in socks:
            s.close()


class Trio:
    """Three NodeServers of one package, gossiping, and a ClusterClient."""

    def __init__(self, transport, ids=NODE_IDS, gossip_s=0.05):
        self.transport = transport
        self.nodes = [transport.NodeServer(i, port=p,
                                           gossip_interval_s=gossip_s)
                      for i, p in zip(ids, free_ports(len(ids)))]
        for (lo, hi), n in zip(transport.assign_slot_ranges(len(ids)),
                               self.nodes):
            n.slots = (lo, hi)
        for n in self.nodes:
            n.resp.start()
        self._ports = [n.port for n in self.nodes]
        self.addrs = [f"127.0.0.1:{p}" for p in self._ports]
        for i, n in enumerate(self.nodes):
            n.peers = [a for j, a in enumerate(self.addrs) if j != i]
            n._gossip_thread = threading.Thread(target=n._gossip_loop,
                                                daemon=True)
            n._gossip_thread.start()
        self.client = transport.ClusterClient(self.addrs)
        self._conns = []

    def conn(self, i):
        c = self.transport.RespConnection(("127.0.0.1", self.nodes[i].port))
        self._conns.append(c)
        return c

    def learned(self) -> bool:
        """Every node knows both peers' slot ranges."""
        return all(len(n._peer_slots) == len(self.nodes) - 1
                   for n in self.nodes)

    def ports(self):
        return list(self._ports)

    def close(self):
        for c in self._conns:
            try:
                c.close()
            except OSError:
                pass
        self.client.close()
        for n in self.nodes:
            n.close()


def normalize(value, ports):
    """``value`` with each of ``ports`` written as ``PORT<i>``: in bytes,
    strings, ints and the error messages of ``Errored`` outcomes."""
    if isinstance(value, bytes):
        for i, p in enumerate(ports):
            value = re.sub(rb"(?<!\d)%d(?!\d)" % p, b"PORT%d" % i, value)
        return value
    if isinstance(value, str):
        return normalize(value.encode(), ports).decode()
    if isinstance(value, bool):
        return value
    if isinstance(value, int):
        return f"PORT{ports.index(value)}" if value in ports else value
    if isinstance(value, Errored):
        return Errored(value.type, normalize(value.message, ports))
    if isinstance(value, Exception):  # an error reply of RawClient's parse
        return type(value)(normalize(str(value), ports))
    if isinstance(value, (list, tuple)):
        return type(value)(normalize(v, ports) for v in value)
    if isinstance(value, dict):
        return {normalize(k, ports): normalize(v, ports)
                for k, v in value.items()}
    return value


def _text(value):
    """Bulk strings as text, so that numeric ones compare as numbers."""
    if isinstance(value, bytes):
        return value.decode("utf-8", "surrogateescape")
    if isinstance(value, list):
        return [_text(v) for v in value]
    return value


class TrioPair:
    """A reference trio and a port trio, fed the same commands."""

    def __init__(self):
        self.jax = Trio(jtransport)
        try:
            self.port = Trio(ttransport)
        except BaseException:
            self.jax.close()
            raise
        self.sides = (self.jax, self.port)
        self._raw = {}

    def learned(self):
        wait(lambda: self.jax.learned() and self.port.learned(),
             what="gossip to learn the peers' slot ranges")

    def _outcomes(self, fn, rtol=0.0):
        got = []
        for side in self.sides:
            res = outcome(fn, side)
            if res[0] == "error":
                res = ("error", res[1], normalize(res[2], side.ports()))
            else:
                res = ("ok", normalize(res[1], side.ports()))
            got.append(res)
        if rtol and got[0][0] == got[1][0] == "ok":
            assert_close(got[1][1], got[0][1], rtol)
        else:
            assert got[1] == got[0], f"port {got[1]!r} != jax {got[0]!r}"
        res = got[1]
        return res[1] if res[0] == "ok" else Errored(res[1], res[2])

    def same(self, *argv, rtol=0.0):
        """One argv through both ClusterClients; equal outcomes (numeric
        strings within ``rtol`` when it is set)."""
        return self._outcomes(lambda side: side.client.execute(*argv), rtol)

    def call(self, method, *args, **kwargs):
        """One ClusterClient method on both sides; equal outcomes."""
        return self._outcomes(
            lambda side: getattr(side.client, method)(*args, **kwargs))

    def each(self, fn):
        """``fn(side)`` on both sides; equal (normalized) outcomes."""
        return self._outcomes(fn)

    def raw(self, i):
        if i not in self._raw:
            self._raw[i] = (RawClient(self.jax.nodes[i].port),
                            RawClient(self.port.nodes[i].port))
        return self._raw[i]

    def node_same(self, i, *argv, rtol=0.0):
        """One argv to node ``i`` of each side; byte-equal replies (ports
        normalized), or with ``rtol`` set, equal parsed replies whose
        numeric strings agree within it; returns the parsed reply."""
        jc, pc = self.raw(i)
        jraw, praw = jc.cmd(*argv), pc.cmd(*argv)
        want = normalize(parse(jraw), self.jax.ports())
        got = normalize(parse(praw), self.port.ports())
        if rtol:
            assert_close(_text(got), _text(want), rtol)
        else:
            jraw = normalize(jraw, self.jax.ports())
            praw = normalize(praw, self.port.ports())
            assert praw == jraw, (f"{argv[:3]}: port {praw[:300]!r} != "
                                  f"jax {jraw[:300]!r}")
        return got

    def close(self):
        for clients in self._raw.values():
            for c in clients:
                c.close()
        self._raw.clear()
        for side in self.sides:
            side.close()
