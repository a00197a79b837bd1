"""RESP network serving layer: any Redis/Valkey client can drive the engine.

The port's copy of valkey_search_tpu/server/resp.py: a standalone RESP2/RESP3
server in front of ``Engine.execute`` (the reference is a Valkey module, so
valkey-server speaks RESP for it; src/module_loader.cc:33-129). redis-cli,
redis-py and valkey-py connect unchanged and issue HSET / FT.CREATE /
FT.SEARCH as against the reference. Start it with

    python -m valkey_search_tpu_torch.server.resp [--port 6379] [--async-ingest]
        [--device cuda|cpu]

- One thread per connection. FT.SEARCH goes through
  ``Engine.ft_search_async``: the reader pool and the query batcher
  (query/batcher.py) coalesce concurrent KNN queries from different
  connections into one scan launch on the card. Inside MULTI/EXEC and EVAL
  a search runs inline under the engine lock, one launch per request.
- Binary-safe: argv elements stay ``bytes`` end to end (vector blobs in HSET
  values and PARAMS never pass through a text decode).
- RESP3 through HELLO 3; RESP2 by default.

Connection-level commands served here (valkey-server serves them for the
reference): PING, ECHO, HELLO, AUTH, SELECT, SWAPDB, QUIT, RESET, CLIENT,
COMMAND, DBSIZE, FLUSHALL, FLUSHDB, MULTI/EXEC/DISCARD, ACL, CONFIG, INFO,
EVAL/EVALSHA/SCRIPT (server/lua.py), pub/sub with keyspace notifications,
SAVE, BGSAVE and SHUTDOWN; with ``search.journal-path`` set, the op journal
(persistence/journal.py) and boot recovery.

The module is the JAX package's statement for statement, apart from the
spans of a sampled command (``_Handler.handle`` and ``_reply`` record
``resp.command`` and ``resp.write`` into runtime/metrics.py's ``TRACE``)
and the forked BGSAVE, which a process that holds a CUDA context changes
(``bgsave_forked``, ``_engine_aux_locks``, ``_detach_after_fork``):

- the fork barrier also holds each engine's schema manager lock and each
  HNSW index's native builder lock, both of which the child's save path
  takes, and takes an HNSW index's graph lock before its index lock and the
  key interner's lock after the index locks, in the order the serving
  threads nest them (the JAX package's order can deadlock the parent
  against a graph publish or a synchronous HSET);
- the child makes the process-wide leaf locks of its save path anew and
  drops its engines' writer pools, whose threads do not exist after a fork;
- nothing the child runs touches CUDA: every array it saves is host numpy.

The command line takes ``--device`` (``cuda``, the default, or ``cpu``).
"""

from __future__ import annotations

import io
import os
import socket
import socketserver
import threading
from fnmatch import fnmatchcase
from typing import Any, Dict, List, Optional

from valkey_search_tpu_torch.runtime import config
from valkey_search_tpu_torch.runtime.log import log
from valkey_search_tpu_torch.runtime.metrics import CTX, SPAN, TRACE, clock
from valkey_search_tpu_torch.server.engine import (
    CommandError,
    Engine,
    OutOfMemoryError,
)

CRLF = b"\r\n"


class SimpleString(str):
    """Marker: encode as +str (RESP simple string) instead of bulk."""


class RespError(Exception):
    """Carries a redis-style error line (first word = error code)."""

    def __init__(self, message: str, code: str = "ERR"):
        super().__init__(message)
        self.code = code


class Push(list):
    """Marker: a pub/sub push frame — RESP3 encodes as >N, RESP2 as a
    plain array (subscribe confirmations and message deliveries)."""


# --------------------------------------------------------------------------
# Encoding
# --------------------------------------------------------------------------

def _fmt_double(x: float) -> bytes:
    if x == int(x) and abs(x) < 1e17:
        return str(int(x)).encode()
    return repr(x).encode()


def encode(value: Any, proto: int = 2) -> bytes:
    """Encode a Python reply value as RESP2 (proto=2) or RESP3 (proto=3)."""
    out = io.BytesIO()
    _encode_into(out, value, proto)
    return out.getvalue()


def _encode_into(out: io.BytesIO, v: Any, proto: int) -> None:
    if isinstance(v, RespError):
        msg = str(v).replace("\r", " ").replace("\n", " ")
        code = v.code
        head = msg.split(" ", 1)[0]
        prefix = "" if head.isupper() and head == code else code + " "
        out.write(b"-" + (prefix + msg).encode() + CRLF)
    elif isinstance(v, SimpleString):
        out.write(b"+" + str(v).encode() + CRLF)
    elif v is None:
        out.write(b"_" + CRLF if proto >= 3 else b"$-1" + CRLF)
    elif isinstance(v, bool):
        if proto >= 3:
            out.write(b"#t" + CRLF if v else b"#f" + CRLF)
        else:
            out.write(b":1" + CRLF if v else b":0" + CRLF)
    elif isinstance(v, int):
        out.write(b":" + str(v).encode() + CRLF)
    elif isinstance(v, float):
        if proto >= 3:
            out.write(b"," + _fmt_double(v) + CRLF)
        else:
            b = _fmt_double(v)
            out.write(b"$" + str(len(b)).encode() + CRLF + b + CRLF)
    elif isinstance(v, (bytes, bytearray, memoryview)):
        b = bytes(v)
        out.write(b"$" + str(len(b)).encode() + CRLF + b + CRLF)
    elif isinstance(v, str):
        b = v.encode("utf-8", "surrogateescape")
        out.write(b"$" + str(len(b)).encode() + CRLF + b + CRLF)
    elif isinstance(v, dict):
        if proto >= 3:
            out.write(b"%" + str(len(v)).encode() + CRLF)
            for k, val in v.items():
                _encode_into(out, k, proto)
                _encode_into(out, val, proto)
        else:
            out.write(b"*" + str(2 * len(v)).encode() + CRLF)
            for k, val in v.items():
                _encode_into(out, k, proto)
                _encode_into(out, val, proto)
    elif isinstance(v, Push):
        out.write((b">" if proto >= 3 else b"*")
                  + str(len(v)).encode() + CRLF)
        for item in v:
            _encode_into(out, item, proto)
    elif isinstance(v, (list, tuple)):
        out.write(b"*" + str(len(v)).encode() + CRLF)
        for item in v:
            _encode_into(out, item, proto)
    else:  # numpy scalars and friends: degrade to their string form
        _encode_into(out, str(v), proto)


# --------------------------------------------------------------------------
# Decoding (client → server direction: arrays of bulk strings + inline)
# --------------------------------------------------------------------------

class ProtocolError(Exception):
    pass


class CommandReader:
    """Incremental reader of client commands from a socket file."""

    def __init__(self, rfile):
        self._r = rfile

    def _readline(self, limit: int = 64 * 1024) -> bytes:
        line = self._r.readline(limit + 2)
        if not line:
            raise EOFError
        if not line.endswith(b"\r\n"):
            if line.endswith(b"\n"):  # tolerate bare LF for inline/telnet use
                return line[:-1].rstrip(b"\r")
            raise ProtocolError("too big inline request or missing CRLF")
        return line[:-2]

    def read_command(self) -> Optional[List[bytes]]:
        """Returns argv as a list of bytes, or None for an empty inline line.

        Raises EOFError on clean connection close."""
        line = self._readline()
        if not line:
            return None
        if line[:1] == b"*":
            try:
                n = int(line[1:])
            except ValueError:
                raise ProtocolError("invalid multibulk length")
            if n < 0 or n > 1024 * 1024:
                raise ProtocolError("invalid multibulk length")
            argv: List[bytes] = []
            for _ in range(n):
                hdr = self._readline()
                if hdr[:1] != b"$":
                    raise ProtocolError(
                        f"expected '$', got {hdr[:1].decode(errors='replace')!r}"
                    )
                try:
                    blen = int(hdr[1:])
                except ValueError:
                    raise ProtocolError("invalid bulk length")
                if blen < 0 or blen > 512 * 1024 * 1024:
                    raise ProtocolError("invalid bulk length")
                data = self._r.read(blen + 2)
                if len(data) != blen + 2 or data[-2:] != CRLF:
                    raise EOFError
                argv.append(data[:-2])
            return argv
        # inline command (redis protocol compat: space-split, no quoting
        # beyond simple double/single quotes)
        return _split_inline(line)


def _split_inline(line: bytes) -> List[bytes]:
    parts: List[bytes] = []
    i, n = 0, len(line)
    while i < n:
        while i < n and line[i : i + 1].isspace():
            i += 1
        if i >= n:
            break
        quote = line[i : i + 1]
        if quote in (b'"', b"'"):
            i += 1
            buf = bytearray()
            while i < n and line[i : i + 1] != quote:
                if quote == b'"' and line[i : i + 1] == b"\\" and i + 1 < n:
                    i += 1
                    esc = line[i : i + 1]
                    buf += {b"n": b"\n", b"r": b"\r", b"t": b"\t"}.get(esc, esc)
                else:
                    buf += line[i : i + 1]
                i += 1
            if i >= n:
                raise ProtocolError("unbalanced quotes in request")
            i += 1
            parts.append(bytes(buf))
        else:
            j = i
            while j < n and not line[j : j + 1].isspace():
                j += 1
            parts.append(line[i:j])
            i = j
    return parts


# --------------------------------------------------------------------------
# Server
# --------------------------------------------------------------------------

def _s(v) -> str:
    return v.decode("utf-8", "surrogateescape") if isinstance(v, bytes) else str(v)


CURRENT_CONN = threading.local()


class _Handler(socketserver.StreamRequestHandler):
    rbufsize = 64 * 1024
    wbufsize = 64 * 1024

    def setup(self):
        super().setup()
        self.connection.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self.proto = 2
        self.user = "default"
        self.authenticated = False
        self.db = 0
        self.client_name = ""
        self.multi_queue: Optional[List[List[bytes]]] = None
        self.multi_error = False
        self._in_exec = False
        # pub/sub: publisher threads write push frames into this
        # connection concurrently with its own replies — serialize on a
        # per-connection write lock
        self.sub_channels: set = set()
        self.sub_patterns: set = set()
        self._wlock = threading.Lock()
        srv = self.server.resp_server  # type: ignore[attr-defined]
        self.client_id = srv.register_client(self)

    def finish(self):
        srv = self.server.resp_server  # type: ignore[attr-defined]
        srv.drop_subscriber(self.client_id)
        srv.unregister_client(self.client_id)
        super().finish()

    def push(self, frame) -> None:
        """Deliver a pub/sub frame from a publisher thread."""
        with self._wlock:
            self.wfile.write(encode(frame, self.proto))
            self.wfile.flush()

    def handle(self):
        srv: RespServer = self.server.resp_server  # type: ignore[attr-defined]
        # expose this connection's handler to extra_commands handlers
        # (one thread per connection): the cluster transport marks the
        # primary→replica replication link so the replica's READONLY
        # write guard can exempt the stream (CURRENT_CONN.handler)
        CURRENT_CONN.handler = self
        reader = CommandReader(self.rfile)
        while not srv._closing:
            try:
                argv = reader.read_command()
            except EOFError:
                return
            except ProtocolError as exc:
                self._reply(RespError(f"Protocol error: {exc}"))
                return
            if argv is None:
                continue
            if not argv:
                self._reply(RespError("empty command"))
                continue
            # a sampled command's span, and the request id that every span
            # of its work carries (the reader pool and the batcher hand it
            # on); 0: the command is not traced
            CTX.rid = rid = TRACE.sample()
            t0 = clock() if rid else 0
            try:
                quit_after = self._dispatch(srv, argv)
            except BrokenPipeError:
                return
            if rid:
                TRACE.record(SPAN["resp.command"], t0, clock(), rid)
            if quit_after:
                return

    # -- reply helpers ------------------------------------------------------
    def _reply(self, value: Any) -> None:
        rid = CTX.rid
        t0 = clock() if rid else 0
        with self._wlock:
            self.wfile.write(encode(value, self.proto))
            self.wfile.flush()
        if rid:
            TRACE.record(SPAN["resp.write"], t0, clock(), rid)

    # -- dispatch -----------------------------------------------------------
    def _dispatch(self, srv: "RespServer", argv: List[bytes]) -> bool:
        cmd = _s(argv[0]).upper()

        # connection authentication gate: with search.requirepass set,
        # everything except the handshake commands requires a successful
        # AUTH first (standalone stack — no valkey-server in front to do
        # this; reference delegates it, src/acl.cc)
        if not self.authenticated and cmd not in (
            "AUTH", "HELLO", "QUIT", "RESET",
        ):
            if str(config.get("search.requirepass")):
                self._reply(RespError(
                    "Authentication required.", code="NOAUTH"
                ))
                return False

        # pub/sub commands run OUTSIDE the generic reply path: they write
        # one push frame per channel (redis wire shape), and a RESP2
        # connection in subscriber mode accepts only the pub/sub family
        # (valkey pubsub.c; RESP3 multiplexes pushes with normal replies)
        if cmd in ("SUBSCRIBE", "UNSUBSCRIBE", "PSUBSCRIBE",
                   "PUNSUBSCRIBE"):
            if self.multi_queue is not None:
                self.multi_error = True
                self._reply(RespError(
                    f"{cmd} is not allowed in transactions"))
                return False
            self._pubsub_cmd(srv, cmd, argv[1:])
            return False
        if (
            self.proto == 2
            and (self.sub_channels or self.sub_patterns)
            and cmd not in ("PING", "QUIT", "RESET")
        ):
            self._reply(RespError(
                f"Can't execute '{cmd.lower()}': only (P|S)SUBSCRIBE / "
                "(P|S)UNSUBSCRIBE / PING / QUIT / RESET are allowed in "
                "this context"))
            return False

        # MULTI/EXEC state machine (reference: valkey-server's MULTI wraps
        # module commands; ingestion keeps ordered groups per EXEC —
        # index_schema.cc:834 EnqueueMultiMutation)
        if self.multi_queue is not None and cmd not in (
            "EXEC", "DISCARD", "MULTI", "RESET", "QUIT",
        ):
            # queue-time validation (redis: unknown/invalid commands abort
            # the whole transaction at EXEC with -EXECABORT)
            if cmd not in _COMMANDS and cmd not in srv.extra_commands:
                self.multi_error = True
                self._reply(RespError(
                    f"unknown command {cmd!r}, with args beginning with: "
                ))
                return False
            self.multi_queue.append(argv)
            self._reply(SimpleString("QUEUED"))
            return False

        try:
            if cmd == "QUIT":
                self._reply(SimpleString("OK"))
                return True
            result = self._run(srv, cmd, argv)
            self._reply(result)
        except RespError as exc:
            self._reply(exc)
        except OutOfMemoryError as exc:
            self._reply(RespError(str(exc), code="OOM"))
        except PermissionError as exc:
            # ACL denials reply -NOPERM (valkey wire behavior), never the
            # internal-error path
            self._reply(RespError(str(exc), code="NOPERM"))
        except (CommandError, config.ConfigError, ValueError, KeyError) as exc:
            msg = exc.args[0] if exc.args else str(exc)
            self._reply(RespError(str(msg)))
        except Exception as exc:  # never kill the connection on a bug
            log("warning", f"internal error serving {cmd}: {exc!r}")
            self._reply(RespError(f"internal error: {exc}", code="ERR"))
        return False

    def _pubsub_cmd(self, srv: "RespServer", cmd: str,
                    chans: List[bytes]) -> None:
        """(P)SUBSCRIBE/(P)UNSUBSCRIBE: one push frame per channel, each
        carrying the post-op subscription count (redis wire shape)."""
        pattern = cmd.startswith("P")
        mine = self.sub_patterns if pattern else self.sub_channels
        verb = cmd.lower()
        if cmd in ("SUBSCRIBE", "PSUBSCRIBE"):
            if not chans:
                self._reply(RespError(
                    f"wrong number of arguments for '{verb}' command"))
                return
            for ch in chans:
                name = _s(ch)
                mine.add(name)
                srv.subscribe(self.client_id, name, pattern)
                self.push(Push([verb, name,
                                len(self.sub_channels)
                                + len(self.sub_patterns)]))
            return
        targets = [_s(c) for c in chans] or sorted(mine)
        if not targets:  # unsubscribe with nothing subscribed
            self.push(Push([verb, None, 0]))
            return
        for name in targets:
            mine.discard(name)
            srv.unsubscribe(self.client_id, name, pattern)
            self.push(Push([verb, name,
                            len(self.sub_channels)
                            + len(self.sub_patterns)]))

    def _run(self, srv: "RespServer", cmd: str, argv: List[bytes]) -> Any:
        engine = srv.engine if self.db == 0 else srv.engine_for(self.db)
        rest = argv[1:]

        # extension commands (cluster transport registers _PART.*/_META.*
        # here — the socket-RPC analog of the reference's gRPC service
        # methods, src/coordinator/server.cc)
        ext = srv.extra_commands.get(cmd)
        if ext is not None:
            return ext(argv[1:])

        if cmd == "PING":
            if len(rest) > 1:
                raise RespError("wrong number of arguments for 'ping' command")
            return rest[0] if rest else SimpleString("PONG")
        if cmd == "ECHO":
            if len(rest) != 1:
                raise RespError("wrong number of arguments for 'echo' command")
            return rest[0]
        if cmd == "HELLO":
            if rest:
                ver = _s(rest[0])
                if ver not in ("2", "3"):
                    raise RespError(
                        "NOPROTO unsupported protocol version", code="NOPROTO"
                    )
                self.proto = int(ver)
                i = 1
                while i < len(rest):
                    opt = _s(rest[i]).upper()
                    if opt == "AUTH" and i + 2 < len(rest):
                        self._authenticate(
                            engine, _s(rest[i + 1]), _s(rest[i + 2])
                        )
                        i += 3
                    elif opt == "SETNAME" and i + 1 < len(rest):
                        i += 2
                    else:
                        raise RespError(f"unknown HELLO option {opt!r}")
            return {
                "server": "valkey-search-tpu",
                "version": srv.version,
                "proto": self.proto,
                "id": threading.get_ident() % (1 << 31),
                "mode": "standalone",
                "role": "master",
                "modules": [],
            }
        if cmd == "AUTH":
            if len(rest) == 1:
                self._authenticate(engine, "default", _s(rest[0]))
            elif len(rest) == 2:
                self._authenticate(engine, _s(rest[0]), _s(rest[1]))
            else:
                raise RespError("wrong number of arguments for 'auth' command")
            return SimpleString("OK")
        if cmd == "SELECT":
            # full logical-DB range with one Engine per db (reference:
            # per-db schema registries, schema_manager.h
            # GetIndexSchema(db_num, ...), integration/test_multidb_search)
            # — in cluster mode too (valkey 9 dbnum,
            # integration/test_dbnum.py)
            if len(rest) != 1 or not _s(rest[0]).lstrip("-").isdigit():
                raise RespError("value is not an integer or out of range")
            n = int(_s(rest[0]))
            if not 0 <= n < srv.databases:
                raise RespError("DB index is out of range")
            self.db = n
            return SimpleString("OK")
        if cmd == "SWAPDB":
            if len(rest) != 2:
                raise RespError(
                    "wrong number of arguments for 'swapdb' command")
            if srv.key_router is not None or srv.write_observer is not None:
                raise RespError("SWAPDB is not allowed in cluster mode")
            try:
                a, b = int(_s(rest[0])), int(_s(rest[1]))
            except ValueError:
                raise RespError("invalid first DB index")
            if not (0 <= a < srv.databases and 0 <= b < srv.databases):
                raise RespError("DB index is out of range")
            srv.swap_dbs(a, b)
            return SimpleString("OK")
        if cmd == "RESET":
            self.multi_queue = None
            self.multi_error = False
            self.user = "default"
            self.authenticated = False
            self.db = 0
            for name in list(self.sub_channels):
                srv.unsubscribe(self.client_id, name, False)
            for name in list(self.sub_patterns):
                srv.unsubscribe(self.client_id, name, True)
            self.sub_channels.clear()
            self.sub_patterns.clear()
            return SimpleString("RESET")
        if cmd == "PUBLISH":
            if len(rest) != 2:
                raise RespError(
                    "wrong number of arguments for 'publish' command")
            return srv.publish(_s(rest[0]), rest[1])
        if cmd == "PUBSUB":
            sub = _s(rest[0]).upper() if rest else ""
            with srv._sub_lock:
                if sub == "CHANNELS":
                    pat = _s(rest[1]) if len(rest) > 1 else None
                    return [c for c in srv._subs
                            if pat is None or fnmatchcase(c, pat)]
                if sub == "NUMSUB":
                    out: List[Any] = []
                    for c in rest[1:]:
                        name = _s(c)
                        out += [name, len(srv._subs.get(name, ()))]
                    return out
                if sub == "NUMPAT":
                    return len(srv._psubs)
            raise RespError(f"Unknown PUBSUB subcommand {sub!r}")
        if cmd == "CLIENT":
            sub = _s(rest[0]).upper() if rest else ""
            if sub == "SETNAME":
                self.client_name = _s(rest[1]) if len(rest) > 1 else ""
                return SimpleString("OK")
            if sub == "GETNAME":
                return getattr(self, "client_name", "")
            if sub == "ID":
                return self.client_id
            if sub == "LIST":
                rows = []
                for cid, h in sorted(srv.clients().items()):
                    rows.append(
                        f"id={cid} name={getattr(h, 'client_name', '')} "
                        f"db={getattr(h, 'db', 0)} "
                        f"user={getattr(h, 'user', 'default')}"
                    )
                return "\n".join(rows) + "\n"
            if sub == "KILL":
                # CLIENT KILL ID <id> — severs the target connection; an
                # in-flight blocked query on it unblocks with an error
                # (reference cancel path, integration/test_cancel.py)
                if len(rest) >= 3 and _s(rest[1]).upper() == "ID":
                    target = srv.clients().get(int(_s(rest[2])))
                    if target is None:
                        raise RespError("No such client ID")
                    try:
                        target.connection.shutdown(socket.SHUT_RDWR)
                    except OSError:
                        pass
                    return 1
                raise RespError("syntax error (CLIENT KILL ID <id>)")
            if sub in ("SETINFO", "NO-EVICT", "NO-TOUCH"):
                return SimpleString("OK")
            raise RespError(f"Unknown CLIENT subcommand {sub!r}")
        if cmd == "COMMAND":
            if rest and _s(rest[0]).upper() == "DOCS":
                return {} if self.proto >= 3 else []
            if rest and _s(rest[0]).upper() == "COUNT":
                return len(_COMMANDS)
            return [[name.lower(), -1, [], 0, 0, 0] for name in _COMMANDS]
        if cmd == "DBSIZE":
            with engine._lock:
                return len(engine.keyspace)
        if cmd == "FLUSHALL":
            for eng in srv.all_engines():
                eng.flushall()
            if srv.journal is not None:
                srv.journal.append(argv, db=self.db)
            return SimpleString("OK")
        if cmd == "FLUSHDB":
            engine.flushall()
            if srv.journal is not None:
                srv.journal.append(argv, db=self.db)
            return SimpleString("OK")
        if cmd == "MULTI":
            if self.multi_queue is not None:
                raise RespError("MULTI calls can not be nested")
            self.multi_queue = []
            self.multi_error = False
            return SimpleString("OK")
        if cmd == "DISCARD":
            if self.multi_queue is None:
                raise RespError("DISCARD without MULTI")
            self.multi_queue = None
            self.multi_error = False
            return SimpleString("OK")
        if cmd == "EXEC":
            if self.multi_queue is None:
                raise RespError("EXEC without MULTI")
            queued, self.multi_queue = self.multi_queue, None
            if self.multi_error:
                self.multi_error = False
                raise RespError(
                    "Transaction discarded because of previous errors.",
                    code="EXECABORT",
                )
            return self._exec_multi(srv, queued)
        if cmd == "ACL":
            return self._acl_cmd(engine, rest)
        if cmd == "CONFIG":
            return self._config_cmd(rest)
        if cmd == "INFO":
            return _format_info(engine, [_s(a) for a in rest])
        if cmd in ("SAVE", "BGSAVE"):
            path = str(config.get("search.checkpoint-path"))
            if rest:
                path = _s(rest[0])
            if not path:
                raise RespError(
                    "no checkpoint path (set search.checkpoint-path "
                    "or pass one: SAVE /path/file.vstpu)"
                )
            if cmd == "SAVE":
                srv.save_all(path)
                return SimpleString("OK")
            if bool(config.get("search.bgsave-fork")) and hasattr(os, "fork"):
                srv.bgsave_forked(path)
                return SimpleString("Background saving started")
            t = threading.Thread(
                target=lambda: srv.save_all(path), daemon=True,
                name="bgsave",
            )
            t.start()
            return SimpleString("Background saving started")
        if cmd == "SHUTDOWN":
            threading.Thread(target=srv.close, daemon=True).start()
            return SimpleString("OK")

        if cmd in ("EVAL", "EVALSHA"):
            return self._eval_lite(srv, engine, cmd, rest)
        if cmd == "SCRIPT":
            return self._script_cmd(srv, rest)

        if cmd == "FT.SEARCH" and srv.async_search and not self._in_exec:
            # route through the reader pool so concurrent connections'
            # KNN queries coalesce into one device launch (inside EXEC the
            # engine lock is held — run inline to avoid self-deadlock)
            fut = engine.ft_search_async(*argv[1:], user=self.user)
            return _ok(fut.result(timeout=srv.search_timeout))
        if cmd in _WRITE_COMMANDS and (
            srv.write_observer is not None or srv.journal is not None
        ):
            # replication stream hook: each replica indexes its own copy
            # of the write stream (docs/topics/search.md "Index
            # Replication" — index content itself is never replicated).
            # Apply + log under the engine lock so the stream order equals
            # the apply order (the observer appends to an ordered log and
            # must not block; forwarding happens on a dedicated thread).
            # The op journal appends at the same point: journal order ==
            # apply order == replication order.
            with engine._lock:
                result = engine.execute(*argv, user=self.user)
                if srv.write_observer is not None:
                    srv.write_observer(argv, db=self.db)
                if srv.journal is not None:
                    srv.journal.append(argv, db=self.db)
            return _ok(result)
        if cmd in _JOURNALED_SCHEMA_COMMANDS and srv.journal is not None:
            # schema mutations are journaled too (reference: FT.CREATE
            # reaches the AOF via module replication); engine._lock is an
            # RLock, so the handler's own locking nests fine
            with engine._lock:
                result = engine.execute(*argv, user=self.user)
                srv.journal.append(argv, db=self.db)
            return _ok(result)
        return _ok(engine.execute(*argv, user=self.user))

    # -- Lua scripting (server/lua.py, a Lua 5.1 subset interpreter; the
    #    reference rides valkey-server's embedded Lua — integration/
    #    test_multi_lua.py drives FT.* and ingest-then-query scripts) -----
    def _script_cmd(self, srv: "RespServer", rest: List[bytes]):
        import hashlib

        if not rest:
            raise RespError("SCRIPT LOAD|EXISTS|FLUSH ...")
        sub = _s(rest[0]).upper()
        scripts = getattr(srv, "_scripts", None)
        if scripts is None:
            scripts = srv._scripts = {}
        if sub == "LOAD":
            if len(rest) != 2:
                raise RespError("SCRIPT LOAD script")
            from valkey_search_tpu_torch.server import lua as lua_mod

            src = _s(rest[1])
            try:
                ast = lua_mod.compile_script(src)  # syntax-check at load
            except lua_mod.LuaError as exc:
                raise RespError(str(exc))
            sha = hashlib.sha1(rest[1] if isinstance(rest[1], bytes)
                               else src.encode()).hexdigest()
            scripts[sha] = src
            self._script_asts(srv)[sha] = ast
            return sha
        if sub == "EXISTS":
            return [1 if _s(h).lower() in scripts else 0 for h in rest[1:]]
        if sub == "FLUSH":
            scripts.clear()
            self._script_asts(srv).clear()  # compiled ASTs too (ADVICE r4)
            return SimpleString("OK")
        raise RespError(f"Unknown SCRIPT subcommand {sub!r}")

    @staticmethod
    def _script_asts(srv: "RespServer") -> Dict[str, Any]:
        asts = getattr(srv, "_script_ast_cache", None)
        if asts is None:
            asts = srv._script_ast_cache = {}
        return asts

    @staticmethod
    def _script_error(msg: str) -> RespError:
        """A Lua-side error string back to a RESP error. Script-visible
        error strings embed the code as the first word (that's what a
        redis.pcall err field looks like), so split it back out to keep
        -MOVED / -NOPERM etc. wire-exact through a script hop."""
        msg = msg.replace("\r", " ").replace("\n", " ")
        head, _, tail = msg.partition(" ")
        if tail and head.isupper() and head.isalpha():
            return RespError(tail, code=head)
        return RespError(msg)

    def _eval_lite(self, srv: "RespServer", engine: Engine, cmd: str,
                   rest: List[bytes]):
        """EVAL/EVALSHA over the embedded Lua 5.1 interpreter
        (server/lua.py). Runs atomically under the engine lock (a Lua
        script is a transaction); redis.call errors abort the script
        (redis.pcall returns them as {err=...} tables); writes feed the
        replication stream and op journal in apply order, like EXEC."""
        import hashlib

        from valkey_search_tpu_torch.server import lua as lua_mod

        if len(rest) < 2:
            raise RespError(f"wrong number of arguments for '{cmd.lower()}'")
        scripts = getattr(srv, "_scripts", None)
        if scripts is None:
            scripts = srv._scripts = {}
        if cmd == "EVALSHA":
            sha = _s(rest[0]).lower()
            src = scripts.get(sha)
            if src is None:
                raise RespError(
                    "No matching script. Please use EVAL.", code="NOSCRIPT"
                )
        else:
            src = _s(rest[0])
            sha = hashlib.sha1(
                rest[0] if isinstance(rest[0], bytes) else src.encode()
            ).hexdigest()
            scripts.setdefault(sha, src)
        try:
            numkeys = int(_s(rest[1]))
        except ValueError:
            raise RespError("value is not an integer or out of range")
        if numkeys < 0 or 2 + numkeys > len(rest):
            raise RespError("Number of keys can't be negative")
        keys = [bytes(x) if not isinstance(x, bytes) else x
                for x in rest[2:2 + numkeys]]
        argv_in = [bytes(x) if not isinstance(x, bytes) else x
                   for x in rest[2 + numkeys:]]
        asts = self._script_asts(srv)
        ast = asts.get(sha)
        if ast is None:
            try:
                ast = lua_mod.compile_script(src)
            except lua_mod.LuaError as exc:
                raise RespError(str(exc))
            asts[sha] = ast

        repl: List[List[bytes]] = []
        txn = engine.multi()

        def host_call(cargv: List[bytes]):
            inner = _s(cargv[0]).upper()
            if inner in ("EVAL", "EVALSHA", "MULTI", "EXEC", "SCRIPT",
                         "WATCH"):
                raise lua_mod.RedisCallError(
                    f"This Redis command is not allowed from script: {inner}"
                )
            # map the same error family the connection loop maps (so
            # redis.pcall can catch ANY command failure as {err=...})
            try:
                return self._exec_one(srv, txn, inner, cargv, repl)
            except RespError as exc:
                msg = str(exc)
                if exc.code != "ERR" and msg.split(" ", 1)[0] != exc.code:
                    msg = f"{exc.code} {msg}"
                raise lua_mod.RedisCallError(msg)
            except OutOfMemoryError as exc:
                raise lua_mod.RedisCallError(f"OOM {exc}")
            except PermissionError as exc:
                raise lua_mod.RedisCallError(f"NOPERM {exc}")
            except (CommandError, config.ConfigError, ValueError,
                    KeyError) as exc:
                msg = exc.args[0] if exc.args else str(exc)
                raise lua_mod.RedisCallError(str(msg))

        rt = lua_mod.LuaRuntime(
            host_call, keys=keys, argv=argv_in,
            resp_to_lua_fn=lambda rep: lua_mod.resp_to_lua(
                rep, status_class=SimpleString),
            random_seed=int(sha[:8], 16),
        )
        was_in_exec = self._in_exec
        self._in_exec = True  # scripts are atomic: inline FT.SEARCH, no pool
        try:
            with engine._lock:
                try:
                    rets = rt.run(ast)
                except lua_mod.LuaError as exc:
                    v = exc.value
                    if isinstance(v, lua_mod.LuaTable):
                        e = v.data.get(b"err")
                        if e is not None:
                            raise self._script_error(
                                _s(e) if isinstance(e, bytes) else str(e))
                    raise self._script_error(str(exc))
                finally:
                    txn.flush_notifications()
                    if repl and srv.write_observer is not None:
                        for a in repl:
                            srv.write_observer(a, db=self.db)
                    if repl and srv.journal is not None:
                        for a in repl:
                            srv.journal.append(a, db=self.db)
        finally:
            self._in_exec = was_in_exec

        def _raise_err(msg: str):
            raise self._script_error(msg)

        return lua_mod.lua_to_resp(
            rets[0] if rets else None,
            status_factory=SimpleString, error_factory=_raise_err,
        )

    def _authenticate(self, engine: Engine, user: str, password: str) -> None:
        """Verify credentials before switching the connection's ACL user.

        The reference delegates authentication to valkey-server; this
        standalone stack verifies against search.requirepass (default
        user) or the ACL user's `>password` rules. With no credential
        store configured, AUTH is refused outright — the per-user
        key-prefix ACL must not be switchable by an unverified client.
        """
        requirepass = str(config.get("search.requirepass"))
        if user == "default":
            if not requirepass:
                raise RespError(
                    "Client sent AUTH, but no password is set. Did you mean "
                    "AUTH <username> <password>?"
                )
            if password != requirepass:
                raise RespError(
                    "invalid username-password pair or user is disabled.",
                    code="WRONGPASS",
                )
        else:
            try:
                acl_user = engine.acl.getuser(user)
            except Exception:
                acl_user = None
            if acl_user is None or not acl_user.check_password(password):
                raise RespError(
                    "invalid username-password pair or user is disabled.",
                    code="WRONGPASS",
                )
        self.user = user
        self.authenticated = True

    def _exec_multi(self, srv: "RespServer", queued: List[List[bytes]]) -> list:
        """Execute queued commands strictly in queue order (redis MULTI
        semantics: a read after a write in the same transaction sees the
        write). Keyspace writes apply at their queue position but their
        *index* notifications commit at the end as one ordered mutation
        group (reference EnqueueMultiMutation, index_schema.cc:834).
        Writes pass the same cluster slot routing as outside MULTI
        (srv.key_router → -MOVED) and replicate in apply order."""
        engine = srv.engine if self.db == 0 else srv.engine_for(self.db)
        results: list = []
        txn = engine.multi()
        repl: List[List[bytes]] = []
        self._in_exec = True
        try:
            with engine._lock:
                for argv in queued:
                    cmd = _s(argv[0]).upper()
                    try:
                        results.append(
                            self._exec_one(srv, txn, cmd, argv, repl)
                        )
                    except RespError as exc:
                        results.append(exc)
                    except OutOfMemoryError as exc:
                        results.append(RespError(str(exc), code="OOM"))
                    except Exception as exc:
                        msg = exc.args[0] if exc.args else str(exc)
                        results.append(RespError(str(msg)))
                txn.flush_notifications()
                if repl and srv.write_observer is not None:
                    # replicate the transaction's writes in apply order
                    # through the same ordered stream as plain writes
                    for argv in repl:
                        srv.write_observer(argv, db=self.db)
                if repl and srv.journal is not None:
                    for argv in repl:
                        srv.journal.append(argv, db=self.db)
        finally:
            self._in_exec = False
        return results

    def _exec_one(self, srv: "RespServer", txn, cmd: str,
                  argv: List[bytes], repl: List[List[bytes]]):
        """One queued command inside EXEC (engine lock held)."""
        engine = srv.engine if self.db == 0 else srv.engine_for(self.db)
        rest = argv[1:]
        if (cmd in ("FT.SEARCH", "FT.AGGREGATE")
                and srv.multi_query_guard is not None):
            index_name = _s(rest[0]) if rest else ""
            if not srv.multi_query_guard(index_name):
                raise RespError(
                    "MULTI/EXEC or Lua script are not supported in CME "
                    "mode unless the query targets a single-slot index "
                    "on the local node."
                )
        if cmd == "HSET" and len(rest) >= 3 and len(rest) % 2 == 1:
            key = _s(rest[0])
            self._route_key(srv, key)
            engine._deny_oom()
            mapping = {
                _s(rest[i]): rest[i + 1] for i in range(1, len(rest), 2)
            }
            added = txn.hset_now(key, mapping)
            repl.append(argv)
            return added
        if cmd == "DEL" and rest:
            for k in rest:
                self._route_key(srv, _s(k))
            n = sum(txn.delete_now(_s(k)) for k in rest)
            repl.append(argv)
            return n
        if cmd == "JSON.SET" and len(rest) == 3:
            key = _s(rest[0])
            self._route_key(srv, key)
            engine._deny_oom()
            txn.json_set_now(key, _s(rest[1]), rest[2])
            repl.append(argv)
            return SimpleString("OK")
        return _ok(self._run(srv, cmd, argv))

    def _route_key(self, srv: "RespServer", key: str) -> None:
        if srv.key_router is not None:
            srv.key_router(key)  # raises -MOVED when this node doesn't own it

    def _acl_cmd(self, engine: Engine, rest: List[bytes]) -> Any:
        """ACL SETUSER/GETUSER/DELUSER/LIST/WHOAMI/CAT — the user registry
        behind the per-user key-prefix checks every FT.* command runs
        (reference AclPrefixCheck, src/acl.h:36-43; user management itself
        lives in valkey-server, so this standalone stack carries the
        minimal redis-compatible surface)."""
        if not rest:
            raise RespError("wrong number of arguments for 'acl' command")
        sub = _s(rest[0]).upper()
        if sub == "WHOAMI":
            return self.user
        if sub == "LIST":
            with engine.acl._lock:
                users = list(engine.acl._users.values())
            return [
                "user %s %s %s" % (
                    u.name, "on" if u.enabled else "off",
                    " ".join(f"~{p}" for p in u.key_patterns) or "resetkeys",
                )
                for u in users
            ]
        if sub == "CAT":
            return ["search"]
        if sub == "SETUSER":
            if len(rest) < 2:
                raise RespError("ACL SETUSER needs a username")
            engine.acl.setuser(_s(rest[1]), *[_s(r) for r in rest[2:]])
            return SimpleString("OK")
        if sub == "GETUSER":
            if len(rest) != 2:
                raise RespError("ACL GETUSER needs a username")
            u = engine.acl.getuser(_s(rest[1]))
            return [
                "flags", ["on" if u.enabled else "off"] +
                (["nopass"] if u.nopass else []),
                "passwords", [f"<{len(u.passwords)} set>"] if u.passwords else [],
                "keys", [f"~{p}" for p in u.key_patterns],
            ]
        if sub == "DELUSER":
            if len(rest) < 2:
                raise RespError("ACL DELUSER needs a username")
            n = 0
            for name in rest[1:]:
                try:
                    engine.acl.deluser(_s(name))
                    n += 1
                except Exception:
                    pass
            return n
        raise RespError(f"Unknown ACL subcommand {sub!r}")

    def _config_cmd(self, rest: List[bytes]) -> Any:
        if not rest:
            raise RespError("wrong number of arguments for 'config' command")
        sub = _s(rest[0]).upper()
        if sub == "GET":
            if len(rest) < 2:
                raise RespError("wrong number of arguments for 'config|get'")
            pattern = _s(rest[1])
            snap = config.REGISTRY.snapshot(include_hidden=False)
            # reference-spelled aliases answer CONFIG GET too (they share
            # the target entry's value, config.py _ALIASES)
            for alias, target in config._ALIASES.items():
                if target in snap:
                    snap.setdefault(alias, snap[target])
            out = {}
            for name, val in sorted(snap.items()):
                if fnmatchcase(name, pattern) or name == pattern:
                    out[name] = _cfg_str(val)
            return out if self.proto >= 3 else _flatten(out)
        if sub == "SET":
            if len(rest) != 3:
                raise RespError("wrong number of arguments for 'config|set'")
            config.set_config(_s(rest[1]), _s(rest[2]))
            return SimpleString("OK")
        if sub == "RESETSTAT":
            return SimpleString("OK")
        raise RespError(f"Unknown CONFIG subcommand {sub!r}")


def _cfg_str(val) -> str:
    if isinstance(val, bool):
        return "yes" if val else "no"
    return str(val)


def _flatten(d: dict) -> list:
    out: list = []
    for k, v in d.items():
        out.append(k)
        out.append(v)
    return out


def _ok(result: Any) -> Any:
    """Engine results → RESP conventions: bare 'OK' is a simple string."""
    if isinstance(result, str) and result == "OK":
        return SimpleString("OK")
    return result


def _format_info(engine: Engine, args: List[str]) -> str:
    """INFO as the sectioned text blob redis clients expect (the reference's
    ~90 fields appear under the SEARCH section of valkey's INFO)."""
    section = args[0].lower() if args else None
    fields = engine.info()
    lines = ["# search"]
    for k, v in fields.items():
        name = k if k.startswith("search_") else f"search_{k}"
        lines.append(f"{name}:{v}")
    if section not in (None, "all", "everything", "search", "modules"):
        lines = []
    return "\r\n".join(lines) + "\r\n"


_WRITE_COMMANDS = {
    "HSET", "HDEL", "DEL", "JSON.SET", "EXPIRE", "PEXPIRE", "PERSIST",
    "COPY", "HEXPIRE", "HPEXPIRE", "HPERSIST",
}

# non-keyspace mutations the op journal must also capture (replication
# streams them separately; see _cmd_meta_pull for schema gossip)
_JOURNALED_SCHEMA_COMMANDS = {"FT.CREATE", "FT.DROPINDEX"}

_COMMANDS = [
    "PING", "ECHO", "HELLO", "AUTH", "SELECT", "QUIT", "RESET", "CLIENT",
    "COMMAND", "DBSIZE", "FLUSHALL", "FLUSHDB", "MULTI", "EXEC", "DISCARD",
    "ACL",
    "CONFIG", "INFO", "SAVE", "BGSAVE", "SHUTDOWN", "SWAPDB",
    "HSET", "HGETALL", "HGET", "HMGET", "HDEL", "DEL", "EXISTS", "TYPE",
    "KEYS", "SCAN", "EXPIRE", "PEXPIRE", "TTL", "PERSIST",
    "HEXPIRE", "HPEXPIRE", "HTTL", "HPTTL", "HPERSIST",
    "JSON.SET", "JSON.GET", "COPY", "FT.CREATE", "FT.DROPINDEX", "FT.SEARCH",
    "FT.AGGREGATE", "FT.INFO", "FT._LIST", "FT._DEBUG",
    "EVAL", "EVALSHA", "SCRIPT",
    "SUBSCRIBE", "UNSUBSCRIBE", "PSUBSCRIBE", "PUNSUBSCRIBE", "PUBLISH",
    "PUBSUB",
]


class _ThreadingTCPServer(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True


def _engine_aux_locks(engine):
    """Deterministically-ordered per-index / native-gating locks for the
    fork barrier (bgsave_forked): every Python lock that wraps a resource
    the forked child's save path reads — the schema registry, vector index
    rows, the native HNSW graph and its builder, the native text
    dictionary, the key interner. Holding them in the forking thread
    guarantees no OTHER thread (cron vacuum, a reader inside a native call,
    a graph publish, a synchronous HSET) has one locked at fork, which
    would leave it locked forever in the child.

    The order is the one serving threads nest them in: the schema manager
    first; an HNSW index's graph lock before its index lock (the graph
    publish holds both) and the builder's after it; the interner last (an
    index holds its own lock while it interns a key)."""
    locks = []
    seen = set()

    def add(lk):
        if lk is not None and id(lk) not in seen:
            seen.add(id(lk))
            locks.append(lk)

    try:
        schemas = sorted(engine.manager.all_schemas(), key=lambda s: s.name)
    except Exception:
        return locks
    add(getattr(engine.manager, "_lock", None))
    for schema in schemas:
        for attr_name in sorted(schema.attributes):
            idx = schema.attributes[attr_name].index
            add(getattr(idx, "_graph_lock", None))
            add(getattr(idx, "_lock", None))
            add(getattr(getattr(idx, "builder", None), "_lock", None))
        te = getattr(schema, "text_engine", None)
        nt = getattr(te, "_nt", None) if te is not None else None
        add(getattr(nt, "_lock", None))
        add(getattr(getattr(schema, "interner", None), "_lock", None))
    return locks


def _detach_after_fork(engines) -> None:
    """The forked BGSAVE child's own state, set before it saves. Only the
    forking thread lives on in the child, so:

    - the process-wide leaf locks of the save path (the metrics counters',
      the config registry's, the controlled variables') are made anew: a
      thread that held one at the fork does not exist to release it;
    - each engine's writer pool is dropped: its threads do not exist here,
      so ``Engine.save``'s drain could only wait for ever. The pool was
      drained and parked before the fork; one that still holds a mutation
      fails the child (status err) rather than save a keyspace that its
      indexes lag.

    Nothing here or on the save path touches CUDA (store rows, tracked keys
    and the HNSW graph are host numpy): a forked child cannot initialise a
    CUDA context, and the parent's is not its to use."""
    from valkey_search_tpu_torch.runtime.debug import CONTROLLED
    from valkey_search_tpu_torch.runtime.metrics import STATS

    STATS._lock = threading.Lock()
    config.REGISTRY._lock = threading.RLock()
    CONTROLLED._lock = threading.Lock()
    for eng in engines:
        ing = getattr(eng, "_ingestion", None)
        if ing is not None:
            if ing._any_queued() or ing._inflight:
                raise RespError("BGSAVE child: mutations still queued")
            eng._ingestion = None


class RespServer:
    """Standalone RESP server wrapping an Engine.

    >>> srv = RespServer(Engine(), port=0)   # port=0 → ephemeral
    >>> srv.start()
    >>> srv.port
    54321
    >>> srv.close()
    """

    version = "1.0.0"

    def __init__(
        self,
        engine: Optional[Engine] = None,
        host: str = "127.0.0.1",
        port: int = 6379,
        async_search: bool = True,
        search_timeout: float = 60.0,
    ):
        self.engine = engine if engine is not None else Engine()
        # logical databases (standalone): db → Engine, created lazily on
        # SELECT; db 0 is self.engine (cluster mode supports the full
        # range too — valkey 9 dbnum, cluster/transport.py routing)
        self.engines = {0: self.engine}
        self._db_lock = threading.Lock()
        self.databases = 16
        self.bgsave_pid: Optional[int] = None
        self.bgsave_status = "none"
        self.host = host
        self._requested_port = port
        # name → fn(rest_argv: List[bytes]) -> reply; lets the cluster
        # transport (and tests) extend the command surface per server
        self.extra_commands = {}
        # called with the raw argv after each successful keyspace write,
        # UNDER the engine lock (replication stream hook for the cluster
        # transport — must be fast: append to an ordered log, not a send)
        self.write_observer = None
        # cluster slot routing hook: fn(key) raises -MOVED when this node
        # doesn't own the key's slot (set by cluster NodeServer; applied
        # to writes inside MULTI/EXEC too)
        self.key_router = None
        # cluster MULTI/EXEC query guard: fn(index_name) -> bool; when set
        # (cluster NodeServer), FT.SEARCH/FT.AGGREGATE inside MULTI/EXEC
        # are refused unless the index is single-slot and owned locally
        # (reference CME restriction, drilled by integration/
        # test_multi_lua.py)
        self.multi_query_guard = None
        self.async_search = async_search
        self.search_timeout = search_timeout
        # op journal (AOF analog): attached by start() when
        # search.journal-path is configured; appended UNDER the engine
        # lock right after each accepted write, truncated by SAVE
        self.journal = None
        self._server: Optional[_ThreadingTCPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._closing = False
        # pub/sub registries: channel/pattern → {client_id}. Guarded by
        # _sub_lock; deliveries walk a snapshot so a slow client can't
        # hold the registry. Keyspace notifications (__keyspace@N__ /
        # __keyevent@N__, valkey notify.c) ride the same machinery: each
        # logical db's Engine gets an event_observer at creation.
        self._sub_lock = threading.Lock()
        self._subs: Dict[str, set] = {}
        self._psubs: Dict[str, set] = {}
        self._attach_event_observer(self.engine, 0)

    # -- pub/sub --------------------------------------------------------------
    def _attach_event_observer(self, eng: Engine, db: int) -> None:
        eng.event_observer = (
            lambda event, key, klass, _db=db:
            self.notify_keyspace_event(_db, event, key, klass)
        )

    def notify_keyspace_event(self, db: int, event: str, key: str,
                              klass: str) -> None:
        """__keyspace@<db>__:<key> → event and __keyevent@<db>__:<event>
        → key, gated by search.notify-keyspace-events exactly like
        valkey's notify-keyspace-events (K/E select the channel family,
        class letters or A select event classes)."""
        if not self._subs and not self._psubs:
            return  # fast path: nobody is listening
        flags = str(config.get("search.notify-keyspace-events"))
        if not flags or ("K" not in flags and "E" not in flags):
            return
        if "A" not in flags and klass not in flags:
            return
        if "K" in flags:
            self.publish(f"__keyspace@{db}__:{key}", event)
        if "E" in flags:
            self.publish(f"__keyevent@{db}__:{event}", key)

    def publish(self, channel: str, message) -> int:
        """Deliver to direct + pattern subscribers; returns receiver
        count (the PUBLISH reply)."""
        with self._sub_lock:
            targets = [
                (None, cid) for cid in self._subs.get(channel, ())
            ] + [
                (pat, cid)
                for pat, cids in self._psubs.items()
                if fnmatchcase(channel, pat)
                for cid in cids
            ]
        if not targets:
            return 0
        clients = self.clients()
        n = 0
        for pat, cid in targets:
            h = clients.get(cid)
            if h is None:
                continue
            frame = (
                Push(["message", channel, message]) if pat is None
                else Push(["pmessage", pat, channel, message])
            )
            try:
                h.push(frame)
                n += 1
            except OSError:
                pass  # client went away; finish() will unregister it
        return n

    def subscribe(self, cid: int, channel: str, pattern: bool) -> None:
        with self._sub_lock:
            reg = self._psubs if pattern else self._subs
            reg.setdefault(channel, set()).add(cid)

    def unsubscribe(self, cid: int, channel: str, pattern: bool) -> None:
        with self._sub_lock:
            reg = self._psubs if pattern else self._subs
            s = reg.get(channel)
            if s is not None:
                s.discard(cid)
                if not s:
                    del reg[channel]

    def drop_subscriber(self, cid: int) -> None:
        with self._sub_lock:
            for reg in (self._subs, self._psubs):
                for ch in [c for c, s in reg.items() if cid in s]:
                    reg[ch].discard(cid)
                    if not reg[ch]:
                        del reg[ch]

    @property
    def port(self) -> int:
        assert self._server is not None, "server not started"
        return self._server.server_address[1]

    # -- connected clients --------------------------------------------------
    def register_client(self, handler) -> int:
        with self._db_lock:
            self._next_client_id = getattr(self, "_next_client_id", 0) + 1
            cid = self._next_client_id
            if not hasattr(self, "_clients"):
                self._clients = {}
            self._clients[cid] = handler
            return cid

    def unregister_client(self, cid: int) -> None:
        with self._db_lock:
            getattr(self, "_clients", {}).pop(cid, None)

    def clients(self) -> dict:
        with self._db_lock:
            return dict(getattr(self, "_clients", {}))

    # -- logical databases --------------------------------------------------
    def engine_for(self, db: int) -> Engine:
        with self._db_lock:
            eng = self.engines.get(db)
            if eng is None:
                factory = getattr(self, "engine_factory", None) or Engine
                eng = self.engines[db] = factory()
                self._attach_event_observer(eng, db)
            return eng

    def all_engines(self) -> List[Engine]:
        with self._db_lock:
            return [self.engines[d] for d in sorted(self.engines)]

    def swap_dbs(self, a: int, b: int) -> None:
        """SWAPDB: every connection selecting db a now sees b's data and
        vice versa (redis semantics — the swap is of the db content, which
        here means swapping the Engine objects)."""
        if a == b:
            return
        with self._db_lock:
            ea = self.engines.get(a) or Engine()
            eb = self.engines.get(b) or Engine()
            self.engines[a], self.engines[b] = eb, ea
            if 0 in (a, b):
                self.engine = self.engines[0]
            # keyspace-notification channels are named by DB NUMBER: the
            # swapped engines must emit under their new numbers
            self._attach_event_observer(self.engines[a], a)
            self._attach_event_observer(self.engines[b], b)

    def save_all(self, path: str, truncate_journal: bool = True) -> None:
        """Checkpoint every non-empty db: db 0 at ``path``, db N at
        ``path.dbN`` (one chunked file per logical database).

        With the op journal attached, the whole save runs under a write
        barrier (_db_lock + every engine lock) and truncates the journal
        before releasing: every journaled effect is inside the checkpoint
        and every later write lands in the fresh journal — a crash at any
        point replays to a consistent state. Without a journal the
        original incremental (per-db lock) path is kept.

        truncate_journal=False: the forked-BGSAVE child passes this — it
        must never touch the journal file it shares with the parent
        (the parent truncates only the pre-fork prefix after the child
        succeeds, bgsave_forked)."""
        import contextlib
        import os as _os
        import re as _re

        with contextlib.ExitStack() as stack:
            if self.journal is not None:
                stack.enter_context(self._db_lock)
                snapshot = sorted(self.engines.items())
                for _db, eng in snapshot:
                    stack.enter_context(eng._lock)
            else:
                with self._db_lock:
                    snapshot = sorted(self.engines.items())
            saved = set()
            for db, eng in snapshot:
                with eng._lock:
                    empty = (not eng.keyspace
                             and not eng.manager.all_schemas())
                if db == 0:
                    eng.save(path)
                elif not empty:
                    eng.save(f"{path}.db{db}")
                    saved.add(db)
            if self.journal is not None and truncate_journal:
                self.journal.truncate()
        # remove stale .dbN files from earlier saves (an emptied/flushed
        # db must not resurrect on the next load_all)
        base = _os.path.basename(path)
        d = _os.path.dirname(path) or "."
        try:
            listing = _os.listdir(d)
        except OSError:
            listing = []
        for fn in listing:
            m = _re.fullmatch(_re.escape(base) + r"\.db(\d+)", fn)
            if m and int(m.group(1)) not in saved:
                try:
                    _os.remove(_os.path.join(d, fn))
                except OSError:
                    pass

    def bgsave_forked(self, path: str) -> int:
        """Fork-isolated BGSAVE (the reference rides valkey's fork-based
        BGSAVE; its AtForkPrepare suspends the worker pools,
        valkey_search.cc:1029-1056):

        1. suspend every db's writer pool — workers park *between* items,
           so no native builder/posting mutex is held across fork;
        2. take the write barrier (_db_lock + every engine lock), record
           the journal length (no append can be in flight), fork;
        3. the child — a copy-on-write point-in-time snapshot — releases
           its inherited locks (the forking thread owns them), detaches
           from the shared journal fd, writes the checkpoint, _exit()s;
        4. the parent releases/resumes immediately; a waiter thread
           reaps the child and, on success, truncates ONLY the pre-fork
           journal prefix (post-fork writes keep their replay records).

        Parent mutations after the fork are invisible to the snapshot —
        the point-in-time property the in-process path cannot give.
        Returns the child pid."""
        import contextlib
        import os as _os
        import time as _time

        from valkey_search_tpu_torch.runtime.metrics import STATS

        # one BGSAVE at a time (valkey: "Background save already in
        # progress"); overlapping forks would race their journal-prefix
        # truncations against each other (r3 review finding)
        with self._db_lock:
            if self.bgsave_pid is not None:
                raise RespError("Background save already in progress")
            self.bgsave_pid = -1  # reserved until the fork lands

        pools: list = []
        held: list = []
        aux_held: list = []
        db_locked = False
        try:
            # Quiesce protocol. The queues must be EMPTY at fork, not
            # merely parked: queued-but-unapplied writes are already in
            # the journal's pre-fork prefix (append happens at dispatch),
            # so a snapshot that missed their effects plus a truncated
            # prefix would lose them. Drain first, then take the write
            # barrier, then re-check — loop if a write slipped between.
            deadline = _time.monotonic() + 60.0
            while True:
                with self._db_lock:
                    engines = sorted(self.engines.items())
                for _db, eng in engines:
                    ing = getattr(eng, "_ingestion", None)
                    if ing is not None:
                        ing.drain(
                            timeout=max(0.1, deadline - _time.monotonic())
                        )
                self._db_lock.acquire()
                db_locked = True
                engines = sorted(self.engines.items())
                for _db, eng in engines:
                    eng._lock.acquire()
                    held.append(eng)
                if all(
                    getattr(eng, "_ingestion", None) is None
                    or not eng._ingestion.pending()
                    for _db, eng in engines
                ):
                    break
                for eng in reversed(held):
                    eng._lock.release()
                held.clear()
                self._db_lock.release()
                db_locked = False
                if _time.monotonic() > deadline:
                    raise RespError("BGSAVE quiesce timed out")
            # park the (idle) workers so none wakes mid-fork
            for _db, eng in engines:
                ing = getattr(eng, "_ingestion", None)
                if ing is not None:
                    if not ing.suspend(timeout=10.0):
                        raise RespError("BGSAVE worker suspension timed out")
                    pools.append(ing)
            # widen the barrier to per-index and native-gating locks:
            # a cron vacuum or a reader inside a native call must not
            # hold a mutex the child's save path will need (locks taken
            # by the forking thread transfer cleanly to the child)
            for _db, eng in engines:
                for lk in _engine_aux_locks(eng):
                    lk.acquire()
                    aux_held.append(lk)
            fork_off = self.journal.size() if self.journal is not None else 0
            pid = _os.fork()
        except BaseException:
            for lk in reversed(aux_held):
                lk.release()
            for eng in reversed(held):
                eng._lock.release()
            if db_locked:
                self._db_lock.release()
            for p in pools:
                p.resume()
            self.bgsave_pid = None
            raise
        if pid == 0:
            # ---- child ----------------------------------------------------
            try:
                for lk in reversed(aux_held):
                    lk.release()
                for eng in reversed(held):
                    eng._lock.release()
                self._db_lock.release()
                if self.journal is not None:
                    # never touch the shared journal fd from the child
                    self.journal._closed = True
                _detach_after_fork([eng for _db, eng in engines])
                self.save_all(path, truncate_journal=False)
                _os._exit(0)
            except BaseException:
                _os._exit(1)
        # ---- parent -------------------------------------------------------
        for lk in reversed(aux_held):
            lk.release()
        for eng in reversed(held):
            eng._lock.release()
        self._db_lock.release()
        for p in pools:
            p.resume()
        self.bgsave_pid = pid
        self.bgsave_status = "in-progress"
        STATS.incr("bgsave_forks")

        def _reap():
            _, status = _os.waitpid(pid, 0)
            ok = _os.WIFEXITED(status) and _os.WEXITSTATUS(status) == 0
            if ok and self.journal is not None:
                with contextlib.suppress(OSError):
                    self.journal.truncate_upto(fork_off)
            self.bgsave_status = "ok" if ok else "err"
            self.bgsave_pid = None
            STATS.incr("bgsave_forks_ok" if ok else "bgsave_forks_failed")

        threading.Thread(target=_reap, daemon=True, name="bgsave-reap").start()
        return pid

    def load_all(self, path: str) -> None:
        """Restore a save_all checkpoint set (db 0 + any path.dbN files)."""
        import os as _os
        import re as _re

        from valkey_search_tpu_torch.persistence.checkpoint import load_engine

        if _os.path.exists(path):
            load_engine(path, engine=self.engine)
        base = _os.path.basename(path)
        d = _os.path.dirname(path) or "."
        for fn in _os.listdir(d):
            m = _re.fullmatch(_re.escape(base) + r"\.db(\d+)", fn)
            if m:
                load_engine(_os.path.join(d, fn),
                            engine=self.engine_for(int(m.group(1))))

    def start(self) -> "RespServer":
        self._server = _ThreadingTCPServer(
            (self.host, self._requested_port), _Handler
        )
        self._server.resp_server = self  # type: ignore[attr-defined]
        self._thread = threading.Thread(
            target=self._server.serve_forever,
            kwargs={"poll_interval": 0.1},
            daemon=True,
            name=f"resp-server:{self.port}",
        )
        self._thread.start()
        log("notice", f"RESP server listening on {self.host}:{self.port}")
        self._init_persistence()
        return self

    def _init_persistence(self) -> None:
        """Boot recovery (valkey startup order): restore the last
        checkpoint set if one exists, replay the op journal on top, then
        open the journal for appends. No-op unless search.journal-path is
        configured."""
        jpath = str(config.get("search.journal-path"))
        if not jpath:
            return
        from valkey_search_tpu_torch.persistence.journal import (
            OpJournal, read_records,
        )

        cpath = str(config.get("search.checkpoint-path"))
        import os as _os

        if cpath and _os.path.exists(cpath):
            self.load_all(cpath)
        n = self._replay_journal(read_records(jpath))
        if n:
            log("notice", f"journal: replayed {n} ops from {jpath}")
        self.journal = OpJournal(
            jpath, int(config.get("search.journal-fsync-ms"))
        )

    def _replay_journal(self, records) -> int:
        """Apply journal records in append order. Relative TTLs are
        rebased by the record timestamp so an EXPIRE journaled an hour ago
        does not grant a fresh full TTL at replay (valkey AOF rewrites to
        PEXPIREAT for the same reason)."""
        import time as _time

        n = 0
        now_ms = _time.time() * 1000.0
        for ts_ms, db, argv in records:
            try:
                cmd = _s(argv[0]).upper()
                if cmd == "FLUSHALL":
                    for eng in self.all_engines():
                        eng.flushall()
                elif cmd == "FLUSHDB":
                    self.engine_for(db).flushall()
                else:
                    elapsed_ms = max(0.0, now_ms - ts_ms)
                    if cmd in ("EXPIRE", "HEXPIRE") and len(argv) >= 3:
                        argv = list(argv)
                        argv[2] = str(
                            max(0.0, float(_s(argv[2])) - elapsed_ms / 1000.0)
                        )
                    elif cmd in ("PEXPIRE", "HPEXPIRE") and len(argv) >= 3:
                        argv = list(argv)
                        argv[2] = str(
                            max(0.0, float(_s(argv[2])) - elapsed_ms)
                        )
                    self.engine_for(db).execute(*argv)
                n += 1
            except Exception as exc:  # noqa: BLE001 — replay must finish
                log("warning", f"journal replay skipped {argv[:1]}: {exc}")
        return n

    def close(self) -> None:
        self._closing = True
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
        if self._thread is not None:
            self._thread.join(5)
            self._thread = None
        if self.journal is not None:
            self.journal.close()
            self.journal = None

    def __enter__(self) -> "RespServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()


def serve(host: str = "127.0.0.1", port: int = 6379, **engine_kwargs) -> None:
    """Blocking entry point: ``python -m valkey_search_tpu_torch.server.resp``."""
    engine = Engine(**engine_kwargs)
    engine.start_cron()
    srv = RespServer(engine, host=host, port=port)
    srv.start()
    try:
        srv._thread.join()
    except KeyboardInterrupt:
        srv.close()


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description="valkey-search-tpu RESP server")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=6379)
    ap.add_argument(
        "--async-ingest", action="store_true",
        help="index mutations on the background ingestion pipeline",
    )
    ap.add_argument(
        "--device", default="cuda", choices=("cuda", "cpu"),
        help="where the vector stores live (cuda: cuda:0, the default)",
    )
    ns = ap.parse_args()
    from valkey_search_tpu_torch.runtime.device import set_device

    set_device(ns.device)
    serve(host=ns.host, port=ns.port, sync_ingest=not ns.async_ingest)
