"""Append-only op journal: durability between checkpoints (AOF analog).

The reference rides valkey's AOF for mutation replay — FT.INTERNAL_UPDATE
is written to the AOF and replayed on restart (src/commands/
ft_internal_update.cc:55), and document payloads ride RDB. This standalone
engine owns its keyspace, so it carries its own write-ahead journal: every
accepted write command is framed and appended here, an fsync window bounds
the loss horizon on kill -9, and replay-on-boot restores everything since
the last checkpoint. SAVE truncates the journal under a write barrier (the
checkpoint then contains every journaled effect).

Frame format (little-endian), one record per accepted command:

    u32 payload_len | u32 crc32(payload) | payload
    payload := u64 ts_ms | u32 db | u16 argc | argc * (u32 len, bytes)

A torn tail (kill -9 mid-write) fails the length/CRC check; replay stops
there and `open` truncates the file back to the last whole record, exactly
like valkey's aof-load-truncated=yes behavior.

The port's own copy of valkey_search_tpu/persistence/journal.py, with its imports
pointing into valkey_search_tpu_torch.
"""

from __future__ import annotations

import os
import struct
import threading
import time
import zlib
from typing import Iterator, List, Sequence, Tuple

_HEADER = b"VSTPUJ1\n"
_FRAME = struct.Struct("<II")      # payload_len, crc32
_META = struct.Struct("<QIH")      # ts_ms, db, argc


class JournalError(IOError):
    pass


def _encode(ts_ms: int, db: int, argv: Sequence[bytes]) -> bytes:
    parts = [_META.pack(ts_ms, db, len(argv))]
    for a in argv:
        if isinstance(a, str):
            a = a.encode("utf-8", "surrogateescape")
        elif not isinstance(a, (bytes, bytearray, memoryview)):
            a = str(a).encode()
        a = bytes(a)
        parts.append(struct.pack("<I", len(a)))
        parts.append(a)
    payload = b"".join(parts)
    return _FRAME.pack(len(payload), zlib.crc32(payload)) + payload


def _decode(payload: bytes) -> Tuple[int, int, List[bytes]]:
    ts_ms, db, argc = _META.unpack_from(payload, 0)
    off = _META.size
    argv: List[bytes] = []
    for _ in range(argc):
        (n,) = struct.unpack_from("<I", payload, off)
        off += 4
        argv.append(payload[off:off + n])
        off += n
    if off != len(payload):
        raise JournalError("trailing bytes inside journal record")
    return ts_ms, db, argv


def read_records(path: str) -> Iterator[Tuple[int, int, List[bytes]]]:
    """Yield (ts_ms, db, argv) for every whole record; a torn/corrupt tail
    ends iteration silently (the write that tore was never acknowledged
    as durable — it is inside the loss window by definition)."""
    try:
        f = open(path, "rb")
    except FileNotFoundError:
        return
    with f:
        head = f.read(len(_HEADER))
        if head != _HEADER:
            return
        while True:
            frame = f.read(_FRAME.size)
            if len(frame) < _FRAME.size:
                return
            n, crc = _FRAME.unpack(frame)
            if n > (1 << 30):
                return  # corrupt length
            payload = f.read(n)
            if len(payload) < n or zlib.crc32(payload) != crc:
                return
            try:
                yield _decode(payload)
            except (JournalError, struct.error):
                return


def _valid_prefix_len(path: str) -> int:
    """Byte offset of the end of the last whole record."""
    good = len(_HEADER)
    try:
        f = open(path, "rb")
    except FileNotFoundError:
        return 0
    with f:
        if f.read(len(_HEADER)) != _HEADER:
            return 0
        while True:
            frame = f.read(_FRAME.size)
            if len(frame) < _FRAME.size:
                return good
            n, crc = _FRAME.unpack(frame)
            if n > (1 << 30):
                return good
            payload = f.read(n)
            if len(payload) < n or zlib.crc32(payload) != crc:
                return good
            good += _FRAME.size + n


class OpJournal:
    """Appender with a bounded-loss fsync policy.

    fsync_ms: 0 → fsync on every append (valkey appendfsync=always);
    N > 0 → at most one fsync per window, flushed by appends or by the
    background timer (appendfsync=everysec shape); < 0 → never fsync
    (OS page cache decides — appendfsync=no).
    """

    def __init__(self, path: str, fsync_ms: int = 1000):
        self.path = path
        self.fsync_ms = int(fsync_ms)
        self._lock = threading.Lock()
        self._dirty = False
        self._last_fsync = 0.0
        self._closed = False
        self._timer: threading.Thread | None = None
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        keep = _valid_prefix_len(path)
        if keep:
            # chop a torn tail so appended records stay parseable
            with open(path, "r+b") as f:
                f.truncate(keep)
            self._f = open(path, "ab")
        else:
            self._f = open(path, "wb")
            self._f.write(_HEADER)
            self._f.flush()
            os.fsync(self._f.fileno())

    # -- write side ----------------------------------------------------------
    def append(self, argv: Sequence[bytes], db: int = 0) -> None:
        rec = _encode(int(time.time() * 1000), int(db), argv)
        with self._lock:
            if self._closed:
                return
            self._f.write(rec)
            self._f.flush()
            if self.fsync_ms == 0:
                os.fsync(self._f.fileno())
                self._last_fsync = time.monotonic()
            elif self.fsync_ms > 0:
                now = time.monotonic()
                if (now - self._last_fsync) * 1000.0 >= self.fsync_ms:
                    os.fsync(self._f.fileno())
                    self._last_fsync = now
                    self._dirty = False
                else:
                    self._dirty = True
                    self._ensure_timer()

    def _ensure_timer(self) -> None:
        if self._timer is None or not self._timer.is_alive():
            self._timer = threading.Thread(
                target=self._timer_loop, daemon=True, name="journal-fsync"
            )
            self._timer.start()

    def _timer_loop(self) -> None:
        # flush writes that arrive and then go idle: without this, a burst
        # followed by silence could sit unsynced past the window
        while True:
            time.sleep(max(self.fsync_ms, 50) / 1000.0 / 2)
            with self._lock:
                if self._closed:
                    return
                if self._dirty:
                    now = time.monotonic()
                    if (now - self._last_fsync) * 1000.0 >= self.fsync_ms:
                        os.fsync(self._f.fileno())
                        self._last_fsync = now
                        self._dirty = False

    def truncate(self) -> None:
        """Reset to empty — called right after a successful checkpoint,
        under the server's write barrier (every journaled effect is now
        inside the checkpoint)."""
        with self._lock:
            if self._closed:
                return
            self._f.close()
            self._f = open(self.path, "wb")
            self._f.write(_HEADER)
            self._f.flush()
            os.fsync(self._f.fileno())
            self._last_fsync = time.monotonic()
            self._dirty = False

    def truncate_upto(self, offset: int) -> None:
        """Drop records up to byte ``offset`` (they are covered by a
        completed checkpoint), keeping everything appended after — the
        fork-BGSAVE variant: the checkpoint contains exactly the journal
        prefix that existed at fork time, so only that prefix may go.
        ``offset`` must come from a moment when no append was in flight
        (the server's write barrier guarantees it)."""
        with self._lock:
            if self._closed:
                return
            self._f.flush()
            with open(self.path, "rb") as rf:
                rf.seek(offset)
                tail = rf.read()
            # temp + atomic rename: a crash at any instant leaves either
            # the full old journal or the complete rewritten one — never
            # a zero-length window that loses fsynced post-fork records
            tmp = self.path + ".rewrite"
            with open(tmp, "wb") as wf:
                wf.write(_HEADER)
                wf.write(tail)
                wf.flush()
                os.fsync(wf.fileno())
            self._f.close()
            os.replace(tmp, self.path)
            self._f = open(self.path, "ab")
            self._last_fsync = time.monotonic()
            self._dirty = False

    def size(self) -> int:
        """Current byte length (no-append barrier assumed by callers)."""
        with self._lock:
            self._f.flush()
            return os.path.getsize(self.path)

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            try:
                self._f.flush()
                os.fsync(self._f.fileno())
            except (OSError, ValueError):
                pass
            self._f.close()
