"""Framed chunk container: json section headers + raw ndarray payloads.

Reference: src/rdb_serialization.h — SafeRDB IO-checked wrapper (:68),
RDBSection protos (:162-287) and RDBChunkInputStream/OutputStream
(:289-367) that frame supplemental payloads as length-prefixed chunks.

Layout:
    magic "VSTPURDB" | u32 format_version | u32 min_compat_version
    repeated sections:
        u32 header_len | header json utf-8
        per array in header["arrays"]: raw bytes (dtype/shape in manifest),
        written and read in bounded chunks
    u32 0  (end marker)

Readers must refuse files whose min_compat_version exceeds what they
understand (reference min-semantic-version gate, rdb-format.md).

The port's own copy of valkey_search_tpu/persistence/format.py, with its imports
pointing into valkey_search_tpu_torch.
"""

from __future__ import annotations

import json
import struct
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

MAGIC = b"VSTPURDB"
FORMAT_VERSION = 1
MIN_COMPAT_VERSION = 1
CHUNK_BYTES = 4 << 20  # stream payloads in 4MiB chunks


class FormatError(IOError):
    pass


class ChunkWriter:
    def __init__(self, path: str):
        # the override_min_version controlled variable stamps an arbitrary
        # min-compat version into the header so tests can produce a
        # "from the future" file (reference RDBSectionSerializer min
        # semantic version override, drilled by integration/
        # test_versioning.py: save under override → reload must fail)
        min_compat = MIN_COMPAT_VERSION
        from valkey_search_tpu_torch.runtime.debug import CONTROLLED
        ov = CONTROLLED.get("override_min_version")
        if ov is not None and int(str(ov)) != -1:  # -1 == unset (reference)
            min_compat = int(str(ov))
        self._f = open(path, "wb")
        self._f.write(MAGIC)
        self._f.write(struct.pack("<II", FORMAT_VERSION, min_compat))

    def section(self, meta: Dict, arrays: Optional[List[np.ndarray]] = None) -> None:
        arrays = arrays or []
        manifest = []
        prepared = []
        for a in arrays:
            a = np.ascontiguousarray(a)
            manifest.append(
                {"dtype": a.dtype.str, "shape": list(a.shape), "nbytes": a.nbytes}
            )
            prepared.append(a)
        meta = dict(meta)
        meta["arrays"] = manifest
        blob = json.dumps(meta).encode()
        self._f.write(struct.pack("<I", len(blob)))
        self._f.write(blob)
        for a in prepared:
            view = memoryview(a).cast("B")
            for off in range(0, len(view), CHUNK_BYTES):
                self._f.write(view[off : off + CHUNK_BYTES])

    def close(self) -> None:
        self._f.write(struct.pack("<I", 0))
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class ChunkReader:
    def __init__(self, path: str):
        self._f = open(path, "rb")
        magic = self._f.read(len(MAGIC))
        if magic != MAGIC:
            raise FormatError(f"bad magic {magic!r}")
        header = self._f.read(8)
        if len(header) != 8:
            raise FormatError("truncated header")
        self.format_version, self.min_compat_version = struct.unpack("<II", header)
        if self.min_compat_version > FORMAT_VERSION:
            raise FormatError(
                f"checkpoint requires format >= {self.min_compat_version}, "
                f"reader supports {FORMAT_VERSION}"
            )

    def _read_exact(self, n: int) -> bytes:
        b = self._f.read(n)
        if len(b) != n:
            raise FormatError("truncated section payload")
        return b

    def sections(self) -> Iterator[Tuple[Dict, List[np.ndarray]]]:
        while True:
            raw = self._f.read(4)
            if len(raw) != 4:
                raise FormatError("missing end marker")
            (hlen,) = struct.unpack("<I", raw)
            if hlen == 0:
                return
            meta = json.loads(self._read_exact(hlen))
            arrays = []
            for m in meta.get("arrays", ()):
                buf = bytearray(m["nbytes"])
                mv = memoryview(buf)
                for off in range(0, m["nbytes"], CHUNK_BYTES):
                    chunk = self._read_exact(min(CHUNK_BYTES, m["nbytes"] - off))
                    mv[off : off + len(chunk)] = chunk
                arr = np.frombuffer(bytes(buf), dtype=np.dtype(m["dtype"]))
                arrays.append(arr.reshape(m["shape"]))
            yield meta, arrays

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
