"""ctypes binding to the native C++ layer (native/, built by native/build.py).

The port's own copy of valkey_search_tpu/native_lib.py, cut to what the
port uses: the loader ``load()``, ``cpu_brute_force_topk`` (one exact
query on one host core), ``HnswBuilder`` (the HNSW graph builder and its CPU
search oracle), ``NativeLexer`` and ``NativeTextIndex``, with the same names
and behaviour. The native sources under native/ are
repository-level and shared by both packages; each package binds them
itself.
"""

from __future__ import annotations

import ctypes as ct
import os
import sys
import threading
from typing import Optional, Tuple

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(_REPO_ROOT, "native"))

_lib = None
_lib_lock = threading.Lock()


def load() -> ct.CDLL:
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        from build import lib_path  # native/build.py

        lib = ct.CDLL(lib_path())
        lib.hnsw_create.restype = ct.c_void_p
        lib.hnsw_create.argtypes = [
            ct.c_int, ct.c_int, ct.c_int, ct.c_int, ct.c_uint64,
        ]
        lib.hnsw_free.argtypes = [ct.c_void_p]
        lib.hnsw_add.restype = ct.c_int32
        lib.hnsw_add.argtypes = [ct.c_void_p, ct.POINTER(ct.c_float)]
        lib.hnsw_dirty_count.restype = ct.c_int32
        lib.hnsw_dirty_count.argtypes = [ct.c_void_p]
        lib.hnsw_upper_dirty.restype = ct.c_int
        lib.hnsw_upper_dirty.argtypes = [ct.c_void_p]
        lib.hnsw_export_dirty.restype = ct.c_int32
        lib.hnsw_export_dirty.argtypes = [
            ct.c_void_p, ct.POINTER(ct.c_int32), ct.POINTER(ct.c_int32),
            ct.POINTER(ct.c_uint8),
        ]
        lib.hnsw_clear_dirty.argtypes = [ct.c_void_p]
        lib.hnsw_components.restype = ct.c_int32
        lib.hnsw_components.argtypes = [ct.c_void_p, ct.POINTER(ct.c_int32)]
        lib.hnsw_add_bridge.argtypes = [ct.c_void_p, ct.c_int32, ct.c_int32]
        lib.hnsw_bulk_build.restype = ct.c_int
        lib.hnsw_bulk_build.argtypes = [
            ct.c_void_p, ct.POINTER(ct.c_float), ct.c_int32,
            ct.POINTER(ct.c_int32), ct.POINTER(ct.c_int32), ct.c_int32,
        ]
        lib.hnsw_add_batch_seeded.argtypes = [
            ct.c_void_p, ct.POINTER(ct.c_float), ct.c_int32,
            ct.POINTER(ct.c_int32), ct.c_int32, ct.POINTER(ct.c_int32),
        ]
        lib.hnsw_add_batch.argtypes = [
            ct.c_void_p, ct.POINTER(ct.c_float), ct.c_int32,
            ct.POINTER(ct.c_int32),
        ]
        lib.hnsw_add_batch_mt.argtypes = [
            ct.c_void_p, ct.POINTER(ct.c_float), ct.c_int32, ct.c_int,
            ct.POINTER(ct.c_int32),
        ]
        lib.hnsw_mark_deleted.argtypes = [ct.c_void_p, ct.c_int32, ct.c_int]
        lib.hnsw_search.restype = ct.c_int
        lib.hnsw_search.argtypes = [
            ct.c_void_p, ct.POINTER(ct.c_float), ct.c_int, ct.c_int,
            ct.POINTER(ct.c_int32), ct.POINTER(ct.c_float),
        ]
        for name in ("hnsw_count", "hnsw_entry"):
            getattr(lib, name).restype = ct.c_int32
            getattr(lib, name).argtypes = [ct.c_void_p]
        lib.hnsw_max_level.restype = ct.c_int
        lib.hnsw_max_level.argtypes = [ct.c_void_p]
        lib.hnsw_bytes.restype = ct.c_int64
        lib.hnsw_bytes.argtypes = [ct.c_void_p]
        for name in ("hnsw_dist_comps", "hnsw_hops"):
            getattr(lib, name).restype = ct.c_uint64
            getattr(lib, name).argtypes = [ct.c_void_p]
        lib.hnsw_export_links0.argtypes = [ct.c_void_p, ct.POINTER(ct.c_int32)]
        lib.hnsw_export_levels.argtypes = [ct.c_void_p, ct.POINTER(ct.c_int32)]
        lib.hnsw_export_deleted.argtypes = [ct.c_void_p, ct.POINTER(ct.c_uint8)]
        lib.hnsw_export_upper.restype = ct.c_int32
        lib.hnsw_export_upper.argtypes = [
            ct.c_void_p, ct.c_int, ct.POINTER(ct.c_int32),
            ct.POINTER(ct.c_int32),
        ]
        lib.hnsw_count_at_level.restype = ct.c_int32
        lib.hnsw_count_at_level.argtypes = [ct.c_void_p, ct.c_int]
        lib.hnsw_import.restype = ct.c_int
        lib.hnsw_import.argtypes = [
            ct.c_void_p, ct.c_int32, ct.POINTER(ct.c_float),
            ct.POINTER(ct.c_int32), ct.POINTER(ct.c_int32),
            ct.POINTER(ct.c_uint8), ct.POINTER(ct.c_int32),
            ct.POINTER(ct.c_int64), ct.c_int32, ct.c_int,
        ]
        lib.bf_topk.argtypes = [
            ct.POINTER(ct.c_float), ct.c_int32, ct.c_int,
            ct.POINTER(ct.c_float), ct.c_int, ct.c_int,
            ct.POINTER(ct.c_int32), ct.POINTER(ct.c_float),
        ]
        _lib = lib
        return lib


def cpu_brute_force_topk(
    corpus: np.ndarray, query: np.ndarray, k: int, metric: str = "l2"
) -> Tuple[np.ndarray, np.ndarray]:
    """Single-query exact CPU scan (reference bruteforce.h equivalent);
    the single-host CPU baseline for bench_torch.py. Returns (dists, ids)."""
    lib = load()
    corpus = np.ascontiguousarray(corpus, np.float32)
    query = np.ascontiguousarray(query, np.float32)
    ids = np.full(k, -1, np.int32)
    dists = np.full(k, np.inf, np.float32)
    lib.bf_topk(
        _fptr(corpus), corpus.shape[0], corpus.shape[1], _fptr(query),
        k, 0 if metric == "l2" else 1, _iptr(ids), _fptr(dists),
    )
    return dists, ids


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ct.POINTER(ct.c_float))


def _iptr(a: np.ndarray):
    return a.ctypes.data_as(ct.POINTER(ct.c_int32))


class HnswBuilder:
    """Native HNSW graph builder + CPU search oracle.

    Semantics track the reference's modified hnswlib (hnswalg.h): geometric
    level assignment with mult=1/ln(M), ef_construction beam per layer,
    keep-pruned-out neighbor heuristic, bidirectional connect with overflow
    re-selection, tombstone deletes traversed-but-not-returned.
    """

    METRICS = {"l2": 0, "ip": 1, "cosine": 1}

    def __init__(self, dim: int, metric: str = "l2", m: int = 16,
                 ef_construction: int = 200, seed: int = 0x5EED):
        self._lib = load()
        self.dim = dim
        self.metric = metric
        self.m = m
        self.ef_construction = ef_construction
        self._h = self._lib.hnsw_create(
            dim, self.METRICS[metric], m, ef_construction, seed
        )
        self._lock = threading.Lock()

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.hnsw_free(h)
            self._h = None

    # -- construction -------------------------------------------------------
    def add(self, vec: np.ndarray) -> int:
        vec = np.ascontiguousarray(vec, np.float32)
        with self._lock:
            return int(self._lib.hnsw_add(self._h, _fptr(vec)))

    def add_batch(self, vecs: np.ndarray, threads: int = 1) -> np.ndarray:
        """Batch insert. threads > 1 builds concurrently (per-node striped
        locks + global entry lock — reference thread-safe addPoint,
        hnswalg.h:1260-1270); the C call releases the GIL, so worker
        threads scale on real cores."""
        vecs = np.ascontiguousarray(vecs, np.float32)
        out = np.empty(vecs.shape[0], np.int32)
        with self._lock:
            if threads > 1:
                self._lib.hnsw_add_batch_mt(
                    self._h, _fptr(vecs), vecs.shape[0], int(threads),
                    _iptr(out)
                )
            else:
                self._lib.hnsw_add_batch(
                    self._h, _fptr(vecs), vecs.shape[0], _iptr(out)
                )
        return out

    def add_batch_seeded(self, vecs: np.ndarray,
                         seeds: np.ndarray) -> np.ndarray:
        """Insert a batch with device-computed level-0 candidate pools.

        ``seeds``: [n, k] int32 node ids — for row i, the exact nearest
        nodes of vecs[i] among all node ids < (count + i), -1 padded.
        The builder skips the level-0 ef_construction beam entirely
        (add_seeded): candidate quality is exact, so recall matches or
        beats beam-built graphs at a fraction of the host cost."""
        vecs = np.ascontiguousarray(vecs, np.float32)
        seeds = np.ascontiguousarray(seeds, np.int32)
        assert seeds.shape[0] == vecs.shape[0]
        out = np.empty(vecs.shape[0], np.int32)
        with self._lock:
            self._lib.hnsw_add_batch_seeded(
                self._h, _fptr(vecs), vecs.shape[0], _iptr(seeds),
                seeds.shape[1], _iptr(out),
            )
        return out

    def bulk_build(self, vecs: np.ndarray, levels: np.ndarray,
                   links: np.ndarray) -> np.ndarray:
        """Vectorized bulk construction from device-pruned KNN links
        (ops/hnsw_build.py). Requires an empty builder; returns node ids
        0..n-1 (insertion order == row order)."""
        vecs = np.ascontiguousarray(vecs, np.float32)
        levels = np.ascontiguousarray(levels, np.int32)
        links = np.ascontiguousarray(links, np.int32)
        n = vecs.shape[0]
        assert levels.shape[0] == n and links.shape[0] == n
        with self._lock:
            rc = self._lib.hnsw_bulk_build(
                self._h, _fptr(vecs), n, _iptr(levels), _iptr(links),
                links.shape[1],
            )
        if rc != 0:
            raise RuntimeError("bulk_build requires an empty index")
        return np.arange(n, dtype=np.int32)

    @property
    def dirty_count(self) -> int:
        return int(self._lib.hnsw_dirty_count(self._h))

    @property
    def upper_dirty(self) -> bool:
        return bool(self._lib.hnsw_upper_dirty(self._h))

    def export_dirty(self):
        """(nodes [n], links0 [n, 2m], deleted [n]) of changed level-0
        rows since the last export; clears the dirty set."""
        n = self.dirty_count
        nodes = np.empty(max(n, 1), np.int32)
        links = np.empty((max(n, 1), 2 * self.m), np.int32)
        deleted = np.empty(max(n, 1), np.uint8)
        with self._lock:
            got = int(self._lib.hnsw_export_dirty(
                self._h, _iptr(nodes), _iptr(links),
                deleted.ctypes.data_as(ct.POINTER(ct.c_uint8)),
            ))
        return nodes[:got], links[:got], deleted[:got].astype(bool)

    def clear_dirty(self) -> None:
        with self._lock:
            self._lib.hnsw_clear_dirty(self._h)

    def components(self) -> np.ndarray:
        """Level-0 connected-component labels [count] (undirected)."""
        n = self.count
        out = np.empty(n, np.int32)
        if n == 0:
            return out
        with self._lock:
            self._lib.hnsw_components(self._h, _iptr(out))
        return out

    def add_bridge(self, u: int, v: int) -> None:
        """Force a mutual level-0 edge (connectivity repair)."""
        with self._lock:
            self._lib.hnsw_add_bridge(self._h, int(u), int(v))

    def mark_deleted(self, node: int, flag: bool = True) -> None:
        with self._lock:
            self._lib.hnsw_mark_deleted(self._h, node, int(flag))

    # -- CPU oracle search ---------------------------------------------------
    def search(self, q: np.ndarray, k: int, ef: int) -> Tuple[np.ndarray, np.ndarray]:
        q = np.ascontiguousarray(q, np.float32)
        ids = np.full(k, -1, np.int32)
        dists = np.full(k, np.inf, np.float32)
        with self._lock:
            n = self._lib.hnsw_search(
                self._h, _fptr(q), k, ef, _iptr(ids), _fptr(dists)
            )
        return dists[:n], ids[:n]

    # -- introspection -------------------------------------------------------
    @property
    def count(self) -> int:
        return int(self._lib.hnsw_count(self._h))

    @property
    def entry(self) -> int:
        return int(self._lib.hnsw_entry(self._h))

    @property
    def max_level(self) -> int:
        return int(self._lib.hnsw_max_level(self._h))

    @property
    def dist_comps(self) -> int:
        return int(self._lib.hnsw_dist_comps(self._h))

    def memory_bytes(self) -> int:
        return int(self._lib.hnsw_bytes(self._h))

    # -- graph export for device upload / checkpoint -------------------------
    def export_uppers(self):
        """Per-level upper exports (levels 1..max_level) — small
        (~count/M rows total), re-exported whole when any upper changed."""
        uppers = []
        level = 1
        n = self.count
        while n and level <= self.max_level:
            cnt = int(self._lib.hnsw_count_at_level(self._h, level))
            nodes = np.empty(max(cnt, 1), np.int32)
            links = np.empty((max(cnt, 1), self.m), np.int32)
            got = int(self._lib.hnsw_export_upper(
                self._h, level, _iptr(nodes), _iptr(links)
            ))
            uppers.append({"nodes": nodes[:got], "links": links[:got]})
            level += 1
        return uppers

    def export_graph(self) -> dict:
        n = self.count
        m0 = 2 * self.m
        links0 = np.empty((n, m0), np.int32)
        levels = np.empty(n, np.int32)
        deleted = np.empty(n, np.uint8)
        if n:
            self._lib.hnsw_export_links0(self._h, _iptr(links0))
            self._lib.hnsw_export_levels(self._h, _iptr(levels))
            self._lib.hnsw_export_deleted(
                self._h, deleted.ctypes.data_as(ct.POINTER(ct.c_uint8))
            )
        uppers = []
        level = 1
        while n and level <= self.max_level:
            cnt = int(self._lib.hnsw_count_at_level(self._h, level))
            nodes = np.empty(max(cnt, 1), np.int32)
            links = np.empty((max(cnt, 1), self.m), np.int32)
            got = int(self._lib.hnsw_export_upper(
                self._h, level, _iptr(nodes), _iptr(links)
            ))
            uppers.append({"nodes": nodes[:got], "links": links[:got]})
            level += 1
        return {
            "links0": links0,
            "levels": levels,
            "deleted": deleted.astype(bool),
            "uppers": uppers,
            "entry": self.entry,
            "max_level": self.max_level,
            "count": n,
        }

    def import_graph(self, vectors: np.ndarray, graph: dict) -> None:
        """Restore builder state from export_graph() output + vectors."""
        n = int(graph["count"])
        levels = np.ascontiguousarray(graph["levels"], np.int32)
        links0 = np.ascontiguousarray(graph["links0"], np.int32)
        deleted = np.ascontiguousarray(
            np.asarray(graph["deleted"]).astype(np.uint8)
        )
        vectors = np.ascontiguousarray(vectors[:n], np.float32)
        # rebuild per-node flat upper arrays from per-level exports
        offsets = np.zeros(max(n, 1), np.int64)
        sizes = levels.astype(np.int64) * self.m
        if n:
            offsets[1:] = np.cumsum(sizes)[:-1]
        upper_flat = np.full(int(sizes.sum()) or 1, -1, np.int32)
        for li, lv in enumerate(graph["uppers"], start=1):
            for node, row in zip(lv["nodes"], lv["links"]):
                off = int(offsets[node]) + (li - 1) * self.m
                upper_flat[off : off + self.m] = row
        rc = self._lib.hnsw_import(
            self._h, n, _fptr(vectors), _iptr(links0), _iptr(levels),
            deleted.ctypes.data_as(ct.POINTER(ct.c_uint8)),
            _iptr(upper_flat),
            offsets.ctypes.data_as(ct.POINTER(ct.c_int64)),
            int(graph["entry"]), int(graph["max_level"]),
        )
        if rc != 0:
            raise ValueError(f"hnsw_import failed: corrupt graph (code {rc})")



class NativeLexer:
    """ctypes wrapper over native/text_core.cpp — the text-ingest hot loop
    (punctuation split, ASCII fold, stop words, snowball-3.0.1 stemming
    with an in-library cache), mirroring the reference's all-C++ lexer
    (src/indexes/text/lexer.cc)."""

    def __init__(self, punctuation: str, stop_words, min_stem_size: int):
        self._lib = load()
        if not hasattr(self._lib, "_lexer_ready"):
            self._lib.lexer_create.restype = ct.c_void_p
            self._lib.lexer_create.argtypes = [
                ct.c_char_p, ct.c_int, ct.c_char_p, ct.c_int, ct.c_int,
                ct.c_int,
            ]
            self._lib.lexer_free.argtypes = [ct.c_void_p]
            self._lib.lexer_tokenize.restype = ct.c_int
            self._lib.lexer_tokenize.argtypes = [
                ct.c_void_p, ct.c_char_p, ct.c_int, ct.c_char_p, ct.c_int,
            ]
            self._lib.stem_word.restype = ct.c_int
            self._lib.stem_word.argtypes = [
                ct.c_char_p, ct.c_int, ct.c_char_p, ct.c_int,
            ]
            self._lib._lexer_ready = True
        punct = punctuation.encode()
        stops = b"\x00".join(w.encode() for w in stop_words) + b"\x00"
        self._h = self._lib.lexer_create(
            punct, len(punct), stops, len(stops), len(tuple(stop_words)),
            int(min_stem_size),
        )
        self._lock = threading.Lock()
        self._buf = ct.create_string_buffer(1 << 16)

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.lexer_free(h)
            self._h = None

    def tokenize(self, text: str):
        """[(word, stem_or_empty), ...] or None when the text outgrows the
        buffer (caller falls back to the Python path)."""
        raw = text.encode()
        with self._lock:
            need = len(raw) * 2 + 64
            if need > len(self._buf):
                self._buf = ct.create_string_buffer(max(need, 1 << 16))
            n = self._lib.lexer_tokenize(
                self._h, raw, len(raw), self._buf, len(self._buf)
            )
            if n < 0:
                return None
            parts = self._buf[:n].split(b"\x00")[:-1]
        return [
            (parts[i].decode(), parts[i + 1].decode())
            for i in range(0, len(parts), 2)
        ]


class NativeTextIndex:
    """ctypes wrapper over native/text_index.cpp — dictionary, postings,
    stem tree, and per-doc token store in C++ (reference: rax + C++
    postings, src/indexes/text/{text_index,posting}.cc). One call per
    (doc, field) on ingest; union/positions queries return numpy arrays.

    The wrapper shares the NativeLexer's handle so tokenization happens
    inside the same C call as the posting update."""

    def __init__(self, native_lexer: "NativeLexer"):
        self._lexer = native_lexer  # keep alive: C side borrows its handle
        self._lib = load()
        if not hasattr(self._lib, "_tix_ready"):
            L = self._lib
            L.tix_create.restype = ct.c_void_p
            L.tix_create.argtypes = [ct.c_void_p]
            L.tix_free.argtypes = [ct.c_void_p]
            L.tix_update_field.restype = ct.c_int
            L.tix_update_field.argtypes = [
                ct.c_void_p, ct.c_int32, ct.c_int, ct.c_int,
                ct.c_char_p, ct.c_int, ct.c_char_p, ct.c_int,
            ]
            L.tix_update_field_tokens.restype = ct.c_int
            L.tix_update_field_tokens.argtypes = [
                ct.c_void_p, ct.c_int32, ct.c_int, ct.c_int,
                ct.c_char_p, ct.c_int, ct.c_char_p, ct.c_int,
            ]
            L.tix_remove_field.restype = ct.c_int
            L.tix_remove_field.argtypes = [
                ct.c_void_p, ct.c_int32, ct.c_int, ct.c_int,
                ct.c_char_p, ct.c_int,
            ]
            L.tix_last_events.restype = ct.c_int
            L.tix_last_events.argtypes = [
                ct.c_void_p, ct.c_char_p, ct.c_int,
            ]
            L.tix_docs_union.restype = ct.c_int64
            L.tix_docs_union.argtypes = [
                ct.c_void_p, ct.c_char_p, ct.c_int, ct.c_uint64,
                ct.POINTER(ct.c_int64), ct.c_int64,
            ]
            L.tix_expand.restype = ct.c_int
            L.tix_expand.argtypes = [
                ct.c_void_p, ct.c_int, ct.c_char_p, ct.c_int, ct.c_int,
                ct.c_char_p, ct.c_int,
            ]
            L.tix_docs_union_expand.restype = ct.c_int64
            L.tix_docs_union_expand.argtypes = [
                ct.c_void_p, ct.c_int, ct.c_char_p, ct.c_int, ct.c_int,
                ct.c_uint64, ct.POINTER(ct.c_int64), ct.c_int64,
            ]
            L.tix_contains.restype = ct.c_int
            L.tix_contains.argtypes = [
                ct.c_void_p, ct.c_char_p, ct.c_int32, ct.c_uint64,
            ]
            L.tix_positions.restype = ct.c_int
            L.tix_positions.argtypes = [
                ct.c_void_p, ct.c_char_p, ct.c_int32, ct.c_uint64,
                ct.POINTER(ct.c_int32), ct.c_int,
            ]
            L.tix_phrase_docs.restype = ct.c_int64
            L.tix_phrase_docs.argtypes = [
                ct.c_void_p, ct.c_char_p, ct.POINTER(ct.c_int32),
                ct.c_int, ct.c_uint64, ct.c_int, ct.c_int,
                ct.POINTER(ct.c_int64), ct.c_int64,
            ]
            L.tix_phrase_check.restype = ct.c_int
            L.tix_phrase_check.argtypes = [
                ct.c_void_p, ct.c_char_p, ct.POINTER(ct.c_int32),
                ct.c_int, ct.c_int32, ct.c_uint64, ct.c_int, ct.c_int,
            ]
            L.tix_key_count.restype = ct.c_int32
            L.tix_key_count.argtypes = [ct.c_void_p, ct.c_char_p]
            L.tix_position_count.restype = ct.c_int64
            L.tix_position_count.argtypes = [ct.c_void_p, ct.c_char_p]
            L.tix_stem_parents.restype = ct.c_int
            L.tix_stem_parents.argtypes = [
                ct.c_void_p, ct.c_char_p, ct.c_char_p, ct.c_int,
            ]
            L.tix_stem_count.restype = ct.c_int32
            L.tix_stem_count.argtypes = [ct.c_void_p]
            L.tix_doc_count.restype = ct.c_int32
            L.tix_doc_count.argtypes = [ct.c_void_p]
            L.tix_total_positions.restype = ct.c_int64
            L.tix_total_positions.argtypes = [ct.c_void_p]
            L.tix_bytes.restype = ct.c_int64
            L.tix_bytes.argtypes = [ct.c_void_p]
            L._tix_ready = True
        self._h = self._lib.tix_create(native_lexer._h)
        self._fn_update = self._lib.tix_update_field
        self._ev = ct.create_string_buffer(1 << 16)
        self._ids = np.empty(1 << 16, np.int64)
        self._pos = np.empty(1 << 12, np.int32)
        self._lock = threading.Lock()

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.tix_free(h)
            self._h = None

    def _events(self, n: int):
        # slice the ctypes array directly — Array.__getitem__ with a slice
        # copies only n bytes (``.raw`` would memcpy the whole 64KiB buffer
        # per call, which dominated the single-doc ingest profile)
        buf = self._ev[:n]
        code = chr(buf[0]) if n else "A"
        added, removed = [], []
        for part in buf[1:].split(b"\x00")[:-1] if n > 1 else []:
            if part[:1] == b"+":
                added.append(part[1:].decode())
            elif part[:1] == b"-":
                removed.append(part[1:].decode())
        return code, added, removed

    _TOKENIZE_FAILED = -(2**31)  # INT32_MIN sentinel from tix_update_field

    def _finish_events(self, n: int):
        """Resolve a mutating call's return: n >= 0 is the event-blob
        size; n < 0 is -(needed) — the mutation ALREADY ran, so grow the
        buffer and fetch the recorded events via tix_last_events instead
        of re-executing (a re-run would emit no '+word' births for
        postings created by the first run, silently desyncing the Python
        dictionary mirror)."""
        while n < 0:
            self._ev = ct.create_string_buffer(max(-n + 64, len(self._ev)))
            n = self._lib.tix_last_events(self._h, self._ev, len(self._ev))
        return self._events(n)

    def update_field(self, doc: int, bit_index: int, no_stem: bool,
                     text: str):
        """Returns (code 'A'|'M', new_words, dead_words); None when the
        text is non-ASCII or untokenizable natively (caller tokenizes in
        Python and retries via update_field_tokens)."""
        if not text.isascii():
            return None
        raw = text.encode()
        fn = self._fn_update
        with self._lock:
            n = fn(
                self._h, doc, bit_index, int(no_stem), raw, len(raw),
                self._ev, len(self._ev),
            )
            if n == self._TOKENIZE_FAILED:
                return None
            return self._finish_events(n)

    def update_field_tokens(self, doc: int, bit_index: int, no_stem: bool,
                            pairs):
        """pairs: [(word, stem_or_empty), ...] from the Python tokenizer."""
        blob = b"".join(
            w.encode() + b"\x00" + s.encode() + b"\x00" for w, s in pairs
        )
        with self._lock:
            n = self._lib.tix_update_field_tokens(
                self._h, doc, bit_index, int(no_stem), blob, len(blob),
                self._ev, len(self._ev),
            )
            return self._finish_events(n)

    def remove_field(self, doc: int, bit_index: int, no_stem: bool):
        with self._lock:
            n = self._lib.tix_remove_field(
                self._h, doc, bit_index, int(no_stem),
                self._ev, len(self._ev)
            )
            return self._finish_events(n)

    def docs_union(self, words, mask: int) -> np.ndarray:
        """Sorted unique doc ids where any word matches mask."""
        blob = b"".join(w.encode() + b"\x00" for w in words)
        with self._lock:
            while True:
                n = self._lib.tix_docs_union(
                    self._h, blob, len(words), mask & 0xFFFFFFFFFFFFFFFF,
                    self._ids.ctypes.data_as(ct.POINTER(ct.c_int64)),
                    len(self._ids),
                )
                if n >= 0:
                    return self._ids[:n].copy()
                self._ids = np.empty(max(-n, len(self._ids) * 2), np.int64)

    EXPAND_KINDS = {"prefix": 0, "suffix": 1, "infix": 2, "fuzzy": 3}

    def expand(self, kind: str, term: str, dist: int, max_exp: int):
        """Dictionary words a wide matcher touches — the native walk over
        the ordered vocabulary (tix_expand)."""
        k = self.EXPAND_KINDS[kind]
        buf = ct.create_string_buffer(1 << 14)
        with self._lock:
            n = self._lib.tix_expand(
                self._h, k, term.encode(), dist, max_exp, buf, len(buf)
            )
            if n < 0:
                buf = ct.create_string_buffer(-n + 64)
                n = self._lib.tix_expand(
                    self._h, k, term.encode(), dist, max_exp, buf, len(buf)
                )
        if n <= 0:
            return []
        return [p.decode() for p in buf[:n].split(b"\x00")[:-1]]

    def docs_union_expand(
        self, kind: str, term: str, dist: int, max_exp: int, mask: int
    ) -> np.ndarray:
        """Fused expansion + union: one C call resolves a wide matcher to
        its sorted unique doc-id set (tix_docs_union_expand)."""
        k = self.EXPAND_KINDS[kind]
        with self._lock:
            while True:
                n = self._lib.tix_docs_union_expand(
                    self._h, k, term.encode(), dist, max_exp,
                    mask & 0xFFFFFFFFFFFFFFFF,
                    self._ids.ctypes.data_as(ct.POINTER(ct.c_int64)),
                    len(self._ids),
                )
                if n >= 0:
                    return self._ids[:n].copy()
                self._ids = np.empty(max(-n, len(self._ids) * 2), np.int64)

    @staticmethod
    def _phrase_blob(groups):
        """Flatten per-slot variant word lists for tix_phrase_docs/check:
        (NUL-separated words in slot order, int32 per-slot counts)."""
        blob = b"".join(
            w.encode() + b"\x00" for g in groups for w in g
        )
        counts = (ct.c_int32 * len(groups))(*[len(g) for g in groups])
        return blob, counts

    def phrase_docs(
        self, groups, mask: int, slop: int, inorder: bool
    ) -> np.ndarray:
        """Sorted doc ids matching a phrase: per-slot unions, candidate
        intersection, and the positional SLOP/INORDER walk all in one C
        call (tix_phrase_docs)."""
        blob, counts = self._phrase_blob(groups)
        with self._lock:
            while True:
                n = self._lib.tix_phrase_docs(
                    self._h, blob, counts, len(groups),
                    mask & 0xFFFFFFFFFFFFFFFF, int(slop), int(inorder),
                    self._ids.ctypes.data_as(ct.POINTER(ct.c_int64)),
                    len(self._ids),
                )
                if n >= 0:
                    return self._ids[:n].copy()
                self._ids = np.empty(max(-n, len(self._ids) * 2), np.int64)

    def phrase_check(
        self, groups, doc: int, mask: int, slop: int, inorder: bool
    ) -> bool:
        """Does ONE doc contain the phrase? (per-result-row verification)"""
        blob, counts = self._phrase_blob(groups)
        return bool(self._lib.tix_phrase_check(
            self._h, blob, counts, len(groups), doc,
            mask & 0xFFFFFFFFFFFFFFFF, int(slop), int(inorder),
        ))

    def contains(self, word: str, doc: int, mask: int) -> bool:
        return bool(self._lib.tix_contains(
            self._h, word.encode(), doc, mask & 0xFFFFFFFFFFFFFFFF
        ))

    def positions(self, word: str, doc: int, mask: int):
        with self._lock:
            while True:
                n = self._lib.tix_positions(
                    self._h, word.encode(), doc, mask & 0xFFFFFFFFFFFFFFFF,
                    self._pos.ctypes.data_as(ct.POINTER(ct.c_int32)),
                    len(self._pos),
                )
                if n >= 0:
                    return self._pos[:n].tolist()
                self._pos = np.empty(max(-n, len(self._pos) * 2), np.int32)

    def key_count(self, word: str) -> int:
        return int(self._lib.tix_key_count(self._h, word.encode()))

    def position_count(self, word: str) -> int:
        return int(self._lib.tix_position_count(self._h, word.encode()))

    def stem_parents(self, stem: str):
        buf = ct.create_string_buffer(1 << 14)
        n = self._lib.tix_stem_parents(self._h, stem.encode(), buf, len(buf))
        if n < 0:  # -(needed): large stem family — grow and retry
            buf = ct.create_string_buffer(-n + 64)
            n = self._lib.tix_stem_parents(
                self._h, stem.encode(), buf, len(buf))
        if n <= 0:
            return []
        return [p.decode() for p in buf[:n].split(b"\x00")[:-1]]

    def stem_count(self) -> int:
        return int(self._lib.tix_stem_count(self._h))

    def doc_count(self) -> int:
        return int(self._lib.tix_doc_count(self._h))

    def total_positions(self) -> int:
        return int(self._lib.tix_total_positions(self._h))

    def bytes_used(self) -> int:
        return int(self._lib.tix_bytes(self._h))
