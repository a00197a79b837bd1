"""Shared vector-index logic: value parsing, host store, device mirror.

Counterpart of valkey_search_tpu/indexes/vector_base.py. The host keeps the
authoritative rows in numpy arrays; each store carries the ``torch.device``
it was made for and publishes a mirror there, either by scatter (few dirty
rows) or by full upload (bulk change, growth, a changed corpus dtype, or an
int8 row past the published quantization range). A published mirror is never
written again: a scatter builds new tensors, so a search that holds a
snapshot sees one consistent state, as in the JAX package.

Mirror keys: ``vectors`` fp32 [cap, d], ``norms_sq`` fp32 [cap], ``invalid``
bool [cap], plus ``vectors_lp`` bf16 under ``search.corpus-dtype bfloat16``
or ``vectors_i8`` int8 with its f32 scalar ``i8_scale`` under ``int8``.

Over ``search.ivf-threshold`` rows an index also keeps an IVF mirror
(``VectorIndexBase.ivf_mirror``, ``ops/ivf.py``), rebuilt only once mutation
drift is material; the rows written since its build (``ivf_delta_ids``) are
scored exactly beside it.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from valkey_search_tpu_torch.runtime import config
from valkey_search_tpu_torch.runtime.metrics import STATS
from valkey_search_tpu_torch.utils.interning import KeyInterner
from valkey_search_tpu_torch.indexes.base import IndexBase, RecordResult
from valkey_search_tpu_torch.ops import ivf as ivf_ops
from valkey_search_tpu_torch.runtime.device import get_device

VectorLike = Union[bytes, bytearray, memoryview, np.ndarray, Sequence[float]]


def parse_vector(value: VectorLike, dim: int) -> np.ndarray:
    """Decode a vector attribute value (little-endian fp32 blob, array or
    sequence) into fp32 [dim]."""
    if isinstance(value, (bytes, bytearray, memoryview)):
        arr = np.frombuffer(value, dtype="<f4")
    else:
        arr = np.asarray(value, dtype=np.float32)
    arr = np.ascontiguousarray(arr, dtype=np.float32).reshape(-1)
    if arr.shape[0] != dim:
        raise ValueError(f"vector has {arr.shape[0]} dims, index expects {dim}")
    if not np.all(np.isfinite(arr)):
        raise ValueError("vector contains non-finite values")
    return arr


def _round_capacity(needed: int, block: int, growth: str = "block") -> int:
    """Round a capacity up.

    growth="block": small corpora grow in 2048-row steps, large ones in
    whole blocks (flat_topk needs cap % block_rows == 0 once cap >
    block_rows). growth="pow2": doubling from 2048, as the JAX package grows
    its HNSW stores. The JAX package chose it to bound XLA recompiles; it is
    kept because the capacity sets the fused scan's span and coarse factor,
    so both packages then scan the same layout."""
    if growth == "pow2":
        cap = 2048
        while cap < needed:
            cap *= 2
        return cap
    if needed <= block:
        return max(2048, -(-needed // 2048) * 2048)
    return -(-needed // block) * block


def _scatter_rows(dst: torch.Tensor, idx: torch.Tensor,
                  rows: torch.Tensor) -> torch.Tensor:
    """A new tensor: ``dst`` with ``rows`` written at ``idx``."""
    out = dst.clone()
    out[idx] = rows
    return out


def _quantize_i8(v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Global symmetric int8: scale = max(max|v| / 127, 1e-30) in f32, rows
    rounded half to even and clipped, as in the JAX package."""
    scale = torch.clamp_min(v.abs().max() / 127.0, 1e-30)
    q = torch.clamp(torch.round(v / scale), -127, 127).to(torch.int8)
    return q, scale


class HostVectorStore:
    """Host-authoritative vector arrays + a lazily published device mirror."""

    def __init__(self, dim: int, metric: str, block: int,
                 device: Optional[torch.device] = None,
                 growth: str = "block"):
        self.dim = dim
        self.metric = metric
        self.block = block
        self.growth = growth
        self.device = torch.device(device) if device is not None \
            else get_device()
        cap = _round_capacity(1, block, growth)
        self.vectors = np.zeros((cap, dim), np.float32)
        self.norms_sq = np.zeros((cap,), np.float32)
        self.magnitudes = np.zeros((cap,), np.float32)  # cosine denormalization
        self.present = np.zeros((cap,), bool)
        self._dirty: set = set()
        self._device: Optional[Dict[str, torch.Tensor]] = None
        self._lock = threading.RLock()
        self.epoch = 0  # bumped on every publish
        self.mutations = 0  # lifetime row writes and clears (IVF drift)
        # rows written since the last IVF mirror build: the delta overlay
        # scores exactly these
        self.ivf_written_since: set = set()

    @property
    def capacity(self) -> int:
        return self.vectors.shape[0]

    def memory_bytes(self) -> int:
        return (self.vectors.nbytes + self.norms_sq.nbytes
                + self.magnitudes.nbytes + self.present.nbytes
                + 32 * len(self._dirty))

    def ensure_capacity(self, needed: int) -> None:
        with self._lock:
            if needed <= self.capacity:
                return
            grow = (_round_capacity(needed, self.block, self.growth)
                    - self.capacity)
            self.vectors = np.concatenate(
                [self.vectors, np.zeros((grow, self.dim), np.float32)])
            self.norms_sq = np.concatenate(
                [self.norms_sq, np.zeros(grow, np.float32)])
            self.magnitudes = np.concatenate(
                [self.magnitudes, np.zeros(grow, np.float32)])
            self.present = np.concatenate([self.present, np.zeros(grow, bool)])
            self._device = None  # shape changed: full upload

    def set_row(self, doc: int, vec: np.ndarray) -> None:
        """Store a vector at row ``doc`` (normalized here for cosine)."""
        with self._lock:
            self.ensure_capacity(doc + 1)
            if self.metric == "cosine":
                mag = float(np.sqrt(np.dot(vec, vec)))
                self.magnitudes[doc] = mag
                if mag > 0:
                    vec = vec / mag
            self.vectors[doc] = vec
            self.norms_sq[doc] = float(np.dot(vec, vec))
            self.present[doc] = True
            self._dirty.add(doc)
            self.mutations += 1
            self.ivf_written_since.add(doc)

    def clear_row(self, doc: int) -> None:
        with self._lock:
            if doc < self.capacity:
                self.present[doc] = False
                self.vectors[doc] = 0
                self.norms_sq[doc] = 0
                self.magnitudes[doc] = 0
                self._dirty.add(doc)
                self.mutations += 1
                self.ivf_written_since.add(doc)

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(arr).to(self.device, copy=True)

    def published(self) -> Tuple[Dict[str, torch.Tensor], int]:
        """``device_snapshot()`` and the epoch it was published at."""
        with self._lock:
            return self.device_snapshot(), self.epoch

    def device_snapshot(self) -> Dict[str, torch.Tensor]:
        """Publish the current state to the device; returns the mirror."""
        with self._lock:
            dt = str(config.get("search.corpus-dtype"))
            lp = dt == "bfloat16"
            i8 = dt == "int8"
            if self._device is None:
                snap = {
                    "vectors": self._upload(self.vectors),
                    "norms_sq": self._upload(self.norms_sq),
                    "invalid": self._upload(~self.present),
                }
                if lp:
                    snap["vectors_lp"] = snap["vectors"].to(torch.bfloat16)
                if i8:
                    snap["vectors_i8"], snap["i8_scale"] = _quantize_i8(
                        snap["vectors"])
                self._device = snap
                self._dirty.clear()
                self.epoch += 1
                STATS.incr("vector_store_full_uploads")
                return snap
            if (lp and "vectors_lp" not in self._device) or (
                    i8 and "vectors_i8" not in self._device):
                self._device = None  # corpus-dtype changed since publish
                return self.device_snapshot()
            if not self._dirty:
                return self._device
            if len(self._dirty) > max(1024, self.capacity // 5):
                self._device = None
                return self.device_snapshot()
            rows_np = np.fromiter(self._dirty, np.int64, len(self._dirty))
            old = self._device
            idx = torch.from_numpy(rows_np).to(self.device)
            vecs = self._upload(self.vectors[rows_np])
            snap = {
                "vectors": _scatter_rows(old["vectors"], idx, vecs),
                "norms_sq": _scatter_rows(
                    old["norms_sq"], idx, self._upload(self.norms_sq[rows_np])),
                "invalid": _scatter_rows(
                    old["invalid"], idx, self._upload(~self.present[rows_np])),
            }
            if "vectors_lp" in old:
                snap["vectors_lp"] = _scatter_rows(
                    old["vectors_lp"], idx, vecs.to(torch.bfloat16))
            if "vectors_i8" in old:
                scale = float(old["i8_scale"])
                new_abs = float(np.abs(self.vectors[rows_np]).max())
                if new_abs > scale * 127.0 * 1.001:
                    # rows past the published range: fresh global scale
                    self._device = None
                    return self.device_snapshot()
                rows = np.clip(
                    np.round(self.vectors[rows_np] / scale), -127, 127
                ).astype(np.int8)
                snap["vectors_i8"] = _scatter_rows(
                    old["vectors_i8"], idx, self._upload(rows))
                snap["i8_scale"] = old["i8_scale"]
            self._device = snap
            self._dirty.clear()
            self.epoch += 1
            STATS.incr("vector_store_scatter_uploads")
            return snap


def store_from_reference(
    vectors: np.ndarray,
    norms_sq: np.ndarray,
    magnitudes: np.ndarray,
    present: np.ndarray,
    *,
    metric: str,
    block: int,
    device: Optional[torch.device] = None,
    growth: str = "block",
) -> HostVectorStore:
    """A store holding the JAX package's HostVectorStore rows verbatim (its
    numpy arrays), so both packages search the same state."""
    st = HostVectorStore(vectors.shape[1], metric, block, device, growth)
    st.vectors = np.array(vectors, np.float32)
    st.norms_sq = np.array(norms_sq, np.float32)
    st.magnitudes = np.array(magnitudes, np.float32)
    st.present = np.array(present, bool)
    return st


class VectorIndexBase(IndexBase):
    """Common add/remove/modify plumbing for vector indexes."""

    mutation_weight = 10.0  # vectors dominate ingest cost

    def __init__(
        self,
        dim: int,
        metric: str = "l2",
        interner: Optional[KeyInterner] = None,
        block_size: Optional[int] = None,
        device: Optional[torch.device] = None,
        growth: str = "block",
    ):
        if metric not in ("l2", "ip", "cosine"):
            raise ValueError(f"bad metric {metric!r}")
        self.dim = dim
        self.metric = metric
        # with a schema-shared interner the schema owns doc-id lifetime
        self._owns_interner = interner is None
        self.interner = interner if interner is not None else KeyInterner()
        block = block_size or config.get("search.flat-block-size")
        self.store = HostVectorStore(dim, metric, block, device, growth)
        self._tracked: Dict[str, int] = {}
        self._lock = threading.RLock()
        self._ivf = None  # drift-throttled IVF mirror (ops/ivf.py)
        self._ivf_epoch = -1
        self._ivf_muts = -1  # store.mutations at build time
        self._ivf_building = threading.Lock()
        # seconds of the last mirror build: build_s, and by stage
        # (build_ivf_device's timings) when it read the device mirror
        self.ivf_build_seconds: Dict[str, float] = {}

    def memory_bytes(self) -> int:
        return self.store.memory_bytes() + 72 * len(self._tracked)

    # -- IVF mirror (large-corpus sub-linear path) --------------------------
    def ivf_mirror(self):
        """The IVF index over the present rows, or None below
        search.ivf-threshold (0 disables).

        A build is k-means, reorder and quantize over the whole corpus, so
        it neither runs per publish nor holds the index lock. The mirror
        rebuilds only once the mutations since the last build pass
        max(16384, n // 20); in between the stale mirror serves, with
        deletions masked by the caller's ~invalid and the rows written since
        the build (``ivf_delta_ids``) scored exactly beside it. One thread
        builds at a time; concurrent searches keep the stale mirror (the
        first build blocks them until it lands), and a thread that takes
        the builder's turn after a build landed serves that build (the JAX
        package's check-then-acquire could build twice). The build reads the
        published device mirror when it is current (``build_ivf_device``),
        the host rows otherwise (``build_ivf``)."""
        thresh = int(config.get("search.ivf-threshold"))
        n = self.count()
        if thresh == 0 or n < thresh:
            return None
        with self._lock:
            current = self._ivf_current(n)
        if current is not None:
            return current
        if not self._ivf_building.acquire(blocking=False):
            if self._ivf is not None:
                return self._ivf
            with self._ivf_building:
                return self._ivf
        try:
            with self._lock:
                current = self._ivf_current(n)
                if current is not None:
                    return current
                st = self.store
                docs = np.nonzero(st.present)[0]
                epoch = st.epoch
                muts = st.mutations
                dev = st._device
                dev_fresh = (dev is not None and "vectors" in dev
                             and not st._dirty)
                if dev_fresh:
                    present = st.present.copy()
                else:
                    vecs = st.vectors[docs].copy()
                # the new mirror holds every row up to this copy; writes
                # during the unlocked build enter the delta set again
                st.ivf_written_since = set()
            block_rows = int(config.get("search.ivf-block-rows"))
            n_clusters = int(config.get("search.ivf-clusters"))
            timings: Dict[str, float] = {}
            t0 = time.perf_counter()
            if dev_fresh:
                new = ivf_ops.build_ivf_device(
                    dev["vectors"], present=present, block_rows=block_rows,
                    n_clusters=n_clusters, timings=timings)
            else:
                new = ivf_ops.build_ivf(
                    vecs, docs.astype(np.int64), block_rows=block_rows,
                    n_clusters=n_clusters, device=st.device)
            timings["build_s"] = time.perf_counter() - t0
            with self._lock:
                self._ivf = new
                self._ivf_epoch = epoch
                self._ivf_muts = muts
                self.ivf_build_seconds = timings
            STATS.incr("ivf_mirror_builds")
            return new
        finally:
            self._ivf_building.release()

    def _ivf_current(self, n: int):
        """The mirror when it may serve: built at the store's epoch (settled
        by a publish), or within the drift bound of its mutations; else
        None. The caller holds ``self._lock``."""
        self.store.device_snapshot()  # settle the epoch
        if self._ivf is None:
            return None
        if self._ivf_epoch == self.store.epoch:
            return self._ivf
        if self.store.mutations - self._ivf_muts <= max(16384, n // 20):
            return self._ivf
        return None

    def ivf_delta_ids(self) -> np.ndarray:
        """Rows written since the last mirror build (int64). The JAX package
        pads them to a power of two, for its compiled shapes; the port does
        not."""
        with self.store._lock:
            return np.fromiter(self.store.ivf_written_since, np.int64,
                               len(self.store.ivf_written_since))

    def _ivf_search(self, mirror, q: torch.Tensor, k: int,
                    corpus: torch.Tensor, invalid: torch.Tensor,
                    ef: Optional[int] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """An unfiltered search over the IVF mirror: the mirror serves every
        row outside ``invalid`` and the delta set, rescored in fp32 against
        ``corpus`` (the current snapshot's rows); the delta rows are scored
        exactly and merged in. Cosine runs as "ip" over the normalized rows.
        The probe is search.ivf-probe, or ``default_probe`` when that is 0;
        HNSW's EF_RUNTIME ``ef``, a candidate count, raises it to
        ceil(ef / block_rows). Returns (dists, store rows) on the device."""
        probe = (int(config.get("search.ivf-probe"))
                 or ivf_ops.default_probe(mirror))
        if ef:
            probe = max(probe, -(-int(ef) // mirror.block_rows))
        metric = "ip" if self.metric == "cosine" else self.metric
        delta = self.ivf_delta_ids()
        delta = delta[delta < corpus.shape[0]]
        mask = ~invalid
        if len(delta):
            delta_t = torch.from_numpy(delta).to(corpus.device)
            mask = mask.clone()
            mask[delta_t] = False
        d, i = ivf_ops.ivf_search_rescored(mirror, q, corpus, k=k,
                                           probe=probe, metric=metric,
                                           filter_mask=mask)
        if len(delta):
            d, i = ivf_ops.delta_overlay_merge(q, corpus, delta_t, invalid,
                                               d, i, k=k, metric=metric)
        return d, i

    # -- IndexBase ----------------------------------------------------------
    def add_record(self, key: str, value: VectorLike) -> RecordResult:
        try:
            vec = parse_vector(value, self.dim)
        except ValueError:
            STATS.incr("vector_invalid_records")
            return RecordResult.INVALID_DATA
        with self._lock:
            existed = key in self._tracked
            doc = self.interner.intern(key)
            self._tracked[key] = doc
            self.store.set_row(doc, vec)
            STATS.incr("vector_records_modified" if existed
                       else "vector_records_added")
            return RecordResult.MODIFIED if existed else RecordResult.ADDED

    def modify_record(self, key: str, value: VectorLike) -> RecordResult:
        return self.add_record(key, value)

    def remove_record(self, key: str) -> RecordResult:
        with self._lock:
            doc = self._tracked.pop(key, None)
            if doc is None:
                return RecordResult.SKIPPED
            self.store.clear_row(doc)
            if self._owns_interner:
                self.interner.release(key)
            STATS.incr("vector_records_removed")
            return RecordResult.REMOVED

    def tracked_keys(self):
        with self._lock:
            return set(self._tracked)

    def tracks(self, key: str) -> bool:
        with self._lock:
            return key in self._tracked

    def count(self) -> int:
        with self._lock:
            return len(self._tracked)

    def doc_of(self, key: str) -> Optional[int]:
        with self._lock:
            return self._tracked.get(key)

    def bulk_load(self, keys: Sequence[str], vectors: np.ndarray) -> int:
        """Batch ingest: the whole batch lands with numpy writes and one
        full upload at the next publish."""
        vectors = np.ascontiguousarray(vectors, np.float32)
        if vectors.shape[1] != self.dim:
            raise ValueError("bulk_load dim mismatch")
        with self._lock:
            doc_list = self.interner.intern_many(keys)
            docs = np.asarray(doc_list, np.int64)
            self.store.ensure_capacity(int(docs.max()) + 1)
            st = self.store
            vecs = vectors
            if self.metric == "cosine":
                mags = np.linalg.norm(vectors, axis=1)
                st.magnitudes[docs] = mags
                vecs = vectors / np.maximum(mags, 1e-30)[:, None]
            st.vectors[docs] = vecs
            # einsum: no [n, d] squared temporary
            st.norms_sq[docs] = np.einsum("ij,ij->i", vecs, vecs)
            st.present[docs] = True
            st.mutations += len(docs)
            st.ivf_written_since.update(doc_list)
            st._device = None  # full upload at the next publish
            self._tracked.update(zip(keys, doc_list))
            STATS.incr("vector_records_added", len(keys))
            return len(keys)

    def neighbors_to_keys(
        self, dists: np.ndarray, ids: np.ndarray
    ) -> List[Tuple[str, float]]:
        """One query's (dists [k], doc ids [k]) -> [(key, distance)],
        dropping pads."""
        out: List[Tuple[str, float]] = []
        for d, i in zip(np.asarray(dists), np.asarray(ids)):
            if i < 0 or not np.isfinite(d):
                continue
            key = self.interner.key_of(int(i))
            if key is not None:
                out.append((key, float(d)))
        return out
