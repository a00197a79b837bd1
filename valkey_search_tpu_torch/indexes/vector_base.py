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
or ``vectors_i8`` int8 with its f32 scalar ``i8_scale`` under ``int8``. The
IVF mirror of the JAX package is not ported yet.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from valkey_search_tpu_torch.runtime import config
from valkey_search_tpu_torch.runtime.metrics import STATS
from valkey_search_tpu_torch.utils.interning import KeyInterner
from valkey_search_tpu_torch.indexes.base import IndexBase, RecordResult
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

    def clear_row(self, doc: int) -> None:
        with self._lock:
            if doc < self.capacity:
                self.present[doc] = False
                self.vectors[doc] = 0
                self.norms_sq[doc] = 0
                self.magnitudes[doc] = 0
                self._dirty.add(doc)

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(arr).to(self.device, copy=True)

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

    def memory_bytes(self) -> int:
        return self.store.memory_bytes() + 72 * len(self._tracked)

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
