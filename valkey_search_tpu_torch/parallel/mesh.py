"""Sharded search programs over a mesh of torch devices, with a top-k merge.

Counterpart of valkey_search_tpu/parallel/mesh.py. A cluster shard is one
range of the corpus on one mesh position; the per-shard RPC (reference
SearchIndexPartition, src/coordinator/coordinator.proto:21-31) is a local
top-k on the shard's device; the coordinator's k-bounded merge heap
(src/query/fanout.cc:69-222) is a gather of the [B, k] rows of every shard
and one k-selection. Each shard carries a version scalar and a program
returns their (min, max): min != max is the reference's FAILED_PRECONDITION
(server.h:60-65), and the caller retries on a fresh snapshot.

The JAX package runs each program as one ``shard_map``: a single controller
drives every device. The port keeps the single controller:

- ``Mesh`` is a numpy object array of ``torch.device``s with named axes,
  and ``mesh.shape[SHARD_AXIS]`` reads as in the JAX package;
- a program splits each global tensor into S ranges, one a shard; a range
  already on its shard's device is a view, not a copy;
- each shard runs the JAX package's local function on its device; the
  launches are asynchronous and the bodies read nothing back to the host,
  so the shards of a multi-card mesh overlap;
- the collectives are plain operations on the first device: ``all_gather``
  is ``.to(dev0)`` and ``stack``, ``psum`` / ``pmin`` / ``pmax`` are a sum,
  ``min`` and ``max``.

``make_mesh`` and ``make_mesh_2d`` without ``devices`` cycle the visible
devices, so one card holds a mesh of four shards, which then run one after
another (the JAX package takes the first n devices and makes a smaller
mesh). ``torch.distributed`` is not used: NCCL refuses two ranks on one
GPU, gloo has no ``all_gather`` for CUDA tensors, and processes on one
host are the cluster layer's (cluster/transport.py).

Every merge breaks ties to the lower shard, then the lower position
(``topk_smallest``, the order of ``lax.top_k``), so merged ids equal the
JAX package's wherever distances are equal. Every product is fp32 with TF32
off (ops/distance.py), so the JAX package's ``precision`` argument has no
counterpart here.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from valkey_search_tpu_torch.ops import hnsw_search as hs_ops
from valkey_search_tpu_torch.ops import ivf as ivf_ops
from valkey_search_tpu_torch.ops import topk as topk_ops
from valkey_search_tpu_torch.ops.topk import topk_smallest
from valkey_search_tpu_torch.runtime.device import get_device

SHARD_AXIS = "shard"
REPLICA_AXIS = "replica"


class Mesh:
    """Devices shaped per axis: ``devices`` is a numpy object array of
    ``torch.device``s, one dimension an axis of ``axis_names``; ``shape``
    maps each axis name to its size."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        if devices.ndim != len(axis_names):
            raise ValueError(
                f"{devices.ndim}-d devices for axes {tuple(axis_names)}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, devices.shape))


def _device(d) -> torch.device:
    dev = torch.device(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def visible_devices(device=None) -> List[torch.device]:
    """The devices a mesh cycles: every card for ``None`` on a card (the
    default device's type) or for ``"cuda"``; ``[device]`` otherwise. The
    default raises without a card (``runtime.device``)."""
    dev = torch.device(device) if device is not None else get_device()
    if dev.type == "cuda" and (device is None or dev.index is None):
        if not torch.cuda.is_available():
            raise RuntimeError("a CUDA mesh was asked for without a card")
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [_device(dev)]


def cycle_devices(devices: Sequence, n: int) -> List[torch.device]:
    """``n`` devices, round-robin over ``devices``."""
    devices = [_device(d) for d in devices]
    return [devices[i % len(devices)] for i in range(n)]


def _device_array(devices: List[torch.device], shape) -> np.ndarray:
    arr = np.empty(len(devices), dtype=object)
    for i, d in enumerate(devices):
        arr[i] = d
    return arr.reshape(shape)


def make_mesh(n_devices: Optional[int] = None, devices=None) -> Mesh:
    """A 1-D mesh on ``SHARD_AXIS``. Without ``devices``, ``n_devices``
    positions cycle the visible devices (all of them when ``n_devices`` is
    None); an explicit ``devices`` list shorter than ``n_devices`` raises."""
    if devices is None:
        devices = visible_devices()
        if n_devices is not None:
            devices = cycle_devices(devices, n_devices)
    else:
        devices = [_device(d) for d in devices]
        if n_devices is not None:
            if len(devices) < n_devices:
                raise ValueError(
                    f"need {n_devices} devices, have {len(devices)}")
            devices = devices[:n_devices]
    return Mesh(_device_array(devices, (len(devices),)), (SHARD_AXIS,))


def make_mesh_2d(n_shards: int, n_replicas: int, devices=None) -> Mesh:
    """(shard x replica) mesh: the corpus split over ``SHARD_AXIS``, the
    query batch over ``REPLICA_AXIS`` (reference P7 replica read scaling,
    cluster_map.h FanoutTargetMode). Without ``devices`` the positions
    cycle the visible devices."""
    need = n_shards * n_replicas
    if devices is None:
        devices = cycle_devices(visible_devices(), need)
    devices = [_device(d) for d in devices]
    if len(devices) < need:
        raise ValueError(f"need {need} devices, have {len(devices)}")
    return Mesh(_device_array(devices[:need], (n_shards, n_replicas)),
                (SHARD_AXIS, REPLICA_AXIS))


def shard_devices(mesh: Mesh) -> List[torch.device]:
    """The device of each shard of a 1-D mesh, in shard order."""
    if mesh.axis_names != (SHARD_AXIS,):
        raise ValueError(f"a 1-D {SHARD_AXIS!r} mesh, not {mesh.axis_names}")
    return list(mesh.devices.flat)


def _split(t: torch.Tensor, devices: List[torch.device],
           dim: int = 0) -> List[torch.Tensor]:
    """``t`` cut into len(devices) equal ranges along ``dim``, each on its
    shard's device (a view where it already lies there)."""
    n = len(devices)
    if t.shape[dim] % n:
        raise ValueError(f"dim {dim} of size {t.shape[dim]} does not divide "
                         f"over {n} shards")
    size = t.shape[dim] // n
    return [t.narrow(dim, s * size, size).to(dev)
            for s, dev in enumerate(devices)]


def _gather(parts: Sequence[torch.Tensor], dev: torch.device) -> torch.Tensor:
    """all_gather: the shards' tensors stacked on ``dev``, [S, ...]."""
    return torch.stack([p.to(dev) for p in parts])


def _psum(parts: Sequence[torch.Tensor], dev: torch.device) -> torch.Tensor:
    """psum: the shards' tensors summed on ``dev``, in shard order."""
    out = parts[0].to(dev)
    for p in parts[1:]:
        out = out + p.to(dev)
    return out


def _merge_gathered(all_d: torch.Tensor, all_i: torch.Tensor,
                    k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """[S, B, k] per-shard results -> [B, k] global best (the fanout merge
    heap), shard-major: ties go to the lower shard."""
    s, b, kk = all_d.shape
    flat_d = all_d.transpose(0, 1).reshape(b, s * kk)
    flat_i = all_i.transpose(0, 1).reshape(b, s * kk)
    top, pos = topk_smallest(flat_d, k)
    return top, flat_i.gather(-1, pos)


def _version_minmax(shard_versions: Optional[torch.Tensor],
                    dev: torch.device) -> torch.Tensor:
    if shard_versions is None:
        return torch.zeros(2, dtype=torch.int32, device=dev)
    v = torch.as_tensor(shard_versions).to(dev)
    return torch.stack([v.min(), v.max()]).to(torch.int32)


def _global_ids(ids: torch.Tensor, offset: int) -> torch.Tensor:
    return torch.where(ids >= 0, ids + offset, -1)


def sharded_flat_topk(
    mesh: Mesh,
    corpus: torch.Tensor,          # [S * rows, d], rows split over shards
    queries: torch.Tensor,         # [B, d], every shard sees them all
    k: int,
    metric: str = "l2",
    invalid: Optional[torch.Tensor] = None,      # [S * rows] bool
    filter_mask: Optional[torch.Tensor] = None,  # [S * rows] bool
    shard_versions: Optional[torch.Tensor] = None,  # [S] int32
    block_rows: int = 131072,
    mode: str = "exact",
    two_stage: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Exact k-NN over a sharded corpus -> (dists [B, k], global ids [B, k],
    version (min, max) [2] int32), all on the first shard's device.

    Each shard scans its own rows (``flat_topk``; ``block_rows`` capped at
    the shard's rows), its ids offset by ``shard * rows`` (-1 kept), then
    one merge. ``two_stage`` casts each shard to bf16 on its device and runs
    ``flat_topk_two_stage`` there, so only exactly rescored rows are
    merged."""
    devs = shard_devices(mesh)
    n = len(devs)
    rows = corpus.shape[0] // n
    parts = _split(corpus, devs)
    invs = _split(invalid, devs) if invalid is not None else [None] * n
    filts = _split(filter_mask, devs) if filter_mask is not None else [None] * n
    ds, gids = [], []
    for s, dev in enumerate(devs):
        q = queries.to(dev)
        if two_stage:
            d, i = topk_ops.flat_topk_two_stage(
                q, parts[s], parts[s].to(torch.bfloat16), k=k, metric=metric,
                invalid=invs[s], filter_mask=filts[s],
                block_rows=min(block_rows, rows),
            )
        else:
            d, i = topk_ops.flat_topk(
                q, parts[s], k=k, metric=metric, invalid=invs[s],
                filter_mask=filts[s], block_rows=min(block_rows, rows),
                mode=mode,
            )
        ds.append(d)
        gids.append(_global_ids(i, s * rows))
    dev0 = devs[0]
    md, mi = _merge_gathered(_gather(ds, dev0), _gather(gids, dev0), k)
    return md, mi, _version_minmax(shard_versions, dev0)


def sharded_hnsw_search(
    mesh: Mesh,
    graphs: Sequence[hs_ops.HnswDeviceGraph],  # one a shard, equal shapes
    queries: torch.Tensor,                     # [B, d]
    k: int,
    ef: int,
    metric: str = "l2",
    filter_masks=None,   # per shard a bool [doc_cap] (a [S, cap] tensor or a list)
    shard_versions: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """ANN over per-shard HNSW graphs: each shard walks its own graph on its
    device (``hnsw_search_batch``), then one merge. ``graphs`` hold equal
    node capacities (``fanout._normalize_graphs``); a result id is
    ``shard * node_cap + node``. Returns (dists, ids, version (min, max)).

    The walk reads its ``done`` flags back every few iterations
    (``hnsw_search.CHECK_EVERY``), so these shards run one after another
    even on several cards."""
    devs = shard_devices(mesh)
    n = len(devs)
    if len(graphs) != n:
        raise ValueError(f"{len(graphs)} graphs for {n} shards")
    node_cap = graphs[0].vectors.shape[0]
    ds, gids = [], []
    for s, dev in enumerate(devs):
        fm = None if filter_masks is None else torch.as_tensor(
            filter_masks[s]).to(dev)
        d, nodes = hs_ops.hnsw_search_batch(
            graphs[s], queries.to(dev), k=k, ef=ef, metric=metric,
            filter_mask=fm,
        )
        ds.append(d)
        gids.append(_global_ids(nodes, s * node_cap))
    dev0 = devs[0]
    md, mi = _merge_gathered(_gather(ds, dev0), _gather(gids, dev0), k)
    return md, mi, _version_minmax(shard_versions, dev0)


def replicated_sharded_flat_topk(
    mesh: Mesh,
    corpus: torch.Tensor,     # [S * rows, d] split over SHARD_AXIS
    queries: torch.Tensor,    # [R * b, d] split over REPLICA_AXIS
    k: int,
    metric: str = "l2",
    mode: str = "exact",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """2-D mesh search: the corpus split over ``SHARD_AXIS``, the query
    batch over ``REPLICA_AXIS``. Position (s, r) scans shard s for
    sub-batch r; each replica merges over its own shards, so replica groups
    serve disjoint queries (reference P7). Returns [R * b, k] (dists, ids)
    on the mesh's first device."""
    n_s, n_r = mesh.shape[SHARD_AXIS], mesh.shape[REPLICA_AXIS]
    if corpus.shape[0] % n_s or queries.shape[0] % n_r:
        raise ValueError("corpus rows must divide over the shards and "
                         "queries over the replicas")
    rows = corpus.shape[0] // n_s
    b = queries.shape[0] // n_r
    out_d, out_i = [], []
    for r in range(n_r):
        q_r = queries[r * b:(r + 1) * b]
        ds, gids = [], []
        for s in range(n_s):
            dev = mesh.devices[s, r]
            d, i = topk_ops.flat_topk(
                q_r.to(dev), corpus[s * rows:(s + 1) * rows].to(dev), k=k,
                metric=metric, block_rows=rows, mode=mode,
            )
            ds.append(d)
            gids.append(_global_ids(i, s * rows))
        head = mesh.devices[0, r]
        md, mi = _merge_gathered(_gather(ds, head), _gather(gids, head), k)
        out_d.append(md)
        out_i.append(mi)
    dev0 = mesh.devices[0, 0]
    return _gather(out_d, dev0).reshape(-1, k), _gather(out_i, dev0).reshape(
        -1, k)


def sharded_batch_update(
    mesh: Mesh,
    corpus: torch.Tensor,     # [S * rows, d]
    row_ids,                  # [U] global row ids
    new_vecs: torch.Tensor,   # [U, d]
) -> torch.Tensor:
    """Sharded scatter-update of corpus rows (the distributed ingest step:
    each shard applies the updates that land in its rows, the reference's
    per-shard writer pools, P2). Functional, as in the JAX package: the
    caller's ``corpus`` is unchanged, and the updated corpus comes back on
    its device. Each shard copies its rows and ``index_copy_``s the
    in-range updates; the ids are read on the host once, before the shards
    run."""
    devs = shard_devices(mesh)
    rows = corpus.shape[0] // len(devs)
    if corpus.shape[0] % len(devs):
        raise ValueError("corpus rows must divide over the shards")
    ids = torch.as_tensor(row_ids).to("cpu", torch.int64)
    out = []
    for s, dev in enumerate(devs):
        local_ids = ids - s * rows
        sel = torch.nonzero((local_ids >= 0) & (local_ids < rows)).reshape(-1)
        local = corpus[s * rows:(s + 1) * rows].to(dev, copy=True)
        local.index_copy_(
            0, local_ids[sel].to(dev),
            new_vecs[sel.to(new_vecs.device)].to(dev, local.dtype))
        out.append(local)
    return torch.cat([o.to(corpus.device) for o in out])


class MeshConsistencyError(RuntimeError):
    """Shard versions disagreed on every attempt (the coordinator giving
    up on FAILED_PRECONDITION retries)."""


def consistent_sharded_topk(
    mesh: Mesh,
    snapshot_fn: Callable,
    queries: torch.Tensor,
    k: int,
    metric: str = "l2",
    max_retries: int = 3,
    partial_ok: bool = False,
    dead_shards=None,
):
    """Sharded exact top-k under the coordinator's consistency protocol.

    ``snapshot_fn() -> (corpus, shard_versions, invalid_or_None)`` gives a
    (possibly refreshed) snapshot per attempt. A version spread (min !=
    max) is the reference's per-RPC fingerprint check failing
    (server.h:60-65) and retries on a fresh snapshot, as the coordinator
    does (fanout.cc).

    ``dead_shards``: shards considered failed. Their rows are masked out and
    they do not vote on the versions; with ``partial_ok`` the reply is
    (dists, ids, partial=True), the reference's partial-results policy
    (fanout.cc:177-221), else MeshConsistencyError, the first-error
    policy."""
    n_shards = mesh.shape[SHARD_AXIS]
    dead = sorted(set(int(s) for s in (dead_shards or ())))
    if dead and not partial_ok:
        raise MeshConsistencyError(
            f"shards {dead} unavailable and partial results disabled"
        )
    last = None
    for _attempt in range(max_retries):
        corpus, versions, invalid = snapshot_fn()
        rows = corpus.shape[0] // n_shards
        versions = torch.as_tensor(versions)
        if dead:
            inv = (torch.as_tensor(invalid, dtype=torch.bool).to(
                corpus.device, copy=True)
                if invalid is not None
                else torch.zeros(corpus.shape[0], dtype=torch.bool,
                                 device=corpus.device))
            for s in dead:
                inv[s * rows:(s + 1) * rows] = True
            invalid = inv
            # a dead shard can't vote on the version check either
            is_dead = torch.isin(
                torch.arange(n_shards, device=versions.device),
                torch.tensor(dead, device=versions.device))
            vmax = versions.max().clamp_min(0) if versions.numel() else 0
            versions = torch.where(is_dead, vmax, versions).to(torch.int32)
        d, i, vmm = sharded_flat_topk(
            mesh, corpus, queries, k=k, metric=metric,
            invalid=invalid, shard_versions=versions,
        )
        vmm = vmm.cpu()
        if int(vmm[0]) == int(vmm[1]):
            return d, i, bool(dead)
        last = (int(vmm[0]), int(vmm[1]))
    raise MeshConsistencyError(
        f"shard versions did not converge after {max_retries} attempts "
        f"(min/max {last})"
    )


def dim_sharded_flat_topk(
    mesh: Mesh,
    corpus: torch.Tensor,     # [N, D], D split over shards
    queries: torch.Tensor,    # [B, D], split the same way
    k: int,
    metric: str = "l2",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Tensor-parallel exact k-NN: the dimension axis is split over the
    shards (SURVEY §5.7, for rows too wide for one device). Each shard
    computes partial dots and squared norms over its columns; they are
    summed on the first device and one exact top-k runs there. Returns
    (dists [B, k], ids [B, k] int32)."""
    devs = shard_devices(mesh)
    cs = _split(corpus, devs, dim=1)
    qs = _split(queries, devs, dim=1)
    dots, c_sq, q_sq = [], [], []
    for c, q in zip(cs, qs):
        c = c.to(torch.float32)
        q = q.to(torch.float32)
        dots.append(q @ c.T)
        if metric == "l2":
            c_sq.append((c * c).sum(1))
            q_sq.append((q * q).sum(1))
    dev0 = devs[0]
    dots = _psum(dots, dev0)
    if metric == "l2":
        scores = (_psum(q_sq, dev0)[:, None] + _psum(c_sq, dev0)[None, :]
                  - 2.0 * dots)
    else:  # ip / cosine (pre-normalized rows)
        scores = 1.0 - dots
    d, ids = topk_smallest(scores, k)
    return d, ids.to(torch.int32)


def shard_index(index: ivf_ops.IvfIndex,
                devices: List[torch.device]) -> List[ivf_ops.IvfIndex]:
    """An IvfIndex cut on its block axis into one index a shard, each on its
    shard's device (views where the index already lies there); nb must
    divide the mesh."""
    fields = [_split(t, devices) for t in index]
    return [ivf_ops.IvfIndex(*(f[s] for f in fields))
            for s in range(len(devices))]


def local_ivf_topk(index_l: ivf_ops.IvfIndex, queries: torch.Tensor, k: int,
                   probe: int, metric: str, probe_chunk: int):
    """One shard's part of ``sharded_ivf_topk``: its blocks' block_ids are
    global row ids, so no offset."""
    return ivf_ops.ivf_search_batch(
        index_l, queries.to(index_l.blocks_i8.device), k=k, probe=probe,
        metric=metric, probe_chunk=probe_chunk,
    )


def sharded_ivf_topk(
    mesh: Mesh,
    index: ivf_ops.IvfIndex,  # every field split over the shards on nb
    queries: torch.Tensor,    # [B, d]
    k: int,
    probe: int = 32,
    metric: str = "l2",
    probe_chunk: int = 8,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """IVF k-NN over a block index split over the shards (the scaling path
    past one device's memory, reference README.md:5): each shard probes its
    own best ``probe`` blocks, then one merge.

    Each shard probes the FULL probe (blocks are cluster-major, so a query's
    best cells concentrate in few shards; probing ``probe`` a shard keeps
    recall >= the single-device index's at the same setting). block_ids
    hold global row ids (build once, then shard); nb must divide the
    mesh."""
    devs = shard_devices(mesh)
    parts = [local_ivf_topk(idx_l, queries, k, probe, metric, probe_chunk)
             for idx_l in shard_index(index, devs)]
    dev0 = devs[0]
    return _merge_gathered(_gather([p[0] for p in parts], dev0),
                           _gather([p[1] for p in parts], dev0), k)


def rows_in_slot_order(corpus, block_ids) -> np.ndarray:
    """[nb, S, d] fp32 rows in the IVF index's slot order (the per-shard
    rescore mirror of sharded_ivf_topk_rescored): slot (b, s) holds the
    fp32 row of block_ids[b, s], zeros at -1 padding. Split on nb, every
    shard's fp32 rows lie beside its own blocks. Host numpy."""
    ids = _host(block_ids)
    nb, s = ids.shape
    out = np.asarray(_host(corpus), np.float32)[np.maximum(ids, 0).reshape(-1)]
    out[ids.reshape(-1) < 0] = 0.0
    return out.reshape(nb, s, corpus.shape[1])


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


def local_ivf_topk_rescored(index_l: ivf_ops.IvfIndex,
                            corpus_l: torch.Tensor, queries: torch.Tensor,
                            k: int, kc: int, probe: int, metric: str,
                            probe_chunk: int):
    """One shard's part of ``sharded_ivf_topk_rescored``: the coarse pass
    over a view of its blocks whose ids are slot numbers, the exact fp32
    rescore of those slots from ``corpus_l`` [nb_l, S, d], then the real
    ids re-attached."""
    dev = index_l.blocks_i8.device
    nb_l, s_rows = index_l.n_blocks, index_l.block_rows
    q = queries.to(dev, torch.float32)
    slot_ids = torch.where(
        index_l.block_ids >= 0,
        torch.arange(nb_l * s_rows, dtype=torch.int32,
                     device=dev).reshape(nb_l, s_rows),
        -1,
    )
    cd, cs = ivf_ops.ivf_search_batch(
        index_l._replace(block_ids=slot_ids), q, k=kc, probe=probe,
        metric=metric, probe_chunk=probe_chunk,
    )
    flat = corpus_l.reshape(nb_l * s_rows, corpus_l.shape[-1])
    d2, s2 = topk_ops._rescore_exact(q, flat, cs, cd, k=k, metric=metric)
    ids2 = torch.where(
        s2 >= 0, index_l.block_ids.reshape(-1)[s2.clamp_min(0).long()], -1)
    return d2, ids2


def sharded_ivf_topk_rescored(
    mesh: Mesh,
    index: ivf_ops.IvfIndex,     # every field split over the shards on nb
    corpus_slots: torch.Tensor,  # [nb, S, d] fp32 in slot order, split on nb
    queries: torch.Tensor,       # [B, d]
    k: int,
    probe: int = 32,
    metric: str = "l2",
    coarse_factor: int = 4,
    probe_chunk: int = 8,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """sharded_ivf_topk + each shard's EXACT fp32 rescore (the >= 0.99
    recall tier past one device): both the int8 blocks and the fp32 rows
    (``rows_in_slot_order``) are split over the shards; each shard rescores
    its own coarse candidates from its own rows (a row lives in exactly one
    block), then one merge of exact scores. Same contract as the
    single-device ivf_search_rescored."""
    devs = shard_devices(mesh)
    n = len(devs)
    kc = min(coarse_factor * k,
             index.block_rows * min(probe, index.n_blocks // n))
    parts = [
        local_ivf_topk_rescored(idx_l, corpus_l, queries, k, kc, probe,
                                metric, probe_chunk)
        for idx_l, corpus_l in zip(shard_index(index, devs),
                                   _split(corpus_slots, devs))
    ]
    dev0 = devs[0]
    return _merge_gathered(_gather([p[0] for p in parts], dev0),
                           _gather([p[1] for p in parts], dev0), k)
