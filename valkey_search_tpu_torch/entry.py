"""Entry points: one batched HNSW search step, and one step of every sharded path.

Counterpart of __graft_entry__.py at the repository root.

``entry()`` returns the engine's hot path, a batched HNSW walk over a
device-resident graph, with its arguments. ``dryrun_multichip(n)`` runs one
step of every sharded path on an n-shard mesh: the sharded ingest (a
scatter-update of corpus rows), exact and two-stage sharded search with the
shard-version check, a version retry and a dead shard's partial result, the
sharded HNSW index, the dimension-sharded search, both sharded IVF programs,
and the (shard x replica) mesh when n >= 4.

Both run on the card unless the caller passes a CPU device
(``device="cpu"``); the default raises without a card. A CPU mesh is n CPU
positions; on a card the positions cycle the visible cards.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def _small_graph_and_queries(n=2048, d=64, m=8, b=16, seed=7, device=None):
    from valkey_search_tpu_torch.indexes.hnsw import HnswVectorIndex

    rng = np.random.default_rng(seed)
    corpus = rng.standard_normal((n, d)).astype(np.float32)
    idx = HnswVectorIndex(dim=d, m=m, ef_construction=60, seed=seed,
                          device=device)
    for i, v in enumerate(corpus):
        idx.add_record(f"k{i}", v)
    graph = idx.device_graph()
    queries = rng.standard_normal((b, d)).astype(np.float32)
    return graph, queries


def entry(device=None):
    """Returns (fn, example_args): the batched HNSW search step (k 10, ef
    32, l2) over a 2,048 x 64 graph (M 8) on ``device``."""
    from valkey_search_tpu_torch.ops.hnsw_search import hnsw_search_batch
    from valkey_search_tpu_torch.runtime.device import get_device

    dev = torch.device(device) if device is not None else get_device()
    graph, queries = _small_graph_and_queries(device=dev)

    def fn(graph, queries):
        return hnsw_search_batch(graph, queries, k=10, ef=32, metric="l2")

    return fn, (graph, torch.from_numpy(queries).to(dev))


def dryrun_multichip(n_devices: int, device: Optional[str] = None) -> None:
    """One step of every sharded path on an ``n_devices``-shard mesh over
    ``device`` (default: the visible cards); raises on a wrong result."""
    from valkey_search_tpu_torch.ops import ivf as ivf_ops
    from valkey_search_tpu_torch.parallel import mesh as pm
    from valkey_search_tpu_torch.parallel.fanout import ShardedHnswIndex

    devices = pm.cycle_devices(pm.visible_devices(device), n_devices)
    mesh = pm.make_mesh(n_devices, devices=devices)
    dev0 = devices[0]
    rng = np.random.default_rng(0)
    d = 32
    rows = 128  # tiny per-shard corpus
    corpus = rng.standard_normal((n_devices * rows, d)).astype(np.float32)
    queries = rng.standard_normal((4, d)).astype(np.float32)
    corpus_t = torch.from_numpy(corpus).to(dev0)
    q = torch.from_numpy(queries).to(dev0)

    # 1. distributed ingest step: scatter rows into their owning shards
    upd_ids = torch.tensor([1, rows + 2], dtype=torch.int32)
    new_vecs = torch.from_numpy(
        rng.standard_normal((2, d)).astype(np.float32)).to(dev0)
    before = corpus_t.clone()
    corpus_dev = pm.sharded_batch_update(mesh, corpus_t, upd_ids, new_vecs)
    assert torch.equal(corpus_dev[rows + 2], new_vecs[1])
    assert torch.equal(corpus_t, before), "the update wrote into its input"

    # 2. sharded exact search: a local top-k a shard, one merge, the
    #    shard-version (min, max)
    versions = torch.zeros(n_devices, dtype=torch.int32)
    dists, ids, vminmax = pm.sharded_flat_topk(
        mesh, corpus_dev, q, k=5, shard_versions=versions,
    )
    assert dists.shape == (4, 5) and ids.shape == (4, 5)
    vmm = vminmax.cpu().numpy()
    assert vmm[0] == vmm[1], "version check must agree on a clean snapshot"

    # 2b. two-stage sharded retrieval: each shard's bf16 coarse pass and
    #     fp32 rescore, only rescored rows merged
    d2s, _i2s, _ = pm.sharded_flat_topk(
        mesh, corpus_dev, q, k=5, shard_versions=versions, two_stage=True,
    )
    assert d2s.shape == (4, 5)

    # 2c. consistency protocol: a version-mismatch retry, and a dead
    #     shard's partial result (reference FAILED_PRECONDITION retry,
    #     server.h:60-65; partial policy fanout.cc:177-221)
    calls = {"n": 0}

    def snapshot():
        calls["n"] += 1
        v = np.full(n_devices, 4, np.int32)
        if calls["n"] == 1:
            v[-1] = 3  # one stale shard on the first attempt
        return corpus_dev, torch.from_numpy(v), None

    _d, _i, partial = pm.consistent_sharded_topk(mesh, snapshot, q, k=5)
    assert calls["n"] == 2 and not partial
    _dp, ip, partial = pm.consistent_sharded_topk(
        mesh, snapshot, q, k=5, partial_ok=True, dead_shards=[0],
    )
    assert partial and bool((ip >= rows).all())

    # 3. per-shard HNSW graphs, each walked on its shard's device. M 8, not
    #    the JAX package's 4: at M 4 and n = 4, s0 is a local minimum no
    #    walk reaches in either package (it has one in-link), and this
    #    self lookup fails; at M 8 every row finds itself for n = 2 .. 8
    #    (tests/test_torch_parallel.py runs both packages at M 4 and 8)
    sharded = ShardedHnswIndex(dim=16, m=8, ef_construction=30, mesh=mesh)
    sub = rng.standard_normal((n_devices * 24, 16)).astype(np.float32)
    for i, v in enumerate(sub):
        sharded.add_record(f"s{i}", v)
    _hd, hdocs = sharded.search_batch(sub[:2], k=3, ef=16)
    assert hdocs.shape == (2, 3)
    assert sharded.interner.key_of(int(hdocs[0, 0])) == "s0"

    # 3b. dimension sharding (very wide rows): partial dots and norms,
    #     summed on the first device (SURVEY §5.7)
    _dtp, itp = pm.dim_sharded_flat_topk(mesh, corpus_dev, q, k=5)
    assert itp.shape == (4, 5)

    # 3c. sharded IVF (past one device's memory): blocks split over the
    #     shards, each shard's pruned search, one merge
    ivf_idx = ivf_ops.build_ivf(
        corpus, block_rows=128, n_clusters=max(4, n_devices),
        train_sample=corpus.shape[0], device=dev0,
    )
    probe = max(1, ivf_idx.n_blocks // n_devices)
    _div, iiv = pm.sharded_ivf_topk(mesh, ivf_idx, q, k=5, probe=probe)
    assert iiv.shape == (4, 5) and int(iiv[0, 0]) >= 0

    # 3d. sharded IVF + each shard's EXACT fp32 rescore (int8 blocks and
    #     fp32 rows both split over the shards)
    slots = torch.from_numpy(
        pm.rows_in_slot_order(corpus, ivf_idx.block_ids)).to(dev0)
    _dvr, ivr = pm.sharded_ivf_topk_rescored(
        mesh, ivf_idx, slots, q, k=5, probe=probe,
    )
    assert ivr.shape == (4, 5) and int(ivr[0, 0]) >= 0

    # 4. 2-D mesh (shard x replica): corpus split, query batch split
    if n_devices >= 4 and n_devices % 2 == 0:
        mesh2 = pm.make_mesh_2d(n_devices // 2, 2, devices=devices)
        c2 = rng.standard_normal(((n_devices // 2) * rows, d)).astype(
            np.float32)
        q2 = rng.standard_normal((8, d)).astype(np.float32)
        d2, _i2 = pm.replicated_sharded_flat_topk(
            mesh2, torch.from_numpy(c2).to(dev0),
            torch.from_numpy(q2).to(dev0), k=3)
        assert d2.shape == (8, 3)

    print(f"dryrun_multichip({n_devices}): ok")


if __name__ == "__main__":
    fn, args = entry()
    out = fn(*args)
    print("entry ok:", [tuple(o.shape) for o in out])
    dryrun_multichip(8)
