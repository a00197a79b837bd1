"""The port's HNSW index against the JAX package's, on the CPU.

The port's index is carried over from the JAX index's state
(``HnswVectorIndex.from_reference``: store rows, node <-> doc maps,
tombstones and the native graph through ``export_graph``/``import_graph``),
so both packages walk the same graph:

- the SoA walk (``hnsw_search_batch``), unfiltered, filtered and over
  tombstones: equal ids on >= 99% of the rows, equal id sets on every row,
  distances within rtol 1e-5;
- the AoS walk (``hnsw_search_batch_aos``): the JAX package sorts its beam
  unstably and scores in bf16 elementwise, so it is held by overlap (>= 0.98
  of the JAX package's ids) and recall@10 (no lower than the JAX package's
  minus 0.01);
- the scan route (``exact_search_batch``): ids equal in order, as the FLAT
  tests hold them, with the fused scan's plain versions (K1, K2) at a
  capacity of 131,072;
- the engine: the same FT.* replies from both Engines.
"""

import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from valkey_search_tpu.indexes.hnsw import HnswVectorIndex as JaxHnsw
from valkey_search_tpu.ops import distance as jdist
from valkey_search_tpu.ops import topk as jtopk
from valkey_search_tpu.server.engine import Engine as JaxEngine
from valkey_search_tpu_torch.indexes.hnsw import HnswVectorIndex
from valkey_search_tpu_torch.ops import distance as tdist
from valkey_search_tpu_torch.query import batcher as tbatcher
from valkey_search_tpu_torch.runtime.device import set_device
from valkey_search_tpu_torch.runtime.metrics import STATS
from valkey_search_tpu_torch.server.engine import Engine
from torch_port_config import saved_options, set_both

D, M, EFC, N, K = 16, 8, 40, 3000, 10
_KEYS = ("search.corpus-dtype", "search.scan-kernel",
         "search.hnsw-scan-threshold", "search.hnsw-aos-budget-bytes",
         "search.hnsw-aos-project-dim", "search.hnsw-traversal-seed-stride",
         "search.native-build-threads", "search.hnsw-build-mode")
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _cpu_and_config():
    set_device("cpu")
    with saved_options(*_KEYS):
        yield


def _arrays(jidx) -> dict:
    """The JAX index's state, as ``from_reference`` takes it."""
    st = jidx.store
    return {"vectors": st.vectors, "norms_sq": st.norms_sq,
            "magnitudes": st.magnitudes, "present": st.present,
            "metric": st.metric, "block": st.block, "m": jidx.m,
            "ef_construction": jidx.ef_construction,
            "ef_runtime": jidx.ef_runtime, "node_doc": jidx._node_doc,
            "deleted": jidx._deleted, "doc_node": dict(jidx._doc_node),
            "graph": jidx.builder.export_graph()}


def _pair(seed: int, metric: str = "l2", n: int = N, removed_every: int = 0):
    """A JAX index built by its native builder (one thread: deterministic),
    with every ``removed_every``-th key removed, and the port's index
    carried over from it."""
    rng = np.random.default_rng(seed)
    vecs = (rng.standard_normal((n, D)) * 3).astype(np.float32)
    jidx = JaxHnsw(dim=D, metric=metric, m=M, ef_construction=EFC)
    jidx.bulk_load([f"k{i}" for i in range(n)], vecs)
    removed = list(range(0, n, removed_every)) if removed_every else []
    for i in removed:
        jidx.remove_record(f"k{i}")
    idx = HnswVectorIndex.from_reference(_arrays(jidx),
                                         dict(jidx.interner.items()), CPU)
    return jidx, idx, vecs, removed


_PAIRS = {}


def _cached_pair(metric: str):
    """One index pair per metric for the scan-route cases, with 5% of the
    keys removed."""
    if metric not in _PAIRS:
        _PAIRS[metric] = _pair(11, metric, removed_every=20)
    return _PAIRS[metric]


def _queries(seed: int, b: int = 64) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal((b, D)) * 3).astype(
        np.float32)


def _assert_walks_match(got, want):
    (td, ti), (jd, ji) = got, (np.asarray(want[0]), np.asarray(want[1]))
    assert (ti == ji).all(1).mean() >= 0.99
    for a, b in zip(ti, ji):
        assert set(a.tolist()) == set(b.tolist())
    np.testing.assert_allclose(np.sort(td, 1), np.sort(jd, 1), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("metric", ["l2", "ip", "cosine"])
def test_batched_candidate_scores_match(rng, metric):
    q = rng.standard_normal((8, 32)).astype(np.float32)
    c = rng.standard_normal((8, 40, 32)).astype(np.float32)
    want = jdist.batched_candidate_scores(jnp.asarray(q), jnp.asarray(c),
                                          metric, "highest")
    got = tdist.batched_candidate_scores(torch.from_numpy(q),
                                         torch.from_numpy(c), metric)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-4)


@pytest.mark.parametrize("variant", ["plain", "filtered", "tombstones"])
@pytest.mark.parametrize("ef", [10, 50])
def test_soa_walk_matches(ef, variant):
    set_both("search.hnsw-scan-threshold", 0)
    set_both("search.hnsw-aos-budget-bytes", 0)  # the SoA walk serves
    jidx, idx, _, removed = _pair(
        3, removed_every=20 if variant == "tombstones" else 0)
    q = _queries(4)
    jmask = tmask = None
    if variant == "filtered":
        allowed = np.random.default_rng(5).random(jidx.store.capacity) < 0.1
        jmask, tmask = jnp.asarray(allowed), torch.from_numpy(allowed)
    before = STATS.get("hnsw_searches")
    want = jidx.search_batch(q, K, ef=ef, filter_mask=jmask)
    got = idx.search_batch(q, K, ef=ef, filter_mask=tmask)
    _assert_walks_match(got, want)
    ids = got[1][got[1] >= 0]
    if variant == "filtered":
        assert allowed[ids].all()
    assert not np.isin(ids, removed).any()
    assert STATS.get("hnsw_searches") == before + len(q)


@pytest.mark.parametrize("project_dim,seed_stride",
                         [(0, 0), (8, 0), (0, 16), (8, 16)])
def test_aos_walk_overlaps(project_dim, seed_stride):
    set_both("search.hnsw-scan-threshold", 0)
    set_both("search.hnsw-aos-project-dim", project_dim)
    set_both("search.hnsw-traversal-seed-stride", seed_stride)
    jidx, idx, vecs, _ = _pair(6)
    q = _queries(7)
    _, ji = jidx.search_batch(q, K, ef=50)
    _, ti = idx.search_batch(q, K, ef=50)
    assert idx._aos_tables is not None  # the AoS mirror served
    ji = np.asarray(ji)
    overlap = np.mean([len(set(a) & set(b)) / K for a, b in zip(ti, ji)])
    assert overlap >= 0.98
    dist = ((q[:, None, :] - vecs[None, :, :]) ** 2).sum(-1)
    gt = np.argsort(dist, axis=1)[:, :K]

    def recall(ids):
        return np.mean([len(set(a) & set(b)) / K for a, b in zip(ids, gt)])

    assert recall(ti) >= recall(ji) - 0.01


@pytest.mark.parametrize("metric", ["l2", "ip", "cosine"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_exact_search_batch_matches(dtype, metric):
    set_both("search.corpus-dtype", dtype)
    jidx, idx, _, removed = _cached_pair(metric)
    q = _queries(8, 5)
    allowed = np.random.default_rng(9).random(N + 100) < 0.3
    for jmask, tmask in ((None, None),
                         (jnp.asarray(allowed), torch.from_numpy(allowed))):
        jd, ji = jidx.exact_search_batch(q, K, jmask)
        td, ti = idx.exact_search_batch(q, K, tmask)
        np.testing.assert_array_equal(ti, np.asarray(ji))
        np.testing.assert_allclose(td, np.asarray(jd), rtol=1e-5)
        assert not np.isin(ti, removed).any()
        if tmask is not None:
            assert allowed[ti[ti >= 0]].all()


@pytest.fixture(scope="module")
def fused_pair():
    """~70,000 rows: pow2 capacity 131,072, where the scan route takes the
    fused scan. Built by the JAX index's native builder with threads."""
    with saved_options("search.native-build-threads"):
        set_both("search.native-build-threads", 4)
        return _pair(21, n=70_000, removed_every=97)


@pytest.mark.parametrize("filtered", [False, True])
@pytest.mark.parametrize("dtype", ["int8", "bfloat16"])
def test_scan_route_reaches_the_fused_scan(fused_pair, dtype, filtered):
    set_both("search.corpus-dtype", dtype)
    set_both("search.scan-kernel", "pallas")
    jidx, idx, _, removed = fused_pair
    assert idx.store.capacity == jidx.store.capacity == 131072
    q = _queries(22, 4)
    allowed = np.random.default_rng(23).random(idx.store.capacity) < 0.5
    graph = jidx.device_graph()
    jsnap = jidx.store.device_snapshot()
    node_filter = None
    if filtered:
        node_filter = jnp.take(jnp.asarray(allowed),
                               jnp.maximum(graph.node_doc, 0)) & (
            graph.node_doc >= 0)
    # the JAX package's scan route, with its Pallas kernel in interpret mode
    jd, jnodes = jtopk.flat_topk_fused(
        jnp.asarray(q), jsnap["vectors"], jsnap.get("vectors_lp"), k=K,
        corpus_sq=jsnap["norms_sq"],
        invalid=graph.deleted | (graph.node_doc < 0),
        filter_mask=node_filter, block_rows=131072,
        corpus_i8=jsnap.get("vectors_i8"), i8_scale=jsnap.get("i8_scale"),
        interpret=True)
    jnodes = np.asarray(jnodes)
    want = np.where(jnodes >= 0, jidx._node_doc[np.maximum(jnodes, 0)], -1)
    td, ti = idx.exact_search_batch(
        q, K, torch.from_numpy(allowed) if filtered else None)
    np.testing.assert_array_equal(ti, want)
    np.testing.assert_allclose(td, np.asarray(jd), rtol=1e-5)
    assert not np.isin(ti, removed).any()


def test_short_filter_mask_admits_no_doc_past_its_end():
    """A predicate mask shorter than the doc space: docs past its end are
    not allowed, on the scan route and on the walk, as with the mask
    False-padded."""
    jidx, idx, _, _ = _cached_pair("l2")
    q = _queries(12, 8)
    short = np.random.default_rng(13).random(N // 2) < 0.5
    padded = np.concatenate([short, np.zeros(N, bool)])
    for thresh in (1 << 30, 0):
        set_both("search.hnsw-scan-threshold", thresh)
        got = idx.search_batch(q, K, ef=40, filter_mask=torch.from_numpy(short))
        want = idx.search_batch(q, K, ef=40,
                                filter_mask=torch.from_numpy(padded))
        np.testing.assert_array_equal(got[1], want[1])
        assert (got[1] < N // 2).all() and short[got[1][got[1] >= 0]].all()


def test_vacuum_keeps_results():
    set_both("search.corpus-dtype", "float32")
    jidx, idx, _, removed = _pair(14, removed_every=20)
    q = _queries(15, 16)
    assert idx.deleted_count() == jidx.deleted_count() == len(removed)
    before = [index.search_batch(q, K) for index in (jidx, idx)]
    assert jidx.vacuum(force=True) == idx.vacuum(force=True) == len(removed)
    assert idx.deleted_count() == 0 and idx.reclaimable_bytes() == 0
    for (bd, bi), index in zip(before, (jidx, idx)):
        ad, ai = index.search_batch(q, K)
        np.testing.assert_array_equal(np.asarray(ai), np.asarray(bi))
        np.testing.assert_allclose(np.asarray(ad), np.asarray(bd), rtol=1e-6)
    jg, tg = jidx.builder.export_graph(), idx.builder.export_graph()
    np.testing.assert_array_equal(tg["links0"], jg["links0"])
    set_both("search.hnsw-scan-threshold", 0)
    set_both("search.hnsw-aos-budget-bytes", 0)
    _assert_walks_match(idx.search_batch(q, K, ef=40),
                        jidx.search_batch(q, K, ef=40))


def test_single_search_and_key_lookup():
    jidx, idx, vecs, _ = _cached_pair("l2")
    got, want = idx.search(vecs[5], 4), jidx.search(vecs[5], 4)
    assert [key for key, _ in got] == [key for key, _ in want]
    np.testing.assert_allclose([d for _, d in got], [d for _, d in want],
                               rtol=1e-5, atol=1e-3)
    assert idx.doc_of("k5") == jidx.doc_of("k5") and idx.doc_of("k0") is None
    assert idx.node_count == jidx.node_count == N


# ---------------------------------------------------------------------------
# the engine


ROWS = 2500
CREATE = ("FT.CREATE", "idx", "ON", "HASH", "PREFIX", "1", "doc:", "SCHEMA",
          "v", "VECTOR", "HNSW", "10", "TYPE", "FLOAT32", "DIM", str(D),
          "DISTANCE_METRIC", "L2", "M", "8", "EF_CONSTRUCTION", "60",
          "cat", "TAG")


def _engines(rng):
    engines = (JaxEngine(), Engine())
    rows = (rng.standard_normal((ROWS, D)) * 3).astype(np.float32)
    for e in engines:
        assert e.execute(*CREATE) == "OK"
        for i, row in enumerate(rows):
            e.execute("HSET", f"doc:{i}", "v", row.tobytes(),
                      "cat", f"c{i % 10}")
    deleted = [f"doc:{i}" for i in range(0, ROWS, 41)]
    updated = (rng.standard_normal((30, D)) * 3).astype(np.float32)
    for e in engines:
        assert e.execute("DEL", *deleted) == len(deleted)
        for j, row in enumerate(updated):
            e.execute("HSET", f"doc:{j * 7 + 2}", "v", row.tobytes())
    return engines, set(deleted)


def _knn(flt: str, blob: bytes, ef: str = ""):
    return ("FT.SEARCH", "idx", f"{flt}=>[KNN {K} @v $q{ef}]", "PARAMS", "2",
            "q", blob, "RETURN", "1", "__v_score")


def _same_reply(got, want):
    assert got[0] == want[0] and got[1::2] == want[1::2]
    for g, w in zip(got[2::2], want[2::2]):
        np.testing.assert_allclose(float(g[1]), float(w[1]), rtol=1e-5,
                                   atol=1e-5)


def test_engine_replies_match(rng):
    set_both("search.corpus-dtype", "float32")
    (jeng, teng), deleted = _engines(rng)
    queries = (rng.standard_normal((6, D)) * 3).astype(np.float32)
    flts = ("*", "@cat:{c3}", "(-@cat:{c3})")
    scans, walks = STATS.get("hnsw_served_by_scan"), STATS.get(
        "hnsw_searches")
    for q in queries:
        blob = q.tobytes()
        for flt in flts:
            for ef in ("", " EF_RUNTIME 50"):
                cmd = _knn(flt, blob, ef)
                got, want = teng.execute(*cmd), jeng.execute(*cmd)
                _same_reply(got, want)
                assert not deleted & set(got[1::2])
                if flt == "@cat:{c3}":
                    assert all(int(k[4:]) % 10 == 3 for k in got[1::2])
    # the walk serves: SoA (AoS off) gives equal replies, filtered too
    set_both("search.hnsw-scan-threshold", 0)
    set_both("search.hnsw-aos-budget-bytes", 0)
    for q in queries:
        for flt in ("*", "(-@cat:{c3})"):
            cmd = _knn(flt, q.tobytes(), " EF_RUNTIME 40")
            got, want = teng.execute(*cmd), jeng.execute(*cmd)
            _same_reply(got, want)
            assert not deleted & set(got[1::2])
    # the AoS walk: held by overlap
    set_both("search.hnsw-aos-budget-bytes", 1 << 30)
    hits = 0
    for q in queries:
        cmd = _knn("*", q.tobytes())
        got, want = teng.execute(*cmd), jeng.execute(*cmd)
        hits += len(set(got[1::2]) & set(want[1::2]))
    assert hits / (K * len(queries)) >= 0.95
    info_t, info_j = teng.execute("FT.INFO", "idx"), jeng.execute(
        "FT.INFO", "idx")
    attrs_t = info_t[info_t.index("attributes") + 1]
    attrs_j = info_j[info_j.index("attributes") + 1]
    # the HNSW attribute's fields (a TAG's memory differs by design: the
    # port keeps no raw-value column)
    assert attrs_t[0] == attrs_j[0] and attrs_t[0][5] == "HNSW"
    assert info_t[:7] == info_j[:7] and info_t[8:12] == info_j[8:12]
    assert STATS.get("hnsw_served_by_scan") > scans
    assert STATS.get("hnsw_searches") > walks


def test_engine_update_and_delete_are_visible(rng):
    set_both("search.corpus-dtype", "float32")
    (jeng, teng), deleted = _engines(rng)
    probe = (np.arange(D, dtype=np.float32) - 7) / 3
    for thresh in (1 << 30, 0):
        set_both("search.hnsw-scan-threshold", thresh)
        for e in (jeng, teng):
            e.execute("HSET", "doc:5", "v", probe.tobytes())
            reply = e.execute(*_knn("*", probe.tobytes()))
            assert reply[1] == "doc:5" and abs(float(reply[2][1])) <= 1e-4
            e.execute("DEL", "doc:5")
            reply = e.execute(*_knn("*", probe.tobytes()))
            assert "doc:5" not in reply[1::2]
            assert not deleted & set(reply[1::2])


class _EfIndex:
    """A stand-in index: answers each batch with its ef."""

    def search_batch(self, queries, k, ef=None):
        ids = np.full((queries.shape[0], k), ef, np.int64)
        return np.zeros((queries.shape[0], k), np.float32), ids


def test_batcher_mixed_ef_answers_without_idle_wait():
    """Interleaved submits at ef 10 and 50 (two batch signatures with idle
    dispatchers) are each answered well under IDLE_S: a submit wakes its
    own signature's dispatcher."""
    batcher = tbatcher.VectorQueryBatcher()
    index = _EfIndex()
    q = np.zeros(4, np.float32)
    worst = 0.0
    # repeats matter: a single wake-up goes to the longest waiter, which
    # after "10, 50" is the ef 10 dispatcher
    for ef in (10, 50, 50, 10, 10, 50, 10, 50, 50, 10):
        t0 = time.monotonic()
        _, ids = batcher.submit(index, q, 3, ef).result(10)
        worst = max(worst, time.monotonic() - t0)
        assert (ids == ef).all()
        time.sleep(0.02)  # both dispatchers wait, idle
    assert worst < 0.5, f"a query waited {worst:.3f} s"
    assert batcher.IDLE_S == 2.0


def test_batcher_mixed_ef_under_threads():
    """16 threads submitting at ef 10 and 50 at once: every query answered,
    each with its own signature's result."""
    batcher = tbatcher.VectorQueryBatcher()
    index = _EfIndex()
    out, lat = {}, []
    lock = threading.Lock()

    def worker(t):
        ef = 10 if t % 2 else 50
        for _ in range(10):
            t0 = time.monotonic()
            _, ids = batcher.submit(index, np.zeros(4, np.float32), 2,
                                    ef).result(10)
            with lock:
                lat.append(time.monotonic() - t0)
                out.setdefault(ef, set()).update(ids.ravel().tolist())

    pool = [threading.Thread(target=worker, args=(t,)) for t in range(16)]
    for t in pool:
        t.start()
    for t in pool:
        t.join(30)
    assert not any(t.is_alive() for t in pool)
    assert out == {10: {10}, 50: {50}} and len(lat) == 160
    assert max(lat) < 1.0
