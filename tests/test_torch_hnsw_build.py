"""The port's HNSW bulk construction against the JAX package's, on the CPU.

The corpus is dyadic: every value is a multiple of 1/32 in [-8, 8], so it is
exact in bf16, and every product and sum of the builds (d 16) is exact in
f32: both packages compute the same distances bit for bit, whatever order
they sum in. The fixture also redraws rows until no two candidate distances
of a row tie among the nearest the builds select (prefix scans and seeded
batches alike), so no result depends on how a selection breaks ties.
"""

import numpy as np
import pytest
import torch

from valkey_search_tpu.indexes.hnsw import HnswVectorIndex as JaxHnsw
from valkey_search_tpu.ops import hnsw_build as jhb
from valkey_search_tpu_torch.indexes.hnsw import HnswVectorIndex
from valkey_search_tpu_torch.ops import hnsw_build as thb
from valkey_search_tpu_torch.runtime.device import set_device
from torch_port_config import saved_options, set_both

D, M, EFC = 16, 8, 40
K_CAND = min(EFC, 64) + 1   # the bulk build's candidates, self included
K_SEEDS = min(EFC, 128) + 1  # a seeded batch's candidates
BATCH = 1024                 # search.hnsw-build-batch in these tests
N_FIRST, N_SECOND = 2048, 2048
_KEYS = ("search.hnsw-build-mode", "search.hnsw-build-batch",
         "search.hnsw-scan-threshold", "search.corpus-dtype")


@pytest.fixture(autouse=True)
def _cpu_and_config():
    set_device("cpu")
    with saved_options(*_KEYS):
        yield


def _tied_rows(c: np.ndarray) -> np.ndarray:
    """Rows whose nearest candidates hold two equal distances: the first
    K_CAND + 1 below the row under l2 and ip for the first N_FIRST rows;
    the first K_SEEDS + 1 below the end of the row's seeded batch under l2
    after them."""
    n = len(c)
    c64 = c.astype(np.float64)
    dots = c64 @ c64.T
    sq = np.diag(dots)
    l2 = sq[:, None] + sq[None, :] - 2.0 * dots
    row = np.arange(n)[:, None]
    col = np.arange(n)[None, :]
    end = np.where(row < N_FIRST, row,
                   N_FIRST + ((row - N_FIRST) // BATCH + 1) * BATCH)
    bad = np.zeros(n, bool)
    for dist, first in ((l2, True), (-dots, False)):
        width = np.where(row < N_FIRST, K_CAND + 1, K_SEEDS + 1)[:, 0]
        masked = np.where(col < end, dist, np.inf)
        if not first:  # ip: the prefix rows only
            masked[N_FIRST:] = np.inf
        near = np.sort(np.partition(masked, K_SEEDS + 1, axis=1)
                       [:, :K_SEEDS + 2], axis=1)
        near[np.arange(K_SEEDS + 2)[None, :] >= width[:, None]] = np.inf
        bad |= ((np.diff(near, axis=1) == 0) & np.isfinite(near[:, 1:])).any(1)
    return np.nonzero(bad)[0]


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(17)
    c = (rng.integers(-256, 257, (N_FIRST + N_SECOND, D)) / 32).astype(
        np.float32)
    for _ in range(20):
        bad = _tied_rows(c)
        if not len(bad):
            break
        c[bad] = (rng.integers(-256, 257, (len(bad), D)) / 32).astype(
            np.float32)
    assert not len(_tied_rows(c)), "a candidate distance still ties"
    return c


@pytest.mark.parametrize("n,m,seed", [(1, 16, 0x5EED), (5000, 8, 3),
                                      (20000, 32, 0x5EED)])
def test_sample_levels_match(n, m, seed):
    jl, jmax = jhb.sample_levels(n, m, seed)
    tl, tmax = thb.sample_levels(n, m, seed)
    np.testing.assert_array_equal(tl, jl)
    assert tl.dtype == jl.dtype and tmax == jmax


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_candidate_scan_matches(corpus, metric):
    import jax.numpy as jnp

    c = corpus[:N_FIRST]
    s, e = 1024, 2048
    c_lp = jnp.asarray(c, jnp.bfloat16)
    c_sq = jnp.einsum("ij,ij->i", jnp.asarray(c), jnp.asarray(c))
    qsq = np.einsum("ij,ij->i", c[s:e], c[s:e])[:, None]
    jd, ji = jhb._candidate_scan(
        c_lp[s:e], jnp.asarray(qsq), c_lp, c_sq,
        jnp.arange(s, e, dtype=jnp.int32), k=K_CAND, metric=metric)
    cf = torch.from_numpy(c).to(torch.bfloat16).to(torch.float32)
    t_sq = torch.from_numpy(c).pow(2).sum(1)
    td, ti = thb._candidate_scan(
        cf[s:e], t_sq[s:e], cf, t_sq,
        torch.arange(s, e, dtype=torch.int32), K_CAND, metric, e)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


@pytest.mark.parametrize("alpha", [1.0, 1.2])
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_prune_candidates_match(corpus, metric, alpha):
    import jax.numpy as jnp

    c = corpus[:N_FIRST]
    s, e = 512, 1536
    c_lp = jnp.asarray(c, jnp.bfloat16)
    c_sq = jnp.einsum("ij,ij->i", jnp.asarray(c), jnp.asarray(c))
    qsq = np.einsum("ij,ij->i", c[s:e], c[s:e])[:, None]
    self_ids = jnp.arange(s, e, dtype=jnp.int32)
    dq, ids = jhb._candidate_scan(c_lp[s:e], jnp.asarray(qsq), c_lp, c_sq,
                                  self_ids, k=K_CAND, metric=metric)
    want = jhb.prune_candidates(c_lp, c_sq, ids, dq, self_ids, m=M,
                                metric=metric, alpha=alpha)
    got = thb.prune_candidates(
        torch.from_numpy(c).to(torch.bfloat16),
        torch.from_numpy(np.array(c_sq)),
        torch.from_numpy(np.array(ids)), torch.from_numpy(np.array(dq)),
        torch.arange(s, e, dtype=torch.int32), M, metric, alpha)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy() >= 0).sum(1).min() >= 1


@pytest.mark.parametrize("metric,prefix", [("l2", True), ("ip", True),
                                           ("cosine", True), ("l2", False)])
def test_build_pruned_knn_links_match(corpus, metric, prefix):
    c = corpus[:N_FIRST]
    want = jhb.build_pruned_knn_links(c, metric, m=M, k_cand=K_CAND - 1,
                                      batch=BATCH, prefix=prefix)
    times = {}
    got = thb.build_pruned_knn_links(c, metric, m=M, k_cand=K_CAND - 1,
                                     batch=BATCH, prefix=prefix,
                                     timings=times)
    np.testing.assert_array_equal(got, want)
    assert set(times) == {"candidate_scan_s", "prune_s"}


def test_nearest_blocks_columns_like_one_block(corpus, monkeypatch):
    """A score block narrower than the corpus (a running top-k over 4,096
    columns at a time) selects what one block does."""
    cf = torch.from_numpy(corpus)
    c_sq = (cf * cf).sum(1)
    q = cf[:300]
    one = thb.nearest(q, cf, 50, "l2", c_sq[:300], c_sq, len(cf))
    monkeypatch.setattr(thb, "_CPU_BLOCK_BYTES", 1)
    assert thb._column_block(300, cf.device) == 4096
    monkeypatch.setattr(thb, "_COLUMN_QUANTUM", 1000)
    blocked = thb.nearest(q, cf, 50, "l2", c_sq[:300], c_sq, len(cf))
    assert torch.equal(one[1], blocked[1]) and torch.equal(one[0], blocked[0])


@pytest.mark.parametrize("k", [1, 10, 40])
def test_block_selection_is_topk_smallest(k):
    """The f32 top-k with a margin selects what topk_smallest does: the k
    smallest, ties to the lower column, with many ties (small integers),
    rows with fewer than k finite scores, and ties at the k-th value (the
    block then takes topk_smallest itself)."""
    from valkey_search_tpu_torch.ops.topk import topk_smallest

    rng = np.random.default_rng(k)
    s = torch.from_numpy(rng.integers(0, 30, (64, 700)).astype(np.float32))
    s[3, :] = float("inf")
    s[4, 5:] = float("inf")
    wide = torch.from_numpy(rng.standard_normal((64, 700)).astype(np.float32))
    for block in (s, wide, torch.where(wide > 2.5, float("inf"), wide)):
        want_d, want_p = topk_smallest(block, k)
        got_d, got_p = thb._smallest(block, k)
        finite = torch.isfinite(want_d)
        assert torch.equal(got_d, want_d)
        assert torch.equal(got_p[finite], want_p[finite])


def _jax_index(metric="l2"):
    return JaxHnsw(dim=D, metric=metric, m=M, ef_construction=EFC)


def _graphs_equal(got: dict, want: dict) -> None:
    for key in ("count", "entry", "max_level"):
        assert got[key] == want[key], key
    for key in ("links0", "levels", "deleted"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert len(got["uppers"]) == len(want["uppers"])
    for g, w in zip(got["uppers"], want["uppers"]):
        np.testing.assert_array_equal(g["nodes"], w["nodes"])
        np.testing.assert_array_equal(g["links"], w["links"])


def test_device_bulk_build_and_seeded_batch_match(corpus):
    """hnsw-build-mode device: the bulk build of a first batch (candidate
    scan, prune, native bulk_build, bridging) and the device-seeded insert
    of a second give the JAX package's graph."""
    set_both("search.hnsw-build-mode", "device")
    set_both("search.hnsw-build-batch", BATCH)
    jidx = _jax_index()
    idx = HnswVectorIndex(dim=D, m=M, ef_construction=EFC,
                          device=torch.device("cpu"))
    keys = [f"k{i}" for i in range(len(corpus))]
    for index in (jidx, idx):
        index.bulk_load(keys[:N_FIRST], corpus[:N_FIRST])
    _graphs_equal(idx.builder.export_graph(), jidx.builder.export_graph())
    assert {"candidate_scan_s", "prune_s", "native_bulk_build_s",
            "bridge_s", "bridge_rounds"} <= set(idx.build_seconds)
    for index in (jidx, idx):
        index.bulk_load(keys[N_FIRST:], corpus[N_FIRST:])
    _graphs_equal(idx.builder.export_graph(), jidx.builder.export_graph())
    np.testing.assert_array_equal(idx._node_doc, jidx._node_doc)
    assert idx.store.capacity == jidx.store.capacity == 4096
    # the graph serves: the scan route and the walk find each row itself
    set_both("search.corpus-dtype", "float32")
    q = corpus[::97]
    for thresh in (1 << 30, 0):
        set_both("search.hnsw-scan-threshold", thresh)
        _, docs = idx.search_batch(q, 1, ef=64)
        np.testing.assert_array_equal(docs[:, 0], np.arange(0, 4096, 97))


def test_build_mode_auto_builds_on_the_host_for_a_cpu_store(corpus):
    set_both("search.hnsw-build-mode", "auto")
    idx = HnswVectorIndex(dim=D, m=M, ef_construction=EFC,
                          device=torch.device("cpu"))
    host = _jax_index()
    keys = [f"k{i}" for i in range(N_FIRST)]
    idx.bulk_load(keys, corpus[:N_FIRST])
    host.builder.add_batch(corpus[:N_FIRST])
    assert idx.build_seconds == {}
    _graphs_equal(idx.builder.export_graph(), host.builder.export_graph())


def test_bridge_components_joins_islands():
    """Two far clusters built as a symmetric KNN graph are two islands;
    bridging joins them in one round."""
    rng = np.random.default_rng(5)
    c = np.concatenate([rng.standard_normal((600, D)),
                        rng.standard_normal((600, D)) + 50]).astype(
        np.float32)
    idx = HnswVectorIndex(dim=D, m=M, ef_construction=EFC,
                          device=torch.device("cpu"))
    links = thb.build_pruned_knn_links(c, "l2", m=M, k_cand=16,
                                       batch=BATCH, prefix=False)
    levels, _ = thb.sample_levels(len(c), M, seed=1)
    idx.builder.bulk_build(c, levels, links)
    assert idx.builder.components().max() >= 1
    assert thb.bridge_components(idx.builder, c) == 1
    assert idx.builder.components().max() == 0
