"""The hand-written CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA GPU and skip without one. The file imports only
the port (no JAX and nothing of valkey_search_tpu), so it also runs where
JAX is not installed, without the JAX test harness of tests/conftest.py:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from valkey_search_tpu_torch.indexes.flat import FlatVectorIndex
from valkey_search_tpu_torch.indexes.hnsw import HnswVectorIndex
from valkey_search_tpu_torch.ops import bucket_scan as bs
from valkey_search_tpu_torch.ops import ivf
from valkey_search_tpu_torch.ops import topk
from valkey_search_tpu_torch.runtime import config
from valkey_search_tpu_torch.runtime.device import set_device
from valkey_search_tpu_torch.runtime.metrics import STATS

GROUP = bs.GROUP


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return set_device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("span,d", [(1, 128), (8, 128), (4, 256), (2, 48)])
def test_kernels_match_plain(dev, span, d):
    gen = torch.Generator(device=dev).manual_seed(span * 1000 + d)
    b, n = 40, 2 * span * GROUP
    n_rows = n - 999
    q = torch.randint(-127, 128, (b, d), generator=gen, device=dev,
                      dtype=torch.int8)
    c = torch.randint(-127, 128, (n_rows, d), generator=gen, device=dev,
                      dtype=torch.int8)
    dotmax, clamp, sentinel, _, _ = bs.i8_packed_layout(bs.round_up(d, 128),
                                                        span)
    bias = torch.randint(0, clamp, (n,), generator=gen, device=dev,
                         dtype=torch.int32) + dotmax
    bias[n_rows:] = sentinel
    before = sum(bs.launch_counts().values())
    got = bs.bucket_min_scan_i8_packed(q, c, bias, span)
    torch.cuda.synchronize()
    assert sum(bs.launch_counts().values()) == before + 1
    assert torch.equal(got, bs.bucket_min_scan_i8_packed_plain(q, c, bias, span))


# K1 over its query tiles: ragged tiles (B = 5, 40, 130 against BQ = 8,
# 40, 128), a k-pad (d 48: one 128-column box of which 80 columns are
# zeros; d 144: a second box of 16 columns), span 1 (chunk_bits 7) and 8
# (chunk_bits 10, pre_shift 3), n_rows not a multiple of 128 with arbitrary
# biases on the padded tail (zero-vector rows score bias - 0), and B = 1
# with 95% or more of the rows excluded, as a hybrid request gives them
_K1_CASES = [(b, d, span, 0.95) for b in (1, 5, 40, 130)
             for d in (48, 128, 144) for span in (1, 8)]
_K1_CASES += [(1, 128, 8, 0.01), (1, 128, 1, 0.05), (1, 48, 8, 0.01)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,d,span,kept", _K1_CASES)
def test_k1_kernel_matches_plain(dev, b, d, span, kept):
    gen = torch.Generator(device=dev).manual_seed(b * 1000 + d + span)
    n = 2 * span * GROUP
    n_rows = n - 999
    q = torch.randint(-127, 128, (b, d), generator=gen, device=dev,
                      dtype=torch.int8)
    c = torch.randint(-127, 128, (n_rows, d), generator=gen, device=dev,
                      dtype=torch.int8)
    dotmax, clamp, sentinel, _, _ = bs.i8_packed_layout(bs.round_up(d, 128),
                                                        span)
    bias = torch.randint(0, clamp, (n,), generator=gen, device=dev,
                         dtype=torch.int32) + dotmax
    excluded = torch.rand((n,), generator=gen, device=dev) >= kept
    excluded[n_rows:] = False  # the tail keeps its arbitrary biases
    bias[excluded] = sentinel
    before = sum(bs.launch_counts().values())
    got = bs.bucket_min_scan_i8_packed(q, c, bias, span)
    torch.cuda.synchronize()
    assert sum(bs.launch_counts().values()) == before + 1
    assert torch.equal(got, bs.bucket_min_scan_i8_packed_plain(q, c, bias, span))


# K2: ragged query tiles (B = 5, 40, 130 against BQ = 8, 40, 128), a k-pad
# (d 48: a partial 64-column box and a 16-column k-step of zeros; d 136: a
# second box of 8 columns), a padded tail of zero rows, and B = 1 with 95%
# or more of the rows excluded, as a hybrid request gives them
_K2_CASES = [(b, d, positive, 0.95)
             for b in (1, 5, 40, 130) for d in (48, 128, 136)
             for positive in (True, False)]
_K2_CASES += [(1, 128, True, 0.01), (1, 128, False, 0.05), (1, 48, True, 0.01)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,d,positive,kept", _K2_CASES)
def test_k2_kernel_matches_plain(dev, b, d, positive, kept):
    gen = torch.Generator(device=dev).manual_seed(b * 1000 + d)
    n = 4 * GROUP
    n_rows = n - 999
    qf = torch.randn((b, d), generator=gen, device=dev)
    cf = torch.randn((n_rows, d), generator=gen, device=dev)
    bias = torch.zeros((n,), device=dev)
    if positive:
        bias[:n_rows] = (cf * cf).sum(1)
    excluded = torch.rand((n,), generator=gen, device=dev) >= kept
    excluded[n_rows:] = True
    bias[excluded] = float("inf")
    qsq = (qf * qf).sum(1) if positive else torch.zeros(b, device=dev)
    args = (((-2.0 if positive else -1.0) * qf).to(torch.bfloat16),
            qsq.contiguous(), cf.to(torch.bfloat16), bias, positive)
    before = bs.launch_counts()["bucket_scan_bf16"]
    vals, idx = bs.bucket_min_scan(*args)
    torch.cuda.synchronize()
    assert bs.launch_counts()["bucket_scan_bf16"] == before + 1
    pv, pi = bs.bucket_min_scan_plain(*args)
    agree = idx == pi
    assert float(agree.float().mean()) >= 0.99
    torch.testing.assert_close(vals[agree], pv[agree], rtol=4e-5, atol=1e-2)
    assert torch.equal(torch.isinf(vals[agree]), torch.isinf(pv[agree]))
    # an all-excluded bucket decodes to +inf at its lowest chunk
    dead = torch.isinf(pv)
    assert torch.isinf(vals[dead]).all()
    lane = torch.arange(n // 128, device=dev) % 128
    group = torch.arange(n // 128, device=dev) // 128
    lowest = (group * GROUP + lane).to(torch.int32).expand(b, -1)
    assert torch.equal(idx[dead], lowest[dead])


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [True, False])
def test_fused_topk_on_card_matches_cpu(dev, int8):
    """flat_topk_fused through the kernels (several blocks, a filter, a
    padded tail) against the same call on the CPU (plain versions)."""
    rng = np.random.default_rng(3)
    b, n, d, k = 24, 3 * GROUP + 500, 64, 10
    q = torch.from_numpy(rng.standard_normal((b, d)).astype(np.float32))
    c = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))
    allowed = torch.from_numpy(rng.random(n) < 0.8)
    scale = torch.clamp_min(c.abs().max() / 127.0, 1e-30)
    c_i8 = torch.clamp(torch.round(c / scale), -127, 127).to(torch.int8)
    out = []
    for where in (torch.device("cpu"), dev):
        kw = dict(k=k, filter_mask=allowed.to(where), block_rows=GROUP,
                  corpus_sq=(c * c).sum(1).to(where))
        if int8:
            kw.update(corpus_i8=c_i8.to(where), i8_scale=scale.to(where))
        lp = None if int8 else c.to(where, torch.bfloat16)
        out.append(topk.flat_topk_fused(q.to(where), c.to(where), lp, **kw))
    (cd, ci), (gd, gi) = out
    if int8:  # keys are exact: the same candidates, the same answer
        assert torch.equal(gi.cpu(), ci)
    else:
        same = np.mean([len(set(gi[i].tolist()) & set(ci[i].tolist())) / k
                        for i in range(b)])
        assert same >= 0.99
    torch.testing.assert_close(gd.cpu(), cd, rtol=1e-5, atol=1e-5)
    assert allowed[gi.cpu().long()].all()


# -- the fused launch replayed as a CUDA graph (ops/fused_graphs.py) --------

_GRAPH_INDEXES = {}


def _graph_index(dev, dtype, metric, n, d):
    """A FLAT index of ``n`` Gaussian rows published under ``dtype``, and
    200 queries; built once per (dtype, metric, n, d) in the process."""
    key = (dtype, metric, n, d)
    if key not in _GRAPH_INDEXES:
        rng = np.random.default_rng(n + d)
        vecs = rng.standard_normal((n, d)).astype(np.float32)
        index = FlatVectorIndex(dim=d, metric=metric, device=dev)
        index.bulk_load([f"k{i}" for i in range(n)], vecs)
        queries = rng.standard_normal((200, d)).astype(np.float32)
        _GRAPH_INDEXES[key] = index, queries
    return _GRAPH_INDEXES[key]


def _graph_counts():
    return (STATS.get("flat_graph_captures"),
            STATS.get("flat_graph_replays"))


def _eager(index, q, k):
    """``flat_topk_fused`` called eagerly on the index's snapshot, as
    ``search_batch`` calls it: host arrays."""
    if index.metric == "cosine":
        q = q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-30)
    snap = index.store.device_snapshot()
    corpus = snap["vectors"]
    d, i = topk.flat_topk_fused(
        torch.from_numpy(q).to(corpus.device), corpus,
        snap.get("vectors_lp"), k=k, metric=index.metric,
        corpus_sq=snap["norms_sq"], invalid=snap["invalid"],
        block_rows=max(int(config.get("search.flat-block-size")),
                       corpus.shape[0]),
        corpus_i8=snap.get("vectors_i8"), i8_scale=snap.get("i8_scale"))
    return d.cpu().numpy(), i.cpu().numpy()


def _same_bits(got, want):
    (gd, gi), (wd, wi) = got, want
    return (np.array_equal(gi, wi)
            and np.array_equal(gd.view(np.int32), wd.view(np.int32)))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [10, 100])
@pytest.mark.parametrize("b", [1, 7, 128])
@pytest.mark.parametrize("metric", ["l2", "cosine"])
@pytest.mark.parametrize("dtype,n,d,kernel", [
    ("int8", 1_048_576, 128, "bucket_scan_i8_packed[pre_shift>0]"),  # K1b
    ("bfloat16", 262_144, 768, "bucket_scan_bf16"),                  # K2
])
def test_graph_replay_is_the_eager_launch_bit_for_bit(dev, dtype, n, d,
                                                      kernel, metric, b, k):
    with _Options(corpus_dtype=dtype, topk_mode="approx",
                  scan_kernel="auto"):
        index, queries = _graph_index(dev, dtype, metric, n, d)
        q = queries[:b]
        want = _eager(index, q, k)
        c0, r0 = _graph_counts()
        first = index.search_batch(q, k)   # captured: the warm-up answers
        assert _graph_counts() == (c0 + 1, r0)
        launches = bs.launch_counts()[kernel]
        got = index.search_batch(q, k)     # replayed
        assert _graph_counts() == (c0 + 1, r0 + 1)
        assert bs.launch_counts()[kernel] == launches + 1
        assert _same_bits(first, want) and _same_bits(got, want)
        assert got[1].shape == (b, k) and (got[1] >= 0).all()


@pytest.mark.cuda
def test_a_write_recaptures_the_graph(dev):
    """HSET and DEL that change the top 10 publish a new snapshot: the next
    search captures again and answers the new rows as the eager launch."""
    with _Options(corpus_dtype="int8", topk_mode="approx",
                  scan_kernel="auto"):
        index, queries = _graph_index(dev, "int8", "l2", 140_000, 64)
        q = queries[:1]
        index.search_batch(q, 10)
        before = index.search_batch(q, 10)
        old = [key for key, _ in index.neighbors_to_keys(before[0][0],
                                                         before[1][0])]
        for key in old[:3]:
            index.remove_record(key)            # DEL of the best three
        index.add_record("new", q[0] * 1.001)   # HSET: the new best
        c0, r0 = _graph_counts()
        got = index.search_batch(q, 10)
        assert _graph_counts() == (c0 + 1, r0)
        assert _same_bits(got, _eager(index, q, 10))
        keys = [key for key, _ in index.neighbors_to_keys(got[0][0],
                                                          got[1][0])]
        assert keys[0] == "new" and not set(old[:3]) & set(keys)
        again = index.search_batch(q, 10)
        assert _graph_counts() == (c0 + 1, r0 + 1)
        assert _same_bits(again, got)


@pytest.mark.cuda
def test_filtered_wide_and_xla_launches_stay_eager(dev):
    with _Options(corpus_dtype="int8", topk_mode="approx",
                  scan_kernel="auto"):
        index, queries = _graph_index(dev, "int8", "l2", 140_000, 64)
        index.search_batch(queries[:1], 10)
        counts = _graph_counts()
        everything = torch.ones(index.store.capacity, dtype=torch.bool,
                                device=dev)
        got = index.search_batch(queries[:1], 10, filter_mask=everything)
        assert _same_bits(got, index.search_batch(queries[:1], 10))
        counts = (counts[0], counts[1] + 1)   # the unfiltered one replayed
        assert _graph_counts() == counts
        wide = index.search_batch(queries[:129], 10)
        assert _same_bits(wide, _eager(index, queries[:129], 10))
        assert _graph_counts() == counts
        with _Options(scan_kernel="xla"):
            index.search_batch(queries[:1], 10)
        assert _graph_counts() == counts


@pytest.mark.cuda
def test_concurrent_searches_get_their_own_answers(dev):
    """Three threads on one index, two of them on one graph (B = 1) and one
    on another (B = 7), with the interpreter switching threads every
    microsecond: every answer is its own query's."""
    import sys
    import threading

    with _Options(corpus_dtype="int8", topk_mode="approx",
                  scan_kernel="auto"):
        index, queries = _graph_index(dev, "int8", "l2", 140_000, 64)
        work = [queries[10:11], queries[11:12], queries[20:27]]
        wants = [_eager(index, q, 10) for q in work]
        for q in work:
            index.search_batch(q, 10)   # captured outside the race
        c0, r0 = _graph_counts()
        errors = []

        def run(q, want):
            try:
                for _ in range(200):
                    if not _same_bits(index.search_batch(q, 10), want):
                        errors.append("a wrong answer")
            except Exception as exc:  # noqa: BLE001 - reported below
                errors.append(repr(exc))

        threads = [threading.Thread(target=run, args=(q, w))
                   for q, w in zip(work, wants)]
        old = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=300)
        finally:
            sys.setswitchinterval(old)
        assert not any(t.is_alive() for t in threads)
        assert errors == []
        assert _graph_counts() == (c0, r0 + 600)
    from valkey_search_tpu_torch.server.engine import Engine

    names = Engine().execute("FT._DEBUG", "METRICS", "NAMES_ONLY")
    assert {"flat_graph_captures", "flat_graph_replays"} <= set(names)


@pytest.mark.cuda
@pytest.mark.parametrize("groups,d", [(1, 128), (3, 768), (2, 48)])
def test_k3_matches_plain(dev, groups, d):
    gen = torch.Generator(device=dev).manual_seed(groups * 1000 + d)
    b, n = 40, groups * GROUP
    n_rows = n - 999
    q = torch.randint(-127, 128, (b, d), generator=gen, device=dev,
                      dtype=torch.int8)
    c = torch.randint(-127, 128, (n_rows, d), generator=gen, device=dev,
                      dtype=torch.int8)
    clamp, sentinel, _, _ = bs.i8_layout(bs.round_up(d, 128))
    bias = torch.randint(0, clamp // 64, (n,), generator=gen, device=dev,
                         dtype=torch.int32)
    bias[torch.rand((n,), generator=gen, device=dev) < 0.05] = sentinel
    bias[n_rows:] = sentinel
    before = bs.launch_counts()["bucket_scan_i8"]
    vals, idx = bs.bucket_min_scan_i8(q, c, bias)
    torch.cuda.synchronize()
    assert bs.launch_counts()["bucket_scan_i8"] == before + 1
    pv, pi = bs.bucket_min_scan_i8_plain(q, c, bias)
    assert torch.equal(vals.view(torch.int32), pv.view(torch.int32))
    assert torch.equal(idx, pi)
    assert bool((vals < 0).any())  # negative scores were exercised


# K3 over the same query tiles and dims, with negative scores (no +DOTMAX
# offset) and arbitrary biases on the padded tail
_K3_CASES = [(b, d) for b in (1, 5, 40, 130) for d in (48, 128, 144)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,d", _K3_CASES)
def test_k3_kernel_matches_plain_over_query_tiles(dev, b, d):
    gen = torch.Generator(device=dev).manual_seed(b * 1000 + d)
    n = 2 * GROUP
    n_rows = n - 999
    q = torch.randint(-127, 128, (b, d), generator=gen, device=dev,
                      dtype=torch.int8)
    c = torch.randint(-127, 128, (n_rows, d), generator=gen, device=dev,
                      dtype=torch.int8)
    clamp, sentinel, _, _ = bs.i8_layout(bs.round_up(d, 128))
    bias = torch.randint(0, clamp // 64, (n,), generator=gen, device=dev,
                         dtype=torch.int32)
    bias[:n_rows][torch.rand((n_rows,), generator=gen, device=dev) < 0.05] = \
        sentinel
    before = bs.launch_counts()["bucket_scan_i8"]
    vals, idx = bs.bucket_min_scan_i8(q, c, bias)
    torch.cuda.synchronize()
    assert bs.launch_counts()["bucket_scan_i8"] == before + 1
    pv, pi = bs.bucket_min_scan_i8_plain(q, c, bias)
    assert torch.equal(vals.view(torch.int32), pv.view(torch.int32))
    assert torch.equal(idx, pi)
    assert bool((vals < 0).any())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["int8", "bfloat16"])
def test_filtered_search_batch_stays_inside_the_mask(dev, dtype):
    """A 1% pre-filter through search_batch on the card (the fused scan at
    131,072+ rows): every id lies inside the mask, as on the CPU."""
    saved = config.get("search.corpus-dtype")
    config.set_config("search.corpus-dtype", dtype)
    try:
        rng = np.random.default_rng(4)
        n, d, k = 140_000, 32, 10
        vecs = rng.standard_normal((n, d)).astype(np.float32)
        allowed = rng.random(n) < 0.01
        index = FlatVectorIndex(dim=d, device=dev)
        for i in range(n):
            index.add_record(f"k{i}", vecs[i])
        q = rng.standard_normal((6, d)).astype(np.float32)
        bs.reset_launches()
        _, ids = index.search_batch(
            q, k, filter_mask=torch.from_numpy(allowed).to(dev))
        assert sum(bs.launch_counts().values()) == 1
        assert (ids >= 0).all() and allowed[ids].all()
        dist = ((vecs[None, :, :] - q[:, None, :]) ** 2).sum(-1)
        dist[:, ~allowed] = np.inf
        want = np.argsort(dist, axis=1)[:, :k]
        hits = np.mean([len(set(ids[i]) & set(want[i])) / k
                        for i in range(len(q))])
        assert hits >= 0.98
    finally:
        config.set_config("search.corpus-dtype", saved)


def _hnsw_state(index):
    """An HNSW index's state, as ``HnswVectorIndex.from_reference`` takes
    it (the port's own index stands in for the JAX package's here)."""
    st = index.store
    return {"vectors": st.vectors, "norms_sq": st.norms_sq,
            "magnitudes": st.magnitudes, "present": st.present,
            "metric": st.metric, "block": st.block, "m": index.m,
            "ef_construction": index.ef_construction,
            "ef_runtime": index.ef_runtime, "node_doc": index._node_doc,
            "deleted": index._deleted, "doc_node": dict(index._doc_node),
            "graph": index.builder.export_graph()}


class _Options:
    """Set port options for one test and restore them after."""

    def __init__(self, **options):
        self.options = {k.replace("_", "-"): v for k, v in options.items()}

    def __enter__(self):
        self.saved = {k: config.get("search." + k) for k in self.options}
        for k, v in self.options.items():
            config.set_config("search." + k, v)

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            config.set_config("search." + k, v)


@pytest.mark.cuda
def test_hnsw_scan_route_launches_k1_and_k2(dev):
    """An HNSW index on the card (device bulk build) at pow2 capacity
    131,072: its scan route reaches the fused scan, K1 under int8 and K2
    under bfloat16, filtered and not."""
    rng = np.random.default_rng(8)
    n, d, k = 70_000, 32, 10
    vecs = rng.standard_normal((n, d)).astype(np.float32)
    index = HnswVectorIndex(dim=d, m=8, ef_construction=40, device=dev)
    index.bulk_load([f"k{i}" for i in range(n)], vecs)
    assert index.store.capacity == 131072 and index.build_seconds
    q = rng.standard_normal((8, d)).astype(np.float32)
    allowed = rng.random(n) < 0.2
    dist = ((vecs[None, :, :] - q[:, None, :]) ** 2).sum(-1)
    for dtype, kernel in (("int8", "bucket_scan_i8_packed[pre_shift=0]"),
                          ("bfloat16", "bucket_scan_bf16")):
        with _Options(corpus_dtype=dtype):
            for mask in (None, allowed):
                bs.reset_launches()
                tmask = None if mask is None else torch.from_numpy(mask).to(dev)
                _, ids = index.search_batch(q, k, filter_mask=tmask)
                assert bs.launch_counts()[kernel] == 1
                dd = dist if mask is None else np.where(mask, dist, np.inf)
                want = np.argsort(dd, axis=1)[:, :k]
                hits = np.mean([len(set(ids[i]) & set(want[i])) / k
                                for i in range(len(q))])
                # isotropic d 32 data is hard for the int8 coarse pass
                # (0.975 unfiltered on the first run)
                assert hits >= 0.95
                if mask is not None:
                    assert mask[ids].all()


@pytest.mark.cuda
@pytest.mark.parametrize("filtered", [False, True])
def test_hnsw_walk_on_the_card_matches_the_cpu(dev, filtered):
    """The SoA walk over one graph, on the card and on the CPU: the same
    ids on >= 99% of the rows."""
    rng = np.random.default_rng(9)
    n, d = 6000, 32
    vecs = rng.standard_normal((n, d)).astype(np.float32)
    cpu = HnswVectorIndex(dim=d, m=8, ef_construction=40,
                          device=torch.device("cpu"))
    cpu.bulk_load([f"k{i}" for i in range(n)], vecs)
    for i in range(0, n, 20):
        cpu.remove_record(f"k{i}")
    card = HnswVectorIndex.from_reference(
        _hnsw_state(cpu), dict(cpu.interner.items()), dev)
    q = rng.standard_normal((128, d)).astype(np.float32)
    allowed = rng.random(cpu.store.capacity) < 0.1
    with _Options(hnsw_scan_threshold=0, hnsw_aos_budget_bytes=0):
        masks = [None, None] if not filtered else [
            torch.from_numpy(allowed), torch.from_numpy(allowed).to(dev)]
        _, want = cpu.search_batch(q, 10, ef=50, filter_mask=masks[0])
        _, got = card.search_batch(q, 10, ef=50, filter_mask=masks[1])
    assert (got == want).all(1).mean() >= 0.99
    assert not np.isin(got, np.arange(0, n, 20)).any()


@pytest.mark.cuda
def test_hnsw_short_filter_mask_does_not_assert(dev):
    """A predicate mask shorter than the doc space, on the card: no
    device-side assert on the walk or the scan route, and no doc past the
    mask's end."""
    rng = np.random.default_rng(10)
    n, d = 5000, 16
    vecs = rng.standard_normal((n, d)).astype(np.float32)
    index = HnswVectorIndex(dim=d, m=8, ef_construction=40, device=dev)
    index.bulk_load([f"k{i}" for i in range(n)], vecs)
    short = torch.ones(n // 2, dtype=torch.bool, device=dev)
    q = rng.standard_normal((16, d)).astype(np.float32)
    for thresh in (1 << 30, 0):
        with _Options(hnsw_scan_threshold=thresh):
            _, ids = index.search_batch(q, 10, ef=40, filter_mask=short)
            torch.cuda.synchronize()
            assert (ids >= 0).all() and (ids < n // 2).all()


def _clustered(rng, n, d, centers=16, spread=0.08):
    c = rng.normal(size=(centers, d)).astype(np.float32)
    a = rng.integers(0, centers, size=n)
    return (c[a] + spread * rng.normal(size=(n, d))).astype(np.float32)


def _ivf_on(index, device):
    return ivf.IvfIndex(*(t.to(device) for t in index))


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["grouped", "steps"])
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_ivf_search_on_the_card_matches_the_cpu(dev, route, metric):
    """One IVF index built on the CPU and carried to the card: both stage-2
    routes give the CPU's ids on >= 99% of the rows, distances within 1e-5
    of the terms they are summed from, and stay inside a 1-D mask."""
    rng = np.random.default_rng(11)
    x = _clustered(rng, 8192, 32)
    if metric == "ip":
        x /= np.linalg.norm(x, axis=1, keepdims=True)
    cpu = ivf.build_ivf(x, block_rows=128, n_clusters=8, train_sample=4096,
                        device=torch.device("cpu"))
    card = _ivf_on(cpu, dev)
    q = x[rng.integers(0, len(x), 192)] + 0.03 * rng.normal(
        size=(192, 32)).astype(np.float32)
    mask = np.arange(len(x)) % 3 != 0
    search = getattr(ivf, f"_ivf_search_batch_{route}")
    kw = dict(k=10, probe=8, metric=metric)
    if route == "steps":
        kw["probe_chunk"] = 3
    for m in (None, mask):
        wd, wi = search(cpu, torch.from_numpy(q), filter_mask=None if m is None
                        else torch.from_numpy(m), **kw)
        gd, gi = search(card, torch.from_numpy(q).to(dev),
                        filter_mask=None if m is None
                        else torch.from_numpy(m).to(dev), **kw)
        gd, gi, wd, wi = (a.cpu().numpy() for a in (gd, gi, wd, wi))
        assert (gi == wi).all(1).mean() >= 0.99
        same = (gi == wi) & (wi >= 0)
        scale = ((q * q).sum(1)[:, None] + (x * x).sum(1)[np.maximum(wi, 0)]
                 if metric == "l2" else np.ones_like(wd))
        assert (np.abs(gd - wd)[same] <= 1e-5 * scale[same]).all()
        if m is not None:
            assert m[gi[gi >= 0]].all()


@pytest.mark.cuda
def test_ivf_build_and_engine_route_on_the_card(dev):
    """A FLAT index on the card over search.ivf-threshold: the first search
    builds the mirror with build_ivf_device, the rescored route serves it,
    a deleted row never comes back and an update comes first through the
    delta overlay, without a rebuild."""
    from valkey_search_tpu_torch.runtime.metrics import STATS

    rng = np.random.default_rng(12)
    n, d = 20_000, 32
    x = _clustered(rng, n, d, centers=64)
    index = FlatVectorIndex(dim=d, device=dev)
    index.bulk_load([f"k{i}" for i in range(n)], x)
    q = x[rng.integers(0, n, 256)] + 0.03 * rng.normal(
        size=(256, d)).astype(np.float32)
    with _Options(ivf_threshold=10_000, ivf_block_rows=128):
        builds = STATS.get("ivf_mirror_builds")
        served = STATS.get("ivf_served_searches")
        bs.reset_launches()
        _, ids = index.search_batch(q, 10)
        assert STATS.get("ivf_mirror_builds") - builds == 1
        assert STATS.get("ivf_served_searches") - served == len(q)
        assert sum(bs.launch_counts().values()) == 0
        dist = ((x[None, :, :] - q[:, None, :]) ** 2).sum(-1)
        want = np.argsort(dist, axis=1)[:, :10]
        assert np.mean([len(set(ids[i]) & set(want[i])) / 10
                        for i in range(len(q))]) >= 0.95
        gone = [int(i) for i in ids[:4, 0]]
        for doc in gone:
            index.remove_record(f"k{doc}")
        index.add_record("k7", q[5])
        d2, ids2 = index.search_batch(q, 10)
        assert not np.isin(ids2, gone).any()
        assert index.interner.key_of(int(ids2[5, 0])) == "k7"
        assert abs(d2[5, 0]) <= 1e-5 * float(q[5] @ q[5])
        assert STATS.get("ivf_mirror_builds") - builds == 1


def _flat_engine(rows, dtype):
    from valkey_search_tpu_torch.server.engine import Engine

    e = Engine()
    e.config_set("search.corpus-dtype", dtype)
    e.execute("FT.CREATE", "i", "SCHEMA", "v", "VECTOR", "FLAT", "6", "TYPE",
              "FLOAT32", "DIM", str(rows.shape[1]), "DISTANCE_METRIC", "L2")
    for i, v in enumerate(rows):
        e.execute("HSET", f"k{i}", "v", v.tobytes())
    return e


def _knn_replies(engine, queries):
    return [engine.execute("FT.SEARCH", "i", "*=>[KNN 10 @v $q]", "PARAMS",
                           "2", "q", q.tobytes(), "RETURN", "1", "__v_score")
            for q in queries]


@pytest.mark.cuda
def test_forked_bgsave_after_a_launch_on_the_card(dev, tmp_path):
    """BGSAVE forks a process that holds a CUDA context after K2 has
    launched in it: the child writes the checkpoint from host arrays alone
    and exits 0, the file restores to equal bfloat16 replies, and the
    parent's next KNN launches again."""
    import time

    from valkey_search_tpu_torch.server.engine import Engine
    from valkey_search_tpu_torch.server.resp import RespServer

    rng = np.random.default_rng(21)
    rows = rng.standard_normal((140_000, 64)).astype(np.float32)
    queries = rows[:32] + 0.01
    saved = config.get("search.corpus-dtype")
    try:
        e = _flat_engine(rows, "bfloat16")
        bs.reset_launches()
        before = _knn_replies(e, queries)
        assert bs.launch_counts().get("bucket_scan_bf16", 0) > 0
        srv = RespServer(e, port=0)
        path = str(tmp_path / "fork.vstpu")
        srv.bgsave_forked(path)
        deadline = time.monotonic() + 120
        while srv.bgsave_pid is not None and time.monotonic() < deadline:
            time.sleep(0.05)
        assert srv.bgsave_status == "ok"
        bs.reset_launches()
        assert _knn_replies(e, queries) == before
        assert bs.launch_counts().get("bucket_scan_bf16", 0) > 0
        assert _knn_replies(Engine.load(path), queries) == before
    finally:
        config.set_config("search.corpus-dtype", saved)


@pytest.mark.cuda
def test_a_restore_publishes_to_the_card_at_its_first_query(dev, tmp_path):
    from valkey_search_tpu_torch.server.engine import Engine

    rng = np.random.default_rng(22)
    rows = rng.standard_normal((3000, 32)).astype(np.float32)
    saved = config.get("search.corpus-dtype")
    try:
        e = _flat_engine(rows, "int8")
        before = _knn_replies(e, rows[:8])
        path = str(tmp_path / "r.vstpu")
        e.save(path)
        back = Engine.load(path)
        st = back.manager.get("i").attribute("v").index.store
        assert st.device == dev and st._device is None
        assert _knn_replies(back, rows[:8]) == before
        assert st._device["vectors_i8"].device == dev
        assert float(st._device["i8_scale"]) == float(
            e.manager.get("i").attribute("v").index.store._device["i8_scale"])
    finally:
        config.set_config("search.corpus-dtype", saved)


def _cluster_knn(cluster, queries):
    return [cluster.execute("FT.SEARCH", "i", "*=>[KNN 10 @v $q]", "PARAMS",
                            "2", "q", q.tobytes(), "RETURN", "1",
                            "__v_score") for q in queries]


@pytest.mark.cuda
def test_cluster_engine_fans_knn_out_over_k2_on_every_shard(dev):
    """ClusterEngine(n_nodes=3) on the card over 3 x ~132,000 rows (a FLAT
    store grows in 2,048-row steps; from 129,025 rows its capacity reaches
    131,072, where the fused scan serves): bfloat16 KNN replies equal the
    CPU port's (keys in order, or distances within rounding where keys
    tie), and K2 launches once a shard a query."""
    from valkey_search_tpu_torch.cluster.node import ClusterEngine

    rng = np.random.default_rng(31)
    rows = rng.standard_normal((396_000, 64)).astype(np.float32)
    queries = rows[rng.integers(0, len(rows), 16)] + 0.01
    saved = config.get("search.corpus-dtype")
    replies = []
    try:
        config.set_config("search.corpus-dtype", "bfloat16")
        for device in ("cuda", "cpu"):
            set_device(device)
            c = ClusterEngine(n_nodes=3)
            c.execute("FT.CREATE", "i", "SCHEMA", "v", "VECTOR", "FLAT", "6",
                      "TYPE", "FLOAT32", "DIM", "64", "DISTANCE_METRIC", "L2")
            for i, v in enumerate(rows):
                c.hset(f"k{i}", {"v": v.tobytes()})
            sizes = [len(n.engine.keyspace) for n in c.nodes]
            assert min(sizes) > 129_024, sizes
            _cluster_knn(c, queries[:1])  # publish
            bs.reset_launches()
            replies.append(_cluster_knn(c, queries))
            if device == "cuda":
                assert bs.launch_counts().get("bucket_scan_bf16", 0) == (
                    3 * len(queries))
                st = c.nodes[0].engine.manager.get("i").attribute("v").index
                assert st.store.device.type == "cuda"
    finally:
        set_device("cuda")
        config.set_config("search.corpus-dtype", saved)
    for got, want, q in zip(replies[0], replies[1], queries):
        keys_g, keys_w = got[1::2], want[1::2]
        dist_g = [float(r[1]) for r in got[2::2]]
        dist_w = [float(r[1]) for r in want[2::2]]
        tol = 1e-5 * float(q @ q)
        assert keys_g == keys_w or np.allclose(dist_g, dist_w, atol=2 * tol)
        assert keys_g[0] == keys_w[0]


@pytest.mark.cuda
def test_a_node_process_serves_knn_on_the_card_by_default(dev):
    """python -m valkey_search_tpu_torch.cluster.transport with no
    --device: the node's stores live on cuda:0, it answers _NODE.ID and a
    KNN, and stops on SIGTERM."""
    import os
    import subprocess
    import sys

    from valkey_search_tpu_torch.cluster.transport import RespConnection

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo)
    proc = subprocess.Popen(
        [sys.executable, "-m", "valkey_search_tpu_torch.cluster.transport",
         "--node-id", "g0", "--port", "0"], stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL, env=env, text=True)
    try:
        line = proc.stdout.readline().strip()
        assert line.startswith("READY "), line
        c = RespConnection(("127.0.0.1", int(line.split()[1])))
        assert c.cmd("_NODE.ID") == b"g0"
        assert c.cmd("FT.CREATE", "i", "SCHEMA", "v", "VECTOR", "FLAT", "6",
                     "TYPE", "FLOAT32", "DIM", "16", "DISTANCE_METRIC",
                     "L2") == "OK"
        rows = np.random.default_rng(32).standard_normal((200, 16)).astype(
            np.float32)
        for i, v in enumerate(rows):
            c.cmd("HSET", f"k{i}", "v", v.tobytes())
        reply = c.cmd("FT.SEARCH", "i", "*=>[KNN 3 @v $q]", "PARAMS", "2",
                      "q", rows[7].tobytes(), "NOCONTENT")
        assert reply[0] == 3 and reply[1] == b"k7"
        c.close()
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=30)


@pytest.mark.cuda
def test_mesh_of_four_on_one_card_matches_unsharded(dev):
    """Four shards on cuda:0 (make_mesh cycles the visible cards): the
    sharded exact and IVF searches against the unsharded ones on the card,
    and dryrun_multichip(4) to its end."""
    from valkey_search_tpu_torch import entry
    from valkey_search_tpu_torch.parallel import mesh as pm

    mesh = pm.make_mesh(4)
    assert pm.shard_devices(mesh) == pm.cycle_devices(
        pm.visible_devices(), 4)
    rng = np.random.default_rng(41)
    x = _clustered(rng, 16384, 32)
    q = x[rng.integers(0, len(x), 64)] + 0.03 * rng.normal(
        size=(64, 32)).astype(np.float32)
    xt, qt = torch.from_numpy(x).to(dev), torch.from_numpy(q).to(dev)
    d, i, v = pm.sharded_flat_topk(mesh, xt, qt, k=10)
    wd, wi = topk.flat_topk(qt, xt, k=10, block_rows=len(x))
    assert i.device == xt.device and torch.equal(i, wi)
    assert torch.allclose(d, wd, rtol=1e-5, atol=1e-5)
    assert v.tolist() == [0, 0]
    index = ivf.build_ivf(x, block_rows=128, n_clusters=8, train_sample=4096,
                          device=dev)
    sd, si = pm.sharded_ivf_topk(mesh, index, qt, k=10,
                                 probe=index.n_blocks)
    ud, ui = ivf.ivf_search_batch(index, qt, k=10, probe=index.n_blocks)
    assert (si == ui).all(1).float().mean().item() >= 0.99
    entry.dryrun_multichip(4)


@pytest.mark.cuda
def test_streaming_build_holds_less_than_its_corpus(dev):
    """build_ivf_streaming from chunks generated on the card: every row in
    one slot, and the peak allocation during the build below the fp32
    corpus's bytes (the corpus is never resident)."""
    n_chunks, ch, d = 32, 65536, 128
    centers = torch.from_numpy(np.random.default_rng(42).standard_normal(
        (256, d)).astype(np.float32) * 60 + 128).to(dev)

    def chunk(ci):
        gen = torch.Generator(device=dev).manual_seed(7000 + ci)
        a = torch.randint(0, 256, (ch,), generator=gen, device=dev)
        z = torch.randn((ch, d), generator=gen, device=dev)
        return (centers[a] + z * 20).clamp_(0, 255)

    assert torch.equal(chunk(3), chunk(3))
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    # the sample and the sub-slices small beside the corpus: the k-means
    # fit's [rows, clusters] products do not shrink with the corpus
    index = ivf.build_ivf_streaming(chunk, n_chunks, block_rows=256,
                                    block_align=8, train_sample=16384,
                                    sub_rows=16384)
    peak = torch.cuda.max_memory_allocated(dev) - base
    assert peak < n_chunks * ch * d * 4, (peak, index.device_bytes())
    ids = index.block_ids.cpu().numpy().reshape(-1)
    live = ids[ids >= 0]
    assert len(live) == n_chunks * ch and len(np.unique(live)) == len(live)
    q = chunk(0)[:32] + 0.5
    _, ids = ivf.ivf_search_rescored_streaming(
        index, q, chunk, n_chunks, ch, k=1, probe=32)
    assert (ids[:, 0].cpu() == torch.arange(32)).float().mean() >= 0.9


@pytest.mark.cuda
def test_sharded_hnsw_with_a_mask_on_the_card(dev):
    """ShardedHnswIndex with its four shards on the card: the walk finds a
    row itself, stays inside a doc-space mask, and a removed key never
    returns; the same keys on a CPU mesh give the same results."""
    from valkey_search_tpu_torch.parallel import fanout
    from valkey_search_tpu_torch.parallel import mesh as pm

    rng = np.random.default_rng(43)
    x = rng.standard_normal((2000, 16)).astype(np.float32)
    out = {}
    for where in ("cuda", "cpu"):
        mesh = pm.make_mesh(4, devices=pm.cycle_devices(
            pm.visible_devices(where), 4))
        idx = fanout.ShardedHnswIndex(dim=16, m=8, ef_construction=60,
                                      mesh=mesh)
        for i, v in enumerate(x):
            idx.add_record(f"k{i}", v)
        assert all(s.store.device.type == where for s in idx.shards)
        allowed = np.zeros(idx.interner.capacity, bool)
        for i in range(0, 2000, 7):
            allowed[idx.interner.lookup(f"k{i}")] = True
        mask = torch.from_numpy(allowed)
        if where == "cuda":
            mask = mask.to(dev)
        d, docs = idx.search_batch(x[:32], k=10, ef=64, filter_mask=mask)
        assert allowed[docs[docs >= 0]].all()
        d0, docs0 = idx.search_batch(x[:32], k=1, ef=64)
        assert [idx.interner.key_of(int(v)) for v in docs0[:, 0]] == [
            f"k{i}" for i in range(32)]
        idx.remove_record("k5")
        _, docs5 = idx.search_batch(x[5:6], k=5, ef=64)
        assert "k5" not in {idx.interner.key_of(int(v)) for v in docs5[0]
                            if v >= 0}
        out[where] = (d, docs)
    assert (out["cuda"][1] == out["cpu"][1]).all(1).mean() >= 0.99
    # a row's distance to itself cancels to ~0 (+-2e-6): atol beside rtol
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-5,
                               atol=1e-4)


@pytest.mark.cuda
def test_sharded_exact_search_reaches_the_fused_scan_on_every_shard(dev):
    """ShardedHnswIndex.exact_search_batch over four shards of ~70,000 rows
    on the card (capacity 131,072 each, each shard's device bulk build):
    each shard's scan launches K1 under int8 and K2 under bfloat16, the
    doc-space mask moves to the shards' device, and the host merge agrees
    with the unsharded fp32 flat_topk."""
    from valkey_search_tpu_torch.parallel import fanout
    from valkey_search_tpu_torch.parallel import mesh as pm

    rng = np.random.default_rng(44)
    n, d, k = 280_000, 32, 10
    x = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((16, d)).astype(np.float32)
    idx = fanout.ShardedHnswIndex(dim=d, m=8, ef_construction=40,
                                  mesh=pm.make_mesh(4))
    keys = [f"k{i}" for i in range(n)]
    owner = np.array([idx.shard_of(key) for key in keys])
    for s, shard in enumerate(idx.shards):
        rows = np.nonzero(owner == s)[0]
        shard.bulk_load([keys[i] for i in rows], x[rows])
    assert [s.store.capacity for s in idx.shards] == [131072] * 4
    docs_of = np.array([idx.interner.lookup(key) for key in keys])
    ok_rows = rng.random(n) < 0.2
    allowed = np.zeros(idx.interner.capacity, bool)
    allowed[docs_of[ok_rows]] = True
    qt, xt = torch.from_numpy(q).to(dev), torch.from_numpy(x).to(dev)
    for dtype, kernel in (("int8", "bucket_scan_i8_packed[pre_shift=0]"),
                          ("bfloat16", "bucket_scan_bf16")):
        with _Options(corpus_dtype=dtype):
            for rows_ok in (None, ok_rows):
                fm = None if rows_ok is None else torch.from_numpy(
                    allowed).to(dev)
                _, want = topk.flat_topk(
                    qt, xt, k, block_rows=n,
                    filter_mask=None if rows_ok is None
                    else torch.from_numpy(rows_ok).to(dev))
                want = docs_of[want.cpu().numpy()]
                bs.reset_launches()
                _, docs = idx.exact_search_batch(q, k, filter_mask=fm)
                assert bs.launch_counts()[kernel] == 4
                hits = np.mean([len(set(a) & set(b)) / k
                                for a, b in zip(docs, want)])
                # test_hnsw_scan_route_launches_k1_and_k2's floor for
                # isotropic d 32 under the int8 coarse pass
                assert hits >= 0.95
                if rows_ok is not None:
                    assert allowed[docs].all()
