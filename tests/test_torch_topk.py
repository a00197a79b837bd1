"""The port's top-k paths against the JAX package's, on the same numpy inputs.

flat_topk_fused runs the JAX side with ``interpret=True`` (its Pallas
kernels in interpret mode) and the port's side through the plain versions
of K1/K2, since the tensors lie on the CPU. Corpora are Gaussian, so no two
distances tie.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from valkey_search_tpu.ops import distance as jdist
from valkey_search_tpu.ops import pallas_scan as ps
from valkey_search_tpu.ops import topk as jtopk
from valkey_search_tpu_torch.ops import distance as tdist
from valkey_search_tpu_torch.ops import topk as ttopk
from valkey_search_tpu_torch.runtime.device import set_device
from torch_port_config import saved_options, set_both


@pytest.fixture(autouse=True)
def _cpu():
    set_device("cpu")


@pytest.fixture()
def scan_kernel():
    with saved_options("search.scan-kernel"):
        yield


def _t(x):
    return torch.from_numpy(np.array(x))  # a writable copy


def _corpus(rng, b, n, d):
    q = rng.standard_normal((b, d)).astype(np.float32)
    c = rng.standard_normal((n, d)).astype(np.float32)
    return q, c


def _i8_mirror(c):
    """The JAX store's int8 mirror and scale (vector_base.device_snapshot)."""
    v = jnp.asarray(c)
    scale = jnp.maximum(jnp.max(jnp.abs(v)) / 127.0, 1e-30).astype(jnp.float32)
    return jnp.clip(jnp.round(v / scale), -127, 127).astype(jnp.int8), scale


def _recall(got, want):
    k = want.shape[1]
    return np.mean([len(set(got[i]) & set(want[i])) / k
                    for i in range(len(want))])


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("span,block_rows", [
    (None, 1 << 20),         # span 1 (pre_shift 0), one block
    (None, ps.GROUP),        # span 1, three blocks merged
    (2, 1 << 20),            # span 2 (pre_shift 1 at d_pad 128)
])
def test_fused_int8_matches_jax(rng, metric, span, block_rows):
    b, n, d, k = 8, 2 * ps.GROUP + 300, 64, 10  # n pads to whole groups
    q, c = _corpus(rng, b, n, d)
    c_i8, scale = _i8_mirror(c)
    sq = (c ** 2).sum(1).astype(np.float32)
    invalid = rng.random(n) < 0.03
    allowed = rng.random(n) < 0.8
    jd, ji = jtopk.flat_topk_fused(
        jnp.asarray(q), jnp.asarray(c), None, k=k, metric=metric,
        corpus_sq=jnp.asarray(sq), invalid=jnp.asarray(invalid),
        filter_mask=jnp.asarray(allowed), block_rows=block_rows,
        corpus_i8=c_i8, i8_scale=scale, span=span, interpret=True)
    td, ti = ttopk.flat_topk_fused(
        _t(q), _t(c), None, k=k, metric=metric, corpus_sq=_t(sq),
        invalid=_t(invalid), filter_mask=_t(allowed), block_rows=block_rows,
        corpus_i8=_t(c_i8), i8_scale=_t(scale), span=span)
    ji = np.asarray(ji)
    np.testing.assert_array_equal(ti.numpy(), ji)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5)
    assert (allowed[ji] & ~invalid[ji]).all()


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("block_rows", [1 << 20, ps.GROUP])
def test_fused_bf16_matches_jax(rng, metric, block_rows):
    b, n, d, k = 8, 2 * ps.GROUP + 300, 64, 10
    q, c = _corpus(rng, b, n, d)
    allowed = rng.random(n) < 0.8
    jd, ji = jtopk.flat_topk_fused(
        jnp.asarray(q), jnp.asarray(c), jnp.asarray(c, jnp.bfloat16), k=k,
        metric=metric, filter_mask=jnp.asarray(allowed),
        block_rows=block_rows, interpret=True)
    c_lp = np.asarray(jnp.asarray(c, jnp.bfloat16).astype(jnp.float32))
    td, ti = ttopk.flat_topk_fused(
        _t(q), _t(c), _t(c_lp).to(torch.bfloat16), k=k, metric=metric,
        filter_mask=_t(allowed), block_rows=block_rows)
    assert _recall(ti.numpy(), np.asarray(ji)) >= 0.99
    assert allowed[ti.numpy()].all()
    assert (np.diff(td.numpy(), axis=1) >= 0).all()


@pytest.mark.parametrize("d,copied", [(40, False), (36, True)])
def test_fused_bf16_scans_the_mirror_in_place(rng, monkeypatch, d, copied):
    """K2 needs only d % 8 == 0: at d 40 the corpus it is handed is the bf16
    mirror itself, not a padded copy (d 36 still pads to 40)."""
    seen = []
    scan = ttopk.bs.bucket_min_scan

    def spy(queries, qsq, corpus, bias, positive):
        seen.append((queries.shape[1], corpus.shape[1], corpus.data_ptr()))
        return scan(queries, qsq, corpus, bias, positive)

    monkeypatch.setattr(ttopk.bs, "bucket_min_scan", spy)
    q, c = _corpus(rng, 3, 1000, d)
    lp = _t(c).to(torch.bfloat16)
    ttopk.flat_topk_fused(_t(q), _t(c), lp, k=5)
    assert len(seen) == 1
    width = ttopk.bs.round_up(d, 8)
    assert seen[0][:2] == (width, width)
    assert (seen[0][2] == lp.data_ptr()) is not copied


@pytest.mark.parametrize("metric", ["l2", "ip", "cosine"])
@pytest.mark.parametrize("mode", ["exact", "approx"])
def test_flat_topk_matches_jax(rng, metric, mode):
    b, n, d, k = 6, 4096, 32, 10
    q, c = _corpus(rng, b, n, d)
    invalid = rng.random(n) < 0.05
    allowed = rng.random((b, n)) < 0.7  # per-query filter, multi-block
    kw = dict(k=k, metric=metric, block_rows=1024, mode=mode)
    jd, ji = jtopk.flat_topk(
        jnp.asarray(q), jnp.asarray(c), invalid=jnp.asarray(invalid),
        filter_mask=jnp.asarray(allowed), **kw)
    td, ti = ttopk.flat_topk(_t(q), _t(c), invalid=_t(invalid),
                             filter_mask=_t(allowed), **kw)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5)


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_flat_topk_two_stage_matches_jax(rng, metric):
    b, n, d, k = 6, 3000, 32, 10
    q, c = _corpus(rng, b, n, d)
    sq = (c ** 2).sum(1).astype(np.float32)
    invalid = rng.random(n) < 0.05
    c_lp = jnp.asarray(c, jnp.bfloat16)
    jd, ji = jtopk.flat_topk_two_stage(
        jnp.asarray(q), jnp.asarray(c), c_lp, k=k, metric=metric,
        corpus_sq=jnp.asarray(sq), invalid=jnp.asarray(invalid))
    td, ti = ttopk.flat_topk_two_stage(
        _t(q), _t(c), _t(np.asarray(c_lp.astype(jnp.float32))).to(torch.bfloat16),
        k=k, metric=metric, corpus_sq=_t(sq), invalid=_t(invalid))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5)


def test_tiny_corpus_pads_to_k(rng):
    q, c = _corpus(rng, 3, 4, 8)
    jd, ji = jtopk.flat_topk(jnp.asarray(q), jnp.asarray(c), k=6)
    td, ti = ttopk.flat_topk(_t(q), _t(c), k=6)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert (ti.numpy()[:, 4:] == -1).all() and np.isinf(td.numpy()[:, 4:]).all()


def test_ties_break_to_the_lower_index():
    vals = np.array([[3.0, 1.0, 2.0, 1.0, 1.0, 0.5]], np.float32)
    jv, jp = jtopk.merge_topk(
        jnp.asarray(vals[:, :3]), jnp.arange(3)[None],
        jnp.asarray(vals[:, 3:]), jnp.arange(3, 6)[None], 4)
    tv, tp = ttopk.merge_topk(
        _t(vals[:, :3]), torch.arange(3)[None],
        _t(vals[:, 3:]), torch.arange(3, 6)[None], 4)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    keys = torch.tensor([[7, 3, 3, 9, 3]], dtype=torch.int32)
    v, p = ttopk.topk_smallest(keys, 3)
    assert p.tolist() == [[1, 2, 4]] and v.tolist() == [[3, 3, 3]]


def test_use_fused_scan_routing(scan_kernel):
    big = torch.zeros((131072, 4))
    set_both("search.scan-kernel", "auto")
    assert not ttopk.use_fused_scan(131072, None, big)  # CPU corpus
    set_both("search.scan-kernel", "pallas")
    assert ttopk.use_fused_scan(131072, None, big)
    assert ttopk.use_fused_scan(131072, torch.ones(131072, dtype=torch.bool),
                                big)
    assert not ttopk.use_fused_scan(131071, None, big)
    assert not ttopk.use_fused_scan(
        131072, torch.ones((2, 131072), dtype=torch.bool), big)
    set_both("search.scan-kernel", "xla")
    assert not ttopk.use_fused_scan(131072, None, big)


@pytest.mark.parametrize("metric", ["l2", "ip", "cosine"])
def test_distance_ops_match_jax(rng, metric):
    q, c = _corpus(rng, 5, 300, 24)
    cands = rng.standard_normal((5, 7, 24)).astype(np.float32)
    np.testing.assert_allclose(tdist.squared_norms(_t(c)).numpy(),
                               np.asarray(jdist.squared_norms(c)), rtol=1e-6)
    tn, tm = tdist.normalize_rows(_t(c))
    jn, jm = jdist.normalize_rows(c)
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), rtol=1e-6)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-6)
    np.testing.assert_allclose(
        tdist.pairwise_scores(_t(q), _t(c), metric).numpy(),
        np.asarray(jdist.pairwise_scores(q, c, metric)), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        tdist.batched_candidate_scores(_t(q), _t(cands), metric).numpy(),
        np.asarray(jdist.batched_candidate_scores(q, cands, metric)),
        rtol=1e-5, atol=1e-5)


# -- the CUDA graph of the fused launch (ops/fused_graphs.py), on the CPU ----
# What decides a graph, its key, the cache's snapshot rule and what the CPU
# path leaves untouched; the graphs themselves run in tests/test_torch_cuda.py.

from valkey_search_tpu_torch.indexes.flat import FlatVectorIndex
from valkey_search_tpu_torch.ops import bucket_scan as tbs
from valkey_search_tpu_torch.ops import fused_graphs
from valkey_search_tpu_torch.runtime.metrics import STATS

_CUDA = torch.device("cuda", 0)
_CPU = torch.device("cpu")


@pytest.mark.parametrize("b,device,filtered,takes", [
    (1, _CUDA, False, True),
    (7, _CUDA, False, True),
    (128, _CUDA, False, True),
    (129, _CUDA, False, False),   # past K1's and K2's largest query tile
    (0, _CUDA, False, False),
    (1, _CUDA, True, False),      # a filtered launch stays eager
    (1, _CPU, False, False),      # the plain versions on the CPU
])
def test_which_fused_launches_take_a_graph(b, device, filtered, takes):
    assert fused_graphs.GRAPH_MAX_B == 128
    assert fused_graphs.takes_graph(b, device, filtered) is takes


def test_the_graph_key_holds_all_that_shapes_the_launch():
    cap, d = 1_048_576, 8
    corpus = torch.empty((cap, d))
    lp = torch.empty((cap, d), dtype=torch.bfloat16)
    i8 = torch.empty((cap, d), dtype=torch.int8)
    plan = ttopk.fused_plan(1, corpus, None, i8, cap)
    assert plan == ttopk.FusedPlan(True, 8, 4, cap, cap)
    key = fused_graphs.graph_key(1, 10, "l2", plan)
    assert key == fused_graphs.graph_key(
        1, 10, "l2", ttopk.fused_plan(1, corpus, None, i8, cap))
    others = [
        fused_graphs.graph_key(2, 10, "l2", plan),
        fused_graphs.graph_key(1, 100, "l2", plan),
        fused_graphs.graph_key(1, 10, "cosine", plan),
        fused_graphs.graph_key(1, 10, "l2", ttopk.fused_plan(
            1, corpus, lp, None, cap)),                  # K2's mirror
        fused_graphs.graph_key(1, 10, "l2", ttopk.fused_plan(
            1, corpus, None, i8, cap, span=4)),          # search.scan-span
        fused_graphs.graph_key(1, 10, "l2", ttopk.fused_plan(
            1, corpus, None, i8, cap, coarse_factor=6)),  # coarse factor
        fused_graphs.graph_key(1, 10, "l2", ttopk.fused_plan(
            1, corpus, None, i8, cap // 4)),             # the block split
    ]
    assert len({key, *others}) == len(others) + 1


def test_the_plan_reads_the_device_memory_once(monkeypatch):
    calls = []

    def mem_get_info(device):
        calls.append(device)
        return 1 << 30, 80 << 30

    monkeypatch.setattr(torch.cuda, "mem_get_info", mem_get_info)
    monkeypatch.setattr(ttopk, "_TOTAL_MEMORY", {})
    dev = torch.device("cuda", 3)
    assert ttopk._memory_limit(dev) == 80 << 30
    assert ttopk._memory_limit(dev) == 80 << 30
    assert calls == [dev]
    assert ttopk._memory_limit(_CPU) == ttopk._DEFAULT_MEMORY_LIMIT


@pytest.mark.parametrize("int8", [True, False])
def test_a_given_plan_is_the_plan_the_launch_makes(rng, int8):
    q, c = _corpus(rng, 3, 3 * ps.GROUP + 70, 16)
    corpus = _t(c)
    kw = dict(k=10, corpus_sq=(corpus * corpus).sum(1), block_rows=ps.GROUP)
    if int8:
        scale = torch.clamp_min(corpus.abs().max() / 127.0, 1e-30)
        kw.update(corpus_i8=torch.clamp(torch.round(corpus / scale), -127,
                                        127).to(torch.int8), i8_scale=scale)
        lp = None
    else:
        lp = corpus.to(torch.bfloat16)
    plan = ttopk.fused_plan(3, corpus, lp, kw.get("corpus_i8"), ps.GROUP)
    assert plan.block_rows == ps.GROUP and plan.n == 4 * ps.GROUP
    d0, i0 = ttopk.flat_topk_fused(_t(q), corpus, lp, **kw)
    kw.pop("block_rows")
    d1, i1 = ttopk.flat_topk_fused(_t(q), corpus, lp, plan=plan, **kw)
    assert torch.equal(i0, i1)
    assert torch.equal(d0.view(torch.int32), d1.view(torch.int32))


class _Store:
    """A store that takes weak references, as HostVectorStore does."""


def test_the_graphs_belong_to_one_snapshot():
    graphs = fused_graphs.FusedGraphs(size=2)
    store, other = _Store(), _Store()
    assert graphs._lookup(store, 5, "a") == (True, None)
    graphs._keep(store, 5, "a", "graph a")
    graphs._keep(store, 5, "b", "graph b")
    assert graphs._lookup(store, 5, "a") == (True, "graph a")
    graphs._keep(store, 5, "c", "graph c")   # over the bound: b, the
    assert len(graphs) == 2                  # least recently replayed, goes
    assert graphs._lookup(store, 5, "b") == (True, None)
    # a launch that holds an older snapshot runs eagerly, and keeps nothing
    assert graphs._lookup(store, 4, "a") == (False, None)
    graphs._keep(store, 4, "d", "graph d")
    assert len(graphs) == 2
    # a newer snapshot drops every graph of the old one
    assert graphs._lookup(store, 6, "a") == (True, None)
    assert len(graphs) == 0
    graphs._keep(store, 5, "a", "graph a")   # captured on the old one
    assert len(graphs) == 0
    graphs._keep(store, 6, "a", "graph a")
    # another store (an index's store replaced) at any epoch: dropped too
    assert graphs._lookup(other, 1, "a") == (True, None)
    assert len(graphs) == 0


@pytest.mark.parametrize("filtered", [False, True])
def test_a_cpu_corpus_captures_nothing(rng, scan_kernel, filtered):
    """The fused launch on a CPU corpus (its plain versions) runs eagerly:
    no graph, and both counters stay where they were."""
    set_both("search.scan-kernel", "pallas")
    n, d = 131_072, 8
    c = rng.standard_normal((n, d)).astype(np.float32)
    index = FlatVectorIndex(dim=d, device="cpu")
    index.bulk_load([f"k{i}" for i in range(n)], c)
    with saved_options("search.corpus-dtype", "search.topk-mode"):
        set_both("search.corpus-dtype", "int8")
        set_both("search.topk-mode", "approx")
        before = {n: STATS.get(n) for n in ("flat_graph_captures",
                                            "flat_graph_replays")}
        launches = tbs.launch_counts()
        mask = torch.ones(n, dtype=torch.bool) if filtered else None
        for _ in range(2):
            _, ids = index.search_batch(c[:1], 10, filter_mask=mask)
            assert ids[0, 0] == 0
    assert len(index._graphs) == 0
    assert {n: STATS.get(n) for n in before} == before
    assert tbs.launch_counts() == launches  # the plain versions count none


def _former_bias_i8_packed(n, d_pad, span, metric, corpus_sq, inv_two,
                           invalid, filter_mask):
    """make_bias_i8_packed as it was, with its fill made as a tensor."""
    dotmax, bias_clamp, sentinel, _, _ = tbs.i8_packed_layout(d_pad, span)
    if metric == "l2":
        f = corpus_sq.to(torch.float32) * inv_two
        bias = torch.clamp(torch.round(f), 0, bias_clamp).to(torch.int32)
    else:
        bias = torch.zeros((n,), dtype=torch.int32)
    bias = bias + dotmax
    fill = torch.tensor(sentinel, dtype=torch.int32)
    if invalid is not None:
        bias = torch.where(invalid, fill, bias)
    if filter_mask is not None:
        bias = torch.where(filter_mask, bias, fill)
    return bias


def _former_bias(n, metric, corpus_sq, invalid, filter_mask):
    """make_bias as it was, with its +inf made as a tensor."""
    bias = (corpus_sq.to(torch.float32) if metric == "l2"
            else torch.zeros((n,), dtype=torch.float32))
    inf = torch.tensor(float("inf"), dtype=torch.float32)
    if invalid is not None:
        bias = torch.where(invalid, inf, bias)
    if filter_mask is not None:
        bias = torch.where(filter_mask, bias, inf)
    return bias


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("invalid,filtered", [
    (False, False), (True, False), (False, True), (True, True)])
def test_scalar_fills_give_the_former_biases(rng, metric, invalid, filtered):
    n, d_pad, span = 2 * ps.GROUP, 128, 2
    sq = _t(rng.random(n).astype(np.float32) * 5e4)
    inv = torch.from_numpy(rng.random(n) < 0.1) if invalid else None
    mask = torch.from_numpy(rng.random(n) < 0.7) if filtered else None
    inv_two = torch.tensor(0.37, dtype=torch.float32)
    got = tbs.make_bias_i8_packed(n, d_pad, span, metric, sq, inv_two, inv,
                                  mask)
    want = _former_bias_i8_packed(n, d_pad, span, metric, sq, inv_two, inv,
                                  mask)
    assert got.dtype == want.dtype == torch.int32
    assert torch.equal(got, want)
    got = tbs.make_bias(n, metric, sq, inv, mask, device=_CPU)
    want = _former_bias(n, metric, sq, inv, mask)
    assert got.dtype == want.dtype == torch.float32
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
