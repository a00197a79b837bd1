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
