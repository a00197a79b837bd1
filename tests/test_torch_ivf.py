"""The port's IVF path (ops/ivf.py and its index routes) against the JAX package's.

The same numpy inputs go through both packages on the CPU. Builds draw
random numbers from different generators, so builds are held by their
invariants and by recall; search is held over one reference index carried
across with ``ivf_from_reference``. Tolerances:

- codes bit-identical (both round (row - centroid) / scale half to even
  after the same f32 division); centroids, scales and row norms within
  rtol 1e-6;
- search ids identical on >= 99% of rows (rows that differ hold near-ties);
  distances within 1e-5 of the terms they are summed from (|q|^2 + |x|^2
  for l2, 1 for ip: the l2 score cancels to near 0 for close rows, so a
  relative bound on the result itself would be meaningless there); recall
  within 0.005;
- index and engine replies over the same rows: the same keys, scores (the
  exact fp32 rescore's) within 1e-5 of |q|^2 + |x|^2.
"""

from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from valkey_search_tpu.indexes.flat import FlatVectorIndex as JaxFlat
from valkey_search_tpu.ops import ivf as jivf
from valkey_search_tpu.server.engine import Engine as JaxEngine
from valkey_search_tpu_torch.indexes.flat import FlatVectorIndex
from valkey_search_tpu_torch.indexes.hnsw import HnswVectorIndex
from valkey_search_tpu_torch.ops import ivf
from valkey_search_tpu_torch.runtime.device import set_device
from valkey_search_tpu_torch.runtime.metrics import STATS
from valkey_search_tpu_torch.server.engine import Engine
from torch_port_config import saved_options, set_both

CPU = torch.device("cpu")
_KEYS = ("search.ivf-threshold", "search.ivf-block-rows", "search.ivf-probe",
         "search.ivf-clusters", "search.corpus-dtype")


@pytest.fixture(autouse=True)
def _cpu_and_config():
    set_device("cpu")
    with saved_options(*_KEYS):
        yield


def clustered(rng, n, d, centers=64, spread=0.08):
    c = rng.normal(size=(centers, d)).astype(np.float32)
    a = rng.integers(0, centers, size=n)
    x = c[a] + spread * rng.normal(size=(n, d)).astype(np.float32)
    return np.ascontiguousarray(x, np.float32)


def brute(queries, corpus, k, metric="l2", allowed=None):
    """Exact top-k ids among the rows ``allowed`` (bool [n]; all if None)."""
    if metric == "l2":
        d = ((queries * queries).sum(1)[:, None]
             + (corpus * corpus).sum(1)[None, :] - 2.0 * queries @ corpus.T)
    else:
        d = 1.0 - queries @ corpus.T
    if allowed is not None:
        d[:, ~allowed] = np.inf
    return np.argsort(d, axis=1, kind="stable")[:, :k]


def recall_at_k(ids, truth):
    hits = sum(len(set(row[row >= 0].tolist()) & set(t.tolist()))
               for row, t in zip(np.asarray(ids), truth))
    return hits / truth.size


def carry(jidx):
    return ivf.ivf_from_reference(
        {f: np.asarray(getattr(jidx, f)) for f in jivf.IvfDeviceIndex._fields},
        CPU)


def dyadic(rng, n, d):
    """Multiples of 1/32 in [-8, 8]: exact in bf16, exact products."""
    return (rng.integers(-256, 257, size=(n, d)) / 32.0).astype(np.float32)


def t(x):
    return torch.from_numpy(np.array(x))  # a copy: jax arrays are read-only


# one reference index per metric, shared by the search tests
@pytest.fixture(scope="module")
def ref_index():
    rng = np.random.default_rng(5)
    out = {}
    for metric in ("l2", "ip"):
        x = clustered(rng, 8192, 32, centers=16)
        if metric == "ip":
            x /= np.linalg.norm(x, axis=1, keepdims=True)
        jidx = jivf.build_ivf(x, block_rows=128, n_clusters=8,
                              train_sample=4096)
        q = x[rng.integers(0, len(x), 192)] + 0.03 * rng.normal(
            size=(192, 32)).astype(np.float32)
        if metric == "ip":
            q /= np.linalg.norm(q, axis=1, keepdims=True)
        out[metric] = (x, q, jidx, carry(jidx))
    return out


def assert_search_close(td, ti, jd, ji, q, x, metric):
    """Ids equal on >= 99% of rows; where an id is equal, its distance
    within 1e-5 of the terms it is summed from; +inf where the other's is."""
    jd, ji = np.asarray(jd), np.asarray(ji)
    td, ti = np.asarray(td), np.asarray(ti)
    assert (ti == ji).all(1).mean() >= 0.99
    same = (ti == ji) & (ji >= 0)
    if metric == "l2":
        scale = (q * q).sum(1)[:, None] + (x * x).sum(1)[np.maximum(ji, 0)]
    else:
        scale = np.ones_like(jd)
    assert (np.abs(td - jd)[same] <= 1e-5 * scale[same]).all()
    assert np.array_equal(np.isinf(td), np.isinf(jd))


# -- quantization ----------------------------------------------------------------


def _laid_out_blocks(rng, nb=24, s=64, d=16):
    vecs = clustered(rng, nb * s, d, centers=6).reshape(nb, s, d) * 3
    ids = np.arange(nb * s, dtype=np.int32).reshape(nb, s)
    ids[rng.random((nb, s)) < 0.15] = -1
    ids[-2:] = -1  # whole padding blocks
    vecs[ids < 0] = 0
    return vecs, ids


def test_quantize_blocks_matches_reference(rng):
    vecs, ids = _laid_out_blocks(rng)
    want = [np.asarray(a) for a in jivf.quantize_blocks(jnp.asarray(vecs),
                                                       jnp.asarray(ids))]
    got = [a.numpy() for a in ivf.quantize_blocks(t(vecs), t(ids))]
    np.testing.assert_array_equal(got[0], want[0])
    for g, w in zip(got[1:5], want[1:5]):  # centroids, cent_sq, scale, row_sq
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-12)
    np.testing.assert_array_equal(got[5], want[5])


@pytest.mark.parametrize("host_quantize", [False, True])
def test_finalize_blocks_matches_reference(rng, host_quantize):
    vecs, ids = _laid_out_blocks(rng, nb=40)
    want = jivf.finalize_blocks(vecs, ids, chunk_blocks=16,
                                host_quantize=host_quantize)
    got = ivf.finalize_blocks(vecs, ids, chunk_blocks=16,
                              host_quantize=host_quantize, device=CPU)
    np.testing.assert_array_equal(got.blocks_i8.numpy(), np.asarray(want.blocks_i8))
    for name in ("centroids", "cent_sq", "block_scale", "row_sq"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=1e-6, atol=1e-12, err_msg=name)
    for name in ("block_valid", "block_ids"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)))
    assert got.block_ids.dtype == torch.int32
    assert got.device_bytes() == want.device_bytes()


def test_host_and_device_quantization_agree(rng):
    vecs, ids = _laid_out_blocks(rng, nb=32)
    a = ivf.finalize_blocks(vecs, ids, host_quantize=False, device=CPU)
    b = ivf.finalize_blocks(vecs, ids, host_quantize=True, device=CPU)
    np.testing.assert_array_equal(a.block_ids.numpy(), b.block_ids.numpy())
    np.testing.assert_array_equal(a.blocks_i8.numpy(), b.blocks_i8.numpy())
    np.testing.assert_allclose(a.centroids.numpy(), b.centroids.numpy(),
                               rtol=1e-5, atol=1e-6)


# -- layout ----------------------------------------------------------------------


@pytest.mark.parametrize("align", [0, 4])
def test_plan_blocks_matches_reference(rng, align):
    assign = rng.integers(0, 9, 3000).astype(np.int32)
    order = np.lexsort((rng.random(3000), assign))
    got = ivf.plan_blocks(assign, order, 64, block_align=align)
    want = jivf.plan_blocks(assign, order, 64, block_align=align)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]


def test_principal_axis_matches_reference(rng):
    x = clustered(rng, 2000, 24, centers=5)
    np.testing.assert_array_equal(ivf.principal_axis(x),
                                  jivf.principal_axis(x))


def _blocks_only(nb):
    z = torch.zeros((nb, 1, 1), dtype=torch.int8)
    return ivf.IvfIndex(None, None, None, z, None, None, None)


def test_default_probe_matches_reference():
    for nb in (1, 2048, 7168, 7169, 9216, 12288, 12289, 16384, 100352,
               1 << 20):
        fake = jivf.IvfDeviceIndex(None, None, None,
                                   jnp.zeros((nb, 1, 1), jnp.int8),
                                   None, None, None)
        assert ivf.default_probe(_blocks_only(nb)) == jivf.default_probe(fake)
    assert ivf.default_probe(_blocks_only(100352)) == 262


def test_grouped_gather_bytes_matches_reference():
    assert ivf._GROUPED_GATHER_CAP_BYTES == jivf._GROUPED_GATHER_CAP_BYTES
    for b in (1, 7, 256, 1024, 16384):
        for probe in (1, 8, 16, 512):
            for nb in (16, 2048, 11264, 100352):
                args = (b, probe, nb, 1024, 128)
                assert (ivf._grouped_gather_bytes(*args)
                        == jivf._grouped_gather_bytes(*args)), args
    # the 10M engine shape groups, the 100M shape does not
    assert (ivf._grouped_gather_bytes(16384, 16, 11264, 1024, 128)
            <= ivf._GROUPED_GATHER_CAP_BYTES)
    assert (ivf._grouped_gather_bytes(512, 512, 100352, 1024, 128)
            > ivf._GROUPED_GATHER_CAP_BYTES)


# -- assignment ------------------------------------------------------------------


def test_assign_clusters_matches_reference_on_dyadic_corpus(rng):
    x = dyadic(rng, 6000, 24)
    cent = jivf.kmeans_fit(jnp.asarray(x[:2048]), 37, iters=4)
    want = jivf.assign_clusters(x, cent, chunk_rows=1024)
    got = ivf.assign_clusters(x, t(np.asarray(cent)), chunk_rows=1024)
    np.testing.assert_array_equal(got, want)
    chunks = (x[s:s + 700] for s in range(0, len(x), 700))
    np.testing.assert_array_equal(
        ivf.assign_clusters(chunks, t(np.asarray(cent))), want)


def test_two_level_assignment_matches_reference_on_dyadic_corpus(rng):
    x = dyadic(rng, 3000, 16)
    a1 = rng.integers(0, 6, 3000).astype(np.int32)
    cents2 = rng.normal(size=(6, 4, 16)).astype(np.float32) * 3
    c2_valid = np.arange(4)[None, :] < rng.integers(1, 5, 6)[:, None]
    want = jivf._assign_chunk2(jnp.asarray(x), jnp.asarray(a1),
                               jnp.asarray(cents2), jnp.asarray(c2_valid))
    got = ivf._assign_chunk2(t(x), t(a1), t(cents2), t(c2_valid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _separated(rng):
    """Four centers 10 apart plus dyadic noise (exact in bf16)."""
    centers = np.eye(4, 8).astype(np.float32) * 10
    noise = rng.integers(-8, 9, size=(1024, 8)) / 64.0
    return centers, (np.repeat(centers, 256, axis=0) + noise).astype(
        np.float32)


@pytest.mark.parametrize("masked", [False, True])
def test_kmeans_matches_reference_from_its_seeds(rng, masked):
    """The two packages draw seeds from different generators, so the port's
    Lloyd's iterations start here from the JAX package's own draw (made with
    jax.random as kmeans_fit makes it) and must land on its centroids."""
    import jax

    centers, x = _separated(rng)
    valid = np.arange(len(x)) % 2 == 0 if masked else None
    key = jax.random.PRNGKey(0)
    if valid is None:
        perm = np.asarray(jax.random.permutation(key, len(x)))
    else:
        u = np.asarray(jax.random.uniform(key, (len(x),))) + np.where(
            valid, 0.0, 1e9)
        perm = np.argsort(u, kind="stable")
    want = np.asarray(jivf.kmeans_fit(
        jnp.asarray(x), 4, iters=10,
        valid=None if valid is None else jnp.asarray(valid)))
    got = ivf._lloyd(t(x), t(x[perm[:4]]), None if valid is None
                     else t(valid), 10).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    if not masked:  # the JAX package's own recovery check
        for c in centers:
            assert np.min(np.linalg.norm(got - c, axis=1)) < 0.5
    # the port's own draw: centroids of the rows, no NaN
    cent = ivf.kmeans_fit(t(x), 4, iters=10, valid=None if valid is None
                          else t(valid)).numpy()
    assert cent.shape == (4, 8) and np.isfinite(cent).all()


def test_kmeans_batched_matches_reference_from_its_seeds(rng):
    import jax

    tabs = np.stack([np.repeat(np.eye(3, 8, k=i).astype(np.float32) * 5, 40,
                               axis=0) for i in range(4)])
    tabs += rng.integers(-4, 5, size=tabs.shape) / 64.0
    tabs = tabs.astype(np.float32)
    valid = np.ones(tabs.shape[:2], bool)
    valid[:, 100:] = False
    tabs[~valid] = 0.0
    u = np.asarray(jax.random.uniform(jax.random.PRNGKey(0), valid.shape))
    seed_pos = np.argsort(u + np.where(valid, 0.0, 1e9), axis=1,
                          kind="stable")[:, :3]
    cent0 = np.take_along_axis(tabs, seed_pos[:, :, None], axis=1)
    want = np.asarray(jivf.kmeans_fit_batched(jnp.asarray(tabs),
                                              jnp.asarray(valid), 3, iters=6))
    got = ivf._lloyd_batched(t(tabs), t(cent0), t(valid), 6).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    cents = ivf.kmeans_fit_batched(t(tabs), t(valid), 3, iters=6).numpy()
    assert cents.shape == (4, 3, 8) and np.isfinite(cents).all()


# -- search over a carried reference index ----------------------------------------


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("route", ["grouped", "steps"])
def test_search_matches_reference(ref_index, route, metric, masked):
    x, q, jidx, tidx = ref_index[metric]
    mask = (np.arange(len(x)) % 3 != 0) if masked else None
    kw = dict(k=10, probe=8, metric=metric)
    if route == "steps":
        kw["probe_chunk"] = 3  # 8 = 3 + 3 + 2: a padded last step
    jd, ji = getattr(jivf, f"_ivf_search_batch_{route}")(
        jidx, jnp.asarray(q), filter_mask=None if mask is None
        else jnp.asarray(mask), **kw)
    td, ti = getattr(ivf, f"_ivf_search_batch_{route}")(
        tidx, t(q), filter_mask=None if mask is None else t(mask), **kw)
    assert ti.dtype == torch.int32 and td.dtype == torch.float32
    assert_search_close(td, ti, jd, ji, q, x, metric)
    truth = brute(q, x, 10, metric, mask)
    assert abs(recall_at_k(ti, truth) - recall_at_k(ji, truth)) <= 0.005
    if mask is not None:
        live = ti.numpy()[ti.numpy() >= 0]
        assert mask[live].all()


def test_probe_clamped_matches_reference(rng):
    x = clustered(rng, 100, 8, centers=2)
    jidx = jivf.build_ivf(x, block_rows=64, n_clusters=2, train_sample=100)
    tidx = carry(jidx)
    jd, ji = jivf.ivf_search_batch(jidx, jnp.asarray(x[:4]), k=3, probe=999)
    td, ti = ivf.ivf_search_batch(tidx, t(x[:4]), k=3, probe=999)
    assert (ti.numpy()[:, 0] >= 0).all()
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    # k past probe * S pads with (+inf, -1)
    td, ti = ivf._ivf_search_batch_steps(tidx, t(x[:2]), k=300, probe=999)
    assert ti.shape == (2, 300) and (ti.numpy()[:, 100:] == -1).all()
    assert np.isinf(td.numpy()[:, 100:]).all()


def test_probe_chunk_padding_matches_reference(ref_index):
    x, q, jidx, tidx = ref_index["l2"]
    jd, ji = jivf.ivf_search_batch(jidx, jnp.asarray(q[:16]), k=8, probe=5,
                                   probe_chunk=4)
    td, ti = ivf.ivf_search_batch(tidx, t(q[:16]), k=8, probe=5,
                                  probe_chunk=4)
    assert_search_close(td, ti, jd, ji, q[:16], x, "l2")
    for row in ti.numpy():
        live = row[row >= 0]
        assert len(live) == len(set(live.tolist()))


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_rescored_matches_reference(ref_index, metric):
    x, q, jidx, tidx = ref_index[metric]
    mask = np.arange(len(x)) % 5 != 0
    jd, ji = jivf.ivf_search_rescored(jidx, jnp.asarray(q), jnp.asarray(x),
                                      k=10, probe=8, metric=metric,
                                      filter_mask=jnp.asarray(mask))
    td, ti = ivf.ivf_search_rescored(tidx, t(q), t(x), k=10, probe=8,
                                     metric=metric, filter_mask=t(mask))
    assert_search_close(td, ti, jd, ji, q, x, metric)
    truth = brute(q, x, 10, metric, mask)
    assert recall_at_k(ti, truth) >= 0.95
    assert abs(recall_at_k(ti, truth) - recall_at_k(ji, truth)) <= 0.005


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_delta_overlay_merge_matches_reference(ref_index, metric):
    x, q, jidx, tidx = ref_index[metric]
    rng = np.random.default_rng(12)
    cap = len(x)
    invalid = rng.random(cap) < 0.05
    delta = rng.choice(cap, 37, replace=False).astype(np.int32)
    mask = ~invalid
    mask[delta] = False
    jd, ji = jivf.ivf_search_rescored(jidx, jnp.asarray(q), jnp.asarray(x),
                                      k=10, probe=8, metric=metric,
                                      filter_mask=jnp.asarray(mask))
    want = jivf.delta_overlay_merge(
        jnp.asarray(q), jnp.asarray(x), jnp.asarray(delta),
        jnp.asarray(invalid), jd, ji, k=10, metric=metric)
    td, ti = ivf.ivf_search_rescored(tidx, t(q), t(x), k=10, probe=8,
                                     metric=metric, filter_mask=t(mask))
    got = ivf.delta_overlay_merge(t(q), t(x), t(delta), t(invalid), td, ti,
                                  k=10, metric=metric)
    assert_search_close(*got, *want, q, x, metric)
    assert not invalid[got[1].numpy()[got[1].numpy() >= 0]].any()
    assert np.isin(got[1].numpy(), delta).any()  # the overlay contributed


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_grouped_matches_steps_in_the_port(ref_index, metric):
    """The two stage-2 routes over one index: their products have other
    shapes, so they sum in other orders; ids equal on >= 99% of rows."""
    x, q, _, tidx = ref_index[metric]
    gd, gi = ivf._ivf_search_batch_grouped(tidx, t(q), k=10, probe=8,
                                           metric=metric, filter_mask=None)
    sd, si = ivf._ivf_search_batch_steps(tidx, t(q), k=10, probe=8,
                                         metric=metric, probe_chunk=4)
    assert_search_close(gd, gi, sd, si, q, x, metric)


def test_dispatch_routes_by_multiplicity_and_cap(ref_index, monkeypatch):
    x, q, _, tidx = ref_index["l2"]
    called = []
    for name in ("grouped", "steps"):
        orig = getattr(ivf, f"_ivf_search_batch_{name}")
        monkeypatch.setattr(ivf, f"_ivf_search_batch_{name}",
                            lambda *a, _n=name, _o=orig, **kw:
                            (called.append(_n), _o(*a, **kw))[1])
    before = (STATS.get("ivf_stage2_grouped"), STATS.get("ivf_stage2_steps"))
    ivf.ivf_search_batch(tidx, t(q), k=10, probe=16)   # 192 * 16 / 64 >= 2
    ivf.ivf_search_batch(tidx, t(q[:3]), k=10, probe=16)
    monkeypatch.setattr(ivf, "_GROUPED_GATHER_CAP_BYTES", 1)
    _, ids = ivf.ivf_search_batch(tidx, t(q), k=10, probe=16)
    assert called == ["grouped", "steps", "steps"]
    assert (STATS.get("ivf_stage2_grouped") - before[0],
            STATS.get("ivf_stage2_steps") - before[1]) == (1, 2)
    assert recall_at_k(ids, brute(q, x, 10)) >= 0.9


# -- builds ----------------------------------------------------------------------


def test_build_partitions_every_row_once(rng):
    n, d, s = 5000, 16, 128
    x = clustered(rng, n, d, centers=8)
    idx = ivf.build_ivf(x, block_rows=s, n_clusters=8, train_sample=2048,
                        device=CPU)
    ids = idx.block_ids.numpy().ravel()
    assert np.array_equal(np.sort(ids[ids >= 0]), np.arange(n))
    assert idx.n_blocks & (idx.n_blocks - 1) == 0   # pow2 block count
    assert np.array_equal(idx.block_valid.numpy(),
                          (idx.block_ids.numpy() >= 0).any(axis=1))
    assert idx.block_rows == s and idx.blocks_i8.dtype == torch.int8


def test_build_custom_row_ids_survive(rng):
    x = clustered(rng, 1000, 8, centers=4)
    row_ids = np.arange(1000, 2000)
    idx = ivf.build_ivf(x, row_ids, block_rows=64, n_clusters=4,
                        train_sample=512, device=CPU)
    ids = idx.block_ids.numpy().ravel()
    assert set(ids[ids >= 0].tolist()) == set(row_ids.tolist())


@pytest.mark.parametrize("build", ["build_ivf", "build_ivf_device"])
def test_residual_codes_reconstruct_rows(rng, build):
    x = clustered(rng, 600, 8, centers=4)
    kw = dict(block_rows=64, n_clusters=4, train_sample=512)
    idx = (ivf.build_ivf(x, device=CPU, **kw) if build == "build_ivf"
           else ivf.build_ivf_device(t(x), **kw))
    codes = idx.blocks_i8.numpy().astype(np.float32)
    cent, scale = idx.centroids.numpy(), idx.block_scale.numpy()
    ids = idx.block_ids.numpy()
    recon = cent[:, None, :] + codes * scale[:, None, None]
    bb, ss = np.nonzero(ids >= 0)
    err = np.abs(recon[bb, ss] - x[ids[bb, ss]])
    assert (err <= scale[bb][:, None] * 0.51 + 1e-6).all()
    np.testing.assert_allclose(idx.row_sq.numpy()[bb, ss],
                               (recon[bb, ss] ** 2).sum(1), rtol=1e-4,
                               atol=1e-4)


def test_device_build_partitions_every_row_once(rng):
    x = clustered(rng, 4096, 32)
    timings = {}
    idx = ivf.build_ivf_device(t(x), block_rows=128, n_clusters=8,
                               train_sample=2048, timings=timings)
    ids = idx.block_ids.numpy().reshape(-1)
    live = ids[ids >= 0]
    assert len(live) == 4096 and len(np.unique(live)) == 4096
    assert set(timings) == {"sample_fit_s", "assign_s", "plan_s",
                            "quantize_s"}


def test_device_build_present_mask_and_row_ids(rng):
    x = clustered(rng, 2048, 32)
    present = np.zeros(2048, bool)
    present[::2] = True
    row_ids = np.arange(2048) * 7 + 3
    idx = ivf.build_ivf_device(t(x), row_ids, present=present, block_rows=64,
                               n_clusters=4, train_sample=512)
    ids = idx.block_ids.numpy().reshape(-1)
    assert np.array_equal(np.sort(ids[ids >= 0]), np.sort(row_ids[::2]))


@pytest.mark.parametrize("build", ["build_ivf", "build_ivf_device"])
def test_build_recall_matches_reference(build):
    """The port's build against the reference's own, same inputs and probe:
    recall within 0.01 (the k-means draws differ)."""
    rng = np.random.default_rng(21)
    x = clustered(rng, 16384, 32, centers=32)
    q = x[rng.integers(0, len(x), 256)] + 0.03 * rng.normal(
        size=(256, 32)).astype(np.float32)
    truth = brute(q, x, 10)
    kw = dict(block_rows=128, n_clusters=16, train_sample=8192)
    if build == "build_ivf":
        jidx = jivf.build_ivf(x, **kw)
        tidx = ivf.build_ivf(x, device=CPU, **kw)
    else:
        jidx = jivf.build_ivf_device(jnp.asarray(x), **kw)
        tidx = ivf.build_ivf_device(t(x), **kw)
    assert tidx.n_blocks == jidx.n_blocks
    r_ref = recall_at_k(jivf.ivf_search_batch(jidx, jnp.asarray(q), k=10,
                                              probe=8)[1], truth)
    r_port = recall_at_k(ivf.ivf_search_batch(tidx, t(q), k=10, probe=8)[1],
                         truth)
    assert r_port >= 0.85
    assert abs(r_port - r_ref) <= 0.01


def test_bf16_mirror_accepted(rng):
    x = clustered(rng, 4096, 32)
    q = x[:64]
    idx = ivf.build_ivf_device(t(x).to(torch.bfloat16), block_rows=128,
                               n_clusters=8, train_sample=2048)
    _, ids = ivf.ivf_search_batch(idx, t(q), k=5, probe=8)
    assert recall_at_k(ids, brute(q, x, 5)) >= 0.85


def test_sample_refine_partition_and_recall(rng):
    n, d, k = 12000, 16, 10
    x = clustered(rng, n, d, centers=6, spread=0.3)
    q = x[rng.integers(0, n, size=48)]
    truth = brute(q, x, k)
    res = {}
    for mode in ("exact", "sample"):
        idx = ivf.build_ivf(x, block_rows=128, n_clusters=6, refine=mode,
                            train_sample=6000, device=CPU)
        _, ids = ivf.ivf_search_rescored(idx, t(q), t(x), k=k, probe=40)
        res[mode] = recall_at_k(ids, truth)
        flat = idx.block_ids.numpy().ravel()
        assert np.array_equal(np.sort(flat[flat >= 0]), np.arange(n))
    assert res["sample"] >= 0.92 and res["sample"] >= res["exact"] - 0.05


def test_skewed_clusters(rng):
    d, k = 16, 10
    big = rng.normal(size=(18000, d)).astype(np.float32) * 0.1
    small = rng.normal(size=(2000, d)).astype(np.float32) * 0.1 + 3.0
    x = np.concatenate([big, small]).astype(np.float32)
    idx = ivf.build_ivf(x, block_rows=256, n_clusters=8, train_sample=8192,
                        device=CPU)
    q = x[rng.integers(0, len(x), size=48)]
    _, ids = ivf.ivf_search_rescored(idx, t(q), t(x), k=k, probe=32)
    assert recall_at_k(ids, brute(q, x, k)) >= 0.95


# -- indexes ---------------------------------------------------------------------


def _with_ivf(thresh=1000, block=128, probe=16):
    set_both("search.ivf-threshold", thresh)
    set_both("search.ivf-block-rows", block)
    set_both("search.ivf-probe", probe)


def _flat(rng, n=4000, d=16, centers=8, metric="l2"):
    idx = FlatVectorIndex(dim=d, metric=metric, device=CPU)
    x = clustered(rng, n, d, centers=centers)
    idx.bulk_load([f"k{i}" for i in range(n)], x)
    return idx, x


def test_flat_routes_to_ivf_and_recalls(rng):
    _with_ivf()
    idx, x = _flat(rng)
    builds = STATS.get("ivf_mirror_builds")
    served = STATS.get("ivf_served_searches")
    q = x[:32]
    d, ids = idx.search_batch(q, 5)
    assert STATS.get("ivf_served_searches") - served == 32
    assert STATS.get("ivf_mirror_builds") - builds == 1
    assert recall_at_k(ids, brute(q, x, 5)) >= 0.95
    np.testing.assert_allclose(  # the exact fp32 rescore
        d[:, 0], [((q[i] - x[ids[i, 0]]) ** 2).sum() for i in range(32)],
        rtol=1e-4, atol=1e-4)
    idx.search_batch(q, 5)
    assert STATS.get("ivf_mirror_builds") - builds == 1  # kept


def test_below_threshold_the_scan_serves(rng):
    _with_ivf(thresh=5000)
    idx, x = _flat(rng)
    served = STATS.get("ivf_served_searches")
    idx.search_batch(x[:4], 5)
    assert idx.ivf_mirror() is None and idx._ivf is None
    assert STATS.get("ivf_served_searches") == served


def test_flat_filter_bypasses_ivf(rng):
    _with_ivf(probe=2)  # aggressive pruning would lose the allowed docs
    idx, x = _flat(rng)
    allowed = np.arange(3980, 4000)
    mask = np.zeros(idx.store.capacity, bool)
    mask[allowed] = True
    served = STATS.get("ivf_served_searches")
    _, ids = idx.search_batch(x[:4], 5, filter_mask=t(mask))
    assert STATS.get("ivf_served_searches") == served
    live = ids[ids >= 0]
    assert len(live) and np.isin(live, allowed).all()


def test_flat_mutation_drift_rebuilds_the_mirror(rng):
    _with_ivf()
    idx, x = _flat(rng, n=2000)
    idx.search_batch(x[:1], 1)
    builds = STATS.get("ivf_mirror_builds")
    keys = [f"k{i}" for i in range(2000)]
    for _ in range(8):  # 16,000 rewrites: within max(16384, n // 20)
        idx.bulk_load(keys, x)
    idx.search_batch(x[:1], 1)
    assert STATS.get("ivf_mirror_builds") == builds
    idx.bulk_load(keys, x)  # 18,000: past it
    _, ids = idx.search_batch(x[:1], 1)
    assert STATS.get("ivf_mirror_builds") == builds + 1
    assert ids[0, 0] == 0 and not idx.ivf_delta_ids().size


def test_builder_turn_after_a_landed_build_serves_it(rng):
    # a search that saw no mirror, then took the builder's turn after
    # another thread's build landed, serves that build and builds none
    _with_ivf()
    idx, x = _flat(rng, n=2000)
    mirror = idx.ivf_mirror()
    builds = STATS.get("ivf_mirror_builds")
    real, seen = idx._ivf_current, []

    def stale_first_look(n):
        seen.append(n)
        return None if len(seen) == 1 else real(n)

    idx._ivf_current = stale_first_look
    assert idx.ivf_mirror() is mirror
    assert len(seen) == 2 and STATS.get("ivf_mirror_builds") == builds


def test_concurrent_first_searches_build_once(rng):
    _with_ivf()
    idx, x = _flat(rng, n=2000)
    builds = STATS.get("ivf_mirror_builds")
    with ThreadPoolExecutor(8) as pool:
        got = list(pool.map(lambda _: idx.ivf_mirror(), range(16)))
    assert all(m is got[0] for m in got) and got[0] is not None
    assert STATS.get("ivf_mirror_builds") == builds + 1


def test_flat_delta_overlay_read_your_writes(rng):
    _with_ivf()
    idx, x = _flat(rng, n=3000, centers=6)
    idx.search_batch(x[:1], 1)  # builds the mirror
    builds = STATS.get("ivf_mirror_builds")
    q = rng.normal(size=(16,)).astype(np.float32) * 0.01 + 7.5
    idx.add_record("fresh", q)
    d, ids = idx.search_batch(q[None, :], 1)
    assert idx.interner.key_of(int(ids[0, 0])) == "fresh" and d[0, 0] < 1e-4
    idx.remove_record("fresh")
    _, ids = idx.search_batch(q[None, :], 1)
    assert idx.interner.key_of(int(ids[0, 0])) != "fresh"
    idx.remove_record("k0")  # a mirror row: masked, not rebuilt
    _, ids = idx.search_batch(x[:1], 3)
    assert 0 not in ids[0].tolist()
    idx.add_record("k1", x[2])  # an update: its old vector is gone
    _, ids = idx.search_batch(x[2:3], 2)
    assert {idx.interner.key_of(int(i)) for i in ids[0]} == {"k1", "k2"}
    assert STATS.get("ivf_mirror_builds") == builds


def test_flat_cosine_runs_as_ip(rng):
    _with_ivf()
    idx, x = _flat(rng, metric="cosine")
    q = x[:16] * 3.0  # cosine ignores the norm
    d, ids = idx.search_batch(q, 5)
    xn = x / np.linalg.norm(x, axis=1, keepdims=True)
    qn = q / np.linalg.norm(q, axis=1, keepdims=True)
    assert recall_at_k(ids, brute(qn, xn, 5, "ip")) >= 0.95
    np.testing.assert_allclose(
        d[:, 0], 1.0 - (qn * xn[ids[:, 0]]).sum(1), atol=1e-5)


def test_flat_over_a_carried_mirror_matches_reference(rng):
    """Both packages' FLAT indexes over the same rows and the same mirror
    (the reference's, carried across): equal replies, also after writes
    that the delta overlay serves."""
    _with_ivf()
    jidx = JaxFlat(dim=16, metric="l2")
    x = clustered(rng, 4000, 16, centers=8)
    keys = [f"k{i}" for i in range(len(x))]
    jidx.bulk_load(keys, x)
    jidx.search_batch(x[:1], 1)  # the reference builds its mirror
    st = jidx.store
    idx = FlatVectorIndex.from_reference(
        {"vectors": st.vectors, "norms_sq": st.norms_sq,
         "magnitudes": st.magnitudes, "present": st.present,
         "metric": st.metric, "block": st.block},
        dict(jidx.interner.items()), CPU)
    idx.store.device_snapshot()
    idx._ivf = carry(jidx._ivf)
    idx._ivf_epoch, idx._ivf_muts = idx.store.epoch, idx.store.mutations
    q = x[rng.integers(0, len(x), 64)] + 0.02 * rng.normal(
        size=(64, 16)).astype(np.float32)

    def both():
        jd, ji = jidx.search_batch(q, 10)
        td, ti = idx.search_batch(q, 10)
        assert_search_close(td, ti, jd, ji, q, idx.store.vectors, "l2")

    both()
    for i in (5, 77, 1999):
        for index in (jidx, idx):
            index.remove_record(f"k{i}")
    for j, row in enumerate(q[:8]):
        for index in (jidx, idx):
            index.add_record(f"new{j}", row + 0.001)
            index.add_record(f"k{j * 11 + 3}", row - 0.002)
    both()
    # freed doc ids are reused: 16 distinct rows written, as in the reference
    assert idx._ivf is not None and len(idx.ivf_delta_ids()) == 16
    assert (set(idx.ivf_delta_ids().tolist())
            == set(jidx.ivf_delta_ids(pad_pow2=False).tolist()))


def _hnsw(rng, n=2000, d=16):
    idx = HnswVectorIndex(dim=d, metric="l2", m=8, device=CPU)
    x = clustered(rng, n, d, centers=4)
    idx.bulk_load([f"k{i}" for i in range(n)], x)
    return idx, x


def test_hnsw_routes_to_ivf(rng):
    _with_ivf()
    idx, x = _hnsw(rng)
    served = STATS.get("ivf_served_searches")
    _, docs = idx.search_batch(x[:8], 5)
    assert STATS.get("ivf_served_searches") - served == 8
    truth = brute(x[:8], x, 5)
    keys = [[idx.interner.key_of(int(dd)) for dd in row] for row in docs]
    got = np.array([[int(kk[1:]) for kk in row] for row in keys])
    assert recall_at_k(got, truth) >= 0.95
    idx.remove_record("k0")  # a tombstone rides ~invalid
    _, docs = idx.search_batch(x[:1], 1)
    assert idx.interner.key_of(int(docs[0, 0])) != "k0"
    idx.add_record("k1", x[7] + 0.5)  # an update: the overlay serves it
    _, docs = idx.search_batch(x[7:8] + 0.5, 1)
    assert idx.interner.key_of(int(docs[0, 0])) == "k1"
    mask = torch.zeros(idx.store.capacity, dtype=torch.bool)
    mask[:10] = True  # a filtered search takes the scan
    served = STATS.get("ivf_served_searches")
    idx.search_batch(x[:2], 3, filter_mask=mask)
    assert STATS.get("ivf_served_searches") == served


def test_hnsw_ef_runtime_raises_probe(rng, monkeypatch):
    _with_ivf(probe=2)
    idx, x = _hnsw(rng)
    seen = {}
    orig = ivf.ivf_search_rescored

    def spy(*a, **kw):
        seen["probe"] = kw.get("probe")
        return orig(*a, **kw)

    monkeypatch.setattr(ivf, "ivf_search_rescored", spy)
    idx.search_batch(x[:2], 3)
    assert seen["probe"] == 2  # the configured floor
    idx.search_batch(x[:2], 3, ef=1000)
    assert seen["probe"] == 8  # ceil(1000 / 128)
    idx.search_batch(x[:2], 3, ef=100)
    assert seen["probe"] == 2


# -- engines ---------------------------------------------------------------------


def test_engine_replies_match_at_full_probe(rng):
    """One argv flow through both Engines with the probe covering every
    block, so both answer exactly: FT.CREATE, HSETs, a lowered threshold,
    FT.SEARCH, DEL and an update."""
    dim, rows = 16, 2500
    x = clustered(rng, rows, dim, centers=12, spread=0.3)
    engines = (JaxEngine(), Engine())
    for e in engines:
        assert e.execute(
            "FT.CREATE", "idx", "ON", "HASH", "PREFIX", "1", "doc:", "SCHEMA",
            "v", "VECTOR", "FLAT", "6", "TYPE", "FLOAT32", "DIM", str(dim),
            "DISTANCE_METRIC", "L2") == "OK"
        for i, row in enumerate(x):
            e.execute("HSET", f"doc:{i}", "v", row.tobytes())
    set_both("search.ivf-threshold", 1000)
    set_both("search.ivf-block-rows", 128)
    set_both("search.ivf-probe", 65536)
    served = STATS.get("ivf_served_searches")
    q = x[rng.integers(0, rows, 12)] + 0.05 * rng.normal(
        size=(12, dim)).astype(np.float32)

    current = {f"doc:{i}": row for i, row in enumerate(x)}

    def searches():
        for row in q:
            replies = [e.execute("FT.SEARCH", "idx", "*=>[KNN 10 @v $q]",
                                 "PARAMS", "2", "q", row.tobytes(),
                                 "RETURN", "1", "__v_score")
                       for e in engines]
            want, got = replies
            assert got[0] == want[0] and got[1::2] == want[1::2]
            # scores within 1e-5 of the terms of |q|^2 + |x|^2 - 2 q.x
            scale = np.array([row @ row + current[key] @ current[key]
                              for key in want[1::2]])
            diff = np.abs(np.array([float(r[1]) for r in got[2::2]])
                          - np.array([float(r[1]) for r in want[2::2]]))
            assert (diff <= 1e-5 * scale).all()

    searches()
    gone = [f"doc:{i}" for i in range(0, rows, 37)]
    for e in engines:
        assert e.execute("DEL", *gone) == len(gone)
        for j in range(6):
            e.execute("HSET", f"doc:{j * 13 + 1}", "v", q[j].tobytes())
    for j in range(6):
        current[f"doc:{j * 13 + 1}"] = q[j]
    searches()
    assert STATS.get("ivf_served_searches") - served == 24
