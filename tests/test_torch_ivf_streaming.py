"""The port's IVF tier beyond device memory against the JAX package's, on the CPU.

``build_ivf_streaming`` and ``ivf_search_rescored_streaming`` read the
corpus from a chunk source; here both packages get the same numpy chunks.
The two builds seed their k-means from different generators (an accepted
divergence, as for every IVF build: ``tests/test_torch_ivf.py``), so the
build is held by its invariants and by recall:

- every row in exactly one slot, the block count a multiple of
  ``block_align``;
- the passes' helpers equal the JAX package's on the same inputs (sums and
  counts within rtol 1e-6, maxima, codes and norms bit for bit);
- centroids within rtol 2e-5 of each block's mean (the JAX package's own
  test holds them so), scales equal to the residual maximum from that
  centroid / 127; codes and norms equal to ``quantize_blocks``' coding of
  the same layout with the build's centroids and scales, bit for bit; and
  against ``quantize_blocks`` itself, whose centroid sums run in another
  order: scales within rtol 1e-5, codes equal on >= 99.9% of entries and
  never more than 1 apart;
- recall@10 within 0.01 of the JAX package's streaming build at the same
  probe, each the mean over the builds of 8 k-means seeds (one build's
  recall moves by up to +-0.02 with its seed in either package).

The streaming rescore is held over one JAX index carried across
(``ivf_from_reference``): ids equal, distances within 1e-5 of |q|^2 +
|x|^2; and equal, ids and distances, to the port's ``ivf_search_rescored``
with the whole corpus resident.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from valkey_search_tpu.ops import ivf as jivf
from valkey_search_tpu_torch.ops import ivf
from valkey_search_tpu_torch.runtime.device import set_device

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _cpu():
    set_device("cpu")


def t(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x))


def clustered(rng, n, d, centers=64, spread=0.08):
    c = rng.normal(size=(centers, d)).astype(np.float32)
    a = rng.integers(0, centers, size=n)
    x = c[a] + spread * rng.normal(size=(n, d)).astype(np.float32)
    return np.ascontiguousarray(x, np.float32)


def brute(queries, corpus, k):
    d = ((queries * queries).sum(1)[:, None]
         + (corpus * corpus).sum(1)[None, :] - 2.0 * queries @ corpus.T)
    return np.argsort(d, axis=1, kind="stable")[:, :k]


def recall_at_k(ids, truth):
    hits = sum(len(set(row[row >= 0].tolist()) & set(t.tolist()))
               for row, t in zip(np.asarray(ids), truth))
    return hits / truth.size


def sources(x, n_chunks):
    """The same chunks for both packages: (port source, JAX source, rows)."""
    ch = len(x) // n_chunks
    tc = [torch.from_numpy(x[i * ch:(i + 1) * ch].copy())
          for i in range(n_chunks)]
    jc = [jnp.asarray(x[i * ch:(i + 1) * ch]) for i in range(n_chunks)]
    return (lambda ci: tc[ci]), (lambda ci: jc[ci]), ch


def carry(jidx):
    return ivf.ivf_from_reference(
        {f: np.asarray(getattr(jidx, f)) for f in jivf.IvfDeviceIndex._fields},
        CPU)


@pytest.mark.parametrize("align", [1, 4, 8])
def test_partitions_every_row_once(rng, align):
    x = clustered(rng, 8192, 32, centers=16)
    src, _, _ = sources(x, 4)
    idx = ivf.build_ivf_streaming(src, 4, block_rows=128, n_clusters=8,
                                  block_align=align)
    ids = idx.block_ids.numpy().reshape(-1)
    live = ids[ids >= 0]
    assert len(live) == 8192 and len(np.unique(live)) == 8192
    assert idx.n_blocks % align == 0
    assert idx.blocks_i8.dtype == torch.int8
    assert tuple(idx.blocks_i8.shape) == (idx.n_blocks, 128, 32)
    np.testing.assert_array_equal(idx.block_valid.numpy(),
                                  (idx.block_ids.numpy() >= 0).any(1))


@pytest.mark.parametrize("by_cluster,align", [(True, 8), (False, 0)])
@pytest.mark.parametrize("live", [False, True])
def test_layout_plan_is_the_jax_packages_plan(rng, by_cluster, align, live):
    """One device sort gives the JAX package's np.unique + np.lexsort plan
    (both builds there): the same order, slots and block counts, with
    tied and signed-zero projections and assignments that skip cells."""
    n, c2max, s = 6000, 6, 16
    assign64 = (rng.integers(0, 40, n) * 3).astype(np.int64)  # gaps
    proj = rng.integers(-4, 5, n).astype(np.float32) * 0.5     # ties
    proj[proj == 0] = rng.choice(np.float32([0.0, -0.0]),
                                 int((proj == 0).sum()))
    pos_live = np.sort(rng.choice(n, 4500, replace=False)) if live else None
    order, pos, nb, nb_pad = ivf._layout_plan(
        t(assign64), t(proj), c2max, s, align, by_cluster=by_cluster,
        pos_live=pos_live)
    a64 = assign64 if pos_live is None else assign64[pos_live]
    p = proj if pos_live is None else proj[pos_live]
    _, cell = np.unique(a64, return_inverse=True)
    _, l1 = np.unique(a64 // c2max, return_inverse=True)
    want = np.lexsort((p, cell))
    wpos, wnb, wnb_pad = jivf.plan_blocks(l1 if by_cluster else cell, want,
                                          s, block_align=align)
    np.testing.assert_array_equal(order, want)
    np.testing.assert_array_equal(pos, wpos)
    assert (nb, nb_pad) == (wnb, wnb_pad)


def test_helpers_match_jax(rng):
    s, nb, d, n = 16, 8, 12, 100
    xc = rng.standard_normal((n, d)).astype(np.float32)
    dslot = rng.permutation(nb * s)[:n].astype(np.int32)
    csum0 = rng.standard_normal((nb, d)).astype(np.float32)
    cnt0 = rng.integers(0, 5, nb).astype(np.float32)
    jsum, jcnt = jivf._acc_block_means(jnp.asarray(csum0), jnp.asarray(cnt0),
                                       jnp.asarray(xc), jnp.asarray(dslot), s)
    tsum, tcnt = torch.from_numpy(csum0.copy()), torch.from_numpy(cnt0.copy())
    ivf._acc_block_means(tsum, tcnt, torch.from_numpy(xc),
                         torch.from_numpy(dslot).long(), s)
    np.testing.assert_allclose(tsum.numpy(), np.asarray(jsum), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_array_equal(tcnt.numpy(), np.asarray(jcnt))

    cents = rng.standard_normal((nb, d)).astype(np.float32)
    amax0 = np.abs(rng.standard_normal(nb)).astype(np.float32)
    jam = jivf._acc_block_amax(jnp.asarray(amax0), jnp.asarray(xc),
                               jnp.asarray(dslot), jnp.asarray(cents), s)
    tam = torch.from_numpy(amax0.copy())
    ivf._acc_block_amax(tam, torch.from_numpy(xc),
                        torch.from_numpy(dslot).long(),
                        torch.from_numpy(cents), s)
    np.testing.assert_array_equal(tam.numpy(), np.asarray(jam))

    scale = (np.abs(rng.standard_normal(nb)) / 40 + 0.01).astype(np.float32)
    codes0 = np.zeros((nb * s, d), np.int8)
    rowsq0 = np.zeros(nb * s, np.float32)
    jcodes, jrowsq = jivf._quant_scatter(
        jnp.asarray(codes0), jnp.asarray(rowsq0), jnp.asarray(xc),
        jnp.asarray(dslot), jnp.asarray(cents), jnp.asarray(scale), s)
    tcodes, trowsq = torch.from_numpy(codes0.copy()), torch.from_numpy(
        rowsq0.copy())
    ivf._quant_scatter(tcodes, trowsq, torch.from_numpy(xc),
                       torch.from_numpy(dslot).long(),
                       torch.from_numpy(cents), torch.from_numpy(scale), s)
    np.testing.assert_array_equal(tcodes.numpy(), np.asarray(jcodes))
    np.testing.assert_allclose(trowsq.numpy(), np.asarray(jrowsq), rtol=1e-6)


def test_codes_match_quantize_blocks(rng):
    x = clustered(rng, 4096, 16, centers=4)
    src, _, _ = sources(x, 2)
    idx = ivf.build_ivf_streaming(src, 2, block_rows=64, n_clusters=4,
                                  block_align=1)
    ids = idx.block_ids
    valid = ids >= 0
    rows = torch.where(valid[:, :, None],
                       torch.from_numpy(x)[ids.clamp_min(0).long()], 0.0)
    codes, cent, _, scale, row_sq, bvalid = ivf.quantize_blocks(rows, ids)
    live = bvalid.numpy()
    np.testing.assert_array_equal(idx.block_valid.numpy(), live)
    np.testing.assert_allclose(idx.centroids.numpy()[live], cent.numpy()[live],
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(idx.block_scale.numpy()[live],
                               scale.numpy()[live], rtol=1e-5)
    # the scale is the residual maximum from the build's own centroid / 127
    resid = torch.where(valid[:, :, None],
                        rows - idx.centroids[:, None, :], 0.0)
    assert torch.equal(idx.block_scale[bvalid],
                       (resid.abs().amax((1, 2)).clamp_min(1e-30)
                        / 127.0)[bvalid])
    # quantize_blocks' coding with the build's own centroids and scales
    own = torch.clamp(torch.round(
        (rows - idx.centroids[:, None, :]) / idx.block_scale[:, None, None]),
        -127, 127).to(torch.int8)
    own = torch.where(valid[:, :, None], own, 0)
    assert torch.equal(idx.blocks_i8, own)
    recon = idx.centroids[:, None, :] + own.float() * idx.block_scale[
        :, None, None]
    np.testing.assert_array_equal(
        idx.row_sq.numpy()[valid.numpy()],
        (recon * recon).sum(2).numpy()[valid.numpy()])
    # and quantize_blocks itself
    diff = (idx.blocks_i8.int() - codes.int()).abs()[valid]
    assert int(diff.max()) <= 1 and float((diff == 0).float().mean()) >= 0.999
    same = (valid & (idx.blocks_i8 == codes).all(2)).numpy()  # rows alike
    np.testing.assert_allclose(idx.row_sq.numpy()[same], row_sq.numpy()[same],
                               rtol=1e-4, atol=1e-3)


def test_recall_matches_jax_streaming_build(rng):
    x = clustered(rng, 20480, 48, centers=32)
    q = x[:128]
    truth = brute(q, x, 10)
    tsrc, jsrc, _ = sources(x, 5)
    r_j, r_t = [], []
    for seed in range(8):
        jidx = jivf.build_ivf_streaming(jsrc, 5, block_rows=256,
                                        n_clusters=16, block_align=8,
                                        seed=seed)
        tidx = ivf.build_ivf_streaming(tsrc, 5, block_rows=256,
                                       n_clusters=16, block_align=8,
                                       seed=seed)
        assert tidx.n_blocks % 8 == 0
        _, ji = jivf.ivf_search_batch(jidx, jnp.asarray(q), k=10, probe=8)
        _, ti = ivf.ivf_search_batch(tidx, torch.from_numpy(q), k=10,
                                     probe=8)
        r_j.append(recall_at_k(np.asarray(ji), truth))
        r_t.append(recall_at_k(ti, truth))
    assert abs(np.mean(r_t) - np.mean(r_j)) <= 0.01, (r_t, r_j)
    assert min(r_t) >= 0.88


def test_build_timings_and_log(rng):
    x = clustered(rng, 4096, 16, centers=8)
    src, _, _ = sources(x, 4)
    timings, lines = {}, []
    ivf.build_ivf_streaming(src, 4, block_rows=64, n_clusters=4,
                            block_align=4, timings=timings,
                            log_fn=lines.append)
    assert set(timings) == {"sample_fit_s", "assign_s", "plan_s", "means_s",
                            "amax_s", "quantize_s"}
    assert all(v >= 0 for v in timings.values())
    assert lines[0].startswith("ivf-streaming: fit")
    assert lines[-1] == "ivf-streaming: pass 3 done"


@pytest.fixture(scope="module")
def carried():
    """One JAX streaming index carried across, the corpus and queries."""
    rng = np.random.default_rng(3)
    x = clustered(rng, 20480, 48, centers=32)
    q = x[:96] + 0.01 * rng.normal(size=(96, 48)).astype(np.float32)
    _, jsrc, ch = sources(x, 5)
    jidx = jivf.build_ivf_streaming(jsrc, 5, block_rows=256, n_clusters=16,
                                    block_align=8)
    return x, q, jidx, carry(jidx), ch


@pytest.mark.parametrize("probe,cf", [(4, 4), (16, 8), (0, 8)])
def test_streaming_rescore_matches_jax_and_resident(carried, probe, cf):
    x, q, jidx, tidx, ch = carried
    probe = probe or tidx.n_blocks
    tsrc, jsrc, _ = sources(x, 5)
    jd, ji = jivf.ivf_search_rescored_streaming(
        jidx, jnp.asarray(q), jsrc, 5, ch, k=10, probe=probe,
        coarse_factor=cf, sync_every=2)
    td, ti = ivf.ivf_search_rescored_streaming(
        tidx, torch.from_numpy(q), tsrc, 5, ch, k=10, probe=probe,
        coarse_factor=cf)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    ids = np.maximum(ti.numpy(), 0)
    terms = (q * q).sum(1)[:, None] + (x[ids] * x[ids]).sum(-1)
    assert (np.abs(td.numpy() - np.asarray(jd)) <= 1e-5 * terms).all()
    # the resident corpus's rescore: the same candidates, the same scores
    rd, ri = ivf.ivf_search_rescored(tidx, torch.from_numpy(q),
                                     torch.from_numpy(x), k=10, probe=probe,
                                     coarse_factor=cf)
    assert torch.equal(ti, ri) and torch.equal(td, rd)
    for row in ti.numpy():
        live = row[row >= 0]
        assert len(live) == len(set(live.tolist()))
    if probe == tidx.n_blocks:
        assert recall_at_k(ti, brute(q, x, 10)) >= 0.999


def test_rescored_merge_drops_duplicates_as_jax_does():
    cand = np.array([[5, 3, 5, -1, 3, 7], [1, 1, 1, 1, 2, -1]], np.int32)
    best = np.array([[0.5, 0.2, 0.5, np.inf, 0.2, 0.9],
                     [0.1, 0.1, 0.1, 0.1, 0.3, np.inf]], np.float32)
    jd, ji = jivf._rescored_merge(jnp.asarray(best), jnp.asarray(cand), 4)
    td, ti = ivf._rescored_merge(torch.from_numpy(best),
                                 torch.from_numpy(cand), 4)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(ti.numpy(), [[3, 5, 7, -1], [1, 2, -1, -1]])


def test_streaming_rescore_beats_no_rescore(rng):
    x = clustered(rng, 16384, 32, centers=8, spread=0.02)
    q = x[:128] + 0.002 * rng.normal(size=(128, 32)).astype(np.float32)
    truth = brute(q, x, 10)
    src, _, ch = sources(x, 4)
    idx = ivf.build_ivf_streaming(src, 4, block_rows=128, n_clusters=8,
                                  block_align=4)
    probe = min(16, idx.n_blocks)
    _, i_raw = ivf.ivf_search_batch(idx, torch.from_numpy(q), k=10,
                                    probe=probe)
    _, i_r = ivf.ivf_search_rescored_streaming(
        idx, torch.from_numpy(q), src, 4, ch, k=10, probe=probe)
    r_raw, r_res = recall_at_k(i_raw, truth), recall_at_k(i_r, truth)
    assert r_res >= r_raw and r_res >= 0.95
