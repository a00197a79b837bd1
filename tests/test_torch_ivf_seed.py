"""The streaming IVF build's seed spread, held seed by seed from the JAX
package's own k-means starting rows.

The two packages draw their k-means starting rows from different
generators (``jax.random`` against ``torch.Generator``), so their builds
differ at every seed. Here the port's ``kmeans_fit`` and
``kmeans_fit_batched`` are patched to start ``_lloyd`` and
``_lloyd_batched`` from the rows the JAX package draws:

- level 1: ``jax.random.permutation(PRNGKey(seed), n)[:k]``
  (``valkey_search_tpu/ops/ivf.py`` ``kmeans_fit``, ``valid is None``);
- level 2: ``argsort(uniform(PRNGKey(seed), (C, R)) + 1e9 * ~valid)[:, :k]``
  (``kmeans_fit_batched``).

From the same rows the builds still part, at floating-point near-ties
only: an argmin whose two best scores ``|c|^2 - 2 bf16(x).bf16(c)`` lie
within a few f32 ulps of each other goes one way in one package and the
other way in the other (the two sum ``|c|^2`` and the products in another
order). A level-2 flip moves one centroid; a pass-1 flip moves one row to
another cell and so shifts the slot of every later row of its level-1
cluster. The tests hold each stage from the same inputs:

- level 1 from the carried rows: centroids within rtol/atol 1e-5 and the
  same cluster for >= 99.9% of the corpus;
- level 2 from the carried rows, one Lloyd step at a time from the JAX
  package's centroids: every centroid within rtol/atol 1e-5 but those a
  near-tie row could move (two best scores within ``TIE_ULPS`` f32 ulps of
  the row's score scale, exact arithmetic);
- pass 1 from the JAX package's fit: assignments equal but at near-tie rows
  (at most 0.1%), projections within rtol/atol 1e-5 (the layout from the
  same pass-1 arrays is held equal in ``test_torch_ivf_streaming.py``);
- the whole ``build_ivf_streaming`` at seeds 0-15 in the setup of
  ``test_torch_ivf_streaming.py::test_recall_matches_jax_streaming_build``:
  with the JAX package's fit carried, recall@10 at probe 8 within 0.005 of
  the JAX build's at every seed; with only the starting rows carried,
  within 0.005 at every seed where the level-2 fit did not part, within
  0.01 where a near-tie parted it, and the means over the 16 seeds within
  0.005. The per-seed table and the spreads are printed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_ivf_streaming import brute, clustered, recall_at_k, sources
from valkey_search_tpu.ops import ivf as jivf
from valkey_search_tpu_torch.ops import ivf
from valkey_search_tpu_torch.runtime.device import set_device

N, D, CHUNKS = 20480, 48, 5
BLOCK_ROWS, CLUSTERS, ALIGN, PROBE = 256, 16, 8, 8
ITERS = 12  # build_ivf_streaming's kmeans_iters
SEEDS = range(16)
TIE_ULPS = 2
TOL = dict(rtol=1e-5, atol=1e-5)
EPS32 = float(np.finfo(np.float32).eps)


@pytest.fixture(autouse=True)
def _cpu():
    set_device("cpu")


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def corpus():
    """The existing streaming recall test's corpus, queries and truth."""
    x = clustered(np.random.default_rng(0), N, D, centers=32)
    q = x[:128]
    return x, q, brute(q, x, 10)


def sample_of(x):
    return x[:N // CHUNKS]  # the build's fit sample: chunk 0 (4,096 rows)


# -- the JAX package's starting rows ------------------------------------------


def jax_level1_rows(seed, n, k):
    perm = jax.random.permutation(jax.random.PRNGKey(seed), n)
    return np.asarray(perm[:k]).astype(np.int64)


def jax_level2_rows(seed, valid, k):
    v = jnp.asarray(valid)
    u = jax.random.uniform(jax.random.PRNGKey(seed), v.shape) + jnp.where(
        v, 0.0, 1e9)
    return np.asarray(jnp.argsort(u, axis=1)[:, :k]).astype(np.int64)


def carried_kmeans_fit(x, n_clusters, iters=12, seed=0, valid=None):
    assert valid is None  # _fit_two_level_device's level 1
    rows = t(jax_level1_rows(seed, x.shape[0], n_clusters)).to(x.device)
    x = x.to(torch.float32)
    return ivf._lloyd(x, x[rows], None, iters)


def carried_kmeans_fit_batched(x, valid, k_each, iters=8, seed=0):
    x = x.to(torch.float32)
    pos = t(jax_level2_rows(seed, valid.cpu().numpy(), k_each)).to(x.device)
    cent = torch.gather(x, 1, pos[:, :, None].expand(-1, -1, x.shape[2]))
    return ivf._lloyd_batched(x, cent, valid, iters)


def carry_seeds(mp):
    mp.setattr(ivf, "kmeans_fit", carried_kmeans_fit)
    mp.setattr(ivf, "kmeans_fit_batched", carried_kmeans_fit_batched)


# -- near-ties ----------------------------------------------------------------


def _bf16_f64(a):
    return t(np.asarray(a, np.float32)).to(torch.bfloat16).double().numpy()


def near_ties(x, cent, cvalid=None):
    """Rows whose argmin over ``|c|^2 - 2 bf16(x).bf16(c)`` could go either
    way in f32: the two best scores, in exact arithmetic, lie within
    TIE_ULPS ulps of the row's score scale (|c|^2 + 2 sum|x c|).

    x [..., r, d], cent [..., k, d] (or [..., r, k, d], one table a row),
    cvalid [..., k] (or [..., r, k]). Returns (tie [..., r] bool,
    near [..., r, k] bool: the candidates within that gap of the best)."""
    xb, cb = _bf16_f64(x), _bf16_f64(cent)
    c64 = np.asarray(cent, np.float64)
    per_row = cb.ndim == xb.ndim + 1
    if per_row:
        dots = np.einsum("...rd,...rkd->...rk", xb, cb)
        mag = np.einsum("...rd,...rkd->...rk", np.abs(xb), np.abs(cb))
        csq = (c64 * c64).sum(-1)
    else:
        dots = np.einsum("...rd,...kd->...rk", xb, cb)
        mag = np.einsum("...rd,...kd->...rk", np.abs(xb), np.abs(cb))
        csq = (c64 * c64).sum(-1)[..., None, :]
    s = csq - 2.0 * dots
    if cvalid is not None:
        cv = np.asarray(cvalid)
        s = np.where(cv if per_row else cv[..., None, :], s, np.inf)
    tol = TIE_ULPS * EPS32 * (csq + 2.0 * mag).max(-1)
    two = np.sort(s, axis=-1)[..., :2]
    tie = two[..., 1] - two[..., 0] <= tol
    near = s <= two[..., :1] + tol[..., None]
    return tie, near


# -- level 1 ------------------------------------------------------------------


@pytest.mark.parametrize("seed", SEEDS)
def test_level1_from_carried_rows(corpus, monkeypatch, seed):
    x = corpus[0]
    carry_seeds(monkeypatch)
    sample = sample_of(x)
    want = np.asarray(jivf.kmeans_fit(jnp.asarray(sample), CLUSTERS,
                                      iters=ITERS, seed=seed))
    got = ivf.kmeans_fit(t(sample), CLUSTERS, iters=ITERS, seed=seed).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    ja = jivf._assign_sample_device(jnp.asarray(x), jnp.asarray(want),
                                    CLUSTERS)
    ta = ivf._assign_sample_device(t(x), t(got), CLUSTERS)
    assert float((ja == ta).mean()) >= 0.999


# -- level 2 ------------------------------------------------------------------


def _level2_inputs(x, seed):
    """The level-2 fit's tables, mask and size, as the port's build hands
    them to kmeans_fit_batched after its level-1 fit from carried rows."""
    seen = {}

    def spy(tables, valid, k_each, iters=8, seed=0):
        seen.update(tables=tables.numpy().copy(), valid=valid.numpy().copy(),
                    k_each=k_each, iters=iters, seed=seed)
        return carried_kmeans_fit_batched(tables, valid, k_each, iters, seed)

    with pytest.MonkeyPatch.context() as mp:
        carry_seeds(mp)
        mp.setattr(ivf, "kmeans_fit_batched", spy)
        ivf._fit_two_level_device(t(sample_of(x)), CLUSTERS, BLOCK_ROWS, N,
                                  kmeans_iters=ITERS, seed=seed)
    return seen


@pytest.mark.parametrize("seed", SEEDS)
def test_level2_steps_part_only_at_ties(corpus, seed):
    """Each Lloyd step of the port's level-2 fit from the JAX package's
    centroids of the step before lands on the JAX package's next centroids,
    but where a near-tie row could move one."""
    seen = _level2_inputs(corpus[0], seed)
    tables, valid, k = seen["tables"], seen["valid"], seen["k_each"]
    assert seen["seed"] == seed and seen["iters"] == max(4, ITERS // 2)
    jt, jv = jnp.asarray(tables), jnp.asarray(valid)
    prev = np.asarray(jivf.kmeans_fit_batched(jt, jv, k, iters=0, seed=seed))
    # iteration 0 is the starting rows themselves
    np.testing.assert_array_equal(
        prev, np.take_along_axis(
            tables, jax_level2_rows(seed, valid, k)[:, :, None], axis=1))
    for i in range(1, seen["iters"] + 1):
        nxt = np.asarray(jivf.kmeans_fit_batched(jt, jv, k, iters=i,
                                                 seed=seed))
        step = ivf._lloyd_batched(t(tables), t(prev), t(valid), 1).numpy()
        tie, near = near_ties(tables, prev)
        movable = (near & (tie & valid)[:, :, None]).any(1)      # [C, k]
        np.testing.assert_allclose(step[~movable], nxt[~movable], **TOL,
                                   err_msg=f"seed {seed}, step {i}")
        prev = nxt


# -- pass 1 -------------------------------------------------------------------


@pytest.mark.parametrize("seed", SEEDS)
def test_pass1_from_the_jax_fit_parts_only_at_ties(corpus, seed):
    x = corpus[0]
    c1, c2, c2v, pc1, c2max = jivf._fit_two_level_device(
        jnp.asarray(sample_of(x)), CLUSTERS, BLOCK_ROWS, N,
        kmeans_iters=ITERS, seed=seed)
    ch = N // CHUNKS
    out = np.asarray(jivf._assign_proj_at(jnp.asarray(x), 0, c1, c2, c2v,
                                          pc1, N, c2max))
    ja, jp = out[0].astype(np.int64), out[1].view(np.float32)
    parts = [ivf._assign_proj_at(t(x[s:s + ch]), t(c1), t(c2), t(c2v),
                                 t(pc1), c2max) for s in range(0, N, ch)]
    ta = torch.cat([a for a, _ in parts]).numpy()
    tp = torch.cat([p for _, p in parts]).numpy()
    np.testing.assert_allclose(tp, jp, **TOL)
    diff = ja != ta
    assert float(diff.mean()) <= 0.001
    if diff.any():
        xs = x[diff]
        tie1, _ = near_ties(xs, np.asarray(c1))
        # level 2 in the JAX package's cluster and in the port's
        ties2 = [near_ties(xs, np.asarray(c2)[a // c2max],
                           np.asarray(c2v)[a // c2max])[0]
                 for a in (ja[diff], ta[diff])]
        assert (tie1 | ties2[0] | ties2[1]).all(), np.nonzero(diff)


# -- the whole streaming build --------------------------------------------------


@pytest.fixture(scope="module")
def builds(corpus):
    """Per seed: recall@10 at probe 8 of the JAX build, of the port's build
    from the carried starting rows and of the port's build from the JAX
    package's whole fit; and whether the carried-rows level-2 fit parted
    from the JAX package's."""
    set_device("cpu")
    x, q, truth = corpus
    tsrc, jsrc, _ = sources(x, CHUNKS)
    sample = sample_of(x)
    kw = dict(block_rows=BLOCK_ROWS, n_clusters=CLUSTERS, block_align=ALIGN)
    out = {}
    for seed in SEEDS:
        jfit = jivf._fit_two_level_device(
            jnp.asarray(sample), CLUSTERS, BLOCK_ROWS, N, kmeans_iters=ITERS,
            seed=seed)
        jfit_t = tuple(t(a) for a in jfit[:4]) + (jfit[4],)
        jidx = jivf.build_ivf_streaming(jsrc, CHUNKS, seed=seed, **kw)
        _, ji = jivf.ivf_search_batch(jidx, jnp.asarray(q), k=10, probe=PROBE)
        with pytest.MonkeyPatch.context() as mp:
            carry_seeds(mp)
            tfit = ivf._fit_two_level_device(
                t(sample), CLUSTERS, BLOCK_ROWS, N, kmeans_iters=ITERS,
                seed=seed)
            ridx = ivf.build_ivf_streaming(tsrc, CHUNKS, seed=seed, **kw)

            def jax_fit(sample_d, *args, **kwargs):
                assert torch.equal(sample_d, t(sample))
                return jfit_t

            mp.setattr(ivf, "_fit_two_level_device", jax_fit)
            fidx = ivf.build_ivf_streaming(tsrc, CHUNKS, seed=seed, **kw)
        _, ri = ivf.ivf_search_batch(ridx, t(q), k=10, probe=PROBE)
        _, fi = ivf.ivf_search_batch(fidx, t(q), k=10, probe=PROBE)
        parted = not np.allclose(tfit[1].numpy(), np.asarray(jfit[1]), **TOL)
        out[seed] = dict(jax=recall_at_k(np.asarray(ji), truth),
                         rows=recall_at_k(ri, truth),
                         fit=recall_at_k(fi, truth), parted=parted)
    return out


@pytest.mark.parametrize("seed", SEEDS)
def test_build_from_the_jax_fit_per_seed(builds, seed):
    b = builds[seed]
    assert abs(b["fit"] - b["jax"]) <= 0.005, b


@pytest.mark.parametrize("seed", SEEDS)
def test_build_from_carried_rows_per_seed(builds, seed):
    b = builds[seed]
    bound = 0.01 if b["parted"] else 0.005
    assert abs(b["rows"] - b["jax"]) <= bound, b


def test_seed_spread(builds):
    rows = [builds[s] for s in SEEDS]
    print("\nseed  jax      port(rows) port(fit)  level-2 parted")
    for s, b in zip(SEEDS, rows):
        print(f"{s:4d}  {b['jax']:.5f}  {b['rows']:.5f}    {b['fit']:.5f}"
              f"    {b['parted']}")
    stats = {k: (float(np.mean([b[k] for b in rows])),
                 float(np.std([b[k] for b in rows])))
             for k in ("jax", "rows", "fit")}
    for k, (m, sd) in stats.items():
        print(f"{k:5s} mean {m:.5f} std {sd:.5f}")
    assert abs(stats["rows"][0] - stats["jax"][0]) <= 0.005, stats
    assert abs(stats["fit"][0] - stats["jax"][0]) <= 0.005, stats
