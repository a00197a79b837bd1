"""The port's parallel/ (mesh programs, ShardedHnswIndex) and entry points against the JAX package's.

The same seeded numpy inputs go through the JAX function, on conftest's 8
virtual CPU devices, and through the port, on a mesh of as many CPU
devices (S = 2, 4 and 8, and 2 x 2). Tolerances:

- sharded, replicated, dimension-sharded and consistent top-k: ids equal;
  distances within rtol 1e-5 (``tests/test_torch_topk.py``'s bound for
  ``flat_topk``; atol 1e-5 for ip, whose scores cross 0); version pairs,
  ``partial`` flags and the retry count equal. The dimension-sharded l2
  distances sum partial dots in another order than XLA's psum and cancel
  to near 0 for close rows, so they are held within 1e-5 of the terms
  they are summed from, |q|^2 + |x|^2 (``tests/test_torch_ivf.py``'s
  bound);
- ``sharded_batch_update``: bit for bit, the input unchanged;
- ``ShardedHnswIndex`` over the same keys: the same shard of every key,
  the same graphs (one native builder, one seed a shard), the SoA walk
  held as the unsharded one is (``tests/test_torch_hnsw.py``): equal keys
  on >= 99% of rows, equal key sets on every row, distances within rtol
  1e-5;
- sharded IVF over one JAX index carried across (``ivf_from_reference``):
  ids equal on >= 99% of rows, distances within 1e-5 of |q|^2 + |x|^2
  (``tests/test_torch_ivf.py``'s bounds).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from valkey_search_tpu.ops import ivf as jivf
from valkey_search_tpu.parallel import mesh as jpm
from valkey_search_tpu.parallel.fanout import ShardedHnswIndex as JaxSharded
from valkey_search_tpu_torch.ops import ivf
from valkey_search_tpu_torch.parallel import fanout
from valkey_search_tpu_torch.parallel import mesh as pm
from valkey_search_tpu_torch.runtime import device as device_mod
from valkey_search_tpu_torch.runtime.device import set_device
from valkey_search_tpu_torch.runtime.metrics import STATS
from torch_port_config import saved_options, set_both

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _cpu():
    set_device("cpu")
    with saved_options("search.prefer-partial-results"):
        yield


def cpu_mesh(n: int) -> pm.Mesh:
    return pm.make_mesh(n, devices=[CPU] * n)


def t(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x))


def assert_dists(got, want, metric="l2"):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-5,
                               atol=1e-5 if metric != "l2" else 0)


# --------------------------------------------------------------------------
# the mesh
# --------------------------------------------------------------------------


def test_make_mesh_shapes_and_cycling():
    m = pm.make_mesh(4)  # the default device is the CPU here: 4 positions
    assert m.shape == {pm.SHARD_AXIS: 4}
    assert [str(d) for d in pm.shard_devices(m)] == ["cpu"] * 4
    m2 = pm.make_mesh_2d(2, 2)
    assert m2.shape == {pm.SHARD_AXIS: 2, pm.REPLICA_AXIS: 2}
    assert pm.make_mesh(2, devices=[CPU] * 3).shape[pm.SHARD_AXIS] == 2
    # an explicit list that is too short raises, as make_mesh_2d's does
    with pytest.raises(ValueError, match="need 4 devices, have 2"):
        pm.make_mesh(4, devices=[CPU] * 2)
    with pytest.raises(ValueError, match="need 6 devices, have 4"):
        pm.make_mesh_2d(3, 2, devices=[CPU] * 4)


def test_mesh_without_a_card_raises(monkeypatch):
    # unset, the default device is cuda:0: no silent CPU fallback; without a
    # card that raises
    monkeypatch.setattr(device_mod, "_device", None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        pm.make_mesh(4)
    from valkey_search_tpu_torch import entry
    with pytest.raises(RuntimeError, match="cuda"):
        entry.dryrun_multichip(2)


@pytest.mark.parametrize("s", [2, 4, 8])
@pytest.mark.parametrize("metric,two_stage", [("l2", False), ("ip", False),
                                              ("l2", True)])
def test_sharded_flat_topk_matches_jax(rng, s, metric, two_stage):
    rows, d = 96, 16
    corpus = rng.standard_normal((s * rows, d)).astype(np.float32)
    q = rng.standard_normal((6, d)).astype(np.float32)
    invalid = rng.random(s * rows) < 0.1
    versions = rng.integers(3, 5, s).astype(np.int32)
    jd, ji, jv = jpm.sharded_flat_topk(
        jpm.make_mesh(s), jnp.asarray(corpus), jnp.asarray(q), k=7,
        metric=metric, invalid=jnp.asarray(invalid),
        shard_versions=jnp.asarray(versions), two_stage=two_stage)
    td, ti, tv = pm.sharded_flat_topk(
        cpu_mesh(s), t(corpus), t(q), k=7, metric=metric,
        invalid=t(invalid), shard_versions=t(versions), two_stage=two_stage)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert_dists(td, jd, metric)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert tv.dtype == torch.int32 and tuple(tv.shape) == (2,)


@pytest.mark.parametrize("s", [2, 8])
def test_sharded_flat_topk_filter_mask_matches_jax(rng, s):
    rows, d = 64, 8
    corpus = rng.standard_normal((s * rows, d)).astype(np.float32)
    q = rng.standard_normal((3, d)).astype(np.float32)
    allowed = rng.random(s * rows) < 0.3
    _, ji, jv = jpm.sharded_flat_topk(
        jpm.make_mesh(s), jnp.asarray(corpus), jnp.asarray(q), k=5,
        filter_mask=jnp.asarray(allowed))
    _, ti, tv = pm.sharded_flat_topk(cpu_mesh(s), t(corpus), t(q), k=5,
                                     filter_mask=t(allowed))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert allowed[ti.numpy()].all()
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_merge_ties_go_to_the_lower_shard():
    # every shard holds the same rows: equal distances everywhere
    rows = np.tile(np.eye(4, dtype=np.float32), (4, 1))
    q = np.eye(4, dtype=np.float32)[:1]
    _, ji, _ = jpm.sharded_flat_topk(jpm.make_mesh(4), jnp.asarray(rows),
                                     jnp.asarray(q), k=4)
    _, ti, _ = pm.sharded_flat_topk(cpu_mesh(4), t(rows), t(q), k=4)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(ti.numpy()[0], [0, 4, 8, 12])


@pytest.mark.parametrize("shards,replicas", [(2, 2), (4, 2)])
def test_replicated_sharded_matches_jax(rng, shards, replicas):
    corpus = rng.standard_normal((shards * 80, 12)).astype(np.float32)
    q = rng.standard_normal((replicas * 5, 12)).astype(np.float32)
    jd, ji = jpm.replicated_sharded_flat_topk(
        jpm.make_mesh_2d(shards, replicas), jnp.asarray(corpus),
        jnp.asarray(q), k=4)
    td, ti = pm.replicated_sharded_flat_topk(
        pm.make_mesh_2d(shards, replicas, devices=[CPU] * 8), t(corpus),
        t(q), k=4)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert_dists(td, jd)
    # the same rows and queries through the 1-D program
    _, i1, _ = pm.sharded_flat_topk(cpu_mesh(shards), t(corpus), t(q), k=4)
    np.testing.assert_array_equal(ti.numpy(), i1.numpy())


@pytest.mark.parametrize("s", [2, 4, 8])
def test_sharded_batch_update_matches_jax(rng, s):
    rows, d = 64, 8
    corpus = rng.standard_normal((s * rows, d)).astype(np.float32)
    ids = rng.choice(s * rows, size=3 * s, replace=False).astype(np.int32)
    vecs = rng.standard_normal((len(ids), d)).astype(np.float32)
    want = np.asarray(jpm.sharded_batch_update(
        jpm.make_mesh(s), jnp.asarray(corpus), jnp.asarray(ids),
        jnp.asarray(vecs)))
    before = corpus.copy()
    got = pm.sharded_batch_update(cpu_mesh(s), t(corpus), t(ids), t(vecs))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy()[ids], vecs)
    np.testing.assert_array_equal(corpus, before)  # the input is unchanged


def _snapshots(corpus, stale, s, lib):
    calls = {"n": 0}

    def snapshot():
        calls["n"] += 1
        v = np.full(s, 2, np.int32)
        if calls["n"] <= stale:
            v[s // 2] = 1  # one shard lags
        return ((jnp.asarray(corpus), jnp.asarray(v), None) if lib == "jax"
                else (t(corpus), t(v), None))
    return snapshot, calls


@pytest.mark.parametrize("s", [2, 4, 8])
@pytest.mark.parametrize("stale", [0, 1, 2])
def test_consistent_sharded_topk_matches_jax(rng, s, stale):
    corpus = rng.standard_normal((s * 64, 8)).astype(np.float32)
    q = rng.standard_normal((3, 8)).astype(np.float32)
    jsnap, jcalls = _snapshots(corpus, stale, s, "jax")
    tsnap, tcalls = _snapshots(corpus, stale, s, "port")
    jd, ji, jp = jpm.consistent_sharded_topk(jpm.make_mesh(s), jsnap,
                                             jnp.asarray(q), k=5)
    td, ti, tp = pm.consistent_sharded_topk(cpu_mesh(s), tsnap, t(q), k=5)
    assert tcalls["n"] == jcalls["n"] == stale + 1
    assert tp is jp is False
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert_dists(td, jd)


@pytest.mark.parametrize("s", [2, 4, 8])
def test_consistent_sharded_topk_dead_shards_match_jax(rng, s):
    rows = 64
    corpus = rng.standard_normal((s * rows, 8)).astype(np.float32)
    q = corpus[:4] + 0.01  # nearest rows on shard 0
    invalid = np.zeros(s * rows, bool)
    invalid[-1] = True
    dead = [0] if s == 2 else [0, s - 1]

    def jsnap():
        return jnp.asarray(corpus), jnp.full(s, 7, jnp.int32), \
            jnp.asarray(invalid)

    def tsnap():
        return t(corpus), torch.full((s,), 7, dtype=torch.int32), t(invalid)

    jd, ji, jp = jpm.consistent_sharded_topk(
        jpm.make_mesh(s), jsnap, jnp.asarray(q), k=5, partial_ok=True,
        dead_shards=dead)
    td, ti, tp = pm.consistent_sharded_topk(
        cpu_mesh(s), tsnap, t(q), k=5, partial_ok=True, dead_shards=dead)
    assert tp is jp is True
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    ids = ti.numpy()
    assert (ids >= rows).all() and not np.isin(ids // rows, dead).any()
    with pytest.raises(pm.MeshConsistencyError, match="partial results"):
        pm.consistent_sharded_topk(cpu_mesh(s), tsnap, t(q), k=5,
                                   dead_shards=dead)


def test_consistent_sharded_topk_exhausts_retries(rng):
    corpus = t(rng.standard_normal((4 * 32, 8)).astype(np.float32))
    calls = {"n": 0}

    def snapshot():  # never converges
        calls["n"] += 1
        return corpus, torch.tensor([1, 2, 1, 1], dtype=torch.int32), None

    with pytest.raises(pm.MeshConsistencyError,
                       match=r"did not converge after 3 attempts \(min/max "
                             r"\(1, 2\)\)"):
        pm.consistent_sharded_topk(cpu_mesh(4), snapshot, corpus[:2], k=3,
                                   max_retries=3)
    assert calls["n"] == 3


@pytest.mark.parametrize("s", [2, 4, 8])
@pytest.mark.parametrize("metric", ["l2", "cosine"])
def test_dim_sharded_matches_jax(rng, s, metric):
    corpus = rng.standard_normal((200, s * 16)).astype(np.float32)
    if metric == "cosine":
        corpus /= np.linalg.norm(corpus, axis=1, keepdims=True)
    q = corpus[:3] + 0.05 * rng.standard_normal((3, s * 16)).astype(
        np.float32)
    jd, ji = jpm.dim_sharded_flat_topk(jpm.make_mesh(s), jnp.asarray(corpus),
                                       jnp.asarray(q), k=5, metric=metric)
    td, ti = pm.dim_sharded_flat_topk(cpu_mesh(s), t(corpus), t(q), k=5,
                                      metric=metric)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    if metric == "l2":
        x = corpus[ti.numpy()]
        terms = (q * q).sum(1)[:, None] + (x * x).sum(-1)
        assert (np.abs(td.numpy() - np.asarray(jd)) <= 1e-5 * terms).all()
    else:
        assert_dists(td, jd, metric)
    assert ti.dtype == torch.int32


# --------------------------------------------------------------------------
# sharded IVF over one JAX index carried across
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ivf_pair():
    rng = np.random.default_rng(5)
    n, d = 8192, 16
    cent = rng.standard_normal((8, d)).astype(np.float32)
    a = rng.integers(0, 8, n)
    x = (cent[a] + 0.05 * rng.standard_normal((n, d))).astype(np.float32)
    jidx = jivf.build_ivf(x, block_rows=128, n_clusters=8, train_sample=4096)
    assert jidx.n_blocks % 8 == 0
    tidx = ivf.ivf_from_reference(
        {f: np.asarray(getattr(jidx, f)) for f in jivf.IvfDeviceIndex._fields},
        CPU)
    q = x[:24] + 0.005 * rng.standard_normal((24, d)).astype(np.float32)
    return x, jidx, tidx, q


def _hold_ivf(td, ti, jd, ji, q, x):
    ti, ji = ti.numpy(), np.asarray(ji)
    same = (ti == ji).all(1)
    assert same.mean() >= 0.99, same.mean()
    # distances within 1e-5 of the terms they are summed from
    ids = np.maximum(ti, 0)
    terms = (q * q).sum(1)[:, None] + (x[ids] * x[ids]).sum(-1)
    assert (np.abs(td.numpy() - np.asarray(jd)) <= 1e-5 * terms + 1e-6)[
        same].all()


@pytest.mark.parametrize("s", [2, 4, 8])
@pytest.mark.parametrize("full", [False, True])
def test_sharded_ivf_matches_jax(ivf_pair, s, full):
    x, jidx, tidx, q = ivf_pair
    probe = jidx.n_blocks if full else max(1, jidx.n_blocks // 8)
    jd, ji = jpm.sharded_ivf_topk(jpm.make_mesh(s), jidx, jnp.asarray(q),
                                  k=5, probe=probe)
    td, ti = pm.sharded_ivf_topk(cpu_mesh(s), tidx, t(q), k=5, probe=probe)
    _hold_ivf(td, ti, jd, ji, q, x)
    if full:  # every block probed: the single-device index's answer
        d1, i1 = ivf.ivf_search_batch(tidx, t(q), k=5, probe=probe)
        np.testing.assert_array_equal(ti.numpy(), i1.numpy())


@pytest.mark.parametrize("s", [2, 4, 8])
def test_sharded_ivf_rescored_matches_jax(ivf_pair, s):
    x, jidx, tidx, q = ivf_pair
    slots = jpm.rows_in_slot_order(x, jidx.block_ids)
    np.testing.assert_array_equal(pm.rows_in_slot_order(x, tidx.block_ids),
                                  slots)
    probe = max(1, jidx.n_blocks // 4)
    jd, ji = jpm.sharded_ivf_topk_rescored(
        jpm.make_mesh(s), jidx, jnp.asarray(slots), jnp.asarray(q), k=10,
        probe=probe, coarse_factor=8)
    td, ti = pm.sharded_ivf_topk_rescored(
        cpu_mesh(s), tidx, t(slots), t(q), k=10, probe=probe,
        coarse_factor=8)
    _hold_ivf(td, ti, jd, ji, q, x)
    # exact fp32 distances of the returned rows, no id twice
    ids = ti.numpy()
    exact = ((q[:, None, :] - x[np.maximum(ids, 0)]) ** 2).sum(-1)
    np.testing.assert_allclose(td.numpy(), exact, rtol=1e-4, atol=1e-4)
    for row in ids:
        live = row[row >= 0]
        assert len(live) == len(set(live.tolist()))


# --------------------------------------------------------------------------
# ShardedHnswIndex (tests/test_sharded.py:50-98 through both packages)
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def hnsw_pair():
    set_device("cpu")
    rng = np.random.default_rng(123)
    corpus = rng.standard_normal((1200, 16)).astype(np.float32)
    jidx = JaxSharded(dim=16, m=8, ef_construction=60, mesh=jpm.make_mesh(4))
    tidx = fanout.ShardedHnswIndex(dim=16, m=8, ef_construction=60,
                                   mesh=cpu_mesh(4))
    for i, v in enumerate(corpus):
        jidx.add_record(f"k{i}", v)
        tidx.add_record(f"k{i}", v)
    return jidx, tidx, corpus


def _keys(idx, docs):
    return [[idx.interner.key_of(int(x)) for x in row if x >= 0]
            for row in docs]


def _hold_walk(jidx, tidx, jd, jdocs, td, tdocs):
    jk, tk = _keys(jidx, jdocs), _keys(tidx, tdocs)
    assert np.mean([a == b for a, b in zip(jk, tk)]) >= 0.99
    assert all(set(a) == set(b) for a, b in zip(jk, tk))
    np.testing.assert_allclose(td, np.asarray(jd), rtol=1e-5)


def test_sharded_hnsw_same_shards_and_graphs(hnsw_pair):
    jidx, tidx, _ = hnsw_pair
    assert [s.count() for s in tidx.shards] == [s.count() for s in jidx.shards]
    for k in ("k0", "k1", "k777"):
        assert tidx.shard_of(k) == jidx.shard_of(k)
    for js, ts in zip(jidx.shards, tidx.shards):
        jg, tg = js.builder.export_graph(), ts.builder.export_graph()
        np.testing.assert_array_equal(tg["links0"], jg["links0"])
        assert tg["entry"] == jg["entry"]


@pytest.mark.parametrize("ef", [20, 80])
def test_sharded_hnsw_walk_matches_jax(hnsw_pair, ef):
    jidx, tidx, corpus = hnsw_pair
    q = np.random.default_rng(ef).standard_normal((8, 16)).astype(np.float32)
    before = STATS.get("fanout_searches")
    jd, jdocs = jidx.search_batch(q, k=10, ef=ef)
    td, tdocs = tidx.search_batch(q, k=10, ef=ef)
    _hold_walk(jidx, tidx, jd, jdocs, td, tdocs)
    assert STATS.get("fanout_searches") == before + 8
    # recall against brute force, as tests/test_sharded.py holds it
    want = np.argsort(((corpus[None] - q[:, None]) ** 2).sum(-1), 1)[:, :10]
    hits = sum(len({f"k{j}" for j in w} & set(g))
               for w, g in zip(want, _keys(tidx, tdocs)))
    assert hits / 80 >= 0.9


def test_sharded_hnsw_filter_matches_jax(hnsw_pair):
    jidx, tidx, corpus = hnsw_pair
    allowed = np.zeros(tidx.interner.capacity, bool)
    for i in range(50):
        allowed[tidx.interner.lookup(f"k{i}")] = True
    jd, jdocs = jidx.search_batch(corpus[500][None], k=10, ef=100,
                                  filter_mask=jnp.asarray(allowed))
    td, tdocs = tidx.search_batch(corpus[500][None], k=10, ef=100,
                                  filter_mask=t(allowed))
    _hold_walk(jidx, tidx, jd, jdocs, td, tdocs)
    got = set(_keys(tidx, tdocs)[0])
    assert got and got <= {f"k{i}" for i in range(50)}
    # the pre-filtered exact path, merged on the host
    ed, edocs = tidx.exact_search_batch(corpus[500][None], 10,
                                        filter_mask=t(allowed))
    jed, jedocs = jidx.exact_search_batch(corpus[500][None], 10,
                                          filter_mask=jnp.asarray(allowed))
    assert _keys(tidx, edocs) == _keys(jidx, jedocs)
    np.testing.assert_allclose(ed, np.asarray(jed), rtol=1e-5)


def test_sharded_hnsw_self_lookup_and_remove(hnsw_pair):
    jidx, tidx, corpus = hnsw_pair
    d, docs = tidx.search_batch(corpus[99][None], k=1, ef=60)
    assert tidx.interner.key_of(int(docs[0, 0])) == "k99"
    assert d[0, 0] == pytest.approx(0.0, abs=1e-4)
    publishes = STATS.get("sharded_graph_publishes")
    for idx in (jidx, tidx):
        idx.remove_record("k99")
    assert tidx.interner.lookup("k99") is None  # the interner released it
    jd, jdocs = jidx.search_batch(corpus[99][None], k=5, ef=60)
    td, tdocs = tidx.search_batch(corpus[99][None], k=5, ef=60)
    assert "k99" not in _keys(tidx, tdocs)[0]
    _hold_walk(jidx, tidx, jd, jdocs, td, tdocs)
    assert STATS.get("sharded_graph_publishes") == publishes + 1
    assert tidx.count() == jidx.count() == 1199
    assert min(s.count() for s in tidx.shards) > 0


def test_sharded_hnsw_epoch_retry_and_partial(hnsw_pair, monkeypatch):
    _, tidx, corpus = hnsw_pair
    tidx.search_batch(corpus[:1], k=3)   # a settled publish
    real = fanout.pm.sharded_hnsw_search
    moved = {"n": 0}

    def search_then_write(*args, **kwargs):
        out = real(*args, **kwargs)
        if moved["n"] < 5:  # a shard's epoch moves during the search
            moved["n"] += 1
            tidx.shards[1].store.epoch += 1
        return out

    monkeypatch.setattr(fanout.pm, "sharded_hnsw_search", search_then_write)
    before = STATS.get("fanout_version_retries")
    tidx.search_batch(corpus[:1], k=3)
    assert STATS.get("fanout_version_retries") == before + 3  # then accepted
    set_both("search.prefer-partial-results", True)
    tidx.search_batch(corpus[:1], k=3)
    assert STATS.get("fanout_version_retries") == before + 3


def test_sharded_hnsw_empty_index():
    idx = fanout.ShardedHnswIndex(dim=4, mesh=cpu_mesh(2))
    d, docs = idx.search_batch(np.zeros((2, 4), np.float32), k=3)
    assert np.isinf(d).all() and (docs == -1).all()


# --------------------------------------------------------------------------
# entry points
# --------------------------------------------------------------------------


def test_entry_walk_matches_jax():
    import __graft_entry__ as graft
    from valkey_search_tpu_torch import entry

    jfn, jargs = graft.entry()
    jd, ji = jfn(*jargs)
    fn, args = entry.entry(device="cpu")
    td, ti = fn(*args)
    ti, ji = ti.numpy(), np.asarray(ji)
    assert np.mean((ti == ji).all(1)) >= 0.99
    assert all(set(a) == set(b) for a, b in zip(ti, ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5)


@pytest.mark.parametrize("n", [2, 4, 8])
def test_dryrun_multichip_on_cpu(n, capsys):
    from valkey_search_tpu_torch import entry

    entry.dryrun_multichip(n, device="cpu")
    assert f"dryrun_multichip({n}): ok" in capsys.readouterr().out


def test_jax_dryrun_fails_its_self_lookup_at_four_devices():
    """The JAX package's own dryrun_multichip(4) stops at its sharded HNSW
    step: the key "s0" is not its own nearest (see the next test)."""
    import __graft_entry__ as graft

    with pytest.raises(AssertionError) as exc:
        graft.dryrun_multichip(4)
    assert '"s0"' in str(exc.traceback[-1].statement)


def _dryrun_hnsw_step(idx, n):
    """dryrun_multichip(n)'s step 3 (both packages): its seeded rows, the
    key of the first query's nearest."""
    rng = np.random.default_rng(0)
    for shape in ((n * 128, 32), (4, 32), (2, 32)):  # the draws before it
        rng.standard_normal(shape)
    sub = rng.standard_normal((n * 24, 16)).astype(np.float32)
    for i, v in enumerate(sub):
        idx.add_record(f"s{i}", v)
    _, docs = idx.search_batch(sub[:2], k=3, ef=16)
    return [idx.interner.key_of(int(x)) for x in docs[0]]


@pytest.mark.parametrize("m", [4, 8])
def test_dryrun_hnsw_step_at_m4_fails_alike_in_both_packages(m):
    """Why the port's dryrun builds its sharded HNSW at M 8, not the JAX
    package's 4: at M 4 over four shards, "s0" is a local minimum that
    neither package's walk reaches (its nearest is another key, the same in
    both); at M 8 both find it."""
    jkeys = _dryrun_hnsw_step(
        JaxSharded(dim=16, m=m, ef_construction=30, mesh=jpm.make_mesh(4)), 4)
    tkeys = _dryrun_hnsw_step(
        fanout.ShardedHnswIndex(dim=16, m=m, ef_construction=30,
                                mesh=cpu_mesh(4)), 4)
    assert tkeys == jkeys
    assert (tkeys[0] == "s0") == (m == 8)


# --------------------------------------------------------------------------
# the JAX package's slow tiers (tests/test_sharded.py:184, 250)
# --------------------------------------------------------------------------


@pytest.mark.slow
def test_mesh_large_sharded_tier(rng):
    mesh = cpu_mesh(8)
    n, d_dim = 1 << 20, 32
    corpus_np = rng.standard_normal((n, d_dim)).astype(np.float32)
    corpus = t(corpus_np)
    q_np = rng.standard_normal((8, d_dim)).astype(np.float32)
    calls = {"n": 0}

    def snapshot():
        calls["n"] += 1
        v = np.full(8, 3, np.int32)
        if calls["n"] == 1:
            v[3] = 2  # stale shard on the first attempt
        return corpus, t(v), None

    _, i, partial = pm.consistent_sharded_topk(mesh, snapshot, t(q_np), k=10)
    assert calls["n"] == 2 and not partial
    dd = ((q_np[:, None, :] - corpus_np[None]) ** 2).sum(-1)
    np.testing.assert_array_equal(i.numpy(), np.argsort(dd, 1)[:, :10])
    _, i2, partial2 = pm.consistent_sharded_topk(
        mesh, snapshot, t(q_np), k=10, partial_ok=True, dead_shards=[1, 6])
    assert partial2
    rows = n // 8
    ids2 = i2.numpy()
    for s in (1, 6):
        assert not (((ids2 >= s * rows) & (ids2 < (s + 1) * rows)).any())


@pytest.mark.slow
def test_sharded_flat_large_scale_exactness(rng):
    n, d, k, nq = 8 * 32768, 64, 10, 32
    corpus = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((nq, d)).astype(np.float32)
    _, ids, vv = pm.sharded_flat_topk(cpu_mesh(8), t(corpus), t(q), k=k)
    ids = ids.numpy()
    for s in range(0, nq, 8):
        dd = ((q[s:s + 8, None, :] - corpus[None, :, :]) ** 2).sum(-1)
        want = np.argsort(dd, axis=1, kind="stable")[:, :k]
        for g, w in zip(ids[s:s + 8], want):
            assert set(g) == set(w)
    assert int(vv[0]) == int(vv[1])
