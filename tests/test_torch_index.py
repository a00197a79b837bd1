"""The port's vector store and FLAT index against the JAX package's.

The port's index is built from the JAX index's state (``from_reference``),
so both search the same rows, ids and key map.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from valkey_search_tpu.indexes.flat import FlatVectorIndex as JaxFlat
from valkey_search_tpu.ops import topk as jtopk
from valkey_search_tpu_torch.indexes.flat import FlatVectorIndex
from valkey_search_tpu_torch.indexes.vector_base import store_from_reference
from valkey_search_tpu_torch.runtime.device import set_device
from torch_port_config import saved_options, set_both

_KEYS = ("search.corpus-dtype", "search.scan-kernel")


@pytest.fixture(autouse=True)
def _cpu_and_config():
    set_device("cpu")
    with saved_options(*_KEYS):
        yield


def _jax_index(rng, n, d, metric="l2"):
    jidx = JaxFlat(dim=d, metric=metric)
    vecs = (rng.standard_normal((n, d)) * 3).astype(np.float32)
    jidx.bulk_load([f"k{i}" for i in range(n)], vecs)
    return jidx, vecs


def _arrays(jidx):
    st = jidx.store
    return {"vectors": st.vectors, "norms_sq": st.norms_sq,
            "magnitudes": st.magnitudes, "present": st.present,
            "metric": st.metric, "block": st.block}


def _port(jidx):
    return FlatVectorIndex.from_reference(
        _arrays(jidx), dict(jidx.interner.items()), torch.device("cpu"))


def test_int8_mirror_bit_identical(rng):
    set_both("search.corpus-dtype", "int8")
    jidx, vecs = _jax_index(rng, 5000, 32)
    idx = _port(jidx)
    for step in range(3):
        jsnap = jidx.store.device_snapshot()
        snap = idx.store.device_snapshot()
        np.testing.assert_array_equal(snap["vectors_i8"].numpy(),
                                      np.asarray(jsnap["vectors_i8"]))
        assert snap["i8_scale"].dtype == torch.float32
        assert snap["i8_scale"].item() == float(jsnap["i8_scale"])
        np.testing.assert_array_equal(snap["invalid"].numpy(),
                                      np.asarray(jsnap["invalid"]))
        if step == 0:  # a scatter publish: a few rows within the range
            for i in (3, 17, 4000):
                row = vecs[i] * 0.5
                jidx.add_record(f"k{i}", row)
                idx.add_record(f"k{i}", row)
            jidx.remove_record("k9")
            idx.remove_record("k9")
        elif step == 1:  # past the published range: a fresh global scale
            row = np.full(32, 1e3, np.float32)
            jidx.add_record("k5", row)
            idx.add_record("k5", row)


def test_scatter_publish_keeps_old_snapshots(rng):
    set_both("search.corpus-dtype", "bfloat16")
    jidx, vecs = _jax_index(rng, 3000, 16)
    idx = _port(jidx)
    old = idx.store.device_snapshot()
    before = old["vectors"].clone()
    epoch = idx.store.epoch
    idx.add_record("k1", vecs[2])
    new = idx.store.device_snapshot()
    assert idx.store.epoch == epoch + 1
    assert torch.equal(old["vectors"], before)  # never written again
    assert torch.equal(new["vectors"][1], torch.from_numpy(vecs[2]))
    assert torch.equal(new["vectors_lp"][1],
                       torch.from_numpy(vecs[2]).to(torch.bfloat16))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("metric", ["l2", "ip", "cosine"])
def test_search_batch_matches_jax(rng, dtype, metric):
    set_both("search.corpus-dtype", dtype)
    jidx, _ = _jax_index(rng, 3000, 32, metric)
    for key in ("k4", "k77", "k2999"):
        jidx.remove_record(key)
    idx = _port(jidx)
    q = rng.standard_normal((5, 32)).astype(np.float32)
    jd, ji = jidx.search_batch(q, 10)
    td, ti = idx.search_batch(q, 10)
    np.testing.assert_array_equal(ti, np.asarray(ji))
    np.testing.assert_allclose(td, np.asarray(jd), rtol=1e-5)
    assert not np.isin(ti, [4, 77, 2999]).any()


def test_fused_path_through_search_batch_matches_jax(rng):
    """At 131,072 rows with scan-kernel "pallas", search_batch routes to the
    fused int8 scan (on the CPU: K1's plain version)."""
    set_both("search.corpus-dtype", "int8")
    set_both("search.scan-kernel", "pallas")
    n, d, k = 131072, 16, 10
    jidx, _ = _jax_index(rng, n, d)
    for i in range(0, n, 97):
        jidx.remove_record(f"k{i}")
    idx = _port(jidx)
    q = rng.standard_normal((4, d)).astype(np.float32)
    jsnap = jidx.store.device_snapshot()
    jd, ji = jtopk.flat_topk_fused(
        jnp.asarray(q), jsnap["vectors"], None, k=k,
        corpus_sq=jsnap["norms_sq"], invalid=jsnap["invalid"],
        block_rows=n, corpus_i8=jsnap["vectors_i8"],
        i8_scale=jsnap["i8_scale"], interpret=True)
    td, ti = idx.search_batch(q, k)
    np.testing.assert_array_equal(ti, np.asarray(ji))
    np.testing.assert_allclose(td, np.asarray(jd), rtol=1e-5)
    assert (ti % 97 != 0).all()


def test_store_from_reference_copies(rng):
    jidx, _ = _jax_index(rng, 100, 8)
    st = jidx.store
    port = store_from_reference(st.vectors, st.norms_sq, st.magnitudes,
                                st.present, metric="l2", block=st.block,
                                device=torch.device("cpu"))
    port.clear_row(0)
    assert st.present[0] and not port.present[0]
    assert port.capacity == st.capacity and port.device.type == "cpu"


def _blob(idx, rng, mask):
    v = np.array([1.0, 2.0, 3.0, 4.0], np.float32)
    idx.add_record("a", v.tobytes())
    return [idx.search(v, k=1)]


def _remove_modify(idx, rng, mask):
    a = rng.standard_normal(8).astype(np.float32)
    b = rng.standard_normal(8).astype(np.float32)
    idx.add_record("a", a)
    idx.add_record("b", b)
    idx.remove_record("a")
    out = [idx.search(a, k=2)]
    idx.modify_record("b", a)
    return out + [idx.search(a, k=1)]


def _cosine(idx, rng, mask):
    v = rng.standard_normal(16).astype(np.float32)
    idx.add_record("v", v * 5.0)
    idx.add_record("w", rng.standard_normal(16).astype(np.float32))
    return [idx.search(v, k=1)]


def _many(idx, rng, mask):
    corpus = rng.standard_normal((300, 32)).astype(np.float32)
    for i, v in enumerate(corpus):
        idx.add_record(f"doc:{i}", v)
    qs = rng.standard_normal((5, 32)).astype(np.float32)
    allowed = None
    if mask:  # odd docs only
        allowed = np.arange(idx.store.capacity) % 2 == 1
        allowed = (jnp.asarray(allowed) if isinstance(idx, JaxFlat)
                   else torch.from_numpy(allowed))
    return [idx.search(q, k=10, filter_mask=allowed) for q in qs]


@pytest.mark.parametrize("case,dim,metric,mask", [
    (_blob, 4, "l2", False),            # test_flat_index.py's blob round trip
    (_remove_modify, 8, "l2", False),   # ... remove and modify
    (_cosine, 16, "cosine", False),     # ... cosine normalization
    (_many, 32, "l2", False),
    (_many, 32, "l2", True),
    (_many, 32, "ip", True),
], ids=["blob", "remove_modify", "cosine", "unfiltered", "masked_l2",
        "masked_ip"])
def test_single_query_search_matches_jax(case, dim, metric, mask):
    """FlatVectorIndex.search, the single-query wrapper over search_batch:
    the same calls on an index of each package give the same keys in the
    same order, distances within rtol 1e-5."""
    got = []
    for idx in (JaxFlat(dim=dim, metric=metric),
                FlatVectorIndex(dim=dim, metric=metric,
                                device=torch.device("cpu"))):
        got.append(case(idx, np.random.default_rng(3), mask))
    want, port = got
    assert [[k for k, _ in r] for r in port] == [[k for k, _ in r]
                                                 for r in want]
    for p, w in zip(port, want):
        np.testing.assert_allclose([d for _, d in p], [d for _, d in w],
                                   rtol=1e-5, atol=1e-6)
    if mask:
        assert all(int(k.split(":")[1]) % 2 == 1 for r in port for k, _ in r)
