"""Hybrid filtered FT.SEARCH: the port against the JAX package.

- The same commands (VECTOR + TAG + NUMERIC + TEXT, HSETs, updates, DELs)
  through both Engines: hybrid replies agree (float32 and int8 below the
  fused scan's size: equal keys, scores within rtol 1e-5; bfloat16: the
  keys at recall >= 0.99), and every returned key satisfies the filter.
- A schema of the port built from the JAX schema's exported host state
  (``schema_from_reference``) has the same doc ids, so filter masks and KNN
  ids compare bit for bit.
- A masked ``flat_topk_fused`` at 131,072 rows (the fused scan's size)
  against the JAX package's in interpret mode.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from valkey_search_tpu.indexes.flat import FlatVectorIndex as JaxFlat
from valkey_search_tpu.ops import topk as jtopk
from valkey_search_tpu.query import parser as jparser
from valkey_search_tpu.query import predicate as jpred
from valkey_search_tpu.server.engine import Engine as JaxEngine
from valkey_search_tpu_torch.indexes.flat import FlatVectorIndex
from valkey_search_tpu_torch.query import parser as tparser
from valkey_search_tpu_torch.query import predicate as tpred
from valkey_search_tpu_torch.runtime.device import set_device
from valkey_search_tpu_torch.schema.index_schema import schema_from_reference
from valkey_search_tpu_torch.server.engine import Engine
from valkey_search_tpu_torch.utils.interning import KeyInterner
from torch_port_config import saved_options, set_both

DIM, ROWS = 16, 3000
VOCAB = ["alpha", "bravo", "charlie", "delta", "echo", "foxtrot", "golf"]
_KEYS = ("search.corpus-dtype", "search.scan-kernel")


@pytest.fixture(autouse=True)
def _cpu_and_config():
    set_device("cpu")
    with saved_options(*_KEYS):
        yield


def _both(rng, metric):
    engines = (JaxEngine(), Engine())
    rows = rng.standard_normal((ROWS, DIM)).astype(np.float32)
    cats = rng.integers(0, 20, ROWS)
    prices = rng.integers(0, 1000, ROWS)
    titles = [" ".join(rng.choice(VOCAB, 3)) for _ in range(ROWS)]
    for e in engines:
        e.execute("FT.CREATE", "idx", "ON", "HASH", "PREFIX", "1", "doc:",
                  "SCHEMA", "v", "VECTOR", "FLAT", "6", "TYPE", "FLOAT32",
                  "DIM", str(DIM), "DISTANCE_METRIC", metric, "cat", "TAG",
                  "price", "NUMERIC", "title", "TEXT")
        for i in range(ROWS):
            e.execute("HSET", f"doc:{i}", "v", rows[i].tobytes(),
                      "cat", f"c{cats[i]}", "price", str(prices[i]),
                      "title", titles[i])
        for i in range(0, ROWS, 50):  # moves between categories
            e.execute("HSET", f"doc:{i}", "cat", "c3")
        e.execute("DEL", *[f"doc:{i}" for i in range(1, ROWS, 61)])
    return engines


FILTERS = ["@cat:{c3}", "@price:[0 99]", "@price:[0 499]",
           "(@cat:{c3} @price:[0 499])", "@title:charlie", "-@cat:{c3}",
           "(@cat:{c1*} | @price:[990 +inf])"]


def _hybrid(q, flt, k=10):
    return ("FT.SEARCH", "idx", f"{flt}=>[KNN {k} @v $q]", "PARAMS", "2",
            "q", q.tobytes(), "RETURN", "2", "__v_score", "price")


def _qualified(engine, flt):
    reply = engine.execute("FT.SEARCH", "idx", flt, "LIMIT", "0", "10000",
                           "NOCONTENT")
    return set(reply[1:])


@pytest.mark.parametrize("dtype", ["float32", "int8"])
@pytest.mark.parametrize("metric", ["L2", "IP", "COSINE"])
def test_hybrid_replies_match(rng, dtype, metric):
    set_both("search.corpus-dtype", dtype)
    engines = _both(rng, metric)
    for flt in FILTERS:
        allowed = _qualified(engines[1], flt)
        assert allowed == _qualified(engines[0], flt)
        for q in rng.standard_normal((3, DIM)).astype(np.float32):
            want, got = (e.execute(*_hybrid(q, flt)) for e in engines)
            assert got[0] == want[0] and got[1::2] == want[1::2], flt
            np.testing.assert_allclose(
                [float(r[1]) for r in got[2::2]],
                [float(r[1]) for r in want[2::2]], rtol=1e-5)
            assert [r[2:] for r in got[2::2]] == [r[2:] for r in want[2::2]]
            assert set(got[1::2]) <= allowed


@pytest.mark.parametrize("metric", ["L2", "IP", "COSINE"])
def test_hybrid_bfloat16_keys_match(rng, metric):
    set_both("search.corpus-dtype", "bfloat16")
    engines = _both(rng, metric)
    hits = total = 0
    for flt in FILTERS:
        allowed = _qualified(engines[1], flt)
        for q in rng.standard_normal((4, DIM)).astype(np.float32):
            want, got = (e.execute(*_hybrid(q, flt)) for e in engines)
            hits += len(set(got[1::2]) & set(want[1::2]))
            total += len(want[1::2])
            assert set(got[1::2]) <= allowed
    assert hits / total >= 0.99


def _export(jschema):
    """The JAX schema's host state as plain values (numpy and dicts)."""
    attrs = []
    for alias, a in jschema.attributes.items():
        ix = a.index
        entry = {"alias": alias, "identifier": a.identifier, "kind": a.kind}
        if a.kind == "TAG":
            entry.update(separator=ix.separator,
                         case_sensitive=ix.case_sensitive)
        elif a.kind == "TEXT":
            entry.update(no_stem=ix.info.no_stem,
                         with_suffix_trie=ix.info.with_suffix_trie,
                         weight=ix.info.weight)
        elif a.kind == "FLAT":
            st = ix.store
            entry["arrays"] = {
                "vectors": st.vectors, "norms_sq": st.norms_sq,
                "magnitudes": st.magnitudes, "present": st.present,
                "metric": st.metric, "block": st.block}
        attrs.append(entry)
    return {"name": jschema.name, "prefixes": list(jschema.prefixes),
            "on": jschema.on, "text_options": jschema.text_options,
            "keys_by_doc": dict(jschema.interner.items()),
            "interner_capacity": jschema.interner.capacity,
            "documents": {k: jschema.document(k)
                          for k in list(jschema._documents)},
            "attributes": attrs}


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_schema_from_reference_same_ids_and_masks(rng, dtype):
    set_both("search.corpus-dtype", dtype)
    jeng = JaxEngine()
    jeng.execute("FT.CREATE", "idx", "ON", "HASH", "PREFIX", "1", "doc:",
                 "SCHEMA", "v", "VECTOR", "FLAT", "6", "TYPE", "FLOAT32",
                 "DIM", str(DIM), "DISTANCE_METRIC", "L2", "cat", "TAG",
                 "price", "NUMERIC", "title", "TEXT")
    rows = rng.standard_normal((ROWS, DIM)).astype(np.float32)
    for i in range(ROWS):
        fields = ["cat", f"c{i % 20}", "price", str(i % 1000),
                  "title", " ".join(rng.choice(VOCAB, 3))]
        if i % 9:  # every ninth doc has no vector
            fields += ["v", rows[i].tobytes()]
        jeng.execute("HSET", f"doc:{i}", *fields)
    # free ids, then reuse some: doc ids no longer follow the key order
    jeng.execute("DEL", *[f"doc:{i}" for i in range(0, ROWS, 7)])
    for i in range(200):
        jeng.execute("HSET", f"new:{i}" if i % 2 else f"doc:{i * 7}",
                     "cat", "c3", "v", rows[i].tobytes())
    jschema = jeng.manager.get("idx")
    tschema = schema_from_reference(_export(jschema), torch.device("cpu"))
    assert dict(tschema.interner.items()) == dict(jschema.interner.items())
    # the port's own interner, rebuilt from the reference's state
    assert isinstance(tschema.interner, KeyInterner)
    assert tschema.interner is not jschema.interner
    jindex, tindex = jschema.attribute("v").index, tschema.attribute("v").index
    assert tindex.count() == jindex.count()
    q = rng.standard_normal((4, DIM)).astype(np.float32)
    for flt in FILTERS:
        jp, _ = jparser.parse_query(flt, {})
        tp, _ = tparser.parse_query(flt, {})
        jctx, tctx = jpred.EvalContext(jschema), tpred.EvalContext(tschema)
        assert tctx.cap == jctx.cap
        jmask, tmask = jp.device_mask(jctx), tp.device_mask(tctx)
        np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
        jd, ji = jindex.search_batch(q, 10, filter_mask=jmask)
        td, ti = tindex.search_batch(q, 10, filter_mask=tmask)
        np.testing.assert_array_equal(ti, np.asarray(ji))
        np.testing.assert_allclose(td, np.asarray(jd), rtol=1e-5)


@pytest.mark.parametrize("dtype", ["int8", "bfloat16"])
def test_masked_fused_scan_matches_jax(rng, dtype):
    """At 131,072 rows with scan-kernel "pallas", a filtered search_batch
    runs the fused scan (on the CPU: K1's or K2's plain version)."""
    set_both("search.corpus-dtype", dtype)
    set_both("search.scan-kernel", "pallas")
    n, d, k = 131072, 16, 10
    jidx = JaxFlat(dim=d, metric="l2")
    jidx.bulk_load([f"k{i}" for i in range(n)],
                   (rng.standard_normal((n, d)) * 3).astype(np.float32))
    for i in range(0, n, 97):
        jidx.remove_record(f"k{i}")
    st = jidx.store
    idx = FlatVectorIndex.from_reference(
        {"vectors": st.vectors, "norms_sq": st.norms_sq,
         "magnitudes": st.magnitudes, "present": st.present,
         "metric": st.metric, "block": st.block},
        dict(jidx.interner.items()), torch.device("cpu"))
    allowed = rng.random(n) < 0.1
    q = rng.standard_normal((4, d)).astype(np.float32)
    jsnap = st.device_snapshot()
    jd, ji = jtopk.flat_topk_fused(
        jnp.asarray(q), jsnap["vectors"], jsnap.get("vectors_lp"), k=k,
        corpus_sq=jsnap["norms_sq"], invalid=jsnap["invalid"],
        filter_mask=jnp.asarray(allowed), block_rows=n,
        corpus_i8=jsnap.get("vectors_i8"), i8_scale=jsnap.get("i8_scale"),
        interpret=True)
    td, ti = idx.search_batch(q, k, filter_mask=torch.from_numpy(allowed))
    assert allowed[ti].all() and (ti % 97 != 0).all()
    if dtype == "int8":  # exact keys: the same candidates, the same order
        np.testing.assert_array_equal(ti, np.asarray(ji))
        np.testing.assert_allclose(td, np.asarray(jd), rtol=1e-5)
    else:  # K2's sums may round apart: the keys at recall >= 0.99
        same = np.mean([len(set(ti[i]) & set(np.asarray(ji)[i])) / k
                        for i in range(len(q))])
        assert same >= 0.99
