"""The port's TAG and NUMERIC indexes against the JAX package's.

The same HSETs go through the JAX Engine and the port's, so both allocate
the same doc ids. For each filter, both packages' parsers build the
predicate, and its ``estimate``, ``host_ids`` and device mask must be equal
(the masks bit for bit), as must the non-vector FT.SEARCH replies. The
mask-capacity case checks the port's repair where the JAX package raises.
"""

import sys
import threading

import numpy as np
import pytest
import torch

from valkey_search_tpu.query import parser as jparser
from valkey_search_tpu.query import predicate as jpred
from valkey_search_tpu.server.engine import Engine as JaxEngine
from valkey_search_tpu_torch.query import parser as tparser
from valkey_search_tpu_torch.query import predicate as tpred
from valkey_search_tpu_torch.runtime.device import set_device
from valkey_search_tpu_torch.server.engine import Engine
from torch_port_config import saved_options, set_both

TAGS = ["red", "Red", "blue", "bluegreen", "green", "ab", "abc", "Abd", "x y"]


@pytest.fixture(autouse=True)
def _cpu_and_config():
    set_device("cpu")
    with saved_options("search.corpus-dtype"):
        yield


def _run(engines, *argv):
    replies = [e.execute(*argv) for e in engines]
    assert replies[1] == replies[0], argv
    return replies[0]


def _ids(x):
    return np.sort(np.fromiter(x, np.int64)) if not isinstance(x, np.ndarray) \
        else np.sort(x.astype(np.int64))


def _same_filter(engines, query):
    """estimate, host ids and device mask equal in both packages."""
    (jeng, teng) = engines
    jschema, tschema = jeng.manager.get("idx"), teng.manager.get("idx")
    jp, _ = jparser.parse_query(query, {})
    tp, _ = tparser.parse_query(query, {})
    jctx, tctx = jpred.EvalContext(jschema), tpred.EvalContext(tschema)
    assert tctx.cap == jctx.cap
    assert tp.estimate(tctx) == jp.estimate(jctx), query
    np.testing.assert_array_equal(_ids(tp.host_ids(tctx)),
                                  _ids(jp.host_ids(jctx)), err_msg=query)
    tmask = tp.device_mask(tctx)
    assert tmask.dtype == torch.bool and tmask.device.type == "cpu"
    np.testing.assert_array_equal(tmask.numpy(),
                                  np.asarray(jp.device_mask(jctx)),
                                  err_msg=query)
    return tmask.numpy()


def _tag_engines(rng, n=600):
    engines = (JaxEngine(), Engine())
    _run(engines, "FT.CREATE", "idx", "ON", "HASH", "PREFIX", "1", "d:",
         "SCHEMA", "t", "TAG", "cs", "TAG", "CASESENSITIVE",
         "sep", "TAG", "SEPARATOR", ";")
    for i in range(n):
        pick = rng.choice(TAGS, size=rng.integers(0, 3), replace=False)
        _run(engines, "HSET", f"d:{i}", "t", " , ".join(pick),
             "cs", ",".join(pick), "sep", ";".join(pick))
    return engines


TAG_QUERIES = [
    "@t:{red}", "@t:{RED}", "@t:{blu*}", "@t:{red|green}", "@t:{ab*}",
    "@t:{abd}", "@t:{nosuch}", "@t:{x y}", "@cs:{Red}", "@cs:{red}",
    "@cs:{Ab*}", "@sep:{x y}", "@sep:{bluegreen|ab}", "-@t:{red}",
    "@t:{ab*} @cs:{Red}", "@t:{red} | @sep:{abc}",
]


@pytest.mark.parametrize("query", TAG_QUERIES)
def test_tag_filters_match(rng, query):
    engines = _tag_engines(rng)
    _same_filter(engines, query)
    _run(engines, "FT.SEARCH", "idx", query, "LIMIT", "0", "1000",
         "NOCONTENT")


def test_tag_mask_cache_follows_updates_and_deletes(rng):
    engines = _tag_engines(rng, 300)
    teng = engines[1]
    before = _same_filter(engines, "@t:{red|blu*}")
    schema = teng.manager.get("idx")
    docs = {f"d:{i}": schema.interner.lookup(f"d:{i}") for i in range(300)}
    moved = [k for k, d in docs.items() if d is not None and before[d]][:10]
    assert moved
    for key in moved[:5]:
        _run(engines, "HSET", key, "t", "green")
    _run(engines, "DEL", *moved[5:])
    _run(engines, "HSET", "d:new", "t", "blue")
    after = _same_filter(engines, "@t:{red|blu*}")
    for key in moved:
        doc = schema.interner.lookup(key)
        assert doc is None or not after[doc]
    assert after[schema.interner.lookup("d:new")]
    _same_filter(engines, "@t:{green}")


@pytest.mark.parametrize("tags", [["red"], ["red", "blu*"]])
def test_tag_mask_is_the_callers_own(tags):
    """Writing a returned mask in place leaves the per-tag cache intact."""
    engine = Engine()
    engine.execute("FT.CREATE", "idx", "SCHEMA", "t", "TAG")
    for i in range(50):
        engine.execute("HSET", f"d:{i}", "t", ("red", "blue", "green")[i % 3])
    index = engine.manager.get("idx").attribute("t").index
    cap = engine.manager.get("idx").doc_capacity()
    want = index.device_mask(tags, cap).clone()
    assert want.any()
    index.device_mask(tags, cap).fill_(False)
    index.device_mask(tags, cap).logical_not_()
    assert torch.equal(index.device_mask(tags, cap), want)


def _numeric_engines(rng, n=500):
    engines = (JaxEngine(), Engine())
    _run(engines, "FT.CREATE", "idx", "ON", "HASH", "PREFIX", "1", "d:",
         "SCHEMA", "p", "NUMERIC", "t", "TAG")
    special = {0: str(2**24 + 1), 1: str(2**24), 2: "-3.5", 3: "1e30",
               4: "abc", 5: "nan", 6: "inf", 7: "-0"}
    for i in range(n):
        value = special.get(i, str(int(rng.integers(-50, 1000))))
        _run(engines, "HSET", f"d:{i}", "p", value, "t", TAGS[i % 4])
    return engines


NUMERIC_QUERIES = [
    "@p:[0 99]", "@p:[(0 (99]", "@p:[-inf +inf]", "@p:[-10 (0]",
    f"@p:[{2**24 + 1} {2**24 + 1}]", f"@p:[{2**24} {2**24}]",
    f"@p:[({2**24} +inf]", "@p:[1e29 +inf]", "@p:[-3.5 -3.5]",
    "@p:[0 499] @t:{red}", "@p:[0 99] | @p:[900 999]", "-@p:[0 500]",
]


@pytest.mark.parametrize("query", NUMERIC_QUERIES)
def test_numeric_filters_match(rng, query):
    engines = _numeric_engines(rng)
    _same_filter(engines, query)
    _run(engines, "FT.SEARCH", "idx", query, "LIMIT", "0", "1000",
         "SORTBY", "p", "RETURN", "1", "p")
    _run(engines, "FT.SEARCH", "idx", query, "SORTBY", "p", "DESC",
         "WITHSORTKEYS", "NOCONTENT")


def test_numeric_column_and_invalid_values(rng):
    engines = _numeric_engines(rng)
    jschema, tschema = (e.manager.get("idx") for e in engines)
    cap = tschema.doc_capacity()
    assert cap == jschema.doc_capacity()
    tcol = tschema.attribute("p").index.device_column(cap)
    jcol = jschema.attribute("p").index.device_column(cap)
    np.testing.assert_array_equal(tcol.numpy(), np.asarray(jcol))
    # "abc" and "nan" are invalid: the key leaves every index
    for e in engines:
        for key in ("d:4", "d:5"):
            assert e.manager.get("idx").interner.lookup(key) is None
    infos = [e.execute("FT.INFO", "idx") for e in engines]
    for info in infos:
        for attr in info[7]:
            assert attr[-2] == "user_indexed_memory" and attr[-1] > 0
    # the TAG's bytes too: the port keeps the raw-value column
    assert infos[1] == infos[0]
    assert infos[1][8:12] == ["num_docs", 498, "num_records", 996]
    # 2^24 + 1 rounds to 2^24 on the device: both masks take d:0 for
    # [2^24 2^24], and both hosts hold the float64 value 2^24 + 1
    doc0 = tschema.interner.lookup("d:0")
    assert _same_filter(engines, f"@p:[{2**24} {2**24}]")[doc0]
    assert tschema.attribute("p").index.value_of("d:0") == 2**24 + 1


def test_numeric_updates_scatter_into_the_column(rng):
    engines = _numeric_engines(rng, 300)
    _same_filter(engines, "@p:[0 99]")
    for i in range(10, 20):
        _run(engines, "HSET", f"d:{i}", "p", "50")
    _run(engines, "DEL", "d:20", "d:21")
    _run(engines, "HSET", "d:22", "t", "red")  # p removed from d:22
    mask = _same_filter(engines, "@p:[50 50]")
    schema = engines[1].manager.get("idx")
    assert all(mask[schema.interner.lookup(f"d:{i}")] for i in range(10, 20))
    _same_filter(engines, "@p:[-inf +inf]")


def test_mask_capacity_repair():
    """20 docs carry a vector and a tag, 2,980 only the tag: the tag mask
    spans 3,000 doc ids, the vector store 2,048 rows. The port answers with
    the 3 nearest vector-bearing docs; the JAX package fails to broadcast."""
    set_both("search.corpus-dtype", "float32")
    rng = np.random.default_rng(5)
    vecs = rng.standard_normal((20, 4)).astype(np.float32)
    q = rng.standard_normal(4).astype(np.float32)
    engines = (JaxEngine(), Engine())
    for e in engines:
        e.execute("FT.CREATE", "idx", "SCHEMA", "v", "VECTOR", "FLAT", "6",
                  "TYPE", "FLOAT32", "DIM", "4", "DISTANCE_METRIC", "L2",
                  "t", "TAG")
        for i in range(20):
            e.execute("HSET", f"k{i}", "v", vecs[i].tobytes(), "t", "a")
        for i in range(20, 3000):
            e.execute("HSET", f"k{i}", "t", "a")
    schema = engines[1].manager.get("idx")
    assert schema.doc_capacity() == 3000
    assert schema.attribute("v").index.store.capacity == 2048
    argv = ("FT.SEARCH", "idx", "@t:{a}=>[KNN 3 @v $q]", "PARAMS", "2", "q",
            q.tobytes(), "NOCONTENT")
    with pytest.raises(ValueError, match="broadcast"):
        engines[0].execute(*argv)
    want = np.argsort(((vecs.astype(np.float64) - q) ** 2).sum(1))[:3]
    assert engines[1].execute(*argv) == [3] + [f"k{i}" for i in want]


def test_tag_mask_cache_under_concurrent_writes():
    """Readers build masks while a writer moves docs between tags (short
    switch interval): afterwards the cached masks equal the postings."""
    engine = Engine()
    engine.execute("FT.CREATE", "idx", "SCHEMA", "t", "TAG")
    for i in range(400):
        engine.execute("HSET", f"d:{i}", "t", "red" if i % 2 else "blue")
    index = engine.manager.get("idx").attribute("t").index
    cap = engine.manager.get("idx").doc_capacity()
    stop = threading.Event()

    def read():
        while not stop.is_set():
            index.device_mask(["red"], cap)
            index.device_mask(["blue", "re*"], cap)

    saved = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        readers = [threading.Thread(target=read) for _ in range(6)]
        for t in readers:
            t.start()
        for j in range(600):
            engine.execute("HSET", f"d:{j % 400}", "t",
                           "blue" if (j // 400 + j) % 2 else "red")
        stop.set()
        for t in readers:
            t.join(60)
        assert not any(t.is_alive() for t in readers)
    finally:
        sys.setswitchinterval(saved)
    for tag in ("red", "blue"):
        want = np.zeros(cap, bool)
        want[list(index._postings.get(tag, ()))] = True
        np.testing.assert_array_equal(index.device_mask([tag], cap).numpy(),
                                      want)
