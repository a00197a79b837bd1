"""FT.AGGREGATE through the port against the JAX package.

Both engines get the same argv (documents from a numpy seed) and must give
equal replies, or errors of the same type and message. Aggregates over a KNN
query carry distances computed by each package's own scan, so their numeric
strings are compared within rtol 1e-5 with the rows in the same order; every
other reply is compared for equality. Covered: KNN and hybrid aggregates,
every reducer, APPLY, FILTER, SORTBY (MAX), LIMIT, LOAD (fields, ``*``,
``@__key``), PARAMS, TIMEOUT, DIALECT 2/3 on HASH and JSON, the columnar
GROUPBY route with its fall-backs (a write since the search, an untracked
raw value, pending TTLs), and the ``agg_*`` / ``aggregate_*`` counters.
"""

import numpy as np
import pytest

from valkey_search_tpu.runtime.metrics import STATS as JSTATS
from valkey_search_tpu.server import ft_aggregate as jagg
from valkey_search_tpu_torch.indexes.tag import TagIndex
from valkey_search_tpu_torch.runtime.device import set_device
from valkey_search_tpu_torch.runtime.metrics import STATS as TSTATS
from valkey_search_tpu_torch.server import ft_aggregate as tagg
from valkey_search_tpu_torch.utils import cancel as tcancel
from torch_port_both import Both
from torch_port_config import saved_options, set_both

DIM, ROWS = 16, 400
CATS = ["red", "green", "blue", "Grey, dark", "x"]


@pytest.fixture(autouse=True)
def _cpu_and_config():
    set_device("cpu")
    with saved_options("search.corpus-dtype"):
        set_both("search.corpus-dtype", "float32")
        yield


@pytest.fixture(scope="module")
def shop():
    """400 products: vector, TAG cat, NUMERIC price and rating, TEXT title."""
    set_device("cpu")
    with saved_options("search.corpus-dtype"):
        set_both("search.corpus-dtype", "float32")
        rng = np.random.default_rng(7)
        both = Both()
        both.same("FT.CREATE", "idx", "ON", "HASH", "PREFIX", "1", "p:",
                  "SCHEMA", "v", "VECTOR", "FLAT", "6", "TYPE", "FLOAT32",
                  "DIM", str(DIM), "DISTANCE_METRIC", "L2", "cat", "TAG",
                  "price", "NUMERIC", "rating", "NUMERIC", "title", "TEXT")
        vecs = rng.standard_normal((ROWS, DIM)).astype(np.float32)
        for i in range(ROWS):
            both.same("HSET", f"p:{i:04d}", "v", vecs[i].tobytes(), "cat",
                      CATS[int(rng.integers(0, len(CATS)))], "price",
                      str(int(rng.integers(1, 500))), "rating",
                      f"{rng.uniform(1, 5):.2f}", "title",
                      "running shoes" if i % 3 else "leather boots")
        both.q = rng.standard_normal((4, DIM)).astype(np.float32)
        yield both


KNN = "*=>[KNN 40 @v $q]"
HYBRID = "(@cat:{red|blue} @price:[50 400])=>[KNN 25 @v $q AS dist]"

KNN_PIPELINES = [
    (KNN, "LOAD", "2", "@cat", "@price", "GROUPBY", "1", "@cat", "REDUCE",
     "COUNT", "0", "AS", "n", "REDUCE", "AVG", "1", "@price", "AS", "p",
     "SORTBY", "2", "@n", "DESC"),
    (KNN, "LOAD", "1", "@__v_score", "SORTBY", "2", "@__v_score", "ASC",
     "LIMIT", "0", "7"),
    (KNN, "LOAD", "3", "@__key", "@price", "@__v_score", "APPLY",
     "@price * 2 + @__v_score", "AS", "s", "FILTER", "@price > 100",
     "SORTBY", "2", "@__v_score", "ASC", "MAX", "30"),
    (KNN, "GROUPBY", "1", "@cat", "REDUCE", "COUNT", "0", "AS", "c"),
    (KNN, "LOAD", "*", "LIMIT", "0", "3"),
    (HYBRID, "LOAD", "3", "@cat", "@price", "@dist", "SORTBY", "2", "@dist",
     "ASC"),
    (HYBRID, "LOAD", "2", "@cat", "@rating", "GROUPBY", "1", "@cat",
     "REDUCE", "MIN", "1", "@rating", "AS", "lo", "REDUCE", "MAX", "1",
     "@rating", "AS", "hi", "REDUCE", "SUM", "1", "@rating", "AS", "s",
     "REDUCE", "STDDEV", "1", "@rating", "AS", "sd", "REDUCE",
     "COUNT_DISTINCT", "1", "@rating", "AS", "cd", "SORTBY", "2", "@cat",
     "ASC"),
    ("(@title:boots)=>[KNN 10 @v $q]", "LOAD", "2", "@title", "@price",
     "APPLY", "upper(@title)", "AS", "t", "SORTBY", "2", "@price", "DESC"),
]


@pytest.mark.parametrize("pipeline", range(len(KNN_PIPELINES)))
def test_knn_aggregate_matches_the_reference(shop, pipeline):
    query, *stages = KNN_PIPELINES[pipeline]
    for q in shop.q:
        reply = shop.close("FT.AGGREGATE", "idx", query, "PARAMS", "2", "q",
                           q.tobytes(), *stages, rtol=1e-5)
        assert reply[0] >= 1


PLAIN_PIPELINES = [
    ("@price:[0 inf]", "LOAD", "2", "@price", "@rating", "APPLY",
     "@price+@rating", "AS", "sum", "SORTBY", "2", "@price", "ASC",
     "DIALECT", "2"),
    ("@price:[0 inf]", "LOAD", "2", "@price", "@cat", "FILTER",
     "@price > 250", "APPLY", "@price * 2", "AS", "doubled", "SORTBY", "2",
     "@price", "ASC", "LIMIT", "0", "5"),
    ("@price:[100 200]", "GROUPBY", "1", "@cat", "REDUCE", "COUNT", "0",
     "AS", "n"),
    ("@price:[100 200]", "GROUPBY", "1", "@cat", "REDUCE", "COUNT", "0"),
    ("*", "GROUPBY", "1", "@cat", "REDUCE", "COUNT", "0", "AS", "n",
     "SORTBY", "2", "@cat", "DESC", "LIMIT", "0", "2"),
    ("*", "LOAD", "1", "@price", "GROUPBY", "0", "REDUCE", "SUM", "1",
     "@price", "AS", "total", "REDUCE", "AVG", "1", "@price", "AS", "avg",
     "REDUCE", "STDDEV", "1", "@price", "AS", "sd"),
    ("*", "LOAD", "2", "@cat", "@price", "GROUPBY", "1", "@cat", "REDUCE",
     "COUNT_DISTINCT", "1", "@price", "AS", "d", "REDUCE", "MIN", "1",
     "@price", "AS", "lo", "REDUCE", "MAX", "1", "@price", "AS", "hi",
     "SORTBY", "4", "@d", "DESC", "@cat", "ASC"),
    ("@title:boots", "LOAD", "1", "@title", "GROUPBY", "1", "@title",
     "REDUCE", "COUNT", "0", "AS", "c"),
    ("@rating:[4 5]", "LOAD", "*", "SORTBY", "2", "@rating", "DESC", "MAX",
     "4"),
    ("*", "LOAD", "1", "@__key", "GROUPBY", "1", "@__key", "REDUCE", "COUNT",
     "0", "AS", "c", "SORTBY", "2", "@__key", "ASC", "LIMIT", "0", "3"),
    ("@price:[$lo $hi]", "PARAMS", "4", "lo", "10", "hi", "60", "LOAD", "1",
     "@price", "SORTBY", "2", "@price", "ASC"),
    ("*", "SORTBY", "1", "@cat", "LIMIT", "0", "5"),
    ("*", "LOAD", "1", "@price", "APPLY", "floor(@price / 100)", "AS",
     "bucket", "GROUPBY", "1", "@bucket", "REDUCE", "COUNT", "0", "AS", "n",
     "SORTBY", "2", "@bucket", "ASC"),
    ("*", "LOAD", "1", "@price", "APPLY", "@nosuch + 1", "AS", "x"),
    ("*", "LOAD", "1", "@v"),
    ("*", "LOAD", "1", "@price", "FILTER", "@price >"),
    ("*", "GROUPBY", "1", "@cat", "REDUCE", "NOSUCH", "0"),
    ("*", "GROUPBY", "1", "@cat", "REDUCE", "SUM", "0"),
    ("*", "LIMIT", "0"),
    ("*", "DIALECT", "1"), ("*", "DIALECT", "5"), ("*", "DIALECT", "x"),
    ("*", "TIMEOUT", "0"),
    ("*", "TIMEOUT", "1000", "LIMIT", "0", "2"),
    ("@nosuch:{x}",),
    ("*", "BOGUS"),
]


@pytest.mark.parametrize("pipeline", range(len(PLAIN_PIPELINES)))
def test_aggregate_matches_the_reference(shop, pipeline):
    shop.same("FT.AGGREGATE", "idx", *PLAIN_PIPELINES[pipeline])


def test_unknown_index_and_arity_errors_match(shop):
    shop.same("FT.AGGREGATE", "nosuch", "*")
    shop.same("FT.AGGREGATE", "idx")
    shop.same("FT.AGGREGATE")


# -- HASH and JSON reply shapes ---------------------------------------------------


@pytest.fixture(scope="module")
def hash_and_json():
    set_device("cpu")
    both = Both()
    both.same("FT.CREATE", "hidx", "ON", "HASH", "PREFIX", "1", "h:",
              "SCHEMA", "n1", "AS", "n1", "NUMERIC", "n2", "AS", "n2",
              "NUMERIC", "t1", "AS", "t1", "TAG", "t2", "AS", "t2", "TAG")
    both.same("FT.CREATE", "jidx", "ON", "JSON", "PREFIX", "1", "j:",
              "SCHEMA", "$.n1", "AS", "n1", "NUMERIC", "$.n2", "AS", "n2",
              "NUMERIC", "$.t1", "AS", "t1", "TAG", "$.t2", "AS", "t2", "TAG")
    for i in range(10):
        both.same("HSET", f"h:{i:04d}", "n1", str(i), "n2", str(i * 10),
                  "t1", f"tag_a{i % 3}", "t2", f"tag_b{i % 5}")
        both.same("JSON.SET", f"j:{i:04d}", "$",
                  '{"n1": %d, "n2": %d, "t1": "tag_a%d", "t2": "tag_b%d"}'
                  % (i, i * 10, i % 3, i % 5))
    both.same("FT.CREATE", "aidx", "ON", "JSON", "PREFIX", "1", "a:",
              "SCHEMA", "$.n", "AS", "n", "NUMERIC", "$.tags[*]", "AS", "t",
              "TAG")
    both.same("JSON.SET", "a:1", "$",
              '{"n": 1, "arr": [1, 2, 3], "tags": ["a", "b"]}')
    return both


SHAPES = [
    ("LOAD", "2", "@n1", "@n2", "SORTBY", "2", "@n1", "ASC", "DIALECT", "2"),
    ("LOAD", "2", "@t1", "@t2", "SORTBY", "2", "@t1", "ASC", "DIALECT", "2"),
    ("LOAD", "2", "@n1", "@n2", "APPLY", "@n1*@n2", "AS", "product",
     "SORTBY", "2", "@n1", "ASC"),
    ("LOAD", "1", "@t1", "GROUPBY", "1", "@t1", "REDUCE", "COUNT", "0", "AS",
     "n", "REDUCE", "SUM", "1", "@n1", "AS", "total", "SORTBY", "2", "@t1",
     "ASC"),
    ("LOAD", "1", "@t1", "SORTBY", "2", "@t1", "ASC", "LIMIT", "0", "1",
     "DIALECT", "3"),
    ("LOAD", "1", "@n1", "APPLY", "@n1 * 2", "AS", "d", "SORTBY", "2", "@n1",
     "ASC", "LIMIT", "0", "1", "DIALECT", "3"),
    ("LOAD", "*", "LIMIT", "0", "2"),
    ("GROUPBY", "1", "@t1", "REDUCE", "COUNT", "0", "AS", "c"),
]


@pytest.mark.parametrize("index", ["hidx", "jidx"])
@pytest.mark.parametrize("shape", range(len(SHAPES)))
def test_reply_shape_matches_the_reference(hash_and_json, index, shape):
    reply = hash_and_json.same("FT.AGGREGATE", index, "@n1:[0 inf]",
                               *SHAPES[shape])
    assert reply[0] >= 1


def test_json_arrays_and_multivalue_tags_match(hash_and_json):
    for dialect in ("2", "3"):
        reply = hash_and_json.same("FT.AGGREGATE", "aidx", "@n:[0 5]", "LOAD",
                                   "2", "@arr", "@t", "DIALECT", dialect)
        row = dict(zip(reply[1][::2], reply[1][1::2]))
        assert row["arr"] == ["1", "2", "3"]
        assert row["t"] == ("a,b" if dialect == "2" else "[a,b]")


# -- the columnar GROUPBY route ------------------------------------------------------

COUNT_BY_TAG = ("GROUPBY", "1", "@tag", "REDUCE", "COUNT", "0", "AS", "c")


def _columnar_engines():
    both = Both()
    both.same("FT.CREATE", "idx", "ON", "HASH", "PREFIX", "1", "d:", "SCHEMA",
              "body", "TEXT", "tag", "TAG", "n", "NUMERIC")
    return both


def _routes(both, query, *tail):
    """The reply by the columnar route and by the generic one, on both
    engines: all four equal."""
    fast = both.same("FT.AGGREGATE", "idx", query, *tail)
    saved = (jagg._columnar_groupby_index, tagg._columnar_groupby_index)
    jagg._columnar_groupby_index = lambda *a: None
    tagg._columnar_groupby_index = lambda *a: None
    try:
        generic = both.same("FT.AGGREGATE", "idx", query, *tail)
    finally:
        jagg._columnar_groupby_index, tagg._columnar_groupby_index = saved
    assert fast == generic
    return fast


COLUMNAR_DOCS = {
    "basic": [({"body": "apple pie", "tag": "red" if i % 3 == 0 else "blue"})
              for i in range(50)],
    "raw": [{"body": "apple", "tag": "A, b"}, {"body": "apple", "tag": "A, b"},
            {"body": "apple", "tag": "b"}],
    "nil": [{"body": "apple", "tag": "t1"}, {"body": "apple"}],
    "untracked": [{"body": "apple", "tag": "  "}, {"body": "apple", "tag": "t"}],
    "order": [{"body": "apple", "tag": t} for t in "mazamq"],
    "bytes": [{"body": "apple", "tag": b"caf\xc3\xa9"},
              {"body": "apple", "tag": b"\xff\xfe"},
              {"body": "apple", "tag": "café"}],
}


@pytest.mark.parametrize("docs", sorted(COLUMNAR_DOCS))
def test_columnar_route_matches_generic_and_reference(docs):
    both = _columnar_engines()
    for i, fields in enumerate(COLUMNAR_DOCS[docs]):
        both.call("hset", f"d:{i}", fields)
    before = TSTATS.get("agg_group_by_stages")
    out = _routes(both, "@body:apple", *COUNT_BY_TAG)
    assert out[0] >= 1
    assert TSTATS.get("agg_group_by_stages") == before + 2
    _routes(both, "*", *COUNT_BY_TAG, "SORTBY", "2", "@tag", "DESC", "LIMIT",
            "0", "2")


def test_columnar_route_after_overwrite_and_delete():
    both = _columnar_engines()
    both.call("hset", "d:1", {"body": "v", "tag": "old"})
    both.call("hset", "d:1", {"body": "v", "tag": "new"})
    both.call("hset", "d:2", {"body": "v", "tag": "old"})
    both.call("delete", "d:2")
    assert _routes(both, "@body:v", *COUNT_BY_TAG) == \
        [1, ["tag", "new", "c", "1"]]


def test_columnar_plan_detection_matches():
    both = _columnar_engines()
    for tail, columnar in (
            (COUNT_BY_TAG, True),
            (("LOAD", "*") + COUNT_BY_TAG, False),
            (("GROUPBY", "1", "@__key", "REDUCE", "COUNT", "0"), False),
            (("GROUPBY", "1", "@body", "REDUCE", "COUNT", "0"), False),
            (("GROUPBY", "1", "@tag", "REDUCE", "SUM", "1", "@n"), False),
            (("GROUPBY", "2", "@tag", "@n", "REDUCE", "COUNT", "0"), False)):
        plans = []
        for eng, mod in ((both.jax, jagg), (both.port, tagg)):
            spec = mod.parse_ft_aggregate(["idx", "*", *tail])
            plan = mod._columnar_groupby_index(eng.manager.get("idx"), spec)
            plans.append(plan is not None)
        assert plans == [columnar, columnar], tail


def test_columnar_route_is_left_when_the_engine_is_not_quiescent(monkeypatch):
    """A TTL anywhere, or a write between the search and the count, sends the
    request down the per-row route; the reply stays equal to the JAX one."""
    both = _columnar_engines()
    for i in range(12):
        both.call("hset", f"d:{i}", {"body": "s", "tag": f"t{i % 3}"})
    counts = []
    real = TagIndex.value_counts
    monkeypatch.setattr(TagIndex, "value_counts",
                        lambda self, docs: counts.append(len(docs))
                        or real(self, docs))
    both.same("FT.AGGREGATE", "idx", "@body:s", *COUNT_BY_TAG)
    assert counts == [12]
    # a pending TTL: the columnar count is not taken
    both.same("EXPIRE", "d:3", "1000")
    both.same("FT.AGGREGATE", "idx", "@body:s", *COUNT_BY_TAG)
    assert counts == [12]
    both.same("PERSIST", "d:3")
    both.same("FT.AGGREGATE", "idx", "@body:s", *COUNT_BY_TAG)
    assert counts == [12, 12]
    # a write that lands after the search began: epoch differs
    schema = both.port.manager.get("idx")
    real_search = tagg.execute_search

    def search_then_write(s, sp, token=None):
        resp = real_search(s, sp, token=token)
        schema.upsert("d:0", {"body": "s", "tag": "late"})
        return resp

    monkeypatch.setattr(tagg, "execute_search", search_then_write)
    both.jax.manager.get("idx").upsert("d:0", {"body": "s", "tag": "late"})
    both.port.keyspace["d:0"]["tag"] = "late"
    both.jax.keyspace["d:0"]["tag"] = "late"
    both.same("FT.AGGREGATE", "idx", "@body:s", *COUNT_BY_TAG)
    assert counts == [12, 12]


# -- counters -------------------------------------------------------------------------

_AGG_COUNTERS = [
    "aggregate_queries", "aggregate_errors", "agg_input_records",
    "agg_output_records", "agg_limit_stages", "agg_limit_input_records",
    "agg_limit_output_records", "agg_group_by_stages",
    "agg_group_by_input_records", "agg_group_by_output_records",
    "agg_reducer_stages", "agg_apply_stages", "agg_apply_records",
    "agg_sort_by_stages", "agg_sort_by_records", "agg_filter_stages",
    "agg_filter_input_records", "agg_filter_output_records",
]


def _snap(stats):
    return {name: stats.get(name) for name in _AGG_COUNTERS}


COUNTED = [
    ("@rating:[-inf inf]", "LIMIT", "0", "5"),
    ("@rating:[-inf inf]", "LOAD", "1", "cat", "GROUPBY", "1", "@cat",
     "REDUCE", "COUNT", "0", "AS", "n"),
    ("@rating:[-inf inf]", "APPLY", "@price * 2", "AS", "double_price"),
    ("@rating:[-inf inf]", "LOAD", "1", "price", "SORTBY", "2", "@price",
     "DESC", "MAX", "20"),
    ("@rating:[-inf inf]", "SORTBY", "1", "@cat", "LIMIT", "0", "5"),
    ("@rating:[-inf inf]", "LOAD", "1", "price", "FILTER", "@price >= 150"),
    ("@rating:[-inf inf]", "GROUPBY", "1", "@cat", "REDUCE", "COUNT", "0"),
    ("@rating:[-inf inf]", "TIMEOUT", "0"),
    ("@rating:[-inf inf]", "LOAD", "1", "@v"),
]


@pytest.mark.parametrize("counted", range(len(COUNTED)))
def test_stage_counters_move_as_the_reference(shop, counted):
    jbase, tbase = _snap(JSTATS), _snap(TSTATS)
    shop.same("FT.AGGREGATE", "idx", *COUNTED[counted])
    jnow, tnow = _snap(JSTATS), _snap(TSTATS)
    jdelta = {k: jnow[k] - jbase[k] for k in jnow}
    tdelta = {k: tnow[k] - tbase[k] for k in tnow}
    assert tdelta == jdelta
    assert tdelta["aggregate_queries"] == 1


def test_stage_boundary_cancel(shop):
    spec = tagg.parse_ft_aggregate(["idx", "*", "LIMIT", "0", "5"])
    token = tcancel.Token()
    token.cancel("client kill")
    with pytest.raises(tcancel.CancelledError):
        tagg.aggregate_rows(shop.port.manager.get("idx"), spec, [], None,
                            None, token=token)
