"""The port's in-process cluster against the JAX package's, reply for reply.

Each test drives a ``ClusterEngine`` (or bare ``MetadataManager``s) of each
package with the same seeded numpy inputs and compares their replies, error
types and messages, and their metadata state, over the flows of the
reference's ``test_cluster`` (fingerprints, gossip, reconcile and its
tie-break, tombstones, ``FT.INTERNAL_UPDATE`` and its corrupted entries,
``key_slot`` with hash tags, routing, backfill on every shard, KNN, hybrid,
non-vector with LIMIT, mutations, DROPINDEX, a forced fingerprint mismatch
with partial results, a late joiner, TEXT, JSON, FT.AGGREGATE, save and load
under a write storm), the cluster cases of ``test_versioning`` and the
replica cases of ``test_multi_replicas_cancel``. KNN ids are equal in order.
The port's shards run on the CPU here (below 65,537 rows a shard, the plain
scan serves).
"""

import json
import threading

import numpy as np
import pytest

from valkey_search_tpu.cluster import metadata as jmeta
from valkey_search_tpu.cluster import node as jnode
from valkey_search_tpu.runtime import config as jconfig
from valkey_search_tpu.runtime import debug as jdebug
from valkey_search_tpu.runtime.metrics import STATS as JSTATS
from valkey_search_tpu_torch.cluster import metadata as tmeta
from valkey_search_tpu_torch.cluster import node as tnode
from valkey_search_tpu_torch.runtime import config as tconfig
from valkey_search_tpu_torch.runtime import debug as tdebug
from valkey_search_tpu_torch.runtime.device import set_device
from valkey_search_tpu_torch.runtime.metrics import STATS as TSTATS
from torch_port_both import Both, outcome
from torch_port_config import set_both

SIDES = ((jmeta, jnode, jdebug), (tmeta, tnode, tdebug))
FUTURE = jmeta.encode_version(9, 9, 9)


@pytest.fixture(autouse=True)
def _clean():
    set_device("cpu")
    for _, _, dbg in SIDES:
        dbg.reset_all()
    yield
    for _, _, dbg in SIDES:
        dbg.reset_all()
    jconfig.REGISTRY.reset_all()
    tconfig.REGISTRY.reset_all()


def _controlled(name, value):
    for _, _, dbg in SIDES:
        dbg.CONTROLLED.set(name, value)


def _clusters(**kwargs) -> Both:
    return Both.of(jnode.ClusterEngine(**kwargs),
                   tnode.ClusterEngine(**kwargs))


def _entries(mgr):
    return {n: (e.version, e.fingerprint, e.payload, e.min_version)
            for n, e in mgr.entries().items()}


# -- metadata manager -----------------------------------------------------------


@pytest.mark.parametrize("data", [b"", b"abc", b"abd", bytes(range(256)),
                                  "idx|{\"v\": 1}".encode()])
def test_fingerprint_is_the_reference_fingerprint(data):
    assert tmeta._FP_KEY == jmeta._FP_KEY
    assert tmeta.MODULE_VERSION == jmeta.MODULE_VERSION
    assert tmeta.fingerprint64(data) == jmeta.fingerprint64(data)
    assert tmeta.fingerprint64(data) != tmeta.fingerprint64(data + b"x")


def _managers(meta, n, applied):
    bus = meta.ClusterBus()
    return [meta.MetadataManager(
        f"n{i}", bus,
        on_apply=lambda name, p, i=i: applied.setdefault(i, []).append(
            (name, p)))
        for i in range(n)]


def test_create_entry_gossips_the_same_state():
    states = []
    for meta, _, _ in SIDES:
        applied = {}
        mms = _managers(meta, 3, applied)
        mms[0].create_entry("idx", {"dim": 4})
        mms[1].create_entry("other", {"dim": 8, "db": 2})
        states.append(([_entries(m) for m in mms],
                       [m.top_fingerprint() for m in mms],
                       [m.top_min_version() for m in mms], applied))
    assert states[1] == states[0]
    assert len(set(states[1][1])) == 1


def test_reconcile_last_writer_wins_and_tombstones():
    states = []
    for meta, _, _ in SIDES:
        bus = meta.ClusterBus()
        a, b = meta.MetadataManager("a", bus), meta.MetadataManager("b", bus)
        a.create_entry("idx", {"v": 1})
        b.create_entry("idx", {"v": 2})
        after_lww = (_entries(a), _entries(b))
        a.drop_entry("idx")
        states.append((after_lww, _entries(a), _entries(b),
                       b.get("idx"), b.top_fingerprint()))
    assert states[1] == states[0]
    assert states[1][0][0]["idx"][:1] == (2,)
    assert states[1][2]["idx"][2] is None  # the tombstone, version 3


def test_version_tie_breaks_on_the_larger_fingerprint():
    states = []
    for meta, _, _ in SIDES:
        a = meta.MetadataManager("a", meta.ClusterBus())
        b = meta.MetadataManager("b", meta.ClusterBus())
        a.create_entry("idx", {"v": "A"})
        b.create_entry("idx", {"v": "B"})
        ea, eb = a.get("idx"), b.get("idx")
        got = (a.reconcile({"idx": eb}), b.reconcile({"idx": ea}))
        states.append((got, _entries(a), _entries(b)))
    assert states[1] == states[0]
    assert states[1][1] == states[1][2]


@pytest.mark.parametrize("raw, skip", [
    (json.dumps({"name": "idx", "version": 3, "payload": {"x": 1}}), False),
    (json.dumps({"name": "idx", "version": 3, "payload": {"x": 1},
                 "min_version": 65536}), False),
    ("not json", False), ("not json", True),
    (json.dumps({"name": "idx"}), True), (json.dumps({"version": 1}), False),
])
def test_internal_update_and_its_corrupted_entries(raw, skip):
    outs = []
    for meta, _, _ in SIDES:
        a = meta.MetadataManager("a", meta.ClusterBus())
        got = outcome(a.internal_update, raw.encode(), skip_corrupted=skip)
        outs.append((got, _entries(a)))
    assert outs[1] == outs[0]


# -- slot routing ---------------------------------------------------------------


def test_key_slot_and_crc16_are_the_reference(rng):
    assert tnode.crc16(b"123456789") == 0x31C3
    alphabet = np.array(list("ab{}:xyz01"))
    keys = ["".join(rng.choice(alphabet, rng.integers(0, 12)))
            for _ in range(3000)]
    keys += ["{user1}.a", "{user1}.b", "foo{}{bar}", "{}", "{a}{b}", "x{"]
    assert [tnode.key_slot(k) for k in keys] == [jnode.key_slot(k)
                                                 for k in keys]
    assert tnode.key_slot("{user1}.a") == tnode.key_slot("{user1}.b")


@pytest.mark.parametrize("n_nodes", [1, 2, 3, 5])
def test_cluster_routes_keys_to_the_same_owners(n_nodes):
    both = _clusters(n_nodes=n_nodes)
    for i in range(200):
        assert both.call("hset", f"doc:{i}", {"f": str(i)}) == 1
    per_node = [[sorted(n.engine.keyspace) for n in c.nodes]
                for c in both.engines]
    assert per_node[1] == per_node[0]
    assert [n.slots for n in both.port.nodes] == [
        n.slots for n in both.jax.nodes]
    for i in range(0, 200, 17):
        assert both.same("HGETALL", f"doc:{i}") == {"f": str(i)}
    both.same("FT.NOPE", "x")


def test_cluster_needs_a_node():
    for _, node, _ in SIDES:
        with pytest.raises(ValueError, match="at least one node"):
            node.ClusterEngine(n_nodes=0)


# -- the index lifecycle over three shards ----------------------------------------


@pytest.fixture()
def cluster(rng):
    both = _clusters(n_nodes=3)
    vecs = rng.standard_normal((90, 8)).astype(np.float32)
    for i, v in enumerate(vecs):
        both.call("hset", f"doc:{i}", {
            "emb": v.tobytes(), "color": ["red", "blue"][i % 2],
            "n": str(i)})
    assert both.same(
        "FT.CREATE", "idx", "ON", "HASH", "PREFIX", "1", "doc:", "SCHEMA",
        "emb", "VECTOR", "HNSW", "8", "TYPE", "FLOAT32", "DIM", "8",
        "DISTANCE_METRIC", "L2", "M", "8", "color", "TAG",
        "n", "NUMERIC") == "OK"
    return both, vecs


def test_ft_create_backfills_every_shard(cluster):
    both, _ = cluster
    for c in both.engines:
        for node in c.nodes:
            schema = node.engine.manager.get("idx")
            assert schema.num_docs() == len(node.engine.keyspace)
    assert [n.engine.manager.get("idx").num_docs() for n in both.port.nodes
            ] == [n.engine.manager.get("idx").num_docs()
                  for n in both.jax.nodes]
    for mode in ("CLUSTER", "LOCAL", "PRIMARY"):
        info = both.same("FT.INFO", "idx", mode)
        if mode != "LOCAL":
            assert dict(zip(info[::2], info[1::2]))["num_docs"] == 90
    both.same("FT._LIST")
    entries = [_entries(c.nodes[1].metadata) for c in both.engines]
    assert entries[1] == entries[0]


@pytest.mark.parametrize("q", [0, 17, 44, 89])
def test_fanout_knn_ids_equal_in_order(cluster, q):
    both, vecs = cluster
    for k in (1, 5, 12):
        r = both.same("FT.SEARCH", "idx", f"*=>[KNN {k} @emb $q]", "PARAMS",
                      "2", "q", vecs[q].tobytes(), "NOCONTENT")
        assert r[0] == k and r[1] == f"doc:{q}"
        if k == 5:  # the reference's own check
            d2 = ((vecs - vecs[q]) ** 2).sum(1)
            assert set(r[1:]) == {f"doc:{i}"
                                  for i in np.argsort(d2, kind="stable")[:k]}
    # content and the distance field from the owning shards
    both.close("FT.SEARCH", "idx", "*=>[KNN 3 @emb $q]", "PARAMS", "2", "q",
               vecs[q].tobytes(), "RETURN", "2", "n", "__emb_score")


@pytest.mark.parametrize("flt", ["(@color:{red})", "(@n:[10 40])",
                                 "(@color:{blue} @n:[0 50])", "(@color:{x})"])
def test_fanout_hybrid_filter(cluster, flt):
    both, vecs = cluster
    r = both.same("FT.SEARCH", "idx", f"{flt}=>[KNN 4 @emb $q]", "PARAMS",
                  "2", "q", vecs[4].tobytes(), "NOCONTENT")
    if flt == "(@color:{red})":
        assert r[0] == 4 and all(int(k[4:]) % 2 == 0 for k in r[1:])


@pytest.mark.parametrize("limit", [("0", "100"), ("5", "5"), ("18", "10"),
                                   ("0", "0")])
def test_fanout_nonvector_with_limit(cluster, limit):
    both, _ = cluster
    r = both.same("FT.SEARCH", "idx", "@n:[10 29]", "NOCONTENT", "LIMIT",
                  *limit)
    assert r[0] == 20
    both.same("FT.SEARCH", "idx", "@color:{red}", "LIMIT", *limit,
              "RETURN", "1", "n")


def test_mutations_visible_through_fanout(cluster):
    both, _ = cluster
    nv = np.full(8, 0.5, np.float32)
    both.call("hset", "doc:500", {"emb": nv.tobytes(), "color": "gold",
                                  "n": "500"})
    assert both.same("FT.SEARCH", "idx", "@color:{gold}",
                     "NOCONTENT") == [1, "doc:500"]
    both.same("FT.SEARCH", "idx", "*=>[KNN 2 @emb $q]", "PARAMS", "2", "q",
              nv.tobytes(), "NOCONTENT")
    assert both.same("DEL", "doc:500", "doc:1", "nope") == 2
    assert both.same("FT.SEARCH", "idx", "@color:{gold}",
                     "NOCONTENT")[0] == 0
    both.same("FT.SEARCH", "idx", "*=>[KNN 3 @emb $q]", "PARAMS", "2", "q",
              nv.tobytes(), "NOCONTENT")


def test_dropindex_converges(cluster):
    both, _ = cluster
    assert both.call("ft_dropindex", "idx") == "OK"
    for c in both.engines:
        for node in c.nodes:
            assert node.metadata.get("idx") is None
            assert "idx" not in node.engine.ft_list()
    both.call("ft_dropindex", "idx")  # KeyError on both
    both.same("FT.SEARCH", "idx", "*", "NOCONTENT")
    entries = [_entries(c.nodes[2].metadata) for c in both.engines]
    assert entries[1] == entries[0]


def test_forced_fingerprint_mismatch_fails_then_partial(cluster):
    both, vecs = cluster
    _controlled("force_invalid_index_fingerprint", "true")
    argv = ("FT.SEARCH", "idx", "*=>[KNN 3 @emb $q]", "PARAMS", "2", "q",
            vecs[0].tobytes(), "NOCONTENT")
    err = both.same(*argv)
    assert err.type == "ConsistencyError"
    assert JSTATS.get("fanout_retries") > 0 and TSTATS.get(
        "fanout_retries") > 0
    set_both("search.prefer-partial-results", True)
    assert both.same(*argv)[0] == 0
    # the slot-ownership drill
    _controlled("force_invalid_index_fingerprint", "false")
    _controlled("force_invalid_slot_fingerprint", "true")
    assert both.same(*argv)[0] == 0
    set_both("search.prefer-partial-results", False)
    both.same(*argv)


def test_late_joining_node_converges():
    states = []
    for _, node, _ in SIDES:
        c = node.ClusterEngine(n_nodes=2)
        c.hset("doc:1", {"t": "x"})
        c.execute("FT.CREATE", "idx", "ON", "HASH", "PREFIX", "1", "doc:",
                  "SCHEMA", "t", "TAG")
        late = node.ClusterNode("late", c.bus)
        late.slots = (0, 0)
        before = late.metadata.get("idx")
        c.nodes[0].metadata.broadcast()
        states.append((before, _entries(late.metadata),
                       late.engine.manager.list_names()))
    assert states[1] == states[0]
    assert states[1][2] == ["idx"]


def test_cluster_text_search():
    both = _clusters(n_nodes=3)
    titles = ["running shoes", "blue suede shoes", "quantum computing",
              "running late again", "the art of computing"]
    for i, t in enumerate(titles * 4):
        both.call("hset", f"doc:{i}", {"title": t, "n": str(i)})
    both.same("FT.CREATE", "t", "ON", "HASH", "PREFIX", "1", "doc:",
              "SCHEMA", "title", "TEXT", "n", "NUMERIC")
    r = both.same("FT.SEARCH", "t", "@title:run", "NOCONTENT", "LIMIT", "0",
                  "50")
    assert set(r[1:]) == {f"doc:{i}" for i, t in enumerate(titles * 4)
                          if "running" in t}
    both.same("FT.SEARCH", "t", '"quantum computing"', "NOCONTENT")
    both.same("FT.SEARCH", "t", "@title:shoes @n:[0 9]", "NOCONTENT",
              "LIMIT", "0", "50")
    both.same("FT.SEARCH", "t", "@title:comput*", "RETURN", "1", "title")
    both.same("FT.SEARCH", "t", "%%quantun%%", "NOCONTENT")


def test_cluster_json_documents(rng):
    both = _clusters(n_nodes=2)
    both.same("FT.CREATE", "j", "ON", "JSON", "PREFIX", "1", "p:", "SCHEMA",
              "$.v", "AS", "v", "VECTOR", "FLAT", "6", "TYPE", "FLOAT32",
              "DIM", "4", "DISTANCE_METRIC", "L2", "$.tag", "AS", "tag",
              "TAG")
    vecs = rng.standard_normal((20, 4)).astype(np.float32)
    for c in both.engines:
        for i, v in enumerate(vecs):
            c.owner(f"p:{i}").engine.json_set(f"p:{i}", "$", json.dumps(
                {"v": [float(x) for x in v], "tag": ["a", "b"][i % 2]}))
    for q in (11, 3):
        r = both.same("FT.SEARCH", "j", "(@tag:{b})=>[KNN 3 @v $q]",
                      "PARAMS", "2", "q", vecs[q].tobytes(), "NOCONTENT")
        assert all(int(k[2:]) % 2 == 1 for k in r[1:])
    both.same("FT.SEARCH", "j", "@tag:{a}", "NOCONTENT", "LIMIT", "0", "20")


@pytest.mark.parametrize("query", [
    ("*", "LOAD", "2", "@tags", "@price", "GROUPBY", "1", "@tags",
     "REDUCE", "COUNT", "0", "AS", "cnt", "REDUCE", "SUM", "1", "@price",
     "AS", "total", "SORTBY", "2", "@tags", "ASC"),
    ("@price:[5 30]", "GROUPBY", "1", "@tags", "REDUCE", "AVG", "1",
     "@price", "AS", "avg", "SORTBY", "2", "@avg", "DESC"),
    ("*=>[KNN 7 @v $q]", "PARAMS", "2", "q", None, "LOAD", "1", "@tags",
     "GROUPBY", "1", "@tags", "REDUCE", "COUNT", "0", "AS", "n",
     "SORTBY", "2", "@tags", "ASC"),
    ("@tags:{a}", "LOAD", "1", "@price", "APPLY", "@price * 2", "AS", "p2",
     "FILTER", "@p2 > 8", "SORTBY", "2", "@p2", "ASC", "LIMIT", "0", "3"),
])
def test_cluster_aggregate_fanout(rng, query):
    both = _clusters(n_nodes=3)
    both.call("ft_create", "idx", "ON", "HASH", "PREFIX", "1", "doc:",
              "SCHEMA", "price", "NUMERIC", "tags", "TAG", "v", "VECTOR",
              "FLAT", "6", "TYPE", "FLOAT32", "DIM", "4", "DISTANCE_METRIC",
              "L2")
    vecs = rng.standard_normal((40, 4)).astype(np.float32)
    for i in range(40):
        both.call("hset", f"doc:{i}", {"price": str(i), "v": vecs[i].tobytes(),
                                       "tags": "a" if i < 10 else "b"})
    argv = [vecs[5].tobytes() if a is None else a for a in query]
    reply = both.same("FT.AGGREGATE", "idx", *argv)
    if query[0] == "*":
        rows = {r[1]: dict(zip(r[::2], r[1::2])) for r in reply[1:]}
        assert int(rows["a"]["cnt"]) == 10 and int(rows["b"]["cnt"]) == 30
        assert float(rows["a"]["total"]) == sum(range(10))
    both.same("FT.AGGREGATE", "nope", "*")


def test_cluster_save_load_roundtrip(cluster, tmp_path):
    both, vecs = cluster
    q = vecs[17].tobytes()
    knn = ("FT.SEARCH", "idx", "*=>[KNN 5 @emb $q]", "PARAMS", "2", "q", q,
           "NOCONTENT")
    before = both.same(*knn)
    saved = [c.save(str(tmp_path / name))
             for c, name in zip(both.engines, ("jax", "port"))]
    assert saved[1] == saved[0] == {"schemas": 1, "keys": 90}
    restored = Both.of(jnode.ClusterEngine.load(str(tmp_path / "jax")),
                       tnode.ClusterEngine.load(str(tmp_path / "port")))
    assert restored.same(*knn) == before
    entries = [_entries(c.nodes[0].metadata) for c in restored.engines]
    assert entries[1] == entries[0]
    nv = np.full(8, 0.25, np.float32)
    restored.call("hset", "doc:900", {"emb": nv.tobytes(), "color": "gold",
                                      "n": "900"})
    assert restored.same("FT.SEARCH", "idx", "@color:{gold}",
                         "NOCONTENT") == [1, "doc:900"]
    assert restored.call("ft_dropindex", "idx") == "OK"


def test_cluster_checkpoint_under_write_storm(tmp_path, rng):
    """Save while two writers hammer every shard: each snapshot loads into a
    consistent cluster (every restored key searchable, the metadata on
    every node), in either package."""
    vecs = rng.standard_normal((400, 8)).astype(np.float32)
    for side, (_, node, _) in zip(("jax", "port"), SIDES):
        c = node.ClusterEngine(n_nodes=3)
        c.execute("FT.CREATE", "idx", "ON", "HASH", "PREFIX", "1", "doc:",
                  "SCHEMA", "emb", "VECTOR", "FLAT", "6", "TYPE", "FLOAT32",
                  "DIM", "8", "DISTANCE_METRIC", "L2", "color", "TAG")
        for i in range(100):
            c.hset(f"doc:{i}", {"emb": vecs[i].tobytes(), "color": "base"})
        stop, errors = threading.Event(), []

        def storm(tid):
            i = 100 + tid
            while not stop.is_set():
                try:
                    c.hset(f"doc:{i}", {"emb": vecs[i % 400].tobytes(),
                                        "color": "storm"})
                    i += 2
                except Exception as exc:  # noqa: BLE001 - reported below
                    errors.append(exc)

        threads = [threading.Thread(target=storm, args=(t,)) for t in (0, 1)]
        for t in threads:
            t.start()
        snaps = []
        try:
            for r in range(2):
                d = tmp_path / f"{side}{r}"
                c.save(str(d))
                snaps.append(d)
        finally:
            stop.set()
            for t in threads:
                t.join()
        assert not errors, errors[:3]
        for d in snaps:
            # each snapshot loads in the other package too
            for _, other, _ in SIDES:
                restored = other.ClusterEngine.load(str(d))
                for n in restored._all_nodes():
                    assert "idx" in n.engine.ft_list()
                assert restored.ft_search("idx", "@color:{base}", "NOCONTENT",
                                          "LIMIT", "0", "200")[0] == 100
                n_storm = restored.ft_search(
                    "idx", "@color:{storm}", "NOCONTENT", "LIMIT", "0",
                    "1000")[0]
                assert n_storm == sum(
                    1 for n in restored.nodes
                    for f in n.engine.keyspace.values()
                    if f.get("color") in ("storm", b"storm"))


# -- versioning (CME: the metadata wire version gate) ------------------------------


def test_gossip_ignores_future_metadata():
    states = []
    for meta, _, dbg in SIDES:
        bus = meta.ClusterBus()
        a, b = meta.MetadataManager("a", bus), meta.MetadataManager("b", bus)
        dbg.CONTROLLED.set("override_min_version", str(FUTURE))
        a.create_entry("idx", {"db": 0, "attributes": []})
        refused = (a.get("idx") is not None, b.get("idx"))
        dbg.CONTROLLED.clear("override_min_version")
        a.create_entry("idx", {"db": 0, "attributes": []})
        states.append((refused, _entries(a), _entries(b)))
    assert states[1] == states[0]
    assert states[1][0] == (True, None) and states[1][2]


def test_reconcile_skips_future_entries_only():
    states = []
    for meta, _, dbg in SIDES:
        a = meta.MetadataManager("a", meta.ClusterBus())
        b = meta.MetadataManager("b", meta.ClusterBus())
        a.create_entry("old", {"db": 0, "attributes": []})
        dbg.CONTROLLED.set("override_min_version", str(FUTURE))
        a.create_entry("new", {"db": 0, "attributes": []})
        dbg.CONTROLLED.clear("override_min_version")
        states.append((b.reconcile(a.get_global_metadata()), _entries(b)))
    assert states[1] == states[0]
    assert states[1][0] is True and list(states[1][1]) == ["old"]


def test_cluster_ft_create_future_version_errors_but_lists_locally():
    both = _clusters(n_nodes=3)
    for i in range(6):
        both.call("hset", f"doc:{i}", {"n": str(i)})
    _controlled("override_min_version", str(FUTURE))
    err = both.call("ft_create", "vidx", "ON", "HASH", "PREFIX", "1", "doc:",
                    "SCHEMA", "n", "NUMERIC", timeout_s=0.3)
    assert err.type == "ConsistencyError"
    assert "Unable to contact all cluster members" in err.message
    assert both.call("ft_list") == ["vidx"]
    for c in both.engines:
        assert all(n.metadata.get("vidx") is None for n in c.nodes[1:])


# -- replicas (read scaling over the replication stream) ----------------------------


@pytest.fixture()
def replicated(rng):
    both = _clusters(n_nodes=2, replicas_per_shard=2)
    vecs = rng.standard_normal((40, 8)).astype(np.float32)
    for i, v in enumerate(vecs):
        both.call("hset", f"doc:{i}", {"emb": v.tobytes(), "t": "x"})
    both.call("ft_create", "idx", "ON", "HASH", "PREFIX", "1", "doc:",
              "SCHEMA", "emb", "VECTOR", "FLAT", "6", "TYPE", "FLOAT32",
              "DIM", "8", "DISTANCE_METRIC", "L2", "t", "TAG")
    return both, vecs


def test_replicas_hold_full_shard_state(replicated):
    both, _ = replicated
    for c in both.engines:
        for i, primary in enumerate(c.nodes):
            for r in c.replicas[i]:
                assert sorted(r.engine.keyspace) == sorted(
                    primary.engine.keyspace)
                assert (r.engine.manager.get("idx").num_docs()
                        == primary.engine.manager.get("idx").num_docs())
    assert [[len(r.engine.keyspace) for r in reps]
            for reps in both.port.replicas] == [
        [len(r.engine.keyspace) for r in reps] for reps in both.jax.replicas]


@pytest.mark.parametrize("mode", ["replica", "primary", "random"])
def test_fanout_target_modes(replicated, mode):
    both, vecs = replicated
    set_both("search.fanout-target-mode", mode)
    for q in (9, 30):
        r = both.same("FT.SEARCH", "idx", "*=>[KNN 3 @emb $q]", "PARAMS",
                      "2", "q", vecs[q].tobytes(), "NOCONTENT")
        assert r[1] == f"doc:{q}"
    assert both.same("FT.SEARCH", "idx", "@t:{x}", "NOCONTENT", "LIMIT",
                     "0", "0") == [40]


def test_force_replicas_only_controlled_var(replicated):
    both, vecs = replicated
    _controlled("force_replicas_only", "true")
    r = both.same("FT.SEARCH", "idx", "*=>[KNN 1 @emb $q]", "PARAMS", "2",
                  "q", vecs[3].tobytes(), "NOCONTENT")
    assert r == [1, "doc:3"]


def test_replica_write_propagation(replicated):
    both, _ = replicated
    nv = np.full(8, 0.25, np.float32)
    both.call("hset", "doc:999", {"emb": nv.tobytes(), "t": "new"})
    set_both("search.fanout-target-mode", "replica")
    assert both.same("FT.SEARCH", "idx", "@t:{new}",
                     "NOCONTENT") == [1, "doc:999"]
    assert both.call("delete", "doc:999") == 1
    assert both.same("FT.SEARCH", "idx", "@t:{new}", "NOCONTENT")[0] == 0
    both.call("drain")
