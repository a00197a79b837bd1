"""The port stands alone: it imports nothing of the JAX package, and its own
copies of the JAX package's host modules behave as the originals do.

- An AST scan of every module of the port, ``bench_torch.py``,
  ``chip_smoke.py`` and ``tests/test_torch_cuda.py``: no import of ``jax``
  or ``valkey_search_tpu``.
- The port's config registry has exactly the reference's options (names,
  kinds, defaults, bounds, choices, flags, aliases) and is a registry of
  its own: a change on one side leaves the other alone.
- Seeded differential runs of the copies of ``KeyInterner``,
  ``PatriciaTree``, ``LRU``, ``attribute_data_type``, the metrics, the
  cancellation tokens and the query batcher against the reference's.
- The modules copied whole (``expr``, ``log``, ``threadmon``, ``acl``,
  ``ft_aggregate``, ``info``, ``version``, ``persistence``'s ``format``,
  ``journal`` and ``checkpoint``, ``lua``, ``cluster``'s ``metadata`` and
  ``node``) are the reference's code with the package name changed,
  statement for statement. ``ingestion`` carries
  one repair and is held by behaviour (``tests/test_torch_ingestion.py``);
  ``server/resp.py`` is the reference's statement for statement apart from
  its forked BGSAVE and its command line (held by behaviour in
  ``tests/test_torch_resp.py`` and ``tests/test_torch_persistence.py``),
  and ``cluster/transport.py`` apart from its two repairs and its command
  line (``tests/test_torch_cluster_interop.py``).
"""

import ast
import os
import re
import threading

import numpy as np
import pytest

from valkey_search_tpu.query import batcher as jbatcher
from valkey_search_tpu.query import planner as jplanner
from valkey_search_tpu.runtime import config as jconfig
from valkey_search_tpu.runtime import metrics as jmetrics
from valkey_search_tpu.schema import attribute_data_type as jadt
from valkey_search_tpu.utils import cancel as jcancel
from valkey_search_tpu.utils.interning import KeyInterner as JaxInterner
from valkey_search_tpu.utils.lru import LRU as JaxLRU
from valkey_search_tpu.utils.patricia import PatriciaTree as JaxPatricia
from valkey_search_tpu_torch.query import batcher as tbatcher
from valkey_search_tpu_torch.query import planner as tplanner
from valkey_search_tpu_torch.runtime import config as tconfig
from valkey_search_tpu_torch.runtime import metrics as tmetrics
from valkey_search_tpu_torch.schema import attribute_data_type as tadt
from valkey_search_tpu_torch.utils import cancel as tcancel
from valkey_search_tpu_torch.utils.interning import KeyInterner
from valkey_search_tpu_torch.utils.lru import LRU
from valkey_search_tpu_torch.utils.patricia import PatriciaTree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_BANNED = ("jax", "jaxlib", "valkey_search_tpu")


def _port_files():
    out = []
    for root, _, names in os.walk(os.path.join(REPO, "valkey_search_tpu_torch")):
        out += [os.path.relpath(os.path.join(root, n), REPO)
                for n in names if n.endswith(".py")]
    return sorted(out) + ["bench_torch.py", "chip_smoke.py",
                          "tests/test_torch_cuda.py"]


def _imported_names(path):
    tree = ast.parse(open(os.path.join(REPO, path)).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", _port_files())
def test_port_file_imports_neither_jax_nor_the_jax_package(path):
    bad = [name for name in _imported_names(path)
           if name.split(".")[0] in _BANNED]
    assert not bad, f"{path} imports {bad}"


# -- modules copied whole ---------------------------------------------------------


def _code_without_docstring(path, package):
    """The module's AST dump, its docstring dropped and ``package`` renamed
    to the port's name."""
    src = open(os.path.join(REPO, path)).read()
    if package == "valkey_search_tpu":
        src = re.sub(r"valkey_search_tpu\b", "valkey_search_tpu_torch", src)
    tree = ast.parse(src, path)
    if (tree.body and isinstance(tree.body[0], ast.Expr)
            and isinstance(getattr(tree.body[0], "value", None), ast.Constant)
            and isinstance(tree.body[0].value.value, str)):
        tree.body = tree.body[1:]
    return ast.dump(tree)


@pytest.mark.parametrize("rel", [
    "query/expr.py", "runtime/log.py", "runtime/threadmon.py",
    "server/acl.py", "server/ft_aggregate.py", "runtime/info.py",
    "version.py", "persistence/__init__.py", "persistence/format.py",
    "persistence/journal.py", "persistence/checkpoint.py", "server/lua.py",
    "cluster/metadata.py", "cluster/node.py",
])
def test_copied_module_is_the_reference_code(rel):
    assert (_code_without_docstring(f"valkey_search_tpu_torch/{rel}",
                                    "valkey_search_tpu_torch")
            == _code_without_docstring(f"valkey_search_tpu/{rel}",
                                       "valkey_search_tpu"))


# the port's RESP server differs from the reference's in its forked BGSAVE
# (a process that holds a CUDA context) and in its command line's --device
_RESP_CHANGED = {"_engine_aux_locks", "_detach_after_fork", "bgsave_forked"}
# and records a sampled command's spans in these functions: they are compared
# with every statement that names the span recorder taken out, and the
# recorder's import with them
_RESP_SPANNED = {"handle", "_reply"}
_SPAN_NAMES = {"CTX", "SPAN", "TRACE", "clock"}
_RESP_ADDED_IMPORT = (
    "ImportFrom(module='valkey_search_tpu_torch.runtime.metrics'")


def _span_point(stmt) -> bool:
    """A statement, its own span points already taken out, that names one
    of ``_SPAN_NAMES`` or whose body held span points alone."""
    if {n.id for n in ast.walk(stmt) if isinstance(n, ast.Name)} & _SPAN_NAMES:
        return True
    return hasattr(stmt, "body") and not stmt.body


class _SpanPointsOut(ast.NodeTransformer):
    """Take the span points out of every statement list, innermost first."""

    def generic_visit(self, node):
        node = super().generic_visit(node)
        for field, value in ast.iter_fields(node):
            if isinstance(value, list) and value and all(
                    isinstance(v, ast.stmt) for v in value):
                setattr(node, field,
                        [v for v in value if not _span_point(v)])
        return node


def _statements_but(path, package, changed):
    """A module's statements, its docstring, the functions named in
    ``changed`` and the ``__main__`` block dropped; each as an AST dump."""
    tree = ast.parse(_renamed_source(path, package), path)
    out = []
    for node in tree.body[1:]:
        if isinstance(node, ast.If):  # if __name__ == "__main__":
            continue
        if isinstance(node, ast.ClassDef):
            for item in node.body:
                if getattr(item, "name", None) not in changed:
                    out.append(f"{node.name}: {ast.dump(item)}")
        elif getattr(node, "name", None) not in changed:
            out.append(ast.dump(node))
    return out


def _resp_statements(path, package):
    tree = ast.parse(_renamed_source(path, package), path)
    spanned = [ast.dump(_SpanPointsOut().visit(n)) for n in ast.walk(tree)
               if isinstance(n, ast.FunctionDef) and n.name in _RESP_SPANNED]
    assert len(spanned) == len(_RESP_SPANNED)
    return spanned + [
        s for s in _statements_but(path, package,
                                   _RESP_CHANGED | _RESP_SPANNED)
        if not s.startswith(_RESP_ADDED_IMPORT)]


def _renamed_source(path, package):
    src = open(os.path.join(REPO, path)).read()
    if package == "valkey_search_tpu":
        src = re.sub(r"valkey_search_tpu\b", "valkey_search_tpu_torch", src)
    return src


def test_resp_server_is_the_reference_code_but_its_fork_path():
    port = _resp_statements("valkey_search_tpu_torch/server/resp.py",
                            "valkey_search_tpu_torch")
    ref = _resp_statements("valkey_search_tpu/server/resp.py",
                           "valkey_search_tpu")
    assert port == ref
    names = {n.name for n in ast.walk(ast.parse(_renamed_source(
        "valkey_search_tpu_torch/server/resp.py", "valkey_search_tpu_torch")))
        if isinstance(n, (ast.FunctionDef, ast.ClassDef))}
    assert _RESP_CHANGED <= names


# the port's cluster transport differs from the reference's in the two
# repairs of a replica that records its own primary as a peer shard (it fans
# out to it; promotion keeps it and dials it) and in its command line's
# --device; _fanout_peers is new
_TRANSPORT_CHANGED = {"_fanout_peers", "_query_fans_out", "_coordinator",
                      "become_replica_of", "promote_to_primary", "main"}


def test_cluster_transport_is_the_reference_code_but_its_repairs():
    port = _statements_but("valkey_search_tpu_torch/cluster/transport.py",
                           "valkey_search_tpu_torch", _TRANSPORT_CHANGED)
    ref = _statements_but("valkey_search_tpu/cluster/transport.py",
                          "valkey_search_tpu", _TRANSPORT_CHANGED)
    assert port == ref
    names = {n.name for n in ast.walk(ast.parse(_renamed_source(
        "valkey_search_tpu_torch/cluster/transport.py",
        "valkey_search_tpu_torch")))
        if isinstance(n, (ast.FunctionDef, ast.ClassDef))}
    assert _TRANSPORT_CHANGED <= names
    # the reference has no _fanout_peers; everything else it changes exists
    ref_names = {n.name for n in ast.walk(ast.parse(_renamed_source(
        "valkey_search_tpu/cluster/transport.py", "valkey_search_tpu")))
        if isinstance(n, (ast.FunctionDef, ast.ClassDef))}
    assert _TRANSPORT_CHANGED - ref_names == {"_fanout_peers"}


# -- config --------------------------------------------------------------------


def _entry_shape(e):
    return (e.name, e.kind, e.default, e.min, e.max, e.choices, int(e.flags),
            e.validate is None, e.on_modify is None)


def test_config_registry_matches_the_reference():
    jent, tent = jconfig.REGISTRY._entries, tconfig.REGISTRY._entries
    # the port's own options (search.trace-spans) are the only ones added
    assert sorted(tent) == sorted([*jent, *tconfig.PORT_OPTIONS])
    for name in jent:
        assert _entry_shape(tent[name]) == _entry_shape(jent[name]), name
    assert tconfig._ALIASES == jconfig._ALIASES
    assert tconfig.get("search.scan-kernel") == "auto"
    assert tent["search.scan-kernel"].choices == ["auto", "pallas", "xla"]


def test_config_registries_are_separate():
    assert tconfig.REGISTRY is not jconfig.REGISTRY
    before = jconfig.get("search.query-max-batch")
    saved = tconfig.get("search.query-max-batch")
    try:
        tconfig.set_config("search.query-max-batch", 7)
        assert tconfig.get("search.query-max-batch") == 7
        assert jconfig.get("search.query-max-batch") == before
    finally:
        tconfig.set_config("search.query-max-batch", saved)


@pytest.mark.parametrize("raw", ["12", "1e3", 5000, "0", "9999999999", "x"])
def test_config_coerces_and_rejects_like_the_reference(raw):
    outcomes = []
    for cfg in (jconfig, tconfig):
        entry = cfg.REGISTRY._entries["search.query-max-batch"]
        try:
            outcomes.append(("ok", entry.coerce(raw)))
        except (ValueError, cfg.ConfigError) as exc:
            outcomes.append(("error", type(exc).__name__, str(exc)))
    assert outcomes[0] == outcomes[1]


def test_engine_config_set_changes_the_port_only():
    from valkey_search_tpu_torch.runtime.device import set_device
    from valkey_search_tpu_torch.server.engine import Engine

    set_device("cpu")
    name = "search.corpus-dtype"
    jbefore, tbefore = jconfig.get(name), tconfig.get(name)
    other = "int8" if tbefore != "int8" else "float32"
    try:
        Engine().config_set(name, other)
        assert tconfig.get(name) == other
        assert jconfig.get(name) == jbefore
    finally:
        tconfig.set_config(name, tbefore)


# -- interning, patricia, lru ----------------------------------------------------


def test_key_interner_matches_the_reference(rng):
    sides = (JaxInterner(), KeyInterner())
    keys = [f"doc:{i}" for i in range(400)]
    for step in range(3000):
        op = rng.integers(0, 10)
        key = keys[int(rng.integers(0, len(keys)))]
        if op < 5:
            got = [s.intern(key) for s in sides]
        elif op < 7:
            got = [s.release(key) for s in sides]
        elif op < 8:
            batch = [keys[int(i)] for i in rng.integers(0, len(keys), 6)]
            got = [s.intern_many(batch) for s in sides]
        else:
            doc = int(rng.integers(0, 500))
            got = [(s.lookup(key), s.key_of(doc)) for s in sides]
        assert got[0] == got[1], step
    j, t = sides
    assert (j.count, j.capacity) == (t.count, t.capacity)
    assert sorted(j.items()) == sorted(t.items())
    np.testing.assert_array_equal(j.valid_ids_np(512), t.valid_ids_np(512))
    docs = list(range(0, 450, 7))
    assert j.keys_of(docs) == t.keys_of(docs)
    mapping = dict(j.items())
    for s in sides:
        s.restore(mapping, capacity=600)
    assert sorted(j.items()) == sorted(t.items())
    assert (j.intern("new"), j.capacity) == (t.intern("new"), t.capacity)


def test_patricia_tree_matches_the_reference(rng):
    sides = (JaxPatricia(), PatriciaTree())
    alphabet = np.array(list("abc:"))
    prefixes = ["".join(rng.choice(alphabet, rng.integers(0, 5)))
                for _ in range(40)]
    for step in range(1500):
        prefix = prefixes[int(rng.integers(0, len(prefixes)))]
        sub = f"s{int(rng.integers(0, 8))}"
        op = rng.integers(0, 4)
        if op == 0:
            for s in sides:
                s.insert(prefix, sub)
        elif op == 1:
            for s in sides:
                s.remove(prefix, sub)
        else:
            key = "".join(rng.choice(alphabet, rng.integers(0, 8)))
            got = [sorted(s.match(key)) for s in sides]
            assert got[0] == got[1], step


def test_lru_matches_the_reference(rng):
    sides = (JaxLRU(16), LRU(16))
    for step in range(3000):
        key = int(rng.integers(0, 40))
        op = rng.integers(0, 3)
        if op == 0:
            for s in sides:
                s.put(key, step)
        elif op == 1:
            got = [s.get(key) for s in sides]
            assert got[0] == got[1], step
        else:
            for s in sides:
                s.remove(key)
        assert len(sides[0]) == len(sides[1])


# -- attribute data types, planner, metrics, cancel -----------------------------


_JSON_DOCS = [
    {"$": '{"a": 1, "b": {"c": [1.5, 2, 3]}, "t": "x,y", "n": null}'},
    {"$": '{"a": [true, false], "b": {"c": "text"}, "arr": [[1, 2], [3]]}'},
    {"$": '{"vec": [0.25, -1, 3e2], "nested": {"deep": {"k": "v"}}}'},
    {"$": "not json"},
    {},
]
_PATHS = ["$.a", "$.b.c", "$.b.c[1]", "$.t", "$.n", "$.arr[0]", "$.vec",
          "$.nested.deep.k", "$.missing", "a", "$", "$.b"]


@pytest.mark.parametrize("doc", range(len(_JSON_DOCS)))
def test_attribute_data_types_match_the_reference(doc):
    fields = dict(_JSON_DOCS[doc], plain="v1", num="3.5")
    for on in ("HASH", "JSON"):
        jdt, tdt = jadt.data_type_for(on), tadt.data_type_for(on)
        assert type(jdt).__name__ == type(tdt).__name__
        for ident in _PATHS + ["plain", "num"]:
            outcomes = []
            for dt in (jdt, tdt):
                try:
                    outcomes.append(("ok", repr(dt.fetch(fields, ident))))
                except Exception as exc:  # the same error on both sides
                    outcomes.append(("error", type(exc).__name__, str(exc)))
            assert outcomes[0] == outcomes[1], (on, ident)


class _Index:
    kind = "HNSW"

    def __init__(self, n):
        self.n = n

    def count(self):
        return self.n


@pytest.mark.parametrize("qualified", [0, 10, 449, 450, 451, 2000])
def test_planner_matches_the_reference(qualified):
    for idx in (_Index(1000), _Index(0)):
        assert (tplanner.use_prefiltering(qualified, idx)
                == jplanner.use_prefiltering(qualified, idx))
    flat = _Index(10)
    flat.kind = "FLAT"
    assert tplanner.use_prefiltering(qualified, flat) is True


def test_metrics_match_the_reference(rng):
    sides = (jmetrics.Stats(), tmetrics.Stats())
    assert tmetrics.STATS is not jmetrics.STATS
    for _ in range(500):
        name = f"c{int(rng.integers(0, 5))}"
        by = int(rng.integers(1, 4))
        usec = float(rng.lognormal(5, 2))
        for s in sides:
            s.incr(name, by)
            s.sampler("lat").observe_usec(usec)
    assert sides[0].snapshot() == sides[1].snapshot()
    for p in (0.5, 0.9, 0.99):
        assert (sides[0].sampler("lat").percentile(p)
                == sides[1].sampler("lat").percentile(p))


def test_cancel_tokens_match_the_reference():
    for mod in (jcancel, tcancel):
        token = mod.Token(None)
        assert not token.expired()
        token.cancel("stop")
        with pytest.raises(mod.CancelledError, match="stop"):
            token.check()
        assert mod.Token(-1.0).expired()
        assert not mod.from_timeout_ms(10_000).expired()
    assert tcancel.CancelledError is not jcancel.CancelledError


# -- the query batcher -----------------------------------------------------------


class _RecordingIndex:
    """search_batch returns each query's row sum as its distance and the
    batch size as its id, and records the batch shapes."""

    def __init__(self):
        self.shapes = []
        self.lock = threading.Lock()

    def search_batch(self, queries, k, ef=None):
        with self.lock:
            self.shapes.append(queries.shape)
        d = np.repeat(queries.sum(1, keepdims=True), k, axis=1)
        ids = np.full((queries.shape[0], k), queries.shape[0], np.int64)
        if ef is not None:
            ids += ef
        return d, ids


@pytest.mark.parametrize("threads", [1, 8])
def test_batcher_matches_the_reference(rng, threads):
    queries = rng.standard_normal((48, 6)).astype(np.float32)
    results = {}
    for name, mod in (("jax", jbatcher), ("port", tbatcher)):
        index = _RecordingIndex()
        batcher = mod.VectorQueryBatcher()
        out = [None] * len(queries)

        def worker(t):
            for i in range(t, len(queries), threads):
                d, ids = batcher.submit(index, queries[i], 3, None).result(10)
                out[i] = (d.tolist(), ids[0] >= 1)

        pool = [threading.Thread(target=worker, args=(t,))
                for t in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(30)
        assert not any(t.is_alive() for t in pool)
        launched = sum(s[0] for s in index.shapes)
        if name == "jax":
            # every launch is padded to a power of two rows
            assert all(s[0] & (s[0] - 1) == 0 for s in index.shapes)
            assert launched >= len(queries)
        else:
            # the port launches each batch at its own size: no padded row
            assert launched == len(queries)
        d, ids = batcher.submit(index, queries[0], 2, 5).result(10)
        out.append((d.tolist(), int(ids[0]) - 5 >= 1))
        results[name] = out
    assert results["port"] == results["jax"]
