"""The port's TEXT index against the JAX package's.

The same documents (with updates and deletes) go through the JAX Engine and
the port's, on the native text tier and on the pure-Python one. Term,
prefix, suffix, infix, fuzzy and phrase matchers must give the same doc ids,
estimates and device masks, and the same FT.SEARCH replies. The copied
stemmer must still pass the snowball golden file.
"""

import os

import numpy as np
import pytest

from valkey_search_tpu.query import parser as jparser
from valkey_search_tpu.query import predicate as jpred
from valkey_search_tpu.server.engine import Engine as JaxEngine
from valkey_search_tpu_torch.query import parser as tparser
from valkey_search_tpu_torch.query import predicate as tpred
from valkey_search_tpu_torch.runtime.device import set_device
from valkey_search_tpu_torch.server.engine import Engine
from valkey_search_tpu_torch.text.stemmer import stem

GOLDEN = os.path.join(os.path.dirname(__file__), "data", "snowball_golden.txt")
WORDS = ["running", "runs", "runner", "hacker", "hackers", "hacking", "quick",
         "brown", "fox", "foxes", "jumps", "lazy", "dogs", "crash", "crush",
         "snow", "cedars", "the", "a", "generous", "general", "hello"]


@pytest.fixture(autouse=True)
def _cpu():
    set_device("cpu")


def test_copied_stemmer_passes_the_golden_file():
    n = 0
    with open(GOLDEN) as f:
        for line in f:
            word, expect = line.rstrip("\n").split("\t")
            assert stem(word) == expect, f"stem({word!r})"
            n += 1
    assert n > 2000


def _run(engines, *argv):
    replies = [e.execute(*argv) for e in engines]
    assert replies[1] == replies[0], argv
    return replies[0]


def _text_engines(rng, tier, n=400):
    engines = (JaxEngine(), Engine())
    _run(engines, "FT.CREATE", "idx", "ON", "HASH", "PREFIX", "1", "d:",
         "SCHEMA", "title", "TEXT", "body", "TEXT", "NOSTEM", "n", "NUMERIC")
    for e in engines:
        eng = e.manager.get("idx").text_engine
        if tier == "python":
            eng._nt = None
        assert (eng._nt is None) == (tier == "python")

    def text(k):
        return " ".join(rng.choice(WORDS, size=k))

    for i in range(n):
        _run(engines, "HSET", f"d:{i}", "title", text(4), "body", text(6),
             "n", str(i))
    for i in range(0, n, 7):
        _run(engines, "HSET", f"d:{i}", "title", text(3))
    _run(engines, "DEL", *[f"d:{i}" for i in range(3, n, 11)])
    return engines


TEXT_QUERIES = [
    "running", "run", "@title:runs", "@body:runs", "hack*", "@body:hack*",
    "*ing", "*ack*", "%crish%", "%%hackr%%", '"quick brown"',
    '@title:"brown fox"', "the", "crash @n:[0 199]", "-crash",
    "@title:(quick|lazy)", "hello world",
]


@pytest.mark.parametrize("tier", ["native", "python"])
@pytest.mark.parametrize("query", TEXT_QUERIES)
def test_text_matchers_match(rng, tier, query):
    engines = _text_engines(rng, tier)
    jschema, tschema = (e.manager.get("idx") for e in engines)
    jp, _ = jparser.parse_query(query, {})
    tp, _ = tparser.parse_query(query, {})
    jctx, tctx = jpred.EvalContext(jschema), tpred.EvalContext(tschema)
    assert tp.estimate(tctx) == jp.estimate(jctx)
    np.testing.assert_array_equal(np.sort(np.asarray(list(tp.host_ids(tctx)))),
                                  np.sort(np.asarray(list(jp.host_ids(jctx)))))
    np.testing.assert_array_equal(tp.device_mask(tctx).numpy(),
                                  np.asarray(jp.device_mask(jctx)))
    _run(engines, "FT.SEARCH", "idx", query, "LIMIT", "0", "500", "NOCONTENT")


@pytest.mark.parametrize("tier", ["native", "python"])
def test_phrase_options_and_info_match(rng, tier):
    engines = _text_engines(rng, tier)
    for extra in (("SLOP", "2"), ("SLOP", "1", "INORDER")):
        _run(engines, "FT.SEARCH", "idx", '"brown quick"', *extra,
             "LIMIT", "0", "500", "NOCONTENT")
    _run(engines, "FT.SEARCH", "idx", "fox*", "SORTBY", "n", "DESC",
         "RETURN", "2", "title", "n")
    infos = [e.execute("FT.INFO", "idx") for e in engines]
    for info in infos:  # text memory is apportioned the same way
        assert info[7][0][:8] == ["identifier", "title", "attribute", "title",
                                  "type", "TEXT", "num_records", 400 - 37]
    assert infos[1] == infos[0]
