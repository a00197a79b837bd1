"""Fuzzy matching in the port against the JAX package: plain Levenshtein.

Both packages count a transposition ("hello" / "hlelo", "search" /
"saerch") as two edits, in ``RadixTree.fuzzy`` and in FT.SEARCH's
``%term%`` / ``%%term%%`` on the native and the pure-Python text tiers.
valkey-search counts it as one; counting it so would be a feature the JAX
package lacks, so the port keeps the JAX package's distance and this test
pins the parity: the same words, distances and doc ids in both packages,
and each distance equal to the Levenshtein distance computed here.
"""

import pytest

from valkey_search_tpu.server.engine import Engine as JaxEngine
from valkey_search_tpu.text.radix import RadixTree as JaxRadixTree
from valkey_search_tpu_torch.runtime.device import set_device
from valkey_search_tpu_torch.server.engine import Engine
from valkey_search_tpu_torch.text.radix import RadixTree

WORDS = ["hello", "hell", "help", "helo", "hallo", "jello", "yellow",
         "search", "searches", "research", "starch", "sear", "scorch",
         "reach", "serach"]
# each is one transposition away from a word of WORDS
QUERIES = ["hlelo", "ehllo", "saerch", "serach", "hello", "search"]


@pytest.fixture(autouse=True)
def _cpu():
    set_device("cpu")


def levenshtein(a, b):
    row = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        prev, row[0] = row[0], i
        for j, cb in enumerate(b, 1):
            prev, row[j] = row[j], min(row[j] + 1, row[j - 1] + 1,
                                       prev + (ca != cb))
    return row[-1]


def _trees():
    jt, tt = JaxRadixTree(), RadixTree()
    for i, w in enumerate(WORDS):
        jt.insert(w, i)
        tt.insert(w, i)
    return jt, tt


@pytest.mark.parametrize("query", QUERIES)
@pytest.mark.parametrize("dist", [1, 2, 3])
def test_radix_fuzzy_matches_jax_as_levenshtein(query, dist):
    jt, tt = _trees()
    got = sorted(tt.fuzzy(query, dist))
    assert got == sorted(jt.fuzzy(query, dist))
    want = sorted((w, i, levenshtein(query, w)) for i, w in enumerate(WORDS)
                  if levenshtein(query, w) <= dist)
    assert got == want


def test_a_transposition_counts_two():
    _, tt = _trees()
    for query, word in (("hlelo", "hello"), ("saerch", "search")):
        assert word not in {w for w, _, _ in tt.fuzzy(query, 1)}
        assert (word, 2) in {(w, d) for w, _, d in tt.fuzzy(query, 2)}


def _run(engines, *argv):
    replies = [e.execute(*argv) for e in engines]
    assert replies[1] == replies[0], argv
    return replies[0]


def _engines(tier):
    engines = (JaxEngine(), Engine())
    _run(engines, "FT.CREATE", "idx", "ON", "HASH", "PREFIX", "1", "d:",
         "SCHEMA", "title", "TEXT", "NOSTEM")
    for e in engines:
        eng = e.manager.get("idx").text_engine
        if tier == "python":
            eng._nt = None
        assert (eng._nt is None) == (tier == "python")
    for i, w in enumerate(WORDS):
        _run(engines, "HSET", f"d:{i}", "title", f"{w} note")
    return engines


@pytest.mark.parametrize("tier", ["native", "python"])
@pytest.mark.parametrize("query", QUERIES)
def test_ft_search_fuzzy_matches_jax(tier, query):
    engines = _engines(tier)
    for marks, dist in (("%", 1), ("%%", 2)):
        for q in (f"{marks}{query}{marks}", f"@title:{marks}{query}{marks}"):
            reply = _run(engines, "FT.SEARCH", "idx", q, "LIMIT", "0", "100",
                         "NOCONTENT")
            keys = sorted(k.decode() if isinstance(k, bytes) else k
                          for k in reply[1:])
            want = sorted(f"d:{i}" for i, w in enumerate(WORDS)
                          if levenshtein(query, w) <= dist)
            assert reply[0] == len(want) and keys == want, (tier, q)
