"""The port's ``native_lib`` and ``schema_manager`` names against the JAX
package's.

``cpu_brute_force_topk`` binds the same native ``bf_topk`` in both
packages, so on the same seeded corpus and query the two return the same
ids and distances, bit for bit, under ``l2`` and ``ip``; both are checked
against numpy's exact top-k too. ``MANAGER`` is each package's module
singleton.
"""

import numpy as np
import pytest

from valkey_search_tpu import native_lib as jnative
from valkey_search_tpu.schema import schema_manager as jsm
from valkey_search_tpu_torch import native_lib
from valkey_search_tpu_torch.schema import schema_manager as tsm


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("n,d,k", [(2000, 48, 10), (513, 128, 100),
                                   (7, 16, 10)])
def test_cpu_brute_force_topk_is_the_jax_packages(metric, n, d, k):
    rng = np.random.default_rng(n + d + k)
    corpus = rng.standard_normal((n, d)).astype(np.float32)
    query = rng.standard_normal(d).astype(np.float32)
    td, ti = native_lib.cpu_brute_force_topk(corpus, query, k, metric)
    jd, ji = jnative.cpu_brute_force_topk(corpus, query, k, metric=metric)
    assert td.dtype == np.float32 and ti.dtype == np.int32
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(td.view(np.int32), jd.view(np.int32))
    # and the exact answer: the first min(k, n) ids, -1 past the corpus
    m = min(k, n)
    if metric == "l2":
        exact = ((corpus.astype(np.float64) - query) ** 2).sum(1)
    else:
        exact = -(corpus.astype(np.float64) @ query)
    want = np.argsort(exact, kind="stable")[:m]
    np.testing.assert_array_equal(np.sort(ti[:m]), np.sort(want))
    assert (ti[m:] == -1).all()


def test_cpu_brute_force_topk_defaults_to_l2():
    rng = np.random.default_rng(5)
    corpus = rng.standard_normal((300, 32)).astype(np.float32)
    query = corpus[17] + 1e-3
    d, ids = native_lib.cpu_brute_force_topk(corpus, query, 5)
    assert ids[0] == 17
    np.testing.assert_array_equal(
        ids, native_lib.cpu_brute_force_topk(corpus, query, 5, "l2")[1])


def test_schema_manager_singleton():
    assert isinstance(tsm.MANAGER, tsm.SchemaManager)
    assert isinstance(jsm.MANAGER, jsm.SchemaManager)
    assert tsm.MANAGER.__class__.__module__ == tsm.__name__
