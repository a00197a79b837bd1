"""A run with the timed path broken underneath comes out not correct.

Each test skips the look for a card and drives the rest of a run on the CPU
at a small size, with ``FlatVectorIndex.search_batch`` (the device program
the window drives) broken in one way. The exchange between chips is not a
fault these cells can have: every cell runs on one chip.
"""

import numpy as np
import pytest

from bench_helpers import TAGGED, cpu_run

CELLS = ["sift1m_int8.serial_c1", "cohere1m_bf16.knn100_c50", TAGGED]


def break_search_batch(monkeypatch, fault):
    from valkey_search_tpu_torch.indexes.flat import FlatVectorIndex

    real = FlatVectorIndex.search_batch
    state = {}

    def broken(index, queries, k, filter_mask=None):
        d, i = real(index, queries, k, filter_mask=filter_mask)
        return fault(state, index, np.atleast_2d(queries), d.copy(), i.copy())

    monkeypatch.setattr(FlatVectorIndex, "search_batch", broken)


def unchanged(state, index, queries, d, i):
    """Every launch after the first returns the first launch's answer."""
    first = state.setdefault("first", (d[:1], i[:1]))
    return np.repeat(first[0], len(d), 0), np.repeat(first[1], len(i), 0)


def half_batch(state, index, queries, d, i):
    """Only the first half of a batch is searched; the rest get row 0's."""
    state["batches"] = state.get("batches", 0) + (len(d) > 1)
    keep = max(1, len(d) // 2)
    d[keep:], i[keep:] = d[0], i[0]
    return d, i


def altered(state, index, queries, d, i):
    """The first answer of every launch names the next document."""
    i[0, 0] = (i[0, 0] + 1) % index.store.capacity
    return d, i


@pytest.mark.parametrize("fault", [unchanged, half_batch, altered],
                         ids=lambda f: f.__name__)
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_launch_is_not_correct(cell, fault, monkeypatch):
    if fault is half_batch and cell != "cohere1m_bf16.knn100_c50":
        pytest.skip("one query a launch (one connection, or a filter): no "
                    "batch to halve")
    break_search_batch(monkeypatch, fault)
    out = cpu_run(cell)
    assert out["correct"] is False
    assert out["checks"]["dist_err"]["value"] > \
        out["checks"]["dist_err"]["limit"]


@pytest.mark.parametrize("cell", CELLS)
def test_a_scan_that_skips_half_the_rows_is_not_correct(cell, monkeypatch):
    """The scan sees the even rows alone; what it finds is rescored exactly,
    so the distances hold and only the neighbours are wrong."""
    import torch

    from valkey_search_tpu_torch.indexes.flat import FlatVectorIndex, _fit_mask

    real = FlatVectorIndex.search_batch

    def broken(index, queries, k, filter_mask=None):
        cap = index.store.capacity
        even = torch.zeros(cap, dtype=torch.bool, device=index.store.device)
        even[::2] = True
        if filter_mask is not None:
            even = _fit_mask(filter_mask, cap) & even
        return real(index, queries, k, filter_mask=even)

    monkeypatch.setattr(FlatVectorIndex, "search_batch", broken)
    out = cpu_run(cell)
    assert out["correct"] is False
    checks = out["checks"]
    assert checks["dist_err"]["value"] <= checks["dist_err"]["limit"]
    assert checks["recall_miss"]["value"] > 3 * checks["recall_miss"]["limit"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_sound_program_is_correct(cell):
    out = cpu_run(cell)
    assert out["correct"] is True
    checks = out["checks"]
    assert checks["dist_err"]["value"] < checks["dist_err"]["limit"] / 3
    assert checks["recall_miss"]["value"] < checks["recall_miss"]["limit"]
