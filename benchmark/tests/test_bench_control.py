"""The control: the reference in TF32 in the program's place fails the
cell's limits, and so does the planted scan fault, at a size a test run
holds (on the card both ran at each cell's own size; PERF.md gives their
readings)."""

import pytest
import torch

from bench_helpers import SEED, TAGGED, small_cell
from benchmark import control

CELLS = ["sift1m_int8.serial_c1", "cohere1m_bf16.knn100_c50", TAGGED]


@pytest.mark.parametrize("cell", CELLS)
def test_the_tf32_control_is_not_correct(cell):
    c = small_cell(cell, rows=20000)
    numbers = control.control_numbers(c, SEED, 300, torch.device("cpu"))
    limit = c.config["limits"]["dist_err"]
    assert numbers["dist_err"] > 3 * limit
    assert all(numbers[n] == 0 for n in ("failed", "outside", "short", "dup",
                                         "unsorted"))


@pytest.mark.parametrize("cell", CELLS)
def test_the_halved_scan_fails_recall_miss_alone(cell):
    c = small_cell(cell, rows=20000)
    numbers = control.control_numbers(c, SEED, 300, torch.device("cpu"),
                                      "halved_scan")
    limits = c.config["limits"]
    assert numbers["recall_miss"] > 3 * limits["recall_miss"]
    assert numbers["dist_err"] < limits["dist_err"] / 3
    assert all(numbers[n] == 0 for n in ("failed", "outside", "short", "dup",
                                         "unsorted"))


def test_the_control_draws_the_runs_requests():
    c = small_cell(TAGGED)
    a = control.requests_of(c.traffic, 128, SEED, 50)
    b = control.requests_of(c.traffic, 128, SEED, 50)
    assert a == b and len({r[0] for r in a}) == 6
    assert all(0 <= r[1] < 128 and 0 <= r[2] < 100 for r in a)
