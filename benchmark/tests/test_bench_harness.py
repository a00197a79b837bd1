"""The harness on the CPU: the reference, discovery by name, the result
line, the roofline's count, the trace arithmetic and the RESP client."""

import json
import os

import numpy as np
import pytest
import torch

from bench_helpers import SEED, TAGGED, cpu_run, named_cell, tagged_cell
from benchmark import datagen, reference, run, spec, tracing, work
from benchmark.loadgen import filter_clause, parse_reply
from benchmark.record import Run
from benchmark.resp_client import Incomplete, encode, parse

ROOT = spec.ROOT


def brute(corpus, queries, k, metric, rows=None):
    c = corpus.astype(np.float64)
    q = queries.astype(np.float64)
    if metric == "COSINE":
        c = c / np.linalg.norm(c, axis=1, keepdims=True)
        q = q / np.linalg.norm(q, axis=1, keepdims=True)
        d = 1.0 - q @ c.T
    else:
        d = ((q[:, None, :] - c[None, :, :]) ** 2).sum(-1)
    ids = np.arange(len(c)) if rows is None else rows
    d = d[:, ids]
    order = np.argsort(d, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(d, order, 1), ids[order]


@pytest.mark.parametrize("metric", ["L2", "COSINE"])
@pytest.mark.parametrize("filtered", [False, True])
def test_reference_topk_is_brute_force(metric, filtered, monkeypatch):
    monkeypatch.setattr(reference, "C_BLOCK", 300)  # several row blocks
    monkeypatch.setattr(reference, "Q_BLOCK", 7)
    rng = np.random.default_rng(5)
    corpus = rng.standard_normal((1000, 24)).astype(np.float32)
    queries = rng.standard_normal((20, 24)).astype(np.float32)
    rows = np.sort(rng.choice(1000, 400, replace=False)) if filtered else None
    d, i = reference.topk(torch.from_numpy(corpus), queries, 10, metric,
                          None if rows is None else torch.from_numpy(rows))
    want_d, want_i = brute(corpus, queries, 10, metric, rows)
    np.testing.assert_array_equal(i, want_i)
    np.testing.assert_allclose(d, want_d, rtol=1e-9, atol=1e-9)


def test_reference_judges_a_perfect_and_a_broken_reply():
    rng = np.random.default_rng(6)
    corpus = rng.standard_normal((500, 16)).astype(np.float32)
    pool = rng.standard_normal((4, 16)).astype(np.float32)
    cfg = {"metric": "L2", "fields": []}
    d, i = brute(corpus, pool, 5, "L2")
    good = [[0, q, 0, 0.0, 1.0, i[q].tolist(), d[q].tolist()]
            for q in range(4)]
    numbers, recall = reference.judge(torch.from_numpy(corpus), pool, cfg,
                                      {}, None, 5, good)
    assert numbers["dist_err"] < 1e-12 and list(recall) == [1.0] * 4
    assert all(numbers[n] == 0 for n in ("failed", "outside", "short",
                                         "dup", "unsorted"))
    bad = [good[0][:5] + [[i[0][1]] + i[0][1:].tolist(), d[0].tolist()],
           good[1][:5] + [None, "ERR"],
           good[2][:5] + [i[2][:3].tolist(), d[2][:3].tolist()],
           good[3][:5] + [i[3].tolist()[::-1], d[3].tolist()[::-1]]]
    numbers, _ = reference.judge(torch.from_numpy(corpus), pool, cfg, {},
                                 None, 5, bad)
    assert numbers["dup"] == 1 and numbers["failed"] == 1
    assert numbers["short"] == 1 and numbers["unsorted"] == 1
    assert numbers["dist_err"] > 1e-3  # reply 0's first key has the wrong score


def test_tf32_round_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2**-10, 1.0 + 2**-11, 1.0 + 3 * 2**-11, 255.3])
    y = reference.tf32_round(x)
    assert y[0] == 1.0 + 2**-10
    assert y[1] == 1.0  # a tie rounds to the even neighbour
    assert y[2] == 1.0 + 2**-9
    assert abs(float(y[3]) - 255.3) <= 255.3 * 2**-11


def test_every_name_in_benchmark_json_finds_its_files():
    bench = spec.benchmark_json()
    names = {c["name"] for c in bench["configs"]}
    for c in bench["configs"]:
        cfg = spec.load_json(os.path.join(ROOT, c["file"]))
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
    for w in bench["workloads"]:
        cell = spec.cell(w["name"], bench)
        assert w["config"] in names and cell.chips == w["chips"]
        assert cell.config["name"] == w["config"]
        kinds = {m.kind for m in cell.metrics}
        assert kinds == {"end_to_end", "per_layer"}
        assert "setup_s" in {m.name for m in cell.metrics}
    for kind in ("end_to_end", "per_layer"):
        for m in bench[kind]:
            assert callable(spec.load_reader(m["name"]))


def test_a_cell_added_as_files_is_found(tmp_path, monkeypatch):
    bench = spec.benchmark_json()
    bench["workloads"].append({"name": "sift1m_int8.extra", "config":
                               "sift1m_int8", "traffic": "serial_c1",
                               "chips": 1, "why": "test"})
    cell = spec.cell("sift1m_int8.extra", bench)
    assert cell.traffic["k"] == 10 and cell.config["dim"] == 128


def test_data_is_made_from_the_seed():
    cfg = tagged_cell().config
    small = dict(cfg, rows=3000)
    a = datagen.make(small, {"pool": 50}, SEED, torch.device("cpu"))
    b = datagen.make(small, {"pool": 50}, SEED, torch.device("cpu"))
    c = datagen.make(small, {"pool": 50}, SEED + 1, torch.device("cpu"))
    np.testing.assert_array_equal(a.corpus, b.corpus)
    np.testing.assert_array_equal(a.fields["cat"], b.fields["cat"])
    assert not np.array_equal(a.corpus, c.corpus)
    assert a.corpus.shape == c.corpus.shape == (3000, 128)
    assert a.corpus.min() >= 0 and a.corpus.max() <= 255
    assert set(np.unique(a.fields["cat"])) <= set(range(100))
    cos = named_cell("cohere1m_bf16.knn100_c50").config
    d = datagen.make(dict(cos, rows=1000), {"pool": 10}, SEED,
                     torch.device("cpu"))
    np.testing.assert_allclose(np.linalg.norm(d.corpus, axis=1), 1, atol=1e-5)
    assert d.fields == {}
    ids = datagen.fields({"rows": 5, "fields": [
        {"name": "id", "type": "NUMERIC", "recipe": "row_number"}]}, SEED)
    np.testing.assert_array_equal(ids["id"], np.arange(5))


def test_filter_clause_and_admitted_rows():
    cfg = tagged_cell().config
    flt = tagged_cell().traffic["filter"]
    assert filter_clause(flt, 7) == "@cat:{c7}"
    assert filter_clause(None, 7) == "*"
    cats = np.array([7, 3, 7, 70])
    rows = reference.admitted_rows(cfg, {"cat": cats}, flt, 7)
    np.testing.assert_array_equal(rows, [0, 2])
    num = {"kind": "numeric", "field": "id", "min": 2, "max": "+inf"}
    assert filter_clause(num, 0) == "@id:[2 +inf]"
    np.testing.assert_array_equal(
        reference.admitted_rows(cfg, {"id": np.arange(5)}, num, 0), [2, 3, 4])


@pytest.mark.parametrize("cell, trace", [
    ("cohere1m_bf16.knn100_c50", False), ("cohere1m_bf16.knn100_c50", True),
    (TAGGED, True)])
def test_the_result_line(cell, trace):
    out = cpu_run(cell, trace=trace)
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(out)[-1] == "checks"
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] > 0
    assert set(out["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    for name, c in out["checks"].items():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]
    kind = "per_layer" if trace else "end_to_end"
    metrics = named_cell(cell).metrics
    want = {m.name for m in metrics if m.kind == kind}
    # the CPU has no device trace: its two metrics are left out there
    want -= {"knn_roofline", "device_idle_share"}
    assert set(out["metrics"]) == want
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"}
    json.dumps(out)


def test_no_card_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert run.main(["--workload", "sift1m_int8.serial_c1", "--seed", "1",
                     "--seconds", "1"]) == 2
    assert capsys.readouterr().out == ""


def test_foreign_modules_are_named(monkeypatch):
    import sys
    import types

    assert run.foreign_modules() == [] or "jax" in sys.modules
    monkeypatch.setitem(sys.modules, "valkey_search_tpu.ops",
                        types.ModuleType("valkey_search_tpu.ops"))
    assert "valkey_search_tpu" in run.foreign_modules()
    monkeypatch.delitem(sys.modules, "valkey_search_tpu.ops")
    monkeypatch.setitem(sys.modules, "valkey_search_tpu_torch_x",
                        types.ModuleType("valkey_search_tpu_torch_x"))
    assert "valkey_search_tpu" not in run.foreign_modules()


def test_the_roofline_counts_shapes():
    assert work.launch_bytes(4, 1_000_000, 128, 10, "int8") == (
        1_000_000 * 132 + 4 * 128 * 4 + 4 * 10 * 12)
    assert work.launch_ops(4, 1_000_000, 128) == 2 * 4 * 1_000_000 * 128
    peak = work.peaks("NVIDIA H100 80GB HBM3")
    s = work.least_seconds(4, 1_000_000, 768, 100, "bfloat16", peak)
    assert s == pytest.approx((1_000_000 * 1540 + 4 * 768 * 4 + 4 * 100 * 12)
                              / 3.35e12)
    # enough queries make the launch bound by operations
    s = work.least_seconds(4096, 1_000_000, 128, 10, "int8", peak)
    assert s == pytest.approx(2 * 4096 * 1_000_000 * 128 / 1.979e15)
    assert work.corpus_dtype(named_cell("cohere1m_bf16.knn100_c50").config) \
        == "bfloat16"
    assert work.corpus_dtype(spec.cell("sift1m_int8.serial_c1").config) \
        == "int8"


def synthetic_run(cfg):
    spans = tracing.Spans()
    # two launches of 3 queries; the second behind a filter of 10,000 rows
    spans._sb.extend((1.0, 1.002, 3, 10, -1, 1.5, 1.501, 3, 10, 10_000))
    spans._ft.extend((0.999, 1.004, 1.49, 1.51))
    sl = tracing.DeviceSlice(0.9, 1.9, [("scan", 1.0005, 1.0010),
                                        ("topk", 1.0008, 1.0012),
                                        ("scan", 1.5002, 1.5004)], True)
    return Run(cfg, {}, 0.5, 2.0, 1.0, [], np.zeros(0), spans, sl,
               "NVIDIA H100 80GB HBM3")


def test_trace_readers_on_a_synthetic_slice():
    cfg = spec.cell("sift1m_int8.serial_c1").config
    r = synthetic_run(cfg)
    busy = 0.0007 + 0.0002
    assert tracing.busy_seconds(r.device_slice) == pytest.approx(busy)
    idle = spec.load_reader("device_idle_share")(r)
    assert idle == pytest.approx(1 - busy / 1.0)
    peak = work.peaks("NVIDIA H100 80GB HBM3")
    least = (work.least_seconds(3, 1_000_000, 128, 10, "int8", peak)
             + work.least_seconds(3, 10_000, 128, 10, "int8", peak))
    assert spec.load_reader("knn_roofline")(r) == pytest.approx(
        least / busy * 100)
    assert spec.load_reader("queries_per_launch")(r) == 3
    assert spec.load_reader("launch_ms")(r) == pytest.approx(1.5)
    assert spec.load_reader("engine_ms")(r) == pytest.approx(12.5)
    gaps = tracing.idle_gaps(r.device_slice)
    assert gaps[0] == (0.9, 1.0005) and gaps[-1] == (1.5004, 1.9)
    b = tracing.breakdown(r.device_slice, r.spans)
    assert b["device_ops"][0][0] == "scan"
    assert len(b["idle_gaps"]) == 3
    assert b["idle_gaps"][1][0] == \
        "no Engine.ft_search running (RESP, reader pool)"
    # a slice whose kernels the profiler lost: copies alone
    r.device_slice = r.device_slice._replace(ops=[(
        "Memcpy DtoH (Device -> Pageable)", 1.0005, 1.0006)])
    assert not tracing.has_kernels(r.device_slice)
    assert spec.load_reader("knn_roofline")(r) is None
    assert spec.load_reader("device_idle_share")(r) is None
    r.device_slice = None
    assert spec.load_reader("knn_roofline")(r) is None


def test_the_reply_parser_takes_replies_in_pieces():
    reply = (b"*5\r\n:2\r\n$5\r\ndoc:2\r\n*2\r\n$9\r\n__v_score\r\n"
             b"$3\r\n0.5\r\n$5\r\ndoc:1\r\n*2\r\n$9\r\n__v_score\r\n"
             b"$3\r\n1.5\r\n+OK\r\n")
    for cut in range(1, len(reply) - 5):
        with pytest.raises(Incomplete):
            parse(reply[:cut])
    value, end = parse(reply)
    assert parse_reply(value, "doc:") == ([2, 1], [0.5, 1.5])
    assert parse(reply, end) == ("OK", len(reply))
    assert isinstance(parse(b"-ERR no\r\n")[0], RuntimeError)


def test_resp_client_against_the_servers_cpu_engine():
    import socket

    from valkey_search_tpu_torch.runtime.device import set_device
    from valkey_search_tpu_torch.server.engine import Engine
    from valkey_search_tpu_torch.server.resp import RespServer

    def cmd(sock, *argv):
        sock.sendall(encode(argv))
        buf = b""
        while True:
            buf += sock.recv(65536)
            try:
                return parse(buf)[0]
            except Incomplete:
                continue

    set_device("cpu")
    srv = RespServer(Engine(), port=0).start()
    try:
        with socket.create_connection(("127.0.0.1", srv.port)) as c:
            assert cmd(c, "PING") == "PONG"
            cmd(c, "FT.CREATE", "i", "ON", "HASH", "PREFIX", "1", "doc:",
                "SCHEMA", "v", "VECTOR", "FLAT", "6", "TYPE", "FLOAT32",
                "DIM", "4", "DISTANCE_METRIC", "L2")
            rows = np.arange(12, dtype=np.float32).reshape(3, 4)
            for n, row in enumerate(rows):
                assert cmd(c, "HSET", f"doc:{n}", "v", row.tobytes()) == 1
            reply = cmd(c, *run.search_argv(
                {"index": "i", "vector_field": "v"}, {"k": 2, "filter": None},
                rows[2], 0))
            keys, scores = parse_reply(reply, "doc:")
            assert keys == [2, 1] and scores == [0.0, 64.0]
    finally:
        srv.close()


@pytest.mark.cuda
def test_a_short_run_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = run.run_cell(spec.cell("sift1m_int8.serial_c1"), SEED, 2.0, True)
    assert out["correct"] and out["device"]["platform"] == "gpu"


def test_the_server_and_the_load_get_disjoint_cpus(monkeypatch):
    monkeypatch.setattr(os, "sched_getaffinity", lambda pid: set(range(8)))
    assert run.cpu_sets() == ([0, 1, 2, 3, 4, 5], [6, 7])
    monkeypatch.setattr(os, "sched_getaffinity", lambda pid: {3})
    assert run.cpu_sets() == ([3], [3])
