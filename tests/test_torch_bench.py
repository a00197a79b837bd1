"""bench_torch.py, the port's benchmark, on the CPU at small sizes.

- (a) its recipes equal bench.py's bit for bit: centers, the SIFT-like
  corpus and queries, the cosine corpus and queries, the fp64 ground truth;
  the three shapes of scripts/recall_shapes.py (torch streams, so held by
  their statistics) and the full sizes of every section;
- (b) flat1m's two measured routes (the device program and search_batch)
  against the JAX package's FlatVectorIndex.search_batch on bench.py's
  recipe at 8,192 rows, under int8 and bfloat16 (at this size both
  packages serve the two-stage path): ids equal, distances within rtol
  1e-5 or 4 ulps of |q|^2 + |c|^2, equal recall;
- (c) the child protocol, and a section that raises: skip_<name>, exit 3;
- (d) the last line at its widest stays within 1,500 characters;
- (e) without a card the default run exits non-zero and runs no section;
- (f) ``--quick --device cpu`` end to end in a subprocess;
- (g) tests/test_torch_shared.py's import scan covers bench_torch.py.
"""

import contextlib
import importlib.util
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import bench_torch as bt
from valkey_search_tpu.indexes.flat import FlatVectorIndex as JaxFlat
from valkey_search_tpu_torch.ops import topk as topk_ops
from valkey_search_tpu_torch.runtime import config as tconfig
from valkey_search_tpu_torch.runtime.device import set_device
from torch_port_config import saved_options, set_both
from test_torch_shared import _imported_names, _port_files

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = [sys.executable, os.path.join(REPO, "bench_torch.py")]


@pytest.fixture(autouse=True)
def _cpu():
    set_device("cpu")
    with saved_options("search.corpus-dtype"):
        yield


def _reference_bench(monkeypatch, n, batch):
    """bench.py imported with its size knobs set (it reads them at import;
    importing it touches no device)."""
    monkeypatch.setenv("VSTPU_BENCH_N", str(n))
    monkeypatch.setenv("VSTPU_BENCH_BATCH", str(batch))
    monkeypatch.delenv("VSTPU_BENCH_QUICK", raising=False)
    spec = importlib.util.spec_from_file_location(
        "reference_bench", os.path.join(REPO, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# -- (a) recipes ----------------------------------------------------------------------


def test_recipes_equal_bench_py(monkeypatch):
    ref = _reference_bench(monkeypatch, 3000, 700)
    np.testing.assert_array_equal(bt.gen_centers(), ref.gen_centers())
    for got, want in zip(bt.gen_corpus_and_queries(3000, 700),
                         ref.gen_corpus_and_queries()):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    _, corpus, queries = ref.gen_corpus_and_queries()
    np.testing.assert_array_equal(bt.fp64_gt(corpus, queries[:20], 10),
                                  ref.fp64_gt(corpus, queries[:20], 10))
    # the device ground truth (here on the CPU) selects the same rows
    got = bt.fp64_gt_device(torch, torch.from_numpy(corpus), queries[:20],
                            torch.device("cpu"), rows=1000)
    np.testing.assert_array_equal(got, ref.fp64_gt(corpus, queries[:20], 10))


class _Captured(Exception):
    pass


def test_cosine_recipe_equals_bench_py(monkeypatch):
    """bench.py's section_cosine with its index swapped for a recorder:
    the rows it loads and the queries it sends equal gen_cosine's."""
    import valkey_search_tpu.indexes.flat as jflat
    from valkey_search_tpu.runtime import config as jconfig

    ref = _reference_bench(monkeypatch, 3000, 700)
    monkeypatch.setenv("VSTPU_BENCH_COSINE_N", "5000")
    seen = {}

    class Recorder:
        def __init__(self, dim, metric):
            seen["dim"], seen["metric"] = dim, metric
            self.store = self

        def bulk_load(self, keys, vecs):
            seen["corpus"] = np.array(vecs)

        def device_snapshot(self):
            return {}

        def search_batch(self, q, k):
            seen["queries"] = np.array(q)
            raise _Captured

    monkeypatch.setattr(ref, "child_jax_init", lambda: None)
    monkeypatch.setattr(jflat, "FlatVectorIndex", Recorder)
    try:
        with pytest.raises(_Captured):
            ref.section_cosine()
    finally:
        jconfig.REGISTRY.reset_all()
    corpus, queries = bt.gen_cosine(5000)
    assert (seen["dim"], seen["metric"]) == (100, "cosine")
    np.testing.assert_array_equal(corpus, seen["corpus"])
    np.testing.assert_array_equal(queries, seen["queries"])


@pytest.mark.parametrize("name", bt.SHAPES)
def test_shapes_by_their_statistics(name):
    """scripts/recall_shapes.py's shapes draw from jax.random, so the port's
    torch streams are held by shape, dtype, range, rank and norms."""
    dev = torch.device("cpu")
    x, q = bt.gen_shape(torch, dev, name, 4096, 64)
    d = 768 if name == "lowrank768" else 128
    assert x.shape == (4096, d) and q.shape == (64, d)
    assert x.dtype == q.dtype == torch.float32
    assert torch.isfinite(x).all() and torch.isfinite(q).all()
    x2, _ = bt.gen_shape(torch, dev, name, 4096, 64)
    assert torch.equal(x, x2)  # seeded
    if name == "clustered128":
        assert x.min() >= 0 and x.max() <= 255
        assert float(x.mean()) == pytest.approx(128, abs=8)
    elif name == "uniform128":
        assert x.min() >= 0 and x.max() < 255
        assert float(x.mean()) == pytest.approx(127.5, abs=2)
        assert float(x.std()) == pytest.approx(255 / 12 ** 0.5, rel=0.02)
    else:
        norms = torch.linalg.norm(x, dim=1)
        assert torch.allclose(norms, torch.ones_like(norms), atol=1e-5)
        s = torch.linalg.svdvals(x.double())
        # rank-64 latent structure over isotropic noise
        assert float(s[63] / s[64]) > 3.0
        assert float(s[64] / s[700]) < 3.0  # the noise bulk


def test_full_sizes_are_bench_py_and_the_scripts():
    sz = bt.sizes(bt.Opts())
    assert sz.cuts == ()
    assert sz.flat_batches == (1024, 16384)
    assert sz.big_n == 10_092_544 and sz.big_probes == (8, 16, 32)
    assert sz.xover_ns == (1_048_576, 2_097_152, 4_063_232)
    assert sz.hnsw_n == 1_000_000 and sz.cos_n == 1_183_514
    assert sz.shapes_n == 1_048_576 and sz.shapes_b == 16384
    assert sz.stream_chunks * sz.stream_chunk == 100_925_440
    assert sz.stream_b == 512 and sz.latency_samples >= 1000
    quick = bt.sizes(bt.parse_args(["--quick"]))
    assert quick.flat_batches == (1024, 2048) and quick.cuts


# -- (b) differential -----------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["int8", "bfloat16"])
def test_flat_routes_match_jax(dtype):
    _, corpus, queries = bt.gen_corpus_and_queries(8192, 512)
    q = queries[:256]
    set_both("search.corpus-dtype", dtype)
    jidx = JaxFlat(dim=128, metric="l2")
    jidx.bulk_load([f"doc:{i}" for i in range(len(corpus))], corpus)
    jd, ji = (np.asarray(a) for a in jidx.search_batch(q, 10))
    dev = torch.device("cpu")
    idx, snap, _ = bt.build_flat(torch, dev, corpus, dtype)
    sd, si = idx.search_batch(q, 10)
    ld, li = bt.flat_launch(topk_ops, tconfig, snap, torch.from_numpy(q))
    gt = bt.fp64_gt(corpus, q, 10)
    # byte-valued rows: |q|^2 + |c|^2 reaches ~4e6, and the l2 expansion's
    # fp32 cancellation leaves each package a few ulps of it apart
    ulps = 4 * np.spacing(np.float32(
        (q * q).sum(1).max() + (corpus * corpus).sum(1).max()))
    for d, i in ((sd, si), (ld.numpy(), li.numpy())):
        np.testing.assert_array_equal(i, ji)
        np.testing.assert_allclose(d, jd, rtol=1e-5, atol=ulps)
        assert bt.recall(i, gt) == bt.recall(ji, gt)
    assert bt.recall(ji, gt) >= 0.99


# -- (c) the child protocol -----------------------------------------------------------


def test_child_lines_merge_skip_and_done():
    details = {}
    lines = ['{"m": {"a": 1}}', "not json", "", '{"m": {"b": [2]}}', "[1]",
             '{"skip": "Boom: x"}', '{"done": 1}']
    assert bt.read_child_lines(lines, details) == ("Boom: x", True)
    assert details == {"a": 1, "b": [2]}
    assert bt.read_child_lines(['{"m": {"c": 3}}'], details) == (None, False)
    assert not bt.record_child("s", details, None, False, -9, 1.0)
    assert "skip_s" in details and "rc=-9" in details["skip_s"]


def _in_process_runner(name, details, timeout_s, opts):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        bt.child_main(name, opts)
    skipped, done = bt.read_child_lines(out.getvalue().splitlines(), details)
    return bt.record_child(name, details, skipped, done, 0, 0.0)


def test_a_section_that_raises_leaves_its_marker_and_exit_3(
        monkeypatch, tmp_path, capsys):
    def boom(opts):
        bt.emit_merge({"flat1m_partial": 1})
        raise RuntimeError("boom")

    monkeypatch.setitem(bt.SECTIONS, "flat1m", boom)
    opts = bt.parse_args(["--quick", "--device", "cpu", "--n", "2048",
                          "--out", str(tmp_path)])
    assert bt.parent_main(opts, runner=_in_process_runner) == 3
    details = json.loads((tmp_path / "details.json").read_text())
    assert details["skip_flat1m"] == "RuntimeError: boom"
    assert details["flat1m_partial"] == 1  # merged before it died
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["value"] == 0.0 and line["skips"]["flat1m"].startswith(
        "RuntimeError")
    assert line["shortfall"] == "flat1m int8 did not land"


# -- (d) the last line ----------------------------------------------------------------


def _widest_details():
    w = 123456789.123456789
    rec = {"qps": w, "recall": 0.123456789}
    flat = {"recall": 0.999999, "launches": {"k1": 10 ** 9, "k2": 10 ** 9},
            "qps": {f"{r}/B={b}": rec for r in ("launch", "search_batch")
                    for b in (1024, 16384)}}
    return {
        "flat1m_int8": flat, "flat1m_bfloat16": flat,
        "big10m_scan": {"B=1024": rec, "B=16384": rec},
        "big10m_ivf": {f"probe={p}/B={b}": rec for p in (8, 16, 32)
                       for b in (1024, 16384)},
        "crossover": {str(n): {"scan": rec, "ivf_qps_at_recall99": w}
                      for n in (1_048_576, 2_097_152, 4_063_232)},
        "hnsw1m_build_s": w,
        "hnsw1m_walk": {f"B={b}/ef={e}": rec for b in (256, 1024)
                        for e in (10, 50, 100)},
        "cosine": rec,
        "shapes": {n: {"default": rec} for n in bt.SHAPES},
        "ivf100m_build": {"build_s": w},
        "ivf100m_sweep": {f"rescored/probe={p}": rec for p in (128, 256)},
        "text_ingest_docs_per_s": w, "text_term_qps_1core": w,
        "cpu_flat_qps_1core": w,
    }


def test_the_last_line_fits_at_its_widest():
    device = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3 " * 2,
              "count": 8, "power_limit": "700.00 W"}
    line = bt.result_line(_widest_details(), device, 2227.2,
                          "bench_torch_out/details.json")
    text = json.dumps(line)
    assert len(text) <= bt.LAST_LINE_MAX
    assert json.loads(text)["headlines"].keys() == {
        "flat1m", "big10m", "crossover", "hnsw1m", "cosine", "shapes",
        "ivf100m", "text", "cpu"}
    assert line["vs_baseline"] == round(line["value"] / 2227.2, 2)
    # every section skipped with a long reason and a fatal error: it still
    # fits and parses
    details = _widest_details()
    for name, _, _ in bt.PLAN:
        details[f"skip_{name}"] = "RuntimeError: " + "x" * 400
    details["fatal"] = "KeyboardInterrupt: " + "y" * 400
    text = json.dumps(bt.result_line(details, device, 2227.2, "d.json"))
    assert len(text) <= bt.LAST_LINE_MAX and json.loads(text)["skips"]


# -- (e) no fallback, (f) end to end --------------------------------------------------


def test_without_a_card_the_default_run_exits_before_any_section(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default run would use it")
    proc = subprocess.run(BENCH + ["--out", str(tmp_path)], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert "section" not in proc.stderr.replace("no section ran", "")
    assert proc.stdout.strip() == ""
    assert not (tmp_path / "details.json").exists()


def test_quick_on_the_cpu_end_to_end(tmp_path):
    proc = subprocess.run(
        BENCH + ["--quick", "--device", "cpu", "--n", "4096", "--out",
                 str(tmp_path)], cwd=REPO, capture_output=True, text=True,
        timeout=240)
    assert proc.returncode == 0, proc.stderr[-2000:]
    last = proc.stdout.strip().splitlines()[-1]
    assert len(last) <= bt.LAST_LINE_MAX
    line = json.loads(last)
    assert line["device"] == {"platform": "cpu", "kind": "cpu", "count": 1}
    assert "host CPU" in line["metric"] and line["value"] > 0
    assert set(line["headlines"]) == {"flat1m", "cpu"}
    details = json.loads((tmp_path / "details.json").read_text())
    assert not [k for k in details if k.startswith("skip_")]
    for dtype in ("int8", "bfloat16"):
        res = details[f"flat1m_{dtype}"]
        assert res["recall"] >= 0.99 and res["routes_equal_rows"] == 1.0
        assert res["latency"]["samples"] == 200
    assert details["reduced"]


# -- (g) the import scan --------------------------------------------------------------


def test_the_import_scan_covers_bench_torch():
    assert "bench_torch.py" in _port_files()
    assert not [n for n in _imported_names("bench_torch.py")
                if n.split(".")[0] in ("jax", "jaxlib", "valkey_search_tpu")]
