"""One run of one cell of BENCHMARK.json.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

In this process: make the cell's data from the seed, start the program's
``Engine`` and ``RespServer(engine, port=0)``, HSET every row through
``Engine.execute`` and then ``FT.CREATE`` the index (its backfill indexes
the rows), publish it and warm every filter value. Then start the load
processes (benchmark/loadgen.py, outside this process), let every connection
get replies, and measure for ``--seconds``. After the window: stop the
load, read the device's memory peak, free the program's state, and hold
every reply against the plain reference (benchmark/reference.py).

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics, from the benchmark's spans and a
device trace of a few seconds at the end of the window), ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``: each number compared
beside its limit, also printed as the last lines of standard error.

The server's process and the load processes run on disjoint sets of the
CPUs the run may use (a quarter, one at least, for the load), so that the
load does not take the server's cores.

Exits 2 without a result when there is no CUDA device or fewer than the
cell asks for, and 3 when the process holds a module of JAX or of the JAX
package once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402
from typing import Dict, List, Optional, Tuple  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)

# every build and kernel cache stays in fixed directories of the checkout
for _var, _dir in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TRITON_CACHE_DIR", "triton_cache"),
                   ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[_var] = os.path.join(ROOT, "build", _dir)
# CUPTI is detached after every profiler session and attached anew for the
# next: left attached between sessions (TEARDOWN_CUPTI unset or 0), it came
# back from later slices with the copies and none of the kernels
os.environ["TEARDOWN_CUPTI"] = "1"

import numpy as np  # noqa: E402

from benchmark import datagen, reference, spec, tracing  # noqa: E402
from benchmark.record import Run  # noqa: E402

FOREIGN = ("jax", "jaxlib", "flax", "valkey_search_tpu")
COUNTERS = ("batched_queries", "query_batches_coalesced")
TRACE_SLICE_S = 3.0
TRACE_TRIES = 3  # slices at most, the last ending at the window's close
CLIENT_START_S = 300.0
DRAIN_S = 60.0
LOAD_CPU_SHARE = 4  # one CPU in this many goes to the load processes


def log(msg: str) -> None:
    print(f"[{time.monotonic() - T_START:8.2f}s] {msg}", file=sys.stderr,
          flush=True)


def foreign_modules() -> List[str]:
    """Top-level names of JAX and the JAX package among sys.modules."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FOREIGN))


def cpu_sets() -> Tuple[List[int], List[int]]:
    """(the server's CPUs, the load's CPUs): disjoint sets of the CPUs this
    process may use, the load's a quarter of them (one at least); with one
    CPU both share it."""
    cpus = sorted(os.sched_getaffinity(0))
    n_load = max(1, len(cpus) // LOAD_CPU_SHARE)
    if len(cpus) <= n_load:
        return cpus, cpus
    return cpus[:-n_load], cpus[-n_load:]


def pin_process(cpus: List[int]) -> None:
    """Every thread of this process onto ``cpus``; the threads it starts
    later inherit the set."""
    for tid in os.listdir("/proc/self/task"):
        try:
            os.sched_setaffinity(int(tid), cpus)
        except OSError:  # a thread that has ended since
            pass


def host_load() -> str:
    return (f"{os.cpu_count()} CPUs, load average "
            + " ".join(f"{x:.2f}" for x in os.getloadavg()))


class Clients:
    """The load processes and the threads that read their output."""

    def __init__(self, port: int, cfg: dict, traffic: dict, pool: np.ndarray,
                 seed: int, cpus: Optional[List[int]] = None):
        n_proc = int(traffic["processes"])
        per = int(traffic["connections_per_process"])
        self.procs: List[subprocess.Popen] = []
        self.warm = [threading.Event() for _ in range(n_proc)]
        self.out: List[Optional[dict]] = [None] * n_proc
        self.readers = []
        hdr = {"port": port, "index": cfg["index"],
               "vector_field": cfg["vector_field"], "k": int(traffic["k"]),
               "key_prefix": cfg["key_prefix"], "filter": traffic["filter"],
               "seed": int(seed), "pool_n": int(pool.shape[0]),
               "dim": int(pool.shape[1]),
               "warmup": int(traffic["warmup_replies_per_connection"]),
               "drain_s": DRAIN_S, "cpus": cpus}
        blob = np.ascontiguousarray(pool, "<f4").tobytes()
        for p in range(n_proc):
            proc = subprocess.Popen(
                [sys.executable, os.path.join(HERE, "loadgen.py")],
                stdin=subprocess.PIPE, stdout=subprocess.PIPE, cwd=ROOT)
            self.procs.append(proc)
            head = dict(hdr, conn_ids=list(range(p * per, (p + 1) * per)))
            proc.stdin.write(json.dumps(head).encode() + b"\n" + blob)
            proc.stdin.flush()
            t = threading.Thread(target=self._read, args=(p,), daemon=True)
            t.start()
            self.readers.append(t)

    def _read(self, p: int) -> None:
        out = self.procs[p].stdout
        for line in out:
            if line.strip() == b"warm":
                self.warm[p].set()
            elif line.startswith(b"{"):
                self.out[p] = json.loads(line)
        self.warm[p].set()  # ended: wait no longer

    def wait_warm(self, timeout: float) -> None:
        deadline = time.monotonic() + timeout
        for p, ev in enumerate(self.warm):
            if not ev.wait(max(0.0, deadline - time.monotonic())):
                raise RuntimeError(f"load process {p} never got its replies")
            if self.procs[p].poll() is not None:
                raise RuntimeError(f"load process {p} ended during warm-up "
                                   f"(exit {self.procs[p].returncode})")

    def stop(self) -> List[list]:
        """Stop every connection and return every request's record."""
        for proc in self.procs:
            try:
                proc.stdin.write(b"stop\n")
                proc.stdin.close()
            except OSError:
                pass
        records = []
        try:
            for p, (proc, t) in enumerate(zip(self.procs, self.readers)):
                t.join(DRAIN_S + 30)
                proc.wait(30)
                if self.out[p] is None:
                    raise RuntimeError(f"load process {p} returned no "
                                       f"records (exit {proc.returncode})")
                records += self.out[p]["records"]
        finally:
            self.kill()
        return records

    def kill(self) -> None:
        for proc in self.procs:
            if proc.poll() is None:
                proc.kill()
            proc.wait()


def load(engine, cfg: dict, data: datagen.Data) -> Dict[str, float]:
    """HSET every row, then FT.CREATE (its backfill indexes the rows)."""
    t0 = time.monotonic()
    names = [f["name"] for f in cfg.get("fields", [])]
    texts = [datagen.field_text(cfg, n, data.fields[n]).tolist()
             for n in names]
    prefix, vf = cfg["key_prefix"], cfg["vector_field"]
    execute = engine.execute
    corpus = data.corpus
    for i in range(corpus.shape[0]):
        argv = ["HSET", f"{prefix}{i}", vf, corpus[i].tobytes()]
        for n, t in zip(names, texts):
            argv += [n, t[i]]
        execute(*argv)
    t1 = time.monotonic()
    execute("FT.CREATE", cfg["index"], *cfg["ft_create"])
    t2 = time.monotonic()
    return {"hset_s": t1 - t0, "ft_create_s": t2 - t1}


def search_argv(cfg: dict, traffic: dict, q: np.ndarray, j: int) -> list:
    from benchmark.loadgen import filter_clause

    vf, k = cfg["vector_field"], int(traffic["k"])
    return ["FT.SEARCH", cfg["index"],
            filter_clause(traffic["filter"], j) + f"=>[KNN {k} @{vf} $q]",
            "PARAMS", "2", "q", np.asarray(q, "<f4").tobytes(),
            "RETURN", "1", f"__{vf}_score", "LIMIT", "0", str(k)]


def publish(engine, cfg: dict, traffic: dict,
            pool: np.ndarray) -> Dict[str, float]:
    """The first search publishes the store and loads the kernels; then one
    search for every filter value, so that each filter's mask is built."""
    t0 = time.monotonic()
    engine.execute(*search_argv(cfg, traffic, pool[0], 0))
    t1 = time.monotonic()
    flt = traffic["filter"]
    if flt and "j" in flt:
        lo, hi = flt["j"]
        for j in range(lo, hi):
            engine.execute(*search_argv(cfg, traffic, pool[j % len(pool)], j))
    return {"first_search_s": t1 - t0, "filters_s": time.monotonic() - t1}


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: Optional[float] = None,
             load_cpus: Optional[List[int]] = None) -> dict:
    """One run; returns the result line's object. ``load_cpus``: the CPUs
    the load processes are pinned to (None: not pinned)."""
    import torch

    from valkey_search_tpu_torch.runtime.device import set_device
    from valkey_search_tpu_torch.runtime.metrics import STATS
    from valkey_search_tpu_torch.server.engine import Engine
    from valkey_search_tpu_torch.server.resp import RespServer

    t_start = T_START if t_start is None else t_start
    cfg, traffic = cell.config, cell.traffic
    dev = set_device(device)
    on_card = dev.type == "cuda"
    stages = {}
    t = time.monotonic()
    data = datagen.make(cfg, traffic, seed, dev)
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    stages["data_s"] = time.monotonic() - t

    engine = Engine()
    srv = RespServer(engine, port=0).start()
    spans = tracing.Spans() if trace else None
    clients = None
    try:
        for name, value in cfg.get("options", {}).items():
            engine.config_set(name, str(value))
            log(f"option {name} = {engine.config_get(name)!r}")
        t = time.monotonic()
        stages.update(load(engine, cfg, data))
        stages["load_s"] = time.monotonic() - t
        if spans is not None:
            spans.install()
        t = time.monotonic()
        stages.update(publish(engine, cfg, traffic, data.pool))
        if on_card:
            torch.cuda.synchronize()
            if trace:
                tracing.warm_profiler(torch)
        stages["publish_s"] = time.monotonic() - t
        gc.collect()  # every window starts from the same collector state
        t = time.monotonic()
        clients = Clients(srv.port, cfg, traffic, data.pool, seed, load_cpus)
        clients.wait_warm(CLIENT_START_S)
        time.sleep(max(0.0, float(traffic["warmup_min_s"])
                       - (time.monotonic() - t)))
        stages["warm_s"] = time.monotonic() - t

        t0 = time.monotonic()
        setup_s = t0 - t_start
        log("setup " + ", ".join(f"{k} {v:.3f}" for k, v in stages.items())
            + f"; setup_s {setup_s:.3f}; window opens: {host_load()}")
        c0 = {n: STATS.get(n) for n in COUNTERS}
        gc0 = [g["collections"] for g in gc.get_stats()]
        t1 = t0 + seconds
        device_slice = None
        if trace and on_card:
            slice_s = min(TRACE_SLICE_S, seconds / (2 * TRACE_TRIES))
            time.sleep(max(0.0, t1 - TRACE_TRIES * slice_s - time.monotonic()))
            while True:
                device_slice = tracing.device_slice(
                    torch, min(slice_s, max(0.0, t1 - time.monotonic())))
                if (tracing.has_kernels(device_slice)
                        or t1 - time.monotonic() < slice_s):
                    break
                log("the profiler's slice holds no kernel: another slice")
        time.sleep(max(0.0, t1 - time.monotonic()))
        c1 = {n: STATS.get(n) for n in COUNTERS}
        gc1 = [g["collections"] for g in gc.get_stats()]
        log(f"window closes: {host_load()}")
        records = clients.stop()
        clients = None
        peak = torch.cuda.max_memory_allocated() if on_card else 0
    finally:
        if spans is not None:
            spans.uninstall()
        if clients is not None:
            clients.kill()
        srv.close()
    del engine, srv
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    # the reference, once the window has closed and the program is freed
    t = time.monotonic()
    judged = [r for r in records if r[4] is None or r[4] >= t0]
    corpus = torch.from_numpy(data.corpus).to(dev)
    numbers, recall = reference.judge(corpus, data.pool, cfg, data.fields,
                                      traffic["filter"], int(traffic["k"]),
                                      judged)
    del corpus
    log(f"reference {time.monotonic() - t:.3f} s over {len(judged)} "
        "requests")
    log(f"collections in the window by generation "
        f"{[b - a for a, b in zip(gc0, gc1)]}; {per_second(judged, t0, t1)}")
    run = Run(cfg, traffic, t0, t1, setup_s, judged, recall, spans,
              device_slice, torch.cuda.get_device_name(0) if on_card else "",
              {"start": c0, "end": c1})
    return result(cell, run, numbers, trace, on_card, peak)


def per_second(records: List[list], t0: float, t1: float) -> str:
    """Replies and their 95th percentile latency in each second of the
    window, to see how steady a run was."""
    done = np.asarray([(r[4], r[4] - r[3]) for r in records
                       if r[5] is not None and t0 <= r[4] < t1]).reshape(-1, 2)
    sec = ((done[:, 0] - t0) // 1).astype(int)
    rows = []
    for s in range(int(t1 - t0)):
        lat = done[sec == s, 1]
        rows.append(f"{lat.size}/{np.percentile(lat, 95) * 1e3:.0f}"
                    if lat.size else "0/-")
    lat = done[:, 1] * 1e3 if done.size else np.zeros(1)
    return (f"window p50_ms {np.percentile(lat, 50):.4f} p95_ms "
            f"{np.percentile(lat, 95):.4f}; replies/p95_ms a second: "
            + " ".join(rows))


def result(cell: spec.Cell, run: Run, numbers: Dict[str, float],
           trace: bool, on_card: bool, peak: int) -> dict:
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in cell.metrics:
        if m.kind != kind:
            continue
        value = m.read(run)
        if value is not None:
            metrics[m.name] = {"value": float(value), "unit": m.unit}
    limits = dict.fromkeys(numbers, 0)
    limits.update(cell.config.get("limits", {}))
    checks = {n: {"value": numbers[n], "limit": limits[n]} for n in numbers}
    answered = len(run.answered())
    correct = answered > 0 and all(c["value"] <= c["limit"]
                                   for c in checks.values())
    device = {"platform": "gpu" if on_card else "cpu",
              "kind": run.device_kind, "count": cell.chips if on_card else 0,
              "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": len(run.requests),
           "failed": int(numbers["failed"]), "metrics": metrics,
           "device": device}
    if trace and run.device_slice is not None:
        sl = run.device_slice
        device["busy_s"] = tracing.busy_seconds(sl)
        device["window_s"] = sl.end - sl.start
        out["breakdown"] = tracing.breakdown(sl, run.spans)
        c0, c1 = run.counters["start"], run.counters["end"]
        rows = sum(s.rows for s in run.search_batch_spans())
        log(f"cross-check: search_batch rows in the window {rows}, "
            f"batched_queries {c1['batched_queries'] - c0['batched_queries']}"
            f", launches {len(run.search_batch_spans())}, coalesced batches "
            f"{c1['query_batches_coalesced'] - c0['query_batches_coalesced']}"
            f"; marker found {sl.aligned}")
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = spec.cell(args.workload)

    import torch

    if not torch.cuda.is_available():
        log("no CUDA device: torch.cuda.is_available() is False")
        return 2
    if torch.cuda.device_count() < cell.chips:
        log(f"{cell.name} needs {cell.chips} CUDA devices, "
            f"{torch.cuda.device_count()} present")
        return 2
    server_cpus, load_cpus = cpu_sets()
    pin_process(server_cpus)
    log(f"server on CPUs {server_cpus}, load on {load_cpus}; {host_load()}")
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                   load_cpus=load_cpus)
    foreign = foreign_modules()
    if foreign:
        log(f"the process holds {foreign} after the window: no result")
        return 3
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
