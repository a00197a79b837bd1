"""The control of ``correct``: the reference in TF32, in the program's place.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 --requests N \
        [--answers tf32|halved_scan]

For each seed it makes the cell's data as a run does, draws ``N`` requests as
the run's connections draw them (round robin over the connections, each from
its own seeded stream), answers each in the program's place and judges those
replies as a run judges the program's. ``tf32`` (the control) answers with
the reference's search computed in TF32 (reference.control_replies);
``halved_scan`` (a planted scan fault) answers with the exact search over the
even rows alone, as a scan that skips half of its buckets and rescores what
it found exactly would. It prints one JSON line a seed with the numbers
compared and the cell's limits: each has to fail at least one of them. The
benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import datagen, reference, spec  # noqa: E402
from benchmark.loadgen import draw  # noqa: E402


def requests_of(traffic: dict, pool_n: int, seed: int, n: int) -> list:
    """``n`` requests in the clients' record form, as the connections of a
    run draw them."""
    conns = int(traffic["processes"]) * int(traffic["connections_per_process"])
    streams = [draw(seed, c, pool_n, traffic["filter"]) for c in range(conns)]
    out = []
    for c in itertools.islice(itertools.cycle(range(conns)), n):
        qi, j = next(streams[c])
        out.append([c, qi, j, 0.0, 0.0, None, None])
    return out


def halved_scan_replies(corpus, pool, config: dict, fields, flt, k: int,
                        requests) -> list:
    """Each request answered exactly over the even rows that its filter
    admits, in the clients' record form."""
    import torch

    groups: dict = {}
    for r in requests:
        groups.setdefault(r[2], set()).add(r[1])
    answers = {}
    for j, qset in groups.items():
        rows = reference.admitted_rows(config, fields, flt, j)
        if rows is None:
            rows = np.arange(corpus.shape[0])
        rows = torch.as_tensor(rows[rows % 2 == 0], device=corpus.device)
        qlist = sorted(qset)
        d, i = reference.topk(corpus, pool[qlist], k, config["metric"], rows)
        for n, qi in enumerate(qlist):
            answers[(qi, j)] = (d[n], i[n])
    return [r[:5] + [answers[(r[1], r[2])][1].tolist(),
                     answers[(r[1], r[2])][0].tolist()] for r in requests]


ANSWERS = {"tf32": reference.control_replies,
           "halved_scan": halved_scan_replies}


def control_numbers(cell: spec.Cell, seed: int, n_requests: int, dev,
                    answers: str = "tf32") -> dict:
    import torch

    cfg, traffic = cell.config, cell.traffic
    data = datagen.make(cfg, traffic, seed, dev)
    reqs = requests_of(traffic, len(data.pool), seed, n_requests)
    corpus = torch.from_numpy(data.corpus).to(dev)
    replies = ANSWERS[answers](corpus, data.pool, cfg, data.fields,
                              traffic["filter"], int(traffic["k"]), reqs)
    numbers, _ = reference.judge(corpus, data.pool, cfg, data.fields,
                                 traffic["filter"], int(traffic["k"]),
                                 replies)
    return numbers


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--requests", type=int, required=True)
    ap.add_argument("--answers", choices=sorted(ANSWERS), default="tf32")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import torch

    dev = torch.device(args.device)
    cell = spec.cell(args.workload)
    limits = cell.config.get("limits", {})
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.monotonic()
        numbers = control_numbers(cell, seed, args.requests, dev,
                                  args.answers)
        failed = [n for n, v in numbers.items() if v > limits.get(n, 0)]
        print(json.dumps({"workload": cell.name, "answers": args.answers,
                          "seed": seed,
                          "numbers": numbers, "limits": limits,
                          "fails": failed,
                          "seconds": time.monotonic() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
