"""One traced run of a cell, then where its time went by the program's spans.

    python3 benchmark/span_split.py --workload <cell> --seed <n> \
        --seconds <s> [--every 1]

Runs ``benchmark/run.py`` with ``--trace 1`` in this process (its result
line comes first on standard output), then prints one more JSON line: for
each of the program's span names, its mean milliseconds a request (request
spans) or a launch (``flat.*`` and ``topk.*``) in the window, with the
counts of requests and launches (``program_spans.split``). The program
traces one command in ``--every`` (its ``TRACE.every``; 1, every command,
by default here, so that the means are over the requests the benchmark's
outside spans time). The benchmark's own runs never call this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from benchmark import program_spans, run  # noqa: E402


def main(argv=None) -> int:
    from valkey_search_tpu_torch.runtime.metrics import TRACE

    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--every", type=int, default=1)
    ours, rest = ap.parse_known_args(sys.argv[1:] if argv is None else argv)
    TRACE.every = ours.every
    runs = []
    result = run.result

    def keep(cell, r, *args, **kwargs):
        runs.append(r)
        return result(cell, r, *args, **kwargs)

    run.result = keep
    rc = run.main(rest + ["--trace", "1"])
    if rc == 0 and runs:
        print(json.dumps({"split": program_spans.split(runs[0])}))
    return rc


if __name__ == "__main__":
    sys.exit(main())
