"""The least time a KNN launch needs, from its shapes and the chip's peaks.

A ``search_batch`` call of B queries over the R rows its filter admits, at
width d and k outputs a query, has to read each admitted row once in the
element size of the configuration's ``search.corpus-dtype`` (int8 1 byte,
bfloat16 2, float32 4) and its float32 norm, read the queries in float32 and
write k float32 distances and k int64 ids a query; and it has to compute
2 * B * R * d operations at the peak of that type. Its least time is the
larger of the bytes over the memory bandwidth and the operations over the
peak rate. The count reads the shapes only, so it stays the same work
whatever kernels implement it.
"""

from __future__ import annotations

import json
import os
from typing import Optional

ELEMENT_BYTES = {"int8": 1, "bfloat16": 2, "float32": 4}


def peaks(kind: str) -> Optional[dict]:
    """The peak table's entry for the device named ``kind``."""
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "peaks.json")) as f:
        return json.load(f)["devices"].get(kind)


def corpus_dtype(config: dict) -> str:
    """The configuration's ``search.corpus-dtype``: every configuration states
    the precision its corpus is served in."""
    return config["options"]["search.corpus-dtype"]


def launch_bytes(batch: int, rows: int, dim: int, k: int, dtype: str) -> int:
    return (rows * (dim * ELEMENT_BYTES[dtype] + 4) + batch * dim * 4
            + batch * k * (4 + 8))


def launch_ops(batch: int, rows: int, dim: int) -> int:
    return 2 * batch * rows * dim


def least_seconds(batch: int, rows: int, dim: int, k: int, dtype: str,
                  peak: dict) -> float:
    return max(launch_bytes(batch, rows, dim, k, dtype)
               / peak["hbm_bytes_per_s"],
               launch_ops(batch, rows, dim) / peak["ops_per_s"][dtype])
