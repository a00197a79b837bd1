"""A cell's data from ``--seed``: the corpus, the query pool and the fields.

One general generator reads the recipes that a configuration file names:

- ``sift_like``: bench_torch.py's SIFT-like recipe (``gen_corpus_and_queries``,
  ``sift_rows``): ``centers`` cluster centres of N(0, 1) * ``center_scale`` +
  ``center_offset``, a uniform centre a row, N(0, ``noise``^2) noise, clipped
  to ``clip``;
- ``clustered_unit``: bench_torch.py's ``gen_cosine`` at the configuration's
  width: ``centers`` N(0, 1) centres, N(0, ``noise``^2) noise, each row
  normalised to unit length.

The queries of the pool follow the corpus's recipe with the same centres.
Vectors are made on the device by one ``torch.Generator`` in large chunks and
copied to the host, where HSET and the reference read them. Fields come from a
NumPy generator of their own: ``uniform_tag`` (``prefix`` + a uniform integer
below ``values``), ``uniform_int`` (uniform in [``low``, ``high``)) and
``row_number``. Every seed gives the same sizes; only the values differ.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np

CHUNK = 1 << 18


class Data(NamedTuple):
    corpus: np.ndarray  # [rows, dim] float32, as HSET sends it
    pool: np.ndarray  # [pool, dim] float32
    fields: Dict[str, np.ndarray]  # name -> per-row values (int64)


def _seed64(seed: int, stream: int) -> int:
    return (int(seed) * 0x9E3779B97F4A7C15 + stream) % (1 << 63)


def _rows(torch, gen, centers, m: int, recipe: dict, dev):
    a = torch.randint(0, centers.shape[0], (m,), generator=gen, device=dev)
    x = centers[a] + torch.randn((m, centers.shape[1]), generator=gen,
                                 device=dev) * float(recipe["noise"])
    kind = recipe["recipe"]
    if kind == "sift_like":
        lo, hi = recipe["clip"]
        return x.clamp_(float(lo), float(hi))
    if kind == "clustered_unit":
        return x / x.norm(dim=1, keepdim=True).clamp_min(1e-30)
    raise ValueError(f"unknown vector recipe {kind!r}")


def _centers(torch, gen, recipe: dict, dim: int, dev):
    c = torch.randn((int(recipe["centers"]), dim), generator=gen, device=dev)
    if recipe["recipe"] == "sift_like":
        c = c * float(recipe["center_scale"]) + float(recipe["center_offset"])
    return c


def vectors(config: dict, n_pool: int, seed: int, dev):
    """(corpus [rows, dim], pool [n_pool, dim]) as float32 host arrays."""
    import torch

    recipe = config["vectors"]
    rows, dim = int(config["rows"]), int(config["dim"])
    gen = torch.Generator(device=dev).manual_seed(_seed64(seed, 0))
    centers = _centers(torch, gen, recipe, dim, dev)
    corpus = np.empty((rows, dim), np.float32)
    for s in range(0, rows, CHUNK):
        m = min(CHUNK, rows - s)
        corpus[s:s + m] = _rows(torch, gen, centers, m, recipe, dev).cpu().numpy()
    pool = _rows(torch, gen, centers, n_pool, recipe, dev).cpu().numpy()
    return corpus, np.ascontiguousarray(pool, np.float32)


def fields(config: dict, seed: int) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng([int(seed) % (1 << 63), 1])
    rows = int(config["rows"])
    out = {}
    for f in config.get("fields", []):
        kind = f["recipe"]
        if kind == "uniform_tag":
            out[f["name"]] = rng.integers(0, int(f["values"]), rows)
        elif kind == "uniform_int":
            out[f["name"]] = rng.integers(int(f["low"]), int(f["high"]), rows)
        elif kind == "row_number":
            out[f["name"]] = np.arange(rows, dtype=np.int64)
        else:
            raise ValueError(f"unknown field recipe {kind!r}")
    return out


def field_text(config: dict, name: str, values: np.ndarray) -> np.ndarray:
    """The strings that HSET writes for field ``name``."""
    spec = next(f for f in config["fields"] if f["name"] == name)
    text = values.astype(str)
    if spec["recipe"] == "uniform_tag":
        text = np.char.add(spec["prefix"], text)
    return text


def make(config: dict, traffic: dict, seed: int, dev) -> Data:
    corpus, pool = vectors(config, int(traffic["pool"]), seed, dev)
    return Data(corpus, pool, fields(config, seed))
