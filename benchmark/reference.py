"""The plain reference: exact top k in float64, and the judgement of replies.

Plain PyTorch and NumPy. It imports nothing of the program under test and
reads nothing that the program made: it works from the corpus, the query pool
and the fields that datagen.py made and handed to both sides, and from the
keys and scores that the clients read off the wire.

``topk`` is the exact top k of queries over the rows a filter admits, in
float64 (``precision="fp64"``), in blocks of queries and of rows on the given
device. With ``precision="tf32"`` it is the control: the same search with its
products taken in TF32, the precision below the configuration's float32 with
TF32 off (each operand rounded to TF32's 10 stored mantissa bits, the product
summed in float32), and its own distances as the reply's scores.

``judge`` holds every reply against the reference and returns the numbers
that decide ``correct``:

- ``dist_err``: the widest gap between a reply's score and the float64
  distance of its key to its query, over the scale of the distance's terms
  (||q||^2 + ||c||^2 under L2, 1 under COSINE);
- ``failed``: requests that got an error or no reply;
- ``outside``: keys that are no row, or a row the request's filter excludes;
- ``short``: replies with fewer keys than min(k, rows admitted);
- ``dup``: replies that hold a key twice;
- ``unsorted``: replies whose scores are not in ascending order;
- ``recall_miss``: 1 - the mean recall at k of the replies against the exact
  top k, so that a scan that picks the wrong candidates and rescores them
  exactly fails too.

It also gives each reply's recall at k.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

Q_BLOCK = 1024
C_BLOCK = 1 << 17
PAIR_BLOCK = 1 << 16


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 stored mantissa bits), nearest even."""
    i = x.contiguous().view(torch.int32)
    i = (i + 0xFFF + ((i >> 13) & 1)) & -0x2000
    return i.view(torch.float32)


def _prep(x: torch.Tensor, metric: str, precision: str) -> torch.Tensor:
    x = x.to(torch.float64 if precision == "fp64" else torch.float32)
    if metric == "COSINE":
        x = x / x.norm(dim=1, keepdim=True).clamp_min(1e-30)
    return x


def _scores(q: torch.Tensor, c: torch.Tensor, metric: str,
            precision: str) -> torch.Tensor:
    """[nq, nc] distances of prepared rows (l2 squared, or 1 - cosine)."""
    if precision == "fp64":
        dots = q @ c.T
    else:
        dots = tf32_round(q) @ tf32_round(c).T
    if metric == "L2":
        return (q * q).sum(1)[:, None] + (c * c).sum(1)[None, :] - 2.0 * dots
    return 1.0 - dots


def topk(corpus: torch.Tensor, queries: np.ndarray, k: int, metric: str,
         rows: Optional[torch.Tensor] = None, precision: str = "fp64"
         ) -> Tuple[np.ndarray, np.ndarray]:
    """Top ``k`` (ascending distance) of ``queries`` over ``corpus`` [n, d]
    (float32 on the device the work runs on), among ``rows`` (int64 row
    numbers) when given: (distances [nq, k'], row numbers [nq, k']) with
    k' = min(k, rows)."""
    dev = corpus.device
    n = corpus.shape[0] if rows is None else rows.shape[0]
    kk = min(k, n)
    out_d, out_i = [], []
    for q0 in range(0, len(queries), Q_BLOCK):
        q = _prep(torch.as_tensor(queries[q0:q0 + Q_BLOCK], device=dev),
                  metric, precision)
        best_d = best_i = None
        for c0 in range(0, n, C_BLOCK):
            if rows is None:
                ids = torch.arange(c0, min(n, c0 + C_BLOCK), device=dev)
            else:
                ids = rows[c0:c0 + C_BLOCK]
            s = _scores(q, _prep(corpus[ids], metric, precision), metric,
                        precision)
            d, pos = torch.topk(s, min(kk, s.shape[1]), largest=False)
            i = ids[pos]
            if best_d is not None:
                d, pos = torch.topk(torch.cat([best_d, d], 1), kk,
                                    largest=False)
                i = torch.cat([best_i, i], 1).gather(1, pos)
            best_d, best_i = d, i
        out_d.append(best_d.double().cpu().numpy())
        out_i.append(best_i.cpu().numpy())
    if not out_d:
        return np.zeros((0, kk)), np.zeros((0, kk), np.int64)
    return np.concatenate(out_d), np.concatenate(out_i)


def pair_errors(corpus: torch.Tensor, pool: np.ndarray, qidx: np.ndarray,
                keys: np.ndarray, scores: np.ndarray, metric: str
                ) -> np.ndarray:
    """|score - exact distance| / scale of each (query, key, score), the
    exact distance taken in float64 from the rows themselves."""
    dev = corpus.device
    out = np.empty(len(keys), np.float64)
    pool_t = torch.as_tensor(pool, device=dev)
    for s0 in range(0, len(keys), PAIR_BLOCK):
        sl = slice(s0, s0 + PAIR_BLOCK)
        q = pool_t[torch.as_tensor(qidx[sl], device=dev)].double()
        c = corpus[torch.as_tensor(keys[sl], device=dev)].double()
        if metric == "L2":
            exact = ((q - c) ** 2).sum(1)
            scale = (q * q).sum(1) + (c * c).sum(1)
        else:
            exact = 1.0 - (q * c).sum(1) / (q.norm(dim=1) * c.norm(dim=1))
            scale = torch.ones_like(exact)
        got = torch.as_tensor(scores[sl], device=dev, dtype=torch.float64)
        out[sl] = ((got - exact).abs() / scale).cpu().numpy()
    return out


def admitted_rows(config: dict, fields: Dict[str, np.ndarray], flt,
                  j: int) -> Optional[np.ndarray]:
    """Row numbers the traffic's filter admits at value ``j`` (None: all)."""
    if not flt:
        return None
    values = fields[flt["field"]]
    if flt["kind"] == "tag":
        spec = next(f for f in config["fields"] if f["name"] == flt["field"])
        want = flt["value"].replace("<j>", str(j))
        prefix = spec.get("prefix", "")
        if not want.startswith(prefix) or not want[len(prefix):].isdigit():
            return np.zeros(0, np.int64)
        return np.flatnonzero(values == int(want[len(prefix):]))
    lo = float(flt["min"]) if str(flt["min"]) not in ("-inf",) else -np.inf
    hi = float(flt["max"]) if str(flt["max"]) not in ("+inf", "inf") else np.inf
    return np.flatnonzero((values >= lo) & (values <= hi))


def exact_answers(corpus: torch.Tensor, pool: np.ndarray, config: dict,
                  fields, flt, k: int, requests, precision: str = "fp64"):
    """{(query, j): (distances, rows)} of every distinct request, and the
    admitted row count of each j."""
    groups: Dict[int, set] = {}
    for r in requests:
        groups.setdefault(r[2], set()).add(r[1])
    answers, admitted = {}, {}
    for j, qset in groups.items():
        rows = admitted_rows(config, fields, flt, j)
        admitted[j] = corpus.shape[0] if rows is None else len(rows)
        qlist = sorted(qset)
        rows_t = (None if rows is None
                  else torch.as_tensor(rows, device=corpus.device))
        if admitted[j] == 0:
            d = np.zeros((len(qlist), 0))
            i = np.zeros((len(qlist), 0), np.int64)
        else:
            d, i = topk(corpus, pool[qlist], k, config["metric"], rows_t,
                        precision)
        for n, qi in enumerate(qlist):
            answers[(qi, j)] = (d[n], i[n])
    return answers, admitted


def control_replies(corpus: torch.Tensor, pool: np.ndarray, config: dict,
                    fields, flt, k: int, requests) -> List[list]:
    """The control in the program's place: each request answered by the
    TF32 search, in the clients' record form."""
    answers, _ = exact_answers(corpus, pool, config, fields, flt, k,
                               requests, precision="tf32")
    out = []
    for r in requests:
        d, i = answers[(r[1], r[2])]
        out.append(r[:5] + [i.tolist(), d.tolist()])
    return out


def judge(corpus: torch.Tensor, pool: np.ndarray, config: dict, fields, flt,
          k: int, requests) -> Tuple[Dict[str, float], np.ndarray]:
    """(the numbers compared, each request's recall at k) of ``requests``:
    client records ``[conn, query, j, t_send, t_recv, keys, scores]``."""
    ok = [r for r in requests if r[5] is not None]
    answers, admitted = exact_answers(corpus, pool, config, fields, flt, k,
                                      ok)
    n_rows = corpus.shape[0]
    allowed = {}
    if flt:
        for j in admitted:
            mask = np.zeros(n_rows, bool)
            mask[admitted_rows(config, fields, flt, j)] = True
            allowed[j] = mask
    out = {"dist_err": 0.0, "failed": len(requests) - len(ok), "outside": 0,
           "short": 0, "dup": 0, "unsorted": 0, "recall_miss": 0.0}
    recall = np.full(len(requests), np.nan)
    pq, pk, ps = [], [], []
    for n, r in enumerate(requests):
        if r[5] is None:
            continue
        qi, j, keys, scores = r[1], r[2], r[5], r[6]
        _, exact_ids = answers[(qi, j)]
        want = min(k, admitted[j])
        if len(keys) < want:
            out["short"] += 1
        if len(set(keys)) < len(keys):
            out["dup"] += 1
        if any(a > b for a, b in zip(scores, scores[1:])):
            out["unsorted"] += 1
        mask = allowed.get(j)
        for key, score in zip(keys, scores):
            if not 0 <= key < n_rows or (mask is not None and not mask[key]):
                out["outside"] += 1
            else:
                pq.append(qi)
                pk.append(key)
                ps.append(score)
        if want:
            recall[n] = len(set(keys[:k]) & set(exact_ids.tolist())) / want
    if pk:
        err = pair_errors(corpus, pool, np.asarray(pq), np.asarray(pk),
                          np.asarray(ps, np.float64), config["metric"])
        out["dist_err"] = float(err.max())
    if not np.isnan(recall).all():
        out["recall_miss"] = float(1.0 - np.nanmean(recall))
    return out, recall
