"""CUDA graphs of the fused KNN launch (ops/topk.py ``flat_topk_fused``).

An unfiltered fused launch is some fifty small torch operations around one
K1b or K2 scan: the queries quantized or scaled, the bias over every row,
the scan, the survivor top-k and its decode, the fp32 rescore. At B = 1 over
1M rows the device needs about 0.2 ms for them, and the host several times
that to dispatch them one by one. ``FusedGraphs`` captures such a launch
once per shape as a CUDA graph and replays it: a launch then copies its
queries in, replays the graph and copies the results out. The replay runs
the operations the eager launch enqueues, in the same order, on the same
shapes, so its answers are the eager launch's bit for bit.

What takes a graph (``takes_graph``): an unfiltered launch on a CUDA corpus
of 1 to ``GRAPH_MAX_B`` queries that ``use_fused_scan`` sends to the fused
scan. A filtered launch, a larger batch and a CPU corpus stay eager. The key
(``graph_key``) is all that shapes the launch's work: B, k, the metric and
the ``FusedPlan`` (mirror, span, coarse factor, rows, block split). Each B
is captured as it is: padding B to fewer shapes would change the shapes of
the rescore's batched product and reductions, whose results may then differ
in the last bit from the eager launch at the real B.

A graph reads the device snapshot it was captured from by address. So the
graphs of an index belong to one published snapshot, named by its store and
the store's epoch; a launch on a newer snapshot drops them all, with their
memory pools, and captures again; a launch that still holds an older
snapshot runs eagerly. A graph holds no reference to the snapshot's tensors:
the launch that replays it holds its snapshot. At most ``GRAPH_CACHE_SIZE``
graphs are kept, the least recently replayed dropped first.

A capture runs the launch eagerly once on a side stream (the warm-up; its
answer is the launch's), then captures the same calls on that stream with
``capture_error_mode="thread_local"``, so that other threads' uploads cannot
break it. One capture runs at a time in the process. A graph's static
buffers are its own: a lock holds them from the copy-in to the copy-out.

``STATS`` counts ``flat_graph_captures`` and ``flat_graph_replays``. Inside a
traced launch (runtime/metrics.py ``CTX.launch``) a capture records
``topk.capture`` (the warm-up's enqueue and the capture) and a replay
``topk.replay`` (the copy-in and the replay's enqueue); neither records the
eager launch's ``topk.*`` spans.
"""

from __future__ import annotations

import threading
import weakref
from collections import OrderedDict
from typing import Callable, Dict, Hashable, Optional, Tuple

import numpy as np
import torch

from valkey_search_tpu_torch.ops import bucket_scan as bs
from valkey_search_tpu_torch.runtime.metrics import (
    CTX,
    SPAN,
    STATS,
    TRACE,
    clock,
)

# the largest query tile of K1 and K2: one tile of queries a launch
GRAPH_MAX_B = max(bs.K1_MAX_TILE, bs.K2_MAX_TILE)
GRAPH_CACHE_SIZE = 32

# (dists, ids, the clock when the host began to wait for them or 0)
Answer = Tuple[np.ndarray, np.ndarray, int]
# a launch: its queries on the device -> (dists, ids) on the device
Launch = Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]


def takes_graph(b: int, device: torch.device, filtered: bool) -> bool:
    """Does a fused launch of ``b`` queries on ``device`` replay a graph?"""
    return device.type == "cuda" and not filtered and 1 <= b <= GRAPH_MAX_B


def graph_key(b: int, k: int, metric: str, plan: Hashable) -> Tuple:
    """The graph cache's key of a launch that ``takes_graph``: everything
    the launch observes that shapes its work (``plan`` is its
    ``ops.topk.FusedPlan``)."""
    return (b, k, metric, plan)


class _Graph:
    """One captured launch: the graph, its static device input and outputs,
    their pinned host twins, and the lock that holds them for one launch."""

    def __init__(self, graph, q_in, out_d, out_i, launches):
        self.graph = graph
        self.q_in = q_in
        self.out_d = out_d
        self.out_i = out_i
        self.launches = launches  # the scan kernels the graph holds
        self.pin_q = torch.empty(q_in.shape, dtype=q_in.dtype,
                                 pin_memory=True)
        self.pin_d = torch.empty(out_d.shape, dtype=out_d.dtype,
                                 pin_memory=True)
        self.pin_i = torch.empty(out_i.shape, dtype=out_i.dtype,
                                 pin_memory=True)
        self.host_q = self.pin_q.numpy()
        self.host_d = self.pin_d.numpy()
        self.host_i = self.pin_i.numpy()
        self.lock = threading.Lock()

    def replay(self, queries: np.ndarray) -> Answer:
        launch = CTX.launch
        with self.lock, torch.cuda.device(self.q_in.device):
            t0 = clock() if launch else 0
            self.host_q[...] = queries
            self.q_in.copy_(self.pin_q, non_blocking=True)
            self.graph.replay()
            t_sync = clock() if launch else 0
            self.pin_d.copy_(self.out_d, non_blocking=True)
            self.pin_i.copy_(self.out_i, non_blocking=True)
            torch.cuda.current_stream().synchronize()
            out = self.host_d.copy(), self.host_i.copy(), t_sync
        if t0:
            TRACE.record(SPAN["topk.replay"], t0, t_sync, CTX.rid, launch)
        bs.add_launches(self.launches)
        STATS.incr("flat_graph_replays")
        return out


# one capture at a time in the process, each on its device's side stream
_capture_lock = threading.Lock()
_side_streams: Dict[torch.device, torch.cuda.Stream] = {}


class FusedGraphs:
    """The captured fused launches of one index, for one published
    snapshot (the module's docstring)."""

    def __init__(self, size: int = GRAPH_CACHE_SIZE):
        self.size = size
        self._lock = threading.Lock()
        self._store = None  # a weak reference to the snapshot's store
        self._epoch = -1
        self._graphs: "OrderedDict[Tuple, _Graph]" = OrderedDict()

    def __len__(self) -> int:
        with self._lock:
            return len(self._graphs)

    def search(self, store, epoch: int, key: Tuple, queries: np.ndarray,
               device: torch.device, run: Launch) -> Optional[Answer]:
        """The answer of launch ``run`` on ``queries`` (f32 [B, d] on the
        host) over the snapshot on ``device`` that ``store`` published at
        ``epoch``: replayed, or captured after an eager run that answers.
        None when a newer snapshot of the store holds the graphs: the
        caller runs eagerly."""
        current, graph = self._lookup(store, epoch, key)
        if not current:
            return None
        if graph is not None:
            return graph.replay(queries)
        return self._capture(store, epoch, key, queries, device, run)

    def _lookup(self, store, epoch: int,
                key: Tuple) -> Tuple[bool, Optional[_Graph]]:
        with self._lock:
            same = self._store is not None and self._store() is store
            if same and epoch < self._epoch:
                return False, None
            if not same or epoch > self._epoch:
                self._graphs.clear()  # the old snapshot's graphs and pools
                self._store = weakref.ref(store)
                self._epoch = epoch
            graph = self._graphs.get(key)
            if graph is not None:
                self._graphs.move_to_end(key)
            return True, graph

    def _capture(self, store, epoch: int, key: Tuple, queries: np.ndarray,
                 device: torch.device, run: Launch) -> Answer:
        launch = CTX.launch
        t0 = clock() if launch else 0
        CTX.launch = 0  # the warm-up and the capture record no topk.* span
        try:
            with _capture_lock, torch.cuda.device(device):
                side = _side_streams.get(device)
                if side is None:
                    side = _side_streams[device] = torch.cuda.Stream(device)
                cur = torch.cuda.current_stream()
                q = torch.from_numpy(queries).to(device)
                q_in = torch.zeros_like(q)
                side.wait_stream(cur)
                with torch.cuda.stream(side):
                    d, i = run(q)  # the warm-up: this launch's answer
                    graph = torch.cuda.CUDAGraph()
                    with bs.captured_launches() as launches:
                        graph.capture_begin(capture_error_mode="thread_local")
                        try:
                            out_d, out_i = run(q_in)
                        finally:
                            graph.capture_end()
                cur.wait_stream(side)
                entry = _Graph(graph, q_in, out_d, out_i, launches)
                t_sync = clock() if launch else 0
                out = d.cpu().numpy(), i.cpu().numpy(), t_sync
        finally:
            CTX.launch = launch
        if t0:
            TRACE.record(SPAN["topk.capture"], t0, t_sync, CTX.rid, launch)
        STATS.incr("flat_graph_captures")
        self._keep(store, epoch, key, entry)
        return out

    def _keep(self, store, epoch: int, key: Tuple, graph) -> None:
        """Keep ``graph`` unless its snapshot was superseded meanwhile,
        dropping the least recently replayed past ``size``."""
        with self._lock:
            if self._store is None or self._store() is not store \
                    or self._epoch != epoch:
                return
            self._graphs[key] = graph
            while len(self._graphs) > self.size:
                self._graphs.popitem(last=False)
