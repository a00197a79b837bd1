"""Self-registering typed config registry.

Models the reference's vmsdk config system (vmsdk/src/module_config.h:33-120,
245+): typed Number/Boolean/Enum/String entries with min/max validation,
modify callbacks, Immutable/Hidden/Dev flags, and a global registry driving
``CONFIG GET/SET search.*``. Dev-only entries are gated behind
``search.debug-mode`` (reference module_config.h:222-227).

The notable engine tunables mirror docs/topics/search-configurables.md and
src/valkey_search_options.cc.

The port's own copy of valkey_search_tpu/runtime/config.py: the same
names, defaults and behaviour, with its imports pointing into
valkey_search_tpu_torch, and one option of its own, ``search.trace-spans``
(``PORT_OPTIONS``).
"""

from __future__ import annotations

import dataclasses
import enum
import threading
from typing import Any, Callable, Dict, List, Optional


class ConfigError(ValueError):
    pass


class Flag(enum.IntFlag):
    NONE = 0
    IMMUTABLE = 1
    HIDDEN = 2
    DEV = 4  # only visible/settable when search.debug-mode is on


@dataclasses.dataclass
class Entry:
    name: str
    value: Any
    default: Any
    kind: str  # "number" | "boolean" | "enum" | "string"
    min: Optional[float] = None
    max: Optional[float] = None
    choices: Optional[List[str]] = None
    flags: Flag = Flag.NONE
    validate: Optional[Callable[[Any], Optional[str]]] = None
    on_modify: Optional[Callable[[Any], None]] = None

    def coerce(self, raw: Any) -> Any:
        if self.kind == "number":
            v = int(raw) if float(raw) == int(float(raw)) else float(raw)
            if self.min is not None and v < self.min:
                raise ConfigError(f"{self.name}: {v} < min {self.min}")
            if self.max is not None and v > self.max:
                raise ConfigError(f"{self.name}: {v} > max {self.max}")
            return v
        if self.kind == "boolean":
            if isinstance(raw, bool):
                return raw
            s = str(raw).lower()
            if s in ("yes", "true", "1", "on"):
                return True
            if s in ("no", "false", "0", "off"):
                return False
            raise ConfigError(f"{self.name}: bad boolean {raw!r}")
        if self.kind == "enum":
            s = str(raw).lower()
            if s not in (self.choices or []):
                raise ConfigError(f"{self.name}: {raw!r} not in {self.choices}")
            return s
        return str(raw)


# reference-spelled config names that map onto this runtime's entries —
# CONFIG GET/SET works with either spelling and both reach ONE value
# (docs/topics/search-configurables.md is the authoritative name list)
_ALIASES = {
    "search.query-string-depth": "search.max-query-depth",
    "search.query-string-terms-count": "search.max-query-terms",
    "search.max-tag-field-length": "search.max-tag-field-len",
    "search.default-timeout-ms": "search.timeout-ms",
}


class Registry:
    """Global config registry; thread-safe GET/SET with validation."""

    def __init__(self):
        self._entries: Dict[str, Entry] = {}
        self._lock = threading.RLock()

    def register(self, entry: Entry) -> Entry:
        with self._lock:
            if entry.name in self._entries:
                return self._entries[entry.name]
            self._entries[entry.name] = entry
            return entry

    def get(self, name: str) -> Any:
        name = _ALIASES.get(name, name)
        with self._lock:
            e = self._entries.get(name)
            if e is None:
                raise ConfigError(f"unknown config {name!r}")
            return e.value

    def set(self, name: str, raw: Any, loading: bool = False) -> None:
        name = _ALIASES.get(name, name)
        with self._lock:
            e = self._entries.get(name)
            if e is None:
                raise ConfigError(f"unknown config {name!r}")
            if (e.flags & Flag.IMMUTABLE) and not loading:
                raise ConfigError(f"config {name!r} is immutable")
            if (e.flags & Flag.DEV) and not self._debug_mode() and not loading:
                raise ConfigError(f"config {name!r} requires search.debug-mode")
            v = e.coerce(raw)
            if e.validate is not None:
                err = e.validate(v)
                if err:
                    raise ConfigError(f"{name}: {err}")
            e.value = v
            if e.on_modify is not None:
                e.on_modify(v)

    def _debug_mode(self) -> bool:
        e = self._entries.get("search.debug-mode")
        return bool(e.value) if e is not None else False

    def snapshot(self, include_hidden: bool = False) -> Dict[str, Any]:
        with self._lock:
            dbg = self._debug_mode()
            out = {}
            for name, e in sorted(self._entries.items()):
                if (e.flags & Flag.HIDDEN) and not include_hidden:
                    continue
                if (e.flags & Flag.DEV) and not dbg:
                    continue
                out[name] = e.value
            return out

    def reset_all(self) -> None:
        with self._lock:
            for e in self._entries.values():
                e.value = e.default


REGISTRY = Registry()


def _num(name, default, lo=None, hi=None, flags=Flag.NONE, on_modify=None):
    return REGISTRY.register(
        Entry(name, default, default, "number", min=lo, max=hi, flags=flags,
              on_modify=on_modify)
    )


def _bool(name, default, flags=Flag.NONE):
    return REGISTRY.register(Entry(name, default, default, "boolean", flags=flags))


def _enum(name, default, choices, flags=Flag.NONE):
    return REGISTRY.register(
        Entry(name, default, default, "enum", choices=choices, flags=flags)
    )


# --- engine tunables (names track the reference's search.* configs,
#     docs/topics/search-configurables.md) ----------------------------------
_bool("search.debug-mode", False)
_num("search.reader-threads", 1, 1, 1024)          # host query dispatch pool
_num("search.writer-threads", 1, 1, 1024)          # host ingest pool
_num("search.hnsw-block-size", 10240, 128, 10_000_000)  # capacity growth quantum
# 256k-row scan blocks measured fastest for the two-stage retrieval
# (155.6k qps @ recall 0.998 on 1M x 128 vs 138k at 128k blocks)
_num("search.flat-block-size", 262144, 1024, 10_000_000)
_num("search.prefiltering-threshold-ratio", 0.45, 0.0, 1.0)  # planner.cc:40-43
_num("search.search-result-buffer-multiplier", 5, 1, 100)    # search.cc:744
_num("search.max-non-vector-search-results-fetched", 10000, 1, 10_000_000)
_num("search.default-ef-runtime", 10, 1, 4096)     # ft.create.md:86-89
_num("search.max-ef-runtime", 4096, 1, 100_000)
_num("search.timeout-ms", 50_000, 1, 10_000_000)
_bool("search.prefer-partial-results", False)      # fanout partial policy
# 0 = adaptive: no artificial wait; arrivals during an in-flight launch
# queue behind the next leader (continuous batching). >0 adds a fixed
# collection window for latency/throughput tuning.
_num("search.query-batch-window-us", 0, 0, 100_000)
_num("search.query-max-batch", 1024, 1, 4096)
# dispatcher threads per (index, k, ef) signature (query/batcher.py): the
# reader-pool analog (reference search.reader-threads). Extra dispatchers
# spawn only while the backlog exceeds a full launch per live worker —
# they overlap host<->device round trips, not device compute.
_num("search.query-dispatch-threads", 4, 1, 16)
# HIGH (bf16x3 MXU passes) keeps recall@10 >= 0.99 on tightly-clustered
# corpora where DEFAULT (single bf16 pass) drops it to ~0.89; HIGHEST
# (fp32) is bit-faithful to a CPU float implementation but slower.
_enum("search.distance-precision", "high", ["highest", "high", "default"])
# per-block top-k primitive for the flat scan: lax.approx_min_k is the
# TPU-optimized partial reduce (2-3x faster; end-to-end recall@10 >= 0.99
# measured — cross-block merges stay exact). "exact" = lax.top_k.
_enum("search.topk-mode", "approx", ["approx", "exact"])
# coarse-scan implementation: "pallas" fuses the distance matmul with the
# per-bucket min/argmin reduction (ops/pallas_scan.py) so the [B, N] score
# matrix never touches HBM; "xla" is the approx_min_k two-stage; "auto"
# picks pallas on TPU for large corpora (per-query filter masks and small
# corpora always take the xla path).
_enum("search.scan-kernel", "auto", ["auto", "pallas", "xla"])
# fused-scan tuning (ops/topk.py flat_topk_fused): survivor granularity
# (rows per packed int8 survivor = span*128) and exact-rescore
# over-retrieval (coarse_factor*k candidates). 0 = auto (measured
# defaults: span 8 / cf 4 at >=1M rows — 392-490k qps at recall@10
# 0.9906-0.9984 across clustered/uniform/low-rank-768 1M shapes,
# scripts/recall_shapes.py r5). Operators wanting more recall margin on
# adversarial corpora: span=4 cf=4 holds >=0.9984 on every measured
# shape at ~13% lower qps.
_num("search.scan-span", 0, 0, 16)
_num("search.scan-coarse-factor", 0, 0, 64)
_bool("search.skip-corrupted-internal-update-entries", False)
REGISTRY.register(Entry("search.checkpoint-path", "", "", "string"))
# op journal (AOF analog — the reference rides valkey AOF for
# FT.INTERNAL_UPDATE replay, ft_internal_update.cc:55): empty = disabled
REGISTRY.register(Entry("search.journal-path", "", "", "string"))
# fsync window: 0 = every write (appendfsync=always), >0 = bounded-loss
# window in ms (everysec shape), <0 = let the OS decide (appendfsync=no)
_num("search.journal-fsync-ms", 1000, -1, 3_600_000)
_enum("search.hnsw-build-mode", "auto", ["auto", "device", "host"])
# host-build worker threads (reference writer pool builds HNSW
# concurrently, valkey_search.cc:1165-1168 + per-label locks
# hnswalg.h:1260-1270); 0 = one per physical core
_num("search.native-build-threads", 1, 0, 256)
# AoS int8 neighbor-block mirror for fast graph traversal: replicates
# each vector once per in-edge (~M0 x corpus bytes at int8), so it is
# budget-gated; graphs over budget fall back to the SoA traversal (and
# usually to the exact scan via hnsw-scan-threshold anyway). 0 disables.
_num("search.hnsw-aos-budget-bytes", 1 << 30, 0, 1 << 40)
# cron-triggered graph rebuild when this fraction of slots are
# tombstones (reference: hnswlib allow_replace_deleted reuses slots in
# place; here the rebuild is cheap and produces a tombstone-free graph).
# 0 disables auto-vacuum (explicit FT._DEBUG / vacuum() still works).
_num("search.hnsw-vacuum-deleted-ratio", 0.5, 0.0, 1.0)
# scan-seeded traversal: a strided-subsample MXU pass initializes the
# beam with ef good candidates before the graph walk refines them (the
# subsample plays the upper layers' long-range-routing role). 0 = pure
# entry-point descent (hnswlib-faithful); N = subsample stride.
_num("search.hnsw-traversal-seed-stride", 0, 0, 1_000_000)
# project the AoS traversal mirror to this many dims (0 = full d):
# smaller rows -> faster HBM gathers during the walk; the exact fp32
# rescore keeps final distances full-precision (DiskANN-style
# quantized-guided traversal)
_num("search.hnsw-aos-project-dim", 0, 0, 4096)
_num("search.hnsw-build-batch", 4096, lo=256, hi=65536)
# corpus storage for the flat scan: bfloat16 keeps a half-width mirror for
# the coarse pass (exact fp32 rescore of 4k candidates restores recall:
# measured 1.6x QPS at recall@10 0.998 on 1M x 128); float32 = single-stage
_enum("search.corpus-dtype", "bfloat16", ["bfloat16", "float32", "int8"])
# HNSW indexes answer queries via the MXU exact scan while the corpus is
# at or below this size. Measured: the scan wins at every on-chip size
# (recall 1.0; 141k qps at 1M, 44k at 10M vs ~1.4k for batched graph
# traversal), and HBM caps a single chip near ~20M rows at 128d — so the
# default keeps the scan for everything that fits. The graph remains for
# API/persistence parity, the CPU oracle, and >HBM sharded regimes.
# 0 = always traverse the graph.
_num("search.hnsw-scan-threshold", 1 << 30, 0, 1 << 40)
# writer-pool priority fairness (reference valkey_search_options.cc:237
# kHighPriorityWeight, default 100): share of scheduling slots "high"
# tasks win over "low" (backfill) when both queues are non-empty;
# low share = 100 - weight. 100 = strict high-first.
_num("search.high-priority-weight", 100, 0, 100)
# BGSAVE isolation: fork a copy-on-write child to write the checkpoint
# (the reference rides valkey's fork-based BGSAVE; AtForkPrepare
# suspends the pools, valkey_search.cc:1029). false = in-process
# background thread under a locked snapshot (round-2 behavior).
_bool("search.bgsave-fork", True)
# IVF coarse-pruned path (ops/ivf.py): unfiltered/1-D-filtered vector
# searches on corpora at or above this row count route through the
# residual-quantized block index instead of the O(N) exact scan — the
# sub-linear regime the reference gets from hnswlib graph walks, built
# from MXU matmuls + contiguous block gathers instead. 0 disables.
# Threshold MEASURED on-chip (scripts/crossover.py r5, B=16384, 128d
# clustered bytes, recall@10 >= 0.99 both paths, BASELINE.md table):
# the fused scan is O(N) — 452k/273k/136k/96k/61k/62k qps at
# 1/2/4/6/8/10M — while grouped-dispatch rescored IVF holds
# 211-244k qps at probe=8 and 147-181k at probe=12-16, nearly
# N-independent. The recall>=0.99 frontiers cross between the measured
# 2M (scan 273k > ivf 244k) and 4M (ivf 233k > scan 136k) points.
_num("search.ivf-threshold", 3_000_000, 0, 1 << 40)
# rows per IVF block: the gather/scoring tile. 1024 x 128d int8 = 128KB
# per tile — the contiguous-read shape HBM likes.
_num("search.ivf-block-rows", 1024, 128, 65536)
# blocks probed per query — the recall/throughput dial (IVF analog of
# ef_runtime, EF_RUNTIME maps here). 0 = auto from the layout's block
# count (ops/ivf.py default_probe: 8 through nb<=7168, 16 through
# nb<=12288, then ~nb/384 clamped [32, 512] — measured r5: probe=8
# collapses to 0.88 at 10M while 16 holds >=0.995; the 100M layout
# needs ~256). Explicit values pin the dial; the no-rescore >HBM
# tier's recall is the residual quantizer's ceiling regardless.
_num("search.ivf-probe", 0, 0, 65536)
# coarse k-means cell count; 0 = auto (~N / (8 * block-rows), refined by
# a second in-cluster k-means level for oversized cells)
_num("search.ivf-clusters", 0, 0, 65536)
_num("search.mutation-compaction-threshold", 4096, 1, 10_000_000)
_num("search.backfill-batch-size", 10240, 1, 10_000_000)
_num("search.max-indexes", 256, 1, 10_000)
_num("search.max-attributes", 64, 1, 1024)
_num("search.max-tag-field-len", 256, 1, 1_000_000)
_num("search.max-prefixes", 16, 1, 1024)
# ---- reference-spelling configurables (docs/topics/search-configurables
# .md; defaults from the reference registration sites) -------------------
_num("search.query-string-bytes", 10_240, 1, 1 << 30)   # options.cc:65
_num("search.fuzzy-max-distance", 3, 1, 50)             # filter_parser.cc:62
_num("search.max-term-expansions", 200, 1, 100_000)     # options.cc:330
_num("search.tag-min-prefix-length", 2, 0, 1024)        # options.cc:344
_num("search.max-vector-knn", 10_000, 1, 100_000)       # ft_search_parser:35
_num("search.max-numeric-field-length", 128, 1, 256)    # ft_create_parser:66
_num("search.max-vector-attributes", 1000, 1, 10_000)   # ft_create_parser:62
_num("search.max-vector-dimensions", 32_768, 1, 64_000)
_num("search.max-vector-m", 2_000_000, 2, 2_000_000)
_num("search.max-vector-ef-construction", 1_000_000, 1, 1_000_000)
_num("search.max-vector-ef-runtime", 1_000_000, 1, 1_000_000)
_num("search.max-search-result-record-size",            # response_gen:53
     5 * 1024 * 1024, 100, 10 * 1024 * 1024)
_num("search.max-search-result-fields-count", 500, 1, 1000)
_bool("search.prefer-consistent-results", True)  # CONSISTENT is default
_bool("search.drain-mutation-queue-on-save", True)
_num("search.ft-info-timeout-ms", 5000, 1, 600_000)     # options.cc:20
_num("search.ft-info-rpc-timeout-ms", 2500, 1, 600_000)
_num("search.coordinator-query-timeout-secs", 25, 1, 3600)  # client.cc:63
_num("search.local-fanout-queue-wait-threshold", 50, 0, 60_000)
_num("search.thread-pool-wait-time-samples", 100, 1, 100_000)
_num("search.high-priority-weight", 100, 0, 1_000_000)  # options.cc:239
_num("search.utility-threads", 1, 0, 1024)
_num("search.max-worker-suspension-secs", 60, 0, 86_400)
_num("search.cluster-map-expiration-ms", 1000, 1, 600_000)
# accepted for compatibility; this runtime's proximity iterator and
# result cleanup have a single behavior (no legacy mode / no deferred
# reclamation thread)
_bool("search.proximity-inorder-compat-mode", False)
_bool("search.search-result-background-cleanup", True)
_bool("search.use-coordinator", True)              # mesh fanout on/off
_num("search.fanout-shards", 1, 1, 4096, flags=Flag.IMMUTABLE)
_bool("search.skip-rdb-load", False)               # README.md:60-77 recovery path
_num("search.max-query-depth", 1000, 1, 100_000)   # filter_parser depth limit
_num("search.max-query-terms", 1000, 1, 10_000)    # reference default 1000
_num("search.max-text-query-terms", 16, 1, 10_000)
_bool("search.enable-partial-results", False)
# fanout target selection (reference FanoutTargetMode, cluster_map.h:38-46)
_enum("search.fanout-target-mode", "random",
      ["random", "primary", "replica"])
_num("search.replication-lag-ms", 0, 0, 60_000, flags=Flag.DEV)
# memory guard (reference: DENYOOM command flag + backfill pause-on-OOM,
# index_schema.h:475 paused_by_oom; 0 = unlimited)
_num("search.max-memory-bytes", 0, 0, 1 << 62)
# what to do at the cap (valkey maxmemory-policy analog; reference
# integration/test_eviction.py covers eviction-driven index removal):
# noeviction = DENYOOM writes; *-random = evict arbitrary keys;
# volatile-ttl = soonest-expiring key; *-lru / *-lfu = approximated
# least-recent / least-frequent via sampling (valkey evict.c pool);
# volatile-* restrict candidates to keys carrying a TTL, else DENYOOM
_enum("search.maxmemory-policy", "noeviction",
      ["noeviction", "allkeys-random", "volatile-random", "volatile-ttl",
       "allkeys-lru", "volatile-lru", "allkeys-lfu", "volatile-lfu"])
# Redisearch compatibility pinning (reference search.emulate-release,
# module_config.h VALKEY_SEARCH_COMPATIBILITY_FIX; '' = native behavior).
# When set, dialect divergences emulate Redisearch (e.g. concat() is
# unknown there).
REGISTRY.register(Entry("search.emulate-release", "", "", "string"))
_enum("search.log-level", "notice", ["debug", "verbose", "notice", "warning"])
# connection authentication: when set, AUTH/HELLO AUTH must present this
# password (the reference delegates authentication to valkey-server; this
# standalone stack has no server in front, so it carries its own gate)
REGISTRY.register(Entry("search.requirepass", "", "", "string"))
_bool("search.log-user-data", False)  # reference RedactIfNeeded gate
# keyspace-notification flags, valkey notify-keyspace-events semantics:
# "" = off; K/E pick the __keyspace@N__/__keyevent@N__ channel families;
# class letters (g h d x ...) or A gate which events publish. (The
# reference CONSUMES these events from valkey-server to drive indexing;
# this standalone stack also EMITS them to SUBSCRIBE/PSUBSCRIBE clients.)
REGISTRY.register(Entry("search.notify-keyspace-events", "", "", "string"))
# the port's own option: record the spans of sampled commands into
# runtime/metrics.py's ring (TRACE); off, a command reads this entry and
# records nothing
TRACE_SPANS = _bool("search.trace-spans", True)
PORT_OPTIONS = ("search.trace-spans",)


def get(name: str) -> Any:
    return REGISTRY.get(name)


def set_config(name: str, value: Any) -> None:
    REGISTRY.set(name, value)
