"""Declarative INFO field registry.

Reference: vmsdk/src/info.{h,cc} (info.h:58-141) — a fluent
registry of INFO fields with Application/Developer visibility, SIBytes
human formatting, CrashSafe fields (emitted during crash dumps with no
locks/allocations), VisibleIf predicates and Computed callbacks; ~90
fields are registered across the engine (valkey_search.cc:93-1006) and
documented in docs/topics/search-observables.md. Developer fields only
appear when `search.debug-mode` is on.

The port's own copy of valkey_search_tpu/runtime/info.py, with its imports
pointing into valkey_search_tpu_torch.
"""

from __future__ import annotations

import dataclasses
import enum
import threading
from typing import Callable, Dict, List, Optional

from valkey_search_tpu_torch.runtime import config
from valkey_search_tpu_torch.runtime.metrics import STATS


class Visibility(enum.Enum):
    APP = "app"
    DEV = "dev"


def format_si_bytes(n: float) -> str:
    """Human bytes (reference SIBytes formatting)."""
    n = float(n)
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024.0 or unit == "TiB":
            return f"{n:.2f}{unit}" if unit != "B" else f"{int(n)}B"
        n /= 1024.0
    return f"{n:.2f}TiB"


@dataclasses.dataclass
class InfoField:
    name: str
    compute: Callable[[], object]
    visibility: Visibility = Visibility.APP
    si_bytes: bool = False
    crash_safe: bool = False
    visible_if: Optional[Callable[[], bool]] = None

    def render(self) -> object:
        v = self.compute()
        if self.si_bytes:
            return format_si_bytes(v)
        return v


class InfoRegistry:
    def __init__(self):
        self._lock = threading.Lock()
        self._fields: Dict[str, InfoField] = {}

    def register(self, field: InfoField) -> InfoField:
        with self._lock:
            if field.name in self._fields:
                raise ValueError(f"duplicate info field {field.name!r}")
            self._fields[field.name] = field
            return field

    def field(
        self,
        name: str,
        compute: Callable[[], object],
        dev: bool = False,
        si_bytes: bool = False,
        crash_safe: bool = False,
        visible_if: Optional[Callable[[], bool]] = None,
    ) -> InfoField:
        return self.register(InfoField(
            name=name, compute=compute,
            visibility=Visibility.DEV if dev else Visibility.APP,
            si_bytes=si_bytes, crash_safe=crash_safe, visible_if=visible_if,
        ))

    def counter(self, name: str, stat: str, dev: bool = False) -> InfoField:
        return self.field(name, lambda: STATS.get(stat), dev=dev)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._fields)

    def collect(self, include_dev: Optional[bool] = None,
                crash_safe_only: bool = False) -> Dict[str, object]:
        """Render all visible fields. include_dev=None → follow
        search.debug-mode (the reference's dev gating)."""
        if include_dev is None:
            include_dev = bool(config.get("search.debug-mode"))
        out: Dict[str, object] = {}
        with self._lock:
            fields = list(self._fields.values())
        for f in fields:
            if crash_safe_only and not f.crash_safe:
                continue
            if f.visibility is Visibility.DEV and not include_dev:
                continue
            if f.visible_if is not None and not f.visible_if():
                continue
            try:
                out[f.name] = f.render()
            except Exception:
                out[f.name] = "<error>"
        return out


REGISTRY = InfoRegistry()


def _sampler_fields(prefix: str, sampler_name: str) -> None:
    def pct(p):
        def _get():
            s = STATS.sampler(sampler_name)
            v = s.percentile(p)
            return round(v, 1) if v is not None else 0
        return _get

    REGISTRY.field(f"{prefix}_latency_usec_p50", pct(50))
    REGISTRY.field(f"{prefix}_latency_usec_p99", pct(99))
    REGISTRY.field(f"{prefix}_latency_usec_p999", pct(99.9), dev=True)


def _register_builtin_fields() -> None:
    R = REGISTRY
    # query path (reference search_* INFO strings, valkey_search.cc:866-890)
    R.counter("search_queries_total", "queries_total")
    R.field("search_vector_queries",
            lambda: STATS.get("vector_searches_unfiltered")
            + STATS.get("vector_searches_prefiltered")
            + STATS.get("vector_searches_inline_filtered"))
    R.counter("search_nonvector_queries", "non_vector_searches")
    R.counter("search_hybrid_queries_prefilter", "vector_searches_prefiltered")
    R.counter("search_hybrid_queries_inline",
              "vector_searches_inline_filtered")
    R.counter("search_query_errors", "query_errors")
    R.counter("search_aggregate_queries", "aggregate_queries")
    R.counter("search_aggregate_errors", "aggregate_errors")
    R.counter("search_query_timeouts", "query_timeouts")
    R.counter("search_partial_results", "partial_results", dev=True)
    _sampler_fields("search_vector", "vector_search_usec")
    _sampler_fields("search_nonvector", "nonvector_search_usec")
    # ingestion
    R.counter("search_mutations_enqueued", "mutations_enqueued")
    R.counter("search_mutations_applied", "mutations_applied")
    R.counter("search_mutations_combined", "mutations_combined")
    R.counter("search_mutation_failures", "mutation_failures")
    R.counter("search_backfilled_records", "backfilled_records")
    R.counter("search_documents_dropped_invalid", "documents_dropped_invalid")
    # vectors
    R.counter("search_vector_records_added", "vector_records_added")
    R.counter("search_vector_records_modified", "vector_records_modified")
    R.counter("search_vector_records_removed", "vector_records_removed")
    R.counter("search_vector_invalid_records", "vector_invalid_records")
    R.counter("search_hnsw_graph_rebuilds", "hnsw_graph_rebuilds", dev=True)
    R.counter("search_device_publishes", "device_publishes", dev=True)
    # persistence
    R.counter("search_rdb_saves", "rdb_saves")
    R.counter("search_rdb_loads", "rdb_loads")
    # ---- reference-spelling INFO fields (valkey_search.cc:93-1006 /
    # drilled by integration/test_info.py test_info_fields_present) -------
    R.counter("search_rdb_load_success_cnt", "rdb_loads")
    R.counter("search_rdb_load_failure_cnt", "rdb_load_failures")
    R.counter("search_rdb_save_success_cnt", "rdb_saves")
    R.counter("search_rdb_save_failure_cnt", "rdb_save_failures")
    R.field("search_successful_requests_count",
            lambda: max(0, STATS.get("queries_total")
                        + STATS.get("aggregate_queries")
                        - STATS.get("query_errors")
                        - STATS.get("aggregate_errors")))
    R.field("search_failure_requests_count",
            lambda: STATS.get("query_errors")
            + STATS.get("aggregate_errors"))
    R.field("search_hybrid_requests_count",
            lambda: STATS.get("vector_searches_prefiltered")
            + STATS.get("vector_searches_inline_filtered"))
    R.counter("search_inline_filtering_requests_count",
              "vector_searches_inline_filtered")
    # HNSW exception counters (reference Metrics::GetStats()
    # hnsw_*_exceptions_cnt, valkey_search.cc:869-884)
    for _op in ("add", "remove", "modify", "search", "create"):
        R.counter(f"search_hnsw_{_op}_exceptions_count",
                  f"hnsw_{_op}_exceptions")
    # worker-pool suspension counters (reference vmsdk ThreadPool
    # suspend/resume, valkey_search.cc fork lifecycle; this runtime
    # suspends writers on OOM — engine._deny_oom pause transitions)
    R.counter("search_worker_pool_suspend_cnt", "worker_pool_suspends")
    R.counter("search_writer_resumed_cnt", "writer_resumes")
    R.counter("search_reader_resumed_cnt", "reader_resumes")
    R.counter("search_writer_suspension_expired_cnt",
              "writer_suspension_expired")
    # vector externalizer (reference vector_externalizer.cc stats; the
    # LRU cache backing vector_bytes() resolution)
    def _ext_cache():
        from valkey_search_tpu_torch.server import externalizer

        return externalizer._cache

    R.field("search_vector_externing_entry_count",
            lambda: len(_ext_cache()))
    R.field("search_vector_externing_num_lru_entries",
            lambda: len(_ext_cache()))
    R.field("search_vector_externing_lru_promote_cnt",
            lambda: _ext_cache().hits)
    R.counter("search_vector_externing_hash_extern_errors",
              "vector_extern_errors")
    R.counter("search_vector_externing_generated_value_cnt",
              "vector_extern_generated")
    R.counter("search_vector_externing_deferred_entry_cnt",
              "vector_extern_deferred")
    # cluster / fanout
    R.counter("search_fanout_queries", "fanout_queries")
    R.counter("search_info_fanout_retry_count", "info_fanout_retries")
    # coordinator RPC counters (reference server.cc:85-92, client.cc:174-184)
    R.counter("search_coordinator_server_search_index_partition_success_count",
              "coordinator_server_partition_successes")
    R.counter("search_coordinator_server_search_index_partition_failure_count",
              "coordinator_server_partition_failures")
    R.counter("search_coordinator_client_search_index_partition_success_count",
              "coordinator_client_partition_successes")
    R.counter("search_coordinator_client_search_index_partition_failure_count",
              "coordinator_client_partition_failures")
    # coordinator RPC latency (reference *_latency samplers, server.cc:87)
    _sampler_fields("search_coordinator_server_search_index_partition_success",
                    "coordinator_server_partition_success_usec")
    _sampler_fields("search_coordinator_server_search_index_partition_failure",
                    "coordinator_server_partition_failure_usec")
    R.counter("search_fanout_retries", "fanout_retries", dev=True)
    R.counter("search_fanout_inconsistent_snapshots", "fanout_inconsistent")
    R.counter("search_metadata_broadcasts", "metadata_broadcasts", dev=True)
    R.counter("search_metadata_reconciles", "metadata_reconciles", dev=True)
    R.counter("search_single_slot_queries", "single_slot_queries", dev=True)
    R.counter("search_queries_parked_on_mutations",
              "queries_parked_on_mutations", dev=True)
    R.counter("search_predicate_revalidation",
              "predicate_revalidation", dev=True)
    # full-text in-flight blocking (reference valkey_search.cc:910-919:
    # text_query_blocked_count / text_query_retry_count in the query section)
    R.counter("search_text_query_blocked_count", "text_query_blocked")
    R.counter("search_text_query_retry_count", "text_query_retry")
    # FT.AGGREGATE per-stage counters (reference agg_stats DEV counters,
    # ft_aggregate.cc:350-362, ft_aggregate_exec.cc:20-33)
    for _agg in (
        "agg_input_records", "agg_output_records",
        "agg_limit_stages", "agg_limit_input_records",
        "agg_limit_output_records",
        "agg_group_by_stages", "agg_group_by_input_records",
        "agg_group_by_output_records", "agg_reducer_stages",
        "agg_apply_stages", "agg_apply_records",
        "agg_sort_by_stages", "agg_sort_by_records",
        "agg_filter_stages", "agg_filter_input_records",
        "agg_filter_output_records",
    ):
        R.counter(f"search_{_agg}", _agg, dev=True)
    R.counter("search_hnsw_graph_publishes", "hnsw_graph_publishes",
              dev=True)
    R.counter("search_hnsw_graph_incremental_publishes",
              "hnsw_graph_incremental_publishes", dev=True)
    R.counter("search_hnsw_served_by_scan", "hnsw_served_by_scan", dev=True)


_register_builtin_fields()


def register_engine_fields(engine, registry: InfoRegistry) -> None:
    """Engine-instance fields (schemas, keyspace, interners, memory-ish) —
    registered on a per-engine registry so multiple engines in one
    process (cluster simulations, tests) don't alias each other."""
    R = registry

    # per-pool thread CPU% (vmsdk ThreadMonitor parity, thread_pool.h:111)
    from valkey_search_tpu_torch.runtime.threadmon import MONITOR

    R.field(
        "search_thread_pool_cpu_percent",
        lambda: ",".join(
            f"{pool}={pct}" for pool, pct in
            sorted(MONITOR.sample().items()) if pct > 0
        ) or "idle",
        dev=True,
    )

    R.field("search_number_of_indexes",
            lambda: len(engine.manager.all_schemas()), crash_safe=True)
    R.field("search_total_indexed_documents",
            lambda: sum(s.num_docs() for s in engine.manager.all_schemas()))
    R.field("search_keyspace_keys", lambda: len(engine.keyspace))
    R.field("search_mutation_queue_size", lambda: engine._queue_size())
    R.field(
        "search_used_vector_bytes",
        lambda: sum(
            a.index.store.vectors.nbytes
            for s in engine.manager.all_schemas()
            for a in s.vector_attributes()
        ),
        si_bytes=True,
    )
    R.field(
        "search_reclaimable_memory_bytes",
        lambda: sum(
            getattr(a.index, "reclaimable_bytes", lambda: 0)()
            for s in engine.manager.all_schemas()
            for a in s.vector_attributes()
        ),
        si_bytes=True,
    )
    # per-subsystem memory pools (reference text_index.h:50-55 MemoryPools
    # + the malloc-interposition used-memory gauge)
    # integer bytes (reference used_memory_bytes is a plain integer; the
    # human-formatted twin is search_used_memory_human below)
    R.field("search_used_memory_bytes",
            lambda: engine.used_memory_bytes())
    for _pool in ("vector", "tag", "numeric", "text", "interner",
                  "keyspace"):
        R.field(
            f"search_memory_pool_{_pool}_bytes",
            (lambda p: lambda: engine.memory_pools().get(p, 0))(_pool),
            si_bytes=True,
        )
    R.field(
        "search_backfills_in_progress",
        lambda: sum(
            1 for s in engine.manager.all_schemas() if s.backfill_in_progress
        ),
        crash_safe=True,
    )
    # allocator-level truth (the reference interposes malloc globally,
    # vmsdk memory_allocation_overrides.h; here the per-subsystem pools
    # above are analytic estimates, and these two fields report what the
    # OS/allocator actually hold — process RSS covers the Python heap the
    # pools cannot see, so the pair bounds the estimate from both sides)
    def _rss_bytes():
        import os as _os

        try:
            with open("/proc/self/statm") as f:
                return int(f.read().split()[1]) * _os.sysconf("SC_PAGE_SIZE")
        except (OSError, ValueError):
            return 0

    def _heap_bytes():
        # glibc mallinfo2: uordblks = bytes in in-use heap chunks —
        # everything malloc'd by Python, numpy, and the native layer
        import ctypes as _ct

        class _MI2(_ct.Structure):
            _fields_ = [(n, _ct.c_size_t) for n in (
                "arena", "ordblks", "smblks", "hblks", "hblkhd",
                "usmblks", "fsmblks", "uordblks", "fordblks", "keepcost",
            )]

        try:
            libc = _ct.CDLL(None)
            libc.mallinfo2.restype = _MI2
            mi = libc.mallinfo2()
            return int(mi.uordblks) + int(mi.hblkhd)
        except (OSError, AttributeError):
            return 0

    R.field("search_process_rss_bytes", _rss_bytes, si_bytes=True)
    R.field("search_heap_allocated_bytes", _heap_bytes, si_bytes=True)
    # ---- reference-spelling engine fields (test_info.py parity) ---------
    R.field("search_used_memory_human",
            lambda: engine.used_memory_bytes(), si_bytes=True)
    R.field("search_index_reclaimable_memory",
            lambda: sum(
                getattr(a.index, "reclaimable_bytes", lambda: 0)()
                for s in engine.manager.all_schemas()
                for a in s.vector_attributes()
            ))
    R.field("search_background_indexing_status",
            lambda: "IN_PROGRESS" if any(
                s.backfill_in_progress for s in engine.manager.all_schemas()
            ) else "NO_ACTIVITY")
    R.field("search_number_of_attributes",
            lambda: sum(
                len(s.attributes) for s in engine.manager.all_schemas()
            ))
    R.field("search_string_interning_store_size",
            lambda: sum(
                s.interner.count for s in engine.manager.all_schemas()
            ))
    R.field("search_writer_queue_size", lambda: engine._queue_size())
    # reader path executes synchronously on the calling thread (queries
    # never queue host-side; device batching happens in the batcher)
    R.field("search_query_queue_size",
            lambda: getattr(engine, "_reader_queue_size", lambda: 0)())
    def _active_writers():
        if getattr(engine, "_sync_ingest", True):
            return 0
        return sum(1 for w in getattr(engine._queue(), "_workers", ())
                   if w.is_alive())

    R.field("search_total_active_write_threads", _active_writers)

    def _pool_cpu(kinds):
        def _get():
            pools = MONITOR.sample()
            vals = [p for name, p in pools.items()
                    if any(k in name for k in kinds)]
            return round(sum(vals), 2) if vals else -1
        return _get

    # per-pool CPU% (reference ThreadPool::GetAvgCPUPercentage, -1 when
    # no samples — valkey_search.cc:126-139)
    R.field("search_used_read_cpu", _pool_cpu(("reader", "search", "batch")))
    R.field("search_used_write_cpu", _pool_cpu(("writer", "ingest")))
