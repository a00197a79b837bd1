#!/usr/bin/env python3
"""Build the PyTorch/CUDA port's kernels and drive its FT.SEARCH and
FT.AGGREGATE paths, its RESP server, its persistence, its cluster layer,
its sharded mesh programs and its IVF tier beyond device memory on one GPU.

Run from the root of a checkout, on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases (each failure exits non-zero; there is no CPU path):

1. device   - requires a CUDA device, selects it, prints name and power limit;
2. build    - one nvcc per source, all at once: K1 and K3
              (bucket_scan_i8_packed.cu) and K2 (bucket_scan_bf16.cu); the
              native text tier (g++) builds beside them;
3. kernels  - each kernel against its plain PyTorch version at
              N = 1,048,576 (1,000 padded rows), each case with its query
              tile BQ, kernel and plain times (CUDA events) and its share
              of the bound (bytes at 3.35 TB/s or operations at the int8 /
              bf16 tensor-core peak, whichever is larger): K1 at span 1
              and 8, d 128, B = 1, 7, 64, 256 and 1,024 with 5% of the rows
              excluded and B = 1 with 99% excluded (a hybrid request under
              a 1% filter), span 4 d 256 at B = 256, span 8 d 768 at B = 64
              and 256 (K1_CASES); K2 at B = 1 .. 1,024 (l2), ip, d 768 and
              B = 1 with 99% excluded (K2_CASES); K3 at d 128 and 768,
              B = 1, 256 and 1,024, with negative scores (K3_CASES). K1
              keys and K3 vals/idx bit-identical, K2 idx agreeing on
              >= 99% of columns and vals within rtol 4e-5, atol 1e-2. One
              PyTorch call times the product alone at B = 256 and 1,024
              (torch._int_mm for K1 and K3, a bf16 matmul for K2) as the
              kernels' library yardstick; the port never calls it;
3b. bench  - bench_torch.py --quick as a child process (its own process
              group, killed whole at BENCH_TIMEOUT_S): it exits 0, its last
              line parses within 1,500 characters and names this card and
              its power limit, int8 recall@10 >= 0.99, and its flat1m
              section launched K1b or K2 (its own counts, reset at the
              section's start, from its details file);
4. slice    - FT.CREATE (v VECTOR FLAT, cat TAG, price NUMERIC) + 1,000,000
              HSETs of all three fields (the bench's seeded SIFT-like recipe,
              seeded tags and prices) + FT.SEARCH KNN 10 from 16 threads,
              under int8 (K1, pre_shift > 0) and bfloat16 (K2): unfiltered,
              then hybrid under a tag (~1%), two price ranges (~10%, ~50%)
              and their conjunction (~0.5%); and a 140,000-row int8 index
              with a TEXT field (K1, pre_shift = 0), unfiltered and under a
              text filter. recall@10 against fp64 ground truth restricted to
              the qualified rows, no key outside a filter, the kernels'
              launch counts, non-vector counts and SORTBY, DEL and update
              visibility (the tag mask cache included), latency and
              search_batch QPS; and where a hybrid request's time goes
              (profile_hybrid: 1 against 16 threads, the GIL switch
              interval, torch.profiler's device time per request);
   Inside it, before the DELs, the aggregate phase on the same 1M index
   (aggregate_phase; under int8 at the default span, K1 at pre_shift > 0,
   where KNN 100 holds recall ~0.95, at search.scan-span 1, K1 at
   pre_shift 0, and under bfloat16, K2):
   FT.AGGREGATE over KNN 100 with LOAD, GROUPBY (COUNT, AVG) and SORTBY, 256
   queries from 16 threads: group counts and averages equal to numpy's over
   the fp64 top 100 wherever the port's top 100 is that set, recall of the
   100 >= 0.99 (0.94 under int8 at span 8, which runs unfiltered alone);
   the same behind the ~1% tag and ~10% price filters with APPLY and
   FILTER stages (no row outside the filter); the columnar
   GROUPBY over ~100,000 rows against np.unique (no scan launch), then the
   same request by the per-row route while HSETs land, and each route
   timed; asynchronous ingestion of 20,000 rows (Engine(sync_ingest=False),
   4 writers, drain(); FT.CREATE after the data and cron() until the
   backfill ends) against a synchronous engine, KNN 10 keys equal, HSETs
   per second of each; PEXPIRE on 100 returned keys (none returns from KNN
   or FT.AGGREGATE, before or after cron()), HDEL of a vector field, a
   multi() of 10 HSETs seen whole; INFO's reference field names and moved
   counters; FT._DEBUG PROFILE around one KNN batch (a non-empty trace).
   Then the server phase on the same index (server_phase): RespServer
   (port 0) over the slice's engine; FT.SEARCH KNN 10 for the 1,024 queries
   over 16 RESP connections under int8 (K1, pre_shift > 0) and bfloat16
   (K2): keys and distances equal to Engine.execute's (distances within
   1e-5 of ||q||^2, keys that tie within rounding in either order or
   across the 10th rank; under int8, whose query scale is the batch's,
   >= 90% of replies equal and every shared key at the same distance),
   recall@10 >= 0.99, fewer scan
   launches than requests, no key outside @cat:{c7}; requests/s and p50 /
   p99 beside Engine.execute's from 16 threads; HELLO 3 (a map, the same
   reply); EVAL (a script's KNN does not see its own HSET, the next
   script's finds it first at distance 0) and MULTI/EXEC of 10 HSETs and
   one FT.SEARCH (none inside, all after); SAVE timed with the file's size,
   Engine.load timed by stage (keyspace decode, non-vector replay, vector
   sections, the rest) with the peak RSS, FT.INFO num_docs and 100 sampled
   HGETALLs equal, the first KNN after the restore (full publish, int8
   quantize) timed and its mirror on the card, replies equal to the saved
   engine's (int8 where the scales are equal); BGSAVE by fork while the 16
   connections search and a 17th writes: status ok, the child's wall time,
   the parent's KNN during and after it, the file read whole and its
   keyspace decoded (a pre-fork key present, a key written after BGSAVE
   returned absent); and the op
   journal: 5,000 rows over the wire with SAVE half way, a DEL and an
   EXPIRE, then a new RespServer over a fresh engine boots from the
   checkpoint and the journal with equal replies and the TTL rebased.
   Then (a) of the ivf phase on the 1M index (ivf_engine_route);
5. hnsw     - (a) FT.CREATE ... VECTOR HNSW (M 16, EF_CONSTRUCTION 200) +
              cat TAG and 66,000 HSETs (native inserts): FT.SEARCH KNN 10
              EF_RUNTIME 100 from 16 threads on the scan route (pow2
              capacity 131,072: K1 at pre_shift 0, and K2), hybrid, DEL and
              update; then search.hnsw-scan-threshold 0: the AoS walk, the
              filtered SoA walk (inline) and the pre-filtered exact scan,
              each checked by its counters (the inline-filtered walk on 16
              queries: such a request walks alone). (b)
              HnswVectorIndex.bulk_load of 300,000 rows under build-mode
              device (candidate scan, prune,
              native bulk_build, bridging and publish timed); search_batch
              at B = 1,024 on the scan route (K1 at pre_shift > 0, K2) and
              the walk at ef 10, 50 and 100 beside the native walk over the
              same graph; the walk's device share under torch.profiler.
              SAVE and Engine.load of that engine: the graph imported, the
              walk at EF_RUNTIME 100 returning the same ids as before the
              save, the first walk's graph upload timed. Then (a) of the
              ivf phase on the 66k HNSW index;
6. ivf      - (a) ivf_engine_route, on the slice's 1M FLAT index with
              search.ivf-threshold 500,000 and on the 66k HNSW index with
              50,000 (EF_RUNTIME 100): FT.SEARCH KNN 10 from 16 threads
              under int8 builds the IVF mirror once on the card and IVF
              serves every query, with no scan launch (the ivf_* counters);
              recall@10 >= 0.95 on the 1,024 queries against fp64
              ground truth over the live rows; a @cat:{c7}
              hybrid query takes the scan (K1); deleted keys never return;
              an updated key comes first at distance 0 through the delta
              overlay, with no rebuild. (b) ivf_phase: a 10,000,000 x 128
              FLAT index (the recipe made on the card in seeded 1M-row
              chunks) through bulk_load at the default threshold: the
              mirror's build_ivf_device stages, size and peak memory;
              search_batch at B = 1,024 and 16,384, probe 8, 16 and 32 (QPS
              the median of 5, recall@10 >= 0.99 at the default probe, the
              stage-2 route of each, both routes required); a torch.profiler
              split of one B = 16,384 batch by ops/ivf.py's ranges, and the
              wall and device time of 8 B = 1,024 calls one by one; the
              fused scan over the same index (K1b, K2); the host-fed
              build_ivf against build_ivf_device over the first 1,000,000
              rows (recall on 16,384 queries within 0.01 at the same
              probe).
7. cluster  - (a) ClusterEngine(n_nodes=3) over rows 0-599,999 of the slice's
              corpus with their tags (~200,000 a shard: capacity 200,704,
              K1 at pre_shift 0 under int8, K2 under bfloat16), every row
              through ClusterEngine.execute("HSET"); 256 KNN 10 unfiltered
              and behind @cat:{c7} under each dtype from 16 threads: recall
              >= 0.99 against fp64 ground truth over the 600,000 rows, no
              key outside the filter, the merged top 10 equal to the 10
              smallest of the shards' own execute_search replies, the
              dtype's kernel launched on every shard (3 launches for one
              request alone; 3 a filtered request); FT.INFO CLUSTER
              num_docs; FT.AGGREGATE over KNN 100 GROUPBY @cat against
              numpy over the shards' rows. (b) three NodeServers in this
              process (ephemeral ports, gossip every 0.05 s): FT.CREATE over
              the wire, _META.FP equal on all three; 130,000 rows a node
              through each node's Engine (capacity 131,072); KNN 10 over 16
              RESP connections spread over the nodes (1,024 under int8,
              256 under bfloat16) against ClusterClient.ft_search (equal
              replies, near-ties at the 10th rank allowed under int8),
              recall, 3 launches for one request alone; MOVED for a key of
              another node's range; node 2 closed: an error, then with
              search.enable-partial-results the two live shards' merge. (c)
              a node process (python -m
              valkey_search_tpu_torch.cluster.transport, cuda:0 by
              default) as primary with 5,000 rows over the wire and a
              replica in this process: after the full sync and its first
              gossip round FT.SEARCH through the replica counts 5,000 (not
              10,000); the primary SIGKILLed and the replica promoted, it
              counts 5,000, then 5,001 after an HSET; the process is gone.
8. mesh     - parallel/ on a four-shard mesh (make_mesh cycles the visible
              cards: on one card all four shards share cuda:0 and run one
              after another). (a) sharded_flat_topk over the slice's 1M
              corpus (~250,000 rows a shard) at B = 1,024: ids equal to the
              unsharded flat_topk's on >= 99.9% of rows, recall@10 >= 0.999
              against fp64 ground truth, versions' min equal to their max;
              two_stage recall >= 0.99; QPS (median of 5) of each beside the
              unsharded search. (b) sharded_batch_update of 1,024 rows over
              every shard: each new row first for its own query, at a
              distance <= 1e-5 of |q|^2, and the input unchanged;
              consistent_sharded_topk: one stale shard takes 2 snapshots, a
              dead shard with partial_ok returns none of its rows. (c) the
              2 x 2 mesh's replicated_sharded_flat_topk equal to (a)'s exact
              ids. (d) dim_sharded_flat_topk over 4 x 32 columns at B = 256:
              ids equal to the unsharded top-k's but for ties. (e)
              ShardedHnswIndex (M 16, EF_CONSTRUCTION 200) over 65,536 rows
              through add_record, shard sizes those of crc32 % 4;
              search_batch at ef 10, 50 and 100, B = 1,024: recall@10 and
              QPS; behind the seeded @cat:{c7} mask no doc outside; 100
              removed keys never return. (e2) exact_search_batch over
              280,000 rows (each shard's device bulk build, ~70,000 rows, so
              each shard's scan reaches the fused kernels): under int8 and
              bfloat16, unfiltered and behind @cat:{c7}, every shard
              launches K1 or K2, recall@10 >= 0.99 against the unsharded
              fp32 flat_topk, no doc outside the mask. (f)
              sharded_ivf_topk and sharded_ivf_topk_rescored over the ivf
              phase's 10M mirror split four ways (its fp32 rows in slot
              order beside it), probe 16,
              B = 1,024 and 16,384: QPS (median of 5), recall, each shard's
              local time and the merge's (CUDA events), the rescored recall
              >= the single-card ivf_search_rescored's - 0.001. (g)
              entry.dryrun_multichip(4) and entry.entry()'s walk on the card;
9. ivf_streaming - the bench's 100M cell: build_ivf_streaming over 154 chunks
              of 655,360 rows (100,925,440 x 128) generated on the card from
              per-chunk seeded generators (chunk 0 regenerated bit-equal),
              block_rows 1,024, block_align 1,024, timed by stage; exact
              fp32 ground truth of 32 queries from the build's first sight
              of each chunk; the build's peak allocated memory under a third
              of the fp32 corpus's bytes; ivf_search_batch at probe 64, 128
              and 256 and ivf_search_rescored_streaming at 128 and 256, B =
              512 (recall@10 >= 0.99 rescored at 256); the 154 chunks
              regenerated alone (CUDA events). Neither phase launches K1-K3
              but for (e2), whose launches it counts (checked).

The next-to-last line is the card's name and power limit as nvidia-smi gives
them; the line before it the kernels' JSON record; the last line the result.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

D = 128
N_BIG = 1_000_000
N_SMALL = 140_000  # capacity 141,312: the fused scan, span 1 (K1a)
N_CENTERS = 1024
N_CATS = 100
N_WORDS = 40  # the small index's title vocabulary
N_QUERIES = 1024
N_GT = 256
K = 10
RECALL_FLOOR = 0.99
BENCH_TIMEOUT_S = 600  # bench_torch.py --quick, its kernel builds reused
BENCH_LINE_MAX = 1500
THREADS = 16
KERNEL_B = 256
KERNEL_N = 1_048_576
# K1's kernel-phase cases: (B, span, d, kept share of the rows)
K1_CASES = tuple((b, span, 128, 0.95) for span in (1, 8)
                 for b in (1, 7, 64, 256, 1024)) + (
    (1, 1, 128, 0.01), (1, 8, 128, 0.01), (256, 4, 256, 0.95),
    (64, 8, 768, 0.95), (256, 8, 768, 0.95))
# K3's: (B, d), 5% of the rows excluded, negative scores present
K3_CASES = tuple((b, d) for d in (128, 768) for b in (1, 256, 1024))
# K2's kernel-phase cases: (B, positive, d, kept share of the rows)
K2_CASES = ((1, True, 128, 0.95), (7, True, 128, 0.95), (64, True, 128, 0.95),
            (256, True, 128, 0.95), (1024, True, 128, 0.95),
            (1, False, 128, 0.95), (256, False, 128, 0.95),
            (64, True, 768, 0.95), (1, True, 128, 0.01))
QPS_BATCHES = (1024, 16384)
# the bound of a kernel (published H100 SXM peaks):
# device-memory bytes at 3.35 TB/s, dense int8 and bf16 tensor-core peaks
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
BF16_FLOPS_PER_S = 989e12
# batches at which one library call times the scans' product alone
LIBRARY_BATCHES = (256, 1024)
# the HNSW phase: the engine's index (pow2 capacity 131,072), the full-width
# index, the batch and ef values of its searches, the native walk's queries
N_HNSW = 66_000  # the capacity and kernels of 100,000 rows, in less time
N_HNSW_BIG = 300_000  # the capacity (524,288) of 500,000, in less time
HNSW_B = 1024
HNSW_EF = 100
HNSW_EFS = (10, 50, 100)
N_NATIVE = 200
N_SOA = 16  # queries of the engine's inline-filtered (SoA) walk
# iterations between the walk's reads of its done flags, timed in turns
CHECK_EVERY_CASES = (1, 2, 4, 8, 16)
# the engine's walk routes are reported; this floor only catches breakage
HNSW_WALK_FLOOR = 0.9
# the IVF phase: search.ivf-threshold on the slice's 1M FLAT index and on
# the 66k HNSW index (the default is 3,000,000), the engine routes' recall
# floor (8 blocks of ~2,048 cover too little at 1M for 0.99), the returned
# keys deleted there; the full-width FLAT index, generated in seeded chunks
# of IVF_CHUNK rows; its probes, batches and timed repetitions, and the small
# batch's calls profiled one by one; the rows of
# the host-fed build_ivf, how far its recall may lie from
# build_ivf_device's over the same rows, and on how many queries
IVF_FLAT_THRESHOLD = 500_000
IVF_HNSW_THRESHOLD = 50_000
IVF_DEFAULT_THRESHOLD = 3_000_000
IVF_ENGINE_FLOOR = 0.95
IVF_DELETED = 200
N_IVF = 10_000_000
IVF_CHUNK = 1_000_000
IVF_PROBES = (8, 16, 32)
IVF_BATCHES = (1024, 16384)
IVF_REPS = 5
IVF_PROFILED_CALLS = 8
N_IVF_HOST = 1_000_000
IVF_HOST_TOLERANCE = 0.01
# the queries the two builds' recalls are read on: two builds of one corpus
# differ by a few thousandths of recall, and 256 queries read a gap to about
# +-0.004 alone
IVF_HOST_QUERIES = 16_384
# the aggregate phase: neighbours a request aggregates and its queries; the
# rows and writers of the asynchronous ingestion; the keys given a TTL (ms);
# INFO fields in the reference's spelling (valkey_search.cc:93-1006) that
# the port must report, those this phase moves among them
AGG_K = 100
AGG_QUERIES = 256
# (corpus-dtype, search.scan-span, the kernel that serves, recall floor):
# under int8 at 1M rows the scan keeps one survivor per 1,024 rows (span 8,
# 1,024 columns), so of 100 true neighbours the j-th is lost where a nearer
# one shares its column, (j - 1) / 1,024 each, 4.8 in all: 0.95 expected,
# at KNN 100 as in the JAX package. search.scan-span 1 (8,192 columns, as
# bfloat16 has) is the setting for requests that wide, and holds the floor
AGG_CASES = (("int8", 0, "bucket_scan_i8_packed[pre_shift>0]", 0.94),
             ("int8", 1, "bucket_scan_i8_packed[pre_shift=0]", RECALL_FLOOR),
             ("bfloat16", 0, "bucket_scan_bf16", RECALL_FLOOR))
N_ASYNC = 20_000
ASYNC_WRITERS = 4
N_EXPIRE = 100
EXPIRE_MS = 200
INFO_FIELDS = (
    "search_query_queue_size", "search_writer_queue_size",
    "search_worker_pool_suspend_cnt", "search_writer_resumed_cnt",
    "search_reader_resumed_cnt", "search_writer_suspension_expired_cnt",
    "search_rdb_load_success_cnt", "search_rdb_load_failure_cnt",
    "search_rdb_save_success_cnt", "search_rdb_save_failure_cnt",
    "search_successful_requests_count", "search_failure_requests_count",
    "search_hybrid_requests_count", "search_inline_filtering_requests_count",
    "search_hnsw_add_exceptions_count", "search_hnsw_remove_exceptions_count",
    "search_hnsw_modify_exceptions_count",
    "search_hnsw_search_exceptions_count",
    "search_hnsw_create_exceptions_count",
    "search_string_interning_store_size",
    "search_vector_externing_entry_count",
    "search_vector_externing_hash_extern_errors",
    "search_vector_externing_generated_value_cnt",
    "search_vector_externing_num_lru_entries",
    "search_vector_externing_lru_promote_cnt",
    "search_vector_externing_deferred_entry_cnt",
    "search_number_of_attributes", "search_number_of_indexes",
    "search_total_indexed_documents", "search_total_active_write_threads",
    "search_used_memory_bytes", "search_index_reclaimable_memory",
    "search_used_read_cpu", "search_used_write_cpu",
    "search_background_indexing_status", "search_used_memory_human",
    "search_queries_total", "search_vector_queries",
    "search_nonvector_queries", "search_hybrid_queries_prefilter",
    "search_aggregate_queries", "search_aggregate_errors",
    "search_mutations_enqueued", "search_mutations_applied",
    "search_backfilled_records", "search_keyspace_keys",
    "search_mutation_queue_size", "search_used_vector_bytes",
    "search_memory_pool_vector_bytes", "search_memory_pool_tag_bytes",
    "search_memory_pool_numeric_bytes", "search_memory_pool_keyspace_bytes",
    "search_process_rss_bytes", "search_heap_allocated_bytes",
    "search_agg_input_records", "search_agg_output_records",
    "search_agg_group_by_stages", "search_agg_apply_stages",
    "search_agg_filter_stages", "search_agg_sort_by_stages",
    "search_thread_pool_cpu_percent",
)
INFO_MOVED = ("search_queries_total", "search_vector_queries",
              "search_aggregate_queries", "search_agg_group_by_stages",
              "search_agg_apply_stages", "search_agg_filter_stages",
              "search_agg_input_records")
# the server phase's journal index (rows written over the wire, replayed);
# the share of int8 replies that must equal those of another batching (the
# query's int8 scale is its batch's, so a coalesced request may keep
# another coarse survivor at its last ranks)
N_JOURNAL = 5_000
INT8_EQUAL = 0.9
# the cluster phase: three primaries (the smallest cluster of the Valkey
# cluster tutorial) over the first N_CLUSTER rows of the slice's corpus,
# ~200,000 a shard; a socket trio with N_TRIO rows a node; a failover pair
# of N_FAILOVER rows. A FLAT store grows in 2,048-row steps and the fused
# scan serves from capacity 131,072, so a shard needs 129,025 rows or more
# for K1 (span 1 below 524,288: pre_shift 0) and K2 to serve it
N_CLUSTER = 600_000
N_CLUSTER_SHARDS = 3
CLUSTER_QUERIES = 256
N_TRIO = 130_000
N_FAILOVER = 5_000
AGG_CLUSTER_K = 100
# the mesh phase: four shards (on one card all on cuda:0) over the slice's
# 1M corpus, a ShardedHnswIndex the size of the hnsw phase's engine index
# and one of 280,000 rows for its exact scan, and the ivf phase's 10M
# mirror split four ways
MESH_SHARDS = 4
MESH_B = 1024
MESH_DIM_B = 256
MESH_AGREE = 0.999  # rows whose ids equal the unsharded search's
MESH_EXACT_FLOOR = 0.999
N_MESH_HNSW = 65_536
# (e2): ~70,000 rows a shard give each shard's store the capacity 131,072,
# from which its exact scan reaches the fused kernels
N_MESH_EXACT = 280_000
MESH_IVF_PROBE = 16
MESH_IVF_BATCHES = (1024, 16384)
MESH_RESCORED_SLACK = 0.001
# the ivf_streaming phase: the bench's 100M cell (bench.py:918-1060), 154
# chunks of 655,360 rows made on the card, never resident together
N_STREAM_CHUNKS = 154
STREAM_CHUNK = 655_360
STREAM_GT = 32
STREAM_B = 512
STREAM_PROBES = (64, 128, 256)
STREAM_RESCORED_PROBES = (128, 256)
# the build's seed spread on the card: two builds over the first
# SEED_CHUNKS chunks (10.5M rows), at the default seed and the next
SEED_CHUNKS = 16
SEED_BUILDS = (0x1BF, 0x1C0)
SEED_PROBE = 16
IVF_COUNTERS = ("ivf_mirror_builds", "ivf_served_searches",
                "ivf_stage2_grouped", "ivf_stage2_steps")


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(proc.returncode == 0, f"nvidia-smi failed: {proc.stderr.strip()}")
    return proc.stdout.strip().splitlines()[0]


_T0 = time.perf_counter()


def log(msg: str, gpu: str = "") -> None:
    """One line, after the card's name and limit and the seconds since the
    script began."""
    stamp = f"{time.perf_counter() - _T0:.0f}s"
    print(f"[{gpu}; {stamp}] {msg}" if gpu else f"[{stamp}] {msg}",
          flush=True)


# ---------------------------------------------------------------------------
# data: the bench's SIFT-like recipe (byte-valued, 1,024 clusters, seed 42)
# ---------------------------------------------------------------------------


def sift_like(n: int, n_queries: int, seed: int = 42):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((N_CENTERS, D)).astype(np.float32) * 60 + 128
    assign = rng.integers(0, N_CENTERS, size=n)
    corpus = np.clip(
        centers[assign] + rng.standard_normal((n, D)).astype(np.float32) * 20,
        0, 255,
    ).astype(np.float32)
    q_assign = rng.integers(0, N_CENTERS, size=n_queries)
    queries = np.clip(
        centers[q_assign]
        + rng.standard_normal((n_queries, D)).astype(np.float32) * 20,
        0, 255,
    ).astype(np.float32)
    return corpus, queries


def seeded_fields(n: int, seed: int = 7):
    """The 1M index's TAG and NUMERIC values, seeded and independent of the
    vectors: category ids in [0, 100) and prices in [0, 1000)."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, N_CATS, n), rng.integers(0, 1000, n)


def seeded_titles(n: int, seed: int = 11) -> np.ndarray:
    """The small index's titles: 4 words each of a fixed vocabulary (w00 ..
    w39, too short to stem), as word ids [n, 4]."""
    return np.random.default_rng(seed).integers(0, N_WORDS, (n, 4))


def fp64_gt(torch, c64, csq, queries, k: int, device,
            allowed=None) -> np.ndarray:
    """Exact neighbours in float64 on the card (||c||^2 - 2 c.q ordering)
    among the rows ``allowed`` (bool [n]; all rows when None)."""
    bad = None if allowed is None else torch.as_tensor(~allowed, device=device)
    out = []
    for q0 in range(0, len(queries), 64):
        q = torch.as_tensor(queries[q0:q0 + 64], dtype=torch.float64,
                            device=device)
        dd = csq[None, :] - 2.0 * (q @ c64.T)
        if bad is not None:
            dd = dd.masked_fill(bad[None, :], float("inf"))
        out.append(torch.topk(dd, k, largest=False).indices.cpu().numpy())
    return np.concatenate(out)


def recall(ids, gt) -> float:
    """recall@k of ``ids`` (rows of ids or keys) against ``gt`` [n, k]."""
    k = len(gt[0])
    return float(np.mean([
        len(set(list(ids[i])[:k]) & set(list(gt[i]))) / k
        for i in range(len(gt))
    ]))


def time_ms(torch, fn, reps: int = 5) -> float:
    """Mean device time of ``fn`` over ``reps`` calls after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def bound(bytes_moved: float, ops: float, peak: float):
    """(bound_ms, bound_by): the least time the card could take for the
    work, the larger of its bytes over HBM_BYTES_PER_S and its operations
    over ``peak``."""
    by_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    by_ops = ops / peak * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                            "operations")


def library_ms(torch, fn, gpu: str, what: str):
    """Time of one PyTorch call computing the product alone (the yardstick
    for the scans; the port never calls it), or None if it cannot run."""
    try:
        return time_ms(torch, fn, reps=3)
    except (RuntimeError, ValueError) as exc:
        log(f"library call {what} did not run: {exc}", gpu)
        return None


def kernel_phase(torch, bs, dev, gpu: str) -> dict:
    """Each kernel against its plain version on the card; returns per-kernel
    records keyed like bs.LAUNCHES."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    records = {}
    n = KERNEL_N
    n_rows = n - 1000  # the tail is padding: zero rows, SENTINEL bias

    def excluded_rows(kept: float):
        """bool [n]: rows outside a filter that keeps ``kept`` of them, and
        the padded tail."""
        out = torch.rand((n,), generator=gen, device=dev) >= kept
        out[n_rows:] = True
        return out

    corpora = {}

    def int8_corpus(d: int):
        """One seeded int8 corpus per dim, shared by K1's and K3's cases."""
        if d not in corpora:
            corpora.clear()
            torch.cuda.empty_cache()
            corpora[d] = torch.randint(-127, 128, (n_rows, d), generator=gen,
                                       device=dev, dtype=torch.int8)
        return corpora[d]

    library = {}  # torch._int_mm by B: the product of K1 and K3 alone
    # K1 over its grid (K1_CASES): bit-identical keys, kernel and plain
    # times, the share of the bound; B = 1 with 99% excluded is a hybrid
    # request (one launch per request, a 1% filter folded into the bias)
    for b, span, d, kept in K1_CASES:
        q = torch.randint(-127, 128, (b, d), generator=gen, device=dev,
                          dtype=torch.int8)
        c = int8_corpus(d)
        d_pad = bs.round_up(d, 128)
        dotmax, clamp, sentinel, pre_shift, _ = bs.i8_packed_layout(d_pad, span)
        bias = torch.randint(0, clamp, (n,), generator=gen, device=dev,
                             dtype=torch.int32) + dotmax
        bias = torch.where(excluded_rows(kept),
                           torch.full_like(bias, sentinel), bias)
        got = bs.bucket_min_scan_i8_packed(q, c, bias, span)
        torch.cuda.synchronize()
        want = bs.bucket_min_scan_i8_packed_plain(q, c, bias, span)
        torch.cuda.synchronize()
        same = torch.equal(got, want)
        n_bad = int((got != want).sum())
        del got, want
        ms = time_ms(torch, lambda: bs.bucket_min_scan_i8_packed(q, c, bias, span))
        plain_ms = time_ms(
            torch, lambda: bs.bucket_min_scan_i8_packed_plain(q, c, bias, span),
            reps=2)
        bound_ms, bound_by = bound(
            b * d + n_rows * d + 4 * n + 4 * b * n // (128 * span),
            2 * b * n_rows * d, INT8_OPS_PER_S)
        lib = None
        if b in LIBRARY_BATCHES and span == 1 and d == 128:
            lib = library_ms(torch, lambda: torch._int_mm(q, c.t()), gpu,
                             f"torch._int_mm B={b}")
        log(f"K1 span={span} d={d} pre_shift={pre_shift} B={b} "
            f"BQ={bs.k1_query_tile(b, d)} N={n} kept={kept}: bit-identical="
            f"{same} (mismatches {n_bad}), kernel {ms:.4f} ms, plain "
            f"{plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by}), share "
            f"{bound_ms / ms:.3f}"
            + (f", torch._int_mm {lib:.4f} ms" if lib is not None else ""), gpu)
        check(same, f"K1 B={b} span={span} d={d}: {n_bad} keys differ from "
              "plain")
        name = ("bucket_scan_i8_packed[pre_shift=0]" if pre_shift == 0
                else "bucket_scan_i8_packed[pre_shift>0]")
        # the main path's dim (128) at B = 256 is the one recorded; B = 1
        # under a 1% filter (the hybrid request) and B = 1,024 beside it
        if d == 128 and b == KERNEL_B and kept > 0.5:
            records.setdefault(name, {}).update({
                "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "bq": bs.k1_query_tile(b, d)})
        elif d == 128 and b == 1 and kept < 0.5:
            records.setdefault(name, {}).update({
                "ms_b1": ms, "plain_ms_b1": plain_ms, "bound_ms_b1": bound_ms})
        elif d == 128 and b == 1024:
            records.setdefault(name, {}).update({
                "ms_b1024": ms, "plain_ms_b1024": plain_ms,
                "bound_ms_b1024": bound_ms})
        if lib is not None:
            library[b] = lib
        del q, bias
    for name in ("bucket_scan_i8_packed[pre_shift=0]",
                 "bucket_scan_i8_packed[pre_shift>0]"):
        records[name]["library_ms"] = library.get(KERNEL_B)
        records[name]["library_ms_b1024"] = library.get(1024)
    corpora.clear()
    torch.cuda.empty_cache()

    # K2 at the query tiles the wrapper picks for B = 1 .. 1,024 (l2), ip,
    # d 768 (BQ capped by shared memory), and B = 1 with 99% excluded: the
    # hybrid request, whose times are recorded as ms_b1 / plain_ms_b1
    k2_err, by_b, hybrid, k2_lib = 0.0, {}, None, {}
    for b, positive, d, kept in K2_CASES:
        qf = torch.randn((b, d), generator=gen, device=dev)
        cf = torch.randn((n_rows, d), generator=gen, device=dev)
        alpha = -2.0 if positive else -1.0
        q = (qf * alpha).to(torch.bfloat16)
        c = cf.to(torch.bfloat16)
        qsq = ((qf * qf).sum(1) if positive
               else torch.zeros(b, device=dev)).contiguous()
        bias = torch.zeros(n, device=dev)
        bias[:n_rows] = (cf * cf).sum(1) if positive else 0.0
        bias = torch.where(excluded_rows(kept),
                           torch.full_like(bias, float("inf")), bias)
        del qf, cf
        vals, idx = bs.bucket_min_scan(q, qsq, c, bias, positive)
        torch.cuda.synchronize()
        pv, pi = bs.bucket_min_scan_plain(q, qsq, c, bias, positive)
        torch.cuda.synchronize()
        agree = idx == pi
        frac = float(agree.float().mean())
        finite = agree & torch.isfinite(pv)
        err = float((vals - pv).abs()[finite].max())
        inf_ok = bool(torch.equal(torch.isinf(vals[agree]),
                                  torch.isinf(pv[agree])))
        tol_ok = bool(torch.all(
            (vals - pv).abs()[finite] <= 1e-2 + 4e-5 * pv.abs()[finite]))
        del vals, idx, pv, pi, agree, finite
        torch.cuda.empty_cache()
        ms = time_ms(torch, lambda: bs.bucket_min_scan(q, qsq, c, bias,
                                                       positive))
        plain_ms = time_ms(
            torch, lambda: bs.bucket_min_scan_plain(q, qsq, c, bias, positive),
            reps=2)
        bound_ms, bound_by = bound(
            2 * b * d + 4 * b + 2 * n_rows * d + 4 * n + 8 * b * n // 128,
            2 * b * n_rows * d, BF16_FLOPS_PER_S)
        lib = None
        if b in LIBRARY_BATCHES and positive and d == 128 and kept > 0.5:
            lib = library_ms(torch, lambda: q @ c.t(), gpu,
                             f"bf16 q @ c.t() B={b}")
            k2_lib[b] = lib
        log(f"K2 positive={positive} B={b} d={d} BQ={bs.k2_query_tile(b, d)} "
            f"N={n} kept={kept}: idx agree {frac:.6f}, max |dval| {err:.6g} "
            f"where idx agree, kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, "
            f"bound {bound_ms:.4f} ms ({bound_by}), share "
            f"{bound_ms / ms:.3f}"
            + (f", bf16 matmul {lib:.4f} ms" if lib is not None else ""), gpu)
        check(frac >= 0.99, f"K2 B={b} d={d} idx agreement {frac} < 0.99")
        check(tol_ok and inf_ok,
              f"K2 B={b} d={d} vals outside rtol 4e-5, atol 1e-2")
        k2_err = max(k2_err, err)
        if kept < 0.5:  # the hybrid request
            hybrid = (ms, plain_ms, bound_ms)
        elif d == 128 and positive:  # l2 at the main path's dim
            by_b[b] = (ms, plain_ms, bound_ms, bound_by)
        del q, c, bias
        torch.cuda.empty_cache()
    records["bucket_scan_bf16"] = {
        "max_abs_err": k2_err, "ms": by_b[KERNEL_B][0],
        "plain_ms": by_b[KERNEL_B][1], "bound_ms": by_b[KERNEL_B][2],
        "bound_by": by_b[KERNEL_B][3], "library_ms": k2_lib.get(KERNEL_B),
        "bq": bs.k2_query_tile(KERNEL_B, 128),
        "ms_b1": hybrid[0], "plain_ms_b1": hybrid[1], "bound_ms_b1": hybrid[2],
        "ms_b1024": by_b[1024][0], "plain_ms_b1024": by_b[1024][1],
        "bound_ms_b1024": by_b[1024][2], "library_ms_b1024": k2_lib.get(1024)}
    log("K2 (kernel ms, plain ms, bound ms, bound by) by B, l2, d 128, 5% "
        "excluded: " + json.dumps(by_b), gpu)

    # K3 has no search path: its launches here are counted apart from the
    # main path's
    k3_before = bs.launch_counts()["bucket_scan_i8"]
    for b, d in K3_CASES:
        q = torch.randint(-127, 128, (b, d), generator=gen, device=dev,
                          dtype=torch.int8)
        c = int8_corpus(d)
        clamp, sentinel, pre_shift, _ = bs.i8_layout(d)
        # no +DOTMAX offset: small biases make many scores negative
        bias = torch.randint(0, clamp // 64, (n,), generator=gen, device=dev,
                             dtype=torch.int32)
        bias = torch.where(excluded_rows(0.95),
                           torch.full_like(bias, sentinel), bias)
        vals, idx = bs.bucket_min_scan_i8(q, c, bias)
        torch.cuda.synchronize()
        pv, pi = bs.bucket_min_scan_i8_plain(q, c, bias)
        torch.cuda.synchronize()
        same = bool(torch.equal(vals.view(torch.int32), pv.view(torch.int32))
                    and torch.equal(idx, pi))
        n_bad = int((idx != pi).sum()) + int((vals != pv).sum())
        negative = bool((vals < 0).any())
        del vals, idx, pv, pi
        ms = time_ms(torch, lambda: bs.bucket_min_scan_i8(q, c, bias))
        plain_ms = time_ms(
            torch, lambda: bs.bucket_min_scan_i8_plain(q, c, bias), reps=2)
        bound_ms, bound_by = bound(
            b * d + n_rows * d + 4 * n + 8 * b * n // 128,
            2 * b * n_rows * d, INT8_OPS_PER_S)
        log(f"K3 d={d} pre_shift={pre_shift} B={b} BQ="
            f"{bs.k1_query_tile(b, d)} N={n}: bit-identical={same} "
            f"(mismatches {n_bad}), negative scores {negative}, kernel "
            f"{ms:.4f} ms, plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms "
            f"({bound_by}), share {bound_ms / ms:.3f}", gpu)
        check(same, f"K3 B={b} d={d}: {n_bad} vals/idx differ from plain")
        check(negative, f"K3 B={b} d={d}: no negative score exercised")
        if d == 128 and b == KERNEL_B:  # the shape K1's record is taken at
            records["bucket_scan_i8"] = {
                "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": library.get(KERNEL_B),
                "bq": bs.k1_query_tile(b, d)}
        elif d == 128 and b == 1024:
            records["bucket_scan_i8"].update({
                "ms_b1024": ms, "plain_ms_b1024": plain_ms,
                "bound_ms_b1024": bound_ms,
                "library_ms_b1024": library.get(1024)})
        del q, bias
    records["bucket_scan_i8"]["check_launches"] = (
        bs.launch_counts()["bucket_scan_i8"] - k3_before)
    corpora.clear()
    torch.cuda.empty_cache()
    return records


# ---------------------------------------------------------------------------
# phase 4: the slice through Engine.execute
# ---------------------------------------------------------------------------


def ingest(engine, prefix: str, rows: np.ndarray, fields, gpu: str) -> None:
    """HSET every row with its vector and ``fields`` [(name, [str] per
    row)], all in one command per key."""
    t0 = time.perf_counter()
    for i in range(len(rows)):
        argv = ["HSET", f"{prefix}{i}", "v", rows[i].tobytes()]
        for name, values in fields:
            argv += [name, values[i]]
        engine.execute(*argv)
    dt = time.perf_counter() - t0
    log(f"HSET {len(rows)} rows under {prefix!r} (v + "
        f"{', '.join(name for name, _ in fields)}): {dt:.1f} s "
        f"({dt / len(rows) * 1e6:.1f} us/row)", gpu)


def knn(flt: str, k: int = K, ef: int = 0) -> str:
    runtime = f" EF_RUNTIME {ef}" if ef else ""
    return f"{flt}=>[KNN {k} @v $q{runtime}]"


def search_all(engine, index: str, queries: np.ndarray, flt: str = "*",
               ef: int = 0):
    """FT.SEARCH every query from THREADS threads; returns (the keys of
    each reply, per-request latencies in s)."""
    n = len(queries)
    keys = [None] * n
    lat = [0.0] * n
    errors = []

    def worker(tid: int) -> None:
        try:
            for i in range(tid, n, THREADS):
                t0 = time.perf_counter()
                reply = engine.execute(
                    "FT.SEARCH", index, knn(flt, ef=ef), "PARAMS", "2", "q",
                    queries[i].tobytes(), "NOCONTENT", "LIMIT", "0", str(K),
                )
                lat[i] = time.perf_counter() - t0
                keys[i] = reply[1:]
        except Exception as exc:  # reported below; the phase fails
            errors.append(repr(exc))

    threads = [threading.Thread(target=worker, args=(t,))
               for t in range(THREADS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    check(not any(t.is_alive() for t in threads), "FT.SEARCH threads hung")
    check(not errors, f"FT.SEARCH failed: {errors[:3]}")
    return keys, np.asarray(lat)


def key_ids(keys, prefix: str) -> np.ndarray:
    out = np.full((len(keys), K), -1, np.int64)
    for i, row in enumerate(keys):
        for j, key in enumerate(row[:K]):
            out[i, j] = int(key[len(prefix):])
    return out


def run_searches(torch, engine, bs, index, prefix, queries, gt, dtype,
                 expect, gpu: str, stats: dict, flt: str = "*",
                 allowed=None, ef: int = 0, floor: float = RECALL_FLOOR):
    """FT.SEARCH ``queries`` under ``flt`` (with EF_RUNTIME ``ef`` when
    set) from THREADS threads with the launch counts set to 0 just before;
    checks recall against ``gt`` (at least ``floor``), that every kernel in
    ``expect`` launched, and that no key lies outside ``allowed`` (bool [n]
    of the rows the filter qualifies)."""
    engine.config_set("search.corpus-dtype", dtype)
    # publish the mirror for this dtype before counting (not timed)
    engine.execute("FT.SEARCH", index, knn(flt, ef=ef), "PARAMS", "2",
                   "q", queries[0].tobytes(), "NOCONTENT")
    bs.reset_launches()
    keys, lat = search_all(engine, index, queries, flt, ef)
    counts = bs.launch_counts()
    ids = key_ids(keys, prefix)
    r = recall(ids[:len(gt)], gt)
    outside = 0 if allowed is None else int((~allowed[ids[ids >= 0]]).sum())
    p50, p99 = np.percentile(lat, 50) * 1e3, np.percentile(lat, 99) * 1e3
    log(f"FT.SEARCH {index} {knn(flt, ef=ef)!r} corpus-dtype={dtype}: "
        f"{len(queries)} queries from {THREADS} threads, recall@{K} "
        f"{r:.4f} on {len(gt)}, {outside} keys outside the filter, "
        f"p50 {p50:.3f} ms, p99 {p99:.3f} ms, launches {counts}", gpu)
    check(r >= floor, f"{index}/{dtype}/{flt}: recall {r} < {floor}")
    check(outside == 0, f"{index}/{dtype}/{flt}: {outside} keys outside")
    for name, count in counts.items():
        if name in expect:
            check(count > 0, f"{index}/{dtype}/{flt}: {name} never launched")
            stats["launches"][name] = stats["launches"].get(name, 0) + count
    stats[f"{index}/{dtype}/{flt}"] = {"recall": r, "p50_ms": p50,
                                       "p99_ms": p99}
    return keys


def batch_qps(torch, index, queries: np.ndarray, b: int, **search) -> float:
    """search_batch QPS over the first ``b`` queries (``search``: more
    arguments of search_batch, such as ef)."""
    reps = max(1, 8192 // b)
    qs = queries[:b]
    index.search_batch(qs, K, **search)  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        index.search_batch(qs, K, **search)  # host arrays: synchronised
    return reps * b / (time.perf_counter() - t0)


def profile_hybrid(torch, engine, queries: np.ndarray, gpu: str,
                   stats: dict, flt: str = "@cat:{c7}") -> None:
    """Where a hybrid request's time goes, under each dtype: one request at
    a time on the host clock; 128 requests from 16 threads at the default
    GIL switch interval and at 0.1 ms (a convoy on the GIL shows as
    throughput that rises when the interval falls); and torch.profiler over
    10 requests (device time and device operations per request, the
    costliest kernels)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def one(i: int) -> None:
        engine.execute("FT.SEARCH", "idx", knn(flt), "PARAMS", "2", "q",
                       queries[i].tobytes(), "NOCONTENT")

    for dtype in ("int8", "bfloat16"):
        engine.config_set("search.corpus-dtype", dtype)
        one(0)  # publish the mirror for this dtype (not timed)
        lat = []
        for i in range(64):
            t0 = time.perf_counter()
            one(i)
            lat.append(time.perf_counter() - t0)
        rec = {"alone_p50_ms": float(np.percentile(lat, 50)) * 1e3,
               "alone_rps": len(lat) / sum(lat)}
        default = sys.getswitchinterval()
        for interval in (default, 1e-4):
            sys.setswitchinterval(interval)
            try:
                t0 = time.perf_counter()
                _, lat16 = search_all(engine, "idx", queries[:128], flt)
                wall = time.perf_counter() - t0
            finally:
                sys.setswitchinterval(default)
            rec[f"threads16_rps@{interval}"] = 128 / wall
            rec[f"threads16_p50_ms@{interval}"] = (
                float(np.percentile(lat16, 50)) * 1e3)
        reps = 10
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for i in range(reps):
                one(i)
            torch.cuda.synchronize()
        dev_events = [e for e in prof.events()
                      if e.device_type == DeviceType.CUDA
                      and not e.is_user_annotation]
        by_name: dict = {}
        for e in dev_events:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
        rec["device_ms_per_request"] = (
            sum(by_name.values()) / reps / 1e3)
        rec["device_ops_per_request"] = len(dev_events) / reps
        rec["top_device_ms_per_request"] = {
            name[:60]: us / reps / 1e3 for name, us in top}
        log(f"profile {flt!r} corpus-dtype={dtype}: " + json.dumps(rec), gpu)
        stats[f"profile/{dtype}/{flt}"] = rec


def hybrid_mutations(engine, corpus, queries, gpu: str) -> None:
    """Under each dtype: a doc moved from c7 to c8 leaves the c7 KNN and
    joins the c8 one (the tag mask cache on the card); a deleted doc does
    not come back."""
    for j, dtype in enumerate(("int8", "bfloat16")):
        engine.config_set("search.corpus-dtype", dtype)
        q = queries[j].tobytes()

        def c7():
            return engine.execute("FT.SEARCH", "idx", knn("@cat:{c7}"),
                                  "PARAMS", "2", "q", q, "NOCONTENT")[1:]

        moved = c7()[0]
        engine.execute("HSET", moved, "cat", "c8")
        back = moved in c7()
        own = corpus[int(moved[len("doc:"):])].tobytes()
        found = engine.execute("FT.SEARCH", "idx", knn("@cat:{c8}", 1),
                               "PARAMS", "2", "q", own, "NOCONTENT")[1:]
        gone = c7()[0]
        check(engine.execute("DEL", gone) == 1, f"DEL {gone}")
        back_del = gone in c7()
        log(f"hybrid mutations ({dtype}): {moved} moved to c8: in the c7 "
            f"KNN {back}, first of the c8 KNN on its own vector "
            f"{found[:1] == [moved]}; {gone} deleted: in the c7 KNN "
            f"{back_del}", gpu)
        check(not back, f"{moved} moved to c8 still in the c7 KNN ({dtype})")
        check(found[:1] == [moved], f"{moved} not found under c8 ({dtype})")
        check(not back_del, f"deleted {gone} returned ({dtype})")


# ---------------------------------------------------------------------------
# the aggregate phase: FT.AGGREGATE, asynchronous ingestion, the keyspace
# surface and the observability commands, on the slice's 1M index
# ---------------------------------------------------------------------------


def execute_all(engine, argvs, senders=None):
    """Send every argv through Engine.execute from THREADS threads, or from
    one thread for each callable of ``senders`` (a RESP connection's cmd);
    returns (the replies, per-request latencies in s, the wall time in s)."""
    senders = senders or [engine.execute] * THREADS
    n = len(argvs)
    replies = [None] * n
    lat = [0.0] * n
    errors = []

    def worker(tid: int) -> None:
        try:
            for i in range(tid, n, len(senders)):
                t0 = time.perf_counter()
                replies[i] = senders[tid](*argvs[i])
                lat[i] = time.perf_counter() - t0
        except Exception as exc:  # reported below; the phase fails
            errors.append(repr(exc))

    threads = [threading.Thread(target=worker, args=(t,))
               for t in range(len(senders))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    wall = time.perf_counter() - t0
    check(not any(t.is_alive() for t in threads), "request threads hung")
    check(not errors, f"requests failed: {errors[:3]}")
    return replies, np.asarray(lat), wall


def rows_of(reply) -> list:
    """An FT.AGGREGATE reply's rows as dicts."""
    return [dict(zip(row[::2], row[1::2])) for row in reply[1:]]


def check_groups(reply, ids: np.ndarray, cats, prices, what: str) -> None:
    """``reply`` of ... GROUPBY @cat REDUCE COUNT AS n, AVG @price AS p,
    SORTBY @n DESC (the 10 largest groups) against numpy over rows ``ids``."""
    want = {}
    for c in np.unique(cats[ids]):
        sel = ids[cats[ids] == c]
        want[f"c{c}"] = (len(sel), float(prices[sel].mean()))
    rows = rows_of(reply)
    counts = [float(r["n"]) for r in rows]
    check(reply[0] == len(rows) == min(10, len(want)),
          f"{what}: {len(rows)} groups of {len(want)}")
    check(counts == sorted(counts, reverse=True), f"{what}: not sorted by n")
    largest = sorted((n for n, _ in want.values()), reverse=True)[:len(rows)]
    check(counts == [float(n) for n in largest],
          f"{what}: counts {counts} are not the largest {largest}")
    for r in rows:
        n, p = want.get(r["cat"], (None, None))
        check(n is not None and float(r["n"]) == n
              and abs(float(r["p"]) - p) <= 1e-12 * max(1.0, abs(p)),
              f"{what}: group {r} against numpy's {(n, p)}")


def aggregate_knn(bs, engine, queries, cats, prices, agg_filters, gt_agg,
                  launches: dict, gpu: str) -> dict:
    """FT.AGGREGATE over KNN AGG_K, unfiltered and behind each filter, under
    each of AGG_CASES, AGG_QUERIES requests from THREADS threads each."""
    out = {}
    qs = queries[:AGG_QUERIES]

    def params(q):
        return ("PARAMS", "2", "q", q.tobytes())

    for dtype, scan_span, kernel, floor in AGG_CASES:
        engine.config_set("search.corpus-dtype", dtype)
        engine.config_set("search.scan-span", str(scan_span))
        for (flt, allowed), gt in zip(agg_filters, gt_agg):
            if floor < RECALL_FLOOR and allowed is not None:
                continue  # the case below the floor: unfiltered alone
            query = knn(flt, AGG_K)
            # the port's own top AGG_K, by FT.SEARCH (also publishes the
            # mirror for this dtype before the counted run)
            found, _, _ = execute_all(engine, [
                ("FT.SEARCH", "idx", query, *params(q), "NOCONTENT", "LIMIT",
                 "0", str(AGG_K)) for q in qs])
            ids = [np.array([int(k[len("doc:"):]) for k in r[1:]], np.int64)
                   for r in found]
            r = float(np.mean([len(set(ids[i]) & set(gt[i])) / AGG_K
                               for i in range(len(qs))]))
            if allowed is None:
                stages = ("LOAD", "2", "@cat", "@price", "GROUPBY", "1",
                          "@cat", "REDUCE", "COUNT", "0", "AS", "n", "REDUCE",
                          "AVG", "1", "@price", "AS", "p", "SORTBY", "2",
                          "@n", "DESC")
            else:
                stages = ("LOAD", "3", "@__key", "@cat", "@price", "APPLY",
                          "@price * 2", "AS", "p2", "FILTER", "@price < 50")
            bs.reset_launches()
            replies, lat, wall = execute_all(engine, [
                ("FT.AGGREGATE", "idx", query, *params(q), *stages)
                for q in qs])
            counts = bs.launch_counts()
            check(counts[kernel] > 0,
                  f"FT.AGGREGATE {flt} ({dtype}): {kernel} never launched")
            _merge_launches(launches, {kernel: counts[kernel]})
            exact = outside = 0
            for i, reply in enumerate(replies):
                same = set(ids[i]) == set(gt[i])
                exact += same
                what = f"FT.AGGREGATE {flt} ({dtype}) query {i}"
                if allowed is None:
                    if same:
                        check_groups(reply, gt[i], cats, prices, what)
                    continue
                rows = rows_of(reply)
                docs = np.array([int(r["__key"][len("doc:"):]) for r in rows],
                                np.int64)
                outside += int((~allowed[docs]).sum())
                check(all(float(r["price"]) < 50
                          and float(r["p2"]) == 2 * float(r["price"])
                          and float(r["price"]) == prices[d]
                          and r["cat"] == f"c{cats[d]}"
                          for r, d in zip(rows, docs)),
                      f"{what}: APPLY / FILTER rows wrong")
                check(set(docs) <= set(ids[i]), f"{what}: rows outside the "
                      "request's own KNN")
                if same:
                    kept = gt[i][prices[gt[i]] < 50]
                    check(reply[0] == len(kept) and set(docs) == set(kept),
                          f"{what}: {reply[0]} rows, numpy {len(kept)}")
            rec = {"recall": r, "exact_sets": int(exact), "outside": outside,
                   "rps": len(qs) / wall,
                   "p50_ms": float(np.percentile(lat, 50)) * 1e3,
                   "p99_ms": float(np.percentile(lat, 99)) * 1e3,
                   "launches": {kernel: counts[kernel]}}
            out[f"{dtype}/span={scan_span}/{flt}"] = rec
            log(f"FT.AGGREGATE idx {query!r} corpus-dtype={dtype} scan-span="
                f"{scan_span}: {len(qs)} requests from {THREADS} threads: "
                + json.dumps(rec), gpu)
            check(r >= floor, f"FT.AGGREGATE {flt} ({dtype}, span "
                  f"{scan_span}): recall@{AGG_K} {r} < {floor}")
            check(outside == 0, f"FT.AGGREGATE {flt} ({dtype}): {outside} "
                  "rows outside the filter")
            check(exact > 0 or floor < RECALL_FLOOR,
                  f"FT.AGGREGATE {flt} ({dtype}): no request's top {AGG_K} "
                  "was the exact set, nothing compared")
    engine.config_set("search.scan-span", "0")
    return out


def aggregate_columnar(bs, engine, cats, prices, gpu: str) -> dict:
    """GROUPBY @cat + COUNT over the rows of @price:[0 99] by the columnar
    route (TagIndex.value_counts: no keyspace fetch, no scan launch), against
    np.unique; the same request by the per-row route, taken because an HSET
    lands between its search and its count; and each route timed."""
    from valkey_search_tpu_torch.runtime.metrics import STATS
    from valkey_search_tpu_torch.server import ft_aggregate as agg

    argv = ("FT.AGGREGATE", "idx", "@price:[0 99]", "GROUPBY", "1", "@cat",
            "REDUCE", "COUNT", "0", "AS", "n")
    sel = prices < 100
    want = {f"c{c}": int(n) for c, n in zip(*np.unique(cats[sel],
                                                       return_counts=True))}
    index = engine.manager.get("idx").attribute("cat").index
    columnar_calls = []
    real = index.value_counts
    index.value_counts = lambda docs: (columnar_calls.append(len(docs)),
                                       real(docs))[1]

    def groups(reply):
        return {r["cat"]: int(r["n"]) for r in rows_of(reply)}

    def timed_ms(reps: int = 3):
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            reply = engine.execute(*argv)
            times.append((time.perf_counter() - t0) * 1e3)
        return reply, sorted(times)

    # a non-vector search fetches at most this many rows (default 10,000):
    # raised over the filter's ~100,000 for this request, then put back
    cap_option = "search.max-non-vector-search-results-fetched"
    cap_before = engine.config_get(cap_option)
    engine.config_set(cap_option, str(N_BIG))
    try:
        stages0 = STATS.get("agg_group_by_stages")
        bs.reset_launches()
        reply, columnar_ms = timed_ms()
        check(groups(reply) == want and reply[0] == len(want),
              "columnar GROUPBY differs from np.unique")
        check(len(columnar_calls) == 3 and columnar_calls[0] == int(sel.sum()),
              f"the columnar route was not taken ({columnar_calls})")
        check(STATS.get("agg_group_by_stages") == stages0 + 3,
              "agg_group_by_stages did not rise")
        check(sum(bs.launch_counts().values()) == 0,
              "a scan launched under a non-vector FT.AGGREGATE")
        # an HSET between the search and the count: the epoch check of
        # _engine_quiescent sends the request down the per-row route
        stop = threading.Event()
        key = "doc:0"
        fields = ("cat", f"c{cats[0]}", "price", str(prices[0]))

        def writer():
            while not stop.is_set():
                engine.execute("HSET", key, *fields)

        t = threading.Thread(target=writer)
        t.start()
        try:
            per_row = None
            for attempt in range(20):
                before = len(columnar_calls)
                reply = engine.execute(*argv)
                check(groups(reply) == want, "GROUPBY under writes differs "
                      "from np.unique")
                if len(columnar_calls) == before:
                    per_row = attempt + 1
                    break
        finally:
            stop.set()
            t.join(60)
        check(per_row is not None, "no request took the per-row route while "
              "HSETs landed")
        # the per-row route alone, timed with the columnar plan set aside
        plan = agg._columnar_groupby_index
        agg._columnar_groupby_index = lambda schema, spec: None
        try:
            reply, generic_ms = timed_ms()
        finally:
            agg._columnar_groupby_index = plan
        check(groups(reply) == want, "per-row GROUPBY differs from np.unique")
    finally:
        del index.value_counts
        engine.config_set(cap_option, str(cap_before))
    rec = {"rows": int(sel.sum()), "groups": len(want),
           "columnar_ms": columnar_ms, "per_row_ms": generic_ms,
           "per_row_under_writes_after_requests": per_row}
    log("FT.AGGREGATE idx '@price:[0 99]' GROUPBY @cat COUNT: "
        + json.dumps(rec), gpu)
    return rec


def async_ingestion(torch, corpus, queries, cats, gpu: str) -> dict:
    """N_ASYNC rows through Engine(sync_ingest=False) from ASYNC_WRITERS
    threads and drain(), against a synchronous engine over the same rows:
    KNN 10 keys equal; an index created after the data, backfilled by cron()
    ticks, equal too; mutation_queue_size above 0 while loading and 0
    after."""
    from valkey_search_tpu_torch.server.engine import Engine

    rows, rcats = corpus[:N_ASYNC], cats[:N_ASYNC]
    qs = queries[:AGG_QUERIES]
    create = ("ON", "HASH", "PREFIX", "1", "a:", "SCHEMA", "v", "VECTOR",
              "FLAT", "6", "TYPE", "FLOAT32", "DIM", str(D),
              "DISTANCE_METRIC", "L2", "cat", "TAG")

    def hset(engine, i: int) -> None:
        engine.execute("HSET", f"a:{i}", "v", rows[i].tobytes(), "cat",
                       f"c{rcats[i]}")

    def knn_keys(engine, index: str) -> list:
        replies, _, _ = execute_all(engine, [
            ("FT.SEARCH", index, knn("*"), "PARAMS", "2", "q", q.tobytes(),
             "NOCONTENT") for q in qs])
        return [set(r[1:]) for r in replies]

    def queue_size(engine) -> int:
        info = engine.execute("FT.INFO", "aidx")
        return info[info.index("mutation_queue_size") + 1]

    sync = Engine()
    check(sync.execute("FT.CREATE", "aidx", *create) == "OK", "FT.CREATE aidx")
    t0 = time.perf_counter()
    for i in range(N_ASYNC):
        hset(sync, i)
    sync_s = time.perf_counter() - t0
    want = knn_keys(sync, "aidx")

    engine = Engine(sync_ingest=False)
    check(engine.execute("FT.CREATE", "aidx", *create) == "OK",
          "FT.CREATE aidx (asynchronous)")
    # an asynchronous engine leaves a new index's backfill to the cron: over
    # the empty keyspace one tick ends it
    engine.cron()
    check(not engine.manager.get("aidx").backfill_in_progress,
          "aidx: the backfill of an empty keyspace did not end")
    seen = []
    errors = []

    def writer(tid: int) -> None:
        try:
            for i in range(tid, N_ASYNC, ASYNC_WRITERS):
                hset(engine, i)
                if i % 8192 < ASYNC_WRITERS:  # each writer, every 8,192 rows
                    seen.append(queue_size(engine))
        except Exception as exc:  # reported below; the phase fails
            errors.append(repr(exc))

    threads = [threading.Thread(target=writer, args=(t,))
               for t in range(ASYNC_WRITERS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    accepted_s = time.perf_counter() - t0
    check(not any(t.is_alive() for t in threads) and not errors,
          f"asynchronous HSETs failed: {errors[:3]}")
    engine.drain()
    applied_s = time.perf_counter() - t0
    # with the writers parked, 8 rewrites must stand in the queue (the
    # samples above read it under load, where it may be empty at times)
    check(engine._ingestion.suspend(), "the writer pool did not park")
    for i in range(8):
        hset(engine, i)
    held = queue_size(engine)
    engine._ingestion.resume()
    engine.drain()
    check(held == 8, f"mutation_queue_size {held} with 8 writes held")
    after = queue_size(engine)
    info = engine.execute("FT.INFO", "aidx")
    check(info[info.index("num_docs") + 1] == N_ASYNC,
          "asynchronous engine: num_docs after drain()")
    got = knn_keys(engine, "aidx")
    differ = sum(g != w for g, w in zip(got, want))

    # an index created after the data: cron() advances the backfill
    engine.execute("FT.CREATE", "bidx", *create)
    schema = engine.manager.get("bidx")
    check(schema.backfill_in_progress, "bidx: no backfill pending")
    t0 = time.perf_counter()
    ticks = backfilled = 0
    while schema.backfill_in_progress:
        backfilled += engine.cron()["backfilled"]
        engine.drain()
        ticks += 1
        check(ticks < 1000, "the backfill never ended")
    backfill_s = time.perf_counter() - t0
    differ_backfill = sum(g != w for g, w in zip(knn_keys(engine, "bidx"),
                                                 want))
    rec = {"rows": N_ASYNC, "writers": ASYNC_WRITERS,
           "sync_hsets_per_s": N_ASYNC / sync_s,
           "async_accepted_hsets_per_s": N_ASYNC / accepted_s,
           "async_applied_hsets_per_s": N_ASYNC / applied_s,
           "queue_size_seen_max": max(seen), "queue_size_held": held,
           "queue_size_after": after,
           "knn_sets_differing": differ, "backfill_ticks": ticks,
           "backfilled": backfilled, "backfill_s": backfill_s,
           "knn_sets_differing_after_backfill": differ_backfill}
    log("asynchronous ingestion: " + json.dumps(rec), gpu)
    check(after == 0, f"mutation_queue_size {after} after drain()")
    check(differ == 0, f"{differ} of {len(qs)} KNN replies differ from the "
          "synchronous engine's")
    check(backfilled == N_ASYNC and differ_backfill == 0,
          f"backfill: {backfilled} rows, {differ_backfill} replies differ")
    engine._ingestion.shutdown()
    del sync, engine
    torch.cuda.empty_cache()
    return rec


def expiry_and_transactions(engine, corpus, queries, gpu: str) -> dict:
    """On the 1M index: PEXPIRE on N_EXPIRE returned keys, after the deadline
    none returns from KNN or FT.AGGREGATE, before or after cron(); HDEL of
    the vector field removes the row; a multi() of 10 HSETs is seen whole
    (and deleted again)."""
    qs = queries[:AGG_QUERIES]

    def search(q, k=K):
        return engine.execute("FT.SEARCH", "idx", knn("*", k), "PARAMS", "2",
                              "q", q.tobytes(), "NOCONTENT", "LIMIT", "0",
                              str(k))[1:]

    def aggregated(q):
        reply = engine.execute("FT.AGGREGATE", "idx", knn("*"), "PARAMS", "2",
                               "q", q.tobytes(), "LOAD", "1", "@__key")
        return [r["__key"] for r in rows_of(reply)]

    # the first hits of the first N_EXPIRE queries, distinct
    doomed, probes = [], []
    for q in qs:
        top = search(q, 1)[0]
        if top not in doomed:
            doomed.append(top)
            probes.append(q)
        if len(doomed) == N_EXPIRE:
            break
    check(len(doomed) == N_EXPIRE, f"only {len(doomed)} distinct first hits")
    for key in doomed:
        check(engine.execute("PEXPIRE", key, str(EXPIRE_MS)) == 1,
              f"PEXPIRE {key}")
    check(0 < engine.execute("TTL", doomed[-1]) <= EXPIRE_MS / 1e3, "TTL")
    time.sleep(EXPIRE_MS / 1e3 + 0.05)
    gone = set(doomed)
    # no sweep yet: content resolution drops the expired keys it meets
    # (half of them here; the cron sweeps the rest)
    back = sum(1 for q in probes[::4] for k in search(q) if k in gone)
    back += sum(1 for q in probes[1::4] for k in aggregated(q) if k in gone)
    swept = engine.cron()["expired"]
    check(swept > 0, "cron() swept no expired key")
    back_after = sum(1 for q in probes for k in search(q) if k in gone)
    back_after += sum(1 for q in probes for k in aggregated(q) if k in gone)
    check(back == 0 and back_after == 0,
          f"expired keys returned: {back} before cron(), {back_after} after")
    check(not engine._expiry and engine.execute("EXISTS", *doomed) == 0,
          "expired keys left behind")

    # HDEL of the vector field: the key stays, its row leaves the KNN
    victim = search(qs[-1], 1)[0]
    own = corpus[int(victim[len("doc:"):])]
    check(engine.execute("HDEL", victim, "v") == 1, f"HDEL {victim} v")
    hits = search(own)
    check(victim not in hits and engine.execute("EXISTS", victim) == 1
          and engine.execute("HGET", victim, "v") is None,
          f"HDEL: {victim} still returned, or gone from the keyspace")
    engine.execute("HSET", victim, "v", own.tobytes())
    check(search(own, 1) == [victim], "HSET after HDEL: the row is not back")

    # a transaction of 10 HSETs around one probe, seen whole
    probe = queries[-11]
    keys = [f"doc:{N_BIG + j}" for j in range(10)]
    tx = engine.multi()
    for j, key in enumerate(keys):
        vec = probe.copy()
        vec[0] += j * 1e-3
        tx.hset(key, {"v": vec.tobytes(), "cat": "c7", "price": "1"})
    check(tx.exec() == 10, "multi(): exec count")
    hits = search(probe)
    check(set(hits) == set(keys), f"multi(): KNN 10 returned {hits}")
    check(engine.execute("DEL", *keys) == 10, "DEL of the transaction's keys")
    rec = {"expired": len(doomed), "swept_by_cron": swept,
           "returned_before_cron": back, "returned_after_cron": back_after}
    log("expiry, HDEL and multi() on idx: " + json.dumps(rec), gpu)
    return rec


def observability(engine, queries, before: dict, gpu: str) -> dict:
    """INFO holds the reference's field names and counters that moved since
    ``before``; FT._DEBUG PROFILE writes a non-empty trace of one KNN batch."""
    engine.config_set("search.debug-mode", "yes")  # developer fields too
    info = engine.execute("INFO")
    missing = [f for f in INFO_FIELDS if f not in info]
    check(not missing, f"INFO lacks {missing}")
    errors = [f for f, v in info.items() if v == "<error>"]
    check(not errors, f"INFO fields failed to render: {errors}")
    moved = {f: info[f] - before[f] for f in INFO_MOVED}
    check(all(v > 0 for v in moved.values()), f"INFO counters {moved}")
    check(info["search_number_of_indexes"] == 1
          and info["search_total_indexed_documents"] >= N_BIG - N_EXPIRE - 1,
          "INFO index gauges")
    out_dir = tempfile.mkdtemp(prefix="ft_debug_profile_")
    try:
        check(engine.execute("FT._DEBUG", "PROFILE", "START", out_dir) == "OK",
              "FT._DEBUG PROFILE START")
        index = engine.manager.get("idx").attribute("v").index
        index.search_batch(queries[:N_QUERIES], K)
        check(engine.execute("FT._DEBUG", "PROFILE", "STOP") == "OK",
              "FT._DEBUG PROFILE STOP")
        traces = os.listdir(out_dir)
        size = sum(os.path.getsize(os.path.join(out_dir, t)) for t in traces)
        with open(os.path.join(out_dir, traces[0])) as f:
            text = f.read()
        check(len(traces) == 1 and size > 1000, f"PROFILE wrote {traces}")
        check("scan_bf16" in text or "scan_i8" in text,
              "PROFILE's trace does not hold the scan kernel")
    finally:
        engine.config_set("search.debug-mode", "no")
        shutil.rmtree(out_dir, ignore_errors=True)
    rec = {"info_fields": len(info), "moved": moved, "trace_bytes": size}
    log("INFO and FT._DEBUG PROFILE: " + json.dumps(rec), gpu)
    return rec


def aggregate_phase(torch, bs, gpu: str, engine, corpus, queries, cats,
                    prices, agg_filters, gt_agg, launches: dict) -> dict:
    info0 = engine.info(include_dev=True)
    out = {"knn": aggregate_knn(bs, engine, queries, cats, prices,
                                agg_filters, gt_agg, launches, gpu)}
    out["columnar"] = aggregate_columnar(bs, engine, cats, prices, gpu)
    out["observability"] = observability(engine, queries, info0, gpu)
    out["expiry"] = expiry_and_transactions(engine, corpus, queries, gpu)
    out["async"] = async_ingestion(torch, corpus, queries, cats, gpu)
    return out


# ---------------------------------------------------------------------------
# the server phase: the RESP server over the slice's 1M index, SAVE and a
# timed restore, BGSAVE by fork with the CUDA context live, the op journal
# ---------------------------------------------------------------------------


class ReplyError(RuntimeError):
    pass


class Resp:
    """A minimal binary-safe RESP2/RESP3 client (the card's machine has no
    redis client): one connection, one reply per ``cmd``; an error reply
    raises ``ReplyError``."""

    def __init__(self, port: int):
        import socket

        self.sock = socket.create_connection(("127.0.0.1", port), timeout=300)
        self.f = self.sock.makefile("rwb")

    def close(self) -> None:
        try:
            self.f.close()
        finally:
            self.sock.close()

    def cmd(self, *argv):
        out = [b"*%d\r\n" % len(argv)]
        for a in argv:
            a = a.encode() if isinstance(a, str) else bytes(a)
            out.append(b"$%d\r\n%s\r\n" % (len(a), a))
        self.f.write(b"".join(out))
        self.f.flush()
        reply = self.read()
        if isinstance(reply, ReplyError):
            raise reply
        return reply

    def pipeline(self, argvs) -> list:
        """Send every argv, then read every reply; an error reply raises."""
        for argv in argvs:
            out = [b"*%d\r\n" % len(argv)]
            for a in argv:
                a = a.encode() if isinstance(a, str) else bytes(a)
                out.append(b"$%d\r\n%s\r\n" % (len(a), a))
            self.f.write(b"".join(out))
        self.f.flush()
        replies = [self.read() for _ in argvs]
        errors = [r for r in replies if isinstance(r, ReplyError)]
        if errors:
            raise errors[0]
        return replies

    def read(self):
        line = self.f.readline()
        if not line:
            raise EOFError("connection closed")
        kind, rest = line[:1], line[1:-2]
        if kind == b"+":
            return rest.decode()
        if kind == b"-":
            return ReplyError(rest.decode())
        if kind == b":":
            return int(rest)
        if kind == b"$":
            n = int(rest)
            return None if n < 0 else self.f.read(n + 2)[:-2]
        if kind in (b"*", b">"):
            return [self.read() for _ in range(int(rest))]
        if kind == b"%":
            return {self.read(): self.read() for _ in range(int(rest))}
        if kind == b"_":
            return None
        if kind == b",":
            return float(rest)
        if kind == b"#":
            return rest == b"t"
        raise ReplyError(f"unknown reply {line!r}")


def _text(v):
    return v.decode() if isinstance(v, bytes) else v


def _knn_argv(index: str, flt: str, q: np.ndarray, k: int = K):
    return ("FT.SEARCH", index, knn(flt, k), "PARAMS", "2", "q", q.tobytes(),
            "RETURN", "1", "__v_score")


def _keys_dists(reply):
    """(keys, distances) of a KNN reply with RETURN 1 __v_score."""
    keys = [_text(k) for k in reply[1::2]]
    return keys, [float(_text(row[1])) for row in reply[2::2]]


def knn_all(engine, queries: np.ndarray, flt: str = "*", conns=None):
    """FT.SEARCH idx KNN 10 for every query through Engine.execute from
    THREADS threads, or over ``conns``, one thread each; returns (each
    reply's (keys, distances), per-request latencies in s, wall s)."""
    replies, lat, wall = execute_all(
        engine, [_knn_argv("idx", flt, q) for q in queries],
        conns and [c.cmd for c in conns])
    return [_keys_dists(r) for r in replies], lat, wall


def same_replies(got, want, queries, what: str,
                 min_equal: float = 1.0) -> dict:
    """Each request's reply against ``want``'s. A distance is ||q||^2 +
    ||c||^2 - 2 q.c in f32 whose product a batch of another size may round
    otherwise, so a key both replies hold has the same distance within 1e-5
    of ||q||^2 (the bound the slice's update check uses), and a reply is
    equal when its keys are in the same order, or when its distances are
    the same within twice that bound (keys that tie within rounding, in
    another order or across the k-th rank). At least ``min_equal`` of the
    requests are equal: 1 under bfloat16; under int8 the query's
    quantization scale is its batch's (in both packages), so a request
    coalesced with others may keep another coarse survivor at its last
    ranks. Fails otherwise."""
    equal = ties = differ = 0
    first = None
    for i, ((gk, gd), (wk, wd)) in enumerate(zip(got, want)):
        tol = 1e-5 * float(queries[i] @ queries[i])
        for key in set(gk) & set(wk):
            check(abs(gd[gk.index(key)] - wd[wk.index(key)]) <= tol,
                  f"{what}: request {i}: {key} at {gd[gk.index(key)]} != "
                  f"{wd[wk.index(key)]}")
        if gk == wk:
            equal += 1
        elif len(gd) == len(wd) and np.allclose(sorted(gd), sorted(wd),
                                                rtol=0, atol=2 * tol):
            ties += 1
        else:
            differ += 1
            first = first or {"request": i, "keys": gk, "dists": gd,
                              "want_keys": wk, "want_dists": wd}
    share = (equal + ties) / len(want)
    check(share >= min_equal, f"{what}: {differ} of {len(want)} replies "
          f"differ ({share:.4f} equal, at least {min_equal} wanted; the "
          f"first {first})")
    return {"equal": equal, "ties": ties, "differ": differ}


def counted(bs, launches: dict, fn):
    """Run ``fn`` with the launch counts set to 0 just before; add the
    counts read just after into ``launches``; returns (fn's value, counts)."""
    bs.reset_launches()
    value = fn()
    counts = bs.launch_counts()
    _merge_launches(launches, counts)
    return value, counts


def wire_phase(torch, bs, gpu, srv, engine, conns, queries, cats, gt,
               launches: dict) -> dict:
    """KNN over 16 RESP connections under int8 (K1b) and bfloat16 (K2):
    equal to Engine.execute, recall, coalesced launches, a hybrid filter;
    then RESP3, EVAL and MULTI/EXEC."""
    out = {}
    qs = queries[:N_QUERIES]
    kernels = (("int8", "bucket_scan_i8_packed[pre_shift>0]"),
               ("bfloat16", "bucket_scan_bf16"))
    for dtype, kernel in kernels:
        engine.config_set("search.corpus-dtype", dtype)
        engine.execute(*_knn_argv("idx", "*", qs[0]))  # publish (not timed)
        (wire, lat, wall), counts = counted(
            bs, launches, lambda: knn_all(engine, qs, conns=conns))
        n_launch = sum(counts.values())
        (want, dlat, dwall), _ = counted(
            bs, launches, lambda: knn_all(engine, qs))
        same = same_replies(wire, want, qs, f"wire/{dtype}",
                            INT8_EQUAL if dtype == "int8" else 1.0)
        r = recall([keys for keys, _ in wire[:len(gt)]], gt)
        (hyb, _, _), hcounts = counted(
            bs, launches, lambda: knn_all(engine, qs[:N_GT], "@cat:{c7}",
                                          conns))
        outside = sum(1 for keys, _ in hyb for key in keys
                      if cats[int(key[4:])] != 7)
        mirror = engine.manager.get("idx").attribute("v").index.store._device
        rec = {"i8_scale": float(mirror["i8_scale"]) if dtype == "int8"
               else None,
               "requests_per_s": len(qs) / wall,
               "p50_ms": float(np.percentile(lat, 50) * 1e3),
               "p99_ms": float(np.percentile(lat, 99) * 1e3),
               "execute_requests_per_s": len(qs) / dwall,
               "execute_p50_ms": float(np.percentile(dlat, 50) * 1e3),
               "execute_p99_ms": float(np.percentile(dlat, 99) * 1e3),
               "recall": r, "launches": n_launch, "same": same,
               "hybrid_outside": outside, "replies": want}
        log(f"RESP {dtype}: {len(qs)} KNN 10 over {len(conns)} connections "
            f"{rec['requests_per_s']:.1f} requests/s, p50 "
            f"{rec['p50_ms']:.3f} ms, p99 {rec['p99_ms']:.3f} ms (Engine."
            f"execute from {THREADS} threads: "
            f"{rec['execute_requests_per_s']:.1f} requests/s, p50 "
            f"{rec['execute_p50_ms']:.3f} ms, p99 "
            f"{rec['execute_p99_ms']:.3f} ms); replies equal to execute's "
            f"{same}; recall@{K} {r:.4f}; {n_launch} scan launches "
            f"{counts}; @cat:{{c7}} over the wire: {outside} keys outside, "
            f"launches {hcounts}", gpu)
        check(counts.get(kernel, 0) > 0, f"wire/{dtype}: {kernel} idle")
        check(n_launch < len(qs), f"wire/{dtype}: {n_launch} launches for "
              f"{len(qs)} requests: the batcher did not coalesce")
        check(r >= RECALL_FLOOR, f"wire/{dtype}: recall {r}")
        check(outside == 0, f"wire/{dtype}: {outside} keys outside c7")
        out[dtype] = rec

    # RESP3: HELLO 3 answers a map; the same search, the same reply
    c3 = Resp(srv.port)
    try:
        hello = c3.cmd("HELLO", "3")
        got3 = _keys_dists(c3.cmd(*_knn_argv("idx", "*", qs[0])))
    finally:
        c3.close()
    check(isinstance(hello, dict) and hello.get(b"proto") == 3,
          f"HELLO 3: {hello}")
    check(got3 == out["bfloat16"]["replies"][0], "RESP3 reply differs")

    # EVAL: a script that HSETs a key and runs a KNN; the index sees the
    # script's writes when it ends (as EXEC's, in both packages), so the
    # next script's KNN finds the key first, at distance 0
    c = conns[0]
    key, probe = f"doc:{N_BIG + 1}", queries[-3]
    script = ("redis.call('HSET', KEYS[1], 'v', ARGV[1], 'cat', 'c7', "
              "'price', '1')\nreturn redis.call('FT.SEARCH', 'idx', "
              "'*=>[KNN 10 @v $q]', 'PARAMS', '2', 'q', ARGV[1], 'RETURN', "
              "'1', '__v_score')")
    inside, _ = _keys_dists(c.cmd("EVAL", script, "1", key, probe.tobytes()))
    after, dist = _keys_dists(c.cmd(
        "EVAL", "return redis.call('FT.SEARCH', 'idx', '*=>[KNN 10 @v $q]',"
        " 'PARAMS', '2', 'q', ARGV[1], 'RETURN', '1', '__v_score')", "0",
        probe.tobytes()))
    log(f"EVAL: HSET {key} + KNN in one script: key in its KNN {key in inside}"
        f"; the next script's KNN: {after[0]} at {dist[0]}", gpu)
    check(key not in inside, "EVAL: a script's KNN saw its own write")
    check(after[0] == key and abs(dist[0]) <= 1e-5 * float(probe @ probe),
          f"EVAL: {key} not first at distance 0 ({after[0]}, {dist[0]})")

    # MULTI/EXEC of 10 HSETs and one FT.SEARCH: seen whole after EXEC
    tx = [f"doc:{N_BIG + 10 + j}" for j in range(10)]
    check(c.cmd("MULTI") == "OK", "MULTI")
    for j, k in enumerate(tx):
        c.cmd("HSET", k, "v", queries[-4 - j].tobytes(), "cat", "srvtx",
              "price", "1")
    c.cmd("FT.SEARCH", "idx", "@cat:{srvtx}", "NOCONTENT")
    res = c.cmd("EXEC")
    seen = c.cmd("FT.SEARCH", "idx", "@cat:{srvtx}", "NOCONTENT")
    log(f"MULTI/EXEC: 10 HSETs {res[:10]}, the FT.SEARCH inside saw "
        f"{res[10][0]}, after EXEC {seen[0]}", gpu)
    check(res[:10] == [3] * 10 and res[10][0] == 0 and seen[0] == 10,
          f"MULTI/EXEC not seen whole: {res}, {seen[0]}")
    check(c.cmd("DEL", key, *tx) == 11, "DEL of the EVAL and MULTI keys")
    return out


class _RssPeak:
    """The peak resident set of this process while the block runs, sampled
    every 10 ms from /proc/self/statm."""

    def __enter__(self):
        self._page = os.sysconf("SC_PAGE_SIZE")
        self.before = self.peak = self._rss()
        self._stop = threading.Event()
        self._t = threading.Thread(target=self._run, daemon=True)
        self._t.start()
        return self

    def _rss(self) -> int:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * self._page

    def _run(self) -> None:
        while not self._stop.wait(0.01):
            self.peak = max(self.peak, self._rss())

    def __exit__(self, *exc):
        self._stop.set()
        self._t.join(5)
        self.peak = max(self.peak, self._rss())


def timed_load(path: str):
    """Engine.load with its stages timed (keyspace decode, non-vector
    replay, vector sections; the rest is reading the file and creating the
    schemas) and the peak RSS while it runs; returns (engine, record)."""
    from valkey_search_tpu_torch.persistence import checkpoint as ck
    from valkey_search_tpu_torch.server.engine import Engine

    stages = {"keyspace_decode_s": 0.0, "nonvector_replay_s": 0.0,
              "vector_sections_s": 0.0}
    names = {"_decode_keyspace": "keyspace_decode_s",
             "_replay_nonvector": "nonvector_replay_s",
             "_restore_vector_attr": "vector_sections_s"}
    real = {name: getattr(ck, name) for name in names}

    def timer(name):
        def run(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return real[name](*args, **kwargs)
            finally:
                stages[names[name]] += time.perf_counter() - t0
        return run

    for name in names:
        setattr(ck, name, timer(name))
    try:
        with _RssPeak() as rss:
            t0 = time.perf_counter()
            engine = Engine.load(path)
            total = time.perf_counter() - t0
    finally:
        for name, fn in real.items():
            setattr(ck, name, fn)
    rec = dict(stages, load_s=total,
               read_and_other_s=total - sum(stages.values()),
               rss_before_gib=rss.before / 2**30,
               rss_peak_gib=rss.peak / 2**30)
    return engine, rec


def save_phase(torch, bs, gpu, engine, conns, queries, gt, tmp, wire,
               launches: dict) -> dict:
    """SAVE over the wire, Engine.load timed by stage with the peak RSS, the
    first KNN after the restore (full publish and quantize), and the
    restored engine's replies against the saved engine's."""
    path = os.path.join(tmp, "ckpt.vstpu")
    t0 = time.perf_counter()
    check(conns[0].cmd("SAVE", path) == "OK", "SAVE")
    out = {"save_s": time.perf_counter() - t0,
           "file_gib": os.path.getsize(path) / 2**30}
    restored, out["restore"] = timed_load(path)
    log(f"SAVE {out['save_s']:.2f} s, {out['file_gib']:.3f} GiB; Engine.load "
        f"{out['restore']}", gpu)
    info = [e.execute("FT.INFO", "idx") for e in (engine, restored)]
    docs = [i[i.index("num_docs") + 1] for i in info]
    sample = [f"doc:{i}" for i in np.random.default_rng(3).choice(
        N_BIG, 100, replace=False)]
    diff = sum(engine.execute("HGETALL", k) != restored.execute("HGETALL", k)
               for k in sample)
    log(f"restored num_docs {docs[1]} (saved {docs[0]}); HGETALL of 100 "
        f"sampled keys: {diff} differ", gpu)
    check(docs[0] == docs[1] and diff == 0, "restored keyspace differs")
    st = restored.manager.get("idx").attribute("v").index.store
    check(st._device is None, "a restored store holds a device mirror")
    qs = queries[:N_QUERIES]
    for dtype, kernel in (("int8", "bucket_scan_i8_packed[pre_shift>0]"),
                          ("bfloat16", "bucket_scan_bf16")):
        engine.config_set("search.corpus-dtype", dtype)
        t0 = time.perf_counter()
        restored.execute(*_knn_argv("idx", "*", qs[0]))
        first_ms = (time.perf_counter() - t0) * 1e3
        check(st._device["vectors"].device.type == "cuda",
              "the restore did not publish to the card")
        (got, _, wall), counts = counted(
            bs, launches, lambda: knn_all(restored, qs))
        check(counts.get(kernel, 0) > 0, f"restored/{dtype}: {kernel} idle")
        r = recall([keys for keys, _ in got[:len(gt)]], gt)
        rec = {"first_knn_ms": first_ms, "requests_per_s": len(qs) / wall,
               "recall": r}
        if dtype == "int8":
            scales = (float(st._device["i8_scale"]), wire["int8"]["i8_scale"])
            rec["i8_scales"] = scales
            equal_scale = scales[0] == scales[1]
        if dtype == "bfloat16" or equal_scale:
            rec["same"] = same_replies(
                got, wire[dtype]["replies"], qs, f"restored/{dtype}",
                INT8_EQUAL if dtype == "int8" else 1.0)
        log(f"restored {dtype}: first KNN (publish"
            f"{' + quantize' if dtype == 'int8' else ''}) {first_ms:.1f} ms; "
            f"{len(qs)} KNN from {THREADS} threads "
            f"{rec['requests_per_s']:.1f} requests/s, recall@{K} {r:.4f}, "
            f"replies against the saved engine's {rec.get('same')}"
            + (f"; scales {rec['i8_scales']}" if dtype == "int8" else ""),
            gpu)
        check(r >= RECALL_FLOOR, f"restored/{dtype}: recall {r}")
        out[dtype] = rec
    del restored, st
    torch.cuda.empty_cache()
    os.remove(path)
    return out


def bgsave_phase(torch, bs, gpu, srv, engine, conns, corpus, queries, tmp,
                 launches: dict) -> dict:
    """BGSAVE by fork while the 16 connections keep searching and a 17th
    keeps writing: the child's status, its wall time, the parent's searches
    during it, and the file's point in time (a key written after BGSAVE
    returned is absent, a key from before is present)."""
    from valkey_search_tpu_torch.persistence import checkpoint as ck
    from valkey_search_tpu_torch.persistence.format import ChunkReader

    path = os.path.join(tmp, "bg.vstpu")
    qs = queries[:N_QUERIES]
    stop, errors = threading.Event(), []
    served = [0] * len(conns)
    written = []

    def searcher(tid: int) -> None:
        try:
            i = tid
            while not stop.is_set():
                conns[tid].cmd(*_knn_argv("idx", "*", qs[i % len(qs)]))
                served[tid] += 1
                i += len(conns)
        except Exception as exc:  # reported below; the phase fails
            errors.append(repr(exc))

    def writer() -> None:
        w = Resp(srv.port)
        try:
            j = 0
            while not stop.is_set():
                key = f"doc:{N_BIG + 100 + j}"
                w.cmd("HSET", key, "v", (corpus[j] + 0.5).tobytes(),
                      "cat", "c1", "price", "5")
                written.append(key)
                j += 1
        except Exception as exc:  # reported below; the phase fails
            errors.append(repr(exc))
        finally:
            w.close()

    engine.config_set("search.corpus-dtype", "bfloat16")
    c = Resp(srv.port)
    threads = [threading.Thread(target=searcher, args=(i,))
               for i in range(len(conns))] + [threading.Thread(target=writer)]
    bs.reset_launches()
    for th in threads:
        th.start()
    try:
        deadline = time.monotonic() + 60
        while sum(served) < 4 * len(conns) or len(written) < 16:
            check(time.monotonic() < deadline and not errors,
                  f"traffic did not start: {errors[:3]}")
            time.sleep(0.01)
        pre_key = written[0]
        t0 = time.perf_counter()
        reply = c.cmd("BGSAVE", path)
        post_key = f"doc:{N_BIG + 99}"
        c.cmd("HSET", post_key, "v", queries[-20].tobytes(), "cat", "c1")
        at_fork, writes_at_fork = sum(served), len(written)
        while srv.bgsave_status == "in-progress":
            check(time.perf_counter() - t0 < 600, "BGSAVE child hung")
            time.sleep(0.01)
        child_s = time.perf_counter() - t0
        during = sum(served) - at_fork
        writes_during = len(written) - writes_at_fork
        time.sleep(0.2)  # the parent serves on after the child
    finally:
        stop.set()
        for th in threads:
            th.join(120)
    counts = bs.launch_counts()
    _merge_launches(launches, counts)
    after = sum(served) - at_fork - during
    check(not errors, f"traffic during BGSAVE failed: {errors[:3]}")
    check(reply == "Background saving started", f"BGSAVE: {reply}")
    log(f"BGSAVE by fork: status {srv.bgsave_status}, child {child_s:.2f} s; "
        f"the parent served {during} KNN and {writes_during} HSETs during it"
        f" ({during / child_s:.1f} KNN/s) and {after} after; launches "
        f"{counts}", gpu)
    check(srv.bgsave_status == "ok", f"BGSAVE child: {srv.bgsave_status}")
    check(during > 0 and after > 0, "the parent stopped serving")
    check(counts.get("bucket_scan_bf16", 0) > 0, "no K2 launch during BGSAVE")
    # the file read whole to its end marker, its keyspace decoded (a full
    # Engine.load of the same format is timed in the SAVE step above)
    t0 = time.perf_counter()
    tracked = None
    with ChunkReader(path) as reader:
        for meta, arrays in reader.sections():
            if meta["type"] == "keyspace":
                snap = ck._decode_keyspace(arrays[0])
            elif meta["type"] == "vector":
                tracked = meta["tracked_count"]
    read_s = time.perf_counter() - t0
    pre = snap.get(pre_key)
    log(f"bg.vstpu read in {read_s:.1f} s: {len(snap)} keys, {tracked} "
        f"vectors; pre-fork {pre_key} {'present' if pre else 'absent'}, "
        f"post-fork {post_key} {'present' if post_key in snap else 'absent'}",
        gpu)
    check(pre is not None and pre == engine.keyspace.get(pre_key),
          "pre-fork key lost")
    check(post_key not in snap, "post-fork key in the snapshot")
    del snap
    os.remove(path)
    check(c.cmd("DEL", post_key, *written) == len(written) + 1, "DEL writes")
    c.close()
    return {"child_s": child_s, "served_during": during,
            "writes_during": writes_during, "served_after": after,
            "knn_per_s_during": during / child_s, "read_s": read_s}


def journal_phase(gpu, corpus, queries, cats, tmp) -> dict:
    """search.journal-path and search.checkpoint-path set: N_JOURNAL rows over
    the wire with a SAVE half way, a DEL and an EXPIRE; the server closes
    and a new one boots over a fresh engine (checkpoint + journal replay),
    answering the same FT.SEARCH replies with the TTL rebased."""
    from valkey_search_tpu_torch.persistence.journal import read_records
    from valkey_search_tpu_torch.runtime import config
    from valkey_search_tpu_torch.server.engine import Engine
    from valkey_search_tpu_torch.server.resp import RespServer

    n = N_JOURNAL
    names = ("search.journal-path", "search.checkpoint-path")
    saved = {name: config.get(name) for name in names}
    jdir = os.path.join(tmp, "journal")
    os.makedirs(jdir)
    config.set_config("search.journal-path", os.path.join(jdir, "ops.journal"))
    config.set_config("search.checkpoint-path", os.path.join(jdir, "c.vstpu"))
    probes = [("*", q) for q in queries[:48]] + [
        ("@cat:{c7}", q) for q in queries[48:64]]
    try:
        srv = RespServer(Engine(), port=0).start()
        c = Resp(srv.port)
        try:
            c.cmd("FT.CREATE", "jidx", "ON", "HASH", "PREFIX", "1", "j:",
                  "SCHEMA", "v", "VECTOR", "FLAT", "6", "TYPE", "FLOAT32",
                  "DIM", str(D), "DISTANCE_METRIC", "L2", "cat", "TAG")
            t0 = time.perf_counter()
            for i in range(n):
                if i == n // 2:
                    check(c.cmd("SAVE") == "OK", "SAVE (journal)")
                c.cmd("HSET", f"j:{i}", "v", corpus[i].tobytes(),
                      "cat", f"c{cats[i]}")
            write_s = time.perf_counter() - t0
            check(c.cmd("DEL", "j:3") == 1 and c.cmd("EXPIRE", "j:4",
                                                     "1000") == 1, "DEL")
            before = [_keys_dists(c.cmd(*_knn_argv("jidx", f, q)))
                      for f, q in probes]
        finally:
            c.close()
            srv.close()
        records = sum(1 for _ in read_records(
            os.path.join(jdir, "ops.journal")))
        t0 = time.perf_counter()
        srv = RespServer(Engine(), port=0).start()
        boot_s = time.perf_counter() - t0
        c = Resp(srv.port)
        try:
            after = [_keys_dists(c.cmd(*_knn_argv("jidx", f, q)))
                     for f, q in probes]
            ttl = float(_text(c.cmd("TTL", "j:4")))
            gone = c.cmd("EXISTS", "j:3")
            count = c.cmd("FT.SEARCH", "jidx", "*", "NOCONTENT", "LIMIT",
                          "0", "0")[0]
        finally:
            c.close()
            srv.close()
    finally:
        for name, value in saved.items():
            config.set_config(name, value)
    log(f"journal: {n} HSETs over the wire in {write_s:.2f} s (SAVE half "
        f"way; {records} records left in the journal); boot (checkpoint"
        f" + replay) {boot_s:.2f} s; {count} docs; "
        f"{sum(a == b for a, b in zip(after, before))} of {len(probes)} "
        f"replies equal; j:3 exists {gone}; TTL of j:4 "
        f"{ttl:.3f} s", gpu)
    check(count == n - 1 and gone == 0, "journal replay lost a write")
    check(after == before, "replies after the replay differ")
    check(990 < ttl <= 1000, f"TTL not rebased: {ttl}")
    return {"hset_s": write_s, "boot_s": boot_s, "records": records,
            "ttl": ttl}


def server_phase(torch, bs, gpu, engine, corpus, queries, cats,
                 launches: dict) -> dict:
    from valkey_search_tpu_torch.server.resp import RespServer

    # the ground truth over the rows live now (the aggregate phase expired,
    # deleted and rewrote some of the first queries' neighbours), as keys
    index = engine.manager.get("idx").attribute("v").index
    gt = live_gt_keys(torch, index, queries[:N_GT], index.store.device)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_server_")
    out = {}
    try:
        srv = RespServer(engine, port=0).start()
        conns = [Resp(srv.port) for _ in range(THREADS)]
        try:
            wire = wire_phase(torch, bs, gpu, srv, engine, conns, queries,
                              cats, gt, launches)
            out["save"] = save_phase(torch, bs, gpu, engine, conns, queries,
                                     gt, tmp, wire, launches)
            out["bgsave"] = bgsave_phase(torch, bs, gpu, srv, engine, conns,
                                         corpus, queries, tmp, launches)
        finally:
            for conn in conns:
                conn.close()
            srv.close()
        for rec in wire.values():
            rec.pop("replies")
        out["wire"] = wire
        out["journal"] = journal_phase(gpu, corpus, queries, cats, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def slice_phase(torch, bs, dev, gpu: str, keep: dict) -> dict:
    """Phase 4 and the phases inside it; ``keep`` receives the corpus, the
    queries and the tags, which the cluster phase reuses."""
    from valkey_search_tpu_torch.server.engine import Engine

    stats = {"launches": {}}
    t0 = time.perf_counter()
    corpus, queries = sift_like(N_BIG, N_QUERIES + 16384)
    cats, prices = seeded_fields(N_BIG)
    keep.update(corpus=corpus, queries=queries, cats=cats)
    small = corpus[:N_SMALL]
    titles = seeded_titles(N_SMALL)
    log(f"data: {N_BIG} x {D} corpus + {len(queries)} queries in "
        f"{time.perf_counter() - t0:.1f} s", gpu)
    qs = queries[:N_QUERIES]
    qs_gt = queries[:N_GT]
    filters = [  # (filter, the rows it qualifies)
        ("@cat:{c7}", cats == 7),
        ("@price:[0 99]", prices < 100),
        ("@price:[0 499]", prices < 500),
        ("(@cat:{c7} @price:[0 499])", (cats == 7) & (prices < 500)),
    ]
    text_filter = ("@title:w07", (titles == 7).any(axis=1))
    c64 = torch.as_tensor(corpus, dtype=torch.float64, device=dev)
    csq = (c64 * c64).sum(1)
    gt_big = fp64_gt(torch, c64, csq, qs_gt, K, dev)
    gt_filtered = [fp64_gt(torch, c64, csq, qs_gt, K, dev, allowed)
                   for _, allowed in filters]
    # the aggregate phase's: the top AGG_K, unfiltered and under the ~1%
    # tag and ~10% price filters
    agg_filters = [("*", None)] + filters[:2]
    gt_agg = [fp64_gt(torch, c64, csq, queries[:AGG_QUERIES], AGG_K, dev,
                      allowed) for _, allowed in agg_filters]
    gt_small = fp64_gt(torch, c64[:N_SMALL], csq[:N_SMALL], qs_gt, K, dev)
    gt_text = fp64_gt(torch, c64[:N_SMALL], csq[:N_SMALL], qs_gt, K, dev,
                      text_filter[1])
    del c64, csq
    torch.cuda.empty_cache()
    for (flt, allowed) in filters + [text_filter]:
        log(f"filter {flt!r} qualifies {int(allowed.sum())} of "
            f"{len(allowed)} rows ({allowed.mean():.4f})", gpu)

    engine = Engine()
    check(engine.execute(
        "FT.CREATE", "idx", "ON", "HASH", "PREFIX", "1", "doc:", "SCHEMA",
        "v", "VECTOR", "FLAT", "6", "TYPE", "FLOAT32", "DIM", str(D),
        "DISTANCE_METRIC", "L2", "cat", "TAG", "price", "NUMERIC") == "OK",
        "FT.CREATE idx")
    ingest(engine, "doc:", corpus,
           [("cat", [f"c{c}" for c in cats]),
            ("price", [str(p) for p in prices])], gpu)
    info = engine.execute("FT.INFO", "idx")
    check(info[info.index("num_docs") + 1] == N_BIG, "FT.INFO num_docs")
    attrs = {a[3]: a for a in info[info.index("attributes") + 1]}
    check(all(attrs[name][7] == N_BIG for name in ("v", "cat", "price")),
          f"FT.INFO attributes {attrs}")

    k1_fused = "bucket_scan_i8_packed[pre_shift=0]"
    k1_shift = "bucket_scan_i8_packed[pre_shift>0]"
    k2 = "bucket_scan_bf16"
    run_searches(torch, engine, bs, "idx", "doc:", qs, gt_big, "int8",
                 {k1_shift}, gpu, stats)
    keys_bf16 = run_searches(torch, engine, bs, "idx", "doc:", qs, gt_big,
                             "bfloat16", {k2}, gpu, stats)

    index = engine.manager.get("idx").attribute("v").index
    for dtype in ("int8", "bfloat16"):
        engine.config_set("search.corpus-dtype", dtype)
        for b in QPS_BATCHES:
            qps = batch_qps(torch, index, queries, b)
            log(f"search_batch idx corpus-dtype={dtype} B={b}: "
                f"{qps:.1f} QPS", gpu)
            stats[f"qps/{dtype}/B={b}"] = qps

    # hybrid KNN: one search_batch launch per request, the filter's mask
    # folded into the scan's bias
    for dtype, kernel in (("int8", k1_shift), ("bfloat16", k2)):
        for (flt, allowed), gt in zip(filters, gt_filtered):
            run_searches(torch, engine, bs, "idx", "doc:", qs_gt, gt, dtype,
                         {kernel}, gpu, stats, flt=flt, allowed=allowed)
    profile_hybrid(torch, engine, qs_gt, gpu, stats)

    # non-vector queries resolve on the host
    reply = engine.execute("FT.SEARCH", "idx", "@cat:{c7}", "LIMIT", "0",
                           "10", "NOCONTENT")
    want = int((cats == 7).sum())
    log(f"FT.SEARCH idx '@cat:{{c7}}' LIMIT 0 10: total {reply[0]} "
        f"(numpy {want}), {len(reply) - 1} keys", gpu)
    check(reply[0] == want and len(reply) == 11, "@cat:{c7} count")
    reply = engine.execute("FT.SEARCH", "idx", "@price:[0 99]", "SORTBY",
                           "price", "RETURN", "1", "price")
    got = [float(row[1]) for row in reply[2::2]]
    log(f"FT.SEARCH idx '@price:[0 99]' SORTBY price: total {reply[0]}, "
        f"prices {got}", gpu)
    check(len(got) == 10 and got == sorted(got)
          and all(0 <= p <= 99 for p in got), "SORTBY price")

    t_agg = time.perf_counter()
    stats["aggregate"] = aggregate_phase(
        torch, bs, gpu, engine, corpus, queries, cats, prices, agg_filters,
        gt_agg, stats["launches"])
    log(f"aggregate phase {time.perf_counter() - t_agg:.1f} s", gpu)
    t_srv = time.perf_counter()
    stats["server"] = server_phase(torch, bs, gpu, engine, corpus, queries,
                                   cats, stats["launches"])
    log(f"server phase {time.perf_counter() - t_srv:.1f} s", gpu)

    # DEL 1,000 returned keys; none may come back under either dtype
    # (of those the aggregate phase's expiry left in the keyspace)
    deleted = [key for key in dict.fromkeys(
        key for row in keys_bf16 for key in row)
        if engine.execute("EXISTS", key)][:1000]
    check(len(deleted) == 1000, f"only {len(deleted)} distinct keys returned")
    check(engine.execute("DEL", *deleted) == len(deleted), "DEL count")
    gone = set(deleted)
    for dtype in ("bfloat16", "int8"):
        engine.config_set("search.corpus-dtype", dtype)
        keys, _ = search_all(engine, "idx", qs)
        back = sum(1 for row in keys for key in row if key in gone)
        log(f"after DEL of {len(gone)} keys, corpus-dtype={dtype}: "
            f"{back} deleted keys returned", gpu)
        check(back == 0, f"{back} deleted keys returned ({dtype})")
        # updated vector: found first, at distance 0 up to f32 rounding
        target = f"doc:{N_BIG - 1}"
        probe = queries[-1 if dtype == "int8" else -2]
        engine.execute("HSET", target, "v", probe.tobytes())
        reply = engine.execute(
            "FT.SEARCH", "idx", knn("*"), "PARAMS", "2", "q",
            probe.tobytes(), "RETURN", "1", "__v_score")
        dist = float(reply[2][1])
        log(f"updated {target} ({dtype}): top hit {reply[1]} at {dist}", gpu)
        check(reply[1] == target, f"updated vector not found first ({dtype})")
        check(abs(dist) <= 1e-5 * float(probe @ probe),
              f"updated vector at distance {dist}, not 0 ({dtype})")
    hybrid_mutations(engine, corpus, queries, gpu)
    # (a) IVF through the engine on this index, its rows as they are now
    stats["ivf_route"] = ivf_engine_route(
        torch, bs, engine, "idx", qs, live_gt_keys(torch, index, qs, dev),
        queries[-7], IVF_FLAT_THRESHOLD, k1_shift, gpu)

    check(engine.execute(
        "FT.CREATE", "small", "ON", "HASH", "PREFIX", "1", "small:", "SCHEMA",
        "v", "VECTOR", "FLAT", "6", "TYPE", "FLOAT32", "DIM", str(D),
        "DISTANCE_METRIC", "L2", "title", "TEXT") == "OK", "FT.CREATE small")
    ingest(engine, "small:", small,
           [("title", [" ".join(f"w{w:02d}" for w in row) for row in titles])],
           gpu)
    tier = ("native" if engine.manager.get("small").text_engine._nt
            is not None else "python")
    log(f"text tier serving 'small': {tier}", gpu)
    stats["text_tier"] = tier
    run_searches(torch, engine, bs, "small", "small:", qs, gt_small, "int8",
                 {k1_fused}, gpu, stats)
    run_searches(torch, engine, bs, "small", "small:", qs_gt, gt_text, "int8",
                 {k1_fused}, gpu, stats, flt=text_filter[0],
                 allowed=text_filter[1])
    return stats


# ---------------------------------------------------------------------------
# phase 5: HNSW, through Engine.execute and at full width at the index level
# ---------------------------------------------------------------------------


def _merge_launches(into: dict, launches: dict) -> None:
    for name, count in launches.items():
        into[name] = into.get(name, 0) + count


def hnsw_engine(torch, bs, dev, gpu: str, corpus, queries, cats,
                stats: dict) -> None:
    """(a) FT.CREATE ... VECTOR HNSW (M 16, EF_CONSTRUCTION 200) + TAG,
    N_HNSW HSETs (native inserts), FT.SEARCH KNN 10 EF_RUNTIME 100 from 16
    threads on the scan route (pow2 capacity 131,072: K1 at pre_shift 0,
    K2), hybrid, DEL and update; then search.hnsw-scan-threshold 0, where
    the graph walk serves: the AoS walk unfiltered, the filtered SoA walk
    under (-@cat:{c7}) (~99% qualify: inline), and the exact scan under
    @cat:{c7} (~1%: pre-filtered). Each route is checked by its counters."""
    from valkey_search_tpu_torch.runtime.metrics import STATS
    from valkey_search_tpu_torch.server.engine import Engine

    n, ef = N_HNSW, HNSW_EF
    rows, hcats = corpus[:n], cats[:n]
    qs, qs_gt = queries[:N_QUERIES], queries[:N_GT]
    c7 = hcats == 7
    c64 = torch.as_tensor(rows, dtype=torch.float64, device=dev)
    csq = (c64 * c64).sum(1)
    gt = fp64_gt(torch, c64, csq, qs_gt, K, dev)
    gt_c7 = fp64_gt(torch, c64, csq, qs_gt, K, dev, c7)
    k1_fused = "bucket_scan_i8_packed[pre_shift=0]"
    k2 = "bucket_scan_bf16"

    engine = Engine()
    check(engine.execute(
        "FT.CREATE", "hidx", "ON", "HASH", "PREFIX", "1", "h:", "SCHEMA",
        "v", "VECTOR", "HNSW", "10", "TYPE", "FLOAT32", "DIM", str(D),
        "DISTANCE_METRIC", "L2", "M", "16", "EF_CONSTRUCTION", "200",
        "cat", "TAG") == "OK", "FT.CREATE hidx")
    t0 = time.perf_counter()
    ingest(engine, "h:", rows, [("cat", [f"c{c}" for c in hcats])], gpu)
    stats["hset_us"] = (time.perf_counter() - t0) / n * 1e6
    info = engine.execute("FT.INFO", "hidx")
    attrs = {a[3]: a for a in info[info.index("attributes") + 1]}
    check(attrs["v"][5] == "HNSW" and attrs["v"][7] == n,
          f"FT.INFO hidx {attrs['v']}")
    index = engine.manager.get("hidx").attribute("v").index
    check(index.store.capacity == 131072, "hidx capacity")

    def routed(flt, dtype, gt_, expect, allowed=None, floor=RECALL_FLOOR):
        rec = {"launches": {}}
        keys = run_searches(torch, engine, bs, "hidx", "h:",
                            qs if flt == "*" else qs_gt[:len(gt_)], gt_,
                            dtype, expect, gpu, rec, flt=flt,
                            allowed=allowed, ef=ef, floor=floor)
        _merge_launches(stats["launches"], rec.pop("launches"))
        return keys, next(iter(rec.values()))

    # the scan route (search.hnsw-scan-threshold defaults to 2^30)
    _, stats["scan/int8"] = routed("*", "int8", gt, {k1_fused})
    keys_bf16, stats["scan/bfloat16"] = routed("*", "bfloat16", gt, {k2})
    for dtype, kernel in (("int8", k1_fused), ("bfloat16", k2)):
        _, stats[f"scan/{dtype}/@cat:{{c7}}"] = routed(
            "@cat:{c7}", dtype, gt_c7, {kernel}, allowed=c7)

    # DEL 1,000 returned keys: none comes back; an updated vector is first
    # (and is then set back, so the ground truth below holds)
    deleted = list(dict.fromkeys(k for row in keys_bf16 for k in row))[:1000]
    check(len(deleted) == 1000, f"only {len(deleted)} distinct keys")
    check(engine.execute("DEL", *deleted) == 1000, "DEL count (hidx)")
    gone = set(deleted)
    target = next(f"h:{i}" for i in range(n - 1, 0, -1)
                  if f"h:{i}" not in gone)
    probe = queries[-3]
    engine.execute("HSET", target, "v", probe.tobytes())
    for dtype in ("bfloat16", "int8"):
        engine.config_set("search.corpus-dtype", dtype)
        keys, _ = search_all(engine, "hidx", qs, ef=ef)
        back = sum(1 for row in keys for key in row if key in gone)
        reply = engine.execute("FT.SEARCH", "hidx", knn("*", ef=ef),
                               "PARAMS", "2", "q", probe.tobytes(),
                               "RETURN", "1", "__v_score")
        log(f"hidx after DEL of 1000 ({dtype}): {back} deleted keys "
            f"returned; updated {target}: top hit {reply[1]} at "
            f"{reply[2][1]}", gpu)
        check(back == 0, f"{back} deleted keys returned (hidx, {dtype})")
        check(reply[1] == target and abs(float(reply[2][1]))
              <= 1e-5 * float(probe @ probe), f"updated {target} not first")
    engine.execute("HSET", target, "v", rows[int(target[2:])].tobytes())

    # the graph walk serves: each route checked by its counters
    live = np.ones(n, bool)
    live[[int(k[2:]) for k in deleted]] = False
    engine.config_set("search.hnsw-scan-threshold", "0")
    engine.config_set("search.corpus-dtype", "int8")
    for flt, allowed, route in (("*", live, "aos"),
                                ("(-@cat:{c7})", live & ~c7, "soa"),
                                ("@cat:{c7}", live & c7, "scan")):
        # an inline-filtered request walks alone (seconds each from 16
        # threads), so that route answers N_SOA queries
        n_q = N_SOA if route == "soa" else len(qs_gt)
        gt_w = fp64_gt(torch, c64, csq, qs_gt[:n_q], K, dev, allowed)
        before = {name: STATS.get(name) for name in (
            "hnsw_searches", "hnsw_served_by_scan",
            "vector_searches_prefiltered", "vector_searches_inline_filtered")}
        _, rec = routed(flt, "int8", gt_w,
                        {k1_fused} if route == "scan" else set(),
                        allowed=allowed, floor=HNSW_WALK_FLOOR)
        moved = {name: STATS.get(name) - v for name, v in before.items()}
        rec["counters"] = moved
        stats[f"walk/{route}/{flt}"] = rec
        log(f"hidx route {route} under {flt!r}: counters {moved}", gpu)
        check(moved["hnsw_served_by_scan"] == 0, f"{route}: served by scan")
        if route == "scan":
            check(moved["hnsw_searches"] == 0
                  and moved["vector_searches_prefiltered"] > 0,
                  f"{flt}: not the pre-filtered scan")
        else:
            check(moved["hnsw_searches"] >= min(n_q, len(qs_gt)),
                  f"{flt}: no walk")
        if route == "aos":
            check(index._aos_tables is not None, "the AoS mirror not built")
        if route == "soa":
            check(moved["vector_searches_inline_filtered"] > 0,
                  f"{flt}: not inline")
    stats["restore"] = hnsw_restore(torch, engine, qs, gpu)
    engine.config_set("search.hnsw-scan-threshold", str(1 << 30))
    # (a) IVF through the engine on this index: its live rows are nodes
    gt_live = fp64_gt(torch, c64, csq, qs, K, dev, live)
    stats["ivf_route"] = ivf_engine_route(
        torch, bs, engine, "hidx", qs, [[f"h:{i}" for i in row]
                                        for row in gt_live],
        queries[-9], IVF_HNSW_THRESHOLD, k1_fused, gpu, ef=ef)
    del c64, csq, engine, index
    torch.cuda.empty_cache()


def hnsw_restore(torch, engine, qs, gpu: str) -> dict:
    """SAVE and restore the HNSW engine: the graph is imported (no
    re-insert), and with search.hnsw-scan-threshold 0 the walk at EF_RUNTIME
    HNSW_EF returns the same ids as before the save on the same queries."""
    from valkey_search_tpu_torch.server.engine import Engine

    engine.config_set("search.hnsw-scan-threshold", "0")
    engine.config_set("search.corpus-dtype", "int8")
    index = engine.manager.get("hidx").attribute("v").index
    _, before = index.search_batch(qs[:N_GT], K, ef=HNSW_EF)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_hnsw_")
    try:
        path = os.path.join(tmp, "hnsw.vstpu")
        t0 = time.perf_counter()
        engine.save(path)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = Engine.load(path)
        load_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    bidx = back.manager.get("hidx").attribute("v").index
    check(bidx._device_graph is None and bidx.builder.count
          == index.builder.count, "the restored graph")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bidx.device_graph()
    torch.cuda.synchronize()
    upload_ms = (time.perf_counter() - t0) * 1e3
    _, after = bidx.search_batch(qs[:N_GT], K, ef=HNSW_EF)
    same = float(np.mean(np.all(after == before, axis=1)))
    log(f"hidx SAVE {save_s:.2f} s, restore {load_s:.2f} s "
        f"({bidx.builder.count} graph nodes imported, no insert), first "
        f"walk's graph upload "
        f"{upload_ms:.1f} ms; walk at ef {HNSW_EF} on {N_GT} queries: "
        f"{same:.4f} of rows the same ids as before the save", gpu)
    check(same == 1.0, f"the restored walk differs on {1 - same:.4f} of rows")
    del back, bidx
    return {"save_s": save_s, "restore_s": load_s,
            "graph_upload_ms": upload_ms}


def _device_share(torch, fn, ranges: str = "") -> dict:
    """torch.profiler over one call: device kernel time against the call's
    host-clock time; with ``ranges``, also the device ms under each
    record_function range whose name starts with it (``by_range``) and
    outside them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev_events = [e for e in prof.events()
                  if e.device_type == DeviceType.CUDA
                  and not e.is_user_annotation]
    busy = sum(e.time_range.elapsed_us() for e in dev_events) / 1e3
    out = {"wall_ms": wall * 1e3, "device_ms": busy,
           "device_share": busy / (wall * 1e3), "device_ops": len(dev_events)}
    if ranges:
        split = {}
        for e in prof.events():
            if e.device_type == DeviceType.CPU and e.name.startswith(ranges):
                split[e.name] = (split.get(e.name, 0.0)
                                 + e.device_time_total / 1e3)
        out["by_range"] = split
        out["outside_ms"] = busy - sum(split.values())
    return out


def hnsw_index(torch, bs, dev, gpu: str, corpus, queries, stats: dict) -> None:
    """(b) HnswVectorIndex(dim 128, M 16, EF_CONSTRUCTION 200).bulk_load of
    N_HNSW_BIG rows under build-mode device, each stage timed, and the
    publish; search_batch at B = 1,024, ef 100 on the scan route under int8
    (K1 at pre_shift > 0: span 4 at capacity 524,288) and bfloat16 (K2); the device walk at ef 10, 50 and 100
    beside the native walk over the same graph (N_NATIVE queries)."""
    from valkey_search_tpu_torch.indexes.hnsw import HnswVectorIndex
    from valkey_search_tpu_torch.ops import hnsw_search as hs_ops
    from valkey_search_tpu_torch.runtime import config

    n = len(corpus)
    qs = queries[:HNSW_B]
    c64 = torch.as_tensor(corpus, dtype=torch.float64, device=dev)
    gt = fp64_gt(torch, c64, (c64 * c64).sum(1), qs[:N_GT], K, dev)
    del c64
    torch.cuda.empty_cache()
    config.set_config("search.hnsw-build-mode", "device")
    index = HnswVectorIndex(dim=D, m=16, ef_construction=200, device=dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    index.bulk_load([f"k{i}" for i in range(n)], corpus)
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    graph = index.device_graph()
    torch.cuda.synchronize()
    publish_s = time.perf_counter() - t0
    build = {"rows": n, "bulk_load_s": build_s, "vec_per_s": n / build_s,
             **index.build_seconds, "publish_s": publish_s,
             "levels": len(graph.upper_links),
             "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30}
    stats["build"] = build
    log(f"HNSW bulk_load {n} x {D} (M 16, EF_CONSTRUCTION 200, device): "
        + json.dumps(build), gpu)
    check(index.node_count == n, "bulk_load node count")

    # the scan route, K1 (pre_shift > 0 from capacity 524,288) and K2
    for dtype, kernel in (("int8", "bucket_scan_i8_packed[pre_shift>0]"),
                          ("bfloat16", "bucket_scan_bf16")):
        config.set_config("search.corpus-dtype", dtype)
        index.search_batch(qs, K, ef=HNSW_EF)  # publish this dtype's mirror
        bs.reset_launches()
        _, ids = index.search_batch(qs, K, ef=HNSW_EF)
        counts = bs.launch_counts()
        r = recall(ids[:N_GT], gt)
        qps = batch_qps(torch, index, qs, len(qs), ef=HNSW_EF)
        _merge_launches(stats["launches"], bs.launch_counts())
        stats[f"scan/{dtype}"] = {"recall": r, "qps": qps}
        log(f"HNSW {n} scan route corpus-dtype={dtype} B={len(qs)} ef "
            f"{HNSW_EF}: recall@{K} {r:.4f}, {qps:.1f} QPS, launches "
            f"{counts}", gpu)
        check(counts[kernel] > 0, f"HNSW {n} scan: {kernel} never launched")
        check(r >= RECALL_FLOOR, f"HNSW {n} scan ({dtype}) recall {r}")

    # the walk: check_every, then ef 10 / 50 / 100 beside the native walk
    config.set_config("search.hnsw-scan-threshold", 0)
    qt = torch.from_numpy(qs).to(dev)
    hs_ops.hnsw_search_batch(graph, qt, K, HNSW_EF)  # warm
    every = {ce: [] for ce in CHECK_EVERY_CASES}
    for rep in range(3):  # in turns, each order reversed every other round
        for ce in CHECK_EVERY_CASES[::1 if rep % 2 == 0 else -1]:
            t0 = time.perf_counter()
            hs_ops.hnsw_search_batch(graph, qt, K, HNSW_EF, check_every=ce)
            torch.cuda.synchronize()
            every[ce].append((time.perf_counter() - t0) * 1e3)
    every = {ce: sorted(v) for ce, v in every.items()}
    stats["walk_check_every_ms"] = every
    log(f"HNSW {n} SoA walk B={len(qs)} ef {HNSW_EF}, ms by check_every "
        f"(3 runs each, in turns; CHECK_EVERY={hs_ops.CHECK_EVERY}): "
        + json.dumps(every), gpu)
    native_q = qs[:N_NATIVE]
    walk = {}
    for ef in HNSW_EFS:
        _, ids = index.search_batch(qs, K, ef=ef)
        qps = batch_qps(torch, index, qs, len(qs), ef=ef)
        t0 = time.perf_counter()
        nat = [index.builder.search(q, K, ef)[1] for q in native_q]
        nat_s = time.perf_counter() - t0
        nat_ids = np.full((N_NATIVE, K), -1, np.int64)
        for i, row in enumerate(nat):
            nat_ids[i, :len(row)] = row
        walk[ef] = {"recall": recall(ids[:N_GT], gt),
                    "recall_200": recall(ids[:N_NATIVE], gt[:N_NATIVE]),
                    "qps": qps,
                    "native_recall_200": recall(nat_ids, gt[:N_NATIVE]),
                    "native_qps": N_NATIVE / nat_s}
        log(f"HNSW {n} walk ef {ef}: " + json.dumps(walk[ef]), gpu)
    stats["walk"] = walk
    share = _device_share(torch, lambda: index.search_batch(qs, K,
                                                             ef=HNSW_EF))
    stats["walk_profile"] = share
    log(f"HNSW {n} walk B={len(qs)} ef {HNSW_EF} under torch.profiler: "
        + json.dumps(share), gpu)
    top = walk[HNSW_EFS[-1]]
    check(top["recall_200"] >= top["native_recall_200"] - 0.02,
          f"device walk recall {top['recall_200']} more than 0.02 below "
          f"the native walk's {top['native_recall_200']}")
    config.set_config("search.hnsw-scan-threshold", 1 << 30)
    config.set_config("search.hnsw-build-mode", "auto")
    del index, graph, qt
    torch.cuda.empty_cache()


def hnsw_phase(torch, bs, dev, gpu: str) -> dict:
    stats = {"launches": {}}
    corpus, queries = sift_like(N_BIG, N_QUERIES + 16384)
    cats, _ = seeded_fields(N_BIG)
    t0 = time.perf_counter()
    hnsw_engine(torch, bs, dev, gpu, corpus, queries, cats, stats)
    stats["engine_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    hnsw_index(torch, bs, dev, gpu, corpus[:N_HNSW_BIG], queries, stats)
    stats["index_s"] = time.perf_counter() - t0
    for name in ("bucket_scan_i8_packed[pre_shift=0]",
                 "bucket_scan_i8_packed[pre_shift>0]", "bucket_scan_bf16"):
        check(stats["launches"].get(name, 0) > 0,
              f"{name} never launched in the HNSW phase")
    return stats


# ---------------------------------------------------------------------------
# phase 6: IVF, through Engine.execute and at full width at the index level
# ---------------------------------------------------------------------------


def ivf_counters(stats_table, before=None) -> dict:
    """The IVF counters, or how far they moved since ``before``."""
    now = {name: stats_table.get(name) for name in IVF_COUNTERS}
    if before is None:
        return now
    return {name: now[name] - before[name] for name in IVF_COUNTERS}


def ivf_engine_route(torch, bs, engine, name: str, queries, gt_keys, probe,
                     threshold: int, kernel: str, gpu: str,
                     ef: int = 0) -> dict:
    """The IVF route of an engine index: search.ivf-threshold at
    ``threshold``, FT.SEARCH KNN 10 (EF_RUNTIME ``ef``) from THREADS threads
    under int8: the mirror builds once on the card, IVF serves every query
    and no scan kernel launches; recall@10 against ``gt_keys``; a
    @cat:{c7} hybrid query takes the scan (``kernel``) and not IVF; deleted
    returned keys never come back; a key updated to ``probe`` comes first
    at distance 0 through the delta overlay, with no rebuild. The threshold
    is restored to its default."""
    from valkey_search_tpu_torch.runtime.metrics import STATS

    engine.config_set("search.corpus-dtype", "int8")
    engine.config_set("search.ivf-threshold", str(threshold))
    rec = {}
    try:
        start = ivf_counters(STATS)
        bs.reset_launches()
        t0 = time.perf_counter()
        keys, lat = search_all(engine, name, queries, ef=ef)
        rec["wall_s"] = time.perf_counter() - t0
        launched = sum(bs.launch_counts().values())
        moved = ivf_counters(STATS, start)
        index = engine.manager.get(name).attribute("v").index
        rec.update(recall=recall(keys[:len(gt_keys)], gt_keys),
                   p50_ms=float(np.percentile(lat, 50)) * 1e3,
                   p99_ms=float(np.percentile(lat, 99)) * 1e3,
                   counters=moved, scan_launches=launched,
                   build_seconds=index.ivf_build_seconds,
                   n_blocks=index._ivf.n_blocks)
        log(f"IVF route {name} (ivf-threshold {threshold}, ef {ef}): "
            + json.dumps(rec), gpu)
        check(moved["ivf_mirror_builds"] == 1,
              f"{name}: {moved['ivf_mirror_builds']} mirror builds, not 1")
        check("sample_fit_s" in index.ivf_build_seconds,
              f"{name}: the mirror was not built from the device mirror")
        check(moved["ivf_served_searches"] >= len(queries),
              f"{name}: IVF served {moved['ivf_served_searches']} queries")
        check(launched == 0, f"{name}: {launched} scan launches under IVF")
        check(rec["recall"] >= IVF_ENGINE_FLOOR,
              f"{name}: IVF recall {rec['recall']} < {IVF_ENGINE_FLOOR}")

        before = ivf_counters(STATS)
        bs.reset_launches()
        engine.execute("FT.SEARCH", name, knn("@cat:{c7}", ef=ef), "PARAMS",
                       "2", "q", queries[0].tobytes(), "NOCONTENT")
        hybrid = ivf_counters(STATS, before)["ivf_served_searches"]
        counts = bs.launch_counts()
        log(f"IVF route {name}: @cat:{{c7}} served by IVF {hybrid}, "
            f"launches {counts}", gpu)
        check(hybrid == 0 and counts[kernel] > 0,
              f"{name}: the hybrid query did not take the scan")

        gone = list(dict.fromkeys(k for row in keys for k in row))
        gone = gone[:IVF_DELETED]
        check(engine.execute("DEL", *gone) == len(gone), f"DEL ({name})")
        after, _ = search_all(engine, name, queries, ef=ef)
        gone = set(gone)
        back = sum(1 for row in after for k in row if k in gone)
        target = next(k for row in after for k in row if k not in gone)
        engine.execute("HSET", target, "v", probe.tobytes())
        reply = engine.execute("FT.SEARCH", name, knn("*", ef=ef), "PARAMS",
                               "2", "q", probe.tobytes(), "RETURN", "1",
                               "__v_score")
        dist = float(reply[2][1])
        total = ivf_counters(STATS, start)
        rec.update(deleted_returned=back, update_top=reply[1],
                   update_dist=dist, counters_total=total)
        log(f"IVF route {name}: after DEL of {len(gone)} returned keys "
            f"{back} came back; updated {target}: top hit {reply[1]} at "
            f"{dist}; counters {total}", gpu)
        check(back == 0, f"{name}: {back} deleted keys returned under IVF")
        check(reply[1] == target and abs(dist) <= 1e-5 * float(probe @ probe),
              f"{name}: updated {target} not first at distance 0")
        check(total["ivf_mirror_builds"] == 1,
              f"{name}: the mirror rebuilt after DEL/HSET")
    finally:
        engine.config_set("search.ivf-threshold", str(IVF_DEFAULT_THRESHOLD))
    return rec


def live_gt_keys(torch, index, queries, dev):
    """fp64 ground truth over an index's live rows, as keys."""
    docs = np.nonzero(index.store.present)[0]
    c64 = torch.as_tensor(index.store.vectors[docs], dtype=torch.float64,
                          device=dev)
    gt = fp64_gt(torch, c64, (c64 * c64).sum(1), queries, K, dev)
    del c64
    return [[index.interner.key_of(int(docs[j])) for j in row] for row in gt]


def ivf_corpus(torch, dev, n: int, n_queries: int, seed: int = 42):
    """The SIFT-like recipe at ``n`` rows, made on the card: the centers as
    sift_like draws them (numpy, ``seed``), then, for each chunk of
    IVF_CHUNK rows, the cluster of each row and its N(0, 20^2) noise from a
    torch.Generator seeded seed * 1000 + chunk, clipped to [0, 255] and
    copied to the host; the queries likewise, from seed * 1000 + 999."""
    rng = np.random.default_rng(seed)
    centers = torch.as_tensor(
        rng.standard_normal((N_CENTERS, D)).astype(np.float32) * 60 + 128,
        device=dev)

    def rows(m: int, gen_seed: int) -> np.ndarray:
        gen = torch.Generator(device=dev).manual_seed(gen_seed)
        a = torch.randint(0, N_CENTERS, (m,), generator=gen, device=dev)
        noise = torch.randn((m, D), generator=gen, device=dev)
        return (centers[a] + noise * 20).clamp_(0, 255).cpu().numpy()

    corpus = np.empty((n, D), np.float32)
    for c, s in enumerate(range(0, n, IVF_CHUNK)):
        corpus[s:s + IVF_CHUNK] = rows(min(IVF_CHUNK, n - s), seed * 1000 + c)
    return corpus, rows(n_queries, seed * 1000 + 999)


def fp64_gt_rows(torch, corpus_t, queries, k: int, dev,
                 rows: int = IVF_CHUNK, n_q: int = N_GT) -> np.ndarray:
    """fp64 ground truth over a device corpus, ``n_q`` queries by ``rows``
    rows at a time (a [256, 1M] fp64 block is 2 GiB)."""
    out = []
    for q0 in range(0, len(queries), n_q):
        q = torch.as_tensor(queries[q0:q0 + n_q], dtype=torch.float64,
                            device=dev)
        best_d = best_i = None
        for s in range(0, corpus_t.shape[0], rows):
            c = corpus_t[s:s + rows].to(torch.float64)
            dd = (c * c).sum(1)[None, :] - 2.0 * (q @ c.T)
            d, i = torch.topk(dd, k, largest=False)
            i = i + s
            if best_d is not None:
                d, pos = torch.topk(torch.cat([best_d, d], 1), k,
                                    largest=False)
                i = torch.cat([best_i, i], 1).gather(1, pos)
            best_d, best_i = d, i
        out.append(best_i.cpu().numpy())
    return np.concatenate(out)


def timed(torch, fn, reps: int = IVF_REPS):
    """``fn``'s result (a warm-up call) and the host-clock seconds of
    ``reps`` more calls, each synchronised."""
    out = fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return out, times


def qps_record(b: int, times, ids, gt) -> dict:
    med = float(np.median(times))
    return {"qps": b / med, "qps_min": b / max(times),
            "qps_max": b / min(times), "ms": [t * 1e3 for t in times],
            "recall": recall(ids[:len(gt)], gt[:len(ids)])}


def ivf_phase(torch, bs, dev, gpu: str, stats: dict, keep: dict) -> None:
    """(b) A FLAT index of N_IVF x 128 rows of the SIFT-like recipe
    (ivf_corpus) through bulk_load, at the default search.ivf-threshold:
    the first search builds the mirror on the card (build_ivf_device, its
    stages timed); search_batch at B = 1,024 and 16,384 and probe 8, 16 and
    32 (QPS the median of IVF_REPS, recall@10 on N_GT queries against fp64
    ground truth, the stage-2 route of each); a torch.profiler split of one
    B = 16,384 batch at the default probe, and IVF_PROFILED_CALLS B = 1,024
    calls profiled one by one; the fused scan over the same
    index at threshold 0 (K1b under int8, K2 under bfloat16); and the
    host-fed build_ivf against build_ivf_device over the first N_IVF_HOST
    rows, their recalls read on IVF_HOST_QUERIES queries."""
    import gc

    from valkey_search_tpu_torch.indexes.flat import FlatVectorIndex
    from valkey_search_tpu_torch.ops import ivf as ivf_ops
    from valkey_search_tpu_torch.runtime import config
    from valkey_search_tpu_torch.runtime.metrics import STATS

    gc.collect()
    torch.cuda.empty_cache()
    check(int(config.get("search.ivf-threshold")) == IVF_DEFAULT_THRESHOLD,
          "search.ivf-threshold is not its default")
    t0 = time.perf_counter()
    corpus, queries = ivf_corpus(torch, dev, N_IVF, max(IVF_BATCHES))
    stats["data_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    index = FlatVectorIndex(dim=D, device=dev)
    index.bulk_load([f"k{i}" for i in range(N_IVF)], corpus)
    stats["bulk_load_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    snap = index.store.device_snapshot()
    torch.cuda.synchronize()
    stats["publish_s"] = time.perf_counter() - t0
    log(f"IVF {N_IVF} x {D}: data {stats['data_s']:.1f} s, bulk_load "
        f"{stats['bulk_load_s']:.1f} s, publish {stats['publish_s']:.1f} s "
        f"(capacity {index.store.capacity})", gpu)

    # the first search builds the mirror from the device mirror
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    before = ivf_counters(STATS)
    index.search_batch(queries[:IVF_BATCHES[0]], K)
    first_s = time.perf_counter() - t0
    mirror = index._ivf
    check(ivf_counters(STATS, before)["ivf_mirror_builds"] == 1,
          "the 10M mirror was not built")
    check("sample_fit_s" in index.ivf_build_seconds,
          "the 10M mirror was not built by build_ivf_device")
    probe0 = ivf_ops.default_probe(mirror)
    stats["build"] = {**index.ivf_build_seconds, "first_search_s": first_s,
                      "n_blocks": mirror.n_blocks,
                      "device_gib": mirror.device_bytes() / 2**30,
                      "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
                      "default_probe": probe0}
    log(f"IVF {N_IVF} mirror: " + json.dumps(stats["build"]), gpu)

    t0 = time.perf_counter()
    gt = fp64_gt_rows(torch, snap["vectors"][:N_IVF], queries[:N_GT], K, dev)
    log(f"IVF {N_IVF} ground truth ({N_GT} queries, fp64) "
        f"{time.perf_counter() - t0:.1f} s", gpu)

    sweep = {}
    for probe in IVF_PROBES:
        config.set_config("search.ivf-probe", probe)
        for b in IVF_BATCHES:
            before = ivf_counters(STATS)
            (_, ids), times = timed(
                torch, lambda: index.search_batch(queries[:b], K))
            moved = ivf_counters(STATS, before)
            route = ("grouped" if moved["ivf_stage2_grouped"]
                     else "steps" if moved["ivf_stage2_steps"] else "none")
            rec = {**qps_record(b, times, ids, gt), "route": route,
                   "calls_by_route": [moved["ivf_stage2_grouped"],
                                      moved["ivf_stage2_steps"]]}
            sweep[f"probe={probe}/B={b}"] = rec
            log(f"IVF {N_IVF} probe {probe} B={b}: " + json.dumps(rec), gpu)
    config.set_config("search.ivf-probe", 0)
    stats["sweep"] = sweep
    for b in IVF_BATCHES:
        r = sweep[f"probe={probe0}/B={b}"]["recall"]
        check(r >= RECALL_FLOOR,
              f"IVF {N_IVF} B={b} default probe {probe0}: recall {r}")
    routes = {rec["route"] for rec in sweep.values()}
    check(routes == {"grouped", "steps"},
          f"IVF {N_IVF}: stage-2 routes exercised {routes}")

    big = max(IVF_BATCHES)
    stats["profile"] = _device_share(
        torch, lambda: index.search_batch(queries[:big], K), ranges="ivf.")
    log(f"IVF {N_IVF} B={big} probe {probe0} under torch.profiler: "
        + json.dumps(stats["profile"]), gpu)
    # the small batch's calls one by one: a slow call whose device time
    # stays put is a host stall, not the route's own cost
    small = min(IVF_BATCHES)
    calls = [_device_share(torch, lambda: index.search_batch(queries[:small], K))
             for _ in range(IVF_PROFILED_CALLS)]
    stats["profile_small"] = {
        key: [c[key] for c in calls] for key in ("wall_ms", "device_ms")}
    log(f"IVF {N_IVF} B={small} probe {probe0}, {IVF_PROFILED_CALLS} calls "
        "under torch.profiler: " + json.dumps(stats["profile_small"]), gpu)

    # the same index served by the fused scan
    scan = {}
    config.set_config("search.ivf-threshold", 0)
    try:
        for dtype, kernel in (("int8", "bucket_scan_i8_packed[pre_shift>0]"),
                              ("bfloat16", "bucket_scan_bf16")):
            config.set_config("search.corpus-dtype", dtype)
            index.search_batch(queries[:1], K)  # publish this dtype's mirror
            bs.reset_launches()
            for b in IVF_BATCHES:
                (_, ids), times = timed(
                    torch, lambda: index.search_batch(queries[:b], K))
                scan[f"{dtype}/B={b}"] = qps_record(b, times, ids, gt)
                log(f"scan {N_IVF} corpus-dtype={dtype} B={b}: "
                    + json.dumps(scan[f"{dtype}/B={b}"]), gpu)
            counts = bs.launch_counts()
            check(counts[kernel] > 0, f"scan {N_IVF}: {kernel} not launched")
            _merge_launches(stats["launches"], counts)
    finally:
        config.set_config("search.ivf-threshold", IVF_DEFAULT_THRESHOLD)
        config.set_config("search.corpus-dtype", "bfloat16")
    stats["scan"] = scan

    # the host-fed build (the engine's when the mirror is dirty) against
    # the device build over the same rows, at the same probe
    sub = snap["vectors"][:N_IVF_HOST]
    gt_sub = fp64_gt_rows(torch, sub, queries[:IVF_HOST_QUERIES], K, dev)
    q_gt = torch.from_numpy(queries[:IVF_HOST_QUERIES]).to(dev)
    builds = {}
    for how in ("build_ivf", "build_ivf_device"):
        t0 = time.perf_counter()
        if how == "build_ivf":
            sub_index = ivf_ops.build_ivf(corpus[:N_IVF_HOST], device=dev)
        else:
            sub_index = ivf_ops.build_ivf_device(sub)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        probe = ivf_ops.default_probe(sub_index)
        _, ids = ivf_ops.ivf_search_rescored(sub_index, q_gt, sub, k=K,
                                             probe=probe)
        _, coarse = ivf_ops.ivf_search_batch(sub_index, q_gt, k=K,
                                             probe=probe)
        builds[how] = {"build_s": build_s, "n_blocks": sub_index.n_blocks,
                       "probe": probe,
                       "recall": recall(ids.cpu().numpy(), gt_sub),
                       "coarse_recall": recall(coarse.cpu().numpy(), gt_sub)}
        del sub_index
    stats["host_build"] = builds
    log(f"IVF {N_IVF_HOST} rows, host-fed against device build (recall on "
        f"{IVF_HOST_QUERIES} queries): " + json.dumps(builds), gpu)
    gap = builds["build_ivf"]["recall"] - builds["build_ivf_device"]["recall"]
    check(builds["build_ivf"]["probe"] == builds["build_ivf_device"]["probe"]
          and abs(gap) <= IVF_HOST_TOLERANCE,
          f"build_ivf recall {gap:+.4f} from build_ivf_device's")
    # the mesh phase splits this mirror four ways
    keep.update(mirror=mirror, corpus=corpus, queries=queries, gt=gt)
    del index, snap, sub, mirror
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# phase 7: the cluster, in one process and over sockets, and a failover
# across a process boundary
# ---------------------------------------------------------------------------


def shard_merge(nodes, argv, k: int):
    """The k smallest of the shards' own replies to one FT.SEARCH (each
    node's execute_search on its own engine), merged as the cluster's
    coordinator merges them: in node order, a stable sort by distance."""
    from valkey_search_tpu_torch.query.search import execute_search
    from valkey_search_tpu_torch.server import ft_search as ft_search_mod

    sp = ft_search_mod.parse_ft_search_args(list(argv))
    rows = []
    for node in nodes:
        resp = execute_search(node.engine.manager.get(sp.index_name), sp)
        rows += [(nb.key, nb.distance) for nb in resp.neighbors]
    rows.sort(key=lambda r: r[1])
    return rows[:k]


def cluster_engine_part(torch, bs, dev, gpu, rows, queries, cats,
                        launches: dict) -> dict:
    """(a) ClusterEngine(n_nodes=3) on the card: HSET every row through
    ClusterEngine.execute, then KNN 10 unfiltered and behind @cat:{c7}
    under int8 and bfloat16 from THREADS threads; recall, no key outside
    the filter, the merge against the shards' own replies, a launch of the
    dtype's kernel on every shard for every query; FT.INFO CLUSTER; one
    FT.AGGREGATE over KNN 100 grouped by @cat against numpy."""
    from valkey_search_tpu_torch.cluster.node import ClusterEngine

    out = {}
    n = len(rows)
    ce = ClusterEngine(n_nodes=N_CLUSTER_SHARDS)
    check(ce.execute(
        "FT.CREATE", "idx", "ON", "HASH", "PREFIX", "1", "doc:", "SCHEMA",
        "v", "VECTOR", "FLAT", "6", "TYPE", "FLOAT32", "DIM", str(D),
        "DISTANCE_METRIC", "L2", "cat", "TAG", "price", "NUMERIC") == "OK",
        "cluster FT.CREATE")
    t0 = time.perf_counter()
    for i in range(n):
        ce.execute("HSET", f"doc:{i}", "v", rows[i].tobytes(),
                   "cat", f"c{cats[i]}", "price", str(i % 1000))
    out["ingest_s"] = time.perf_counter() - t0
    shards = [len(node.engine.keyspace) for node in ce.nodes]
    caps = [node.engine.manager.get("idx").attribute("v").index.store
            .capacity for node in ce.nodes]
    info = ce.execute("FT.INFO", "idx", "CLUSTER")
    num_docs = info[info.index("num_docs") + 1]
    log(f"cluster: {n} HSETs through ClusterEngine.execute over "
        f"{N_CLUSTER_SHARDS} shards in {out['ingest_s']:.1f} s "
        f"({out['ingest_s'] / n * 1e6:.1f} us/row); rows a shard {shards}, "
        f"capacity {caps}; FT.INFO CLUSTER num_docs {num_docs}", gpu)
    check(num_docs == n, f"cluster FT.INFO num_docs {num_docs} != {n}")
    # the fused scan serves from capacity 131,072; under 524,288 int8 scans
    # at span 1 (K1 at pre_shift 0)
    check(all(131_072 <= c < 524_288 for c in caps),
          f"shard capacities {caps}")
    out["rows_a_shard"] = shards

    qs = queries[:CLUSTER_QUERIES]
    c64 = torch.as_tensor(rows, dtype=torch.float64, device=dev)
    csq = (c64 * c64).sum(1)
    in_c7 = cats[:n] == 7
    gts = {"*": fp64_gt(torch, c64, csq, qs, K, dev),
           "@cat:{c7}": fp64_gt(torch, c64, csq, qs, K, dev, in_c7)}
    del c64, csq
    torch.cuda.empty_cache()
    kernels = (("int8", "bucket_scan_i8_packed[pre_shift=0]"),
               ("bfloat16", "bucket_scan_bf16"))
    for dtype, kernel in kernels:
        ce.nodes[0].engine.config_set("search.corpus-dtype", dtype)
        ce.execute(*_knn_argv("idx", "*", qs[0]))  # publish (not timed)
        for flt, gt in gts.items():
            argvs = [_knn_argv("idx", flt, q) for q in qs]
            (replies, lat, wall), counts = counted(
                bs, launches, lambda: execute_all(ce, argvs))
            got = [_keys_dists(r) for r in replies]
            ids = key_ids([keys for keys, _ in got], "doc:")
            r = recall(ids, gt)
            outside = int((~in_c7[ids[ids >= 0]]).sum()) if flt != "*" else 0
            merged = sum(
                1 for (keys, _), argv in zip(got, argvs)
                if keys == [key for key, _ in shard_merge(ce.nodes, argv[1:],
                                                          K)])
            rec = {"requests_per_s": len(qs) / wall,
                   "p50_ms": float(np.percentile(lat, 50) * 1e3),
                   "p99_ms": float(np.percentile(lat, 99) * 1e3),
                   "recall": r, "launches": counts, "merge_equal": merged}
            log(f"cluster {dtype} {knn(flt)!r}: {len(qs)} requests from "
                f"{THREADS} threads, {rec['requests_per_s']:.1f} requests/s, "
                f"p50 {rec['p50_ms']:.3f} ms, p99 {rec['p99_ms']:.3f} ms; "
                f"recall@{K} {r:.4f}; {outside} keys outside the filter; "
                f"merge equal to the shards' own replies on {merged} of "
                f"{len(qs)}; launches {counts} "
                f"({sum(counts.values()) / len(qs):.2f} a request)",
                gpu)
            check(r >= RECALL_FLOOR, f"cluster/{dtype}/{flt}: recall {r}")
            check(outside == 0, f"cluster/{dtype}/{flt}: {outside} outside")
            check(merged == len(qs), f"cluster/{dtype}/{flt}: the merge "
                  f"differs from the shards' own replies on "
                  f"{len(qs) - merged} requests")
            # an unfiltered shard search goes through its index's batcher,
            # which coalesces concurrent requests into one launch; one
            # request alone launches the kernel once on every shard
            (_, probe) = counted(bs, launches,
                                 lambda: ce.execute(*argvs[0]))
            rec["launches_alone"] = probe
            check(counts.get(kernel, 0) > 0 and probe.get(kernel, 0)
                  == N_CLUSTER_SHARDS and sum(probe.values())
                  == N_CLUSTER_SHARDS,
                  f"cluster/{dtype}/{flt}: {kernel} launched "
                  f"{counts.get(kernel, 0)} times for {len(qs)} requests "
                  f"over {N_CLUSTER_SHARDS} shards, {probe} for one")
            if flt != "*":  # one search_batch a shard a filtered request
                check(counts.get(kernel, 0) == N_CLUSTER_SHARDS * len(qs),
                      f"cluster/{dtype}/{flt}: launched {counts} for "
                      f"{len(qs)} requests")
            out[f"{dtype}/{flt}"] = rec

    # FT.AGGREGATE over KNN 100 fans out; the coordinator groups every
    # shard's top 100 (as the JAX package does), so numpy counts @cat over
    # the shards' own replies
    q = qs[1]
    agg_argv = ("FT.AGGREGATE", "idx", f"*=>[KNN {AGG_CLUSTER_K} @v $q]",
                "PARAMS", "2", "q", q.tobytes(), "LOAD", "1", "@cat",
                "GROUPBY", "1", "@cat", "REDUCE", "COUNT", "0", "AS", "n")
    (reply, counts) = counted(bs, launches, lambda: ce.execute(*agg_argv))
    got = {_text(row["cat"]): int(_text(row["n"])) for row in rows_of(reply)}
    keys = [key for key, _ in shard_merge(
        ce.nodes, ("idx", f"*=>[KNN {AGG_CLUSTER_K} @v $q]", "PARAMS", "2",
                   "q", q.tobytes(), "LIMIT", "0", str(10 ** 9)), 10 ** 9)]
    values, freq = np.unique([cats[int(k[4:])] for k in keys],
                             return_counts=True)
    want = {f"c{v}": int(f) for v, f in zip(values, freq)}
    log(f"cluster FT.AGGREGATE KNN {AGG_CLUSTER_K} GROUPBY @cat: "
        f"{len(got)} groups over {sum(got.values())} rows, numpy "
        f"{len(want)} groups over {len(keys)} rows; launches {counts}", gpu)
    check(got == want, f"cluster FT.AGGREGATE counts {got} != numpy {want}")
    out["aggregate_rows"] = sum(got.values())
    return out


def start_trio(gpu):
    """Three NodeServers in this process on ephemeral ports, mutual gossip
    every 0.05 s, assign_slot_ranges(3), as tests/test_transport.py's trio;
    FT.CREATE over the wire to node 0, then until gossip has converged
    (_META.FP equal on all three, each knowing both peers' slot ranges).
    Returns (the nodes, the seconds to converge)."""
    from valkey_search_tpu_torch.cluster.transport import (
        NodeServer,
        assign_slot_ranges,
    )

    nodes = [NodeServer(f"n{i}", port=0, gossip_interval_s=0.05)
             for i in range(N_CLUSTER_SHARDS)]
    for (lo, hi), node in zip(assign_slot_ranges(N_CLUSTER_SHARDS), nodes):
        node.slots = (lo, hi)
    for node in nodes:
        node.resp.start()
    addrs = [f"127.0.0.1:{node.port}" for node in nodes]
    for i, node in enumerate(nodes):
        node.peers = [a for j, a in enumerate(addrs) if j != i]
        node._ensure_gossip_thread()
    conns = [Resp(node.port) for node in nodes]
    try:
        check(conns[0].cmd(
            "FT.CREATE", "idx", "ON", "HASH", "PREFIX", "1", "doc:",
            "SCHEMA", "v", "VECTOR", "FLAT", "6", "TYPE", "FLOAT32", "DIM",
            str(D), "DISTANCE_METRIC", "L2", "cat", "TAG") == "OK",
            "trio FT.CREATE over the wire")
        t0 = time.perf_counter()
        while True:
            fps = {c.cmd("_META.FP") for c in conns}
            if len(fps) == 1 and all(len(node._peer_slots) == 2
                                     for node in nodes):
                break
            check(time.perf_counter() - t0 < 30,
                  f"trio gossip did not converge: _META.FP {fps}")
            time.sleep(0.01)
        return nodes, time.perf_counter() - t0
    finally:
        for c in conns:
            c.close()


def socket_part(torch, bs, dev, gpu, corpus, queries, cats,
                launches: dict) -> dict:
    """(b) A socket trio on the card: N_TRIO rows a node through each node's
    own Engine (keys drawn by key_slot into its range), then KNN 10 over
    THREADS RESP connections spread over the three nodes (each node's
    coordinator fans out _PART.SEARCH over TCP), N_QUERIES under int8 and
    N_GT under bfloat16, against ClusterClient.ft_search; recall; MOVED;
    node 2 closed without and with partial results."""
    from valkey_search_tpu_torch.cluster.node import key_slot
    from valkey_search_tpu_torch.cluster.transport import ClusterClient
    from valkey_search_tpu_torch.runtime import config

    out = {}
    nodes, out["gossip_converge_s"] = start_trio(gpu)
    conns, clients = [], []
    try:
        owned = [[] for _ in nodes]
        for i in range(len(corpus)):
            slot = key_slot(f"doc:{i}")
            for ids, node in zip(owned, nodes):
                if node.slots[0] <= slot < node.slots[1]:
                    if len(ids) < N_TRIO:
                        ids.append(i)
                    break
            if all(len(ids) == N_TRIO for ids in owned):
                break
        t0 = time.perf_counter()
        for node, ids in zip(nodes, owned):
            for i in ids:
                node.engine.execute("HSET", f"doc:{i}", "v",
                                    corpus[i].tobytes(), "cat", f"c{cats[i]}")
        out["ingest_s"] = time.perf_counter() - t0
        caps = [node.engine.manager.get("idx").attribute("v").index.store
                .capacity for node in nodes]
        log(f"trio: gossip converged in {out['gossip_converge_s']:.3f} s; "
            f"{N_TRIO} rows a node through each node's Engine in "
            f"{out['ingest_s']:.1f} s; capacity {caps}", gpu)
        check(all(131_072 <= c < 524_288 for c in caps),
              f"trio capacities {caps}")
        rows = np.concatenate([np.asarray(ids) for ids in owned])
        qs = queries[:N_QUERIES]
        c64 = torch.as_tensor(corpus[rows], dtype=torch.float64, device=dev)
        gt = rows[fp64_gt(torch, c64, (c64 * c64).sum(1), qs[:N_GT], K, dev)]
        gt = [[f"doc:{i}" for i in row] for row in gt]
        del c64
        torch.cuda.empty_cache()

        addrs = [f"127.0.0.1:{node.port}" for node in nodes]
        conns = [Resp(nodes[t % len(nodes)].port) for t in range(THREADS)]
        clients = [ClusterClient(addrs) for _ in range(THREADS)]
        # all N_QUERIES under int8; the first N_GT under bfloat16 (the
        # in-process part runs both dtypes in full; this keeps the phase's
        # time)
        for dtype, kernel, n_req in (
                ("int8", "bucket_scan_i8_packed[pre_shift=0]", N_QUERIES),
                ("bfloat16", "bucket_scan_bf16", N_GT)):
            argvs = [_knn_argv("idx", "*", q) for q in qs[:n_req]]
            config.set_config("search.corpus-dtype", dtype)
            for c in conns[:len(nodes)]:
                c.cmd(*argvs[0])  # publish every shard (not timed)
            (replies, lat, wall), counts = counted(
                bs, launches, lambda: execute_all(
                    None, argvs, [c.cmd for c in conns]))
            wire = [_keys_dists(r) for r in replies]
            (direct, _, cwall), _ = counted(
                bs, launches, lambda: execute_all(
                    None, argvs, [c.execute for c in clients]))
            same = same_replies(wire, [_keys_dists(r) for r in direct],
                                qs[:n_req], f"trio/{dtype}",
                                INT8_EQUAL if dtype == "int8" else 1.0)
            r = recall([keys for keys, _ in wire[:N_GT]], gt)
            n_launch = counts.get(kernel, 0)
            rec = {"requests": n_req, "requests_per_s": n_req / wall,
                   "p50_ms": float(np.percentile(lat, 50) * 1e3),
                   "p99_ms": float(np.percentile(lat, 99) * 1e3),
                   "client_requests_per_s": n_req / cwall,
                   "recall": r, "same": same,
                   "launches_a_request": n_launch / n_req}
            log(f"trio {dtype}: {n_req} KNN 10 over {len(conns)} RESP "
                f"connections to 3 nodes {rec['requests_per_s']:.1f} "
                f"requests/s, p50 {rec['p50_ms']:.3f} ms, p99 "
                f"{rec['p99_ms']:.3f} ms (ClusterClient.ft_search from "
                f"{len(clients)} threads: "
                f"{rec['client_requests_per_s']:.1f} requests/s); replies "
                f"equal to ClusterClient's {same}; recall@{K} {r:.4f}; "
                f"{rec['launches_a_request']:.2f} {kernel} launches a "
                f"request {counts}", gpu)
            # one request alone: one _PART.SEARCH, one launch, a shard
            (_, probe) = counted(bs, launches,
                                 lambda: conns[0].cmd(*argvs[0]))
            rec["launches_alone"] = probe
            log(f"trio {dtype}: one request alone launches {probe}", gpu)
            check(r >= RECALL_FLOOR, f"trio/{dtype}: recall {r}")
            check(n_launch > 0 and probe.get(kernel, 0) == N_CLUSTER_SHARDS
                  and sum(probe.values()) == N_CLUSTER_SHARDS,
                  f"trio/{dtype}: {kernel} launched {n_launch} times for "
                  f"{n_req} requests over {N_CLUSTER_SHARDS} shards, "
                  f"{probe} for one")
            out[dtype] = rec

        # MOVED: a key of node 1's range sent to node 0
        key = next(f"mv{i}" for i in range(100_000)
                   if nodes[1].slots[0] <= key_slot(f"mv{i}")
                   < nodes[1].slots[1])
        try:
            conns[0].cmd("HSET", key, "cat", "x")
            moved = None
        except ReplyError as exc:
            moved = str(exc)
        want = f"MOVED {key_slot(key)} 127.0.0.1:{nodes[1].port}"
        log(f"trio: HSET {key} to node 0: {moved!r}", gpu)
        check(moved == want, f"MOVED: {moved!r} != {want!r}")

        # node 2 closed: an error without partial results; with them, the
        # two live shards' merge. A closed RespServer's handler thread that
        # already waits on an open connection answers the one request it
        # reads next (in both packages), so node 0's coordinator has one
        # more answer from node 2 before its connection is gone
        nodes[2].close()
        argv = argvs[1]
        conns[0].cmd(*argv)
        try:
            conns[0].cmd(*argv)
            refused = None
        except (ReplyError, OSError, EOFError) as exc:
            refused = repr(exc)
        config.set_config("search.enable-partial-results", True)
        try:
            partial = _keys_dists(conns[0].cmd(*argv))[0]
        finally:
            config.set_config("search.enable-partial-results", False)
        live = [key for key, _ in shard_merge(nodes[:2], argv[1:], K)]
        log(f"trio: node 2 closed: without partial results {refused}; with "
            f"them {len(partial)} keys, equal to the live shards' merge "
            f"{partial == live}", gpu)
        check(refused is not None, "node 2 closed: the search did not fail")
        check(partial == live, f"partial results {partial} != {live}")
    finally:
        for c in conns:
            c.close()
        for c in clients:
            c.close()
        for node in nodes:
            node.close()
    return out


def failover_part(gpu, corpus, cats) -> dict:
    """(c) Failover across a process boundary. The primary is a node
    process (python -m valkey_search_tpu_torch.cluster.transport, on
    cuda:0 by default: a second CUDA context on the card) holding
    N_FAILOVER rows written over the wire; the replica a NodeServer in this
    process (the JAX package offers no command that promotes a node over
    the wire, so the node to promote runs here). After the full sync and
    the replica's first gossip round, FT.SEARCH through the replica counts
    each row once; the primary is killed (SIGKILL), the replica promoted,
    and it counts N_FAILOVER, then N_FAILOVER + 1 after an HSET."""
    import signal

    from valkey_search_tpu_torch.cluster.transport import NodeServer

    out = {}
    t0 = time.perf_counter()
    errlog = tempfile.TemporaryFile(mode="w+")
    proc = subprocess.Popen(
        [sys.executable, "-m", "valkey_search_tpu_torch.cluster.transport",
         "--node-id", "p0", "--port", "0"],
        stdout=subprocess.PIPE, stderr=errlog, text=True,
        env=dict(os.environ, PYTHONPATH=os.path.dirname(
            os.path.abspath(__file__))))
    replica, pc, rc = None, None, None
    count = ("FT.SEARCH", "fo", "*", "NOCONTENT", "LIMIT", "0", "0")
    try:
        line = proc.stdout.readline().strip()
        if not line.startswith("READY "):
            proc.wait(30)
            errlog.seek(0)
            check(False, f"node process: {line!r} {errlog.read()[-2000:]}")
        out["process_start_s"] = time.perf_counter() - t0
        port = int(line.split()[1])
        pc = Resp(port)
        check(pc.cmd("FT.CREATE", "fo", "ON", "HASH", "PREFIX", "1", "doc:",
                     "SCHEMA", "v", "VECTOR", "FLAT", "6", "TYPE", "FLOAT32",
                     "DIM", str(D), "DISTANCE_METRIC", "L2", "cat", "TAG")
              == "OK", "failover FT.CREATE")
        t0 = time.perf_counter()
        pc.pipeline([("HSET", f"doc:{i}", "v", corpus[i].tobytes(), "cat",
                      f"c{cats[i]}") for i in range(N_FAILOVER)])
        out["primary_ingest_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        replica = NodeServer("r0", port=0, gossip_interval_s=0.05).start()
        addr = f"127.0.0.1:{port}"
        replica.become_replica_of(addr)
        while (len(replica.engine.keyspace) < N_FAILOVER
               or "fo" not in replica.engine.ft_list()
               or addr not in replica._peer_slots):
            check(time.perf_counter() - t0 < 120, "the full sync and the "
                  "first gossip round did not land")
            time.sleep(0.01)
        out["sync_s"] = time.perf_counter() - t0
        rc = Resp(replica.port)
        out["through_replica"] = rc.cmd(*count)[0]
        knn_before = _keys_dists(rc.cmd(*_knn_argv("fo", "*", corpus[3])))[0]
        proc.send_signal(signal.SIGKILL)
        proc.wait(30)
        replica.promote_to_primary()
        out["after_promotion"] = rc.cmd(*count)[0]
        rc.cmd("HSET", "doc:new", "v", corpus[N_FAILOVER].tobytes(),
               "cat", "c0")
        out["after_hset"] = rc.cmd(*count)[0]
        knn_after = _keys_dists(rc.cmd(*_knn_argv("fo", "*", corpus[3])))[0]
        log(f"failover: node process up in {out['process_start_s']:.1f} s, "
            f"{N_FAILOVER} HSETs over the wire in "
            f"{out['primary_ingest_s']:.2f} s, full sync + first gossip "
            f"round {out['sync_s']:.2f} s; FT.SEARCH through the replica "
            f"counts {out['through_replica']}; primary killed, replica "
            f"promoted: {out['after_promotion']}, after an HSET "
            f"{out['after_hset']}; KNN through it {knn_before[:3]} -> "
            f"{knn_after[:3]}", gpu)
        check(out["through_replica"] == N_FAILOVER,
              f"the replica counts {out['through_replica']}, not "
              f"{N_FAILOVER}")
        check((out["after_promotion"], out["after_hset"])
              == (N_FAILOVER, N_FAILOVER + 1),
              f"after promotion {out['after_promotion']}, "
              f"{out['after_hset']}")
        check(knn_before[0] == knn_after[0] == "doc:3", "failover KNN")
    finally:
        for c in (pc, rc):
            if c is not None:
                try:
                    c.close()
                except OSError:
                    pass
        if replica is not None:
            replica.close()
        if proc.poll() is None:
            proc.kill()
        proc.wait(30)
        errlog.close()
    check(proc.poll() is not None, "the node process was left behind")
    return out


def cluster_phase(torch, bs, dev, gpu, corpus, queries, cats) -> dict:
    stats = {"launches": {}}
    t0 = time.perf_counter()
    stats["engine"] = cluster_engine_part(
        torch, bs, dev, gpu, corpus[:N_CLUSTER], queries, cats,
        stats["launches"])
    log(f"cluster (a) in-process {time.perf_counter() - t0:.1f} s", gpu)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    stats["socket"] = socket_part(torch, bs, dev, gpu, corpus, queries, cats,
                                  stats["launches"])
    log(f"cluster (b) sockets {time.perf_counter() - t0:.1f} s", gpu)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    stats["failover"] = failover_part(gpu, corpus, cats)
    log(f"cluster (c) failover {time.perf_counter() - t0:.1f} s", gpu)
    return stats



# ---------------------------------------------------------------------------
# phase 8: the mesh (parallel/), four shards on the visible cards
# ---------------------------------------------------------------------------


def _agree(ids, want) -> float:
    """Share of rows whose ids equal ``want``'s in order."""
    return float(np.mean((np.asarray(ids) == np.asarray(want)).all(1)))


def _equal_but_ties(torch, ids, d, want_ids, want_d, queries, corpus_t):
    """Rows whose ids differ from ``want_ids``, and how many of them hold
    the same distances (within 1e-5 of |q|^2 + |x|^2): ties reordered."""
    ids, want_ids = np.asarray(ids), np.asarray(want_ids)
    d, want_d = np.asarray(d), np.asarray(want_d)
    rows = np.nonzero((ids != want_ids).any(1))[0]
    csq = (corpus_t[torch.as_tensor(np.maximum(want_ids[rows], 0),
                                    device=corpus_t.device)] ** 2).sum(-1)
    terms = (queries[rows] ** 2).sum(1)[:, None] + csq.cpu().numpy()
    tied = (np.abs(d[rows] - want_d[rows]) <= 1e-5 * terms).all(1)
    return len(rows), int(tied.sum())


def mesh_flat(torch, pm, topk_ops, mesh, dev, gpu, corpus_t, queries,
              gt) -> dict:
    """(a) sharded_flat_topk over the slice's corpus, exact and two-stage,
    beside the unsharded flat_topk; (c) the 2 x 2 mesh's replicated search
    on the same queries."""
    rows = corpus_t.shape[0] // MESH_SHARDS
    q = torch.from_numpy(queries[:MESH_B]).to(dev)
    out = {}
    (wd, wi), times = timed(
        torch, lambda: topk_ops.flat_topk(q, corpus_t, K, block_rows=rows))
    wi = wi.cpu().numpy()
    out["unsharded"] = qps_record(MESH_B, times, wi, gt)
    (d, i, v), times = timed(torch, lambda: pm.sharded_flat_topk(
        mesh, corpus_t, q, K, block_rows=rows))
    ids = i.cpu().numpy()
    out["exact"] = {**qps_record(MESH_B, times, ids, gt),
                    "agree": _agree(ids, wi), "versions": v.tolist()}
    (d2, i2, _), times = timed(torch, lambda: pm.sharded_flat_topk(
        mesh, corpus_t, q, K, block_rows=rows, two_stage=True))
    out["two_stage"] = qps_record(MESH_B, times, i2.cpu().numpy(), gt)
    mesh2 = pm.make_mesh_2d(2, 2)
    (rd, ri), times = timed(torch, lambda: pm.replicated_sharded_flat_topk(
        mesh2, corpus_t, q, K))
    ri = ri.cpu().numpy()
    out["replicated_2x2"] = {
        **qps_record(MESH_B, times, ri, gt), "agree_with_exact": _agree(
            ri, ids),
        "devices": [str(x) for x in mesh2.devices.flat]}
    for name, rec in out.items():
        log(f"mesh (a/c) {name} B={MESH_B}: " + json.dumps(rec), gpu)
    check(out["exact"]["agree"] >= MESH_AGREE,
          f"sharded ids equal the unsharded on {out['exact']['agree']}")
    check(out["exact"]["recall"] >= MESH_EXACT_FLOOR,
          f"sharded exact recall {out['exact']['recall']}")
    check(v[0] == v[1], f"clean snapshot's versions {v.tolist()}")
    check(out["two_stage"]["recall"] >= RECALL_FLOOR,
          f"sharded two-stage recall {out['two_stage']['recall']}")
    check(out["replicated_2x2"]["agree_with_exact"] >= MESH_AGREE,
          "the 2 x 2 mesh's ids equal (a)'s on "
          f"{out['replicated_2x2']['agree_with_exact']}")
    return out


def mesh_update(torch, pm, mesh, dev, gpu, corpus_t, queries) -> dict:
    """(b) sharded_batch_update of MESH_B rows over every shard, the
    version retry and a dead shard's partial result."""
    rows = corpus_t.shape[0] // MESH_SHARDS
    rng = np.random.default_rng(5)
    upd = np.sort(rng.choice(corpus_t.shape[0], MESH_B, replace=False))
    per_shard = np.bincount(upd // rows, minlength=MESH_SHARDS)
    check((per_shard > 0).all(), f"updates a shard {per_shard.tolist()}")
    new = torch.from_numpy(queries[-MESH_B:]).to(dev)  # recipe rows, unseen
    before = corpus_t.clone()
    t0 = time.perf_counter()
    updated = pm.sharded_batch_update(mesh, corpus_t, upd, new)
    torch.cuda.synchronize()
    update_s = time.perf_counter() - t0
    check(torch.equal(corpus_t, before), "the update wrote into its input")
    del before
    d, i, _ = pm.sharded_flat_topk(mesh, updated, new, 1, block_rows=rows)
    first = i[:, 0].cpu().numpy()
    dist = d[:, 0].cpu().numpy()
    qsq = (queries[-MESH_B:].astype(np.float64) ** 2).sum(1)
    out = {"update_s": update_s, "rows_a_shard": per_shard.tolist(),
           "found_first": float(np.mean(first == upd)),
           "max_distance": float(dist.max()),
           "max_distance_over_qsq": float((np.abs(dist) / qsq).max())}
    check(out["found_first"] == 1.0, f"updated rows first on "
          f"{out['found_first']}")
    # the l2 expansion in fp32 cancels to ~0.3 at |q|^2 ~ 3e6: the bound
    # is relative to |q|^2, as the IVF overlay's check
    check(out["max_distance_over_qsq"] <= 1e-5,
          f"updated rows at distance {out['max_distance']}")

    q = torch.from_numpy(queries[:MESH_B]).to(dev)
    calls = {"n": 0}
    # consistent_sharded_topk scans at flat_topk's default block of 131,072
    # rows, which a shard's rows must be a multiple of (in both packages):
    # the first 4 x 131,072 rows of the updated corpus
    cons = updated[:MESH_SHARDS * 131072]
    rows = cons.shape[0] // MESH_SHARDS

    def snapshot():
        calls["n"] += 1
        v = torch.full((MESH_SHARDS,), 4, dtype=torch.int32)
        if calls["n"] == 1:
            v[-1] = 3  # one stale shard on the first attempt
        return cons, v, None

    t0 = time.perf_counter()
    _, _, partial = pm.consistent_sharded_topk(mesh, snapshot, q, K)
    out["retry_s"] = time.perf_counter() - t0
    out["snapshots"] = calls["n"]
    _, ip, partial_dead = pm.consistent_sharded_topk(
        mesh, snapshot, q, K, partial_ok=True, dead_shards=[1])
    ip = ip.cpu().numpy()
    out["dead_shard_ids"] = int(((ip >= rows) & (ip < 2 * rows)).sum())
    log("mesh (b) update and consistency: " + json.dumps(out), gpu)
    check(out["snapshots"] == 2 and not partial,
          f"{out['snapshots']} snapshots for one stale shard")
    check(partial_dead and out["dead_shard_ids"] == 0 and (ip >= 0).all(),
          f"dead shard 1: {out['dead_shard_ids']} of its ids returned")
    return out


def mesh_dims(torch, pm, topk_ops, mesh, dev, gpu, corpus_t, queries) -> dict:
    """(d) dim_sharded_flat_topk over 4 x 32 columns against the unsharded
    exact top-k."""
    rows = corpus_t.shape[0] // MESH_SHARDS
    qn = queries[:MESH_DIM_B]
    q = torch.from_numpy(qn).to(dev)
    wd, wi = topk_ops.flat_topk(q, corpus_t, K, block_rows=rows)
    (d, i), times = timed(torch, lambda: pm.dim_sharded_flat_topk(
        mesh, corpus_t, q, K))
    differ, tied = _equal_but_ties(torch, i.cpu(), d.cpu(), wi.cpu(),
                                   wd.cpu(), qn, corpus_t)
    out = {"qps": MESH_DIM_B / float(np.median(times)),
           "ms": [t * 1e3 for t in times], "rows_differ": differ,
           "rows_differ_by_ties": tied}
    log(f"mesh (d) dim-sharded B={MESH_DIM_B}: " + json.dumps(out), gpu)
    check(differ == tied, f"dim-sharded ids differ on {differ} rows, "
          f"{differ - tied} not by ties")
    return out


def mesh_hnsw(torch, fanout, mesh, dev, gpu, corpus, queries, cats,
              c64) -> dict:
    """(e) ShardedHnswIndex over N_MESH_HNSW rows through add_record."""
    import zlib

    idx = fanout.ShardedHnswIndex(dim=D, m=16, ef_construction=200,
                                  mesh=mesh)
    t0 = time.perf_counter()
    for i in range(N_MESH_HNSW):
        idx.add_record(f"m{i}", corpus[i])
    out = {"add_s": time.perf_counter() - t0}
    sizes = [s.count() for s in idx.shards]
    want = np.bincount([zlib.crc32(f"m{i}".encode()) % MESH_SHARDS
                        for i in range(N_MESH_HNSW)], minlength=MESH_SHARDS)
    out["shard_rows"] = sizes
    check(sizes == want.tolist(), f"shard sizes {sizes}, crc32 gives "
          f"{want.tolist()}")
    docs_of = np.array([idx.interner.lookup(f"m{i}")
                        for i in range(N_MESH_HNSW)])
    sub = c64[:N_MESH_HNSW]
    gt = fp64_gt(torch, sub, (sub * sub).sum(1), queries[:N_GT], K, dev)
    gt_docs = docs_of[gt]
    walk = {}
    for ef in HNSW_EFS:
        (_, docs), times = timed(torch, lambda: idx.search_batch(
            queries[:HNSW_B], K, ef=ef), reps=3)
        walk[f"ef={ef}"] = qps_record(HNSW_B, times, docs, gt_docs)
        log(f"mesh (e) ShardedHnswIndex ef {ef} B={HNSW_B}: "
            + json.dumps(walk[f"ef={ef}"]), gpu)
    out["walk"] = walk
    allowed = np.zeros(idx.interner.capacity, bool)
    allowed[docs_of[cats[:N_MESH_HNSW] == 7]] = True
    _, fdocs = idx.search_batch(queries[:N_GT], K, ef=HNSW_EF,
                                filter_mask=torch.from_numpy(allowed).to(dev))
    out["filtered_outside"] = int((~allowed[fdocs[fdocs >= 0]]).sum())
    out["filtered_returned"] = int((fdocs >= 0).sum())
    _, top = idx.search_batch(queries[:HNSW_B], 1, ef=HNSW_EF)
    gone = list(dict.fromkeys(int(x) for x in top[:, 0] if x >= 0))[:100]
    for doc in gone:
        idx.remove_record(idx.interner.key_of(doc))
    _, after = idx.search_batch(queries[:HNSW_B], K, ef=HNSW_EF)
    out["removed"] = len(gone)
    out["removed_returned"] = int(np.isin(after, gone).sum())
    out["count_after_remove"] = idx.count()
    log("mesh (e) ShardedHnswIndex: " + json.dumps(
        {k: v for k, v in out.items() if k != "walk"}), gpu)
    check(walk[f"ef={HNSW_EF}"]["recall"] >= HNSW_WALK_FLOOR,
          f"sharded walk recall {walk[f'ef={HNSW_EF}']['recall']}")
    check(out["filtered_outside"] == 0 and out["filtered_returned"] > 0,
          f"@cat:{{c7}} mask: {out['filtered_outside']} docs outside")
    check(len(gone) == 100 and out["removed_returned"] == 0
          and out["count_after_remove"] == N_MESH_HNSW - 100,
          f"{out['removed_returned']} of {len(gone)} removed keys returned")
    return out


def mesh_hnsw_exact(torch, bs, fanout, topk_ops, mesh, dev, gpu, corpus,
                    corpus_t, queries, cats) -> dict:
    """(e2) ShardedHnswIndex.exact_search_batch over N_MESH_EXACT rows, each
    shard loaded by its own device bulk build: each shard's masked scan (K1
    under int8, K2 under bfloat16), unfiltered and behind @cat:{c7}, merged
    on the host, against the unsharded fp32 flat_topk over the same rows.
    ``launches`` is every K1-K3 launch of this step."""
    from valkey_search_tpu_torch.runtime import config

    n = N_MESH_EXACT
    idx = fanout.ShardedHnswIndex(dim=D, m=16, ef_construction=200,
                                  mesh=mesh)
    keys = [f"x{i}" for i in range(n)]
    owner = np.array([idx.shard_of(k) for k in keys])
    step_before = bs.launch_counts()
    t0 = time.perf_counter()
    for s, shard in enumerate(idx.shards):
        rows = np.nonzero(owner == s)[0]
        shard.bulk_load([keys[i] for i in rows], corpus[rows])
    out = {"bulk_load_s": time.perf_counter() - t0,
           "capacities": [sh.store.capacity for sh in idx.shards]}
    check(min(out["capacities"]) >= 131072,
          f"shard capacities {out['capacities']} under the fused scan's")
    docs_of = np.array([idx.interner.lookup(k) for k in keys])
    q = queries[:MESH_B]
    qt = torch.from_numpy(q).to(dev)
    c7 = cats[:n] == 7
    allowed = np.zeros(idx.interner.capacity, bool)
    allowed[docs_of[c7]] = True
    saved = config.get("search.corpus-dtype")
    try:
        for dtype, kernel in (("int8", "bucket_scan_i8_packed[pre_shift=0]"),
                              ("bfloat16", "bucket_scan_bf16")):
            config.set_config("search.corpus-dtype", dtype)
            for flt, rows_ok in (("*", None), ("@cat:{c7}", c7)):
                fm = None if rows_ok is None else torch.from_numpy(
                    allowed).to(dev)
                _, want = topk_ops.flat_topk(
                    qt, corpus_t[:n], K, block_rows=n,
                    filter_mask=None if rows_ok is None
                    else torch.from_numpy(rows_ok).to(dev))
                want = docs_of[want.cpu().numpy()]
                before = bs.launch_counts()[kernel]
                _, docs = idx.exact_search_batch(q, K, filter_mask=fm)
                launched = bs.launch_counts()[kernel] - before
                _, times = timed(torch, lambda: idx.exact_search_batch(
                    q, K, filter_mask=fm), reps=3)
                rec = {**qps_record(MESH_B, times, docs, want),
                       "kernel": kernel, "launches": launched}
                if rows_ok is not None:
                    rec["outside"] = int((~allowed[docs[docs >= 0]]).sum())
                out[f"{dtype} {flt}"] = rec
                log(f"mesh (e2) exact_search_batch {dtype} {flt!r} "
                    f"B={MESH_B}: " + json.dumps(rec), gpu)
                check(launched >= MESH_SHARDS,
                      f"exact_search_batch {dtype} {flt}: {launched} "
                      f"launches of {kernel} over {MESH_SHARDS} shards")
                check(rec["recall"] >= RECALL_FLOOR,
                      f"exact_search_batch {dtype} {flt}: recall "
                      f"{rec['recall']} against the unsharded flat_topk")
                check(rec.get("outside", 0) == 0,
                      f"exact_search_batch {flt}: docs outside the mask")
    finally:
        config.set_config("search.corpus-dtype", saved)
    after = bs.launch_counts()
    out["launches"] = {k: after[k] - step_before[k] for k in after
                       if after[k] != step_before[k]}
    log("mesh (e2) exact_search_batch: " + json.dumps(
        {k: v for k, v in out.items() if k in ("bulk_load_s", "capacities",
                                               "launches")}), gpu)
    return out


def mesh_ivf(torch, pm, ivf_ops, mesh, dev, gpu, ivf_keep) -> dict:
    """(f) both sharded IVF programs over the ivf phase's 10M mirror, split
    four ways, beside the single-card ivf_search_rescored at the same
    probe: QPS, recall, each shard's local time and the merge's."""
    mirror, corpus, queries, gt = (ivf_keep[k] for k in
                                   ("mirror", "corpus", "queries", "gt"))
    check(mirror.n_blocks % MESH_SHARDS == 0,
          f"{mirror.n_blocks} blocks do not split {MESH_SHARDS} ways")
    devs = pm.shard_devices(mesh)
    t0 = time.perf_counter()
    slots = torch.from_numpy(pm.rows_in_slot_order(
        corpus, mirror.block_ids)).to(dev)
    out = {"slots_s": time.perf_counter() - t0,
           "slots_gib": slots.nbytes / 2**30}
    corpus_t = torch.from_numpy(corpus).to(dev)
    probe = MESH_IVF_PROBE
    kc = min(4 * K, mirror.block_rows * min(probe, mirror.n_blocks
                                              // MESH_SHARDS))
    shards = pm.shard_index(mirror, devs)
    slot_parts = [slots[s * (mirror.n_blocks // MESH_SHARDS):
                        (s + 1) * (mirror.n_blocks // MESH_SHARDS)]
                  for s in range(MESH_SHARDS)]
    progs = {
        "sharded": lambda q: pm.sharded_ivf_topk(mesh, mirror, q, K,
                                                 probe=probe),
        "sharded_rescored": lambda q: pm.sharded_ivf_topk_rescored(
            mesh, mirror, slots, q, K, probe=probe),
        "single_rescored": lambda q: ivf_ops.ivf_search_rescored(
            mirror, q, corpus_t, K, probe=probe),
    }
    for b in MESH_IVF_BATCHES:
        q = torch.from_numpy(queries[:b]).to(dev)
        for name, prog in progs.items():
            (_, ids), times = timed(torch, lambda: prog(q))
            out[f"{name}/B={b}"] = qps_record(b, times, ids.cpu().numpy(),
                                              gt)
            log(f"mesh (f) IVF {name} probe {probe} B={b}: "
                + json.dumps(out[f"{name}/B={b}"]), gpu)
        local = [time_ms(torch, lambda: pm.local_ivf_topk(
            shards[s], q, K, probe, "l2", 8)) for s in range(MESH_SHARDS)]
        local_r = [time_ms(torch, lambda: pm.local_ivf_topk_rescored(
            shards[s], slot_parts[s], q, K, kc, probe, "l2", 8))
            for s in range(MESH_SHARDS)]
        parts = [pm.local_ivf_topk(shards[s], q, K, probe, "l2", 8)
                 for s in range(MESH_SHARDS)]
        all_d = torch.stack([p[0] for p in parts])
        all_i = torch.stack([p[1] for p in parts])
        merge = time_ms(torch, lambda: pm._merge_gathered(all_d, all_i, K))
        out[f"shard_ms/B={b}"] = {"sharded": local, "sharded_rescored":
                                  local_r, "merge": merge}
        log(f"mesh (f) per-shard local ms (CUDA events, one after another "
            f"on {devs[0]}) B={b}: " + json.dumps(out[f"shard_ms/B={b}"]),
            gpu)
    for b in MESH_IVF_BATCHES:
        got = out[f"sharded_rescored/B={b}"]["recall"]
        want = out[f"single_rescored/B={b}"]["recall"]
        check(got >= want - MESH_RESCORED_SLACK,
              f"sharded rescored recall {got} < single-card {want} at "
              f"B={b}")
    del slots, corpus_t
    return out


def mesh_phase(torch, dev, gpu, corpus, queries, cats, ivf_keep) -> dict:
    """(a)-(g) of the mesh phase on a MESH_SHARDS-shard mesh (make_mesh
    cycles the visible cards: four shards on cuda:0 on one card)."""
    from valkey_search_tpu_torch import entry
    from valkey_search_tpu_torch.ops import bucket_scan as bs
    from valkey_search_tpu_torch.ops import ivf as ivf_ops
    from valkey_search_tpu_torch.ops import topk as topk_ops
    from valkey_search_tpu_torch.parallel import fanout
    from valkey_search_tpu_torch.parallel import mesh as pm

    mesh = pm.make_mesh(MESH_SHARDS)
    out = {"devices": [str(x) for x in pm.shard_devices(mesh)]}
    log(f"mesh: {MESH_SHARDS} shards on {out['devices']}", gpu)
    corpus_t = torch.from_numpy(corpus).to(dev)
    c64 = corpus_t.to(torch.float64)
    gt = fp64_gt(torch, c64, (c64 * c64).sum(1), queries[:MESH_B], K, dev)
    steps = (
        ("flat", lambda: mesh_flat(torch, pm, topk_ops, mesh, dev, gpu,
                                   corpus_t, queries, gt)),
        ("update", lambda: mesh_update(torch, pm, mesh, dev, gpu, corpus_t,
                                       queries)),
        ("dims", lambda: mesh_dims(torch, pm, topk_ops, mesh, dev, gpu,
                                   corpus_t, queries)),
        ("hnsw", lambda: mesh_hnsw(torch, fanout, mesh, dev, gpu, corpus,
                                   queries, cats, c64)),
        ("hnsw_exact", lambda: mesh_hnsw_exact(
            torch, bs, fanout, topk_ops, mesh, dev, gpu, corpus, corpus_t,
            queries, cats)),
    )
    for name, step in steps:
        t0 = time.perf_counter()
        out[name] = step()
        log(f"mesh {name} {time.perf_counter() - t0:.1f} s", gpu)
    del c64, corpus_t
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out["ivf"] = mesh_ivf(torch, pm, ivf_ops, mesh, dev, gpu, ivf_keep)
    log(f"mesh ivf {time.perf_counter() - t0:.1f} s", gpu)

    # (g) the entry points on the card
    t0 = time.perf_counter()
    entry.dryrun_multichip(MESH_SHARDS)
    fn, args = entry.entry()
    check(args[1].is_cuda, "entry() did not place its queries on the card")
    d, ids = fn(*args)
    check(tuple(ids.shape) == (16, 10) and bool(torch.isfinite(d).all())
          and bool((ids >= 0).all()), "entry()'s walk")
    out["entry_s"] = time.perf_counter() - t0
    log(f"mesh (g) dryrun_multichip({MESH_SHARDS}) and entry() on the card "
        f"{out['entry_s']:.1f} s", gpu)
    return out


# ---------------------------------------------------------------------------
# phase 9: the IVF tier beyond device memory, 100M rows from a chunk source
# ---------------------------------------------------------------------------


def ivf_streaming_phase(torch, dev, gpu, queries) -> dict:
    """build_ivf_streaming over N_STREAM_CHUNKS chunks generated on the card
    (the bench's 100M recipe), the exact ground truth of STREAM_GT queries
    riding the build's first sight of each chunk; ivf_search_batch and
    ivf_search_rescored_streaming at B = STREAM_B."""
    from valkey_search_tpu_torch.ops import ivf as ivf_ops

    n = N_STREAM_CHUNKS * STREAM_CHUNK
    corpus_bytes = n * D * 4
    rng = np.random.default_rng(42)
    centers = torch.as_tensor(
        rng.standard_normal((N_CENTERS, D)).astype(np.float32) * 60 + 128,
        device=dev)

    def generate(ci):
        gen = torch.Generator(device=dev).manual_seed(31_000 + ci)
        a = torch.randint(0, N_CENTERS, (STREAM_CHUNK,), generator=gen,
                          device=dev)
        z = torch.randn((STREAM_CHUNK, D), generator=gen, device=dev)
        return (centers[a] + z * 20).clamp_(0, 255)

    gtq = torch.from_numpy(queries[:STREAM_GT]).to(dev)
    gt_parts = {}

    def chunk(ci):
        xc = generate(ci)
        if ci not in gt_parts:
            dd = (xc * xc).sum(1)[None, :] - 2.0 * (gtq @ xc.T)
            v, am = torch.topk(dd, K, largest=False)
            part = (v.cpu().numpy(), am.cpu().numpy() + ci * STREAM_CHUNK)
            gt_parts[ci] = part  # stored once the device call returned
        return xc

    check(torch.equal(generate(0), generate(0)),
          "chunk 0 regenerated is not bit-equal")
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(dev)
    out = {"rows": n, "chunks": N_STREAM_CHUNKS,
           "allocated_before_gib": before / 2**30}
    torch.cuda.reset_peak_memory_stats(dev)
    timings = {}
    t0 = time.perf_counter()
    index = ivf_ops.build_ivf_streaming(
        chunk, N_STREAM_CHUNKS, block_rows=1024, block_align=1024,
        timings=timings, log_fn=lambda m: log(m, gpu))
    torch.cuda.synchronize()
    out["build_s"] = time.perf_counter() - t0
    out["stages_s"] = timings
    peak = torch.cuda.max_memory_allocated(dev)
    out["peak_gib"] = peak / 2**30
    out["build_peak_gib"] = (peak - before) / 2**30  # the build's own
    out["index_gib"] = index.device_bytes() / 2**30
    out["corpus_gib"] = corpus_bytes / 2**30
    out["n_blocks"] = index.n_blocks
    log("ivf_streaming build: " + json.dumps(out), gpu)
    check(len(gt_parts) == N_STREAM_CHUNKS,
          f"ground truth saw {len(gt_parts)} chunks")
    check(peak - before < corpus_bytes / 3,
          f"build peak {out['build_peak_gib']:.2f} GiB, not under a third "
          f"of the fp32 corpus's {out['corpus_gib']:.1f} GiB")
    gt = merged_gt(gt_parts, N_STREAM_CHUNKS)
    out["seed_spread"] = seed_spread(torch, ivf_ops, generate, gtq,
                                     gt_parts, gpu)

    # what a streamed rescore pays beside its search: the 154 chunks
    # regenerated, alone (CUDA events)
    ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    ev0.record()
    for ci in range(N_STREAM_CHUNKS):
        generate(ci)
    ev1.record()
    ev1.synchronize()
    out["regenerate_s"] = ev0.elapsed_time(ev1) / 1e3
    log(f"ivf_streaming: {N_STREAM_CHUNKS} chunks regenerated alone in "
        f"{out['regenerate_s']:.3f} s", gpu)

    hq = torch.from_numpy(queries[:STREAM_B]).to(dev)
    sweep = {}
    for probe in STREAM_PROBES:
        (_, ids), times = timed(torch, lambda: ivf_ops.ivf_search_batch(
            index, hq, k=K, probe=probe, probe_chunk=2), reps=3)
        sweep[f"probe={probe}"] = qps_record(STREAM_B, times,
                                             ids.cpu().numpy(), gt)
        log(f"ivf_streaming probe {probe} B={STREAM_B} (no rescore): "
            + json.dumps(sweep[f"probe={probe}"]), gpu)
    for probe in STREAM_RESCORED_PROBES:
        (_, ids), times = timed(
            torch, lambda: ivf_ops.ivf_search_rescored_streaming(
                index, hq, chunk, N_STREAM_CHUNKS, STREAM_CHUNK, k=K,
                probe=probe, probe_chunk=2), reps=3)
        sweep[f"rescored/probe={probe}"] = qps_record(
            STREAM_B, times, ids.cpu().numpy(), gt)
        log(f"ivf_streaming rescored probe {probe} B={STREAM_B}: "
            + json.dumps(sweep[f"rescored/probe={probe}"]), gpu)
    out["sweep"] = sweep
    r = sweep[f"rescored/probe={max(STREAM_RESCORED_PROBES)}"]["recall"]
    check(r >= RECALL_FLOOR, f"streaming rescored recall {r} at probe "
          f"{max(STREAM_RESCORED_PROBES)}")
    del index
    torch.cuda.empty_cache()
    return out


def merged_gt(gt_parts, n_chunks) -> np.ndarray:
    """The exact top K over chunks 0..n_chunks-1 from each chunk's own."""
    cand_v = np.concatenate([gt_parts[c][0] for c in range(n_chunks)], axis=1)
    cand_i = np.concatenate([gt_parts[c][1] for c in range(n_chunks)], axis=1)
    return np.take_along_axis(
        cand_i, np.argsort(cand_v, axis=1, kind="stable")[:, :K], 1)


def seed_spread(torch, ivf_ops, generate, gtq, gt_parts, gpu) -> dict:
    """build_ivf_streaming over the first SEED_CHUNKS chunks at each seed of
    SEED_BUILDS: build seconds and recall@K of the STREAM_GT queries at
    probe SEED_PROBE (no rescore) against those chunks' exact top K."""
    gt = merged_gt(gt_parts, SEED_CHUNKS)
    out = {}
    for seed in SEED_BUILDS:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        index = ivf_ops.build_ivf_streaming(
            generate, SEED_CHUNKS, block_rows=1024, block_align=1024,
            seed=seed)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        _, ids = ivf_ops.ivf_search_batch(index, gtq, k=K, probe=SEED_PROBE,
                                          probe_chunk=2)
        ids = ids.cpu().numpy()
        check(ids.shape == (len(gtq), K), f"seed {seed:#x}: ids {ids.shape}")
        out[f"{seed:#x}"] = {"rows": SEED_CHUNKS * STREAM_CHUNK,
                             "build_s": build_s, "n_blocks": index.n_blocks,
                             f"recall_probe{SEED_PROBE}": recall(ids, gt)}
        del index
        torch.cuda.empty_cache()
    log("ivf_streaming seed spread: " + json.dumps(out), gpu)
    return out


def bench_phase(torch, gpu: str) -> dict:
    """bench_torch.py --quick (flat1m alone, 131,072 rows, int8 and
    bfloat16) in a child process group: exit 0, the last line's length,
    JSON and device, int8 recall and the K1b / K2 launches of its run."""
    import signal

    root = os.path.dirname(os.path.abspath(__file__))
    script = os.path.join(root, "bench_torch.py")
    check(os.path.exists(script), "bench_torch.py is not beside chip_smoke.py")
    with tempfile.TemporaryDirectory() as out:
        t0 = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, script, "--quick", "--out", out], cwd=root,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            start_new_session=True)
        try:
            stdout, stderr = proc.communicate(timeout=BENCH_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGTERM)
            try:
                proc.communicate(timeout=20)
            except subprocess.TimeoutExpired:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.communicate()
            raise SmokeFailure(
                f"bench_torch.py --quick ran past {BENCH_TIMEOUT_S} s")
        wall = time.perf_counter() - t0
        check(proc.returncode == 0,
              f"bench_torch.py --quick exited {proc.returncode}: "
              f"{stderr[-3000:]}")
        lines = stdout.strip().splitlines()
        check(bool(lines), "bench_torch.py --quick printed nothing")
        last = lines[-1]
        check(len(last) <= BENCH_LINE_MAX,
              f"bench_torch.py's last line is {len(last)} characters")
        try:
            line = json.loads(last)
            with open(os.path.join(out, "details.json")) as f:
                details = json.load(f)
        except (OSError, ValueError) as exc:
            raise SmokeFailure(f"bench_torch.py --quick output: {exc}")
    device = line.get("device", {})
    check(device.get("platform") == "gpu"
          and device.get("kind") == torch.cuda.get_device_name(0)
          and device.get("power_limit") in gpu,
          f"bench_torch.py names the device {device}, not {gpu}")
    check("flat1m_int8" in details and "flat1m_bfloat16" in details,
          f"bench_torch.py --quick: flat1m did not land "
          f"({details.get('skip_flat1m')})")
    r = details["flat1m_int8"]["recall"]
    check(r >= RECALL_FLOOR, f"bench_torch.py --quick int8 recall@10 {r}")
    launches = {}
    for dtype in ("int8", "bfloat16"):
        _merge_launches(launches, details[f"flat1m_{dtype}"]["launches"])
    k1b_k2 = (launches.get("bucket_scan_i8_packed[pre_shift>0]", 0)
              + launches.get("bucket_scan_bf16", 0))
    check(k1b_k2 > 0, f"bench_torch.py --quick launched no K1b or K2: "
          f"{launches}")
    out = {"wall_s": wall, "exit": proc.returncode, "line_chars": len(last),
           "value": line.get("value"), "int8_recall": r,
           "bf16_recall": details["flat1m_bfloat16"]["recall"],
           "launches": launches, "headlines": line.get("headlines")}
    log("bench phase: " + json.dumps(out), gpu)
    return out


def main() -> int:
    import torch

    check(torch.cuda.is_available(), "no CUDA device: this script needs a GPU")
    try:
        from valkey_search_tpu_torch.ops import _build
        from valkey_search_tpu_torch.ops import bucket_scan as bs
        from valkey_search_tpu_torch.runtime import device
        from valkey_search_tpu_torch.text.lexer import Lexer
    except ImportError as exc:
        raise SmokeFailure(
            f"run from the root of a checkout of the repository ({exc})")

    gpu = card()
    dev = device.set_device("cuda")
    free, total = torch.cuda.mem_get_info(dev)
    log(f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}"
        f", torch {torch.__version__}, CUDA {torch.version.cuda}, memory "
        f"free {free / 2**30:.1f} GiB of {total / 2**30:.1f} GiB", gpu)

    t0 = time.perf_counter()
    # the native text tier (g++) builds beside the kernels; without it the
    # text index serves from its Python tier, which the slice reports
    text_tier = threading.Thread(target=lambda: Lexer().tokenize("warm up"))
    text_tier.start()
    sources = ("bucket_scan_i8_packed", "bucket_scan_bf16")
    with ThreadPoolExecutor(len(sources)) as pool:  # one nvcc per source
        list(pool.map(_build.load, sources))
    for name in sources:
        secs, report = _build.BUILD_INFO[name]
        log(f"built {name} in {secs:.1f} s; ptxas: "
            + " | ".join(line.strip() for line in report.splitlines()
                         if "registers" in line or "spill" in line), gpu)
    text_tier.join()
    log(f"build phase {time.perf_counter() - t0:.1f} s", gpu)

    t0 = time.perf_counter()
    records = kernel_phase(torch, bs, dev, gpu)
    log(f"kernel phase {time.perf_counter() - t0:.1f} s", gpu)

    # bench_torch.py --quick in its own processes: its launches are its own
    # and never reach this process's counts
    t0 = time.perf_counter()
    bench_phase(torch, gpu)
    log(f"bench phase {time.perf_counter() - t0:.1f} s", gpu)

    t0 = time.perf_counter()
    data = {}
    stats = slice_phase(torch, bs, dev, gpu, data)
    log(f"slice phase {time.perf_counter() - t0:.1f} s", gpu)
    log("slice stats " + json.dumps(stats), gpu)
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    hnsw = hnsw_phase(torch, bs, dev, gpu)
    log(f"hnsw phase {time.perf_counter() - t0:.1f} s", gpu)
    log("hnsw stats " + json.dumps(hnsw), gpu)
    _merge_launches(stats["launches"], hnsw["launches"])

    t0 = time.perf_counter()
    ivf = {"launches": {}}
    ivf_keep = {}
    ivf_phase(torch, bs, dev, gpu, ivf, ivf_keep)
    ivf["wall_s"] = time.perf_counter() - t0
    log(f"ivf phase {ivf['wall_s']:.1f} s", gpu)
    log("ivf stats " + json.dumps(ivf), gpu)
    _merge_launches(stats["launches"], ivf["launches"])
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    cluster = cluster_phase(torch, bs, dev, gpu, data["corpus"],
                            data["queries"], data["cats"])
    cluster["wall_s"] = time.perf_counter() - t0
    log(f"cluster phase {cluster['wall_s']:.1f} s", gpu)
    log("cluster stats " + json.dumps(cluster), gpu)
    _merge_launches(stats["launches"], cluster["launches"])
    torch.cuda.empty_cache()

    # neither phase below reaches K1-K3 but for mesh (e2)'s exact scans,
    # which count their own: any other launch there would be a fault
    bs.reset_launches()
    t0 = time.perf_counter()
    mesh = mesh_phase(torch, dev, gpu, data["corpus"], data["queries"],
                      data["cats"], ivf_keep)
    mesh["wall_s"] = time.perf_counter() - t0
    ivf_keep.clear()
    torch.cuda.empty_cache()
    log(f"mesh phase {mesh['wall_s']:.1f} s", gpu)
    log("mesh stats " + json.dumps(mesh), gpu)

    t0 = time.perf_counter()
    streaming = ivf_streaming_phase(torch, dev, gpu, data["queries"])
    streaming["wall_s"] = time.perf_counter() - t0
    log(f"ivf_streaming phase {streaming['wall_s']:.1f} s", gpu)
    log("ivf_streaming stats " + json.dumps(streaming), gpu)
    exact = mesh["hnsw_exact"]["launches"]
    late = {k: v - exact.get(k, 0) for k, v in bs.launch_counts().items()}
    late = {k: v for k, v in late.items() if v}
    check(not late, f"the mesh and ivf_streaming phases launched {late} "
          "outside mesh (e2)")

    replaces = {
        "bucket_scan_i8_packed[pre_shift=0]":
            ("valkey_search_tpu_torch/csrc/bucket_scan_i8_packed.cu",
             "valkey_search_tpu/ops/pallas_scan.py:418"),
        "bucket_scan_i8_packed[pre_shift>0]":
            ("valkey_search_tpu_torch/csrc/bucket_scan_i8_packed.cu",
             "valkey_search_tpu/ops/pallas_scan.py:442"),
        "bucket_scan_bf16":
            ("valkey_search_tpu_torch/csrc/bucket_scan_bf16.cu",
             "valkey_search_tpu/ops/pallas_scan.py:164"),
        "bucket_scan_i8":
            ("valkey_search_tpu_torch/csrc/bucket_scan_i8_packed.cu",
             "valkey_search_tpu/ops/pallas_scan.py:589"),
    }
    kernels = []
    for name, (source, tpu) in replaces.items():
        rec = records[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": tpu,
            # the main path's count; K3 has no search path, so its 0 stands
            # beside the kernel phase's check_launches
            "launches": stats["launches"].get(name, 0), **rec,
        })
    log(f"all phases {time.perf_counter() - _T0:.1f} s", gpu)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(gpu, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        # on both streams: a caller that keeps only one still sees why
        print(f"FAIL: {exc}", flush=True)
        print(f"FAIL: {exc}", file=sys.stderr, flush=True)
        sys.exit(1)
