"""The benchmark of valkey_search_tpu_torch: FT.SEARCH served over RESP.

``python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json``. Everything that belongs
to one configuration, traffic mix or metric is a file of its own, found by
name: ``configs/<config>.json``, ``traffic/<mix>.json`` and
``metrics/<metric>.py``.
"""
