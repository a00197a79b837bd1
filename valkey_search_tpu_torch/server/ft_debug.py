"""FT._DEBUG — test/inspection command surface.

The port's own copy of valkey_search_tpu/server/ft_debug.py (reference
src/commands/ft_debug.cc:95-365): PAUSEPOINT SET/RESET/TEST/LIST,
CONTROLLED_VARIABLE GET/SET/LIST, metrics/config listing,
STRING_POOL_STATS, SHOW_METADATA, SHOW_INDEX. Mutating debug controls are
gated behind `search.debug-mode` (module_config.h:222-227). PROFILE starts
and stops ``torch.profiler`` (host activity, and the card's when the port
runs on one) and writes a Chrome trace into the given directory, where the
JAX package captures a ``jax.profiler`` trace."""

from __future__ import annotations

import os
import threading
import time
from typing import List

from valkey_search_tpu_torch.runtime import config
from valkey_search_tpu_torch.runtime.debug import CONTROLLED, PAUSEPOINTS, TEST_COUNTERS
from valkey_search_tpu_torch.runtime.metrics import STATS


class FTDebugError(ValueError):
    pass


# the running torch.profiler capture: (profiler, output directory)
_PROFILE = None
_PROFILE_LOCK = threading.Lock()


def _profile_start(out_dir: str) -> None:
    global _PROFILE
    from torch.profiler import ProfilerActivity, profile

    from valkey_search_tpu_torch.runtime.device import get_device

    with _PROFILE_LOCK:
        if _PROFILE is not None:
            raise FTDebugError("a PROFILE capture is already running")
        activities = [ProfilerActivity.CPU]
        if get_device().type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)
        prof.start()
        _PROFILE = (prof, out_dir)


def _profile_stop() -> None:
    global _PROFILE
    import torch

    with _PROFILE_LOCK:
        if _PROFILE is None:
            raise FTDebugError("no PROFILE capture is running")
        prof, out_dir = _PROFILE
        _PROFILE = None
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.stop()
    os.makedirs(out_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(
        out_dir, f"torch_profile_{int(time.time() * 1000)}.json"))


def _require_debug_mode() -> None:
    if not config.get("search.debug-mode"):
        raise FTDebugError(
            "FT._DEBUG control requires CONFIG SET search.debug-mode yes"
        )


def run_ft_debug(engine, args: List[str]) -> object:
    if not args:
        raise FTDebugError(
            "FT._DEBUG subcommand required: PAUSEPOINT | CONTROLLED_VARIABLE |"
            " TEST_COUNTER | SHOW_INDEX | SHOW_METADATA | STRING_POOL_STATS |"
            " METRICS | CONFIG | RESET"
        )
    sub = args[0].upper()
    # reference spelling aliases (ft_debug.cc subcommand table) so scripts
    # written against valkey-search work verbatim
    sub = {
        "SHOW_INDEXSCHEMAS": "SHOW_INDEX",
        "STRINGPOOLSTATS": "STRING_POOL_STATS",
        "LIST_METRICS": "METRICS",
        "LIST_CONFIGS": "CONFIG",
    }.get(sub, sub)
    rest = args[1:]

    if sub == "PAUSEPOINT":
        _require_debug_mode()
        if not rest:
            raise FTDebugError("PAUSEPOINT SET|RESET|TEST|LIST")
        op = rest[0].upper()
        if op == "LIST":
            return PAUSEPOINTS.list()
        if len(rest) < 2:
            raise FTDebugError(f"PAUSEPOINT {op} needs a name")
        name = rest[1]
        if op == "SET":
            PAUSEPOINTS.pause(name)
            return "OK"
        if op == "RESET":
            PAUSEPOINTS.resume(name)
            return "OK"
        if op == "TEST":
            return ["paused", int(PAUSEPOINTS.is_paused(name)),
                    "hits", PAUSEPOINTS.hits(name),
                    "waiting", PAUSEPOINTS.waiting(name)]
        raise FTDebugError(f"unknown PAUSEPOINT op {op!r}")

    if sub == "CONTROLLED_VARIABLE":
        _require_debug_mode()
        if not rest:
            raise FTDebugError("CONTROLLED_VARIABLE GET|SET|LIST")
        op = rest[0].upper()
        if op == "LIST":
            out: List[object] = []
            for k, v in sorted(CONTROLLED.list().items()):
                out += [k, v]
            return out
        if op == "GET":
            if len(rest) < 2:
                raise FTDebugError("CONTROLLED_VARIABLE GET needs a name")
            return CONTROLLED.get(rest[1])
        if op == "SET":
            if len(rest) < 3:
                raise FTDebugError("CONTROLLED_VARIABLE SET needs name + value")
            CONTROLLED.set(rest[1], rest[2])
            return "OK"
        raise FTDebugError(f"unknown CONTROLLED_VARIABLE op {op!r}")

    if sub == "TEST_COUNTER":
        _require_debug_mode()
        if rest and rest[0].upper() == "GET":
            if len(rest) < 2:
                raise FTDebugError("TEST_COUNTER GET needs a name")
            return TEST_COUNTERS.get(rest[1])
        out = []
        for k, v in sorted(TEST_COUNTERS.list().items()):
            out += [k, v]
        return out

    if sub == "SHOW_INDEX":
        def _one(schema):
            st = schema.stats()
            out = []
            for k, v in st.items():
                out += [k, v]
            if getattr(schema, "text_engine", None) is not None:
                for k, v in schema.text_engine.stats().items():
                    out += [f"text_{k}", v]
            return out

        if not rest:
            # reference SHOW_INDEXSCHEMAS: dump every schema's tables
            out = []
            for schema in engine.manager.all_schemas():
                out += [schema.name, _one(schema)]
            return out
        return _one(engine.manager.get(rest[0]))

    if sub == "SHOW_METADATA":
        mm = getattr(engine, "metadata", None)
        if mm is None:
            return []
        out = []
        for name, entry in sorted(mm.entries().items()):
            out += [name, ["version", entry.version,
                           "fingerprint", entry.fingerprint]]
        return out

    if sub == "STRING_POOL_STATS":
        total_keys = 0
        total_capacity = 0
        for schema in engine.manager.all_schemas():
            total_keys += schema.interner.count
            total_capacity += schema.interner.capacity
        return ["interned_keys", total_keys, "id_capacity", total_capacity,
                "keyspace_keys", len(engine.keyspace)]

    if sub == "METRICS":
        # reference LIST_METRICS [APP|DEV] [NAMES_ONLY] (ft_debug.cc:333);
        # all counters are exported either way, NAMES_ONLY drops values
        opts = {t.upper() for t in rest}
        names_only = "NAMES_ONLY" in opts
        out = []
        for k, v in sorted(STATS.snapshot().items()):
            out += [k] if names_only else [k, v]
        return out

    if sub == "CONFIG":
        # reference LIST_CONFIGS [VERBOSE] [APP|DEV|HIDDEN] (ft_debug.cc:335)
        opts = {t.upper() for t in rest}
        out = []
        for k, v in sorted(config.REGISTRY.snapshot(include_hidden=True).items()):
            out += [k] if "NAMES_ONLY" in opts else [k, v]
        return out

    if sub == "PROFILE":
        # torch.profiler trace capture (the reference is metrics-first; the
        # added capability is a real device trace)
        _require_debug_mode()
        if not rest:
            raise FTDebugError("PROFILE START <dir> | STOP")
        op = rest[0].upper()
        if op == "START":
            if len(rest) < 2:
                raise FTDebugError("PROFILE START needs a directory")
            _profile_start(rest[1])
            return "OK"
        if op == "STOP":
            _profile_stop()
            return "OK"
        raise FTDebugError(f"unknown PROFILE op {op!r}")

    if sub == "RESET":
        _require_debug_mode()
        from valkey_search_tpu_torch.runtime import debug as dbg

        dbg.reset_all()
        return "OK"

    if sub == "SHOW_INFO":
        # flat dump of every INFO field (reference info_field::ShowInfo,
        # ft_debug.cc:360-361): dev fields included
        out = []
        for k, v in sorted(engine.info(include_dev=None).items()):
            out += [k, v]
        return out

    if sub == "TEXTINFO":
        # reference IndexSchema::TextInfoCmd (textinfocmd.cc:81-130):
        # PREFIX/SUFFIX/STEM word-iterator dumps over the schema text index
        if len(rest) < 3:
            raise FTDebugError(
                "TEXTINFO <index> PREFIX|SUFFIX|STEM <word> "
                "[WITHKEYS] [WITHPOSITIONS]")
        schema = engine.manager.get(rest[0])
        te = getattr(schema, "text_engine", None)
        if te is None:
            raise FTDebugError(f"index {rest[0]!r} has no TEXT attributes")
        op = rest[1].upper()
        word = rest[2]
        with_keys = any(a.upper() == "WITHKEYS" for a in rest[3:])
        with_pos = any(a.upper() == "WITHPOSITIONS" for a in rest[3:])

        def dump_word(w):
            p = te._words.get(w)
            if p is None:
                return [w, 0]
            row = [w, p.key_count()]
            if with_keys:
                keys = []
                for doc in sorted(p.docs()):
                    key = schema.interner.key_of(int(doc))
                    if key is None:
                        continue
                    if with_pos:
                        keys.append([key, p.positions(int(doc))])
                    else:
                        keys.append(key)
                row.append(keys)
            return row

        if op == "PREFIX":
            with te._lock:
                return [dump_word(w) for w, _ in te.dictionary.items(word)]
        if op == "SUFFIX":
            if not te._any_suffix_trie():
                raise FTDebugError("Suffix is not enabled")
            with te._lock:
                out = []
                for _rev, bag in te.suffix.items(word[::-1]):
                    for w in sorted(bag):
                        out.append(dump_word(w))
                return out
        if op == "STEM":
            with te._lock:
                if te._nt is not None:
                    # native stem table: exact-stem parent lookup
                    parents = te._nt.stem_parents(word)
                    return [word, sorted(parents)] if parents else []
                out = []
                for st in sorted(te._stems):
                    if not st.startswith(word):
                        continue
                    out += [st, sorted(te._stems[st])]
                return out
        raise FTDebugError(f"unknown TEXTINFO op {op!r}")

    if sub == "HELP":
        help_text = [
            ("FT._DEBUG SHOW_INFO", "Show Info Variable Information"),
            ("FT._DEBUG CONTROLLED_VARIABLE SET <variable> <value>",
             "Set a controlled variable"),
            ("FT._DEBUG CONTROLLED_VARIABLE GET <variable>",
             "Get a controlled variable"),
            ("FT._DEBUG CONTROLLED_VARIABLE LIST",
             "list all controlled variables and their values"),
            ("FT._DEBUG PAUSEPOINT [ SET | RESET | TEST | LIST] <pausepoint>",
             "control pause points"),
            ("FT._DEBUG TEXTINFO <index> ...",
             "show info about schema-level text"),
            ("FT._DEBUG STRING_POOL_STATS", "Show InternStringPool Stats"),
            ("FT._DEBUG SHOW_METADATA",
             "list internal metadata manager table namespace"),
            ("FT._DEBUG SHOW_INDEX", "list internal index schema tables"),
            ("FT._DEBUG METRICS", "List metrics"),
            ("FT._DEBUG CONFIG", "List config entries with values"),
            ("FT._DEBUG TEST_COUNTER [GET <name>]", "test counters"),
            ("FT._DEBUG PROFILE START <dir> | STOP", "torch.profiler trace capture"),
            ("FT._DEBUG RESET", "reset all debug controls"),
        ]
        out = []
        for cmd, desc in help_text:
            out += [cmd, desc]
        return out

    raise FTDebugError(f"unknown FT._DEBUG subcommand {sub!r}")
