"""Logging: leveled, rate-limited, redaction-aware.

Reference: vmsdk/src/log.{h,cc} — VMSDK_LOG(level, ctx) bridged to
ValkeyModule_Log with a module log-level config, VMSDK_LOG_EVERY_N_SEC
rate limiting, and user-data redaction (RedactIfNeeded,
module_config.h:50-57) so keys/queries never leak into logs unless
explicitly allowed.

The port's own copy of valkey_search_tpu/runtime/log.py, with its imports
pointing into valkey_search_tpu_torch.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Dict

from valkey_search_tpu_torch.runtime import config

_logger = logging.getLogger("valkey_search_tpu_torch")
_rate_lock = threading.Lock()
_last_emit: Dict[str, float] = {}

LEVELS = {
    "debug": logging.DEBUG,
    "verbose": logging.INFO,
    "notice": logging.WARNING,
    "warning": logging.ERROR,
}


def _enabled(level: str) -> bool:
    want = str(config.get("search.log-level"))
    order = ["debug", "verbose", "notice", "warning"]
    try:
        return order.index(level) >= order.index(want)
    except ValueError:
        return True


def log(level: str, msg: str, *args) -> None:
    """VMSDK_LOG equivalent."""
    if _enabled(level):
        _logger.log(LEVELS.get(level, logging.INFO), msg, *args)


def log_every_n_sec(level: str, key: str, period_s: float, msg: str, *args) -> None:
    """VMSDK_LOG_EVERY_N_SEC: at most one emission per key per period."""
    now = time.monotonic()
    with _rate_lock:
        last = _last_emit.get(key, 0.0)
        if now - last < period_s:
            return
        _last_emit[key] = now
    log(level, msg, *args)


def redact(user_data: str) -> str:
    """User-data redaction (reference RedactIfNeeded): keys, queries and
    field values are hidden unless search.log-user-data is enabled."""
    if config.get("search.log-user-data"):
        return user_data
    return f"<redacted:{len(str(user_data))}B>"
