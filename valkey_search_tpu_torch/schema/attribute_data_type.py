"""Attribute data types: HASH field fetch vs JSON path fetch.

Reference: src/attribute_data_type.{h,cc} — HashAttributeDataType (:83)
reads hash fields directly; JsonAttributeDataType (:117) fetches
attribute identifiers as JSONPath expressions via the JSON module's
`JSON.GET` (attribute_data_type.h:114) and normalizes scalars/arrays
into indexable values. Index identifiers for ON JSON schemas are paths
like `$.field` or `$.nested.arr[0]`; a numeric array resolves to a
vector, scalars to tag/text/numeric values.

The port's own copy of valkey_search_tpu/schema/attribute_data_type.py:
the same names, defaults and behaviour.
"""

from __future__ import annotations

import json
import re
from typing import Any, Dict, Optional


class HashDataType:
    """ON HASH: identifier == hash field name."""

    kind = "HASH"

    def fetch(self, fields: Dict[str, object], identifier: str):
        return fields.get(identifier)


_PATH_TOKEN = re.compile(r"\.([^.\[\]]+)|\[(\d+|\*)\]")


def resolve_json_path(obj: Any, path: str):
    """Resolve a (restricted) JSONPath: `$`, `$.a.b`, `$.a[2].c`.
    Returns None when the path doesn't resolve (reference: missing
    attribute → record removed for that attribute)."""
    if path == "$":
        return obj
    if not path.startswith("$"):
        # bare field names allowed as a convenience (Redisearch accepts
        # both `foo` and `$.foo` for JSON schemas)
        path = "$." + path
    pos = 1
    cur = obj
    while pos < len(path):
        m = _PATH_TOKEN.match(path, pos)
        if m is None:
            return None
        field, idx = m.group(1), m.group(2)
        if field is not None:
            if not isinstance(cur, dict) or field not in cur:
                return None
            cur = cur[field]
        elif idx == "*":
            # wildcard (Redisearch `$.tags[*]`): map the remaining path
            # over the array, collecting resolved elements
            if not isinstance(cur, list):
                return None
            rest = path[m.end():]
            if not rest:
                return list(cur)
            out = []
            for el in cur:
                sub = resolve_json_path(el, "$" + rest)
                if sub is not None:
                    out.append(sub)
            return out or None
        else:
            i = int(idx)
            if not isinstance(cur, list) or i >= len(cur):
                return None
            cur = cur[i]
        pos = m.end()
    return cur


class JsonDataType:
    """ON JSON: document stored as the serialized JSON under the `$` field;
    identifiers are JSON paths."""

    kind = "JSON"

    def fetch(self, fields: Dict[str, object], identifier: str):
        raw = fields.get("$")
        if raw is None:
            return None
        cache_key = id(raw)
        cached = getattr(self, "_cache", None)
        if cached is not None and cached[0] == cache_key:
            doc = cached[1]
        else:
            try:
                if isinstance(raw, (bytes, bytearray)):
                    raw = bytes(raw).decode()
                doc = json.loads(raw) if isinstance(raw, str) else raw
            except (ValueError, UnicodeDecodeError):
                return None
            self._cache = (cache_key, doc)
        val = resolve_json_path(doc, identifier)
        return normalize_json_value(val)


def normalize_json_value(val: Any):
    """JSON scalar/array → indexable value (reference normalization:
    numbers → numeric strings, bools → tag strings, float arrays →
    vectors)."""
    if val is None:
        return None
    if isinstance(val, bool):
        return "true" if val else "false"
    if isinstance(val, (int, float)):
        return repr(float(val)) if isinstance(val, float) else str(val)
    if isinstance(val, str):
        return val
    if isinstance(val, list):
        if val and all(isinstance(x, (int, float)) and not isinstance(x, bool)
                       for x in val):
            return [float(x) for x in val]  # vector
        if all(isinstance(x, str) for x in val):
            return ",".join(val)  # tag list → separator-joined
        return None
    return None


def data_type_for(on: str):
    if on == "JSON":
        return JsonDataType()
    return HashDataType()
