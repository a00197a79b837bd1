"""Patricia (prefix) tree for keyspace-prefix subscription dispatch.

Reference: src/utils/patricia_tree.h (338 LoC) — the KeyspaceEventManager
matches each mutated key against subscribed index prefixes via a
path-compressed prefix tree instead of scanning every schema
(keyspace_event_manager.h:52-58). Same role here: SchemaManager
registers each schema under its prefixes; a key lookup walks at most
len(key) characters and returns every subscriber whose prefix covers it.

The port's own copy of valkey_search_tpu/utils/patricia.py: the same
names, defaults and behaviour, with its imports pointing into
valkey_search_tpu_torch.
"""

from __future__ import annotations

import threading
from typing import Dict, Iterator, List, Set, Tuple


class _Node:
    __slots__ = ("children", "subscribers")

    def __init__(self):
        self.children: Dict[str, Tuple[str, "_Node"]] = {}
        self.subscribers: Set[object] = set()


class PatriciaTree:
    """prefix → set of subscribers; match(key) yields every subscriber
    registered under any prefix of key (including the "" catch-all)."""

    def __init__(self):
        self._root = _Node()
        self._lock = threading.RLock()

    def insert(self, prefix: str, subscriber: object) -> None:
        with self._lock:
            node = self._root
            rest = prefix
            while rest:
                edge = node.children.get(rest[0])
                if edge is None:
                    child = _Node()
                    node.children[rest[0]] = (rest, child)
                    node = child
                    rest = ""
                    break
                label, child = edge
                common = 0
                n = min(len(label), len(rest))
                while common < n and label[common] == rest[common]:
                    common += 1
                if common == len(label):
                    node = child
                    rest = rest[common:]
                    continue
                mid = _Node()
                mid.children[label[common]] = (label[common:], child)
                node.children[rest[0]] = (label[:common], mid)
                node = mid
                rest = rest[common:]
            node.subscribers.add(subscriber)

    def remove(self, prefix: str, subscriber: object) -> None:
        with self._lock:
            node = self._root
            rest = prefix
            while rest:
                edge = node.children.get(rest[0])
                if edge is None:
                    return
                label, child = edge
                if not rest.startswith(label):
                    return
                node = child
                rest = rest[len(label):]
            node.subscribers.discard(subscriber)

    def match(self, key: str) -> List[object]:
        """All subscribers whose prefix covers `key` — O(len(key))."""
        out: List[object] = []
        with self._lock:
            node = self._root
            out.extend(node.subscribers)
            rest = key
            while rest:
                edge = node.children.get(rest[0])
                if edge is None:
                    break
                label, child = edge
                if len(label) <= len(rest):
                    if not rest.startswith(label):
                        break
                    node = child
                    out.extend(node.subscribers)
                    rest = rest[len(label):]
                else:
                    break  # prefix longer than remaining key → no cover
        return out
