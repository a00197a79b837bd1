"""Path-compressed radix tree over the word dictionary.

Copied unchanged from valkey_search_tpu/text/radix.py.

Reference: src/indexes/text/radix_tree.h (996 LoC) wrapping vendored
antirez rax (rax.c): O(len) prefix word-count for the query planner,
WordIterator for prefix walks, and a path iterator the fuzzy matcher
drives with a Levenshtein automaton (fuzzy.h).

This is an independent design: nodes hold compressed edge labels and a
maintained subtree word count, so `prefix_count` is O(len(prefix)) and
fuzzy search walks the tree with a classic Levenshtein DP row per edge
character, pruning whole subtrees once min(row) > max_dist.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List, Optional, Tuple


class _Node:
    __slots__ = ("children", "value", "has_value", "count")

    def __init__(self):
        self.children: Dict[str, Tuple[str, "_Node"]] = {}  # first char -> (label, node)
        self.value: Any = None
        self.has_value = False
        self.count = 0  # words in this subtree (including self)


class RadixTree:
    """word -> value map with prefix counting, ordered walks, fuzzy walk."""

    def __init__(self):
        self._root = _Node()

    def memory_bytes(self) -> int:
        """Rough resident bytes (nodes + edge labels) for the engine's
        memory accounting."""
        total = 0
        stack = [self._root]
        while stack:
            node = stack.pop()
            total += 120  # node object + children dict overhead
            for _first, (label, child) in node.children.items():
                total += 60 + 2 * len(label)
                stack.append(child)
        return total

    def __len__(self) -> int:
        return self._root.count

    # -- mutation -------------------------------------------------------------
    def insert(self, word: str, value: Any) -> bool:
        """Insert/overwrite. Returns True if the word is new."""
        if not word:
            raise ValueError("empty word")
        path: List[_Node] = []
        node = self._root
        rest = word
        while True:
            path.append(node)
            if not rest:
                new = not node.has_value
                node.value = value
                node.has_value = True
                if new:
                    for p in path:
                        p.count += 1
                return new
            edge = node.children.get(rest[0])
            if edge is None:
                child = _Node()
                child.value = value
                child.has_value = True
                child.count = 1
                node.children[rest[0]] = (rest, child)
                for p in path:
                    p.count += 1
                return True
            label, child = edge
            common = _common_prefix_len(label, rest)
            if common == len(label):
                node = child
                rest = rest[common:]
                continue
            # Split the edge at `common`.
            mid = _Node()
            mid.children[label[common]] = (label[common:], child)
            mid.count = child.count
            node.children[rest[0]] = (label[:common], mid)
            node = mid
            rest = rest[common:]

    def remove(self, word: str) -> bool:
        """Remove a word. Returns True if it was present."""
        stack: List[Tuple[_Node, str]] = []  # (parent, edge first char)
        node = self._root
        rest = word
        while rest:
            edge = node.children.get(rest[0])
            if edge is None:
                return False
            label, child = edge
            if not rest.startswith(label):
                return False
            stack.append((node, rest[0]))
            node = child
            rest = rest[len(label):]
        if not node.has_value:
            return False
        node.has_value = False
        node.value = None
        node.count -= 1
        for parent, _ in stack:
            parent.count -= 1
        # Prune/merge upward.
        for parent, ch in reversed(stack):
            label, child = parent.children[ch]
            if child.count == 0:
                del parent.children[ch]
            elif not child.has_value and len(child.children) == 1:
                (clabel, cchild), = child.children.values()
                parent.children[ch] = (label + clabel, cchild)
            else:
                break
        return True

    # -- lookup ---------------------------------------------------------------
    def get(self, word: str) -> Optional[Any]:
        node = self._find(word)
        return node.value if node is not None and node.has_value else None

    def __contains__(self, word: str) -> bool:
        node = self._find(word)
        return node is not None and node.has_value

    def _find(self, word: str) -> Optional[_Node]:
        node = self._root
        rest = word
        while rest:
            edge = node.children.get(rest[0])
            if edge is None:
                return None
            label, child = edge
            if not rest.startswith(label):
                return None
            node = child
            rest = rest[len(label):]
        return node

    def _find_prefix(self, prefix: str) -> Optional[Tuple[_Node, str]]:
        """Locate the node covering `prefix`; returns (node, remaining label
        chars under the node's incoming edge)."""
        node = self._root
        rest = prefix
        while rest:
            edge = node.children.get(rest[0])
            if edge is None:
                return None
            label, child = edge
            common = _common_prefix_len(label, rest)
            if common == len(rest):
                return child, label[common:]
            if common < len(label):
                return None
            node = child
            rest = rest[common:]
        return node, ""

    def prefix_count(self, prefix: str) -> int:
        """Words starting with prefix — O(len(prefix)) via subtree counts
        (reference radix_tree.h prefix-count for planner sizing)."""
        if not prefix:
            return self._root.count
        hit = self._find_prefix(prefix)
        return hit[0].count if hit else 0

    # -- walks ----------------------------------------------------------------
    def items(self, prefix: str = "") -> Iterator[Tuple[str, Any]]:
        """Ordered (word, value) walk of a prefix subtree (WordIterator)."""
        if not prefix:
            yield from _walk(self._root, "")
            return
        hit = self._find_prefix(prefix)
        if hit is None:
            return
        node, pending = hit
        yield from _walk(node, prefix + pending)

    def keys(self, prefix: str = "") -> Iterator[str]:
        for w, _ in self.items(prefix):
            yield w

    def fuzzy(self, word: str, max_dist: int) -> Iterator[Tuple[str, Any, int]]:
        """All (dict_word, value, distance) with Levenshtein distance
        <= max_dist (reference fuzzy.h: Levenshtein automaton over the
        rax path iterator). DP-row walk with subtree pruning."""
        n = len(word)
        first_row = list(range(n + 1))
        stack: List[Tuple[_Node, str, List[int]]] = [(self._root, "", first_row)]
        while stack:
            node, built, row = stack.pop()
            if node.has_value and row[-1] <= max_dist:
                yield built, node.value, row[-1]
            for label, child in node.children.values():
                cur = row
                ok = True
                for ch in label:
                    nxt = [cur[0] + 1]
                    for j in range(1, n + 1):
                        cost = 0 if word[j - 1] == ch else 1
                        nxt.append(min(nxt[j - 1] + 1, cur[j] + 1, cur[j - 1] + cost))
                    cur = nxt
                    if min(cur) > max_dist:
                        ok = False
                        break
                if ok:
                    stack.append((child, built + label, cur))


def _common_prefix_len(a: str, b: str) -> int:
    n = min(len(a), len(b))
    i = 0
    while i < n and a[i] == b[i]:
        i += 1
    return i


def _walk(node: _Node, built: str) -> Iterator[Tuple[str, Any]]:
    if node.has_value:
        yield built, node.value
    for first in sorted(node.children):
        label, child = node.children[first]
        yield from _walk(child, built + label)
