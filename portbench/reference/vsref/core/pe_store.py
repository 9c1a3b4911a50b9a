"""Indexed store for pairwise PE-link counts.

The reference keeps PE counts in a flat dict keyed by lexicographic
(min(u,v), max(u,v)) id pairs and, at every node split/merge, rescans all
O(N^2) keys to invalidate the mutated node's pairs
(VStrains_Decomposition.py:496-503, 614-617, Utilities:496-499). On a
1000-node graph that scan dominates disentanglement wall time.

PEInfo is a drop-in MutableMapping with a per-node key index, making
"drop every pair touching node X" O(degree of X in the pair map) instead
of O(N^2), plus an O(#None) normalize for the split-invalidation sweep.
All algorithm call sites go through the polymorphic helpers below, so
plain dicts (tests, checkpoints) keep working.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, Iterable, MutableMapping, Tuple

Key = Tuple[str, str]


class PEInfo(MutableMapping):
    def __init__(self, items=None):
        self._d: Dict[Key, object] = {}
        self._by_node: Dict[str, set] = defaultdict(set)
        self._none_keys: set = set()
        if items:
            for k, v in (items.items()
                         if hasattr(items, "items") else items):
                self[k] = v

    # --- MutableMapping interface ---
    def __getitem__(self, key: Key):
        # dense contract: the reference zero-initializes every node pair
        # (VStrains_IO.py:598-602); missing pairs read as 0 so the store
        # can stay sparse
        return self._d.get(key, 0)

    def __setitem__(self, key: Key, value) -> None:
        if key not in self._d:
            self._by_node[key[0]].add(key)
            self._by_node[key[1]].add(key)
        if value is None:
            self._none_keys.add(key)
        else:
            self._none_keys.discard(key)
        self._d[key] = value

    def __delitem__(self, key: Key) -> None:
        del self._d[key]
        self._by_node[key[0]].discard(key)
        self._by_node[key[1]].discard(key)
        self._none_keys.discard(key)

    def __iter__(self):
        return iter(self._d)

    def __len__(self):
        return len(self._d)

    def __contains__(self, key) -> bool:
        return key in self._d

    # --- fast paths ---
    def pop_node(self, no: str) -> None:
        """Drop every pair touching node `no`."""
        for key in list(self._by_node.get(no, ())):
            if key in self._d:
                del self[key]
        self._by_node.pop(no, None)

    def normalize_none(self) -> None:
        """Replace every None marker with 0."""
        for key in list(self._none_keys):
            self._d[key] = 0
        self._none_keys.clear()

    def items_of(self, no: str):
        """All (key, value) pairs touching node `no`."""
        for key in self._by_node.get(no, ()):
            yield key, self._d[key]


def pe_pop_node(pe_info, no: str) -> None:
    """Drop every (u, v) pair with u == no or v == no."""
    if isinstance(pe_info, PEInfo):
        pe_info.pop_node(no)
        return
    for pu, pv in list(pe_info.keys()):
        if pu == no or pv == no:
            pe_info.pop((min(pu, pv), max(pu, pv)))


def pe_pop_nodes(pe_info, nodes: Iterable[str]) -> None:
    """Drop every pair touching any node in `nodes`."""
    if isinstance(pe_info, PEInfo):
        for no in nodes:
            pe_info.pop_node(no)
        return
    nodes = set(nodes)
    for pu, pv in list(pe_info.keys()):
        if pu in nodes or pv in nodes:
            pe_info.pop((min(pu, pv), max(pu, pv)))


def pe_normalize_none(pe_info) -> None:
    """Set every None-valued pair to 0."""
    if isinstance(pe_info, PEInfo):
        pe_info.normalize_none()
        return
    for k in pe_info.keys():
        if pe_info[k] is None:
            pe_info[k] = 0
