"""Permission cache (paper §4.2.3 / §7.1.6).

A small fully-associative cache over permission-table *entries* (and the
internal binary-search nodes they imply) that amortizes lookups.  Two
implementations:

  * `LruCache` — exact, stateful, used by the security/integration layer and
    small-scale tests (paper sizes: 0.5 KiB = 8 entries ... 64 KiB = 1024,
    at 64 B/entry).
  * The memsim uses an exact reuse-distance model (memsim/lru.py) for traces
    with millions of accesses — mathematically identical hit/miss behaviour
    for fully-associative LRU.
"""
from __future__ import annotations

from collections import OrderedDict

ENTRY_BYTES = 64


class LruCache:
    """Fully-associative LRU over 64 B permission entries — the simple
    host-side permission-cache model (the set-associative `PermCache` in
    `core.checker` is the device-speed one)."""

    def __init__(self, capacity_bytes: int):
        if capacity_bytes % ENTRY_BYTES:
            raise ValueError("capacity must be a multiple of 64 B entries")
        self.capacity = capacity_bytes // ENTRY_BYTES
        self._od: OrderedDict[int, None] = OrderedDict()
        self.hits = 0
        self.misses = 0

    def access(self, key: int) -> bool:
        """Touch `key`; returns True on hit."""
        if key in self._od:
            self._od.move_to_end(key)
            self.hits += 1
            return True
        self.misses += 1
        self._od[key] = None
        if len(self._od) > self.capacity:
            self._od.popitem(last=False)
        return False

    def invalidate_range(self, keys) -> None:
        """BISnp back-invalidate: drop any cached entry in the range."""
        for k in list(keys):
            self._od.pop(k, None)

    def invalidate_all(self) -> None:
        """Drop every cached entry (full flush; counters survive)."""
        self._od.clear()

    @property
    def miss_ratio(self) -> float:
        """Lifetime miss fraction (0.0 before any access)."""
        t = self.hits + self.misses
        return self.misses / t if t else 0.0
