"""Exact reuse-distance computation (Mattson stack distances).

For a fully-associative LRU cache of capacity C, an access hits iff its reuse
distance (number of *distinct* keys touched since the previous access to the
same key) is < C.  This gives exact hit/miss behaviour for every capacity in
one O(T log T) pass — how the memsim evaluates the paper's permission-cache
sweep (Fig. 13) and the LLC filter without re-simulating per size.
"""
from __future__ import annotations

import numpy as np


def reuse_distances(keys: np.ndarray) -> np.ndarray:
    """keys: int array [T].  Returns rd[T]: distinct keys since previous
    access to keys[t] (np.iinfo(int64).max for first accesses)."""
    keys = np.asarray(keys)
    t = keys.shape[0]
    if t == 0:
        return np.empty(0, np.int64)
    _, inv = np.unique(keys, return_inverse=True)
    # previous-access positions, vectorized via stable sort by key
    order = np.argsort(inv, kind="stable")
    sk = inv[order]
    prev_sorted = np.where(np.diff(sk, prepend=-1) == 0,
                           np.concatenate([[-1], order[:-1]]), -1)
    prev = np.empty(t, np.int64)
    prev[order] = prev_sorted
    # Fenwick tree over time: count distinct keys in (prev[i], i).
    # A key contributes at the position of its LAST access before i.
    tree = np.zeros(t + 1, np.int64)

    def update(pos: int, val: int):
        pos += 1
        while pos <= t:
            tree[pos] += val
            pos += pos & (-pos)

    def query(pos: int) -> int:  # prefix sum [0, pos]
        pos += 1
        s = 0
        while pos > 0:
            s += tree[pos]
            pos -= pos & (-pos)
        return s

    inf = np.iinfo(np.int64).max
    rd = np.empty(t, np.int64)
    for i in range(t):
        p = prev[i]
        if p < 0:
            rd[i] = inf
        else:
            # distinct keys touched in (p, i) = marks in (p, i-1]
            rd[i] = query(i - 1) - query(p)
            update(p, -1)  # key's previous-last position no longer "last"
        update(i, 1)
    return rd


def lru_hits(keys: np.ndarray, capacity: int) -> np.ndarray:
    """Boolean hit mask for a fully-associative LRU of `capacity` entries."""
    return reuse_distances(keys) < capacity


def hit_curve(keys: np.ndarray, capacities: list[int]) -> dict[int, float]:
    """Miss ratio per capacity from one reuse-distance pass."""
    rd = reuse_distances(keys)
    t = max(len(keys), 1)
    return {c: float(np.count_nonzero(rd >= c)) / t for c in capacities}


def set_assoc_hits(keys: np.ndarray, n_sets: int, ways: int) -> np.ndarray:
    """Boolean hit mask for a set-associative LRU: ``n_sets`` sets indexed
    by ``key % n_sets``, per-set LRU over ``ways`` lines.

    A set-associative LRU is per-set fully-associative LRU of capacity
    ``ways`` over the subsequence of accesses mapping to that set, so each
    set's hits come from one reuse-distance pass over its subsequence.
    ``ways >= n_lines`` or ``n_sets == 1`` degenerates to `lru_hits`.
    """
    keys = np.asarray(keys)
    t = keys.shape[0]
    hits = np.empty(t, bool)
    if t == 0:
        return hits
    if n_sets <= 1:
        return lru_hits(keys, ways)
    sets = keys % n_sets
    order = np.argsort(sets, kind="stable")
    ss = sets[order]
    bounds = np.flatnonzero(np.diff(ss, prepend=-1, append=n_sets + 1))
    for a, b in zip(bounds[:-1], bounds[1:]):
        idx = order[a:b]
        hits[idx] = reuse_distances(keys[idx]) < ways
    return hits
