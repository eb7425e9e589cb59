"""Synthetic graphs in CSR form (GAPBS-style RMAT/Kronecker + uniform)."""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class CSRGraph:
    offsets: np.ndarray    # int64[n+1]
    neighbors: np.ndarray  # int32[m]

    @property
    def n(self) -> int:
        return len(self.offsets) - 1

    @property
    def m(self) -> int:
        return len(self.neighbors)

    def degrees(self) -> np.ndarray:
        return np.diff(self.offsets)


def rmat_edges(scale: int, avg_degree: int = 16, seed: int = 7,
               a=0.57, b=0.19, c=0.19) -> np.ndarray:
    """RMAT edge list [m, 2] (GAPBS Kronecker parameters)."""
    n = 1 << scale
    m = n * avg_degree
    rng = np.random.default_rng(seed)
    src = np.zeros(m, np.int64)
    dst = np.zeros(m, np.int64)
    for bit in range(scale):
        r = rng.random(m)
        src_bit = r > a + b
        r2 = rng.random(m)
        thr = np.where(src_bit, c / (c + (1 - a - b - c)), b / (a + b))
        dst_bit = r2 < thr if False else (
            rng.random(m) < np.where(src_bit, (1 - a - b - c) /
                                     max(c + (1 - a - b - c), 1e-9), b /
                                     max(a + b, 1e-9)))
        src |= src_bit.astype(np.int64) << bit
        dst |= dst_bit.astype(np.int64) << bit
    return np.stack([src, dst], axis=1)


def to_csr(edges: np.ndarray, n: int, *, symmetrize: bool = True) -> CSRGraph:
    if symmetrize:
        edges = np.concatenate([edges, edges[:, ::-1]], axis=0)
    # dedup + drop self loops
    mask = edges[:, 0] != edges[:, 1]
    edges = edges[mask]
    key = edges[:, 0] * n + edges[:, 1]
    key = np.unique(key)
    src = (key // n).astype(np.int64)
    dst = (key % n).astype(np.int32)
    offsets = np.zeros(n + 1, np.int64)
    np.add.at(offsets, src + 1, 1)
    offsets = np.cumsum(offsets)
    return CSRGraph(offsets=offsets, neighbors=dst)


def make_graph(scale: int = 14, avg_degree: int = 16,
               seed: int = 7) -> CSRGraph:
    n = 1 << scale
    return to_csr(rmat_edges(scale, avg_degree, seed), n)
