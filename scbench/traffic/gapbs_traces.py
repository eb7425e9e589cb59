"""GAPBS graphs and SDM page traces: a frozen copy of the port's
``workloads/graphs.py`` (RMAT/Kronecker CSR graphs) and of the trace half of
``workloads/gapbs.py`` (pr, bfs, bc, tc, cc in program order at 4 KiB
pages), kept here so that the traffic does not move when the program does.
The code is the port's, unchanged."""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

PAGE = 4096


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

@dataclass(frozen=True)
class SDMLayout:
    """Page-granular layout of the shared graph in SDM."""
    offsets_pg: int
    neighbors_pg: int
    prop0_pg: int
    prop1_pg: int
    total_pages: int

    @classmethod
    def for_graph(cls, g: CSRGraph) -> "SDMLayout":
        def pgup(nbytes):
            return -(-nbytes // PAGE)
        off = 0
        o_pg = off
        off += pgup((g.n + 1) * 8)
        n_pg = off
        off += pgup(g.m * 4)
        p0 = off
        off += pgup(g.n * 8)
        p1 = off
        off += pgup(g.n * 8)
        return cls(o_pg, n_pg, p0, p1, off)

    # byte addresses within the SDM region (model derives lines and pages)
    def offsets_page(self, v):
        return self.offsets_pg * PAGE + np.asarray(v, np.int64) * 8

    def neighbors_page(self, e):
        return self.neighbors_pg * PAGE + np.asarray(e, np.int64) * 4

    def prop0_page(self, v):
        return self.prop0_pg * PAGE + np.asarray(v, np.int64) * 8

    def prop1_page(self, v):
        return self.prop1_pg * PAGE + np.asarray(v, np.int64) * 8


@dataclass
class Trace:
    pages: np.ndarray     # int64[T] SDM *byte addresses* (remote refs only)
    is_write: np.ndarray  # bool[T]
    n_instructions: int   # retired instructions represented by the trace
    local_refs: int       # local-memory references (encrypted lines)



def _cap(arrs, cap: int, rng):
    """Truncate to a contiguous window (preserves spatial/temporal locality —
    random subsampling would destroy the line-run structure the LLC and the
    permission cache exploit)."""
    pages, writes = arrs
    if len(pages) > cap:
        start = int(rng.integers(0, len(pages) - cap))
        return pages[start:start + cap], writes[start:start + cap]
    return pages, writes


def trace_pr(g: CSRGraph, iters: int = 2, cap: int = 400_000,
             seed: int = 0) -> Trace:
    lay = SDMLayout.for_graph(g)
    rng = np.random.default_rng(seed)
    edst = g.neighbors.astype(np.int64)
    esrc = np.repeat(np.arange(g.n, dtype=np.int64), g.degrees())
    # program order per edge: neighbors stream, contrib gather, rank update
    per_edge = np.stack([lay.neighbors_page(np.arange(g.m)),
                         lay.prop0_page(edst),
                         lay.prop1_page(esrc)], axis=1).ravel()
    per_edge_w = np.tile(np.array([False, False, True]), g.m)
    pages = np.tile(per_edge, iters)
    writes = np.tile(per_edge_w, iters)
    pages, writes = _cap((pages, writes), cap, rng)
    return Trace(pages, writes, n_instructions=int(len(pages) * 14),
                 local_refs=int(len(pages) * 0.6))


def _frontier_trace(g: CSRGraph, lay: SDMLayout, rng, cap: int,
                    extra_prop_pass: bool):
    depth = np.full(g.n, -1, np.int64)
    # RMAT graphs have many isolated vertices; GAPBS picks sources from the
    # non-isolated set (otherwise the frontier dies at level 0)
    candidates = np.where(g.degrees() > 0)[0]
    src0 = int(candidates[rng.integers(0, len(candidates))])
    depth[src0] = 0
    frontier = np.array([src0], np.int64)
    segs, wsegs = [], []
    level = 0
    while len(frontier) and level < 30:
        segs.append(lay.offsets_page(frontier))
        wsegs.append(np.zeros(len(frontier), bool))
        idx = np.concatenate([np.arange(g.offsets[u], g.offsets[u + 1])
                              for u in frontier]) if len(frontier) else \
            np.empty(0, np.int64)
        neigh = g.neighbors[idx].astype(np.int64)
        # program order: read adjacency entry, then visited check (scattered)
        inter = np.stack([lay.neighbors_page(idx),
                          lay.prop0_page(neigh)], axis=1).ravel()
        segs.append(inter)
        wsegs.append(np.zeros(len(inter), bool))
        nxt = np.unique(neigh[depth[neigh] < 0])
        segs.append(lay.prop0_page(nxt))     # depth update
        wsegs.append(np.ones(len(nxt), bool))
        depth[nxt] = level + 1
        frontier = nxt
        level += 1
    if extra_prop_pass:  # bc: dependency back-propagation over visited verts
        visited = np.where(depth >= 0)[0]
        order = visited[np.argsort(-depth[visited], kind="stable")]
        segs += [lay.offsets_page(order), lay.prop1_page(order)]
        wsegs += [np.zeros(len(order), bool), np.ones(len(order), bool)]
        idx = np.concatenate([np.arange(g.offsets[u], g.offsets[u + 1])
                              for u in order[:1 << 14]])
        segs.append(lay.prop1_page(g.neighbors[idx].astype(np.int64)))
        wsegs.append(np.zeros(len(idx), bool))
    return segs, wsegs


def trace_bfs(g: CSRGraph, cap: int = 400_000, seed: int = 0) -> Trace:
    lay = SDMLayout.for_graph(g)
    rng = np.random.default_rng(seed)
    segs, wsegs = _frontier_trace(g, lay, rng, cap, extra_prop_pass=False)
    pages, writes = _cap((np.concatenate(segs), np.concatenate(wsegs)), cap,
                         rng)
    return Trace(pages, writes, n_instructions=int(len(pages) * 9),
                 local_refs=int(len(pages) * 0.5))


def trace_bc(g: CSRGraph, cap: int = 400_000, seed: int = 0) -> Trace:
    lay = SDMLayout.for_graph(g)
    rng = np.random.default_rng(seed)
    segs, wsegs = _frontier_trace(g, lay, rng, cap, extra_prop_pass=True)
    pages, writes = _cap((np.concatenate(segs), np.concatenate(wsegs)), cap,
                         rng)
    return Trace(pages, writes, n_instructions=int(len(pages) * 10),
                 local_refs=int(len(pages) * 0.5))


def trace_tc(g: CSRGraph, cap: int = 400_000, seed: int = 0) -> Trace:
    """Triangle counting: adjacency-list intersections -> highly scattered
    neighbor-list reads with poor reuse (paper: worst locality, most PLPKI)."""
    lay = SDMLayout.for_graph(g)
    rng = np.random.default_rng(seed)
    deg = g.degrees()
    # sample edges (u, v); touch offsets[u], offsets[v], both adj lists
    m = min(cap // 8, g.m)
    eid = rng.choice(g.m, m, replace=False)
    esrc = np.repeat(np.arange(g.n, dtype=np.int64), deg)[eid]
    edst = g.neighbors[eid].astype(np.int64)
    chunks = []
    for u, v in zip(esrc, edst):
        su, sv = g.offsets[u], g.offsets[v]
        lu = min(int(deg[u]), 64)
        lv = min(int(deg[v]), 64)
        chunks.append(lay.offsets_page(np.array([u, v])))
        chunks.append(lay.neighbors_page(np.arange(su, su + lu)))
        chunks.append(lay.neighbors_page(np.arange(sv, sv + lv)))
    pages = np.concatenate(chunks)
    writes = np.zeros(len(pages), bool)
    pages, writes = _cap((pages, writes), cap, rng)
    return Trace(pages, writes, n_instructions=int(len(pages) * 5),
                 local_refs=int(len(pages) * 0.3))


def trace_cc(g: CSRGraph, iters: int = 3, cap: int = 400_000,
             seed: int = 0) -> Trace:
    lay = SDMLayout.for_graph(g)
    rng = np.random.default_rng(seed)
    esrc = np.repeat(np.arange(g.n, dtype=np.int64), g.degrees())
    edst = g.neighbors.astype(np.int64)
    m = min(cap // (4 * iters), g.m)
    segs, wsegs = [], []
    for it in range(iters):
        start = int(rng.integers(0, max(g.m - m, 1)))  # contiguous edge sweep
        eid = np.arange(start, start + m)
        inter = np.stack([lay.neighbors_page(eid), lay.prop0_page(esrc[eid]),
                          lay.prop0_page(edst[eid]),
                          lay.prop0_page(edst[eid])], axis=1).ravel()
        segs.append(inter)
        wsegs.append(np.tile(np.array([False, False, False, True]), m))
    pages, writes = _cap((np.concatenate(segs), np.concatenate(wsegs)), cap,
                         rng)
    return Trace(pages, writes, n_instructions=int(len(pages) * 6),
                 local_refs=int(len(pages) * 0.4))


TRACES = {"pr": trace_pr, "bfs": trace_bfs, "bc": trace_bc, "tc": trace_tc,
          "cc": trace_cc}
KERNELS = ["pr", "bfs", "cc", "bc", "tc"]
