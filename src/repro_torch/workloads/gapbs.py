"""GAPBS kernels (pr, bfs, bc, tc, cc) — the paper's evaluation workloads.

Two faces per kernel:
  * a compute implementation (correctness-tested, usable as examples):
    `pagerank` and `connected_components` in PyTorch on an explicit device
    (default CUDA), `bfs` and `triangle_count` in numpy,
  * a page-granular SDM address-trace generator (numpy) feeding the memsim.

SDM layout (paper §6.1: host 0 allocates the graph, hosts 1..k run kernels):
  offsets | neighbors | prop0 | prop1   all in the shared region; per-host
scratch lives in local memory.  Traces interleave (page, is_remote, is_write)
in program order at 4 KiB granularity.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core.table import HWPID_SHIFT, PAGE_MASK
from ..kernels import resolve_device
from .graphs import CSRGraph

PAGE = 4096


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


# ---------------------------------------------------------------------------
# Compute kernels
# ---------------------------------------------------------------------------

def pagerank(g: CSRGraph, iters: int = 10, d: float = 0.85, *,
             device=None) -> torch.Tensor:
    """f32 PageRank with dangling mass spread uniformly, on ``device``
    (None: CUDA).  The per-vertex sums use ``index_add_``, whose order of
    addition is not fixed on CUDA, so ranks agree with another summation
    order only within f32 rounding."""
    dev = resolve_device(device)
    n = g.n
    degrees = g.degrees()
    deg = torch.as_tensor(np.maximum(degrees, 1), dtype=torch.float32,
                          device=dev)
    dangling = torch.as_tensor(degrees == 0, dtype=torch.float32, device=dev)
    src = torch.as_tensor(np.repeat(np.arange(n), degrees), device=dev)
    dst = torch.as_tensor(g.neighbors.astype(np.int64), device=dev)
    rank = torch.full((n,), 1.0 / n, dtype=torch.float32, device=dev)
    for _ in range(iters):
        contrib = rank / deg
        incoming = torch.zeros_like(rank).index_add_(0, dst, contrib[src])
        # dangling vertices spread their mass uniformly (keeps sum(rank)=1)
        dmass = torch.sum(rank * dangling) / n
        rank = (1 - d) / n + d * (incoming + dmass)
    return rank


def bfs(g: CSRGraph, source: int = 0) -> np.ndarray:
    """Level array via frontier sweeps (numpy; frontier sizes are dynamic)."""
    depth = np.full(g.n, -1, np.int64)
    depth[source] = 0
    frontier = np.array([source])
    level = 0
    while len(frontier):
        starts = g.offsets[frontier]
        ends = g.offsets[frontier + 1]
        neigh = np.concatenate([g.neighbors[s:e]
                                for s, e in zip(starts, ends)]) \
            if len(frontier) < 1 << 14 else g.neighbors[
                np.concatenate([np.arange(s, e)
                                for s, e in zip(starts, ends)])]
        nxt = np.unique(neigh[depth[neigh] < 0])
        depth[nxt] = level + 1
        frontier = nxt
        level += 1
    return depth


def connected_components(g: CSRGraph, max_iters: int = 50, *,
                         device=None) -> torch.Tensor:
    """Label propagation (Shiloach-Vishkin flavored) on ``device`` (None:
    CUDA): each round every vertex takes the smallest label among itself
    and its in-neighbours.  A min is exact in any order.  Returns i32[n]."""
    dev = resolve_device(device)
    src = torch.as_tensor(np.repeat(np.arange(g.n), g.degrees()), device=dev)
    dst = torch.as_tensor(g.neighbors.astype(np.int64), device=dev)
    comp = torch.arange(g.n, dtype=torch.int32, device=dev)
    for _ in range(max_iters):
        comp = comp.scatter_reduce(0, dst, comp[src], "amin",
                                   include_self=True)
    return comp


def triangle_count(g: CSRGraph, max_edges: int = 200_000) -> int:
    """Sorted-adjacency intersection (numpy reference)."""
    deg = g.degrees()
    count = 0
    m = 0
    for u in range(g.n):
        nu = g.neighbors[g.offsets[u]:g.offsets[u + 1]]
        nu = nu[nu > u]
        for v in nu:
            nv = g.neighbors[g.offsets[v]:g.offsets[v + 1]]
            count += np.intersect1d(nu, nv[nv > v],
                                    assume_unique=False).size
            m += 1
            if m >= max_edges:
                return count
    return count


# ---------------------------------------------------------------------------
# Trace generators (program-order SDM page references)
# ---------------------------------------------------------------------------

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


# ---------------------------------------------------------------------------
# Egress replay (fabric-scale simulation): trace -> fixed-size kernel batches
# ---------------------------------------------------------------------------

def egress_batches(trace: Trace, *, hwpid: int, batch: int, n_steps: int,
                   page_offset: int = 0, page_span: int | None = None):
    """Replay a trace's SDM reference stream as A-bit tagged batches for the
    egress kernels (`kernels.memcrypt.checked_memcrypt_view` /
    `kernels.fabric_egress.fabric_egress`).

    The byte-address stream is reduced to 4 KiB page addresses in program
    order, optionally folded into ``page_span`` pages and rebased at
    ``page_offset`` — how a fabric host replays a shared workload against
    its own resident shard (each host's copy of the data lives in its page
    range).  Short traces wrap around, preserving the program-order
    locality structure the permission cache exploits (random resampling
    would destroy it).

    Returns ``(ext i32[n_steps, batch], is_write bool[n_steps, batch])``.
    """
    pages = (np.asarray(trace.pages, np.int64) // PAGE)
    writes = np.asarray(trace.is_write, bool)
    if len(pages) == 0:
        raise ValueError("cannot replay an empty trace")
    if page_span is not None:
        pages = pages % page_span
    pages = pages + page_offset
    need = n_steps * batch
    reps = -(-need // len(pages))
    pages = np.tile(pages, reps)[:need].astype(np.int64)
    writes = np.tile(writes, reps)[:need]
    ext = ((np.int64(hwpid) << HWPID_SHIFT) | (pages & PAGE_MASK)).astype(
        np.int32)
    return ext.reshape(n_steps, batch), writes.reshape(n_steps, batch)


TRACES = {"pr": trace_pr, "bfs": trace_bfs, "bc": trace_bc, "tc": trace_tc,
          "cc": trace_cc}
KERNELS = ["pr", "bfs", "bc", "tc", "cc"]
