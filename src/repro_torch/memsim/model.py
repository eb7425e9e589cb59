"""Analytical CXL-SDM timing model (replaces the paper's gem5+SST stack).

Models the paper's system (Table 2): hosts with a 16 MiB LLC in front of two
local DDR4 channels and a shared 4-channel CXL.mem device; the Space-Control
permission checker sits after the LLC and issues permission lookups to the
table stored *in the SDM*.

Mechanics per SDM reference (traces carry byte addresses):
  * LLC filter at 64 B line granularity (exact LRU via reuse distances);
  * each LLC miss issues a data packet AND (non-cxl systems) permission
    probes: binary-search over the sorted table, a dependent chain whose
    probes hit the permission cache (1 cy), coalesce into one of the 32
    permission-status-holding registers (outstanding-window reuse), or pay a
    remote table read;
  * data + permission packets contend for the same device bandwidth — the
    M/D/1-style queue factor is computed from the TOTAL packet rate, which is
    how permission traffic taxes even the single-entry layout (paper §7.1.3);
  * the response stalls until the slowest of (data, permission chain) arrives
    (enforcement stall, §7.1.5) plus response-matching;
  * A-bit compare 1 cy, local-line encryption 1 cy (paper §6.2).

Prior-work modes (§7.3): flat-table (1 scattered lookup per PPN), deact-like
(2 lookups: owner map + sharing bitmap), mondrian-ext (per-host sorted
segment table checked on local AND remote refs).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..workloads.gapbs import Trace
from .lru import reuse_distances, set_assoc_hits


def positional_distances(keys: np.ndarray) -> np.ndarray:
    """Distance (in stream positions) to the previous occurrence of each key
    (INF for first occurrences).  Models PSHR/MSHR merging of requests that
    are still outstanding — a *positional* window, unlike the LRU cache's
    distinct-key reuse distance."""
    keys = np.asarray(keys)
    t = len(keys)
    if t == 0:
        return np.empty(0, np.int64)
    _, inv = np.unique(keys, return_inverse=True)
    order = np.argsort(inv, kind="stable")
    sk = inv[order]
    prev_sorted = np.where(np.diff(sk, prepend=-1) == 0,
                           np.concatenate([[-1], order[:-1]]), -1)
    prev = np.empty(t, np.int64)
    prev[order] = prev_sorted
    pos = np.arange(t)
    return np.where(prev >= 0, pos - prev, np.iinfo(np.int64).max)

INF = np.iinfo(np.int64).max
LINE = 64
PAGE = 4096
# id(trace.pages) -> (trace.pages, its reuse distances).  The entry holds
# the array it was computed from, so no later array can take its id while
# the entry lives (keyed by the Trace's own id, a freed trace's id handed to
# a new one would return the old trace's distances).
_rd_cache: dict[int, tuple[np.ndarray, np.ndarray]] = {}


@dataclass(frozen=True)
class SimConfig:
    """Table 2 parameters @ 4 GHz.  Raw latencies are amortized by the
    memory-level parallelism the out-of-order/miss-pipelined core extracts
    (mlp_data overlapping independent misses; mlp_chain overlapping
    *dependent* permission-probe chains from different lookups across the 32
    PSHRs) — CPI contributions are effective, bandwidth demand is raw."""
    cpi_exec: float = 1.0
    instr_cycles_per_ref: float = 0.0  # folded into trace instr counts
    lat_llc: int = 40
    lat_local: int = 360           # 90 ns local DDR4
    lat_remote: int = 1000         # 250 ns CXL.mem round trip
    llc_lines: int = 262_144       # 16 MiB / 64 B
    device_gbps: float = 76.8      # remote peak (4ch DDR4-2400)
    coalesce_window: int = 32      # permission status holding registers
    # TimingSimpleCPU (Table 2) is a blocking, in-order core: data misses
    # are serial (mlp_data=1); permission chains overlap the data access
    # and each other only via the checker's PSHRs (mlp_chain=2) —
    # EXPERIMENTS.md §Paper-validation calibration.
    mlp_data: float = 1.0
    mlp_chain: float = 2.0
    abit_cycles: int = 1
    encrypt_cycles: int = 1
    resp_match_cycles: int = 2

    @property
    def eff_llc(self) -> float:
        """Effective LLC hit cost (20-deep overlap absorbs most of it)."""
        return self.lat_llc / 20.0

    @property
    def eff_remote(self) -> float:
        """Effective remote-access cost after data-level MLP overlap."""
        return self.lat_remote / self.mlp_data

    @property
    def eff_probe(self) -> float:
        """Effective table-probe cost (probe chains pipeline pairwise)."""
        return self.lat_remote / self.mlp_chain


@dataclass
class SimResult:
    """One simulated (kernel, system) cell: CPI, normalized overhead, and
    the probe/stall distributions behind the paper's figures."""
    kernel: str = ""
    system: str = ""
    cpi: float = 0.0
    cpi_norm: float = 1.0
    plpki: float = 0.0
    probe_hist: np.ndarray | None = None
    stall_hist: np.ndarray | None = None
    stall_edges: np.ndarray | None = None
    stall_mean: float = 0.0
    stall_p99: float = 0.0
    miss_ratio: float = 0.0
    data_packets: int = 0
    perm_packets: int = 0
    bandwidth_gbps: float = 0.0
    breakdown: dict = field(default_factory=dict)
    cycles: float = 0.0
    instructions: int = 0
    queue_factor: float = 1.0


def binary_search_nodes(n_entries: int, keys: np.ndarray,
                        entry_starts: np.ndarray):
    """Vectorized textbook binary search over sorted entry_starts.

    Returns (nodes int64[T, steps] padded -1, probe_count int64[T],
    entry_idx int64[T]) — the visited table indices per lookup, i.e. the
    paper's binary-search occupancy (Fig. 9)."""
    t = len(keys)
    steps = max(1, int(np.ceil(np.log2(max(n_entries, 2)))) + 1)
    lo = np.zeros(t, np.int64)
    hi = np.full(t, n_entries - 1, np.int64)
    idx = np.full(t, -1, np.int64)
    nodes = np.full((t, steps), -1, np.int64)
    probes = np.zeros(t, np.int64)
    for s in range(steps):
        active = lo <= hi
        if not active.any():
            break
        mid = (lo + hi) // 2
        nodes[active, s] = mid[active]
        probes += active
        sv = entry_starts[np.clip(mid, 0, n_entries - 1)]
        right = active & (sv <= keys)
        left = active & ~right
        idx = np.where(right, mid, idx)
        lo = np.where(right, mid + 1, lo)
        hi = np.where(left, mid - 1, hi)
    return nodes, probes, idx


def _llc_miss_mask(trace: Trace, cfg: SimConfig) -> np.ndarray:
    key = id(trace.pages)
    if key not in _rd_cache:
        _rd_cache[key] = (trace.pages, reuse_distances(trace.pages // LINE))
        if len(_rd_cache) > 64:
            _rd_cache.pop(next(iter(_rd_cache)))
    return _rd_cache[key][1] >= cfg.llc_lines


def _queue_factor(cfg: SimConfig, packets: float, cycles_est: float,
                  n_hosts: int) -> float:
    if cycles_est <= 0:
        return 1.0
    bytes_per_cy = cfg.device_gbps * 1e9 / 4e9
    rate = n_hosts * packets * LINE / cycles_est
    rho = min(rate / bytes_per_cy, 0.95)
    return 1.0 + 0.75 * rho / (1.0 - rho)


def simulate(trace: Trace, *, system: str = "space-control",
             n_entries: int = 1, cache_bytes: int = 0, n_hosts: int = 1,
             cfg: SimConfig = SimConfig(), kernel: str = "?",
             sdm_pages: int | None = None, cache_ways: int | None = None,
             warmup_frac: float = 0.4) -> SimResult:
    """Timing model for one host's trace.  system: cxl | space-control |
    flat-table | deact-like | mondrian-ext.

    ``cache_ways=None`` models the permission cache as fully-associative
    LRU (exact via reuse distances); an integer models a set-associative
    LRU with that many ways over ``cache_bytes // 64 // ways`` sets.

    The first `warmup_frac` of the trace warms the LLC / permission-cache
    state (reuse distances see it) but is excluded from the metrics —
    otherwise compulsory misses of the truncated window dominate."""
    t = len(trace.pages)
    w0 = int(t * warmup_frac)
    sel = np.arange(t) >= w0
    frac = max(t - w0, 1) / max(t, 1)
    instr = int(trace.n_instructions * frac)
    local_refs = int(trace.local_refs * frac)
    miss = _llc_miss_mask(trace, cfg)
    n_miss = int((miss & sel).sum())
    n_hit = int((~miss & sel).sum())
    hit_cycles = n_hit * cfg.eff_llc
    res = SimResult(kernel=kernel, system=system, instructions=instr,
                    data_packets=n_miss)

    exec_cycles = instr * cfg.cpi_exec + \
        local_refs * (cfg.lat_local / cfg.mlp_data) * 0.1

    # unloaded estimate for the queue fixed point
    cycles0 = exec_cycles + hit_cycles + n_miss * cfg.eff_remote

    if system == "cxl":
        qf = _queue_factor(cfg, n_miss, cycles0, n_hosts)
        cycles = exec_cycles + hit_cycles + n_miss * cfg.eff_remote * qf
        res.cycles, res.cpi, res.queue_factor = cycles, cycles / instr, qf
        res.bandwidth_gbps = n_miss * LINE / (cycles / 4e9) / 1e9
        return res

    # ---- permission path (lookups for every LLC-missing SDM ref; metrics
    # accumulate over the post-warmup slice only) ----
    sdm_pages = sdm_pages or int(trace.pages.max() // PAGE) + 1
    lookup_all = trace.pages[miss] // PAGE
    lookup_sel = sel[miss]
    lookup_pages = lookup_all
    nl = len(lookup_pages)

    n_eff = n_entries
    n_local_lookups = 0
    if system == "mondrian-ext":
        # Mondrian checks LOCAL refs too, against a per-host sorted segment
        # table in LOCAL memory.  The local-domain table is tiny (one
        # domain per process, ~2 entries) so each local check costs a
        # short local-latency chain — NOT a remote wc-table search.  Only
        # the SDM-domain half of the table mirrors the remote entries.
        n_local_lookups = min(trace.local_refs, nl * 2)
        n_eff = max(n_entries, 2)

    if system in ("space-control", "mondrian-ext"):
        entry_starts = np.linspace(0, sdm_pages, n_eff,
                                   endpoint=False).astype(np.int64)
        nodes, probes, _ = binary_search_nodes(n_eff, lookup_pages,
                                               entry_starts)
    elif system == "flat-table":
        nodes = lookup_pages[:, None]
        probes = np.ones(nl, np.int64)
    elif system == "deact-like":
        # dependent chain: owner mapping entry THEN sharing bitmap word
        nodes = np.stack([lookup_pages,
                          sdm_pages + lookup_pages // 256], axis=1)
        probes = np.full(nl, 2, np.int64)
    else:
        raise ValueError(system)

    flat_mask = nodes >= 0
    node_stream = nodes[flat_mask]             # program-order probe stream
    per_lookup = probes

    # probe outcome: permission cache hit > PSHR coalesce > remote read.
    # PSHR merging (positional window over outstanding requests) is part of
    # Space-Control's checker; prior-work modes get a generic MSHR merge of
    # back-to-back requests only (window 4); mondrian-ext none (fig14 note).
    if cache_bytes > 0:
        n_lines = cache_bytes // 64
        if cache_ways is not None and cache_ways < n_lines:
            cache_hit = set_assoc_hits(node_stream,
                                       max(n_lines // cache_ways, 1),
                                       cache_ways)
        else:
            prd = reuse_distances(node_stream)
            cache_hit = prd < n_lines
    else:
        cache_hit = np.zeros(len(node_stream), bool)
    pdist = positional_distances(node_stream)
    window = {"space-control": cfg.coalesce_window,
              "flat-table": 4, "deact-like": 4,
              "mondrian-ext": 0}[system]
    coalesced = ~cache_hit & (pdist < window)
    probe_miss = ~cache_hit & ~coalesced
    probe_sel = np.repeat(lookup_sel, per_lookup)
    res.perm_packets = int((probe_miss & probe_sel).sum())
    res.miss_ratio = float((probe_miss & probe_sel).sum()) / \
        max(int(probe_sel.sum()), 1)

    # device contention from TOTAL packets (data + permission)
    qf = _queue_factor(cfg, n_miss + res.perm_packets, cycles0, n_hosts)
    eff_remote = cfg.eff_remote * qf
    eff_probe = cfg.eff_probe * qf
    res.queue_factor = qf

    # dependent-chain lookup latency per lookup (probe chains from different
    # lookups overlap across the PSHRs -> eff_probe per missed probe)
    probe_cost = np.where(probe_miss, eff_probe,
                          np.where(coalesced, cfg.resp_match_cycles, 1.0))
    lookup_lat = np.zeros(len(per_lookup))
    np.add.at(lookup_lat,
              np.repeat(np.arange(len(per_lookup)), per_lookup),
              probe_cost)

    # enforcement: response held until data AND permission chain complete;
    # in-order commit means the residual is not hidden (paper SS7.1.4-7.1.5).
    # deact-like is translation-coupled (Gen-Z zMMU): its lookups must
    # finish BEFORE the access is issued, so nothing overlaps the data
    # fetch; response-side designs (space-control, mondrian) overlap.
    if system == "deact-like":
        stall_all = lookup_lat[:nl] + cfg.resp_match_cycles
    else:
        stall_all = np.maximum(0.0, lookup_lat[:nl] - eff_remote) + \
            cfg.resp_match_cycles
    stall = stall_all[lookup_sel[:nl]]
    # mondrian local-ref checks: ~2-probe chain against the local-memory
    # segment table at local DRAM latency, overlapped like other misses
    mond_extra = n_local_lookups * frac * 2 * \
        (cfg.lat_local / cfg.mlp_chain) if system == "mondrian-ext" else 0.0
    n_lookups = int(lookup_sel.sum())
    creation = n_lookups * 1.0
    abits = (int(t * frac) + local_refs) * cfg.abit_cycles * 0.001
    encrypt = local_refs * cfg.encrypt_cycles

    perm_cycles = stall.sum() + creation + abits + encrypt + mond_extra
    cycles = exec_cycles + hit_cycles + n_miss * eff_remote + perm_cycles
    res.cycles, res.cpi = cycles, cycles / instr
    res.plpki = int(lookup_sel[:nl].sum()) / (instr / 1000)
    res.probe_hist = np.bincount(
        np.clip(per_lookup[:nl][lookup_sel[:nl]], 0, 40))
    edges = np.concatenate([[0.0, 3.0], np.logspace(1, 4.7, 16)])
    res.stall_hist = np.histogram(stall, bins=edges)[0]
    res.stall_edges = edges
    res.stall_mean = float(stall.mean()) if nl else 0.0
    res.stall_p99 = float(np.percentile(stall, 99)) if nl else 0.0
    res.breakdown = {
        "creation": creation,
        "lookup": float(np.maximum(lookup_lat - 1, 0).sum()),
        "enforcement_stall": float(stall.sum()),
        "abit_compare": abits,
        "encryption": float(encrypt),
    }
    res.bandwidth_gbps = n_miss * LINE / (cycles / 4e9) / 1e9
    return res


def run_pair(trace: Trace, *, n_entries: int, cache_bytes: int,
             n_hosts: int, kernel: str, sdm_pages: int | None = None,
             system: str = "space-control", cache_ways: int | None = None,
             cfg: SimConfig = SimConfig()) -> tuple[SimResult, SimResult]:
    """(system result, cxl baseline) with cpi_norm filled in."""
    base = simulate(trace, system="cxl", n_hosts=n_hosts, kernel=kernel,
                    sdm_pages=sdm_pages, cfg=cfg)
    res = simulate(trace, system=system, n_entries=n_entries,
                   cache_bytes=cache_bytes, n_hosts=n_hosts, kernel=kernel,
                   sdm_pages=sdm_pages, cache_ways=cache_ways, cfg=cfg)
    res.cpi_norm = res.cpi / base.cpi
    return res, base
