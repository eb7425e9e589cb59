"""Fabric trace record + replay through the clocked cost model.

`core.fabric.ShardedFabric.begin_trace()` records what a deployment
actually did — every committed BISnp fan-out (via the bus tap) and every
batched egress step's per-row page stream — into a `FabricTrace`.  This
module replays that trace through the `memsim.clock` link model and
answers the timing questions the functional fabric cannot:

  * **commit propagation** — per-copy latency from publish to arrival
    through the shared FM egress port and per-host downlinks (percentiles;
    the measured analogue of paper §7.1.7's
    "revocation costs one BISnp round");
  * **per-link utilization and the critical path** — which link saturates
    first (the shared SDM device port, at scale) and which host contributes
    the most device-port traffic;
  * **the PermCache bandwidth tax** — `finalize()` derives each row's
    permission-entry miss profile from its recorded page stream with the
    exact set-associative LRU model (`lru.set_assoc_hits`, 16 KiB / 4-way
    by default), and `timing_penalty()` replays the trace three ways
    (cached misses / no permission traffic / every access a miss) to
    produce the measured analogue of the paper's 3.3 % / 16 KiB figure.

Traces are compact after `finalize()` (raw page streams are reduced to
per-row miss counts) and JSON-roundtrippable (`to_json`/`from_json`), which
is what the replay-roundtrip test and the CI timing leg pin.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .clock import FabricTopology, TimingConfig
from .lru import set_assoc_hits

PERM_ENTRY_BYTES = 64    # one permission-table entry per cache line
PERM_WAYS = 4            # PermCache associativity (core.checker)


@dataclass
class EgressStep:
    """One recorded `step_egress` launch: R rows x B packets.

    During recording `pages` holds the raw per-row page streams
    (i64[R, B]); `finalize()` reduces them to `perm_misses` (one count per
    row) and drops the raw pages.
    """
    rows: list            # [(host_id, hwpid), ...] kernel row order
    batch: int
    epoch: int
    pages: np.ndarray | None = None
    perm_misses: list | None = None


@dataclass
class FabricTrace:
    """An ordered record of fabric activity: commits + egress steps.

    Event order is recording order — replay preserves it, which is what
    makes the roundtrip test exact (record -> serialize -> replay yields
    the same event count and order).
    """
    label: str = ""
    events: list = field(default_factory=list)   # ("commit", epoch, n_hosts)
    steps: list = field(default_factory=list)    # EgressStep, "egress" refs
    finalized: bool = False
    perm_cache_bytes: int = 16 * 1024
    ways: int = PERM_WAYS

    # -- recording -----------------------------------------------------------
    def record_commit(self, epoch: int, n_hosts: int) -> None:
        """One committed table update fanning out to `n_hosts` copies."""
        self.events.append(("commit", int(epoch), int(n_hosts)))

    def record_egress(self, rows, pages, *, epoch: int) -> None:
        """One batched egress launch: `rows` in kernel row order, `pages`
        i64[R, B] page addresses (already A-bit-stripped)."""
        pages = np.asarray(pages, np.int64)
        step = EgressStep(rows=[(int(h), int(p)) for h, p in rows],
                          batch=int(pages.shape[1]), epoch=int(epoch),
                          pages=pages)
        self.events.append(("egress", len(self.steps)))
        self.steps.append(step)

    # -- finalize: page streams -> PermCache miss profiles -------------------
    def finalize(self, *, perm_cache_bytes: int | None = None,
                 ways: int = PERM_WAYS) -> "FabricTrace":
        """Reduce raw page streams to per-row permission-miss counts.

        Each (host, hwpid) row's pages are concatenated across steps in
        recording order and pushed through the exact set-associative LRU
        (`perm_cache_bytes` / 64 B entries, `ways`-way), then split back
        into per-step miss counts.  Cache state carries across steps —
        which is what makes steady-state steps cheap and the post-commit
        step pay the refill, exactly like the real PermCache."""
        if self.finalized:
            return self
        if perm_cache_bytes is not None:
            self.perm_cache_bytes = int(perm_cache_bytes)
        self.ways = int(ways)
        entries = self.perm_cache_bytes // PERM_ENTRY_BYTES
        n_sets = max(1, entries // self.ways) if entries > 0 else 0
        # gather each row-key's stream: (step_idx, row_idx) segments in order
        streams: dict[tuple[int, int], list[tuple[int, int]]] = {}
        for si, step in enumerate(self.steps):
            step.perm_misses = [0] * len(step.rows)
            for ri, key in enumerate(step.rows):
                streams.setdefault(key, []).append((si, ri))
        for key, segs in streams.items():
            chunks = [self.steps[si].pages[ri] for si, ri in segs]
            keys = np.concatenate(chunks) if chunks else np.empty(0, np.int64)
            if entries <= 0:
                hits = np.zeros(len(keys), bool)
            else:
                hits = set_assoc_hits(keys, n_sets, self.ways)
            pos = 0
            for (si, ri), chunk in zip(segs, chunks):
                n = len(chunk)
                misses = int(np.count_nonzero(~hits[pos:pos + n]))
                self.steps[si].perm_misses[ri] = misses
                pos += n
        for step in self.steps:
            step.pages = None   # raw streams no longer needed
        self.finalized = True
        return self

    # -- introspection -------------------------------------------------------
    @property
    def n_events(self) -> int:
        """Total recorded events (commits + egress steps), in order."""
        return len(self.events)

    @property
    def n_commits(self) -> int:
        """Recorded commit fan-outs."""
        return sum(1 for e in self.events if e[0] == "commit")

    # -- serialization -------------------------------------------------------
    def to_json(self) -> dict:
        """JSON-ready dict (requires `finalize()` — raw pages don't ship)."""
        if not self.finalized:
            raise RuntimeError("finalize() the trace before serializing")
        out_events = []
        for ev in self.events:
            if ev[0] == "commit":
                out_events.append({"kind": "commit", "epoch": ev[1],
                                   "n_hosts": ev[2]})
            else:
                s = self.steps[ev[1]]
                out_events.append({
                    "kind": "egress", "epoch": s.epoch, "batch": s.batch,
                    "rows": [list(r) for r in s.rows],
                    "perm_misses": list(s.perm_misses)})
        return {"label": self.label,
                "perm_cache_bytes": self.perm_cache_bytes,
                "ways": self.ways, "events": out_events}

    @classmethod
    def from_json(cls, d: dict) -> "FabricTrace":
        """Inverse of `to_json` — reconstructs a finalized trace."""
        tr = cls(label=d.get("label", ""),
                 perm_cache_bytes=int(d.get("perm_cache_bytes", 16 * 1024)),
                 ways=int(d.get("ways", PERM_WAYS)))
        for ev in d["events"]:
            if ev["kind"] == "commit":
                tr.events.append(("commit", int(ev["epoch"]),
                                  int(ev["n_hosts"])))
            else:
                step = EgressStep(
                    rows=[(int(h), int(p)) for h, p in ev["rows"]],
                    batch=int(ev["batch"]), epoch=int(ev["epoch"]),
                    perm_misses=[int(m) for m in ev["perm_misses"]])
                tr.events.append(("egress", len(tr.steps)))
                tr.steps.append(step)
        tr.finalized = True
        return tr


@dataclass
class ReplayReport:
    """What one replay measured (all cycle figures at `cfg.clock_ghz`)."""
    cycles: int                      # makespan (last arrival anywhere)
    egress_cycles: int               # last egress step barrier (device path)
    n_commits: int
    n_egress_steps: int
    bisnp_copies: int
    egress_packets: int
    propagation: dict                # p50/p90/p99/max/mean cycles + ns
    links: dict                      # name -> stats + utilization
    critical_path: dict              # bottleneck link + host
    perm_mode: str                   # 'cached' | 'none' | 'nocache'

    def to_dict(self) -> dict:
        """JSON-ready form of the report."""
        return {
            "cycles": self.cycles, "egress_cycles": self.egress_cycles,
            "n_commits": self.n_commits,
            "n_egress_steps": self.n_egress_steps,
            "bisnp_copies": self.bisnp_copies,
            "egress_packets": self.egress_packets,
            "propagation": self.propagation, "links": self.links,
            "critical_path": self.critical_path, "perm_mode": self.perm_mode,
        }


def _percentiles(samples: list, ghz: float) -> dict:
    """Propagation summary: percentiles in cycles and nanoseconds."""
    if not samples:
        return {"n": 0}
    arr = np.asarray(samples, np.int64)
    out = {"n": int(arr.size), "mean_cycles": float(arr.mean())}
    for p, tag in ((50, "p50"), (90, "p90"), (99, "p99"), (100, "max")):
        cy = float(np.percentile(arr, p))
        out[f"{tag}_cycles"] = round(cy, 1)
        out[f"{tag}_ns"] = round(cy / ghz, 1)
    return out


def replay(trace: FabricTrace, cfg: TimingConfig | None = None, *,
           perm: str = "cached", seed: int = 0) -> ReplayReport:
    """Replay a finalized trace through the link cost model.

    `perm` selects the permission-traffic mode per egress row:
    ``"cached"`` adds the finalized miss counts (one 64 B entry fetch per
    PermCache miss), ``"none"`` adds no permission packets (the free-
    checking baseline), ``"nocache"`` adds one per access (a host with no
    PermCache at all).  Everything else is identical, so the cycle delta
    between modes IS the permission-traffic cost.

    The replay is pure arithmetic over `Link` state — no heap events —
    so 255-host traces with ~10^6 packets replay in milliseconds.
    Commits fan out through the FM egress port + per-host downlinks
    (ordered-channel clamped); egress rows share the SDM device port,
    each step barriered on its slowest row (the kernel launch analogue).
    """
    if not trace.finalized:
        raise RuntimeError("finalize() the trace before replaying")
    if perm not in ("cached", "none", "nocache"):
        raise ValueError(f"unknown perm mode {perm!r}")
    cfg = cfg or TimingConfig()
    topo = FabricTopology(cfg, seed=seed)
    now = 0
    horizon = 0
    prop: list[int] = []
    last_arrival: dict[int, int] = {}
    host_device_packets: dict[int, int] = {}
    n_commits = n_steps = copies = packets = 0

    for ev in trace.events:
        if ev[0] == "commit":
            _, _epoch, n_hosts = ev
            n_commits += 1
            for h in range(n_hosts):
                depart = topo.fm_egress.send(now, cfg.packet_bytes)
                arrive = topo.downlink(h).send(depart, cfg.packet_bytes)
                arrive = max(arrive, last_arrival.get(h, 0))
                last_arrival[h] = arrive
                prop.append(arrive - now)
                horizon = max(horizon, arrive)
                copies += 1
        else:
            step = trace.steps[ev[1]]
            n_steps += 1
            step_end = now
            for ri, (host, _hwpid) in enumerate(step.rows):
                n_perm = {"cached": step.perm_misses[ri], "none": 0,
                          "nocache": step.batch}[perm]
                n_pkts = step.batch + n_perm
                arrive = topo.device.send_burst(now, n_pkts,
                                                cfg.packet_bytes)
                arrive += cfg.resp_match_cycles
                host_device_packets[host] = \
                    host_device_packets.get(host, 0) + n_pkts
                packets += n_pkts
                step_end = max(step_end, arrive)
            now = step_end
            horizon = max(horizon, now)

    cycles = max(horizon, now)
    links = {}
    for link in topo.links():
        if link.msgs:
            links[link.name] = {**link.stats(),
                                "utilization": round(
                                    link.utilization(cycles), 4)}
    bottleneck_link = max(links, key=lambda n: links[n]["utilization"]) \
        if links else None
    bottleneck_host = max(host_device_packets,
                          key=host_device_packets.get) \
        if host_device_packets else None
    return ReplayReport(
        cycles=int(cycles), egress_cycles=int(now),
        n_commits=n_commits, n_egress_steps=n_steps,
        bisnp_copies=copies, egress_packets=packets,
        propagation=_percentiles(prop, cfg.clock_ghz), links=links,
        critical_path={
            "link": bottleneck_link,
            "link_utilization": links.get(bottleneck_link, {}).get(
                "utilization") if bottleneck_link else None,
            "host": bottleneck_host,
            "host_device_packets": host_device_packets.get(
                bottleneck_host, 0) if bottleneck_host is not None else 0,
        },
        perm_mode=perm)


def timing_penalty(trace: FabricTrace,
                   cfg: TimingConfig | None = None) -> dict:
    """Replay one trace in all three permission modes and report the
    bandwidth tax: ``penalty_cached_pct`` is the measured analogue of the
    paper's 3.3 % / 16 KiB PermCache figure; ``penalty_nocache_pct`` is
    what the fabric would pay with no PermCache at all.

    The penalty is computed over **egress completion cycles** (the device-
    port path the permission packets actually ride), not the overall
    makespan — at 255 hosts the BISnp fan-out horizon dominates the
    makespan and would mask the device-port delta entirely."""
    cached = replay(trace, cfg, perm="cached")
    none = replay(trace, cfg, perm="none")
    nocache = replay(trace, cfg, perm="nocache")
    base = max(none.egress_cycles, 1)
    return {
        "cycles_cached": cached.egress_cycles,
        "cycles_none": none.egress_cycles,
        "cycles_nocache": nocache.egress_cycles,
        "penalty_cached_pct": round(
            100.0 * (cached.egress_cycles - none.egress_cycles) / base, 3),
        "penalty_nocache_pct": round(
            100.0 * (nocache.egress_cycles - none.egress_cycles) / base, 3),
        "perm_cache_bytes": trace.perm_cache_bytes,
    }
