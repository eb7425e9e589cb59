"""Clocked fabric timing simulator: global cycle + heapq event queue.

This module is the *propagation-latency* half of the memsim (paper §7.1.7:
revocation costs one BISnp round; Table 2: link latencies).  The analytical
model in `memsim.model` answers "how many cycles does one host's trace
cost?"; this module answers "when does a message published onto the fabric
actually *arrive*, and which link saturates first?" — the question the
manually-pumped `BISnpBus` could not answer (it had order, not time).

Three layers:

  * **`Clock`** — a deterministic global-cycle event loop: a heapq of
    `(cycle, seq, callback)` entries, `seq` breaking same-cycle ties in
    schedule order so two runs with the same inputs produce the same event
    order (no wall clock, no threads; the Simu3 ``mem_sim.py`` global-cycle
    pattern);
  * **`Link`** — one directed fabric link with a serialization rate and a
    propagation delay.  Messages FIFO through the serializer: a message
    entering a busy link *queues* — the contention "queue factor" is
    measured (wait cycles per message, utilization) rather than assumed,
    unlike the closed-form M/D/1 factor in `model._queue_factor`;
  * **`FabricTopology` / `ClockedFabric`** — the paper's deployment as a
    star: the FM's egress port (shared by every BISnp fan-out) feeds
    per-host downlinks, and egress data/permission packets from all hosts
    share the SDM device port.  `ClockedFabric` bundles a `Clock` with a
    topology and is the object `BISnpBus(clock=...)` drives: `bisnp_send`
    returns per-host arrival cycles with per-host ordered-channel clamping
    (CXL delivery is ordered per host, so a jittered arrival never
    overtakes an earlier message on the same channel).

Defaults (`TimingConfig`) are derived from the paper's Table 2 @ 4 GHz:
250 ns CXL.mem one-way latency (half the 1000-cycle round trip used by
`model.SimConfig.lat_remote`), 76.8 GB/s device bandwidth (4-channel
DDR4-2400), 64 B packets.  ``docs/timing_model.md`` has the parameter
table.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass
from typing import Callable

LINE_BYTES = 64          # one CXL flit / cache line per packet
GHZ = 4.0                # Table 2 core/fabric clock


class Clock:
    """Deterministic global-cycle event loop (heapq-driven).

    Invariants: `now` is monotonically non-decreasing; events scheduled for
    the same cycle fire in schedule order (the `seq` tiebreak); callbacks
    may schedule further events at or after `now`.  There is no wall-clock
    or randomness here — determinism under a fixed seed is a property the
    timing tests pin (`tests/test_timing.py`).
    """

    def __init__(self) -> None:
        self.now = 0
        self.events_run = 0
        self._heap: list[tuple[int, int, Callable[[], None]]] = []
        self._seq = 0

    def at(self, cycle: int, fn: Callable[[], None]) -> None:
        """Schedule `fn` to run at absolute `cycle` (>= now)."""
        if cycle < self.now:
            raise ValueError(f"cannot schedule at {cycle} < now {self.now}")
        heapq.heappush(self._heap, (int(cycle), self._seq, fn))
        self._seq += 1

    def after(self, delay: int, fn: Callable[[], None]) -> None:
        """Schedule `fn` to run `delay` cycles from now."""
        self.at(self.now + int(delay), fn)

    @property
    def idle(self) -> bool:
        """True when no events are pending."""
        return not self._heap

    @property
    def pending(self) -> int:
        """Number of scheduled-but-unfired events."""
        return len(self._heap)

    def step(self) -> bool:
        """Fire the single earliest event; returns False when idle."""
        if not self._heap:
            return False
        cycle, _, fn = heapq.heappop(self._heap)
        self.now = cycle
        self.events_run += 1
        fn()
        return True

    def run(self, until: int | None = None) -> int:
        """Fire events until the heap is empty (or past `until`); returns
        the number fired.  With `until`, `now` advances to exactly `until`
        even if the last event fired earlier (time passes without work)."""
        n = 0
        while self._heap and (until is None or self._heap[0][0] <= until):
            self.step()
            n += 1
        if until is not None and until > self.now:
            self.now = int(until)
        return n


@dataclass(frozen=True)
class TimingConfig:
    """Fabric link parameters (paper Table 2 @ 4 GHz).

    ``*_gbps`` are GB/s converted to bytes/cycle at `clock_ghz` (matching
    `model.SimConfig.device_gbps`'s convention); `link_latency` is the
    one-way CXL.mem propagation delay — half of `SimConfig.lat_remote`'s
    1000-cycle round trip.  `jitter` adds a deterministic seeded ±uniform
    perturbation to per-message propagation (0 disables; kept 0 for the
    differential tests, enabled by sweeps that want latency distributions).
    """
    clock_ghz: float = GHZ
    link_latency: int = 500        # 125 ns one-way CXL.mem propagation
    fm_egress_gbps: float = 19.2   # FM/switch BISnp egress port (1ch share)
    downlink_gbps: float = 19.2    # per-host BISnp downlink
    device_gbps: float = 76.8      # shared SDM device port (4ch DDR4-2400)
    packet_bytes: int = LINE_BYTES
    resp_match_cycles: int = 2     # model.SimConfig.resp_match_cycles
    jitter: int = 0                # ± uniform cycles on propagation

    def bytes_per_cycle(self, gbps: float) -> float:
        """Serialization rate in bytes/cycle for a GB/s link speed."""
        return gbps * 1e9 / (self.clock_ghz * 1e9)


class Link:
    """One directed link: FIFO serializer + propagation delay + stats.

    `send(now, nbytes)` models a message entering the link: it waits until
    the serializer frees (`busy_until`), occupies it for
    ``nbytes / bytes_per_cycle`` cycles, then propagates for
    ``latency (± jitter)`` cycles.  Returns the arrival cycle.  Stats are
    exact, not modeled: `busy_cycles` (serialization occupancy),
    `wait_cycles` (total queueing), `msgs` — utilization over an interval
    is ``busy_cycles / elapsed`` and the measured queue factor is
    ``1 + wait_cycles / busy_cycles``.
    """

    def __init__(self, name: str, *, latency: int, gbps: float,
                 cfg: TimingConfig, rng=None):
        self.name = name
        self.latency = int(latency)
        self._per_byte = 1.0 / cfg.bytes_per_cycle(gbps)
        self._jitter = cfg.jitter
        self._rng = rng
        self.busy_until = 0
        self.busy_cycles = 0
        self.wait_cycles = 0
        self.msgs = 0
        self.max_queue_cycles = 0
        # fault primitives (core.faults.LinkFault installs these):
        # degrade_factor multiplies serializer occupancy (2.0 = the link
        # runs at half bandwidth); outages are [start, end) cycle windows
        # during which the serializer admits nothing — a message arriving
        # mid-outage queues until the window closes
        self.degrade_factor = 1.0
        self.outages: list[tuple[int, int]] = []
        self.outage_waits = 0

    def occupancy(self, nbytes: int) -> int:
        """Serializer occupancy in whole cycles for one `nbytes` message
        (scaled by the fault layer's `degrade_factor` when installed)."""
        return max(1, int(round(nbytes * self._per_byte
                                * self.degrade_factor)))

    def _defer_past_outages(self, start: int) -> int:
        """Earliest cycle >= `start` outside every outage window."""
        for lo, hi in sorted(self.outages):
            if lo <= start < hi:
                self.outage_waits += 1
                start = hi
        return start

    def send(self, now: int, nbytes: int) -> int:
        """Enqueue one message at `now`; returns its arrival cycle."""
        occ = self.occupancy(nbytes)
        start = self._defer_past_outages(max(int(now), self.busy_until))
        wait = start - int(now)
        self.busy_until = start + occ
        self.busy_cycles += occ
        self.wait_cycles += wait
        self.max_queue_cycles = max(self.max_queue_cycles, wait)
        self.msgs += 1
        lat = self.latency
        if self._jitter and self._rng is not None:
            lat += int(self._rng.integers(-self._jitter, self._jitter + 1))
        return self.busy_until + max(lat, 0)

    def send_burst(self, now: int, n_msgs: int, nbytes: int) -> int:
        """Enqueue `n_msgs` back-to-back messages; returns the arrival
        cycle of the LAST one.  Equivalent to `n_msgs` calls to `send`
        (jitter applied once, to the tail) but O(1) — the replay layer
        pushes ~10^6 egress packets per step through the device port and
        must not pay one heap event per packet."""
        if n_msgs <= 0:
            return int(now)
        occ = self.occupancy(nbytes)
        start = self._defer_past_outages(max(int(now), self.busy_until))
        self.wait_cycles += start - int(now)
        self.max_queue_cycles = max(self.max_queue_cycles, start - int(now))
        self.busy_until = start + occ * n_msgs
        self.busy_cycles += occ * n_msgs
        self.msgs += n_msgs
        lat = self.latency
        if self._jitter and self._rng is not None:
            lat += int(self._rng.integers(-self._jitter, self._jitter + 1))
        return self.busy_until + max(lat, 0)

    def utilization(self, elapsed: int) -> float:
        """Fraction of `elapsed` cycles the serializer was occupied."""
        return self.busy_cycles / max(int(elapsed), 1)

    def queue_factor(self) -> float:
        """Measured contention factor: 1 + wait/busy (1.0 = uncontended)."""
        return 1.0 + self.wait_cycles / max(self.busy_cycles, 1)

    def stats(self) -> dict:
        """JSON-ready per-link counters."""
        return {
            "msgs": self.msgs,
            "busy_cycles": int(self.busy_cycles),
            "wait_cycles": int(self.wait_cycles),
            "queue_factor": round(self.queue_factor(), 3),
            "max_queue_cycles": int(self.max_queue_cycles),
        }


class FabricTopology:
    """Star CXL fabric: FM egress port -> per-host downlinks + shared
    SDM device port.

    The FM's egress port serializes every BISnp copy of a commit (one 64 B
    packet per attached host), so fan-out cost grows linearly with host
    count *at the root* — exactly the term the paper's 255-host claim has
    to absorb.  Egress data/permission packets from every host share the
    one device port, the link that saturates first under load (the
    critical path a replay reports).  Host downlinks are
    created lazily so the topology tracks bus attach/detach for free.
    """

    def __init__(self, cfg: TimingConfig | None = None, *, seed: int = 0):
        import numpy as np
        self.cfg = cfg or TimingConfig()
        self._rng = np.random.default_rng(seed)
        self.fm_egress = Link("fm.egress", latency=0,
                              gbps=self.cfg.fm_egress_gbps, cfg=self.cfg,
                              rng=self._rng)
        self.device = Link("sdm.device", latency=self.cfg.link_latency,
                           gbps=self.cfg.device_gbps, cfg=self.cfg,
                           rng=self._rng)
        self.downlinks: dict[int, Link] = {}

    def downlink(self, host_id: int) -> Link:
        """The (lazily created) BISnp downlink of one host."""
        if host_id not in self.downlinks:
            self.downlinks[host_id] = Link(
                f"host{host_id}.down", latency=self.cfg.link_latency,
                gbps=self.cfg.downlink_gbps, cfg=self.cfg, rng=self._rng)
        return self.downlinks[host_id]

    def links(self) -> list[Link]:
        """Every live link (root + device + downlinks)."""
        return [self.fm_egress, self.device, *self.downlinks.values()]


class ClockedFabric:
    """Clock + topology bundle: what `BISnpBus(clock=...)` drives.

    One instance models simulated time for one deployment.  The bus calls
    `bisnp_send(host_id)` per published copy — the packet serializes
    through the shared FM egress port, propagates down the host's
    downlink, and the arrival is clamped to the host's previous arrival
    (ordered per-host channel: delivery order equals publish order by
    construction, which is the invariant the manual-pump bus established
    and the convergence differential relies on).  `deliver/drain/quiesce`
    on the bus advance `self.clock` instead of popping queues directly.
    """

    def __init__(self, cfg: TimingConfig | None = None, *, seed: int = 0):
        self.cfg = cfg or TimingConfig()
        self.clock = Clock()
        self.topo = FabricTopology(self.cfg, seed=seed)
        self._last_arrival: dict[int, int] = {}

    @property
    def now(self) -> int:
        """Current simulated cycle."""
        return self.clock.now

    def bisnp_send(self, host_id: int) -> int:
        """Route one BISnp copy to `host_id`; returns its arrival cycle
        (ordered-channel clamped to never precede an earlier copy)."""
        depart = self.topo.fm_egress.send(self.clock.now,
                                          self.cfg.packet_bytes)
        arrive = self.topo.downlink(host_id).send(depart,
                                                  self.cfg.packet_bytes)
        arrive = max(arrive, self._last_arrival.get(host_id, 0))
        self._last_arrival[host_id] = arrive
        return arrive

    def schedule(self, cycle: int, fn: Callable[[], None]) -> None:
        """Schedule a callback on the shared clock."""
        self.clock.at(cycle, fn)

    def stats(self) -> dict:
        """Per-link counters plus elapsed cycles (JSON-ready)."""
        worst = max(self.topo.links(), key=lambda l: l.busy_cycles)
        return {
            "cycles": self.clock.now,
            "events": self.clock.events_run,
            "fm_egress": self.topo.fm_egress.stats(),
            "busiest_link": {"name": worst.name, **worst.stats()},
        }
