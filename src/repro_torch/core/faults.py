"""Deterministic fault injection for the fabric control plane.

The control plane built so far (`BISnpBus`, `FabricManager`, `HostRuntime`)
assumed lossless, ordered, never-crashing delivery.  Real CXL fabrics lose
links, drop or reorder messages across switch resets, and restart their
fabric manager — and Space-Control's security claim has to hold *under*
those faults, not just in the happy path.  This module is the seeded chaos
oracle every fault-tolerance test and bench drives:

  * **message faults** — per published BISnp copy, `FaultPlan.copies`
    decides drop / duplicate / reorder (delay-by-one) / delay-by-k.  The
    bus consumes the returned copy list verbatim (`BISnpBus.faults`);
    delayed copies sit in a per-host stash and re-enter the queue after
    later publishes, which is exactly an out-of-order channel;
  * **link faults** — per-host downlink degradation factors and outage
    windows for the clocked simulator (`memsim.clock.Link` grew
    `degrade_factor` / `outages` primitives; `apply_link_faults` installs
    a plan's schedule onto a live `ClockedFabric`);
  * **process faults** — FM crash points (`fm_crash_epochs`: the FM dies
    AFTER journaling a commit but BEFORE broadcasting it — the classic
    lost-broadcast window the write-ahead journal exists for) and the
    host crash/rejoin schedule the chaos harness replays through
    `ShardedFabric.crash_host` / `rejoin_host`.

Every decision comes from one `numpy` Generator seeded at construction:
the same seed and the same publish sequence produce the same fault
schedule, so chaos runs are replayable and CI-stable.  The recovery
machinery these faults exercise lives with the components themselves:
sequence-gap detection and fail-closed denial in
`core.fabric.HostRuntime`, the commit journal and snapshot resync in
`core.fm.FabricManager`.  ``docs/faults.md`` describes the protocol.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class FaultSpec:
    """Per-copy fault probabilities for the BISnp delivery plane.

    One uniform draw per published (host, event) copy lands in cumulative
    bands: ``[0, drop_p)`` the copy is lost, ``[.., +dup_p)`` it is
    enqueued twice, ``[.., +reorder_p)`` it is held back one publish (so
    it swaps with the next copy — an out-of-order channel), and
    ``[.., +delay_p)`` it is held back ``1..max_delay`` publishes.
    Anything else delivers normally.  Probabilities must sum to <= 1.
    """
    drop_p: float = 0.0
    dup_p: float = 0.0
    reorder_p: float = 0.0
    delay_p: float = 0.0
    max_delay: int = 4

    def __post_init__(self):
        """Validate the probability bands."""
        total = self.drop_p + self.dup_p + self.reorder_p + self.delay_p
        if not 0.0 <= total <= 1.0:
            raise ValueError(f"fault probabilities sum to {total}, not <= 1")
        if self.max_delay < 1:
            raise ValueError("max_delay must be >= 1")


@dataclass(frozen=True)
class LinkFault:
    """One downlink's degradation/outage schedule (clocked mode only).

    ``degrade`` multiplies the link's serialization occupancy (2.0 =
    half-bandwidth); ``outages`` are ``[start, end)`` cycle windows during
    which the serializer accepts nothing — a message arriving mid-outage
    waits for the window to close (see `Link.send`).
    """
    degrade: float = 1.0
    outages: tuple[tuple[int, int], ...] = ()


class FaultPlan:
    """Seeded, replayable fault schedule for one fabric deployment.

    Wire it with ``fabric.inject_faults(plan)`` (sets `BISnpBus.faults`
    and `FabricManager.faults`), or attach the pieces by hand.  All
    counters (`dropped`, `duplicated`, `delayed`) are exact, so a chaos
    test can assert the schedule actually exercised each fault class.
    """

    def __init__(self, spec: FaultSpec | None = None, *, seed: int = 0,
                 fm_crash_epochs: tuple[int, ...] = (),
                 link_faults: dict[int, LinkFault] | None = None):
        self.spec = spec or FaultSpec()
        self.seed = seed
        self.rng = np.random.default_rng(seed)
        # epochs whose commit the FM journals and then dies on, BEFORE the
        # broadcast (consumed once each — a restarted FM re-broadcasting
        # the journal tail must not re-crash on the same epoch)
        self._fm_crash_epochs = set(fm_crash_epochs)
        self.link_faults = dict(link_faults or {})
        # per-host stash of (release_countdown, event) held-back copies
        self._stash: dict[int, list] = {}
        self.dropped = 0
        self.duplicated = 0
        self.delayed = 0
        self.fm_crashes = 0

    # -- message faults (consumed by BISnpBus.publish) -----------------------
    def copies(self, host_id: int, ev) -> list:
        """The copies to enqueue NOW at `host_id` for one published event:
        the faulted current copy (possibly absent or doubled) followed by
        any stashed copies whose hold-back expired this publish.  Exactly
        one rng draw per call — the schedule is a pure function of the
        seed and the publish sequence."""
        s = self.spec
        u = float(self.rng.random())
        out: list = []
        # age the stash FIRST (only copies held back by EARLIER publishes):
        # a copy stashed with countdown k re-enters on the k-th LATER
        # publish, behind that publish's own copy — i.e. out of order
        released, kept = [], []
        for item in self._stash.get(host_id, ()):
            item[0] -= 1
            (released if item[0] <= 0 else kept).append(item)
        self._stash[host_id] = kept
        if u < s.drop_p:
            self.dropped += 1
        elif u < s.drop_p + s.dup_p:
            self.duplicated += 1
            out += [ev, ev]
        elif u < s.drop_p + s.dup_p + s.reorder_p:
            self.delayed += 1
            self._stash[host_id].append([1, ev])
        elif u < s.drop_p + s.dup_p + s.reorder_p + s.delay_p:
            self.delayed += 1
            k = 1 + int(self.rng.integers(0, s.max_delay))
            self._stash[host_id].append([k, ev])
        else:
            out.append(ev)
        out += [ev2 for _, ev2 in released]
        return out

    def flush(self, host_id: int) -> list:
        """Hand back every stashed (still-delayed) copy for `host_id` —
        called by `drain`/`quiesce` so a held-back copy cannot sit in
        limbo past a fabric barrier.  Dropped copies are gone forever;
        only the gap/resync protocol recovers those."""
        released = [ev for _, ev in self._stash.get(host_id, ())]
        self._stash[host_id] = []
        return released

    def stashed(self, host_id: int | None = None) -> int:
        """Copies currently held back (one host, or fabric-wide)."""
        if host_id is not None:
            return len(self._stash.get(host_id, ()))
        return sum(len(v) for v in self._stash.values())

    # -- process faults ------------------------------------------------------
    def should_crash_fm(self, epoch: int) -> bool:
        """True exactly once per scheduled crash epoch: the FM checks this
        after journaling a commit and before broadcasting it."""
        if epoch in self._fm_crash_epochs:
            self._fm_crash_epochs.discard(epoch)
            self.fm_crashes += 1
            return True
        return False

    # -- link faults (clocked mode) ------------------------------------------
    def apply_link_faults(self, clocked_fabric) -> None:
        """Install the plan's per-host downlink degradation/outage schedule
        onto a live `ClockedFabric` topology."""
        for host_id, lf in self.link_faults.items():
            link = clocked_fabric.topo.downlink(host_id)
            link.degrade_factor = lf.degrade
            link.outages = list(lf.outages)
