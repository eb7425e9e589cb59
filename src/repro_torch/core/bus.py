"""Asynchronous BISnp event bus (fabric-scale back-invalidate delivery).

Real CXL BISnp messages are posted onto the fabric and arrive at each host's
snoop queue asynchronously, in order, some time later.  `BISnpBus` models
that deterministically:

  * **per-host ordered queues** — `publish()` appends one event to every
    attached host's FIFO; a host consumes its queue in publish order, so the
    epoch stream each host observes is gap-free by construction and the
    `PermCache` fence (see `checker.invalidate_perm_cache`) stays
    on its targeted-drop path (a `fabric.HostRuntime` holds each delivered
    drop and folds the held ones into its cache at the cache's next read,
    `checker.fold_perm_cache_invalidations`, to the same cache);
  * **bounded delivery lag** — no host may fall more than `max_lag` events
    behind the FM: `publish()` force-delivers the oldest queued events of any
    host whose backlog would exceed the bound (the hardware analogue: the
    snoop queue back-pressures the fabric).  `lag(host)` ≤ `max_lag` is a
    bus invariant;
  * **drain / quiesce semantics** — `deliver(host, k)` consumes up to `k`
    events at one host (the simulation's "some time later"); `drain(host)`
    empties one queue; `quiesce()` empties every queue and returns only when
    the whole fabric has observed every committed epoch — the barrier the FM
    needs before e.g. handing a revoked page range to a new tenant;
  * **failure isolation** — a raising handler never blocks delivery to other
    hosts or wedges its own queue: the event counts as consumed, the error
    is recorded in `bus.errors`, and delivery continues.  The consumer-side
    epoch fence makes this safe: a host that missed an event's *effect*
    observes the epoch gap on the next event and resyncs (drop-everything
    path) instead of trusting stale mappings.

The bus is deliberately deterministic (no threads, no wall clocks): "async"
means *delivery is decoupled from publication and interleavable per host*,
which is the property the convergence differential test pins — any schedule
of `deliver()` calls followed by `quiesce()` leaves every host in the same
state as the old synchronous broadcast.

**Clocked mode** (``BISnpBus(clock=ClockedFabric(...))``) keeps every one of
those invariants but replaces the *manual pump* with simulated time: each
published copy is routed through the fabric timing model
(`memsim.clock` — FM egress-port serialization, per-host downlink
propagation, ordered-channel clamp) and its delivery callback is scheduled
on the global cycle heap.  `deliver`/`drain`/`quiesce` then ADVANCE THE
CLOCK until the requested events have arrived instead of popping queues
directly, and every delivery is timestamped in `bus.timeline` —
(epoch, host, publish_cycle, arrive_cycle) — which is where commit-
propagation latency percentiles come from (`memsim.replay`).  Clocked and
manual runs converge to identical fabric state.
"""
from __future__ import annotations

from collections import deque
from typing import Callable, TYPE_CHECKING

from .. import tracing

if TYPE_CHECKING:  # pragma: no cover - import cycle guard (fm imports bus)
    from ..memsim.clock import ClockedFabric
    from .faults import FaultPlan
    from .fm import BISnpEvent

# bounded error ledger: old entries roll off, `error_count` keeps the total
ERROR_LEDGER_CAP = 256


class BISnpBus:
    """Deterministic per-host ordered delivery of FM back-invalidates.

    Invariants (both modes): per-host FIFO delivery in publish order;
    `lag(host) <= max_lag` after every `publish`; a raising handler never
    blocks other hosts (`errors` ledger); after `quiesce()` every attached
    host has observed every committed epoch.
    """

    def __init__(self, *, max_lag: int | None = 64,
                 clock: "ClockedFabric | None" = None,
                 max_handler_failures: int = 16):
        if max_lag is not None and max_lag < 1:
            raise ValueError("max_lag must be >= 1 (or None for unbounded)")
        if max_handler_failures < 1:
            raise ValueError("max_handler_failures must be >= 1")
        self.max_lag = max_lag
        self.clock = clock
        self._queues: dict[int, deque] = {}
        self._handlers: dict[int, Callable[["BISnpEvent"], None]] = {}
        self.published = 0
        self.delivered = 0
        self.forced_deliveries = 0   # events delivered by the lag bound
        # last ERROR_LEDGER_CAP handler failures; error_count is the total
        self.errors: deque = deque(maxlen=ERROR_LEDGER_CAP)
        self.error_count = 0
        # consecutive failures per host; quiesce() escalates a host whose
        # handler keeps failing instead of silently spinning through it
        self.max_handler_failures = max_handler_failures
        self._consec_failures: dict[int, int] = {}
        # fault injection hook (core.faults.FaultPlan); None = lossless
        self.faults: "FaultPlan | None" = None
        # monotone per-bus sequence stamped onto each event at publish time —
        # the per-host gap detector's ground truth (strictly stronger than
        # epochs: one commit can publish several events at the same epoch)
        self._next_seq = 0
        # clocked mode only: (epoch, host_id, publish_cycle, arrive_cycle)
        # appended at delivery time — the raw commit-propagation record
        self.timeline: list[tuple[int, int, int, int]] = []
        # trace recorder hook (memsim.replay): called once per
        # published event with (ev, n_attached_hosts); None = not recording
        self.tap: Callable[["BISnpEvent", int], None] | None = None

    # -- membership ----------------------------------------------------------
    def attach(self, host_id: int,
               handler: Callable[["BISnpEvent"], None]) -> None:
        """Subscribe a host's snoop-queue consumer.  Events published before
        attachment are never seen (a late-enrolled host starts at the current
        epoch — its caches start cold, which is always safe)."""
        if host_id in self._handlers:
            raise ValueError(f"host {host_id} already attached")
        self._handlers[host_id] = handler
        self._queues[host_id] = deque()

    def detach(self, host_id: int) -> None:
        """Unsubscribe (host decommission).  Pending events are dropped —
        the host's caches die with it."""
        self._handlers.pop(host_id, None)
        self._queues.pop(host_id, None)

    @property
    def hosts(self) -> tuple[int, ...]:
        """IDs of every attached host, in attach order."""
        return tuple(self._handlers)

    # -- publication ---------------------------------------------------------
    def publish(self, ev: "BISnpEvent") -> None:
        """Enqueue `ev` on every attached host's queue, enforcing the lag
        bound by force-delivering each over-full host's OLDEST events first
        (order preserved — the new event is always consumed last).  Each
        event is stamped with a monotone bus sequence number (the per-host
        gap detector's ground truth).  A wired `FaultPlan` may drop,
        duplicate, or hold back individual copies per host.  In clocked
        mode each enqueued copy is additionally routed through the fabric
        model and its delivery scheduled at the computed arrival cycle."""
        ev.seq = self._next_seq
        self._next_seq += 1
        self.published += 1
        if self.tap is not None:
            self.tap(ev, len(self._queues))
        for host_id, q in self._queues.items():
            if self.faults is not None:
                for copy in self.faults.copies(host_id, ev):
                    self._enqueue(host_id, copy)
            else:
                self._enqueue(host_id, ev)
            if self.max_lag is not None:
                while len(q) > self.max_lag:
                    self.forced_deliveries += 1
                    self._deliver_one(host_id, q)

    def _enqueue(self, host_id: int, ev: "BISnpEvent") -> None:
        """Append one copy to a host queue (+ clocked-mode arrival)."""
        self._queues[host_id].append(ev)
        if self.clock is not None:
            t_pub = self.clock.now
            arrive = self.clock.bisnp_send(host_id)
            self.clock.schedule(
                arrive, lambda h=host_id, e=ev, t0=t_pub, t1=arrive:
                self._arrival(h, e, t0, t1))

    def _flush_stash(self, host_id: int) -> None:
        """Re-enqueue any fault-plan-delayed copies for one host — called
        before a drain/quiesce barrier so held-back copies cannot outlive
        it (dropped copies are gone; the resync protocol owns those)."""
        if self.faults is None:
            return
        for ev in self.faults.flush(host_id):
            if host_id in self._queues:
                self._enqueue(host_id, ev)

    def _arrival(self, host_id: int, ev: "BISnpEvent",
                 t_pub: int, t_arr: int) -> None:
        """Clock callback: one copy arrived at `host_id` — deliver the
        FRONT of its FIFO (arrivals are ordered-channel clamped, so front
        == this copy unless the lag bound force-delivered it already, in
        which case the arrival is a timestamp-only no-op).  Detached hosts
        drop pending arrivals."""
        q = self._queues.get(host_id)
        self.timeline.append((ev.epoch, host_id, t_pub, t_arr))
        if q:
            self._deliver_one(host_id, q)

    # -- consumption ---------------------------------------------------------
    def _deliver_one(self, host_id: int, q: deque) -> None:
        ev = q.popleft()
        self.delivered += 1
        try:
            self._handlers[host_id](ev)
        except Exception as exc:  # noqa: BLE001 - isolation is the point
            self.errors.append((host_id, ev, exc))
            self.error_count += 1
            self._consec_failures[host_id] = \
                self._consec_failures.get(host_id, 0) + 1
        else:
            self._consec_failures[host_id] = 0

    def deliver(self, host_id: int, max_events: int | None = None) -> int:
        """Consume up to `max_events` (default: all) queued events at one
        host, in publish order.  Returns the number delivered.  In clocked
        mode this ADVANCES SIMULATED TIME — the global clock runs (firing
        every host's due arrivals on the way) until the requested events
        have arrived at `host_id`."""
        q = self._queues[host_id]
        n = len(q) if max_events is None else min(max_events, len(q))
        if self.clock is not None:
            target = len(q) - n
            while len(q) > target:
                if not self.clock.clock.step():
                    raise RuntimeError(
                        f"clocked bus: {len(q) - target} queued events at "
                        f"host {host_id} have no scheduled arrival")
            return n
        for _ in range(n):
            self._deliver_one(host_id, q)
        return n

    def deliver_until(self, host_id: int, epoch: int) -> int:
        """Deliver queued events at one host up to and including `epoch` —
        the serving engine's per-step fence close: before checking a host's
        tenants against a table snapshot, the host must have observed every
        commit at or below that snapshot's epoch, without forcing a
        fabric-wide `quiesce()`.  Events past `epoch` stay queued (the
        per-host FIFO is epoch-ordered, so the prefix is exact).  Returns
        the number delivered.  Clocked mode runs the clock until the
        host's observed epoch reaches the fence."""
        q = self._queues[host_id]
        n = 0
        if self.clock is not None:
            before = len(q)
            while q and q[0].epoch <= epoch:
                if not self.clock.clock.step():
                    raise RuntimeError("clocked bus: queued event has no "
                                       "scheduled arrival")
            return before - len(q)
        while q and q[0].epoch <= epoch:
            self._deliver_one(host_id, q)
            n += 1
        return n

    def drain(self, host_id: int | None = None) -> int:
        """Deliver everything queued at one host (or, with None, at all),
        including any fault-plan-delayed copies (flushed first).  Clocked
        mode advances the clock until the queue(s) empty."""
        if host_id is not None:
            self._flush_stash(host_id)
            return self.deliver(host_id)
        for h in tuple(self._queues):
            self._flush_stash(h)
        return sum(self.deliver(h) for h in tuple(self._queues))

    def quiesce(self) -> int:
        """Fabric barrier: deliver until every queue is empty (handlers may
        not publish, so one pass suffices; asserted), then escalate any
        host whose handler failed `max_handler_failures` consecutive
        deliveries — a permanently-broken consumer must surface at the
        barrier, not spin silently through the error ledger.  Absent
        faults, every attached host has then observed every committed
        epoch (under drop faults a host may instead be desynced and
        fail-closed — see docs/faults.md).  In clocked mode the barrier
        runs the clock to idle — `clock.now` afterwards is when the LAST
        host observed the last commit (the fabric-wide propagation
        horizon)."""
        with tracing.span("bus.quiesce"):
            if self.clock is not None:
                for h in tuple(self._queues):
                    self._flush_stash(h)
                before = self.delivered
                self.clock.clock.run()
                if any(self._queues.values()):
                    raise RuntimeError("bus handlers must not publish "
                                       "during delivery — quiesce barrier "
                                       "violated")
                self._check_handler_health()
                return self.delivered - before
            n = self.drain()
            if any(self._queues.values()):
                raise RuntimeError("bus handlers must not publish during "
                                   "delivery — quiesce barrier violated")
            self._check_handler_health()
            return n

    def _check_handler_health(self) -> None:
        """Raise if any host's handler failed too many times in a row."""
        for host_id, n in self._consec_failures.items():
            if n >= self.max_handler_failures:
                raise RuntimeError(
                    f"host {host_id} snoop handler failed {n} consecutive "
                    f"deliveries (>= max_handler_failures="
                    f"{self.max_handler_failures}) — consumer is wedged")

    # -- introspection -------------------------------------------------------
    def lag(self, host_id: int) -> int:
        """Events published but not yet observed by `host_id`."""
        return len(self._queues[host_id])

    def max_observed_lag(self) -> int:
        """Largest current backlog across every attached host."""
        return max((len(q) for q in self._queues.values()), default=0)

    def propagation_cycles(self):
        """Per-delivery propagation latencies (arrive - publish cycles)
        from the clocked timeline, as a list — empty in manual mode."""
        return [t1 - t0 for _, _, t0, t1 in self.timeline]
