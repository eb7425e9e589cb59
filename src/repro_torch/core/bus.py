"""Asynchronous BISnp event bus (fabric-scale back-invalidate delivery).

Real CXL BISnp messages are posted onto the fabric and arrive at each host's
snoop queue asynchronously, in order, some time later.  `BISnpBus` models
that deterministically (no threads, no clocks):

  * **per-host ordered queues** — `publish()` appends one event to every
    attached host's FIFO; a host consumes its queue in publish order, so the
    epoch stream each host observes is gap-free by construction and the
    `PermCache` fence stays on its targeted-drop path;
  * **bounded delivery lag** — no host may fall more than `max_lag` events
    behind the FM: `publish()` force-delivers the oldest queued events of any
    host whose backlog would exceed the bound (the snoop queue
    back-pressures the fabric);
  * **drain / quiesce semantics** — `deliver(host, k)` consumes up to `k`
    events at one host; `drain(host)` empties one queue; `quiesce()` empties
    every queue and returns only when the whole fabric has observed every
    committed epoch;
  * **failure isolation** — a raising handler never blocks delivery to other
    hosts or wedges its own queue: the event counts as consumed, the error is
    recorded in `bus.errors`, and delivery continues.

This is the lossless, manually pumped bus of the JAX package.  Its clocked
mode (simulated fabric timing) and fault injection (dropped, duplicated or
delayed copies) come with the port of ``memsim`` and ``core/faults.py``.
"""
from __future__ import annotations

from collections import deque
from typing import Callable, TYPE_CHECKING

if TYPE_CHECKING:  # pragma: no cover - import cycle guard (fm imports bus)
    from .fm import BISnpEvent

# bounded error ledger: old entries roll off, `error_count` keeps the total
ERROR_LEDGER_CAP = 256


class BISnpBus:
    """Deterministic per-host ordered delivery of FM back-invalidates.

    Invariants: per-host FIFO delivery in publish order; `lag(host) <=
    max_lag` after every `publish`; a raising handler never blocks other
    hosts (`errors` ledger); after `quiesce()` every attached host has
    observed every committed epoch.
    """

    def __init__(self, *, max_lag: int | None = 64,
                 max_handler_failures: int = 16):
        if max_lag is not None and max_lag < 1:
            raise ValueError("max_lag must be >= 1 (or None for unbounded)")
        if max_handler_failures < 1:
            raise ValueError("max_handler_failures must be >= 1")
        self.max_lag = max_lag
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
        # monotone per-bus sequence stamped onto each event at publish time —
        # the per-host gap detector's ground truth (strictly stronger than
        # epochs: one commit can publish several events at the same epoch)
        self._next_seq = 0

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
        event is stamped with a monotone bus sequence number."""
        ev.seq = self._next_seq
        self._next_seq += 1
        self.published += 1
        for host_id, q in self._queues.items():
            q.append(ev)
            if self.max_lag is not None:
                while len(q) > self.max_lag:
                    self.forced_deliveries += 1
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
        host, in publish order.  Returns the number delivered."""
        q = self._queues[host_id]
        n = len(q) if max_events is None else min(max_events, len(q))
        for _ in range(n):
            self._deliver_one(host_id, q)
        return n

    def deliver_until(self, host_id: int, epoch: int) -> int:
        """Deliver queued events at one host up to and including `epoch` —
        the per-step fence close: before checking a host's tenants against a
        table snapshot, the host must have observed every commit at or below
        that snapshot's epoch, without a fabric-wide `quiesce()`.  Returns
        the number delivered."""
        q = self._queues[host_id]
        n = 0
        while q and q[0].epoch <= epoch:
            self._deliver_one(host_id, q)
            n += 1
        return n

    def drain(self, host_id: int | None = None) -> int:
        """Deliver everything queued at one host (or, with None, at all)."""
        if host_id is not None:
            return self.deliver(host_id)
        return sum(self.deliver(h) for h in tuple(self._queues))

    def quiesce(self) -> int:
        """Fabric barrier: deliver until every queue is empty (handlers may
        not publish, so one pass suffices; asserted), then escalate any host
        whose handler failed `max_handler_failures` consecutive deliveries —
        a permanently-broken consumer must surface at the barrier."""
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
