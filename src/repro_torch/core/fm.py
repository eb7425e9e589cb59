"""Fabric Manager extensions (paper §4.2.4).

The FM is the trusted coordination point: it owns K_FM, approves proposed
permission-table entries, commits them (coalescing overlaps), issues public
labels L_exp, and broadcasts BISnp back-invalidates on every committed update
so host-side permission caches drop stale entries (paper §4.1.3 / §7.1.7).

Live-update control plane: every committed table transaction bumps the table
epoch and broadcasts ONE `BISnpEvent` carrying the minimal dirty page range
(from `HostTable.commit`'s shadow-buffer diff) plus the new epoch.  Hosts
apply it to their `PermCache` via
`checker.invalidate_perm_cache` — targeted drops only, which is
what keeps the cache's epoch fence closed and its all-hit fast path hot
across tenant churn.

Delivery is two-plane (fabric scale, see the note in `bus`):
every committed event is published onto the async `BISnpBus` (per-host
ordered queues, bounded lag — how a 255-host deployment actually receives
back-invalidates; `fabric.HostRuntime` is the consumer) AND
handed to the legacy synchronous `on_bisnp` listeners.  Sync listeners are
failure-isolated: one raising handler can no longer leave the remaining
hosts un-notified mid-iteration — the error is recorded
(`bisnp_errors`, audit log) and the broadcast completes.  A host whose
handler failed self-heals through the PermCache epoch fence: the next event
it does observe reveals the epoch gap and triggers the drop-everything
resync.

Pure Python and numpy: the port keeps its own copy so that it never imports
the JAX package.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Callable, Iterator

from .. import tracing
from .bus import BISnpBus
from .crypto import derive_key, hmac_label
from .space import SpaceEngine
from .table import CommitInfo, HostTable, MAX_HWPID, perm_words_for


@dataclass
class Proposal:
    """An entry_t written to the 'proposed update' metadata section (Fig. 2)."""
    host_id: int
    hwpid: int
    base_p: int
    start_page: int
    n_pages: int
    perm: int  # PERM_R / PERM_W / PERM_RW requested for this hwpid


@dataclass
class BISnpEvent:
    """One back-invalidate broadcast: pages whose permission mapping changed
    at `epoch`.  `min_entry_idx` (when set) is the smallest table index whose
    position shifted in the commit — caches storing entry indices must also
    drop mappings at/after it (see `HostTable.CommitInfo`).

    `seq` is stamped by the bus at publish time (monotone per bus) — the
    per-host gap detector's ground truth, strictly stronger than the epoch
    (one commit broadcasts one event PER dirty range, all sharing an epoch,
    so an epoch gap cannot reveal a lost event inside a multi-range
    commit).  `snapshot=True` marks a full-state resync broadcast (FM
    restart / recovery): consumers drop their whole cache, fast-forward
    their fence and expected sequence to it, and clear any desync or
    quarantine (see docs/faults.md)."""
    start_page: int
    n_pages: int
    epoch: int = 0
    min_entry_idx: int | None = None
    seq: int = -1
    snapshot: bool = False


class FMUnavailable(RuntimeError):
    """Raised by FM control APIs while the FM is crashed (pre-`restart`)."""


@dataclass
class JournalRecord:
    """One write-ahead commit journal entry (appended BEFORE broadcast).

    Compact by design — it holds only what the device-resident table
    cannot re-derive for a restarted FM: the dirty ranges still owed to
    the fabric (`broadcast` flips once the BISnp fan-out completes) and
    the FM-volatile HWPID-liveness ops (`hwpid_ops`: ("add"|"discard",
    hwpid) pairs rebuilding `hwpid_global`)."""
    epoch: int
    ranges: tuple[tuple[int, int], ...]
    min_entry_idx: int | None
    hwpid_ops: tuple[tuple[str, int], ...] = ()
    broadcast: bool = False


class FabricManager:
    """Trusted control plane for a shared-SDM deployment."""

    def __init__(self, sdm_pages: int, table_capacity: int,
                 master_secret: bytes = b"space-control-fm-master",
                 *, max_bisnp_lag: int | None = 64, clock=None):
        self._k_fm = derive_key(master_secret, "K_FM")
        self.sdm_pages = sdm_pages
        self.table = HostTable(table_capacity)
        self.hosts: dict[int, SpaceEngine] = {}
        # deployment-wide HWPID pool: entries key perms by HWPID alone, so
        # SDM HWPIDs must be globally unique (see SpaceEngine docstring)
        self._free_hwpids: list[int] = list(range(1, MAX_HWPID + 1))
        self._hwpid_global: set[int] = set()
        self._bisnp_listeners: list[Callable[[BISnpEvent], None]] = []
        # async delivery plane: HostRuntimes attach here (core.fabric).
        # `clock` (a memsim.clock.ClockedFabric) switches the bus to
        # simulated-time delivery; None keeps the manual pump.
        self.bus = BISnpBus(max_lag=max_bisnp_lag, clock=clock)
        self.bisnp_errors: list[tuple[Callable, BISnpEvent,
                                      BaseException]] = []
        self.audit_log: list[str] = []
        self._policy: Callable[[Proposal], bool] = lambda p: True
        self._txn_depth = 0
        # FM-level side effects (hwpid_global, L_exp install, audit) staged
        # while a transaction is open; applied on commit, dropped on abort
        self._txn_effects: list[Callable[[], None]] = []
        # write-ahead commit journal: a record is appended after the table
        # commit and BEFORE the broadcast, so a crash in between leaves a
        # durable record of what the fabric is still owed (restart()
        # re-broadcasts every record with broadcast=False)
        self.journal: list[JournalRecord] = []
        # HWPID-liveness ops accumulated since the last commit; folded into
        # that commit's journal record (cleared on abort)
        self._pending_hwpid_ops: list[tuple[str, int]] = []
        self.crashed = False
        self.restarts = 0
        # fault injection hook (core.faults.FaultPlan): checked after
        # the journal append, before the broadcast — the lost-broadcast
        # window the journal exists for.  None = never crashes.
        self.faults = None

    # -- host enrolment --------------------------------------------------------
    def enroll_host(self, host_id: int, n_cores: int = 8) -> SpaceEngine:
        """Derive K_host and hand the host a SpaceEngine drawing HWPIDs
        from the deployment-wide pool (up to 255 hosts, paper abstract)."""
        self._require_alive()
        if host_id in self.hosts:
            raise ValueError(f"host {host_id} already enrolled")
        if len(self.hosts) >= 255:
            raise RuntimeError("up to 255 hosts (paper abstract)")
        k_host = derive_key(self._k_fm, f"K_host:{host_id}")
        eng = SpaceEngine(host_id, k_host, n_cores,
                          free_hwpids=self._free_hwpids)
        self.hosts[host_id] = eng
        return eng

    def set_policy(self, fn: Callable[[Proposal], bool]) -> None:
        """Operator policy deciding approval (paper: 'the FM ... decides
        whether to approve the request')."""
        self._policy = fn

    def on_bisnp(self, fn: Callable[[BISnpEvent], None]) -> None:
        """Register a legacy synchronous BISnp listener (failure-isolated;
        fabric-scale consumers attach to `self.bus` instead)."""
        self._bisnp_listeners.append(fn)

    # -- epoch-versioned commit plumbing ---------------------------------------
    @property
    def epoch(self) -> int:
        """Committed table version (bumped once per transaction)."""
        return self.table.epoch

    @contextlib.contextmanager
    def transaction(self) -> Iterator["FabricManager"]:
        """Coalesce several grant/revoke operations into ONE table commit —
        one epoch bump, one BISnp broadcast covering the union dirty range.
        Nested transactions are flattened into the outermost one, whose
        whole extent is the epoch's ``fm.commit`` span."""
        self._require_alive()
        if self._txn_depth:
            self._txn_depth += 1
            try:
                yield self
            finally:
                self._txn_depth -= 1
            return
        with tracing.span("fm.commit"):
            self.table.begin()
            self._txn_depth = 1
            try:
                yield self
            except BaseException:
                self.table.abort()
                self._txn_effects.clear()
                self._pending_hwpid_ops.clear()
                raise
            finally:
                self._txn_depth -= 1
            try:
                self._commit_and_broadcast()
                for effect in self._txn_effects:
                    effect()
            finally:
                # a failing commit must not leak staged effects into the
                # next txn
                self._txn_effects.clear()

    def _commit_and_broadcast(self) -> CommitInfo | None:
        info = self.table.commit()
        if info is not None:
            ranges = info.ranges or ((info.start_page, info.n_pages),)
            # write-ahead: the journal learns about this commit before any
            # host does, so a crash mid-broadcast cannot lose it
            rec = JournalRecord(epoch=info.epoch, ranges=tuple(ranges),
                                min_entry_idx=info.min_shifted_entry,
                                hwpid_ops=tuple(self._pending_hwpid_ops))
            self._pending_hwpid_ops.clear()
            self.journal.append(rec)
            if self.faults is not None and \
                    self.faults.should_crash_fm(info.epoch):
                self.crash()   # journaled but never broadcast — the
                return info    # restart path owes the fabric this record
            for start, n in ranges:
                self._broadcast(BISnpEvent(start, n, epoch=info.epoch,
                                           min_entry_idx=info.min_shifted_entry))
            rec.broadcast = True
        return info

    def _mutate_table(self, fn):
        """Run `fn()` (table mutations) inside the open transaction, or as a
        single auto-committed + broadcast transaction."""
        if self._txn_depth:
            return fn()
        with tracing.span("fm.commit"):
            self.table.begin()
            try:
                ret = fn()
            except BaseException:
                self.table.abort()
                self._pending_hwpid_ops.clear()
                raise
            self._commit_and_broadcast()
        return ret

    def _stage_effect(self, effect: Callable[[], None]) -> None:
        """Apply an FM-level side effect now, or — inside a transaction —
        stage it so an abort rolls it back along with the table."""
        if self._txn_depth:
            self._txn_effects.append(effect)
        else:
            effect()

    # -- proposal -> approve -> commit -> label (Fig. 2 workflow) --------------
    def propose(self, p: Proposal) -> int | None:
        """Returns L_exp on approval, None on rejection."""
        self._require_alive()
        if p.host_id not in self.hosts:
            self.audit_log.append(f"REJECT unknown host {p.host_id}")
            return None
        if not (1 <= p.hwpid <= MAX_HWPID):
            self.audit_log.append(f"REJECT bad hwpid {p.hwpid}")
            return None
        if p.start_page < 0 or p.start_page + p.n_pages > self.sdm_pages:
            self.audit_log.append(f"REJECT range [{p.start_page},+{p.n_pages})")
            return None
        if not self._policy(p):
            self.audit_log.append(f"REJECT policy {p}")
            return None
        # Commit: FM optimizes/coalesces overlapping entries (paper §4.1.1).
        # The HWPID-liveness op is queued first so the commit's journal
        # record carries it (write-ahead for the FM-volatile state too).
        self._pending_hwpid_ops.append(("add", p.hwpid))
        self._mutate_table(lambda: self.table.insert(
            p.start_page, p.n_pages, perm_words_for({p.hwpid: p.perm}),
            owner_host=p.host_id))
        # L_exp = MAC_{K_FM}(host_id, HWPID, BASE_P, range)   (Eq. 1).
        # Computing it is pure; the grant bookkeeping (hwpid_global, label
        # install, audit) is staged so a transaction abort rolls it back —
        # inside a transaction the returned label only becomes live at
        # commit.
        label = hmac_label(self._k_fm, p.host_id, p.hwpid, p.base_p,
                           (p.start_page << 24) | p.n_pages)

        def committed(p=p, label=label):
            self._hwpid_global.add(p.hwpid)
            self.hosts[p.host_id].install_lexp(
                p.hwpid, p.base_p, label, (p.start_page, p.n_pages))
            self.audit_log.append(
                f"COMMIT host={p.host_id} hwpid={p.hwpid} "
                f"[{p.start_page},+{p.n_pages}) perm={p.perm}")

        self._stage_effect(committed)
        return label

    def revoke_hwpid(self, hwpid: int) -> None:
        """Revocation: clear permissions, drop empty entries, and BISnp all
        hosts with the commit's actual dirty range (targeted — hosts keep
        every cached mapping the revoke did not touch)."""
        self._require_alive()
        self._pending_hwpid_ops.append(("discard", hwpid))
        self._mutate_table(lambda: self.table.remove_hwpid(hwpid))
        self._stage_effect(lambda: (
            self._hwpid_global.discard(hwpid),
            self.audit_log.append(f"REVOKE hwpid={hwpid}")))

    def release_range(self, hwpid: int, start_page: int, n_pages: int) -> None:
        """Partial release: revoke one HWPID's grant over a page range only
        (region release on tenant eviction), leaving its other grants live."""
        self._require_alive()
        self._mutate_table(
            lambda: self.table.revoke_range(start_page, n_pages, hwpid))
        self._stage_effect(lambda: self.audit_log.append(
            f"RELEASE hwpid={hwpid} [{start_page},+{n_pages})"))

    def tombstone_count(self) -> int:
        """Committed entries whose perm words are all zero — revocation
        tombstones awaiting reclaim by an overlapping insert or `vacuum()`.
        `ShardedFabric.evict` polls this to schedule maintenance vacuums:
        churn that re-admits at fresh page offsets never overlaps its old
        tombstones, so lazy reclaim alone lets them exhaust the table."""
        t = self.table
        return int((~t.perms[:t.n].any(axis=1)).sum())

    def vacuum(self) -> None:
        """Compact revocation tombstones out of the table (deliberate
        maintenance; shifts entry indices, so the broadcast carries
        min_entry_idx and caches drop shifted mappings)."""
        self._require_alive()
        self._mutate_table(self.table.vacuum)
        self._stage_effect(lambda: self.audit_log.append("VACUUM"))

    def hwpid_global(self) -> set[int]:
        """HWPID_global = union over hosts (paper §4.2.2)."""
        return set(self._hwpid_global)

    # -- crash / restart / resync (fail-closed control plane) ------------------
    def _require_alive(self) -> None:
        """Every FM control API starts here: a crashed FM answers nothing."""
        if self.crashed:
            raise FMUnavailable("fabric manager is down (crash pending "
                                "restart) — retry with backoff")

    def crash(self) -> None:
        """Kill the FM process model: volatile state (`hwpid_global`) is
        gone; the permission table survives (it lives in device memory, not
        the FM); the bus keeps delivering already-published copies (they
        are on the wire, not in the FM).  All control APIs raise
        `FMUnavailable` until `restart()`."""
        self.crashed = True
        self._hwpid_global = set()
        self._pending_hwpid_ops.clear()
        self.audit_log.append("FM-CRASH")

    def restart(self) -> None:
        """Recover a crashed FM from durable state.

        Three steps, in order: (1) replay the journal's HWPID-liveness ops
        to re-derive `hwpid_global` (epoch and tombstones need no replay —
        they are read straight from the device-resident table); (2)
        re-broadcast every journal record whose fan-out never completed
        (fresh event objects, fresh bus sequence numbers — duplicates are
        harmless, consumers treat a replayed epoch as a targeted drop);
        (3) publish one full-range `snapshot=True` resync event that any
        gapped, quarantined, or rejoining host uses to rebuild its view.
        Idempotent: restarting a live FM only re-publishes the snapshot."""
        self.crashed = False
        self.restarts += 1
        rebuilt: set[int] = set()
        for rec in self.journal:
            for op, hwpid in rec.hwpid_ops:
                (rebuilt.add if op == "add" else rebuilt.discard)(hwpid)
        self._hwpid_global = rebuilt
        self.audit_log.append(
            f"FM-RESTART epoch={self.table.epoch} "
            f"hwpids={len(rebuilt)} journal={len(self.journal)}")
        for rec in self.journal:
            if not rec.broadcast:
                for start, n in rec.ranges:
                    self._broadcast(BISnpEvent(
                        start, n, epoch=rec.epoch,
                        min_entry_idx=rec.min_entry_idx))
                rec.broadcast = True
        self._broadcast(BISnpEvent(0, self.sdm_pages,
                                   epoch=self.table.epoch, snapshot=True))

    def sync_host(self, host_id: int) -> tuple[int, int]:
        """Point resync for one gapped host (the retry/backoff target):
        returns ``(epoch, next_seq)`` — the live table epoch to fence the
        host's rebuilt (empty) cache at, and the bus sequence number the
        host should expect next.  Copies already queued for the host carry
        older sequences and degrade to harmless replay drops.  Raises
        `FMUnavailable` while crashed — that is what the host's bounded
        exponential backoff is for."""
        self._require_alive()
        if host_id not in self.bus.hosts and host_id not in self.hosts:
            raise ValueError(f"host {host_id} not attached")
        self.audit_log.append(f"SYNC host={host_id} epoch={self.table.epoch}")
        return self.table.epoch, self.bus._next_seq

    def _broadcast(self, ev: BISnpEvent) -> None:
        """Fan one committed event out to BOTH delivery planes.

        Sync listeners are failure-isolated: every listener sees the event
        even when an earlier one raises (previously an exception aborted the
        loop mid-iteration, leaving later hosts un-notified — their caches
        then held stale grants with no record of it).  Errors are recorded,
        never propagated: the table commit already happened, so the only
        consistent forward path is to finish notifying the fabric.
        """
        self.bus.publish(ev)
        for fn in self._bisnp_listeners:
            try:
                fn(ev)
            except Exception as exc:  # noqa: BLE001 - must not stop fan-out
                self.bisnp_errors.append((fn, ev, exc))
                self.audit_log.append(
                    f"BISNP-ERR listener={getattr(fn, '__name__', fn)!r} "
                    f"epoch={ev.epoch} [{ev.start_page},+{ev.n_pages}): "
                    f"{exc!r}")

    # -- storage accounting (paper §7.2 / Eq. 3-4) ------------------------------
    def storage_overhead_fraction(self) -> float:
        """Worst-case metadata fraction: 64 B per 4 KiB page = 1.5625 %."""
        worst_entries = self.sdm_pages
        return worst_entries * 64 / (self.sdm_pages * 4096)

    @property
    def k_fm(self) -> bytes:
        """The FM master key — exposed for attestation tests only."""
        return self._k_fm
