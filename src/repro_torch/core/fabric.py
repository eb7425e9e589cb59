"""Sharded fabric deployment (paper abstract: 127 concurrent processes
across up to 255 hosts sharing one SDM), with the data plane on the GPU.

`FabricManager` (core.fm) is the trusted control plane; this module is the
*data plane at fabric scale*: each enrolled host owns a `HostRuntime`
bundling its SpaceEngine, an epoch-fenced `PermCache` fed by the async
`BISnpBus`, and a page-range **resident shard** of the permission table —
the subset of entries its egress checker and kernels actually load.

Sharding model
--------------
The SDM page space is partitioned into `n_shards` contiguous ranges; host
`h` is resident for shard `h` plus any explicitly added shared ranges.  A
host's checker never touches entries outside its resident ranges: the shard
is re-extracted from the committed table at most once per epoch
(`shard_rebuilds` counts how often churn forced it), and per-tenant
`ShardView`s for the kernels are memoized the same way: carried to the new
epoch where the extracted arrays did not change, built where they did, and
stacked afresh into the fabric's stacked view, one `torch.stack` a field.
Entries straddling a shard boundary are kept whole — a superset shard is
only extra work, never a wrong verdict, because the checker's range test
is exact.

Observation model
-----------------
The committed `HostTable` is ground truth; the `PermCache` models what the
host has *observed through BISnp delivery*.  Delivery does the bus's
bookkeeping at once but holds each targeted drop; the next read of
`HostRuntime.permcache` folds the held drops into the cache in one pass,
so every reader sees the cache that applying each drop on delivery gives,
and a host that never reads its cache runs no drop on the device.  While
a host lags the bus its cache epoch trails the table epoch, so
`cached_check_access` revalidates hits against the live shard — stale
mappings degrade to misses, never stale grants.  Cached entry indices are
SHARD-LOCAL while `BISnpEvent.min_entry_idx` is GLOBAL; the global index is
forwarded as the drop threshold (a shard-local rank never exceeds its
global index), and shard extraction diffs the kept GLOBAL index set per
epoch and flushes the cache's index mappings whenever membership moved
(`_resident_entries`) — that diff is the correctness backstop.

Multi-tenant hosts
------------------
`fabric_view` accepts ``{host_id: hwpid}`` or ``{host_id: [hwpids...]}``
and emits ONE stacked kernel row per (host, tenant) pair — co-resident
tenants share the host's shard arrays but carry their own permbits row.

Device: every tensor of a fabric lives on ``ShardedFabric(device=...)``
(default CUDA; raises without it unless ``device="cpu"``).  The control
plane's fault points (`inject_faults`), the heartbeat host monitor
(`enable_host_monitor`), the clocked bus (``clock=``) and timing traces
(`begin_trace`) are host-side Python and numpy, as in the JAX package.
"""
from __future__ import annotations

from typing import NamedTuple, TYPE_CHECKING

import numpy as np
import torch
import torch.nn.functional as F

from .. import tracing
from ..kernels import resolve_device
from .checker import (PERM_CACHE_BYTES, PermCache, cached_check_access,
                      desync_check_result, fold_perm_cache_invalidations,
                      make_hwpid_local, make_perm_cache)
from .fm import BISnpEvent, FabricManager, FMUnavailable, Proposal
from .table import EMPTY_START, PERM_RW, PermissionTable, _NO_END, as_int32

if TYPE_CHECKING:  # pragma: no cover
    from ..kernels.permcheck import ShardView

# kernels.permcheck imports core.table, so importing it at module scope here
# (re-exported via core.__init__) would be circular whenever the kernels
# package loads first — resolve it lazily instead.


def _permcheck_mod():
    from ..kernels import permcheck
    return permcheck


# back-invalidates a host holds before its PermCache is read; delivery
# folds them into the cache once it holds more
PENDING_BISNP_CAP = 256


class HostRuntime:
    """Per-host data plane: SpaceEngine + fenced PermCache + resident shard."""

    def __init__(self, fabric: "ShardedFabric", host_id: int,
                 page_lo: int, page_hi: int, *,
                 perm_cache_bytes: int = PERM_CACHE_BYTES):
        self.fabric = fabric
        self.device = fabric.device
        self.host_id = host_id
        self.engine = fabric.fm.hosts[host_id]
        self.page_lo = page_lo
        self.page_hi = page_hi
        self._extra_ranges: list[tuple[int, int]] = []
        self.hwpids: set[int] = set()
        self.perm_cache_bytes = perm_cache_bytes
        # (start_page, n_pages, epoch, min_entry_idx) of the drops delivered
        # since the cache was last read, folded in at the next read
        self._pending: list[tuple] = []
        self.permcache = make_perm_cache(perm_cache_bytes,
                                         epoch=fabric.fm.epoch,
                                         device=self.device)
        self.bisnp_deferred = 0   # back-invalidates held for a later read
        self.bisnp_flushes = 0    # folded passes run over the cache
        self.views = _permcheck_mod().ShardViewCache()
        self.bisnp_seen = 0
        self.shard_rebuilds = 0
        # BISnp loss recovery: the bus stamps a monotone sequence on every
        # event; a hole in the per-host stream means a copy was lost and the
        # host FAILS CLOSED (check() denies with FAULT_DESYNC) until a late
        # reordered copy fills the hole or a resync rebuilds the view
        self._expected_seq = fabric.fm.bus._next_seq
        self._missing: set[int] = set()
        self.quarantined = False
        self.crashed = False
        self.max_resync_attempts = 6
        self.desync_events = 0    # sequence gaps detected
        self.self_heals = 0       # gaps closed by late reordered copies
        self.resyncs = 0          # successful FM point-resyncs
        self.snapshot_resyncs = 0  # recoveries via FM snapshot broadcast
        self.denied_desync = 0    # check() batches denied fail-closed
        self._resync_ticks = 0    # check() calls since the last attempt
        self._resync_wait = 1     # current backoff, in check() calls
        self._resync_attempts = 0
        self._shard: tuple[np.ndarray, np.ndarray, np.ndarray] | None = None
        self._shard_idx: np.ndarray | None = None  # kept global indices
        self._shard_epoch = -1
        self._shard_table: PermissionTable | None = None
        self._hwpid_local: torch.Tensor | None = None
        fabric.fm.bus.attach(host_id, self.on_bisnp)

    # -- the PermCache, with the drops held for its next read ---------------
    @property
    def permcache(self) -> PermCache:
        """This host's PermCache as applying every delivered drop at once
        would leave it: the drops held since the last read are folded in
        first, in one pass."""
        self._fold()
        return self._permcache

    @permcache.setter
    def permcache(self, cache: PermCache) -> None:
        """Install ``cache``; drops held for the one it replaces lapse."""
        self._permcache = cache
        self._pending = []

    def _fold(self) -> None:
        if self._pending:
            self._permcache = fold_perm_cache_invalidations(
                self._permcache, self._pending)
            self._pending = []
            self.bisnp_flushes += 1

    def _defer(self, start_page: int, n_pages: int, epoch: int,
               min_entry_idx: int | None) -> None:
        """Hold one targeted drop for the cache's next read, folding what
        is held at once when it would pass `PENDING_BISNP_CAP`."""
        if len(self._pending) >= PENDING_BISNP_CAP:
            self._fold()
        self._pending.append((start_page, n_pages, epoch, min_entry_idx))

    # -- bus consumer --------------------------------------------------------
    def on_bisnp(self, ev: BISnpEvent) -> None:
        """Take one delivered back-invalidate: match the event's bus
        sequence against this host's expected stream, then hold the
        targeted PermCache drop, with the epoch fence's replay/gap
        semantics, for the cache's next read.  A hole (lost copy) records
        the missing sequences and desyncs the host; a late copy that fills
        the last hole heals it; a ``snapshot=True`` event rebuilds the
        whole view."""
        self.bisnp_seen += 1
        if self.fabric.host_monitor is not None:
            self.fabric.host_monitor.beat(self.host_id)
        if ev.snapshot:
            self._apply_snapshot(ev)
            return
        if ev.seq >= 0:
            if ev.seq == self._expected_seq:
                self._expected_seq += 1
            elif ev.seq > self._expected_seq:
                self._missing.update(range(self._expected_seq, ev.seq))
                self._expected_seq = ev.seq + 1
                self.desync_events += 1
            else:
                # replay/duplicate/late copy: if it fills a recorded hole
                # the "loss" was reordering and the fail-closed window ends
                if ev.seq in self._missing:
                    self._missing.discard(ev.seq)
                    if not self._missing and not self.quarantined:
                        self.self_heals += 1
                        self._reset_backoff()
        self._defer(ev.start_page, ev.n_pages, ev.epoch, ev.min_entry_idx)
        self.bisnp_deferred += 1

    # -- loss recovery (fail closed, then resync) ----------------------------
    @property
    def desynced(self) -> bool:
        """True while this host cannot trust its view: a sequence hole is
        outstanding or the host exhausted its resync attempts
        (quarantined).  `check()` denies everything while True."""
        return bool(self._missing) or self.quarantined

    def _reset_backoff(self) -> None:
        self._resync_ticks = 0
        self._resync_wait = 1
        self._resync_attempts = 0

    def _fresh_cache(self, epoch: int):
        return make_perm_cache(self.perm_cache_bytes, epoch=epoch,
                               device=self.device)

    def _apply_snapshot(self, ev: BISnpEvent) -> None:
        """Consume an FM snapshot-resync broadcast: drop the whole cache,
        fence at the snapshot epoch, fast-forward the expected sequence,
        and clear any desync or quarantine."""
        self.snapshot_resyncs += 1
        self._missing.clear()
        self.quarantined = False
        self._reset_backoff()
        if ev.seq >= 0:
            self._expected_seq = ev.seq + 1
        self.permcache = self._fresh_cache(ev.epoch)

    def _try_resync(self) -> None:
        """One backoff tick toward an FM point-resync: attempt, and on
        `FMUnavailable` double the wait — after `max_resync_attempts`
        consecutive failures the host quarantines itself."""
        self._resync_ticks += 1
        if self._resync_ticks < self._resync_wait:
            return
        self._resync_ticks = 0
        self._resync_attempts += 1
        try:
            epoch, next_seq = self.fabric.fm.sync_host(self.host_id)
        except FMUnavailable:
            self._resync_wait = min(self._resync_wait * 2, 4096)
            if self._resync_attempts >= self.max_resync_attempts:
                self.quarantined = True
            return
        self._missing.clear()
        self._expected_seq = next_seq
        self.permcache = self._fresh_cache(epoch)
        self._reset_backoff()
        self.resyncs += 1

    # -- resident shard ------------------------------------------------------
    def add_resident_range(self, start_page: int, n_pages: int) -> None:
        """Mark an extra page range (e.g. a shared read-only region) as
        resident on this host's checker.  The table epoch does not move
        here, so every memo layer is dropped explicitly."""
        self._extra_ranges.append((start_page, start_page + n_pages))
        self._drop_derived()

    def remove_resident_range(self, start_page: int, n_pages: int) -> None:
        """Release ONE occurrence of a shared resident range (ranges are
        occurrence-counted: two tenants sharing a region pin it twice)."""
        self._extra_ranges.remove((start_page, start_page + n_pages))
        self._drop_derived()

    def _drop_derived(self) -> None:
        """Drop every memo derived from this host's shard: the next read
        re-extracts it and builds its views, and the fabric re-stacks."""
        self._shard_epoch = -1
        self.views = _permcheck_mod().ShardViewCache()
        self.fabric._drop_fabric_view()

    def rejoin(self, epoch: int, next_seq: int) -> None:
        """Come back cold after a crash: a fresh PermCache fenced at
        ``epoch``, the expected sequence at ``next_seq``, desync,
        quarantine and backoff cleared, every derived memo dropped."""
        self.crashed = False
        self.quarantined = False
        self._missing.clear()
        self._reset_backoff()
        self._expected_seq = next_seq
        self.permcache = self._fresh_cache(epoch)
        self._drop_derived()

    def resident_ranges(self) -> list[tuple[int, int]]:
        """Page ranges [lo, hi) this host's checker is resident for."""
        return [(self.page_lo, self.page_hi)] + self._extra_ranges

    def lag(self) -> int:
        """BISnp events published but not yet observed by this host."""
        return self.fabric.fm.bus.lag(self.host_id)

    def _resident_entries(self):
        """(starts, ends, perm_words) of committed entries overlapping any
        resident range, re-extracted at most once per table epoch.  Where
        the arrays equal those held, the views derived from them are
        carried to the new epoch instead of being built again."""
        ht = self.fabric.fm.table
        if self._shard is not None and self._shard_epoch == ht.epoch:
            return self._shard
        n = ht.n
        starts = ht.starts[:n]
        ends = starts + ht.sizes[:n]
        keep = np.zeros(n, bool)
        for lo, hi in self.resident_ranges():
            i0 = int(np.searchsorted(ends, lo, side="right"))
            i1 = int(np.searchsorted(starts, hi, side="left"))
            keep[i0:i1] = True
        idx = np.flatnonzero(keep)
        if self._shard_idx is not None and \
                not np.array_equal(idx, self._shard_idx):
            # Shard MEMBERSHIP changed: later entries' shard-local ranks
            # shift and the cache's (page -> rank) mappings would dangle, so
            # flush index mappings locally (the fence itself is untouched:
            # the flush carries the epoch of the cache as held, which no
            # held drop lowers, so it reads as a replay).  Extraction
            # always precedes the probe in `check`.
            self._defer(0, 0, self._permcache.epoch, 0)
        self._shard_idx = idx
        shard = (starts[idx].copy(), ends[idx].copy(),
                 ht.perms[:n][idx].copy())
        # the arrays' bytes: equal dtypes, and equal lengths only if the
        # entry counts are, so equal bytes are equal arrays (a third of
        # np.array_equal's time on ~100-entry shards)
        if self._shard is not None and all(
                a.tobytes() == b.tobytes()
                for a, b in zip(shard, self._shard)):
            self.views.carry(self._shard_epoch, ht.epoch)
        self._shard = shard
        self._shard_epoch = ht.epoch
        self._shard_table = None
        self.shard_rebuilds += 1
        return self._shard

    def shard_entries(self) -> int:
        """Committed entries in this host's resident shard (forces an
        extraction at the current epoch if one is pending)."""
        return self._resident_entries()[0].shape[0]

    def shard_table(self) -> PermissionTable:
        """Device `PermissionTable` holding ONLY this host's resident shard
        (what the framework checker binary-searches), epoch-stamped."""
        self._resident_entries()
        if self._shard_table is not None:
            return self._shard_table
        s, e, pw = self._shard
        n = s.shape[0]
        cap = max(8, 1 << (max(n, 1) - 1).bit_length())
        starts = np.full((cap,), EMPTY_START, np.int32)
        sizes = np.zeros((cap,), np.int32)
        perms = np.zeros((cap, pw.shape[1]), np.uint32)
        starts[:n], sizes[:n], perms[:n] = s, e - s, pw
        dev = self.device
        self._shard_table = PermissionTable(
            starts=as_int32(starts, dev), sizes=as_int32(sizes, dev),
            perms=as_int32(perms, dev),
            meta=torch.zeros((cap,), dtype=torch.int32, device=dev),
            n=n, epoch=self._shard_epoch)
        return self._shard_table

    def shard_view(self, hwpid: int) -> "ShardView":
        """Padded + tile-summarized kernel operands for one tenant over the
        resident shard, memoized per (tenant, epoch)."""
        s, e, pw = self._resident_entries()
        epoch = self._shard_epoch

        def build() -> "ShardView":
            word = pw[:, hwpid // 16]
            permbits = (word >> np.uint32((hwpid % 16) * 2)) & np.uint32(3)
            return _permcheck_mod().make_shard_view(
                s, e, permbits, epoch=epoch, device=self.device)

        return self.views.get(hwpid, epoch, build)

    # -- the host-side egress check -----------------------------------------
    def hwpid_local(self) -> torch.Tensor:
        """HWPID_local membership vector for the checker (paper §4.2.2),
        rebuilt lazily whenever this host's tenant set changes."""
        if self._hwpid_local is None:
            self._hwpid_local = make_hwpid_local(sorted(self.hwpids),
                                                 device=self.device)
        return self._hwpid_local

    def check(self, ext_addrs, is_write):
        """Framework permission check against the resident shard through
        this host's fenced PermCache.  Returns the CheckResult; the cache is
        threaded internally.

        Fail-closed gate: a desynced host (outstanding BISnp sequence hole
        or quarantine) answers a uniform `FAULT_DESYNC` deny WITHOUT
        consulting table or cache.  Each denied batch also ticks the resync
        backoff, so a stalled-but-checking host works its own way back."""
        if self.fabric.host_monitor is not None:
            self.fabric.host_monitor.beat(self.host_id)
        if self.crashed:
            raise RuntimeError(f"host {self.host_id} is crashed — "
                               f"rejoin_host() first")
        if self.desynced and not self.quarantined:
            self._try_resync()
        if self.desynced:
            self.denied_desync += 1
            return desync_check_result(int(np.shape(ext_addrs)[-1]),
                                       device=self.device)
        table = self.shard_table()
        res, self.permcache = cached_check_access(
            table, self.hwpid_local(), ext_addrs, is_write, self.permcache)
        return res

    def _grant_installed(self, hwpid: int) -> None:
        self.hwpids.add(hwpid)
        self._hwpid_local = None

    def _grant_released(self, hwpid: int) -> None:
        self.hwpids.discard(hwpid)
        self._hwpid_local = None
        self.views.drop(hwpid)


class FabricView(NamedTuple):
    """Stacked per-(host, tenant) shard operands for the batched multi-host
    egress kernel (`repro_torch.kernels.fabric_egress.fabric_egress`): row
    `i` holds host `host_ids[i]`'s resident shard padded to the fleet-wide
    entry count, with `permbits` pre-extracted for tenant `hwpids[i]`."""
    starts: torch.Tensor     # i32[R, N]
    ends: torch.Tensor       # i32[R, N]
    permbits: torch.Tensor   # i32[R, N]
    tile_min: torch.Tensor   # i32[R, T]
    tile_max: torch.Tensor   # i32[R, T]
    hwpids: torch.Tensor     # i32[R]
    host_ids: tuple[int, ...]
    epoch: int = 0

    @property
    def n_hosts(self) -> int:
        """Number of stacked kernel rows (one per (host, tenant) pair)."""
        return self.starts.shape[0]


# the stacked fields and the never-matching fill of each one's padding
_SMAX = int(np.iinfo(np.int32).max)
_STACKED = (("starts", _SMAX), ("ends", _SMAX), ("permbits", 0),
            ("tile_min", int(EMPTY_START)), ("tile_max", int(_NO_END)))


def stack_views(views: "list[ShardView]", hwpids, host_ids,
                *, epoch: int) -> FabricView:
    """Pad per-host ShardViews to a common entry count and stack them into
    one FabricView, one `torch.stack` a field, in new storage (same
    never-matching sentinels as `_pad_shard`: INT32_MAX entry bounds,
    empty-tile summaries).  Only the views shorter than the common count
    are padded first."""
    rows = dict(zip(views[0]._fields, zip(*views)))   # field -> row tensors
    # each row's entry and tile counts, read once for all five fields
    counts = {k: [a.shape[0] for a in rows[k]] for k in ("starts", "tile_min")}

    def stack(field: str, fill: int) -> torch.Tensor:
        ns = counts["tile_min" if field.startswith("tile") else "starts"]
        n, col = max(ns), rows[field]
        if min(ns) < n:
            col = [a if m == n else F.pad(a, (0, n - m), value=fill)
                   for a, m in zip(col, ns)]
        return torch.stack(col)

    return FabricView(
        **{field: stack(field, fill) for field, fill in _STACKED},
        hwpids=torch.as_tensor(list(hwpids), dtype=torch.int32,
                               device=views[0].starts.device),
        host_ids=tuple(host_ids),
        epoch=epoch,
    )


class ShardedFabric:
    """A full deployment: one FM + N `HostRuntime`s over a page-sharded SDM.

    The fabric partitions the SDM page space into `n_shards` equal ranges
    (shard `h` -> host `h`), allocates tenant page spans inside their host's
    shard, and drives cross-host batched egress through the stacked CUDA
    kernel.  BISnp delivery runs through the FM's async bus: call
    `deliver()`/`quiesce()` to advance host observation, or let the bounded
    lag force it.
    """

    def __init__(self, sdm_pages: int, table_capacity: int, n_shards: int,
                 *, max_bisnp_lag: int | None = 64,
                 perm_cache_bytes: int = PERM_CACHE_BYTES, clock=None,
                 device=None):
        if not (1 <= n_shards <= 255):
            raise ValueError("n_shards must be in [1, 255] (paper abstract)")
        self.device = resolve_device(device)
        self.fm = FabricManager(sdm_pages, table_capacity,
                                max_bisnp_lag=max_bisnp_lag, clock=clock)
        self.n_shards = n_shards
        self.perm_cache_bytes = perm_cache_bytes
        self.runtimes: dict[int, HostRuntime] = {}
        self._alloc_cursor: dict[int, int] = {}
        # per-host free list: sorted by start page, adjacent spans merged on
        # insert (`_release_span`) — never append raw tuples directly
        self._free_spans: dict[int, list[tuple[int, int]]] = {}
        self._grants: dict[int, tuple[int, int, int]] = {}
        # hwpid -> [(host_id, start, n)] shared regions pinned resident by
        # grant_shared, released on evict
        self._shared_grants: dict[int, list[tuple[int, int, int]]] = {}
        # evict runs one vacuum() commit when tombstones exceed this
        # fraction of table capacity (None disables)
        self.vacuum_tombstone_frac: float | None = 0.25
        self.vacuums = 0
        self._fabric_view: FabricView | None = None
        self._fabric_view_key = None
        self.view_rebuilds = 0
        self.view_reuses = 0
        # timing-trace recorder (memsim.replay.FabricTrace); set by
        # begin_trace(), consumed by end_trace() — None = not recording
        self._trace = None
        # heartbeat crash detector (enable_host_monitor); None = off
        self.host_monitor = None

    # -- topology ------------------------------------------------------------
    def shard_range(self, host_id: int) -> tuple[int, int]:
        """Page range [lo, hi) of shard `host_id` (contiguous partition)."""
        if not (0 <= host_id < self.n_shards):
            raise ValueError(f"host {host_id} outside [0, {self.n_shards})")
        per = -(-self.fm.sdm_pages // self.n_shards)
        lo = host_id * per
        return lo, min(lo + per, self.fm.sdm_pages)

    def enroll(self, host_id: int, *, n_cores: int = 8) -> HostRuntime:
        """Enroll one host: FM key derivation + a HostRuntime resident for
        shard `host_id`, attached to the BISnp bus."""
        self.fm.enroll_host(host_id, n_cores)
        lo, hi = self.shard_range(host_id)
        rt = HostRuntime(self, host_id, lo, hi,
                         perm_cache_bytes=self.perm_cache_bytes)
        self.runtimes[host_id] = rt
        self._alloc_cursor[host_id] = lo
        self._free_spans[host_id] = []
        return rt

    # -- tenancy -------------------------------------------------------------
    def assign_hwpid(self, host_id: int) -> int:
        """Hand out a deployment-unique HWPID on `host_id` and mark it
        trusted there (callers then attach grants via `fm.propose` /
        `grant_shared`)."""
        rt = self.runtimes[host_id]
        hwpid = rt.engine.get_next_pid()
        rt._grant_installed(hwpid)
        return hwpid

    def admit(self, host_id: int, n_pages: int, *, perm: int = PERM_RW,
              base_p: int | None = None) -> tuple[int, int]:
        """Admit one process on `host_id`: allocate a page span inside the
        host's shard, assign a deployment-unique HWPID, and commit the grant
        (one epoch bump, one BISnp publish).  Returns (hwpid, start_page)."""
        rt = self.runtimes[host_id]
        start = self._alloc_span(host_id, n_pages)
        hwpid = self.assign_hwpid(host_id)
        label = self.fm.propose(Proposal(
            host_id, hwpid, base_p if base_p is not None else 0x1000 + hwpid,
            start, n_pages, perm))
        if label is None:
            rt.engine.release_pid(hwpid)
            rt._grant_released(hwpid)
            self._release_span(host_id, start, n_pages)
            raise RuntimeError(f"FM rejected grant for host {host_id}")
        self._grants[hwpid] = (host_id, start, n_pages)
        return hwpid, start

    def _alloc_span(self, host_id: int, n_pages: int) -> int:
        """First-fit from the host's free list (evicted tenants' spans),
        falling back to the bump cursor; splits oversized free spans."""
        free = self._free_spans[host_id]
        for i, (s, n) in enumerate(free):
            if n >= n_pages:
                if n > n_pages:
                    free[i] = (s + n_pages, n - n_pages)
                else:
                    free.pop(i)
                return s
        rt = self.runtimes[host_id]
        cur = self._alloc_cursor[host_id]
        if cur + n_pages > rt.page_hi:
            raise RuntimeError(
                f"host {host_id} shard [{rt.page_lo},{rt.page_hi}) exhausted")
        self._alloc_cursor[host_id] = cur + n_pages
        return cur

    def _release_span(self, host_id: int, start: int, n_pages: int) -> None:
        """Return a span to the host's free list: kept sorted by start page,
        merged with adjacent spans, and — when the topmost free span runs up
        against the bump cursor — retracted back into the cursor."""
        free = self._free_spans[host_id]
        free.append((start, n_pages))
        free.sort()
        merged: list[tuple[int, int]] = []
        for s, n in free:
            if merged and merged[-1][0] + merged[-1][1] == s:
                merged[-1] = (merged[-1][0], merged[-1][1] + n)
            else:
                merged.append((s, n))
        while merged and \
                merged[-1][0] + merged[-1][1] == self._alloc_cursor[host_id]:
            self._alloc_cursor[host_id] = merged.pop()[0]
        self._free_spans[host_id] = merged

    def free_pages(self, host_id: int) -> int:
        """Total unallocated pages in the host's shard (free list plus the
        untouched tail above the bump cursor)."""
        rt = self.runtimes[host_id]
        return (rt.page_hi - self._alloc_cursor[host_id]
                + sum(n for _, n in self._free_spans[host_id]))

    def evict(self, host_id: int, hwpid: int) -> None:
        """Revoke every grant of `hwpid`, return it to the deployment pool
        (one commit / one publish; index-stable tombstones), recycle its
        page span, and release any shared ranges it pinned resident.  When
        tombstones exceed `vacuum_tombstone_frac` of table capacity, runs
        one `vacuum()` maintenance commit."""
        rt = self.runtimes[host_id]
        self.fm.revoke_hwpid(hwpid)
        rt.engine.release_pid(hwpid)
        rt._grant_released(hwpid)
        span = self._grants.pop(hwpid, None)
        if span is not None:
            self._release_span(span[0], span[1], span[2])
        for sh_host, start, n in self._shared_grants.pop(hwpid, ()):
            self.runtimes[sh_host].remove_resident_range(start, n)
        frac = self.vacuum_tombstone_frac
        if frac is not None and \
                self.fm.tombstone_count() > frac * self.fm.table.capacity:
            self.fm.vacuum()
            self.vacuums += 1

    def grant_shared(self, start_page: int, n_pages: int, hwpid: int,
                     host_id: int, *, perm: int) -> None:
        """Grant one tenant access to a shared region and make that region
        resident on its host's checker (released on `evict`)."""
        label = self.fm.propose(Proposal(
            host_id, hwpid, 0x2000 + hwpid, start_page, n_pages, perm))
        if label is None:
            raise RuntimeError("FM rejected shared grant")
        self.runtimes[host_id].add_resident_range(start_page, n_pages)
        self._shared_grants.setdefault(hwpid, []).append(
            (host_id, start_page, n_pages))

    # -- BISnp observation ---------------------------------------------------
    def deliver(self, host_id: int, max_events: int | None = None) -> int:
        """Consume up to `max_events` queued BISnp events at one host."""
        return self.fm.bus.deliver(host_id, max_events)

    def quiesce(self) -> int:
        """Deliver every queued BISnp at every host (fabric barrier)."""
        return self.fm.bus.quiesce()

    # -- faults, crash, rejoin -----------------------------------------------
    def inject_faults(self, plan) -> "object":
        """Wire a `core.faults.FaultPlan` into every fault point this
        deployment owns: the bus (message drop/dup/reorder/delay), the FM
        (scheduled crash between journal append and broadcast), and — in
        clocked mode — the per-host downlinks (degradation/outages).
        Returns the plan for chaining."""
        self.fm.bus.faults = plan
        self.fm.faults = plan
        if self.fm.bus.clock is not None:
            plan.apply_link_faults(self.fm.bus.clock)
        return plan

    def crash_host(self, host_id: int) -> None:
        """Fail-stop one host: detach it from the bus (its queued events
        die with it) and brick its runtime (`check()` raises until
        `rejoin_host`).  Its table entries survive: grants belong to the
        FM, not the host."""
        rt = self.runtimes[host_id]
        if rt.crashed:
            raise ValueError(f"host {host_id} already crashed")
        rt.crashed = True
        self.fm.bus.detach(host_id)
        if self.host_monitor is not None:
            self.host_monitor.forget(host_id)

    def rejoin_host(self, host_id: int) -> None:
        """Bring a crashed host back cold: fresh PermCache fenced at the
        live epoch, expected sequence fast-forwarded, desync/quarantine
        cleared, every derived-view memo dropped, bus re-attached."""
        rt = self.runtimes[host_id]
        if not rt.crashed:
            raise ValueError(f"host {host_id} is not crashed")
        rt.rejoin(self.fm.epoch, self.fm.bus._next_seq)
        self.fm.bus.attach(host_id, rt.on_bisnp)
        if self.host_monitor is not None:
            self.host_monitor.beat(host_id)

    def enable_host_monitor(self, *, timeout: float, clock=None):
        """Attach a heartbeat-based crash detector (the `FailureDetector`
        of `runtime.fault_tolerance`, deterministic under an injected
        clock): every delivered BISnp and every `check()` beat the host's
        entry; `dead_hosts()` lists hosts silent for longer than
        `timeout`.  Returns the detector."""
        from ..runtime.fault_tolerance import FailureDetector
        self.host_monitor = FailureDetector(timeout=timeout, clock=clock)
        for h in self.runtimes:
            self.host_monitor.beat(h)
        return self.host_monitor

    def dead_hosts(self) -> list[int]:
        """Hosts the heartbeat monitor considers crashed (empty when no
        monitor is attached — call `enable_host_monitor` first)."""
        if self.host_monitor is None:
            return []
        return self.host_monitor.dead()

    # -- batched cross-host egress -------------------------------------------
    def fabric_rows(self, hwpid_by_host: dict) -> list[tuple[int, int]]:
        """Flatten a tenant assignment — ``{host: hwpid}`` or
        ``{host: [hwpids...]}`` — into the kernel row order: hosts sorted
        ascending, each host's tenants in listed order, one row per
        (host, tenant) pair."""
        rows: list[tuple[int, int]] = []
        for h in sorted(hwpid_by_host):
            pids = hwpid_by_host[h]
            if isinstance(pids, (int, np.integer)):
                rows.append((h, int(pids)))
            else:
                rows.extend((h, int(p)) for p in pids)
        return rows

    def fabric_view(self, hwpid_by_host: dict) -> FabricView:
        """Stacked egress operands for a (possibly multi-tenant) assignment,
        memoized per (table epoch, row list) — steady-state steps pay zero
        derivation, and any commit re-resolves once: it builds only the
        views of hosts whose shard changed and stacks every row afresh, so
        a view handed out earlier is never written again."""
        rows = self.fabric_rows(hwpid_by_host)
        key = (self.fm.table.epoch, tuple(rows))
        if self._fabric_view is not None and self._fabric_view_key == key:
            self.view_reuses += 1
            return self._fabric_view
        with tracing.span("fabric.view_rebuild"):
            # every distinct host to the current epoch first, so that the
            # views below only build
            with tracing.span("fabric.shard_extract"):
                for h in dict.fromkeys(h for h, _ in rows):
                    self.runtimes[h]._resident_entries()
            with tracing.span("fabric.shard_views"):
                views = [self.runtimes[h].shard_view(p) for h, p in rows]
            with tracing.span("fabric.stack_views"):
                self._fabric_view = stack_views(
                    views, [p for _, p in rows], [h for h, _ in rows],
                    epoch=self.fm.table.epoch)
        self._fabric_view_key = key
        self.view_rebuilds += 1
        return self._fabric_view

    def _drop_fabric_view(self) -> None:
        """Drop the stacked view's memo: the next `fabric_view` re-resolves
        even at the same epoch."""
        self._fabric_view = None
        self._fabric_view_key = None

    def step_egress(self, data, ext_addrs, hwpid_by_host: dict,
                    *, need: int = 1, key0: int = 0xAB, key1: int = 0xCD):
        """One fabric step: every (host, tenant) row pulls its (B,) batch of
        tagged words through the fused check⊕decrypt kernel in ONE launch.

        `data` u32[R, B] (numpy ``uint32`` or an int32 tensor of the same
        bits) / `ext_addrs` i32[R, B] are row-aligned with
        `fabric_rows(hwpid_by_host)`.  Returns (out i32[R, B] u32 bits,
        fault i32[R, B]) on the fabric's device.  While a trace records,
        the step's pages are taken from `ext_addrs` on the host: numpy
        input as it is, a tensor through one copy to the CPU.
        """
        from ..kernels.fabric_egress import fabric_egress
        view = self.fabric_view(hwpid_by_host)
        if self._trace is not None:
            from .table import PAGE_MASK
            host_ext = ext_addrs.cpu().numpy() \
                if isinstance(ext_addrs, torch.Tensor) else ext_addrs
            pages = np.asarray(host_ext, np.int64) & PAGE_MASK
            self._trace.record_egress(self.fabric_rows(hwpid_by_host), pages,
                                      epoch=self.fm.epoch)
        return fabric_egress(as_int32(data, self.device),
                             as_int32(ext_addrs, self.device), view, need=need,
                             key0=key0, key1=key1)

    # -- timing-trace recording ---------------------------------------------
    def begin_trace(self, *, label: str = ""):
        """Start recording a fabric timing trace (commit fan-outs via the
        bus tap + egress page streams from `step_egress`).  Returns the
        `memsim.replay.FabricTrace`; feed it to `end_trace()` when done,
        then replay it through the clocked cost model."""
        from ..memsim.replay import FabricTrace
        if self._trace is not None:
            raise RuntimeError("a trace is already recording")
        tr = FabricTrace(label=label)
        self._trace = tr
        self.fm.bus.tap = lambda ev, n_hosts: tr.record_commit(
            ev.epoch, n_hosts)
        return tr

    def end_trace(self):
        """Stop recording, finalize the trace (derive per-row PermCache
        miss profiles from the recorded page streams), and return it."""
        tr = self._trace
        if tr is None:
            raise RuntimeError("no trace is recording")
        self._trace = None
        self.fm.bus.tap = None
        tr.finalize(perm_cache_bytes=self.perm_cache_bytes)
        return tr

    # -- accounting ----------------------------------------------------------
    def storage_overhead(self) -> dict:
        """Measured + worst-case metadata fractions (paper §7.2 / Eq. 3-4:
        64 B/entry; worst case one entry per 4 KiB page = 1.5625 %)."""
        used = int(self.fm.table.n) * 64
        total = self.fm.sdm_pages * 4096
        return {
            "entries": int(self.fm.table.n),
            "metadata_bytes": used,
            "measured_fraction": used / total,
            "worst_case_fraction": self.fm.storage_overhead_fraction(),
        }

    def stats(self) -> dict:
        """Deployment-wide counters (bus delivery, back-invalidates held
        for a later read and folded passes, shard rebuilds/sizes,
        `ShardView` builds and views carried to a new epoch unbuilt, summed
        over hosts) — read-only: never forces a shard extraction, view
        rebuild or fold."""
        bus = self.fm.bus
        rts = self.runtimes.values()
        return {
            "hosts": len(self.runtimes),
            "epoch": self.fm.epoch,
            "bus": {"published": bus.published, "delivered": bus.delivered,
                    "forced": bus.forced_deliveries,
                    "max_lag": bus.max_observed_lag(),
                    "errors": len(bus.errors),
                    "error_count": bus.error_count},
            "faults": {
                "desynced": sum(rt.desynced for rt in rts),
                "quarantined": sum(rt.quarantined for rt in rts),
                "crashed": sum(rt.crashed for rt in rts),
                "desync_events": sum(rt.desync_events for rt in rts),
                "self_heals": sum(rt.self_heals for rt in rts),
                "resyncs": sum(rt.resyncs for rt in rts),
                "snapshot_resyncs": sum(rt.snapshot_resyncs for rt in rts),
                "denied_desync": sum(rt.denied_desync for rt in rts),
                "fm_restarts": self.fm.restarts},
            "bisnp": {"deferred": sum(rt.bisnp_deferred for rt in rts),
                      "flushes": sum(rt.bisnp_flushes for rt in rts)},
            "shard_rebuilds": {h: rt.shard_rebuilds
                               for h, rt in self.runtimes.items()},
            "view_builds": sum(rt.views.rebuilds for rt in rts),
            "views_kept": sum(rt.views.kept for rt in rts),
            "shard_entries": {
                h: (rt._shard[0].shape[0] if rt._shard is not None else -1)
                for h, rt in self.runtimes.items()},
        }
