"""Permission checker (paper §4.2.3), PyTorch side.

On-chip unit placed after the LLC.  Every LD/ST of a trusted process carries
A-bits (HWPID) tagged into the extended physical address.  The checker:

  1. verifies the A-bits against HWPID_local (per-host trusted bit-vector),
  2. binary-searches the sorted permission table for the address's entry,
  3. extracts the 2-bit permission for (HWPID) and enforces R/W,
  4. raises a fault code on violation (paper: interrupt on access violation).

This is the framework's *functional* checker in plain tensor code (the JAX
package computes it in XLA, not in a kernel); the CUDA kernels in
``repro_torch.kernels`` are the egress hot path.  Decisions the reference
takes with ``lax.cond`` on device scalars are taken here on host values the
runtime already holds (table size and epoch) or, for the all-hit fast path,
with one read-back of the batch's hit mask.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..kernels import resolve_device
from .table import EMPTY_START, PermissionTable, extract_perm, unpack_ext_addr

# Fault codes
FAULT_NONE = 0
FAULT_NO_ABITS = 1        # untagged access to SDM (untrusted process)
FAULT_NOT_LOCAL = 2       # HWPID not in HWPID_local (wrong host / revoked)
FAULT_NO_ENTRY = 3        # no permission entry covers the address
FAULT_PERM = 4            # entry found but R/W bits deny the access
FAULT_DESYNC = 5          # host lost BISnp events — fail closed until resync

_INT32_MAX = int(np.iinfo(np.int32).max)


class CheckResult(NamedTuple):
    """Per-access verdicts of one permission-check batch (B accesses)."""
    allowed: torch.Tensor      # bool[B]
    fault: torch.Tensor        # i32[B] fault codes
    entry_idx: torch.Tensor    # i32[B] matched entry (-1 if none)
    probes: torch.Tensor       # i32[B] binary-search probe count


def desync_check_result(n_accesses: int, *, device=None) -> CheckResult:
    """The fail-closed verdict: deny every access with `FAULT_DESYNC`.

    A host that detected a BISnp sequence gap (or sits in quarantine) can
    no longer trust ANY cached or freshly-derived grant, so its checker
    answers this instead of consulting the table at all."""
    dev = resolve_device(device)
    return CheckResult(
        allowed=torch.zeros((n_accesses,), dtype=torch.bool, device=dev),
        fault=torch.full((n_accesses,), FAULT_DESYNC, dtype=torch.int32,
                         device=dev),
        entry_idx=torch.full((n_accesses,), -1, dtype=torch.int32,
                             device=dev),
        probes=torch.zeros((n_accesses,), dtype=torch.int32, device=dev))


def binary_search(starts: torch.Tensor, n: int, pages: torch.Tensor):
    """Textbook binary search with early-exit accounting.

    Returns (idx, probes): idx = index of last entry with start <= page
    (-1 if none); probes = table entries touched, the paper's
    'binary-search occupancy' metric (Fig. 9).  Runs a fixed
    ceil(log2(cap))+1 iteration loop while counting only the iterations a
    sequential searcher would have executed.  Tables with at most one live
    entry short-circuit to a single compare."""
    cap = starts.shape[0]
    steps = int(np.ceil(np.log2(max(cap, 2)))) + 1
    pages = pages.to(torch.int32)
    if n <= 1:
        has = (n >= 1) & (starts[0] <= pages)
        return (torch.where(has, 0, -1).to(torch.int32),
                torch.full_like(pages, int(n >= 1)))
    lo = torch.zeros_like(pages)
    hi = torch.full_like(pages, n - 1)
    idx = torch.full_like(pages, -1)
    probes = torch.zeros_like(pages)
    for _ in range(steps):
        active = lo <= hi
        mid = torch.div(lo + hi, 2, rounding_mode="floor")
        s = starts[torch.clamp(mid, 0, cap - 1).long()]
        probes = probes + active.to(torch.int32)
        go_right = s <= pages
        idx = torch.where(active & go_right, mid, idx)
        lo = torch.where(active & go_right, mid + 1, lo)
        hi = torch.where(active & ~go_right, mid - 1, hi)
    return idx, probes


def check_access(table: PermissionTable, hwpid_local: torch.Tensor,
                 ext_addrs, is_write) -> CheckResult:
    """Vectorized permission check for a batch of tagged accesses."""
    hwpid, page = unpack_ext_addr(_on(ext_addrs, table.starts.device))
    is_write = _on(is_write, table.starts.device).to(torch.bool)
    idx, probes = binary_search(table.starts, table.n, page)
    return _finalize(table, hwpid_local, hwpid, page, is_write, idx, probes)


def make_hwpid_local(hwpids, *, device=None) -> torch.Tensor:
    """Build the per-host trusted HWPID bit-vector (i32[4], u32 bits)."""
    v = np.zeros((4,), np.uint32)
    for h in hwpids:
        v[h // 32] |= np.uint32(1) << np.uint32(h % 32)
    return torch.as_tensor(v.view(np.int32), device=resolve_device(device))


def _on(x, device) -> torch.Tensor:
    return torch.as_tensor(x, device=device)


# ---------------------------------------------------------------------------
# Vectorized permission cache (paper §4.2.3: 16 KiB cache in the checker)
# ---------------------------------------------------------------------------
# An N-way set-associative map page -> matched entry index (default 4-way x
# 64 sets within the 16 KiB budget) with tree-PLRU replacement, held as
# plain tensors.  The cache is EPOCH-FENCED against the table it mirrors
# (paper §4.1.3/§7.1.7): when `cache.epoch == table.epoch` the BISnp
# protocol guarantees every surviving mapping is current, so probe hits skip
# live-table revalidation; when the epochs diverge every hit is revalidated
# against the live table and a stale mapping degrades to a miss.  When EVERY
# lane of a batch hits, the binary search and the PLRU update are skipped.

PERM_CACHE_BYTES = 16 * 1024    # paper default: 16 KiB
CACHE_ENTRY_BYTES = 64          # one 64 B table entry per cache slot
PERM_CACHE_WAYS = 4             # default associativity (4-way x 64 sets)


class PermCache(NamedTuple):
    """Set-associative (page -> table entry) cache with tree-PLRU
    replacement and an epoch fence."""
    tag: torch.Tensor      # i32[n_sets, n_ways] cached page (-1 invalid)
    entry: torch.Tensor    # i32[n_sets, n_ways] table entry index matched
    plru: torch.Tensor     # i32[n_sets] tree-PLRU bits (low n_ways-1 used)
    hits: torch.Tensor     # i64[] cumulative probe hits
    misses: torch.Tensor   # i64[] cumulative probe misses
    epoch: int             # table epoch the surviving mappings are valid at

    @property
    def n_sets(self) -> int:
        """Number of sets (pages index by ``page % n_sets``)."""
        return self.tag.shape[0]

    @property
    def n_ways(self) -> int:
        """Associativity (lines per set)."""
        return self.tag.shape[1]

    @property
    def capacity_bytes(self) -> int:
        """Total capacity at 64 B per cached entry."""
        return self.n_sets * self.n_ways * CACHE_ENTRY_BYTES

    @property
    def hit_rate(self) -> float:
        """Lifetime probe hit fraction (0.0 before any probe)."""
        t = int(self.hits) + int(self.misses)
        return int(self.hits) / t if t else 0.0


def plru_victim(bits, n_ways: int):
    """Tree-PLRU victim way for each set's bit word (vectorized).

    The tree is stored breadth-first in the low ``n_ways - 1`` bits: node 0
    is the root, node ``i``'s children are ``2i+1`` / ``2i+2``, and a bit is
    the direction the next victim walk takes (0 left, 1 right)."""
    bits = torch.as_tensor(bits)
    node = torch.zeros(bits.shape, dtype=torch.int32, device=bits.device)
    for _ in range(max(n_ways.bit_length() - 1, 0)):
        d = (bits >> node) & 1
        node = 2 * node + 1 + d
    return (node - (n_ways - 1)).to(torch.int32)


def plru_touch(bits, way, n_ways: int):
    """Repoint the PLRU tree away from ``way`` (MRU protection): every node
    on the accessed way's root-to-leaf path is set to the *opposite*
    direction.  Vectorized over matching ``bits``/``way`` shapes."""
    bits = torch.as_tensor(bits)
    way = torch.as_tensor(way, device=bits.device)
    levels = max(n_ways.bit_length() - 1, 0)
    node = torch.zeros(way.shape, dtype=torch.int32, device=bits.device)
    for lvl in range(levels):
        d = (way >> (levels - 1 - lvl)) & 1
        mask = torch.ones_like(node) << node
        bits = torch.where(d == 1, bits & ~mask, bits | mask)
        node = 2 * node + 1 + d
    return bits.to(torch.int32)


def make_perm_cache(capacity_bytes: int = PERM_CACHE_BYTES, *,
                    epoch: int = 0, ways: int = PERM_CACHE_WAYS,
                    device=None) -> PermCache:
    """Fresh (all-invalid) set-associative cache.  The 16 KiB default holds
    256 entries as 64 sets x 4 ways; ``ways=1`` gives the direct-mapped
    layout.  Pass ``epoch=table.epoch`` and apply the FM's BISnp events
    (each with `invalidate_perm_cache`, or those held since the last read
    with `fold_perm_cache_invalidations`, as `fabric.HostRuntime` does) to
    enable the fenced fast path."""
    if ways < 1 or ways & (ways - 1):
        raise ValueError("perm cache ways must be a power of two")
    if capacity_bytes % (CACHE_ENTRY_BYTES * ways):
        raise ValueError(
            "capacity must be a multiple of 64 B entries x ways")
    n_sets = capacity_bytes // (CACHE_ENTRY_BYTES * ways)
    if n_sets & (n_sets - 1):
        raise ValueError("perm cache set count must be a power of two")
    dev = resolve_device(device)
    return PermCache(
        tag=torch.full((n_sets, ways), -1, dtype=torch.int32, device=dev),
        entry=torch.full((n_sets, ways), -1, dtype=torch.int32, device=dev),
        plru=torch.zeros((n_sets,), dtype=torch.int32, device=dev),
        hits=torch.zeros((), dtype=torch.int64, device=dev),
        misses=torch.zeros((), dtype=torch.int64, device=dev),
        epoch=int(epoch),
    )


def invalidate_perm_cache(cache: PermCache, start_page, n_pages, epoch, *,
                          min_shifted_entry: int | None = None) -> PermCache:
    """Apply one FM BISnp back-invalidate to the cache (targeted): drop
    mappings whose page falls in ``[start_page, start_page + n_pages)`` and
    — when the commit shifted entry indices — mappings whose cached index is
    ``>= min_shifted_entry``.

    Epoch fencing rules:
      * ``epoch == cache.epoch + 1`` — the expected next event: targeted
        drop, fence advances.
      * ``epoch <= cache.epoch`` — duplicate/replayed event: targeted drop,
        fence unchanged.
      * ``epoch > cache.epoch + 1`` — an event was missed: every mapping is
        dropped and the fence jumps forward.
    """
    if min_shifted_entry is None:
        min_shifted_entry = _INT32_MAX
    start, n, ev_epoch = int(start_page), int(n_pages), int(epoch)
    end = (start + n + (1 << 31)) % (1 << 32) - (1 << 31)   # int32 wrap
    drop = (cache.tag >= start) & (cache.tag < end)
    drop = drop | (cache.entry >= int(min_shifted_entry))
    if ev_epoch > cache.epoch + 1:
        drop = torch.ones_like(drop)
    return cache._replace(
        tag=torch.where(drop, -1, cache.tag),
        entry=torch.where(drop, -1, cache.entry),
        epoch=max(cache.epoch, ev_epoch),
    )


def fold_perm_cache_invalidations(cache: PermCache, events) -> PermCache:
    """`invalidate_perm_cache` applied once per event of ``events``, in
    order, as one pass over the cache.  An event is a tuple
    ``(start_page, n_pages, epoch, min_shifted_entry)``, the last None
    where the commit shifted no index.

    A drop is idempotent and nothing refills a line between the events, so
    a line ends dropped exactly when some event's drop mask holds for it in
    the cache as given: its page in the union of the events' ranges, its
    index at or above the least threshold, or any line at all where an
    event jumped the running fence by more than one epoch.  The fence
    arithmetic runs on the host; the device runs the same few operations
    whatever the number of events.  ``plru``, ``hits`` and ``misses`` are
    left as they are."""
    if not events:
        return cache
    epoch, jumped, lowest, bounds = cache.epoch, False, _INT32_MAX, []
    for start, n, ev_epoch, shifted in events:
        start, ev_epoch = int(start), int(ev_epoch)
        jumped = jumped or ev_epoch > epoch + 1
        epoch = max(epoch, ev_epoch)
        if shifted is not None:
            lowest = min(lowest, int(shifted))
        end = (start + int(n) + (1 << 31)) % (1 << 32) - (1 << 31)
        if start < end:                  # else the range holds no page
            bounds.append((start, end))
    if jumped:
        return cache._replace(tag=torch.full_like(cache.tag, -1),
                              entry=torch.full_like(cache.entry, -1),
                              epoch=epoch)
    drop = cache.entry >= lowest
    if bounds:
        b = torch.tensor(bounds, dtype=torch.int64, device=cache.tag.device)
        tag = cache.tag[..., None]
        drop = drop | ((tag >= b[:, 0]) & (tag < b[:, 1])).any(dim=-1)
    return cache._replace(
        tag=torch.where(drop, -1, cache.tag),
        entry=torch.where(drop, -1, cache.entry),
        epoch=epoch,
    )


def _finalize(table, hwpid_local, hwpid, page, is_write, idx, probes):
    """Steps 1+3+4 of the checker, shared by the cached and uncached paths."""
    has_abits = hwpid > 0
    word = hwpid_local[torch.clamp(
        torch.div(hwpid, 32, rounding_mode="floor"), 0, 3).long()]
    local_ok = ((word >> torch.remainder(hwpid, 32)) & 1).to(torch.bool)

    safe_idx = torch.clamp(idx, 0, table.capacity - 1).long()
    s = table.starts[safe_idx]
    sz = table.sizes[safe_idx]
    in_range = (idx >= 0) & (page >= s) & (page < s + sz) & \
        (s != int(EMPTY_START))

    perm = extract_perm(table.perms[safe_idx], hwpid)
    need = torch.where(is_write, 2, 1)
    perm_ok = (perm & need) == need

    allowed = has_abits & local_ok & in_range & perm_ok
    fault = torch.where(
        ~has_abits, FAULT_NO_ABITS,
        torch.where(~local_ok, FAULT_NOT_LOCAL,
                    torch.where(~in_range, FAULT_NO_ENTRY,
                                torch.where(~perm_ok, FAULT_PERM,
                                            FAULT_NONE))))
    fault = torch.where(allowed, FAULT_NONE, fault).to(torch.int32)
    return CheckResult(allowed, fault,
                       torch.where(in_range, idx, -1).to(torch.int32),
                       probes.to(torch.int32))


def _last_lane_wins(slot: torch.Tensor, n_slots: int) -> torch.Tensor:
    """For a scatter of one value per lane into ``slot`` (i64[B], values in
    [0, n_slots)), the lane whose write survives in each slot — the highest
    lane index, as a sequential SRAM update (and the reference's CPU
    scatter) would leave it; -1 where no lane writes.  A CUDA scatter with
    duplicate indices has no defined order, a max-reduce does."""
    lanes = torch.arange(slot.shape[0], dtype=torch.int64, device=slot.device)
    winner = torch.full((n_slots,), -1, dtype=torch.int64, device=slot.device)
    return winner.scatter_reduce(0, slot, lanes, reduce="amax")


def _scatter_last(dst: torch.Tensor, slot: torch.Tensor,
                  values: torch.Tensor) -> torch.Tensor:
    """``dst.flatten()[slot[i]] = values[i]`` for every lane i, the highest
    lane winning each duplicated slot; returns a new tensor."""
    flat = dst.reshape(-1).clone()
    winner = _last_lane_wins(slot, flat.shape[0])
    hit = winner >= 0
    flat[hit] = values[winner[hit]].to(flat.dtype)
    return flat.reshape(dst.shape)


def cached_check_access(table: PermissionTable, hwpid_local: torch.Tensor,
                        ext_addrs, is_write,
                        cache: PermCache) -> tuple[CheckResult, PermCache]:
    """`check_access` with the set-associative permission-cache fast path.

    Semantically identical to `check_access` (same CheckResult fields except
    `probes`, which is 0 on cache-hit lanes); additionally returns the
    updated cache.  Thread the returned cache into the next call, and apply
    every FM BISnp event to it before that call to keep the epoch fence
    closed: each with `invalidate_perm_cache`, or the ones held since the
    last call in one `fold_perm_cache_invalidations` pass, as a fabric
    host does at its cache's next read (`fabric.HostRuntime.permcache`).
    """
    dev = table.starts.device
    hwpid, page = unpack_ext_addr(_on(ext_addrs, dev))
    is_write = _on(is_write, dev).to(torch.bool)
    n_sets, n_ways = cache.n_sets, cache.n_ways

    # probe: set-indexed on the low page bits, all ways compared at once;
    # inside the epoch fence a hit is trusted, outside it is revalidated
    set_idx = (page & (n_sets - 1)).long()
    ctags = cache.tag[set_idx]                    # (B, ways)
    cents = cache.entry[set_idx]                  # (B, ways)
    way_match = (ctags == page[..., None]) & (cents >= 0)
    probe_ok = way_match.any(dim=-1)
    hit_way = way_match.to(torch.int8).argmax(dim=-1)
    cent = torch.gather(cents, -1, hit_way[..., None])[..., 0]
    if cache.epoch == int(table.epoch):
        hit = probe_ok
    else:
        safe_cent = torch.clamp(cent, 0, table.capacity - 1).long()
        cs = table.starts[safe_cent]
        csz = table.sizes[safe_cent]
        hit = probe_ok & (page >= cs) & (page < cs + csz) & \
            (cs != int(EMPTY_START))

    # fast path: when the whole batch hits, skip the binary search entirely
    all_hit = bool(hit.all())
    if all_hit:
        bs_idx, bs_probes = cent, torch.zeros_like(page)
    else:
        bs_idx, bs_probes = binary_search(table.starts, table.n, page)
    idx = torch.where(hit, cent, bs_idx)
    probes = torch.where(hit, 0, bs_probes)

    result = _finalize(table, hwpid_local, hwpid, page, is_write, idx, probes)

    if all_hit:
        # tags/entries unchanged and the PLRU update skipped too: recency
        # only matters when a refill picks a victim, and an all-hit batch
        # performs none
        new_tag, new_ent, new_plru = cache.tag, cache.entry, cache.plru
    else:
        # refill: install missed lanes that resolved to a live entry,
        # filling an invalid way first and the tree-PLRU victim once the set
        # is full; distinct pages aliasing into one set within the batch fan
        # out across consecutive ways
        bits = cache.plru[set_idx]
        inv = cents < 0
        inv_way = inv.to(torch.int8).argmax(dim=-1).to(torch.int32)
        victim = plru_victim(bits, n_ways)
        base_way = torch.where(inv.any(dim=-1), inv_way, victim)
        found = ~hit & (result.entry_idx >= 0)
        # rank of each lane's page among the distinct filling pages of its
        # set: stable sort on (set, page), count page changes within runs
        key64 = (set_idx << 24) | page.to(torch.int64)
        key32 = torch.remainder(key64 + (1 << 31), 1 << 32) - (1 << 31)
        skey = torch.where(found, key32, _INT32_MAX)
        order = torch.argsort(skey, stable=True)
        sk = skey[order]
        one = torch.ones((1,), dtype=torch.bool, device=dev)
        fresh = torch.cat([one, sk[1:] != sk[:-1]])
        set_run = torch.cat([one, (sk[1:] >> 24) != (sk[:-1] >> 24)])
        distinct = torch.cumsum(fresh.to(torch.int64), 0) - 1
        run_base = torch.cummax(torch.where(set_run, distinct, -1), 0).values
        rank = torch.empty_like(distinct)
        rank[order] = distinct - run_base
        fill_way = torch.remainder(base_way + rank, n_ways)
        way_used = torch.where(hit, hit_way.to(torch.int64), fill_way)
        # slot n_sets * n_ways and up is the drop row for lanes not filling
        n_slots = n_sets * n_ways
        fill_slot = torch.where(found, set_idx * n_ways + fill_way,
                                n_slots + fill_way)
        tag1 = torch.cat([cache.tag, torch.full(
            (1, n_ways), -1, dtype=torch.int32, device=dev)])
        ent1 = torch.cat([cache.entry, torch.full(
            (1, n_ways), -1, dtype=torch.int32, device=dev)])
        new_tag = _scatter_last(tag1, fill_slot, page)[:n_sets]
        new_ent = _scatter_last(ent1, fill_slot, result.entry_idx)[:n_sets]
        new_bits = plru_touch(bits, way_used, n_ways)
        touch_set = torch.where(hit | found, set_idx, n_sets)
        plru1 = torch.cat([cache.plru, torch.zeros(
            (1,), dtype=torch.int32, device=dev)])
        new_plru = _scatter_last(plru1, touch_set, new_bits)[:n_sets]

    n_hits = hit.sum()
    new_cache = PermCache(
        tag=new_tag,
        entry=new_ent,
        plru=new_plru,
        hits=cache.hits + n_hits,
        misses=cache.misses + (page.numel() - n_hits),
        # refills never advance the fence: only BISnp events do
        epoch=cache.epoch,
    )
    return result, new_cache
