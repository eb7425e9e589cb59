"""The Space-Control permission check (paper §4.2.3) as a CUDA kernel.

Per tagged address the kernel answers ``allowed`` (the tag is the tenant's
and the entry covering the page grants ``need``) and ``idx`` (the entry
covering the page, else -1) against one tenant's table shard.  The kernel
itself is ``csrc/permcheck.cu``; this module holds its wrapper, the shard
views it runs on, and the reference's adaptive selector.

The kernel is a per-lane search over the sorted shard: the last live tile
whose first start is at or below the page (from the tile summary), then the
last entry of that tile whose start is (`lane_search_plain` repeats it probe
for probe).  It relies on what every view here holds: live entries sorted
by start, non-overlapping, followed by never-matching INT32_MAX sentinels.

The reference's three modes — "flat" (scan every tile), "hier" (scan the
tiles the summary flags) and "adaptive" (`hier_profitable` picks one per
batch) — change only its cost, never the output.  The wrapper still checks
``mode``, but on CUDA every mode runs the one search.  The fused egress
kernels (``memcrypt.checked_memcrypt_view``, ``fabric_egress``) run the same
search.  `hier_profitable`, `selected_mode`, `grant_sizes` and `pad_batch`
stay as the reference's API, held against it by the parity tests; no CUDA
path runs them.

Layout: addresses i32[B]; entries i32[N] padded to a power-of-two multiple
of ENTRY_TILE with never-matching INT32_MAX sentinels (N <= MAX_ENTRIES).
"""
from __future__ import annotations

from typing import Callable, Hashable, NamedTuple

import numpy as np
import torch

from ..core.table import (PAGE_MASK, SUMMARY_TILE, as_int32,
                          summary_candidate_tiles, tenant_permbits,
                          tile_summary)
from . import bucket_pad, check_cuda_operands, launches, ref, resolve_device
from ._build import launch

ADDR_BLOCK = 1024          # addresses per selector step (the reference's)
ENTRY_TILE = 1024          # table entries per summary tile
MAX_ENTRIES = 65536        # per-shard ceiling
MAX_TILES = MAX_ENTRIES // ENTRY_TILE

# Adaptive selector decision rule: hier only while the mean candidate-tile
# count per step stays below 3/4 of the shard's tiles.
HIER_DENSITY_NUM = 3
HIER_DENSITY_DEN = 4

MODES = ("flat", "hier", "adaptive")      # the reference's; cost only

assert ENTRY_TILE == SUMMARY_TILE, "kernel tile must match table summary tile"


# ---------------------------------------------------------------------------
# Epoch-stamped shard views
# ---------------------------------------------------------------------------
# The kernel operands (padded entry arrays + tile summary + per-tenant
# permbits) are derived data.  A `ShardView` snapshots them together with
# the table epoch they were derived at; `ShardViewCache` memoizes views per
# tenant and re-resolves whenever the FM commits a new epoch.

class ShardView(NamedTuple):
    """Padded, summary-annotated table shard for one tenant at one epoch."""
    starts: torch.Tensor     # i32[padded_n], tail = INT32_MAX sentinels
    ends: torch.Tensor       # i32[padded_n]
    permbits: torch.Tensor   # i32[padded_n] 2-bit field for the tenant
    tile_min: torch.Tensor   # i32[n_tiles]
    tile_max: torch.Tensor   # i32[n_tiles]
    epoch: int = 0

    @property
    def n_tiles(self) -> int:
        return self.tile_min.shape[0]


def _operand_device(x, device) -> torch.device:
    """An explicit ``device`` wins; else a tensor operand's own device; else
    the default (CUDA, or raise)."""
    if device is None and isinstance(x, torch.Tensor):
        return x.device
    return resolve_device(device)


def make_shard_view(starts, ends, permbits, *, epoch: int = 0,
                    device=None) -> ShardView:
    """Pad a raw shard and precompute its tile summary, stamped with the
    table epoch the arrays were read at."""
    dev = _operand_device(starts, device)
    s, e, pb, np_ = _pad_shard(starts, ends, permbits, device=dev)
    tmin, tmax = tile_summary(s, e, tile=ENTRY_TILE, n_tiles=np_ // ENTRY_TILE)
    return ShardView(s, e, pb, tmin, tmax, int(epoch))


def table_shard_view(table, hwpid: int, *,
                     cache: "ShardViewCache | None" = None) -> ShardView:
    """ShardView of a device `PermissionTable` for one tenant; with a
    `ShardViewCache` the padded arrays and summary are reused until the
    table's epoch moves."""
    epoch = int(table.epoch)

    def build() -> ShardView:
        return make_shard_view(table.starts, table.starts + table.sizes,
                               tenant_permbits(table, hwpid), epoch=epoch)

    if cache is None:
        return build()
    return cache.get(hwpid, epoch, build)


class ShardViewCache:
    """Epoch-keyed host-side memo: one ShardView per key (typically the
    tenant HWPID), rebuilt when the epoch moves unless `carry` moved it to
    the new epoch; counters show how much derivation work churn caused.
    ``rebuilds`` counts views built, ``kept`` the first use of each view
    carried to a new epoch (a re-resolution without a build), ``reuses``
    every other hit."""

    def __init__(self):
        self._views: dict[Hashable, ShardView] = {}
        self._carried: set[Hashable] = set()
        self.rebuilds = 0
        self.reuses = 0
        self.kept = 0

    def get(self, key: Hashable, epoch: int,
            build: Callable[[], ShardView]) -> ShardView:
        view = self._views.get(key)
        if view is not None and int(view.epoch) == int(epoch):
            if key in self._carried:
                self._carried.discard(key)
                self.kept += 1
            else:
                self.reuses += 1
            return view
        view = build()
        self._views[key] = view
        self._carried.discard(key)
        self.rebuilds += 1
        return view

    def carry(self, from_epoch: int, to_epoch: int) -> None:
        """Restamp every view derived at ``from_epoch`` to ``to_epoch``, with
        no device operation: the caller found the arrays they were derived
        from unchanged at the new epoch."""
        for key, view in list(self._views.items()):
            if int(view.epoch) == int(from_epoch):
                self._views[key] = view._replace(epoch=int(to_epoch))
                self._carried.add(key)

    def drop(self, key: Hashable) -> None:
        self._views.pop(key, None)
        self._carried.discard(key)


def grant_sizes(starts, ends, permbits, need: int):
    """Per-entry diff-form operands: ``sizes[k] = ends[k] - starts[k]`` and
    ``sizes_ok[k]`` = the same span if entry k grants ``need``, else 0.
    The reference's kernels then test one unsigned compare per entry —
    ``(page - start) as u32 < size`` — because a page below the start wraps
    to a huge unsigned value and a denied entry has a zero window.  Works
    row-wise on stacked [R, N] operands too."""
    sizes = ends - starts
    sizes_ok = torch.where((permbits & need) == need, sizes, 0)
    return sizes.contiguous(), sizes_ok.contiguous()


def hier_profitable(ext_addrs, tile_min, tile_max, *,
                    block: int = ADDR_BLOCK) -> torch.Tensor:
    """Adaptive selector decision as a 0-d bool tensor on the operands'
    device: run the hierarchical search iff the batch's mean candidate-tile
    count per ``block``-lane step stays below 3/4 of the shard's tiles.
    Single-tile shards always pick flat.  ``ext_addrs`` must already be
    padded (with -1) to a multiple of ``block``."""
    n_tiles = tile_min.shape[0]
    if n_tiles <= 1:
        return torch.zeros((), dtype=torch.bool, device=tile_min.device)
    pages = as_int32(ext_addrs, tile_min.device) & PAGE_MASK
    needed = summary_candidate_tiles(pages, tile_min, tile_max, block=block)
    n_steps = needed.shape[0]
    return (HIER_DENSITY_DEN * needed.sum()
            <= HIER_DENSITY_NUM * n_steps * n_tiles)


def pad_batch(ext: torch.Tensor, block: int) -> torch.Tensor:
    """``ext`` padded with -1 lanes to ``bucket_pad(len, block)`` — the
    batch the selector scores (a -1 lane has page 0xFFFFFF)."""
    b = ext.shape[-1]
    out = torch.full((*ext.shape[:-1], bucket_pad(b, block)), -1,
                     dtype=torch.int32, device=ext.device)
    out[..., :b] = ext
    return out


def selected_mode(ext_addrs, view: ShardView, *,
                  block: int = ADDR_BLOCK) -> str:
    """Host-side readout of the adaptive decision for a batch (reads the
    selector back; benchmarks record it next to the timings)."""
    ext = as_int32(ext_addrs, view.tile_min.device).reshape(-1)
    ext = pad_batch(ext, block)
    return "hier" if bool(hier_profitable(
        ext, view.tile_min, view.tile_max, block=block)) else "flat"


def _pad_shard(starts, ends, permbits, *, device):
    """Pad a table shard to a power-of-two multiple of ENTRY_TILE with
    never-matching sentinels; returns (s, e, pb, padded_n)."""
    s = as_int32(starts, device)
    n = s.shape[0]
    np_ = bucket_pad(n, ENTRY_TILE)
    if np_ > MAX_ENTRIES:
        raise ValueError(
            f"table shard has {n} entries > MAX_ENTRIES={MAX_ENTRIES}; "
            "range-partition the table across hosts")
    smax = int(np.iinfo(np.int32).max)
    sp = torch.full((np_,), smax, dtype=torch.int32, device=device)
    ep = torch.full((np_,), smax, dtype=torch.int32, device=device)
    pb = torch.zeros((np_,), dtype=torch.int32, device=device)
    sp[:n] = s
    ep[:n] = as_int32(ends, device)
    pb[:n] = as_int32(permbits, device)
    return sp, ep, pb, np_


def permcheck_view_plain(ext_addrs, view: ShardView, *, hwpid: int,
                         need: int):
    """The plain version of the kernel (any mode): ``ref.permcheck`` on the
    view's arrays.  Returns (allowed bool[B], idx i32[B])."""
    return ref.permcheck(ext_addrs, view.starts, view.ends, view.permbits,
                         hwpid=hwpid, need=need)


def _search_steps(n: int):
    """The power-of-two steps of a binary search over ``n`` entries: the
    largest power of two below ``n``, halved down to 1 (none for n <= 1)."""
    s = 1 << ((n - 1).bit_length() - 1) if n > 1 else 0
    while s:
        yield s
        s >>= 1


def lane_search_plain(pages, starts, tile_min) -> torch.Tensor:
    """The search kernels' two-level probe sequence, step for step
    (``egress::shard_prologue`` + ``egress::lane_search``): for each page
    the last entry whose start is at or below it, else -1.

    Level 1 searches the live tiles' first starts (``tile_min``, INT32_MAX
    for a dead tile) for the last one <= page; level 2 searches that tile's
    starts for the last one <= page, and the entry found is returned only
    if its start is.  A shard with one live tile searches only that tile's
    live entries, as the kernel does from shared memory.  ``starts``
    i32[T * ENTRY_TILE] should meet the kernels' precondition (sorted,
    non-overlapping, sentinel tail); then the result is the only entry that
    can cover the page.  On a shard that breaks it, the result still never
    lies above the page.  Returns i32[B].
    """
    pages = as_int32(pages, starts.device).reshape(-1)
    n_tiles = tile_min.shape[0]
    smax = int(np.iinfo(np.int32).max)
    tmin = torch.full((MAX_TILES,), smax, dtype=torch.int32,
                      device=starts.device)
    tmin[:n_tiles] = as_int32(tile_min, starts.device)
    live_tiles = int((tmin != smax).sum())
    t = torch.zeros_like(pages, dtype=torch.int64)
    for s in _search_steps(live_tiles):
        t = torch.where(tmin[t + s] <= pages, t + s, t)
    n_level2 = ENTRY_TILE
    if live_tiles == 1:
        n_level2 = int((starts[:ENTRY_TILE] != smax).sum())
    e = torch.zeros_like(t)
    for s in _search_steps(n_level2):
        probe = starts[t * ENTRY_TILE + e + s]
        e = torch.where(probe <= pages, e + s, e)
    k = t * ENTRY_TILE + e
    return torch.where(starts[k] <= pages, k, -1).to(torch.int32)


def check_search_layout(starts, ends, permbits, tile_min) -> None:
    """Raise unless the operands have the layout the search kernels index:
    ``starts``, ``ends`` and ``permbits`` of one shape [..., N] and
    ``tile_min`` [..., T] with N = T * ENTRY_TILE and 1 <= T <= MAX_TILES."""
    n_tiles = tile_min.shape[-1]
    if not (starts.shape == ends.shape == permbits.shape) or \
            starts.shape[:-1] != tile_min.shape[:-1] or \
            starts.shape[-1] != n_tiles * ENTRY_TILE or \
            not 1 <= n_tiles <= MAX_TILES:
        raise ValueError(
            f"shard operands starts {tuple(starts.shape)}, ends "
            f"{tuple(ends.shape)}, permbits {tuple(permbits.shape)}, "
            f"tile_min {tuple(tile_min.shape)}: expected N = T x "
            f"{ENTRY_TILE} entries with 1 <= T <= {MAX_TILES} tiles")


def permcheck_view(ext_addrs, view: ShardView, *, hwpid: int, need: int,
                   mode: str = "adaptive"):
    """Permission check of an i32[B] tagged batch over a prepared
    `ShardView`: the CUDA kernel when the view lies on a CUDA device, the
    plain version when it lies on the CPU.  ``mode`` ("adaptive", "hier"
    or "flat", the reference's) is checked but changes nothing here: the
    kernel's search serves every mode.  Returns (allowed bool[B],
    idx i32[B])."""
    if mode not in MODES:
        raise ValueError(f"unknown permcheck mode {mode!r}")
    ext = as_int32(ext_addrs, view.starts.device).reshape(-1).contiguous()
    if view.starts.device.type == "cpu":
        return permcheck_view_plain(ext, view, hwpid=hwpid, need=need)
    check_cuda_operands(ext=ext, starts=view.starts, ends=view.ends,
                        permbits=view.permbits, tile_min=view.tile_min)
    check_search_layout(view.starts, view.ends, view.permbits, view.tile_min)
    b = ext.shape[0]
    allowed = torch.empty(b, dtype=torch.bool, device=ext.device)
    idx = torch.empty(b, dtype=torch.int32, device=ext.device)
    launch("permcheck_launch", ext.data_ptr(), b, view.starts.data_ptr(),
           view.ends.data_ptr(), view.permbits.data_ptr(),
           view.starts.shape[0], view.tile_min.data_ptr(), view.n_tiles,
           int(need), int(hwpid), allowed.data_ptr(), idx.data_ptr(),
           torch.cuda.current_stream(ext.device).cuda_stream)
    launches["permcheck"] += 1
    return allowed, idx


def permcheck(ext_addrs, starts, ends, permbits, *, hwpid: int, need: int,
              mode: str = "adaptive", device=None):
    """Raw-array convenience wrapper: derives a ShardView per call and runs
    `permcheck_view`; epoch-aware callers hold a `ShardViewCache` and use
    the view entry point."""
    return permcheck_view(
        ext_addrs, make_shard_view(starts, ends, permbits, device=device),
        hwpid=hwpid, need=need, mode=mode)
