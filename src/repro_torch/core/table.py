"""Permission table (paper §4.2.2), PyTorch side.

A sorted array of permission entries stored in the SDM.  Each entry covers an
arbitrary page range [start, start + n_pages) and carries 2 permission bits
(R, W) per global HWPID.  Layout is 64 B/entry (paper §7.2):

    start:u32  n_pages:u32  perms: 2b x 128 HWPIDs (32 B)
    owner_host:u8  flags:u8  label_idx:u16  pad -> 64 B

On the device the table is struct-of-arrays so the CUDA checker kernels can
stream ``starts`` through shared memory:

    starts : i32[cap]      (sorted; unused tail = INT32_MAX)
    sizes  : i32[cap]
    perms  : i32[cap, 8]   (128 HWPIDs x 2 bits; u32 words as int32 bits)
    meta   : i32[cap]      (owner_host | flags<<8 | label_idx<<16)
    n      : int           (live entry count, known to the host)

torch has no unsigned 32-bit arithmetic on the CPU, so every u32 word lives
in an int32 tensor with the same bit pattern; only shifts need care, and
``(word >> s) & 3`` is exact for s <= 30 whether the shift is arithmetic or
logical.  The numpy `HostTable` keeps real ``uint32`` arrays.

Addresses are 4 KiB-page granular: ext_addr = hwpid<<24 | page.
"""
from __future__ import annotations

import contextlib
from typing import Iterator, NamedTuple

import numpy as np
import torch

from ..kernels import resolve_device

PAGE_SHIFT = 12          # 4 KiB minimum protection granule (paper §7.2)
PAGE_BYTES = 1 << PAGE_SHIFT
HWPID_BITS = 7           # up to 127 processes (paper §5.2); 0 is reserved
MAX_HWPID = (1 << HWPID_BITS) - 1
HWPID_SHIFT = 24         # A-bits position in the 32-bit extended page address
PAGE_MASK = (1 << HWPID_SHIFT) - 1
ENTRY_BYTES = 64         # paper §7.2
PERM_WORDS = 8           # 128 HWPIDs x 2 bits = 256 bits = 8 x u32
EMPTY_START = np.int32(np.iinfo(np.int32).max)

PERM_NONE = 0
PERM_R = 1
PERM_W = 2
PERM_RW = 3

SUMMARY_TILE = 1024      # entries summarized per tile; must equal the CUDA
                         # kernels' ENTRY_TILE (asserted in kernels.permcheck)
_NO_END = np.int32(np.iinfo(np.int32).min)   # "empty tile" max-end sentinel


def as_int32(x, device=None) -> torch.Tensor:
    """``x`` as an int32 tensor on ``device`` (None: a tensor stays where it
    is, anything else lands on the CPU); numpy ``uint32`` words keep their
    bit patterns."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.int32)
    a = np.asarray(x)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    a = a.astype(np.int32, copy=False)
    if not a.flags.writeable:      # e.g. read back from a JAX array
        a = a.copy()
    return torch.as_tensor(a, device=device)


class PermissionTable(NamedTuple):
    """Device-resident permission table: sorted page-range entries with
    2-bit-per-HWPID permission words (64 B/entry, paper Fig. 2/5)."""
    starts: torch.Tensor   # i32[cap] sorted ascending, tail = EMPTY_START
    sizes: torch.Tensor    # i32[cap]
    perms: torch.Tensor    # i32[cap, PERM_WORDS] (u32 bit patterns)
    meta: torch.Tensor     # i32[cap]
    n: int                 # live count
    epoch: int = 0         # committed table version (see HostTable)

    @property
    def capacity(self) -> int:
        """Allocated entry slots (live entries are the first `n`)."""
        return self.starts.shape[0]

    def nbytes_metadata(self) -> int:
        """Metadata bytes actually consumed (64 B per live entry)."""
        return int(self.n) * ENTRY_BYTES

    def tile_summary(self, *, tile: int = SUMMARY_TILE,
                     n_tiles: int | None = None):
        """(tile_min, tile_max) over this device table — see `tile_summary`."""
        return tile_summary(self.starts, self.starts + self.sizes,
                            tile=tile, n_tiles=n_tiles)


def tile_summary(starts, ends, *, tile: int = SUMMARY_TILE,
                 n_tiles: int | None = None):
    """Per-tile [min start, max end) summary for the two-level checker.

    The sorted table is cut into tiles of ``tile`` consecutive entries; tile t
    is summarized by ``tile_min[t] = min(starts)`` and ``tile_max[t] =
    max(ends)`` over its live entries, so a page can fall inside at most one
    tile's ``[tile_min, tile_max)`` window and a checker only evaluates the
    tiles the summary flags.  Dead entries (``start == EMPTY_START``)
    contribute ``tile_min = EMPTY_START`` and ``tile_max = INT32_MIN``.
    Returns ``(tile_min i32[n_tiles], tile_max i32[n_tiles])`` on the
    device of ``starts`` (numpy input: the CPU).
    """
    s = as_int32(starts)
    e = as_int32(ends, s.device)
    n = s.shape[0]
    if n_tiles is None:
        n_tiles = max(1, -(-n // tile))
    cap = n_tiles * tile
    if cap < n:
        raise ValueError(f"n_tiles={n_tiles} x tile={tile} < {n} entries")
    sp = torch.full((cap,), int(EMPTY_START), dtype=torch.int32,
                    device=s.device)
    ep = torch.full((cap,), int(_NO_END), dtype=torch.int32, device=s.device)
    sp[:n] = s
    ep[:n] = e
    ep = torch.where(sp == int(EMPTY_START), int(_NO_END), ep)
    tile_min = sp.reshape(n_tiles, tile).amin(dim=1)
    tile_max = ep.reshape(n_tiles, tile).amax(dim=1)
    return tile_min, tile_max


def summary_candidate_tiles(pages, tile_min, tile_max, *, block: int):
    """Per-kernel-step candidate-tile counts from an existing tile summary.

    ``pages`` (a flat i32 batch whose length is a multiple of ``block``) is
    cut into ``block``-lane steps; for each step this counts how many
    summary tiles at least one lane's page falls into — the selectivity
    estimate the adaptive flat/hier selector runs on.  Returns i32[n_steps].
    """
    pages = as_int32(pages, tile_min.device)
    n_tiles = tile_min.shape[0]
    cand = (pages[:, None] >= tile_min) & (pages[:, None] < tile_max)
    per_step = cand.reshape(-1, block, n_tiles).any(dim=1)
    return per_step.sum(dim=-1).to(torch.int32)


def make_table(capacity: int, *, device=None) -> PermissionTable:
    """An empty device table with `capacity` entry slots."""
    dev = resolve_device(device)
    return PermissionTable(
        starts=torch.full((capacity,), int(EMPTY_START), dtype=torch.int32,
                          device=dev),
        sizes=torch.zeros((capacity,), dtype=torch.int32, device=dev),
        perms=torch.zeros((capacity, PERM_WORDS), dtype=torch.int32,
                          device=dev),
        meta=torch.zeros((capacity,), dtype=torch.int32, device=dev),
        n=0,
    )


def pack_ext_addr(hwpid, page):
    """Tag the A-bits: ext_addr = hwpid << 24 | page (paper §4.1.2).
    Returns an int32 tensor on the device of ``page`` (numpy: the CPU)."""
    page = as_int32(page)
    hwpid = as_int32(hwpid, page.device)
    return (hwpid << HWPID_SHIFT) | (page & PAGE_MASK)


def unpack_ext_addr(ext):
    """Split tagged extended addresses back into (hwpid, page); the tag
    shift is arithmetic, so a -1 padding lane reads tag -1."""
    ext = as_int32(ext)
    return ext >> HWPID_SHIFT, ext & PAGE_MASK


def perm_words_for(hwpid_to_perm: dict[int, int]) -> np.ndarray:
    """Build the 8-word permission bitfield from {hwpid: PERM_*}."""
    words = np.zeros((PERM_WORDS,), np.uint32)
    for hwpid, p in hwpid_to_perm.items():
        if not (0 <= hwpid <= MAX_HWPID):
            raise ValueError(f"hwpid {hwpid} out of range")
        if not (0 <= p <= 3):
            raise ValueError(f"perm {p} out of range")
        words[hwpid // 16] |= np.uint32(p) << np.uint32((hwpid % 16) * 2)
    return words


def extract_perm(perm_words, hwpid):
    """Extract the 2-bit permission for `hwpid` from i32[..., 8] words.
    Negative tags (untagged or padding lanes) read word 0; their verdict
    never depends on it."""
    hwpid = as_int32(hwpid, perm_words.device)
    word_idx = torch.clamp(torch.div(hwpid, 16, rounding_mode="floor"),
                           0, PERM_WORDS - 1)
    word = torch.gather(perm_words, -1, word_idx[..., None].long())[..., 0]
    return (word >> (torch.remainder(hwpid, 16) * 2)) & 3


def tenant_permbits(table: PermissionTable, hwpid: int) -> torch.Tensor:
    """Per-entry 2-bit permission field pre-extracted for one tenant —
    the i32[cap] operand the CUDA checker kernels consume."""
    return (table.perms[:, hwpid // 16] >> ((hwpid % 16) * 2)) & 3


# ---------------------------------------------------------------------------
# Host-side (numpy) authoritative copy used by the Fabric Manager.  The FM owns
# insertion / coalescing; hosts only read the committed table (paper Fig. 2).
#
# The table is EPOCH-VERSIONED with a double-buffered (shadow) commit:
# mutations build in a shadow buffer while readers keep seeing the committed
# front buffer; `commit()` swaps the buffers atomically, bumps the epoch, and
# returns the minimal dirty page range — the payload of the FM's BISnp
# back-invalidate (paper §4.1.3/§7.1.7).  Mutators called outside an explicit
# `begin()` auto-open-and-commit a single-op transaction.
# ---------------------------------------------------------------------------


class CommitInfo(NamedTuple):
    """What a shadow commit changed — drives targeted cache invalidation.

    ``[start_page, start_page + n_pages)`` bounds every page whose
    (range, perms, meta) mapping differs between the two epochs; pages
    outside it are guaranteed byte-identical, so caches may keep them.
    ``ranges`` splits that bound into the per-run dirty ranges (one per
    contiguous run of changed entries, at most ``MAX_DIRTY_RANGES``).
    ``min_shifted_entry`` is the smallest table index whose *position* may
    have changed; ``None`` means every surviving entry kept its index.
    """
    epoch: int
    start_page: int
    n_pages: int
    min_shifted_entry: int | None
    ranges: tuple[tuple[int, int], ...] = ()


MAX_DIRTY_RANGES = 16   # per-commit BISnp fan-out cap (beyond: bounding box)


class _Buf(NamedTuple):
    starts: np.ndarray
    sizes: np.ndarray
    perms: np.ndarray
    meta: np.ndarray
    n: int


class HostTable:
    """Numpy mirror with FM-side mutation (sorted, non-overlapping ranges)."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self.starts = np.full((capacity,), EMPTY_START, np.int32)
        self.sizes = np.zeros((capacity,), np.int32)
        self.perms = np.zeros((capacity, PERM_WORDS), np.uint32)
        self.meta = np.zeros((capacity,), np.uint32)
        self.n = 0
        self.epoch = 0
        self._shadow: _Buf | None = None
        self.last_commit: CommitInfo | None = None

    # -- shadow transaction --------------------------------------------------
    def begin(self) -> None:
        """Open a shadow transaction: subsequent mutations are invisible to
        readers until `commit()`.  Nested begins are an error."""
        if self._shadow is not None:
            raise RuntimeError("shadow transaction already open")
        self._shadow = _Buf(self.starts.copy(), self.sizes.copy(),
                            self.perms.copy(), self.meta.copy(), self.n)

    def abort(self) -> None:
        """Discard the open shadow transaction (no epoch bump)."""
        self._shadow = None

    def commit(self) -> CommitInfo | None:
        """Swap the shadow buffer in; bump the epoch iff anything changed.
        Returns the CommitInfo (None for a no-op transaction)."""
        sh = self._shadow
        if sh is None:
            raise RuntimeError("no shadow transaction open")
        self._shadow = None
        diff = self._diff(sh)
        if diff is None:
            return None
        self.starts, self.sizes = sh.starts, sh.sizes
        self.perms, self.meta, self.n = sh.perms, sh.meta, sh.n
        self.epoch += 1
        dirty_lo, dirty_hi, min_shifted, ranges = diff
        self.last_commit = CommitInfo(self.epoch, dirty_lo,
                                      max(dirty_hi - dirty_lo, 0),
                                      min_shifted, ranges)
        return self.last_commit

    @contextlib.contextmanager
    def transaction(self) -> Iterator["HostTable"]:
        """Batch several mutations into ONE epoch bump / one BISnp payload."""
        self.begin()
        try:
            yield self
        except BaseException:
            self.abort()
            raise

    def _diff(self, sh: _Buf):
        """Minimal (dirty_lo, dirty_hi, min_shifted_entry, ranges) between
        the committed front buffer and the shadow, or None when identical."""
        n0, n1 = self.n, sh.n
        m = min(n0, n1)
        eq = ((self.starts[:m] == sh.starts[:m])
              & (self.sizes[:m] == sh.sizes[:m])
              & (self.perms[:m] == sh.perms[:m]).all(axis=1)
              & (self.meta[:m] == sh.meta[:m]))
        ne = np.flatnonzero(~eq)
        if n0 == n1:
            if ne.size == 0:
                return None
            p, j = int(ne[0]), int(ne[-1])
            lo = min(int(self.starts[p]), int(sh.starts[p]))
            hi = max(int(self.starts[j] + self.sizes[j]),
                     int(sh.starts[j] + sh.sizes[j]))
            runs = np.split(ne, np.flatnonzero(np.diff(ne) > 1) + 1)
            ranges = []
            if len(runs) <= MAX_DIRTY_RANGES:
                for run in runs:
                    a, b = int(run[0]), int(run[-1])
                    r_lo = min(int(self.starts[a]), int(sh.starts[a]))
                    r_hi = max(int(self.starts[b] + self.sizes[b]),
                               int(sh.starts[b] + sh.sizes[b]))
                    ranges.append((r_lo, max(r_hi - r_lo, 0)))
            else:
                ranges.append((lo, max(hi - lo, 0)))
            return lo, hi, None, tuple(ranges)
        p = int(ne[0]) if ne.size else m
        lo_cands = []
        if p < n0:
            lo_cands.append(int(self.starts[p]))
        if p < n1:
            lo_cands.append(int(sh.starts[p]))
        lo = min(lo_cands) if lo_cands else 0
        hi_cands = [lo]
        if n0 > p:
            hi_cands.append(int(self.starts[n0 - 1] + self.sizes[n0 - 1]))
        if n1 > p:
            hi_cands.append(int(sh.starts[n1 - 1] + sh.sizes[n1 - 1]))
        hi = max(hi_cands)
        return lo, hi, p, ((lo, max(hi - lo, 0)),)

    def _mutate(self, fn):
        """Run `fn(buf) -> (buf, ret)` inside the open transaction, or as an
        auto-committed single-op transaction."""
        auto = self._shadow is None
        if auto:
            self.begin()
        try:
            buf, ret = fn(self._shadow)
            self._shadow = buf
        except BaseException:
            if auto:
                self.abort()
            raise
        if auto:
            self.commit()
        return ret

    # -- FM operations ------------------------------------------------------
    def insert(self, start: int, n_pages: int, perm_words: np.ndarray,
               owner_host: int = 0, label_idx: int = 0) -> int:
        """Insert an entry, splitting/merging overlaps (paper §4.1.1).

        Overlapping regions take the OR of permission words (grant union);
        only the entries overlapping (or adjacent to) the new range are
        re-emitted and the sorted tail is spliced with one vectorized move.
        Returns the index of the (possibly merged) entry containing `start`.
        """
        if n_pages <= 0:
            raise ValueError("n_pages must be positive")
        new = (start, start + n_pages, perm_words.astype(np.uint32),
               np.uint32(owner_host | (label_idx << 16)))

        def go(buf: _Buf):
            n = buf.n
            ends = buf.starts[:n] + buf.sizes[:n]
            i_lo = int(np.searchsorted(ends, new[0], side="left"))
            i_hi = int(np.searchsorted(buf.starts[:n], new[1], side="right"))
            segs, keep = [], []
            for i in range(i_lo, i_hi):
                s, e = int(buf.starts[i]), int(buf.starts[i] + buf.sizes[i])
                if e <= new[0] or s >= new[1]:
                    keep.append((s, e, buf.perms[i].copy(), buf.meta[i]))
                else:
                    if s < new[0]:
                        keep.append((s, new[0], buf.perms[i].copy(),
                                     buf.meta[i]))
                    if e > new[1]:
                        keep.append((new[1], e, buf.perms[i].copy(),
                                     buf.meta[i]))
                    lo, hi = max(s, new[0]), min(e, new[1])
                    segs.append((lo, hi, buf.perms[i] | new[2], new[3]))
            # reclaim tombstones the new range touched (lazy vacuum)
            keep = [k for k in keep if k[2].any()]
            covered = sorted((lo, hi) for lo, hi, _, _ in segs)
            cur = new[0]
            for lo, hi in covered:
                if cur < lo:
                    segs.append((cur, lo, new[2].copy(), new[3]))
                cur = max(cur, hi)
            if cur < new[1]:
                segs.append((cur, new[1], new[2].copy(), new[3]))
            merged = _coalesce(sorted(keep + segs, key=lambda t: t[0]))
            buf = _splice(buf, i_lo, i_hi, merged, self.capacity)
            ret = int(np.searchsorted(buf.starts[:buf.n], start,
                                      side="right") - 1)
            return buf, ret

        return self._mutate(go)

    def remove_hwpid(self, hwpid: int) -> None:
        """Revocation: clear a HWPID's bits everywhere, in place.  Entries
        left with no grants become index-stable TOMBSTONES (zero perm
        words), so the commit carries only the revoked tenant's ranges and
        no index shift (paper §4.1.3 targeted BISnp)."""
        mask = ~(np.uint32(3) << np.uint32((hwpid % 16) * 2))

        def go(buf: _Buf):
            buf.perms[:buf.n, hwpid // 16] &= mask
            return buf, None

        self._mutate(go)

    def vacuum(self) -> None:
        """Compact the table: drop tombstoned entries and coalesce adjacent
        identical survivors (shifts indices; the commit reports
        ``min_shifted_entry``)."""
        def go(buf: _Buf):
            n = buf.n
            live = buf.perms[:n].any(axis=1)
            segs = [(int(buf.starts[i]), int(buf.starts[i] + buf.sizes[i]),
                     buf.perms[i].copy(), buf.meta[i])
                    for i in np.flatnonzero(live)]
            return _splice(buf, 0, n, _coalesce(segs), self.capacity), None

        self._mutate(go)

    def revoke_range(self, start: int, n_pages: int, hwpid: int) -> None:
        """Targeted revocation: clear one HWPID's bits only inside
        ``[start, start + n_pages)``, splitting boundary entries."""
        if n_pages <= 0:
            raise ValueError("n_pages must be positive")
        lo_pg, hi_pg = start, start + n_pages
        shift = np.uint32((hwpid % 16) * 2)
        mask = ~(np.uint32(3) << shift)

        def go(buf: _Buf):
            n = buf.n
            ends = buf.starts[:n] + buf.sizes[:n]
            i_lo = int(np.searchsorted(ends, lo_pg, side="right"))
            i_hi = int(np.searchsorted(buf.starts[:n], hi_pg, side="left"))
            w_lo, w_hi = max(i_lo - 1, 0), min(i_hi + 1, n)
            segs = []
            for i in range(w_lo, w_hi):
                s, e = int(buf.starts[i]), int(buf.starts[i] + buf.sizes[i])
                if e <= lo_pg or s >= hi_pg:
                    segs.append((s, e, buf.perms[i].copy(), buf.meta[i]))
                    continue
                if s < lo_pg:
                    segs.append((s, lo_pg, buf.perms[i].copy(), buf.meta[i]))
                cleared = buf.perms[i].copy()
                cleared[hwpid // 16] &= mask
                segs.append((max(s, lo_pg), min(e, hi_pg), cleared,
                             buf.meta[i]))
                if e > hi_pg:
                    segs.append((hi_pg, e, buf.perms[i].copy(), buf.meta[i]))
            merged = _coalesce(segs)
            return _splice(buf, w_lo, w_hi, merged, self.capacity), None

        self._mutate(go)

    def tile_summary(self, *, tile: int = SUMMARY_TILE,
                     n_tiles: int | None = None, device=None):
        """Summary of the committed table on ``device`` (default CUDA)."""
        with np.errstate(over="ignore"):
            ends = self.starts + self.sizes
        dev = resolve_device(device)
        return tile_summary(as_int32(self.starts, dev), as_int32(ends, dev),
                            tile=tile, n_tiles=n_tiles)

    # -- export to device ----------------------------------------------------
    def to_device(self, device=None) -> PermissionTable:
        """Snapshot the COMMITTED buffer (mid-transaction readers never see
        shadow state — that is the point of the double buffer)."""
        dev = resolve_device(device)
        return PermissionTable(
            starts=as_int32(self.starts, dev),
            sizes=as_int32(self.sizes, dev),
            perms=as_int32(self.perms, dev),
            meta=as_int32(self.meta, dev),
            n=int(self.n),
            epoch=self.epoch,
        )

    def check_invariants(self) -> None:
        """Assert the committed geometry: strictly sorted, non-overlapping
        entries (test/debug hook; raises AssertionError on violation)."""
        s = self.starts[: self.n]
        e = s + self.sizes[: self.n]
        assert np.all(np.diff(s) > 0), "starts not strictly sorted"
        assert np.all(e[:-1] <= s[1:]), "entries overlap"
        assert np.all(self.sizes[: self.n] > 0), "empty live entry"
        assert np.all(self.starts[self.n:] == EMPTY_START)


def _coalesce(segs):
    """Merge adjacent (start, end, perms, meta) segments with identical
    permission words.  Tombstones (all-zero perms) are never merged — they
    hold their index so revocation commits stay index-stable."""
    merged: list = []
    for seg in segs:
        if merged and merged[-1][1] == seg[0] and seg[2].any() and \
                np.array_equal(merged[-1][2], seg[2]):
            merged[-1] = (merged[-1][0], seg[1], merged[-1][2], merged[-1][3])
        else:
            merged.append(seg)
    return merged


def _splice(buf: _Buf, i_lo: int, i_hi: int, segs, capacity: int) -> _Buf:
    """Replace entries [i_lo, i_hi) with `segs`, shifting the sorted tail
    with one vectorized move per array (work ∝ window + tail, not table)."""
    n = buf.n
    k_new = len(segs)
    n2 = n - (i_hi - i_lo) + k_new
    if n2 > capacity:
        raise RuntimeError("permission table capacity exceeded")
    tail = slice(i_lo + k_new, n2)
    buf.starts[tail] = buf.starts[i_hi:n].copy()
    buf.sizes[tail] = buf.sizes[i_hi:n].copy()
    buf.perms[tail] = buf.perms[i_hi:n].copy()
    buf.meta[tail] = buf.meta[i_hi:n].copy()
    for j, (s, e, p, m) in enumerate(segs):
        i = i_lo + j
        buf.starts[i] = s
        buf.sizes[i] = e - s
        buf.perms[i] = p
        buf.meta[i] = m
    buf.starts[n2:] = EMPTY_START
    buf.sizes[n2:] = 0
    buf.perms[n2:] = 0
    buf.meta[n2:] = 0
    return buf._replace(n=n2)
