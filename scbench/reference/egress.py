"""The egress path's semantics, written from the paper's definitions.

A fabric row is one (host, tenant) pair.  Its word at lane ``j`` carries an
A-bit tagged page address ``hwpid << 24 | page`` and a ciphertext word.
The word is released, decrypted, iff the tag is the row's tenant and the
page lies inside a span the tenant holds a live read grant on; otherwise it
reads zero and carries a fault code.  The cipher is a counter-mode ARX
block function (Threefry-2x32 rotations, 12 rounds) over 64-byte lines:
word position ``p`` is XORed with the first output word of
``arx(key, line = p // 16, word = p % 16)``.  A row's positions start at
``row * words_per_row``.

Everything is int64 arithmetic on 32-bit values, on whatever device the
operands live on.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

U32 = 0xFFFFFFFF
HWPID_SHIFT = 24
PAGE_MASK = (1 << HWPID_SHIFT) - 1
ROTATIONS = (13, 15, 26, 6, 17, 29, 16, 24)
PARITY = 0x1BD11BDA
ROUNDS = 12

# fault codes: the checker's order of tests
FAULT_NONE = 0
FAULT_NO_ABITS = 1      # untagged
FAULT_NOT_LOCAL = 2     # tag is not the row's tenant
FAULT_NO_ENTRY = 3      # no entry of the host's shard covers the page
FAULT_PERM = 4          # an entry covers it but grants the tenant nothing


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & U32


def keystream(key0: int, key1: int, pos: torch.Tensor) -> torch.Tensor:
    """First output word (int64 holding a u32) of the ARX block function at
    word positions ``pos`` (int64, taken mod 2^32)."""
    pos = pos & U32
    k0, k1 = key0 & U32, key1 & U32
    ks = (k0, k1, k0 ^ k1 ^ PARITY)
    x0 = ((pos >> 4) + k0) & U32
    x1 = ((pos & 15) + k1) & U32
    for rnd in range(ROUNDS):
        x0 = (x0 + x1) & U32
        x1 = _rotl(x1, ROTATIONS[rnd % 8]) ^ x0
        if rnd % 4 == 3:
            j = rnd // 4 + 1
            x0 = (x0 + ks[j % 3]) & U32
            x1 = (x1 + ks[(j + 1) % 3] + j) & U32
    return x0


def to_i32(x64: torch.Tensor) -> torch.Tensor:
    """int64 holding u32 values -> int32 of the same bits."""
    return torch.where(x64 >= 1 << 31, x64 - (1 << 32), x64).to(torch.int32)


@dataclass
class RowGrants:
    """What each row's tenant holds, as the benchmark's lifecycle calls set
    it: ``hwpid[r]``, its span ``[lo[r], hi[r])`` of pages, whether the span
    carries an entry on the host (``entry``: granted, or revoked and kept as
    a tombstone) and whether the grant is live (``live``).  Tensors of [R]
    on one device."""
    hwpid: torch.Tensor
    lo: torch.Tensor
    hi: torch.Tensor
    entry: torch.Tensor
    live: torch.Tensor


def egress(data: torch.Tensor, ext: torch.Tensor, grants: RowGrants, *,
           key0: int, key1: int, words_per_row: int,
           ignore_range: bool = False, ignore_revocation: bool = False):
    """(out int32[R, B], fault int32[R, B]) of one fabric step.

    ``ignore_range`` and ``ignore_revocation`` each break one guarantee:
    a tag-only check, and a check that keeps serving revoked grants.  They
    are the controls a sound comparison has to reject."""
    r, b = ext.shape
    dev = ext.device
    e = ext.to(torch.int64)
    tag = e >> HWPID_SHIFT          # arithmetic: a negative word is untagged
    page = e & PAGE_MASK
    hw = grants.hwpid.to(torch.int64)[:, None]
    own = (page >= grants.lo.to(torch.int64)[:, None]) & \
        (page < grants.hi.to(torch.int64)[:, None])
    if ignore_range:
        own = torch.ones_like(own)
    covered = own & grants.entry[:, None]
    live = grants.live[:, None] | ignore_revocation
    allowed = (tag == hw) & covered & live
    pos = (torch.arange(r, device=dev, dtype=torch.int64)[:, None]
           * words_per_row
           + torch.arange(b, device=dev, dtype=torch.int64)[None, :])
    clear = to_i32((data.to(torch.int64) & U32) ^ keystream(key0, key1, pos))
    out = torch.where(allowed, clear, torch.zeros_like(clear))
    fault = torch.where(
        allowed, FAULT_NONE,
        torch.where(tag <= 0, FAULT_NO_ABITS,
                    torch.where(tag != hw, FAULT_NOT_LOCAL,
                                torch.where(covered, FAULT_PERM,
                                            FAULT_NO_ENTRY))))
    return out, fault.to(torch.int32)


def mismatches(got, want) -> tuple[int, int]:
    """(words that differ, fault codes that differ) between the program's
    (out, fault) and the reference's."""
    return (int((got[0] != want[0]).sum()), int((got[1] != want[1]).sum()))


class GrantLedger:
    """The reference's own account of a fabric deployment's grants, kept
    from the lifecycle calls the benchmark makes: one row per tenant slot,
    rows in ascending host order.  A revoked or evicted grant leaves its
    entry in place as a tombstone (no permission for anyone) until an
    admit on the host replaces it.  ``violations`` counts grants that broke
    the deployment's layout: a span outside its host's shard of the SDM,
    of the wrong size, or overlapping another row's span."""

    def __init__(self, hosts: list[int], n_hosts: int, sdm_pages: int,
                 span_pages: int):
        self.hosts = hosts
        self.per = -(-sdm_pages // n_hosts)
        self.sdm_pages = sdm_pages
        self.span = span_pages
        n = len(hosts)
        self.hwpid = [0] * n
        self.lo = [0] * n
        self.entry = [False] * n
        self.live = [False] * n
        self.violations = 0

    def admit(self, row: int, hwpid: int, lo: int) -> None:
        h = self.hosts[row]
        shard_lo = h * self.per
        shard_hi = min(shard_lo + self.per, self.sdm_pages)
        hi = lo + self.span
        clash = any(self.entry[r] and r != row and lo < self.lo[r] + self.span
                    and self.lo[r] < hi for r in range(len(self.hosts)))
        if not (shard_lo <= lo and hi <= shard_hi) or clash:
            self.violations += 1
        self.hwpid[row], self.lo[row] = hwpid, lo
        self.entry[row], self.live[row] = True, True

    def revoke(self, row: int) -> None:
        self.live[row] = False

    def snapshot(self) -> tuple:
        return (tuple(self.hwpid), tuple(self.lo), tuple(self.entry),
                tuple(self.live))

    def grants(self, snapshot: tuple, device) -> RowGrants:
        hwpid, lo, entry, live = snapshot

        def t(x, dtype):
            return torch.as_tensor(x, dtype=dtype, device=device)
        lo_t = t(lo, torch.int64)
        return RowGrants(hwpid=t(hwpid, torch.int64), lo=lo_t,
                         hi=lo_t + self.span, entry=t(entry, torch.bool),
                         live=t(live, torch.bool))
