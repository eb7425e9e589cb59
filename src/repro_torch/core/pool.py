"""Shared tensor pool — the framework-level SDM.

Maps named tensors (KV-cache pages, expert shards, embedding shards) into
one flat 4 KiB-page-addressed space, so Space-Control range entries can
guard them.  `checked_gather` is the LD/ST egress point: every row gather
from the pool is tagged with the tenant's A-bits and validated by the
permission checker; denied rows are zero-filled and reported via fault
codes — the dataflow analogue of the paper's response-side enforcement.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from .checker import CheckResult, check_access
from .table import PAGE_BYTES, PermissionTable, pack_ext_addr


@dataclass(frozen=True)
class Region:
    """One named tensor's page-granular placement in the shared SDM."""
    name: str
    start_page: int
    n_pages: int
    row_shape: tuple[int, ...]
    dtype: torch.dtype
    rows: int

    @property
    def bytes_per_row(self) -> int:
        """Row footprint in bytes (drives the row -> page mapping)."""
        return int(np.prod(self.row_shape, dtype=np.int64)) * \
            self.dtype.itemsize

    def pages_for_rows(self, row_idx) -> torch.Tensor:
        """Map row indices -> first page of each row (page-granular check);
        int32, on the device of ``row_idx`` (numpy: the CPU)."""
        bpr = max(self.bytes_per_row, 1)
        byte_off = torch.as_tensor(row_idx).to(torch.int32) * bpr
        return self.start_page + torch.div(byte_off, PAGE_BYTES,
                                           rounding_mode="floor")


def _n_pages(tensor: torch.Tensor) -> int:
    rows = tensor.shape[0]
    bpr = int(np.prod(tuple(tensor.shape[1:]), dtype=np.int64)) * \
        tensor.dtype.itemsize
    return max(1, -(-rows * bpr // PAGE_BYTES))


class SharedTensorPool:
    """Page-space registry for shared tensors.

    The data itself stays as ordinary tensors; the pool only assigns page
    ranges so the permission machinery has addresses to check.
    """

    def __init__(self):
        self._regions: dict[str, Region] = {}
        self._tensors: dict[str, torch.Tensor] = {}
        self._next_page = 1  # page 0 reserved (metadata section, Fig. 5)
        self._free: list[tuple[int, int]] = []  # (start, n) released spans
        # regions whose page span is owned by an external allocator (a
        # ShardedFabric tenant span): unregister must NOT recycle them into
        # the pool's own free list
        self._external: set[str] = set()

    def _alloc(self, n_pages: int) -> int:
        """First-fit from the free list (tenant churn reuses released page
        ranges instead of growing the address space), else bump-allocate."""
        for i, (start, n) in enumerate(self._free):
            if n >= n_pages:
                if n == n_pages:
                    self._free.pop(i)
                else:
                    self._free[i] = (start + n_pages, n - n_pages)
                return start
        start = self._next_page
        self._next_page += n_pages
        return start

    def _add(self, name: str, tensor: torch.Tensor, start_page: int,
             n_pages: int) -> Region:
        region = Region(name, int(start_page), n_pages,
                        tuple(tensor.shape[1:]), tensor.dtype,
                        tensor.shape[0])
        self._regions[name] = region
        self._tensors[name] = tensor
        return region

    def register(self, name: str, tensor: torch.Tensor) -> Region:
        """Place a tensor in the pool: allocate a page span (first-fit over
        freed spans, else bump) and record its row-granular Region."""
        if name in self._regions:
            raise ValueError(f"region {name} exists")
        n_pages = _n_pages(tensor)
        return self._add(name, tensor, self._alloc(n_pages), n_pages)

    def register_at(self, name: str, tensor: torch.Tensor, *,
                    start_page: int) -> Region:
        """Register a tensor at an externally-allocated page span (a
        `ShardedFabric` tenant span, so pool regions and fabric grants live
        at the SAME addresses — one page space, one checker).  The pool
        records the region for named lookup / `checked_gather` but does not
        manage the span's lifetime: `unregister` drops the name without
        touching the pool's free list (the external allocator recycles
        it)."""
        if name in self._regions:
            raise ValueError(f"region {name} exists")
        region = self._add(name, tensor, start_page, _n_pages(tensor))
        self._external.add(name)
        return region

    def unregister(self, name: str) -> Region:
        """Release a region: the tensor is dropped and its page span joins
        the free list (coalescing adjacent spans) — unless the span is
        externally owned (`register_at`), in which case only the name is
        dropped.  The caller revokes outstanding grants FIRST — the pool
        only manages addresses, the permission table manages access."""
        region = self._regions.pop(name)
        self._tensors.pop(name, None)
        if name in self._external:
            self._external.discard(name)
            return region
        spans = sorted(self._free + [(region.start_page, region.n_pages)])
        merged: list[tuple[int, int]] = []
        for s, n in spans:
            if merged and merged[-1][0] + merged[-1][1] == s:
                merged[-1] = (merged[-1][0], merged[-1][1] + n)
            else:
                merged.append((s, n))
        self._free = merged
        return region

    def region(self, name: str) -> Region:
        """Placement record of a registered tensor (KeyError if absent)."""
        return self._regions[name]

    def tensor(self, name: str) -> torch.Tensor:
        """Current backing tensor of a registered region."""
        return self._tensors[name]

    def update(self, name: str, tensor: torch.Tensor) -> None:
        """Replace a region's backing tensor (same row count — the page
        placement is immutable)."""
        if tensor.shape[0] != self._regions[name].rows:
            raise ValueError(f"{name}: {tensor.shape[0]} rows, the region "
                             f"holds {self._regions[name].rows}")
        self._tensors[name] = tensor

    @property
    def total_pages(self) -> int:
        """Pages ever allocated (the bump-cursor high-water mark)."""
        return self._next_page


class GatherResult(NamedTuple):
    """A checked gather: fetched rows + the per-row permission verdicts."""
    data: torch.Tensor
    check: CheckResult


def checked_gather(pool: SharedTensorPool, name: str, row_idx, *,
                   hwpid: int, table: PermissionTable,
                   hwpid_local: torch.Tensor,
                   is_write: bool = False) -> GatherResult:
    """Gather rows from a shared region under Space-Control enforcement.

    Data gather and permission lookup proceed side by side (as in the
    paper's out-of-order issue); the verdict is applied at the response
    end: denied rows are zero-filled, faults are reported in
    `check.fault`.
    """
    region = pool.region(name)
    tensor = pool.tensor(name)
    rows = torch.as_tensor(row_idx).to(device=tensor.device,
                                       dtype=torch.int64)
    pages = region.pages_for_rows(rows)
    ext = pack_ext_addr(torch.full(pages.shape, hwpid, dtype=torch.int32,
                                   device=pages.device), pages)
    check = check_access(table, hwpid_local, ext,
                         torch.full(pages.shape, is_write, dtype=torch.bool))
    data = tensor[rows]
    mask = check.allowed.to(data.device).reshape(
        check.allowed.shape + (1,) * (data.ndim - 1))
    data = torch.where(mask, data, torch.zeros_like(data))
    return GatherResult(data, check)
