"""Fabric-wide batched egress (check ⊕ decrypt over R rows) as one CUDA
launch.

The single-host fused kernel launches once per host per step — at the
paper's 255-host deployment that is 255 launches of identical structure.
``fabric_egress`` runs the whole fabric step in ONE launch of
``csrc/fabric_egress.cu`` over a 2-D grid (word block, row), where a
**row is one (host, tenant) pair** (`repro_torch.core.fabric.ShardedFabric
.fabric_rows` defines the order):

  * each row carries its host's resident shard in the stacked ``[R, N]``
    entry arrays of a `FabricView`, with that tenant's permbits;
  * the tenant HWPID is a per-row device operand, so admitting a tenant
    with a fresh HWPID changes data, not code;
  * each word's lane binary-searches its row's sorted shard (the
    precondition `permcheck.lane_search_plain` states) and tests the one
    entry found against the page and ``need``: no per-row mode, no
    per-call operands derived on the host side;
  * the keystream position is ``row * bucket_pad(B, BLOCK) + lane`` —
    exactly the single-host kernel at ``base_word = row * padded_B``.

`_per_host_use_hier` keeps the reference's per-row flat/hier selector as
parity API: the tests hold it against the JAX package, and ``chip_smoke.py``
uses it to mix both kinds of traffic in one launch.

Per-row semantics match ``ref.checked_memcrypt`` for that row's shard and
hwpid bit for bit: denied lanes read zero and carry a FAULT_* code.
"""
from __future__ import annotations

import torch

from ..core.table import as_int32
from . import bucket_pad, check_cuda_operands, launches, ref
from ._build import launch
from .memcrypt import BLOCK
from .permcheck import (HIER_DENSITY_DEN, HIER_DENSITY_NUM,
                        check_search_layout)

_U32 = 0xFFFFFFFF


def _per_host_use_hier(pages, tmin, tmax, *, block: int) -> torch.Tensor:
    """Vectorized per-row selector: ``use_hier[r]`` iff row r's batch keeps
    its candidate-tile density below 3/4 of that row's shard tiles (the
    row-wise form of `permcheck.hier_profitable`).  ``pages`` i32[R, Bp]
    (padded), summaries i32[R, T].  Returns i32[R] on the device."""
    rows, n_tiles = tmin.shape
    if n_tiles <= 1:
        return torch.zeros((rows,), dtype=torch.int32, device=tmin.device)
    cand = (pages[:, :, None] >= tmin[:, None, :]) & \
        (pages[:, :, None] < tmax[:, None, :])          # (R, Bp, T)
    n_steps = pages.shape[1] // block
    needed = cand.reshape(rows, n_steps, block, n_tiles) \
        .any(dim=2).sum(dim=(1, 2))                     # [R]
    use = HIER_DENSITY_DEN * needed <= HIER_DENSITY_NUM * n_steps * n_tiles
    return use.to(torch.int32)


def fabric_egress_plain(data, ext_addrs, view, *, need: int, key0: int,
                        key1: int):
    """The plain version of the kernel: ``ref.checked_memcrypt`` row by
    row, row r at ``base_word = r * bucket_pad(B, BLOCK)``."""
    data = as_int32(data, view.starts.device)
    ext = as_int32(ext_addrs, view.starts.device)
    bp = bucket_pad(data.shape[1], BLOCK)
    outs, faults = [], []
    for r, hwpid in enumerate(view.hwpids.tolist()):
        o, f = ref.checked_memcrypt(
            data[r], ext[r], view.starts[r], view.ends[r], view.permbits[r],
            hwpid=hwpid, need=need, key0=key0, key1=key1, base_word=r * bp)
        outs.append(o)
        faults.append(f)
    return torch.stack(outs), torch.stack(faults)


def fabric_egress(data, ext_addrs, view, *, need: int, key0: int, key1: int):
    """Batched multi-host fused egress over a `FabricView`.

    ``data`` i32[R, B] (u32 bits) / ``ext_addrs`` i32[R, B]: row ``r`` is
    the step batch of tenant ``view.hwpids[r]`` on host
    ``view.host_ids[r]``, checked against that host's resident shard and
    decrypted with the keystream at position ``r * padded_B + lane``.
    Returns ``(out i32[R, B], fault i32[R, B])`` — on the view's device:
    the CUDA kernel there, the plain version on the CPU.
    """
    dev = view.starts.device
    data = as_int32(data, dev)
    ext = as_int32(ext_addrs, dev)
    if data.ndim != 2 or ext.shape != data.shape:
        raise ValueError(
            f"expected matching [R, B] operands, got data "
            f"{tuple(data.shape)} / ext {tuple(ext.shape)}")
    if data.shape[0] != view.starts.shape[0]:
        raise ValueError(
            f"{data.shape[0]} batch rows vs {view.starts.shape[0]} fabric "
            "view (host, tenant) rows")
    if dev.type == "cpu":
        return fabric_egress_plain(data, ext, view, need=need, key0=key0,
                                   key1=key1)
    data, ext = data.contiguous(), ext.contiguous()
    rows, b = data.shape
    check_cuda_operands(data=data, ext=ext, hwpids=view.hwpids,
                        starts=view.starts, ends=view.ends,
                        permbits=view.permbits, tile_min=view.tile_min)
    check_search_layout(view.starts, view.ends, view.permbits, view.tile_min)
    if tuple(view.hwpids.shape) != (rows,):
        raise ValueError(f"hwpids {tuple(view.hwpids.shape)} for {rows} "
                         "rows")
    out = torch.empty_like(data)
    fault = torch.empty_like(data)
    launch("fabric_egress_launch", data.data_ptr(), ext.data_ptr(), rows, b,
           bucket_pad(b, BLOCK), view.hwpids.data_ptr(),
           view.starts.data_ptr(), view.ends.data_ptr(),
           view.permbits.data_ptr(), view.starts.shape[1],
           view.tile_min.data_ptr(), view.tile_min.shape[1], int(need),
           int(key0) & _U32, int(key1) & _U32, out.data_ptr(),
           fault.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    launches["fabric_egress"] += 1
    return out, fault
