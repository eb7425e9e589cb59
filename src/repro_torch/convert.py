"""State carried across between the JAX package and the port.

The system has no weights; what both packages compute on is state — the
device permission table, shard and fabric views, the permission cache.
These functions turn that state, given as numpy arrays (any object with
the named array attributes: a JAX NamedTuple of arrays works, since
``np.asarray`` reads it), into the port's tensors, and back again.  u32
words keep their bit patterns: ``uint32`` in numpy, int32 in torch.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.checker import PermCache
from .core.fabric import FabricView
from .core.table import PermissionTable, as_int32
from .kernels import resolve_device
from .kernels.permcheck import ShardView


def u32_to_numpy(t) -> np.ndarray:
    """A tensor of u32 words (int32 bit patterns) as a numpy uint32 array."""
    return t.detach().to("cpu", torch.int32).numpy().view(np.uint32)


def u32_from_numpy(a, device=None) -> torch.Tensor:
    """Numpy u32 words as an int32 tensor with the same bits."""
    return as_int32(np.asarray(a, np.uint32), resolve_device(device))


def _arr(obj, name: str) -> np.ndarray:
    return np.asarray(getattr(obj, name))


def permission_table_from_numpy(t, *, device=None) -> PermissionTable:
    """``t.starts/sizes/perms/meta/n/epoch`` -> a port `PermissionTable`."""
    dev = resolve_device(device)
    return PermissionTable(
        starts=as_int32(_arr(t, "starts"), dev),
        sizes=as_int32(_arr(t, "sizes"), dev),
        perms=as_int32(_arr(t, "perms"), dev),
        meta=as_int32(_arr(t, "meta"), dev),
        n=int(_arr(t, "n")), epoch=int(_arr(t, "epoch")))


def permission_table_to_numpy(t: PermissionTable) -> dict:
    """A port `PermissionTable` as numpy arrays (u32 fields as uint32)."""
    return {"starts": t.starts.cpu().numpy(), "sizes": t.sizes.cpu().numpy(),
            "perms": u32_to_numpy(t.perms), "meta": u32_to_numpy(t.meta),
            "n": int(t.n), "epoch": int(t.epoch)}


def shard_view_from_numpy(v, *, device=None) -> ShardView:
    """``v.starts/ends/permbits/tile_min/tile_max/epoch`` -> `ShardView`."""
    dev = resolve_device(device)
    return ShardView(*(as_int32(_arr(v, f), dev) for f in
                       ("starts", "ends", "permbits", "tile_min",
                        "tile_max")),
                     epoch=int(_arr(v, "epoch")))


def fabric_view_from_numpy(v, *, device=None) -> FabricView:
    """A stacked fabric view (``starts`` ... ``hwpids``, ``host_ids``,
    ``epoch``) -> `FabricView`."""
    dev = resolve_device(device)
    return FabricView(*(as_int32(_arr(v, f), dev) for f in
                        ("starts", "ends", "permbits", "tile_min",
                         "tile_max", "hwpids")),
                      host_ids=tuple(int(h) for h in v.host_ids),
                      epoch=int(_arr(v, "epoch")))


def perm_cache_from_numpy(c, *, device=None) -> PermCache:
    """``c.tag/entry/plru/hits/misses/epoch`` -> `PermCache`."""
    dev = resolve_device(device)
    return PermCache(
        tag=as_int32(_arr(c, "tag"), dev),
        entry=as_int32(_arr(c, "entry"), dev),
        plru=as_int32(_arr(c, "plru"), dev),
        hits=torch.as_tensor(int(_arr(c, "hits")), dtype=torch.int64,
                             device=dev),
        misses=torch.as_tensor(int(_arr(c, "misses")), dtype=torch.int64,
                               device=dev),
        epoch=int(_arr(c, "epoch")))


def perm_cache_to_numpy(c: PermCache) -> dict:
    """A port `PermCache` as numpy arrays (``plru`` as uint32)."""
    return {"tag": c.tag.cpu().numpy(), "entry": c.entry.cpu().numpy(),
            "plru": u32_to_numpy(c.plru), "hits": int(c.hits),
            "misses": int(c.misses), "epoch": int(c.epoch)}
