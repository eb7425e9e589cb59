"""State and weights carried across between the JAX package and the port.

The checked egress path computes on state — the device permission table,
shard and fabric views, the permission cache; the serving path adds the
decoder LM's parameters and its KV cache.  These functions turn either,
given as numpy arrays (any object with the named array attributes: a JAX
NamedTuple or pytree of arrays works, since ``np.asarray`` reads it), into
the port's tensors and modules, and back again.  u32 words keep their bit
patterns: ``uint32`` in numpy, int32 in torch.
"""
from __future__ import annotations

import numpy as np
import torch

from .configs.base import ArchConfig
from .core.checker import PermCache
from .core.fabric import FabricView
from .core.table import PermissionTable, as_int32
from .kernels import resolve_device
from .kernels.permcheck import ShardView
from .layers.attention import KVCache
from .layers.common import param
from .models import lm


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


# ---------------------------------------------------------------------------
# the serving path: decoder-LM parameters and the KV cache
# ---------------------------------------------------------------------------

def _float_tensor(a, dtype, device) -> torch.Tensor:
    """A numpy float array (bf16 arrays included: JAX's ``bfloat16`` numpy
    dtype has no torch counterpart, so it crosses as its bits)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    return t.to(device=device, dtype=dtype)


def lm_params_from_numpy(cfg: ArchConfig, tree, *, device=None
                         ) -> lm.DenseLM:
    """The reference's dense-LM parameter pytree (``embed.tok``, the
    stacked ``units`` [n_layers, ...], ``final_norm``, ``head.w``), as
    numpy arrays, -> the port's `DenseLM` with one module per layer."""
    dev = resolve_device(device)
    dt = cfg.pdtype
    model = lm.DenseLM(cfg, None, "meta")
    put = lambda a: param(_float_tensor(a, dt, dev))
    model.tok = put(tree["embed"]["tok"])
    model.final_norm = put(tree["final_norm"])
    if not cfg.tie_embeddings:
        model.head_w = put(tree["head"]["w"])
    units = tree["units"]
    for i, layer in enumerate(model.layers):
        layer.ln1 = put(units["ln1"][i])
        layer.ln2 = put(units["ln2"][i])
        for name, arr in units["attn"].items():
            setattr(layer.attn, name, put(arr[i]))
        for name, arr in units["mlp"].items():
            setattr(layer.mlp, name, put(arr[i]))
    return model


def kv_cache_from_numpy(cache, *, device=None) -> list[KVCache]:
    """A reference cache (``k``/``v`` stacked [n_layers, B, n_kv, cap,
    dh]) -> the port's per-layer `KVCache` list."""
    dev = resolve_device(device)
    k, v = np.asarray(cache.k), np.asarray(cache.v)
    return [KVCache(_float_tensor(k[i], None, dev),
                    _float_tensor(v[i], None, dev))
            for i in range(k.shape[0])]


def kv_cache_to_numpy(cache: list[KVCache]) -> dict:
    """The port's per-layer cache as stacked f32 numpy ``k`` and ``v``
    [n_layers, B, n_kv, cap, dh]."""
    return {f: torch.stack([getattr(c, f) for c in cache])
            .to("cpu", torch.float32).numpy() for f in ("k", "v")}
