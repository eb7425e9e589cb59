"""State and weights carried across between the JAX package and the port.

The checked egress path computes on state — the device permission table,
shard and fabric views, the permission cache; the serving path adds the
decoder LM's parameters and its KV cache.  These functions turn either,
given as numpy arrays (any object with the named array attributes: a JAX
NamedTuple or pytree of arrays works, since ``np.asarray`` reads it), into
the port's tensors and modules, and back again.  Model parameters and
serving caches of every family cross the same way (`params_from_numpy`,
`cache_from_numpy`, `cache_to_numpy`), and so do the training path's
parameters, gradients and AdamW state (`params_to_numpy`,
`adamw_state_from_numpy`, `adamw_state_to_numpy`).  u32 words keep their
bit patterns: ``uint32`` in numpy, int32 in torch.
"""
from __future__ import annotations

from collections import OrderedDict

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
from .layers.mamba import Mamba2Cache, MambaCache
from .models import encdec, hybrid, lm, registry, ssm
from .optim import AdamWState


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
# the serving path: model parameters and serving caches of every family
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


def _load(module, tree: dict, index, device) -> None:
    """Copy a reference subtree into ``module``: each leaf array, indexed
    by ``index`` (its layer in the stack), becomes the parameter of the
    same name, in that parameter's dtype; each sub-dict fills the
    submodule of its name."""
    for name, sub in tree.items():
        if isinstance(sub, dict):
            _load(getattr(module, name), sub, index, device)
        else:
            dt = getattr(module, name).dtype
            setattr(module, name, param(_float_tensor(np.asarray(sub)[index],
                                                      dt, device)))


def _load_ends(model, cfg: ArchConfig, tree, device) -> None:
    """The token table, the final norm and the untied head."""
    ends = {"tok": tree["embed"]["tok"], "final_norm": tree["final_norm"]}
    if not cfg.tie_embeddings:
        ends["head_w"] = tree["head"]["w"]
    _load(model, ends, (), device)


def lm_params_from_numpy(cfg: ArchConfig, tree, *, device=None
                         ) -> lm.DecoderLM:
    """The reference's decoder-LM parameter pytree (dense, moe, vlm:
    ``embed.tok``, the stacked ``units`` [n_units, ...] — a llama4 unit
    holds ``dense`` and ``moe`` blocks —, ``final_norm``, ``head.w``), as
    numpy arrays, -> the port's `DecoderLM` with one module per unit."""
    dev = resolve_device(device)
    model = lm.DecoderLM(cfg, None, "meta")
    _load_ends(model, cfg, tree, dev)
    for i, unit in enumerate(model.layers):
        _load(unit, tree["units"], i, dev)
    return model


def ssm_params_from_numpy(cfg: ArchConfig, tree, *, device=None
                          ) -> ssm.MambaLM:
    """The reference's falcon-mamba pytree (stacked ``blocks``) -> the
    port's `MambaLM`."""
    dev = resolve_device(device)
    model = ssm.MambaLM(cfg, None, "meta")
    _load_ends(model, cfg, tree, dev)
    for i, block in enumerate(model.blocks):
        _load(block, tree["blocks"], i, dev)
    return model


def hybrid_params_from_numpy(cfg: ArchConfig, tree, *, device=None
                             ) -> hybrid.HybridLM:
    """The reference's zamba2 pytree (``groups`` stacked [G, per group,
    ...], the one ``shared_attn`` block, ``tail`` [tail, ...]) -> the
    port's `HybridLM`."""
    dev = resolve_device(device)
    model = hybrid.HybridLM(cfg, None, "meta")
    _load_ends(model, cfg, tree, dev)
    for g, group in enumerate(model.groups):
        for j, block in enumerate(group):
            _load(block, tree["groups"], (g, j), dev)
    _load(model.shared_attn, tree["shared_attn"], (), dev)
    for i, block in enumerate(model.tail):
        _load(block, tree["tail"], i, dev)
    return model


def encdec_params_from_numpy(cfg: ArchConfig, tree, *, device=None
                             ) -> encdec.EncDecLM:
    """The reference's seamless pytree (``enc_blocks``, ``enc_norm``,
    ``dec_blocks``) -> the port's `EncDecLM`."""
    dev = resolve_device(device)
    model = encdec.EncDecLM(cfg, None, "meta")
    _load_ends(model, cfg, tree, dev)
    _load(model, {"enc_norm": tree["enc_norm"]}, (), dev)
    for name in ("enc_blocks", "dec_blocks"):
        for i, block in enumerate(getattr(model, name)):
            _load(block, tree[name], i, dev)
    return model


def params_from_numpy(cfg: ArchConfig, tree, *, device=None):
    """Any family's reference parameter pytree -> the port's model."""
    fn = {"ssm": ssm_params_from_numpy, "hybrid": hybrid_params_from_numpy,
          "encdec": encdec_params_from_numpy}.get(cfg.family,
                                                  lm_params_from_numpy)
    return fn(cfg, tree, device=device)


def _split(cls, stacked, index, device):
    """One layer's cache ``cls(...)`` out of the reference's stacked
    NamedTuple, each field indexed by ``index``."""
    return cls(*(_float_tensor(np.asarray(getattr(stacked, f))[index], None,
                               device) for f in cls._fields))


def cache_from_numpy(cfg: ArchConfig, cache, *, device=None):
    """A reference serving cache (stacked per layer: `KVCache`,
    ``{"dense", "moe"}`` of them for llama4, `MambaCache`, zamba2's
    ``{"groups", "attn", "tail"}``, `EncDecCache`) -> the port's per-layer
    cache of the same family."""
    dev = resolve_device(device)
    if cfg.family == "ssm":
        return [_split(MambaCache, cache, i, dev)
                for i in range(cfg.n_layers)]
    if cfg.family == "hybrid":
        g, bpg, tail = hybrid.group_layout(cfg)
        out = {"groups": [[_split(Mamba2Cache, cache["groups"], (i, j), dev)
                           for j in range(bpg)] for i in range(g)],
               "attn": [_split(KVCache, cache["attn"], i, dev)
                        for i in range(g)]}
        if tail:
            out["tail"] = [_split(Mamba2Cache, cache["tail"], i, dev)
                           for i in range(tail)]
        return out
    if cfg.family == "encdec":
        return encdec.EncDecCache(*(
            [_split(KVCache, getattr(cache, f), i, dev)
             for i in range(cfg.n_layers)] for f in ("self_kv", "cross_kv")))
    if cfg.family == "moe" and cfg.moe_every == 2:
        return [{part: _split(KVCache, cache[part], i, dev)
                 for part in ("dense", "moe")}
                for i in range(lm.n_units(cfg))]
    return [_split(KVCache, cache, i, dev) for i in range(lm.n_units(cfg))]


def _stack_layers(parts: list):
    if isinstance(parts[0], dict):
        return {k: _stack_layers([p[k] for p in parts]) for k in parts[0]}
    return np.stack(parts)


def cache_to_numpy(cache):
    """The port's serving cache of any family as the reference's stacked
    layout, in nested dicts of f32 numpy arrays (a NamedTuple becomes a
    dict of its fields; a per-layer list becomes one array per field with
    the layers first)."""
    if isinstance(cache, torch.Tensor):
        return cache.detach().to("cpu", torch.float32).numpy()
    if hasattr(cache, "_fields"):
        return {f: cache_to_numpy(getattr(cache, f)) for f in cache._fields}
    if isinstance(cache, dict):
        return {k: cache_to_numpy(v) for k, v in cache.items()}
    return _stack_layers([cache_to_numpy(c) for c in cache])


# ---------------------------------------------------------------------------
# the training path: parameters, gradients and optimizer state, back again
# ---------------------------------------------------------------------------

# the port's top-level names that the reference spells otherwise
_TOP = {"tok": ("embed", "tok"), "head_w": ("head", "w"),
        "layers": ("units",)}


def reference_path(name: str) -> tuple[tuple[str, ...], tuple[int, ...]]:
    """Where a parameter of the port (its ``named_parameters()`` name)
    lives in the reference's pytree: (key path, index into the stacked
    leaf).  ``layers.3.attn.wq`` -> (("units", "attn", "wq"), (3,));
    zamba2's ``groups.1.2.mamba.w_x`` -> (("groups", "mamba", "w_x"),
    (1, 2)); ``tok`` -> (("embed", "tok"), ())."""
    parts = name.split(".")
    path = list(_TOP.get(parts[0], (parts[0],)))
    rest = parts[1:]
    index = []
    while rest and rest[0].isdigit():
        index.append(int(rest.pop(0)))
    return tuple(path + rest), tuple(index)


def _insert(tree: dict, path, value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def _lookup(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def _stack_named(named) -> dict:
    """Port (name, tensor) pairs -> the reference's nested dict of stacked
    f32 numpy arrays (a tied model's ``head`` is the reference's ``{}``)."""
    groups: dict = {}
    for name, t in named:
        path, index = reference_path(name)
        groups.setdefault(path, []).append(
            (index, t.detach().to("cpu", torch.float32).numpy()))
    tree: dict = {"head": {}}
    for path, items in groups.items():
        items.sort(key=lambda it: it[0])
        idx = np.array([i for i, _ in items]).reshape(len(items), -1)
        stack = [a for _, a in items]
        lead = tuple(int(n) + 1 for n in idx.max(axis=0)) if idx.size else ()
        value = np.stack(stack).reshape(lead + stack[0].shape) if lead \
            else stack[0]
        _insert(tree, path, value)
    return tree


def params_to_numpy(cfg: ArchConfig, model, *, grads: bool = False) -> dict:
    """The port's model of any family as the reference's parameter pytree
    (stacked per layer, f32 numpy arrays); with ``grads=True`` each
    parameter's ``.grad`` in its place.  The inverse of
    `params_from_numpy`."""
    del cfg  # the names carry the layout
    named = []
    for name, p in model.named_parameters():
        t = p.grad if grads else p
        if t is None:
            raise ValueError(f"parameter {name} has no gradient")
        named.append((name, t))
    return _stack_named(named)


def adamw_state_from_numpy(cfg: ArchConfig, state, *,
                           device=None) -> AdamWState:
    """The reference's `AdamWState` (``step``, ``mu`` and ``nu`` trees
    shaped like its parameters; numpy arrays) -> the port's, its moments
    keyed by the port's parameter names in ``cfg.moment_dtype``."""
    dev = resolve_device(device)
    mdt = getattr(torch, cfg.moment_dtype)
    names = [n for n, _ in registry.param_shapes(cfg).named_parameters()]

    def moments(tree):
        out = OrderedDict()
        for name in names:
            path, index = reference_path(name)
            out[name] = _float_tensor(np.asarray(_lookup(tree, path))[index],
                                      mdt, dev)
        return out
    return AdamWState(
        step=torch.as_tensor(int(np.asarray(state.step)), dtype=torch.int32,
                             device=dev),
        mu=moments(state.mu), nu=moments(state.nu))


def adamw_state_to_numpy(state: AdamWState) -> AdamWState:
    """The port's `AdamWState` with the reference's layout: ``step`` an
    int32 numpy scalar, ``mu``/``nu`` the reference's stacked trees of f32
    numpy arrays (`params_to_numpy`'s layout)."""
    return AdamWState(step=np.asarray(int(state.step), np.int32),
                      mu=_stack_named(state.mu.items()),
                      nu=_stack_named(state.nu.items()))
