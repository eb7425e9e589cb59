"""Sharding rule engine: param-path + shape -> partition spec (the port of
``repro.launch.sharding``).

Rules are name-based with divisibility fallback: an axis is assigned only if
the dimension divides the mesh axis size, otherwise that dimension is
replicated.  This is what lets one ruleset cover all 10 archs (gemma3's 4
heads and qwen2-vl's 28 heads silently fall back to replicated attention
heads while their FFNs stay tensor-parallel).

Conventions:
  * batch dims -> ("pod","data") (= all data axes)
  * TP ("model"): ffn hidden, attention heads, vocab
  * FSDP (cfg.fsdp): weight input-dim additionally sharded over "data"
  * MoE: expert dim over cfg.expert_axis; per-expert ffn over "model" when the
    expert axis is "data" (llama4 2-D expert sharding)
  * KV caches: batch over data axes; kv-heads over "model" if divisible, else
    the *sequence* dim over "model" (sequence-parallel decode attention)

`RuleEngine` is the reference's, rule for rule, on the reference's key
strings (``['units']['attn']['wq']``) and stacked shapes.  The port's
parameters and caches are per layer: the tree functions give each leaf its
reference key string (`convert.reference_path` for a parameter, the cache
path without its list indices) and its stacked rank (one dim of size 1 per
layer index), and drop those leading dims from the spec.  So a port leaf's
spec is the reference leaf's spec without its stacked dims, also where a
rule reads the rank (``r >= 2``) or a stacked dim (llama4's shared MLP sits
under a "moe" unit, and the expert rule reads its layer dim).  The engine
reads an `AbstractMesh` or a ``DeviceMesh``; `named` turns specs into
placements on a ``DeviceMesh``.
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass
from typing import Any

import re

import numpy as np
from torch import nn

from ..checkpointing.store import _flatten, _unflatten
from ..configs.base import ArchConfig
from ..convert import reference_path
from .mesh import axis_names, mesh_shape, sharded_zeros, spec_placements


class P(tuple):
    """A partition spec: per tensor dim None, an axis name or a tuple of
    axis names (``jax.sharding.PartitionSpec``)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


@dataclass(frozen=True)
class NamedSharding:
    """A ``DeviceMesh`` and one DTensor placement per mesh dim."""
    mesh: Any
    placements: tuple


def _axis_size(mesh, name: str) -> int:
    return mesh_shape(mesh).get(name, 1)


def _fits(mesh, axis: str, dim: int) -> bool:
    return axis in axis_names(mesh) and dim % _axis_size(mesh, axis) == 0


def _squeeze_axes(axes: tuple[str, ...]):
    """(a,) -> a: single-axis assignments use the bare name in specs."""
    return axes[0] if len(axes) == 1 else axes


def key_string(name: str) -> str:
    """The reference's key string of a port parameter: ``layers.3.moe.w_gate``
    -> ``['units']['moe']['w_gate']``."""
    return "".join(f"[{k!r}]" for k in reference_path(name)[0])


def _unstacked(spec: P, stacked: int) -> P:
    """A stacked leaf's spec without its ``stacked`` leading dims."""
    return P(*tuple(spec)[stacked:])


_INDEX = re.compile(r"\[\d+\]")


def _named_leaves(tree) -> list[tuple[str, Any]]:
    """(path, leaf) pairs: a module's ``named_parameters()``, else the
    store's tree walk (``keystr`` paths)."""
    if isinstance(tree, nn.Module):
        return list(tree.named_parameters())
    return _flatten(tree)


class RuleEngine:
    def __init__(self, cfg: ArchConfig, mesh):
        self.cfg = cfg
        self.mesh = mesh
        self.dp = ("pod", "data") if "pod" in axis_names(mesh) else ("data",)

    # -- helpers -------------------------------------------------------------
    def m(self, dim: int) -> str | None:
        return "model" if _fits(self.mesh, "model", dim) else None

    def d(self, dim: int):
        """FSDP axes (only when cfg.fsdp): ZeRO-3 over ALL data axes —
        on the multipod mesh the pod axis shards weights/optimizer state
        too."""
        if not self.cfg.fsdp:
            return None
        total = int(np.prod([_axis_size(self.mesh, a) for a in self.dp]))
        if dim % total == 0:
            return _squeeze_axes(self.dp)
        return "data" if _fits(self.mesh, "data", dim) else None

    def dp_axes(self, dim: int):
        total = int(np.prod([_axis_size(self.mesh, a) for a in self.dp]))
        return _squeeze_axes(self.dp) if dim % total == 0 else None

    def expert(self, dim: int) -> str | None:
        ax = self.cfg.expert_axis
        return ax if _fits(self.mesh, ax, dim) else None

    # -- parameter specs -----------------------------------------------------
    def param_spec(self, path: str, shape: tuple[int, ...]) -> P:
        name = path.rsplit("[", 1)[-1].strip("']\"")
        r = len(shape)

        def pad(spec: tuple, rank: int) -> P:
            """left-pad with None to full rank (leading stacked layer dims)."""
            return P(*((None,) * (rank - len(spec)) + spec))

        if name == "tok":  # [V, D]
            return P(self.m(shape[0]), self.d(shape[1]))
        if name == "w" and "head" in path:  # [D, V]
            return P(self.d(shape[0]), self.m(shape[1]))
        if name == "wq":  # [..., D, H, hd]
            return pad((self.d(shape[-3]), self.m(shape[-2]), None), r)
        if name in ("wk", "wv"):  # [..., D, KV, hd]
            return pad((self.d(shape[-3]), self.m(shape[-2]), None), r)
        if name == "wo":  # [..., H, hd, D]
            return pad((self.m(shape[-3]), None, self.d(shape[-1])), r)
        if name in ("bq", "bk", "bv"):  # [..., H, hd]
            return pad((self.m(shape[-2]), None), r)
        if "moe" in path and name in ("w_gate", "w_up"):  # [..., E, D, F]
            return pad((self.expert(shape[-3]), None,
                        self.m(shape[-1]) if self.cfg.expert_axis != "model"
                        else None), r)
        if "moe" in path and name == "w_down":  # [..., E, F, D]
            return pad((self.expert(shape[-3]),
                        self.m(shape[-2]) if self.cfg.expert_axis != "model"
                        else None, None), r)
        if name == "router":  # [..., D, E]
            return pad((None, None), r)
        if name in ("w_gate", "w_up"):  # dense mlp [..., D, F]
            return pad((self.d(shape[-2]), self.m(shape[-1])), r)
        if name == "w_down":  # [..., F, D]
            return pad((self.m(shape[-2]), self.d(shape[-1])), r)
        if name == "w_out" and "mamba" in path:  # [..., di, D]
            return pad((self.m(shape[-2]), self.d(shape[-1])), r)
        if name in ("w_x_in", "w_z_in", "w_z", "w_x"):  # [..., D, di]
            return pad((self.d(shape[-2]), self.m(shape[-1])), r)
        if name in ("w_b", "w_c", "w_dt_in") and self.cfg.mamba_version == 1:
            # mamba1: [..., di, small] — contract over sharded di
            return pad((self.m(shape[-2]), None), r)
        if name == "w_dt" and "mamba" in path and r >= 2:
            # mamba1 [..., R, di] -> di over model; mamba2 [..., D, nh]
            return pad((None, self.m(shape[-1])), r) \
                if self.cfg.mamba_version == 1 else pad((None, None), r)
        if name in ("conv_w", "conv_x_w", "conv_b_w", "conv_c_w"):
            return pad((None, self.m(shape[-1])), r)
        if name in ("conv_b", "conv_x_b", "b_dt", "d_skip"):
            return pad((self.m(shape[-1]),), r)
        if name == "a_log" and r >= 2 and shape[-1] > 1:  # [..., di, N]
            return pad((self.m(shape[-2]), None), r)
        return P(*((None,) * r))

    # -- batch / cache specs ---------------------------------------------------
    def batch_spec(self, name: str, shape: tuple[int, ...]) -> P:
        if name == "positions":  # [3, B, S]
            return P(None, self.dp_axes(shape[1]), None)
        if name == "pos":
            return P()
        b_axes = self.dp_axes(shape[0])
        return P(*((b_axes,) + (None,) * (len(shape) - 1)))

    def kv_cache_spec(self, shape: tuple[int, ...]) -> P:
        """[U, B, KV, S, hd]: batch over data axes; kv over model when
        divisible else sequence-parallel over model."""
        u, b, kv, s, hd = shape
        b_axes = self.dp_axes(b)
        if _fits(self.mesh, "model", kv):
            return P(None, b_axes, "model", None, None)
        if _fits(self.mesh, "model", s):
            return P(None, b_axes, None, "model", None)
        return P(None, b_axes, None, None, None)

    def ssm_cache_spec(self, path: str, shape: tuple[int, ...]) -> P:
        """Mamba caches: batch over data axes; channel/head dim over model.

        Trailing layouts (possibly with leading stacked layer/group dims):
          conv  [..., B, W-1, C]       -> (dp(B), None, model(C))
          ssm1  [..., B, di, N]        -> (dp(B), model(di), None)
          ssm2  [..., B, H, dh, N]     -> (dp(B), model(H), None, None)
        """
        if "conv" in path:
            core = (self.dp_axes(shape[-3]), None, self.m(shape[-1]))
        elif "ssm" in path:
            # mamba2 state has 4 core dims [B,H,dh,N]; mamba1 has 3 [B,di,N]
            core_rank = 4 if self.cfg.mamba_version == 2 else 3
            if core_rank == 4 and len(shape) >= 4:
                core = (self.dp_axes(shape[-4]), self.m(shape[-3]),
                        None, None)
            else:
                core = (self.dp_axes(shape[-3]), self.m(shape[-2]), None)
        else:
            core = (None,) * len(shape)
        lead = (None,) * (len(shape) - len(core))
        return P(*(lead + core))

    def cache_spec_tree(self, cache_shapes: Any) -> Any:
        """Build the spec tree for a serving cache (lists of per-layer
        cache NamedTuples, as `registry.cache_shapes` gives them): each
        list index is a stacked dim of the reference's leaf."""
        specs = []
        for port_path, leaf in _flatten(cache_shapes):
            k = len(_INDEX.findall(port_path))
            path, shape = _INDEX.sub("", port_path), (1,) * k + leaf.shape
            if ".k" in path or ".v" in path or "'k'" in path or "'v'" in path:
                if len(shape) == 5:
                    specs.append(_unstacked(self.kv_cache_spec(shape), k))
                    continue
            if "conv" in path or "ssm" in path:
                specs.append(_unstacked(self.ssm_cache_spec(path, shape), k))
                continue
            specs.append(P(*((None,) * len(leaf.shape))))
        return _unflatten(cache_shapes, iter(specs))


def param_spec_tree(cfg: ArchConfig, mesh, param_shapes: Any) -> OrderedDict:
    """Parameter name -> spec for a model (``registry.param_shapes`` or any
    module) or a name -> tensor mapping, in its order."""
    eng = RuleEngine(cfg, mesh)
    named = param_shapes.named_parameters() \
        if isinstance(param_shapes, nn.Module) else param_shapes.items()
    specs = OrderedDict()
    for n, p in named:
        k = len(reference_path(n)[1])
        specs[n] = _unstacked(
            eng.param_spec(key_string(n), (1,) * k + tuple(p.shape)), k)
    return specs


def batch_spec_tree(cfg: ArchConfig, mesh, batch_shapes: dict) -> dict:
    eng = RuleEngine(cfg, mesh)
    return {k: eng.batch_spec(k, tuple(v.shape))
            for k, v in batch_shapes.items()}


def cache_spec_tree(cfg: ArchConfig, mesh, cache_shapes: Any) -> Any:
    return RuleEngine(cfg, mesh).cache_spec_tree(cache_shapes)


def named(mesh, spec_tree: Any) -> Any:
    """The spec tree with each spec turned into a `NamedSharding` on the
    ``DeviceMesh`` (``mesh.spec_placements``)."""
    return _unflatten(spec_tree, iter(
        NamedSharding(mesh, spec_placements(mesh, spec))
        for _, spec in _flatten(spec_tree)))


def sharded_zeros_tree(mesh, spec_tree: Any, shape_tree: Any,
                       device) -> Any:
    """``shape_tree`` (meta tensors) as DTensors of zeros on ``device``,
    each laid out as its spec in ``spec_tree``; only local shards are
    made."""
    return _unflatten(shape_tree, iter(
        sharded_zeros(mesh, spec_placements(mesh, spec), leaf.shape,
                      leaf.dtype, device)
        for (_, leaf), (_, spec) in zip(_flatten(shape_tree),
                                        _flatten(spec_tree))))


# ---------------------------------------------------------------------------
# Permission-table shard plumbing (Space-Control egress path)
# ---------------------------------------------------------------------------
# The global permission table is range-partitioned across the "model" mesh
# axis; each host's checker sees one shard (paper: table-in-SDM with
# per-host checkers).  These helpers size the shards against the kernel
# ceiling and produce the specs for the struct-of-arrays table + its
# two-level tile summary.

def permtable_shard_entries(mesh, total_entries: int,
                            *, max_entries: int | None = None) -> int:
    """Entries per "model"-axis shard, tile-aligned so every shard's tile
    summary stands alone; raises if a shard would exceed the checker's
    MAX_ENTRIES ceiling."""
    from ..kernels.permcheck import ENTRY_TILE, MAX_ENTRIES
    if max_entries is None:
        max_entries = MAX_ENTRIES
    ways = _axis_size(mesh, "model")
    per = -(-max(int(total_entries), 1) // ways)
    per = -(-per // ENTRY_TILE) * ENTRY_TILE
    if per > max_entries:
        raise ValueError(
            f"{total_entries} entries over a {ways}-way model axis gives "
            f"{per} entries/shard > kernel ceiling {max_entries}; widen the "
            "model axis or raise kernels.permcheck.MAX_ENTRIES")
    return per


def permtable_specs(mesh) -> dict[str, P]:
    """Partition specs for the permission-table arrays (entry dim over
    "model") and the per-shard tile summary arrays."""
    ax = "model" if "model" in axis_names(mesh) else None
    return {
        "starts": P(ax),
        "sizes": P(ax),
        "perms": P(ax, None),
        "meta": P(ax),
        "tile_min": P(ax),
        "tile_max": P(ax),
    }


def validate_specs(shape_tree: Any, spec_tree: Any, mesh) -> list[str]:
    """Returns a list of (path, error) strings for non-divisible assignments."""
    errs = []
    shape = mesh_shape(mesh)
    for (path, leaf), (_, spec) in zip(_named_leaves(shape_tree),
                                       _flatten(spec_tree)):
        for dim, ax in zip(leaf.shape, tuple(spec) + (None,) * 8):
            if ax is None:
                continue
            axes = ax if isinstance(ax, tuple) else (ax,)
            n = int(np.prod([shape[a] for a in axes]))
            if dim % n:
                errs.append(f"{path}: {dim} % {n} != 0 ({spec})")
    return errs
