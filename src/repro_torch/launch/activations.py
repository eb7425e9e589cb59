"""Activation sharding constraints (the port of ``repro.launch.activations``).

The reference pins the canonical activation layout (batch over the data
axes, heads/ffn over "model") with ``with_sharding_constraint`` so that
XLA's SPMD partitioner cannot pick a worse one.  ``constrain(x, spec...)``
resolves the spec against the ambient mesh with the rule engine's
divisibility fallback (an axis that does not divide its dimension, or that
the mesh lacks, is dropped) and

  * without an ambient mesh returns ``x`` itself;
  * under a mesh redistributes a ``DTensor`` to the resolved placements,
    and returns a plain tensor unchanged: eager PyTorch has no SPMD
    partitioner to constrain.

State that a step makes for itself follows its inputs: `zeros` and
`sharded_cache` give plain tensors, as before, unless the input they are
made for is a ``DTensor`` under an ambient mesh (the dry run), and then
DTensors laid out by the rules, with only the local shard made.

PyTorch has no ``with mesh:``, so `use_mesh` sets the ambient mesh for a
block (a context variable; the reference reads jax's thread resources).
The reference's ``constrain`` raises "can only refer to Auto axes" on jax
0.9, where ``jax.make_mesh`` gives Explicit axes; the port keeps the
documented behaviour instead.
"""
from __future__ import annotations

import contextlib
import contextvars
import math

import torch

from ..kernels import is_dtensor
from .mesh import axis_names, mesh_shape, sharded_zeros, spec_placements

BATCH = ("pod", "data")   # all data-parallel axes
MODEL = "model"

_MESH = contextvars.ContextVar("repro_torch_mesh", default=None)


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` the ambient mesh inside the block."""
    token = _MESH.set(mesh)
    try:
        yield mesh
    finally:
        _MESH.reset(token)


def current_mesh():
    """The ambient mesh (`use_mesh`), or None."""
    mesh = _MESH.get()
    return None if mesh is None or not axis_names(mesh) else mesh


def _resolve(mesh, dim: int, want) -> tuple | None:
    """Filter `want` down to axes present in the mesh that divide `dim`."""
    if want is None:
        return None
    shape = mesh_shape(mesh)
    axes = tuple(a for a in (want if isinstance(want, tuple) else (want,))
                 if a in shape)
    if not axes:
        return None
    total = math.prod(shape[a] for a in axes)
    return axes if total > 0 and dim % total == 0 else None


def constrain(x, *spec):
    """``x`` laid out as ``spec`` with the divisibility fallback.

    spec entries: None, an axis name, or a tuple of axis names; entries for
    trailing dims may be omitted (replicated).  ``x`` itself without an
    ambient mesh, and for a plain tensor."""
    mesh = _MESH.get()
    if mesh is None or not is_dtensor(x):
        return x
    resolved = _resolved(mesh, x.shape, spec)
    if all(r is None for r in resolved):
        return x
    return x.redistribute(mesh, spec_placements(mesh, resolved))


def _resolved(mesh, shape, spec) -> list:
    full = list(spec) + [None] * (len(shape) - len(spec))
    return [_resolve(mesh, d, w) for d, w in zip(shape, full)]


def layout(mesh, shape, *spec) -> tuple:
    """The placements of a tensor of ``shape`` laid out as ``spec`` on
    ``mesh``, resolved as `constrain` resolves it."""
    return spec_placements(mesh, _resolved(mesh, shape, spec))


def zeros(shape, dtype, like, *spec):
    """Zeros of ``shape`` on ``like``'s device: a plain tensor, or, when
    ``like`` is a DTensor under an ambient mesh, a DTensor laid out as
    ``spec`` (resolved as `constrain` resolves it)."""
    mesh = _MESH.get()
    if mesh is None or not is_dtensor(like):
        return torch.zeros(shape, dtype=dtype, device=like.device)
    return sharded_zeros(mesh, layout(mesh, shape, *spec), shape, dtype,
                         like.device)


def sharded_cache(cfg, make, like):
    """``make(device)``, a zeroed serving cache, on ``like``'s device; when
    ``like`` is a DTensor under an ambient mesh, every leaf a DTensor laid
    out by the cache rules (`sharding.cache_spec_tree`)."""
    mesh = _MESH.get()
    if mesh is None or not is_dtensor(like):
        return make(like.device)
    from .sharding import cache_spec_tree, sharded_zeros_tree
    shapes = make("meta")
    return sharded_zeros_tree(mesh, cache_spec_tree(cfg, mesh, shapes),
                              shapes, like.device)


def rows_like(t, like, dim: int = 0):
    """A plain tensor ``t`` as a DTensor whose dim ``dim`` is laid out as
    ``like``'s batch dim 0, each rank keeping its own rows of ``t`` (no
    communication): positions made inside a step for a sharded batch."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    placements = [Shard(dim) if isinstance(p, Shard) and p.dim == 0
                  else Replicate() for p in like.placements]
    return distribute_tensor(t, like.device_mesh, placements,
                             src_data_rank=None)
