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

from ..kernels import dtensor_type
from .mesh import axis_names, mesh_shape, spec_placements

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
    if mesh is None or not isinstance(x, dtensor_type()):
        return x
    full = list(spec) + [None] * (x.ndim - len(spec))
    resolved = [_resolve(mesh, d, w) for d, w in zip(x.shape, full)]
    if all(r is None for r in resolved):
        return x
    return x.redistribute(mesh, spec_placements(mesh, resolved))
