"""Expert-parallel MoE with the sorted (gather/scatter) dispatch — the
default of olmoe and llama4 (``moe_impl="ep"``).

The port of ``repro.layers.moe_ep``.  Where `moe.moe_ffn` builds one-hot
[T, E, C] dispatch tensors, here dispatch is data movement:

  * route: top-k per token, capacity positions by a cumulative count;
  * dispatch: a slot table [E, C] of flat (t * K) slot indices, then one
    gather of the tokens;
  * expert FFN: three batched products over the experts, the only matmuls;
  * combine: each (token, k) slot gathers its expert's output, weighted by
    its gate.

Under an ambient mesh (`launch.activations.use_mesh`) `moe_ffn_ep` runs the
reference's two ``shard_map`` bodies on every rank, with
``torch.distributed`` collectives on the mesh's process groups:

  experts over "model" (olmoe): each rank takes its data shard of the
      tokens and its model column's E/m experts; one ``all_reduce`` over
      "model" sums the columns' outputs.
  experts over "data", per-expert FFN over "model" (llama4): tokens go to
      their expert's home row and back by ``all_to_all_single`` over the
      data axes (flattened with "pod"), with an ``all_reduce`` over
      "model" after ``w_down``.

Every rank holds the whole (replicated) tensors and slices its own part,
as ``shard_map``'s ``in_specs`` would; the output is gathered over the
data axes, as ``out_specs=P(data_axes, None)`` gives a global array.
Where autograd records an operand (training) the collectives are
``torch.distributed.nn.functional``'s, which it differentiates; elsewhere
plain c10d calls.  With binding capacity the drop order is
position-in-shard, as in the reference.  Without a mesh every expert is
local: the reference's meshless branch.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist
import torch.distributed.nn.functional as dist_fn
import torch.nn.functional as F

from ..kernels import is_dtensor
from ..launch.activations import current_mesh
from ..launch.mesh import axis_names, mesh_shape
from .moe import MoE, capacity, load_balance_loss, moe_ffn, route

# Collective calls of the mesh bodies since the last reset, by kind: each
# helper below adds one where it calls its collective.
collectives = {"all_reduce": 0, "all_to_all": 0, "all_gather": 0,
               "broadcast": 0}


def reset_collectives() -> None:
    for kind in collectives:
        collectives[kind] = 0


class MeshAxis(NamedTuple):
    """One mesh axis (or the flattened data axes) as a process group, this
    rank's index along it (``jax.lax.axis_index``) and its size."""
    group: object
    index: int
    size: int


def _mesh_axis(mesh, axes: tuple[str, ...]) -> MeshAxis | None:
    """``axes`` of a ``DeviceMesh`` as one axis, None for no axes; several
    axes (``("pod", "data")``) are flattened in mesh order, as
    ``shard_map`` orders them.  A collective over None is the identity, as
    one over ``()`` is in the reference."""
    if not axes:
        return None
    if len(axes) == 1:
        (a,) = axes
        return MeshAxis(mesh.get_group(a), mesh.get_local_rank(a),
                        mesh.size(mesh.mesh_dim_names.index(a)))
    sub = mesh[axes]._flatten()
    return MeshAxis(sub.get_group(), sub.get_local_rank(), sub.size())


def _recording(x) -> bool:
    """Whether autograd records ``x``: the collective then goes through
    ``torch.distributed.nn.functional``, which differentiates it; else the
    plain c10d call, with no clone and no autograd node."""
    return torch.is_grad_enabled() and x.requires_grad


def _all_reduce(x, axis: MeshAxis | None):
    """``jax.lax.psum`` over the axis (in place on ``x``, a tensor of the
    body's own, where autograd does not record it)."""
    if axis is None:
        return x
    collectives["all_reduce"] += 1
    if _recording(x):
        return dist_fn.all_reduce(x, group=axis.group)
    dist.all_reduce(x, group=axis.group)
    return x


def _pmean(x, axis: MeshAxis | None):
    if axis is None:
        return x
    return _all_reduce(x.reshape(1), axis).reshape(()) / axis.size


def _all_to_all(x, axis: MeshAxis | None):
    """``jax.lax.all_to_all(x, split_axis=0, concat_axis=0, tiled=True)``:
    chunk i of dim 0 goes to the axis' rank i; the chunks received are
    stacked in rank order."""
    if axis is None:
        return x
    collectives["all_to_all"] += 1
    x = x.contiguous()
    out = torch.empty_like(x)
    if _recording(x):
        return dist_fn.all_to_all_single(out, x, group=axis.group)
    dist.all_to_all_single(out, x, group=axis.group)
    return out


def _all_gather(x, axis: MeshAxis | None):
    """The shards of dim 0, concatenated in rank order."""
    if axis is None:
        return x
    collectives["all_gather"] += 1
    x = x.contiguous()
    if _recording(x):
        return torch.cat(dist_fn.all_gather(x, group=axis.group))
    out = x.new_empty((axis.size * x.shape[0], *x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=axis.group)
    return out


def _broadcast_first(x, axis: MeshAxis | None):
    """The axis' rank-0 value on every rank."""
    if axis is None:
        return x
    collectives["broadcast"] += 1
    src = dist.get_global_rank(axis.group, 0)
    x = x.reshape(1).contiguous()
    if _recording(x):
        return dist_fn.broadcast(x, src, group=axis.group).reshape(())
    dist.broadcast(x, src, group=axis.group)
    return x.reshape(())


def _route(xt, router, top_k: int):
    """[t, D] -> (gate_vals [t, K], gate_idx [t, K], aux scalar)."""
    probs, gate_vals, gate_idx = route(xt, router, top_k)
    return gate_vals, gate_idx, load_balance_loss(probs, gate_idx,
                                                  router.shape[1])


def _positions(gate_idx, n_experts: int, cap: int):
    """Each (token, k) slot's position in its expert's buffer, handed out in
    flat (t * K) order: (pos [t, K] int32, valid [t, K] = pos < cap)."""
    t, k = gate_idx.shape
    flat = gate_idx.reshape(t * k).long()
    onehot = F.one_hot(flat, n_experts).to(torch.int32)         # [tK, E]
    pos = torch.cumsum(onehot, dim=0, dtype=torch.int32) - 1
    pos = torch.take_along_dim(pos, flat[:, None], dim=1)[:, 0]
    return pos.reshape(t, k), (pos < cap).reshape(t, k)


def _scatter_token_idx(gate_idx, pos, valid, n_experts: int, cap: int,
                       t: int):
    """The slot table [E, C]: the flat (t * K) index held by each slot;
    empty slots hold t * K (a zero pad row).  Invalid (dropped) slots all
    write one pad entry past the table, which is sliced off, so every
    written index but that one is unique."""
    tk = gate_idx.numel()
    slot = torch.where(valid.reshape(tk),
                       gate_idx.reshape(tk) * cap + pos.reshape(tk),
                       n_experts * cap).long()
    table = torch.full((n_experts * cap + 1,), tk, dtype=torch.int32,
                       device=gate_idx.device)
    table[slot] = torch.arange(tk, dtype=torch.int32, device=table.device)
    return table[:n_experts * cap].reshape(n_experts, cap)


def _expert_ffn(expert_in, wg, wu, wd):
    """[E, C, D] x [E, D, F] -> [E, C, D]: SwiGLU per expert (the useful
    FLOPs)."""
    h = F.silu(torch.bmm(expert_in, wg)) * torch.bmm(expert_in, wu)
    return torch.bmm(h, wd)


def _moe_block_model_axis(xt, router, wg, wu, wd, *, top_k: int, cap: int,
                          n_experts: int, model_axis: MeshAxis | None = None):
    """The reference's shard_map body for experts over "model".  xt [t, D]
    (this data shard's tokens, the same on every model column); wg/wu/wd
    [E_loc, ...] (this column's experts; all of them without a model
    axis).  -> (y [t, D], aux)."""
    t, d = xt.shape
    e_loc = wg.shape[0]
    j = model_axis.index if model_axis else 0
    e0 = j * e_loc
    gate_vals, gate_idx, aux = _route(xt, router, top_k)
    pos, valid = _positions(gate_idx, n_experts, cap)
    token_idx = _scatter_token_idx(gate_idx, pos, valid, n_experts, cap, t)
    token_idx = token_idx[e0:e0 + e_loc]

    # the reference gathers from xt repeated K times plus a zero pad row;
    # flat slot i holds token i // K, and the pad index t * K maps to row
    # t, so the gather reads the same rows without the K-fold copy
    xt_pad = torch.cat([xt, xt.new_zeros((1, d))])
    expert_in = xt_pad[(token_idx // top_k).long()]              # [E_loc,C,D]
    expert_out = _expert_ffn(expert_in, wg, wu, wd)              # [E_loc,C,D]

    # combine: a (t, k) slot fetches its output if its expert is local
    local = (gate_idx // e_loc == j) & valid                     # [t, K]
    slot = torch.where(local, (gate_idx - e0) * cap + pos,
                       e_loc * cap).long()
    out_flat = torch.cat([expert_out.reshape(e_loc * cap, d),
                          expert_out.new_zeros((1, d))])
    per_k = out_flat[slot]                                       # [t, K, D]
    w = gate_vals.to(per_k.dtype) * local.to(per_k.dtype)
    y = torch.einsum("tkd,tk->td", per_k, w)
    return _all_reduce(y, model_axis), _pmean(aux, model_axis)


def _moe_block_data_axis(xt, router, wg, wu, wd, *, top_k: int, cap: int,
                         n_experts: int, data_axis: MeshAxis,
                         model_axis: MeshAxis | None):
    """The reference's shard_map body for experts over the data axes.  xt
    [t, D] per data shard (the same on every model column); wg/wu/wd
    [E_loc, D, F_loc] (this data row's experts and, when ``model_axis`` is
    given, this model column's FFN slice).  -> (y [t, D], aux)."""
    t, d = xt.shape
    e_loc = wg.shape[0]
    rows = n_experts // e_loc                     # data-axis size

    gate_vals, gate_idx, aux = _route(xt, router, top_k)
    dest = gate_idx // e_loc                      # [t, K] home row per slot

    # per-destination-row send positions (capacity per row)
    send_cap = cap * e_loc
    pos_r, valid_r = _positions(dest, rows, send_cap)

    # pack [rows, send_cap] of flat (t * K) indices; the pad index t * K
    # reads the zero row t of xt_pad and the pad expert id e_loc
    table = _scatter_token_idx(dest, pos_r, valid_r, rows, send_cap, t)
    xt_pad = torch.cat([xt, xt.new_zeros((1, d))])
    send = xt_pad[(table // top_k).long()]                       # [R, S, D]
    eid_pairs = torch.cat([(gate_idx % e_loc).reshape(-1).to(torch.int32),
                           gate_idx.new_full((1,), e_loc, dtype=torch.int32)])
    send_eid = eid_pairs[table.long()]                           # [R, S]
    send_valid = (table < t * top_k).to(torch.int32)             # [R, S]

    # all_to_all over the data axes: row dim <-> shard dim
    recv = _all_to_all(send, data_axis).reshape(rows * send_cap, d)
    recv_eid = _all_to_all(send_eid, data_axis).reshape(rows * send_cap)
    recv_valid = _all_to_all(send_valid, data_axis) \
        .reshape(rows * send_cap).bool()

    # second-level dispatch to my e_loc experts
    recv_eid = torch.where(recv_valid, recv_eid, e_loc)
    pos2, valid2 = _positions(recv_eid[:, None], e_loc + 1, cap * rows)
    pos2, valid2 = pos2[:, 0], valid2[:, 0]
    n2 = recv.shape[0]
    mine = valid2 & (recv_eid < e_loc)
    slot2 = torch.where(mine, recv_eid * (cap * rows) + pos2,
                        e_loc * cap * rows).long()
    table2 = torch.full((e_loc * cap * rows + 1,), n2, dtype=torch.int32,
                        device=xt.device)
    table2[slot2] = torch.arange(n2, dtype=torch.int32, device=xt.device)
    table2 = table2[:e_loc * cap * rows].reshape(e_loc, cap * rows)
    recv_pad = torch.cat([recv, recv.new_zeros((1, d))])
    expert_in = recv_pad[table2.long()]                          # [E_loc,C',D]

    out = _expert_ffn(expert_in, wg, wu, wd)
    out = _all_reduce(out, model_axis)       # partial sums of w_down

    # route outputs back to origin rows
    out_flat = torch.cat([out.reshape(e_loc * cap * rows, d),
                          out.new_zeros((1, d))])
    back = out_flat[slot2]                                       # [R*S, D]
    ret = _all_to_all(back.reshape(rows, send_cap, d), data_axis)

    # combine at origin: slot (t, k) sits at ret[dest, pos_r]
    flat_back = torch.cat([ret.reshape(rows * send_cap, d),
                           ret.new_zeros((1, d))])
    slot_tk = torch.where(valid_r, dest * send_cap + pos_r,
                          rows * send_cap).long()
    per_k = flat_back[slot_tk]                                   # [t, K, D]
    w = gate_vals.to(per_k.dtype) * valid_r.to(per_k.dtype)
    y = torch.einsum("tkd,tk->td", per_k, w)
    return y, _pmean(_pmean(aux, data_axis), model_axis)


def moe_ffn_ep(p: MoE, x, *, top_k: int, capacity_factor: float = 1.25,
               expert_axis: str = "model"):
    """Drop-in for `moe.moe_ffn` (same parameters, same returns) through the
    sorted dispatch, expert-parallel under the ambient mesh.  Without a
    mesh every expert is local (the single-device shard_map)."""
    if expert_axis not in ("model", "data"):
        raise ValueError(f"expert_axis {expert_axis!r} is not 'model' or "
                         "'data'")
    b, s, d = x.shape
    e = p.router.shape[1]
    mesh = current_mesh()

    if mesh is None:
        t = b * s
        y, aux = _moe_block_model_axis(
            x.reshape(t, d), p.router, p.w_gate, p.w_up, p.w_down,
            top_k=top_k, cap=capacity(t, capacity_factor, top_k, e),
            n_experts=e)
        return y.reshape(b, s, d), aux

    if is_dtensor(x):
        return _moe_ffn_ep_dtensor(p, x, mesh, top_k=top_k,
                                   capacity_factor=capacity_factor,
                                   expert_axis=expert_axis)
    names, shape = axis_names(mesh), mesh_shape(mesh)
    data_axes = tuple(a for a in ("pod", "data") if a in names)
    has_model = "model" in names
    dsize = int(np.prod([shape[a] for a in data_axes]))
    msize = shape["model"] if has_model else 1

    t_loc = (b * s) // dsize if (b * s) % dsize == 0 else b * s
    cap = capacity(t_loc, capacity_factor, top_k, e)
    xt = x.reshape(b * s, d)
    batch_ok = (b * s) % dsize == 0

    if expert_axis == "model" and has_model and e % msize == 0 and batch_ok:
        data = _mesh_axis(mesh, data_axes)
        model = _mesh_axis(mesh, ("model",))
        e_loc = e // msize
        ex = slice(model.index * e_loc, (model.index + 1) * e_loc)
        y, aux = _moe_block_model_axis(
            _data_shard(xt, data), p.router, p.w_gate[ex], p.w_up[ex],
            p.w_down[ex], top_k=top_k, cap=cap, n_experts=e,
            model_axis=model)
        # out_specs=P() declares aux replicated, but this body makes it so
        # only over "model": the global array holds the first data shard's
        # value, which every rank returns
        return (_all_gather(y, data).reshape(b, s, d),
                _broadcast_first(aux, data))

    if expert_axis == "data" and e % dsize == 0 and batch_ok:
        data = _mesh_axis(mesh, data_axes)
        model = _mesh_axis(mesh, ("model",)) if has_model else None
        split_ffn = model is not None and p.w_gate.shape[-1] % msize == 0
        e_loc = e // dsize
        row = data.index if data else 0
        ex = slice(row * e_loc, (row + 1) * e_loc)
        wg, wu, wd = p.w_gate[ex], p.w_up[ex], p.w_down[ex]
        if split_ffn:
            f_loc = wg.shape[-1] // msize
            ff = slice(model.index * f_loc, (model.index + 1) * f_loc)
            wg, wu, wd = wg[..., ff], wu[..., ff], wd[:, ff]
        # the reference sums over "model" after w_down even when the FFN
        # is not split, which multiplies the output by the axis size
        # (ROADMAP defect 9): the port sums only the slices of a split FFN
        y, aux = _moe_block_data_axis(
            _data_shard(xt, data), p.router, wg, wu, wd, top_k=top_k,
            cap=cap, n_experts=e, data_axis=data,
            model_axis=model if split_ffn else None)
        if not split_ffn:
            aux = _pmean(aux, model)
        return _all_gather(y, data).reshape(b, s, d), aux

    # layout not expressible on this mesh: einsum fallback
    return moe_ffn(p, x, top_k=top_k, capacity_factor=capacity_factor)


def _moe_ffn_ep_dtensor(p: MoE, x, mesh, *, top_k: int,
                        capacity_factor: float, expert_axis: str):
    """`moe_ffn_ep` of DTensor operands: the same shard_map bodies under
    ``local_map``, which hands each rank its data shard of the tokens and
    its experts (and FFN slice) of the weights, as ``shard_map``'s
    ``in_specs`` do; the output stays sharded over the data axes.  Layouts
    the mesh cannot express raise (the einsum fallback needs
    ``bincount``, which DTensor lacks)."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    b, s, d = x.shape
    e = p.router.shape[1]
    names, shape = axis_names(mesh), mesh_shape(mesh)
    data_axes = tuple(a for a in ("pod", "data") if a in names)
    dsize = int(np.prod([shape[a] for a in data_axes]))
    msize = shape.get("model", 1)
    if (b * s) % dsize:
        raise ValueError(f"{b * s} tokens do not divide over the data axes "
                         f"{data_axes} ({dsize})")
    cap = capacity((b * s) // dsize, capacity_factor, top_k, e)

    def lay(**dims):
        """Placements: axis name -> tensor dim sharded over it."""
        return tuple(Shard(dims[a]) if a in dims else Replicate()
                     for a in names)

    tokens = lay(**{a: 0 for a in data_axes})
    whole = lay()
    if expert_axis == "model" and "model" in names and e % msize == 0:
        model = _mesh_axis(mesh, ("model",))
        body = lambda xt, router, wg, wu, wd: _moe_block_model_axis(
            xt, router, wg, wu, wd, top_k=top_k, cap=cap, n_experts=e,
            model_axis=model)
        experts = (lay(model=0),) * 3
    elif expert_axis == "data" and e % dsize == 0:
        data = _mesh_axis(mesh, data_axes)
        model = _mesh_axis(mesh, ("model",)) if "model" in names else None
        split = model is not None and p.w_gate.shape[-1] % msize == 0
        ex = {a: 0 for a in data_axes}
        experts = (lay(**ex, model=2), lay(**ex, model=2),
                   lay(**ex, model=1)) if split else (lay(**ex),) * 3

        def body(xt, router, wg, wu, wd):
            y, aux = _moe_block_data_axis(
                xt, router, wg, wu, wd, top_k=top_k, cap=cap, n_experts=e,
                data_axis=data, model_axis=model if split else None)
            return y, aux if split else _pmean(aux, model)
    else:
        raise ValueError(f"no expert-parallel layout for {e} experts over "
                         f"{expert_axis!r} on the mesh {shape}")
    y, aux = local_map(
        body, out_placements=(tokens, whole),
        in_placements=(tokens, whole) + experts, device_mesh=mesh,
        redistribute_inputs=True)(
        x.reshape(b * s, d), p.router, p.w_gate, p.w_up, p.w_down)
    return y.reshape(b, s, d), aux


def _data_shard(xt, data: MeshAxis | None):
    """This rank's rows of ``xt`` along the data axes (``in_specs`` P(data,
    None))."""
    if data is None:
        return xt
    t_loc = xt.shape[0] // data.size
    return xt[data.index * t_loc:(data.index + 1) * t_loc]
