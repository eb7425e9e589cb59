"""MoE with the sorted (gather/scatter) dispatch — the default of olmoe and
llama4 (``moe_impl="ep"``).

The port of ``repro.layers.moe_ep``.  Where `moe.moe_ffn` builds one-hot
[T, E, C] dispatch tensors, here dispatch is data movement:

  * route: top-k per token, capacity positions by a cumulative count;
  * dispatch: a slot table [E, C] of flat (t * K) slot indices, then one
    gather of the tokens;
  * expert FFN: three batched products over the experts, the only matmuls;
  * combine: each (token, k) slot gathers its expert's output, weighted by
    its gate.

The reference runs this as a ``shard_map`` body with experts over the
"model" axis (olmoe) or over "data" with the FFN over "model" (llama4).
The port has no mesh yet (ROADMAP Queue 1 item f), so `moe_ffn_ep` runs
the body with every expert local — the reference's meshless branch, which
is the same function on one device.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .moe import MoE, capacity, load_balance_loss, route


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
                          n_experts: int):
    """The reference's shard_map body with ``model_axis=None``: every expert
    is local.  xt [t, D] -> (y [t, D], aux)."""
    t, d = xt.shape
    gate_vals, gate_idx, aux = _route(xt, router, top_k)
    pos, valid = _positions(gate_idx, n_experts, cap)
    token_idx = _scatter_token_idx(gate_idx, pos, valid, n_experts, cap, t)

    # the reference gathers from xt repeated K times plus a zero pad row;
    # flat slot i holds token i // K, and the pad index t * K maps to row
    # t, so the gather reads the same rows without the K-fold copy
    xt_pad = torch.cat([xt, xt.new_zeros((1, d))])
    expert_in = xt_pad[(token_idx // top_k).long()]              # [E, C, D]
    expert_out = _expert_ffn(expert_in, wg, wu, wd)              # [E, C, D]

    # combine: each valid (t, k) slot fetches its expert's output
    slot = torch.where(valid, gate_idx * cap + pos, n_experts * cap).long()
    out_flat = torch.cat([expert_out.reshape(n_experts * cap, d),
                          expert_out.new_zeros((1, d))])
    per_k = out_flat[slot]                                       # [t, K, D]
    w = gate_vals.to(per_k.dtype) * valid.to(per_k.dtype)
    return torch.einsum("tkd,tk->td", per_k, w), aux


def moe_ffn_ep(p: MoE, x, *, top_k: int, capacity_factor: float = 1.25,
               expert_axis: str = "model"):
    """Drop-in for `moe.moe_ffn` (same parameters, same returns) through the
    sorted dispatch.  ``expert_axis`` names the reference's mesh layout;
    without a mesh every layout runs the same local body."""
    if expert_axis not in ("model", "data"):
        raise ValueError(f"expert_axis {expert_axis!r} is not 'model' or "
                         "'data'")
    b, s, d = x.shape
    e = p.router.shape[1]
    t = b * s
    y, aux = _moe_block_model_axis(
        x.reshape(t, d), p.router, p.w_gate, p.w_up, p.w_down, top_k=top_k,
        cap=capacity(t, capacity_factor, top_k, e), n_experts=e)
    return y.reshape(b, s, d), aux
