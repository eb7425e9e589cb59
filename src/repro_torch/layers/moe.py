"""Mixture-of-Experts FFN with the GShard/Switch einsum dispatch.

The port of ``repro.layers.moe``: a router ``[D, E]`` picks the top-k
experts per token, each expert's buffer holds at most ``cap`` (token, k)
slots in flat (t * K) order, and one-hot dispatch/combine tensors move the
tokens in and out of the stacked expert weights.  `moe_ffn_ep`
(``layers/moe_ep.py``) computes the same function with a sorted
gather/scatter dispatch, and is what olmoe and llama4 run by default.

Expert weights are what the paper's shared pool holds ("sharing of machine
learning model weights (especially in expert models) across hosts", §1):
``examples/torch_serve_shared_experts.py`` fetches them through
``checked_gather``.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .common import normal


class MoE(nn.Module):
    """``router [D, E]`` (f32 by default), ``w_gate``/``w_up`` [E, D, F] and
    ``w_down`` [E, F, D]: the reference's stacked layout."""

    def __init__(self, d: int, f: int, n_experts: int, dtype, generator,
                 device, *, router_dtype=torch.float32):
        super().__init__()
        s_in, s_out = float(1.0 / np.sqrt(d)), float(1.0 / np.sqrt(f))
        self.router = normal((d, n_experts), router_dtype, generator, device,
                             s_in)
        self.w_gate = normal((n_experts, d, f), dtype, generator, device,
                             s_in)
        self.w_up = normal((n_experts, d, f), dtype, generator, device, s_in)
        self.w_down = normal((n_experts, f, d), dtype, generator, device,
                             s_out)


def init_moe(d: int, f: int, n_experts: int, dtype,
             generator: torch.Generator, device=None, *,
             router_dtype=torch.float32) -> MoE:
    """Random expert weights drawn from ``generator`` on ``device``, scaled
    as the reference scales them."""
    return MoE(d, f, n_experts, dtype, generator, device,
               router_dtype=router_dtype)


def capacity(t: int, capacity_factor: float, top_k: int,
             n_experts: int) -> int:
    """Slots per expert: ``max(ceil(t * factor * K / E), 1)``, in Python
    floats as the reference computes it."""
    return max(int(np.ceil(t * capacity_factor * top_k / n_experts)), 1)


def top_k_lowest_index_first(probs, k: int):
    """(values, indices) of the ``k`` largest entries of each row, in
    descending order with the lower index first among equal values: the
    order of ``jax.lax.top_k``, which sets the flat slot order and so which
    slots a binding capacity drops.  A stable descending sort keeps equal
    values in index order; ``torch.topk`` promises no order."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(xt, router, top_k: int):
    """Router softmax and top-k: ``xt [t, D]`` -> (probs [t, E], gate_vals
    [t, K] renormalised over the K picks, gate_idx [t, K])."""
    probs = torch.softmax(xt.to(router.dtype) @ router, dim=-1)
    gate_vals, gate_idx = top_k_lowest_index_first(probs, top_k)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    return probs, gate_vals, gate_idx


def load_balance_loss(probs, gate_idx, n_experts: int):
    """Switch aux loss: ``E * sum(frac_tokens * frac_probs)``."""
    t, k = gate_idx.shape
    idx = gate_idx.reshape(-1).long()
    counts = torch.zeros(n_experts, dtype=torch.int64, device=idx.device) \
        .scatter_add_(0, idx, torch.ones_like(idx))   # bincount, static shape
    frac_tok = counts.to(torch.float32) / (t * k)
    frac_prob = probs.mean(dim=0).to(torch.float32)
    return n_experts * torch.sum(frac_tok * frac_prob)


def moe_ffn(p: MoE, x, *, top_k: int, capacity_factor: float = 1.25):
    """x: [B, S, D] -> (y [B, S, D], aux loss), through one-hot dispatch
    and combine tensors [T, E, C]."""
    b, s, d = x.shape
    e = p.router.shape[1]
    t = b * s
    xt = x.reshape(t, d)
    probs, gate_vals, gate_idx = route(xt, p.router, top_k)
    cap = capacity(t, capacity_factor, top_k, e)

    # position of each (token, k) slot within its expert's buffer
    onehot = F.one_hot(gate_idx.long(), e).to(torch.int32)       # [T, K, E]
    flatoh = onehot.reshape(t * top_k, e)
    pos = (torch.cumsum(flatoh, dim=0) * flatoh - 1).reshape(t, top_k, e)
    within = (pos < cap) & (onehot > 0)
    # jax.nn.one_hot gives a zero row for a position outside [0, cap);
    # torch's one_hot raises there, so mask first
    poh = F.one_hot(torch.where(within, pos, 0).long(), cap).to(x.dtype) \
        * within[..., None].to(x.dtype)                          # [T,K,E,C]
    dispatch = poh.sum(dim=1)                                    # [T, E, C]
    combine = (poh * gate_vals[..., None, None].to(x.dtype)).sum(dim=1)

    expert_in = torch.einsum("tec,td->ecd", dispatch, xt)        # [E, C, D]
    h = F.silu(torch.bmm(expert_in, p.w_gate)) * \
        torch.bmm(expert_in, p.w_up)
    expert_out = torch.bmm(h, p.w_down)                          # [E, C, D]
    y = torch.einsum("tec,ecd->td", combine, expert_out)
    aux = load_balance_loss(probs, gate_idx, e)
    return y.reshape(b, s, d), aux
