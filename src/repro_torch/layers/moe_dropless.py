"""Dropless MoE with the sorted dispatch: every (token, expert) slot is
computed, none dropped (granite's ``block_sparse_moe``).

The capacity dispatches (`moe.moe_ffn`, `moe_ep.moe_ffn_ep`) give each
expert ``cap`` slots and drop the rest: at decode, capacity 1.25 leaves 3
slots an expert for 16 tokens at top-10 of 72, and a cap wide enough for
every slot of a 32k-token prefill is a [72, t, 4096] buffer.  Here:

  * route: the router's top-k per token (`moe.route`: the softmax over the
    k picks' logits, as granite's gates);
  * sort: the t * K slots sorted by expert (stable), each expert's slots
    one contiguous segment, ``offsets [E + 1]`` its bounds;
  * expert FFN: each expert once over its segment: the grouped kernel
    (`kernels.moe_grouped_ffn`) on the card, the per-expert loop
    (`moe_grouped_ffn_plain`) on the CPU;
  * combine: each token gathers its K slots' outputs back out of sorted
    order and sums them weighted by their gates.

Only the slot count and the expert bounds depend on the routing; nothing is
read back to the host on the card.  A prefill runs in chunks of
``PREFILL_CHUNK`` tokens: a dropless MoE is token by token, so the chunks
give the same result with a bounded buffer.
"""
from __future__ import annotations

import torch

from .. import tracing
from ..kernels.moe_grouped_ffn import moe_grouped_ffn
from .moe import MoE, route

PREFILL_CHUNK = 8192


def sort_slots(gate_idx, n_experts: int):
    """Slots sorted by expert: (order [t * K] the flat slot index of each
    sorted slot, tok [t * K] int32 its token, offsets [E + 1] int32,
    counts [E] slots an expert)."""
    t, k = gate_idx.shape
    flat = gate_idx.reshape(-1).long()
    order = torch.argsort(flat, stable=True)
    counts = torch.zeros(n_experts, dtype=torch.int64, device=flat.device) \
        .scatter_add_(0, flat, torch.ones_like(flat))
    offsets = torch.zeros(n_experts + 1, dtype=torch.int32,
                          device=flat.device)
    offsets[1:] = torch.cumsum(counts, 0)
    return order, (order // k).to(torch.int32), offsets, counts


def _dispatch(p: MoE, xt, top_k: int, hits=None):
    t, d = xt.shape
    _, gate_vals, gate_idx = route(xt, p.router, top_k)
    order, tok, offsets, counts = sort_slots(gate_idx, p.router.shape[1])
    if hits is not None:
        hits.add_((counts > 0).sum())
    elif tracing.counting():
        tracing.count("moe.slots", t * top_k)
        tracing.count("moe.experts_hit", (counts > 0).sum())
    with tracing.span("moe.grouped_ffn"):
        y_sorted = moe_grouped_ffn(xt, tok, offsets, p.w_gate, p.w_up,
                                   p.w_down)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.numel(), device=order.device)
    y = y_sorted[inv] * gate_vals.reshape(-1, 1).to(y_sorted.dtype)
    return y.reshape(t, top_k, d).sum(dim=1).to(xt.dtype), gate_idx


def moe_ffn_dropless(p: MoE, x, *, top_k: int, hits=None):
    """x: [B, S, D] -> (y [B, S, D], each token's experts [B, S, K]), every
    slot computed.  ``hits``, a device scalar, takes the count of experts
    with a slot in place of the counter ``moe.experts_hit`` (a CUDA
    graph's own count)."""
    b, s, d = x.shape
    xt = x.reshape(b * s, d).contiguous()
    y, idx = zip(*(_dispatch(p, xt[i:i + PREFILL_CHUNK], top_k, hits)
                   for i in range(0, b * s, PREFILL_CHUNK)))
    y, idx = torch.cat(y), torch.cat(idx)
    return y.reshape(b, s, d), idx.reshape(b, s, top_k)
