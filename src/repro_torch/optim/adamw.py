"""AdamW with the reference's features (the port of ``repro.optim.adamw``):

  * moments in a configurable dtype (bf16 moments halve optimizer memory),
  * global-norm gradient clipping,
  * warmup + cosine schedule,
  * optional int8 gradient compression with stochastic rounding.

Trees are mappings from a parameter's name to its tensor, in the order of
the model's ``named_parameters()``; `AdamWState` keeps ``mu`` and ``nu``
keyed the same way.  `apply_updates` is the reference's arithmetic step for
step (f32 math, moments stored in their dtype, each parameter cast back to
its own dtype) but updates the parameters and moments IN PLACE: at full
width the moments are gigabytes, and a functional copy would double them.
``torch.optim.AdamW`` is not used: it applies weight decay first and
divides ``sqrt(v)`` by ``sqrt(bc2)``, so its updates differ, and it has no
bf16-moment mode.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Mapping, NamedTuple

import numpy as np
import torch
from torch import nn


class AdamWState(NamedTuple):
    step: torch.Tensor          # int32 scalar: updates applied so far
    mu: OrderedDict             # name -> first moment
    nu: OrderedDict             # name -> second moment


def _named(params) -> OrderedDict:
    """A module's parameters, or a mapping, as an ordered name -> tensor
    map."""
    if isinstance(params, nn.Module):
        return OrderedDict(params.named_parameters())
    return OrderedDict(params)


def init_state(params, moment_dtype=torch.float32) -> AdamWState:
    """Zero moments of ``moment_dtype`` beside each parameter (a module or a
    name -> tensor mapping), on the parameters' device."""
    named = _named(params)
    dev = next(iter(named.values())).device if named else None
    zeros = lambda p: torch.zeros(p.shape, dtype=moment_dtype,
                                  device=p.device)
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=dev),
        mu=OrderedDict((k, zeros(p)) for k, p in named.items()),
        nu=OrderedDict((k, zeros(p)) for k, p in named.items()))


def cosine_schedule(step, *, peak_lr: float, warmup: int, total: int,
                    min_ratio: float = 0.1):
    """Linear warmup to ``peak_lr``, then a cosine down to ``min_ratio`` of
    it at ``total`` (f32, as the reference)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = peak_lr * step / max(warmup, 1)
    frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = peak_lr * (min_ratio + (1 - min_ratio) * 0.5 *
                     (1 + torch.cos(np.pi * frac)))
    return torch.where(step < warmup, warm, cos)


def global_norm(tree: Mapping) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's f32 sum of squares."""
    sq = sum(torch.sum(torch.square(x.to(torch.float32)))
             for x in tree.values())
    return torch.sqrt(torch.as_tensor(sq, dtype=torch.float32))


def clip_by_global_norm(grads: Mapping, max_norm: float):
    """(grads scaled by ``min(1, max_norm / norm)`` in f32 and cast back to
    each leaf's dtype, the norm before clipping)."""
    gn = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return OrderedDict((k, (g.to(torch.float32) * scale).to(g.dtype))
                       for k, g in grads.items()), gn


def compress_int8(grads: Mapping, generator: torch.Generator):
    """Stochastic-rounding int8 quantization of gradients (per-leaf scale):
    (q_tree, scales_tree).  The rounding noise is uniform on [-0.5, 0.5)
    drawn from ``generator`` (the reference draws it from a JAX key), so a
    leaf's expected round trip is the leaf itself."""
    qs, scales = OrderedDict(), OrderedDict()
    for k, g in grads.items():
        g32 = g.to(torch.float32)
        s = torch.clamp(torch.max(torch.abs(g32)), min=1e-12) / 127.0
        noise = torch.rand(g.shape, generator=generator, dtype=torch.float32,
                           device=g.device) - 0.5
        qs[k] = torch.clamp(torch.round(g32 / s + noise), -127, 127) \
            .to(torch.int8)
        scales[k] = s
    return qs, scales


def decompress_int8(q_tree: Mapping, scales_tree: Mapping,
                    dtype=torch.float32):
    return OrderedDict((k, (q.to(torch.float32) * scales_tree[k]).to(dtype))
                       for k, q in q_tree.items())


@torch.no_grad()
def apply_updates(params: Mapping, grads: Mapping, state: AdamWState, *, lr,
                  b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                  weight_decay: float = 0.1):
    """One AdamW step, in place: each parameter of ``params`` (name ->
    tensor, e.g. ``model.named_parameters()``) and its moments are
    overwritten.  Returns (params, the new state)."""
    params = _named(params)
    step = state.step + 1
    bc1 = 1 - b1 ** step.to(torch.float32)
    bc2 = 1 - b2 ** step.to(torch.float32)
    for k, p in params.items():
        mu, nu = state.mu[k], state.nu[k]
        g32 = grads[k].to(torch.float32)
        mu32 = mu.to(torch.float32) * b1 + g32 * (1 - b1)
        nu32 = nu.to(torch.float32) * b2 + torch.square(g32) * (1 - b2)
        upd32 = (mu32 / bc1) / (torch.sqrt(nu32 / bc2) + eps)
        upd32 = upd32 + weight_decay * p.to(torch.float32)
        p.copy_(p.to(torch.float32) - lr * upd32)
        mu.copy_(mu32)
        nu.copy_(nu32)
    return params, AdamWState(step, state.mu, state.nu)
