"""Step functions of the launcher (the port of ``repro.launch.steps``).

  train_step   : loss + grad + clip + AdamW update
  prefill_step : no-grad forward building the serving cache
  serve_step   : one-token decode against the cache

The reference jits pure functions of (params, state, batch); here the model
is an ``nn.Module`` that `train_step` updates in place (its gradients land
in each parameter's ``.grad``), and the optimizer state is returned anew.
"""
from __future__ import annotations

import math
from collections import OrderedDict

import torch

from ..configs.base import ArchConfig
from ..kernels import is_dtensor
from ..models import registry
from ..optim import (AdamWState, apply_updates, clip_by_global_norm,
                     cosine_schedule, init_state)


def _microbatches(batch: dict, k: int) -> list[dict]:
    """Split a global batch into k equal microbatches along the batch dim
    (dim 1 for M-RoPE 'positions' [3, B, S], dim 0 otherwise).  A DTensor
    batch is split on each rank's own rows, so every microbatch stays
    sharded over the data axes (the reference's scan over microbatches
    keeps the batch sharding)."""
    parts = {name: _chunk(x, k, 1 if name == "positions" else 0)
             for name, x in batch.items()}
    return [{name: p[i] for name, p in parts.items()} for i in range(k)]


def _chunk(x, k: int, dim: int):
    if not is_dtensor(x):
        return torch.chunk(x, k, dim=dim)
    from torch.distributed.tensor import DTensor

    from .mesh import contiguous_stride
    shape = list(x.shape)
    shape[dim] //= k
    return [DTensor.from_local(part, x.device_mesh, x.placements,
                               run_check=False, shape=torch.Size(shape),
                               stride=contiguous_stride(shape))
            for part in torch.chunk(x.to_local(), k, dim=dim)]


def _grads_of(cfg: ArchConfig, model, params: OrderedDict, batch: dict):
    """Backward of the loss on ``batch``; every parameter's ``.grad`` is
    set anew.  Returns the loss metrics (detached)."""
    for p in params.values():
        p.grad = None
    loss, metrics = registry.loss_fn(cfg, model, batch)
    loss.backward()
    missing = [n for n, p in params.items() if p.grad is None]
    if missing:
        raise RuntimeError(f"no gradient reached {missing[:4]} "
                           f"({len(missing)} parameters)")
    return {k: torch.as_tensor(v).detach() for k, v in metrics.items()}


def build_train_step(cfg: ArchConfig, *, peak_lr: float = 3e-4,
                     warmup: int = 2000, total_steps: int = 100_000,
                     max_grad_norm: float = 1.0,
                     grad_accum: int | None = None):
    """``train_step(model, opt_state, batch) -> (opt_state, metrics)``.

    The model's parameters are made trainable and updated in place.
    ``grad_accum`` k > 1 runs k microbatches and sums their gradients in
    f32 (peak activation memory drops ~1/k at identical math: the mean
    token loss over equal microbatches); a batch that k does not divide,
    or smaller than k, falls back to k = 1 as the reference's does.  A
    DTensor batch is split on each rank's own rows (`_microbatches`), into
    gcd(k, local rows) microbatches: where the data axes leave a rank fewer
    rows than k, each microbatch is one local row."""
    k = grad_accum if grad_accum is not None else cfg.grad_accum

    def train_step(model, opt_state: AdamWState, batch: dict):
        model.requires_grad_(True)
        params = OrderedDict(model.named_parameters())
        b = batch["tokens"].shape[0]
        kk = k if k > 1 and b % k == 0 and b >= k else 1
        if is_dtensor(batch["tokens"]):
            kk = math.gcd(k, batch["tokens"].to_local().shape[0])
        if kk > 1:
            g_sum = OrderedDict((n, torch.zeros_like(
                p, dtype=torch.float32, memory_format=torch.contiguous_format))
                                for n, p in params.items())
            per_micro = []
            for mb in _microbatches(batch, kk):
                per_micro.append(_grads_of(cfg, model, params, mb))
                for n, p in params.items():
                    g_sum[n] += p.grad.to(torch.float32)
            grads = OrderedDict((n, g / kk) for n, g in g_sum.items())
            metrics = {m: torch.stack([pm[m] for pm in per_micro]).mean()
                       for m in per_micro[0]}
        else:
            metrics = _grads_of(cfg, model, params, batch)
            grads = OrderedDict((n, p.grad) for n, p in params.items())
        grads, gnorm = clip_by_global_norm(grads, max_grad_norm)
        lr = cosine_schedule(opt_state.step, peak_lr=peak_lr, warmup=warmup,
                             total=total_steps)
        _, opt_state = apply_updates(params, grads, opt_state, lr=lr)
        return opt_state, dict(metrics, grad_norm=gnorm, lr=lr)

    return train_step


def build_prefill_step(cfg: ArchConfig):
    @torch.no_grad()
    def prefill_step(model, batch):
        logits, cache = registry.prefill(cfg, model, batch)
        return logits, cache

    return prefill_step


def build_serve_step(cfg: ArchConfig):
    @torch.no_grad()
    def serve_step(model, cache, tokens, pos):
        logits, new_cache = registry.decode_step(cfg, model, cache, tokens,
                                                 pos)
        return logits, new_cache

    return serve_step


def opt_state_shapes(cfg: ArchConfig, param_shapes=None) -> AdamWState:
    """The optimizer state on the meta device (shapes and dtypes, no
    allocation) for ``param_shapes`` (default `registry.param_shapes`)."""
    model = param_shapes if param_shapes is not None \
        else registry.param_shapes(cfg)
    return init_state(model, moment_dtype=getattr(torch, cfg.moment_dtype))
