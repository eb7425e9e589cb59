"""Attention-free Mamba1 LM (falcon-mamba-7b).

The port of ``repro.models.ssm``: one `MambaBlock` per layer (pre-norm,
residual), the cache a list of per-layer `MambaCache`s, O(1) in the
context length, so `prefill` takes no capacity.  No kernel runs here: the
reference computes the scan and the convs outside any Pallas kernel.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..configs.base import ArchConfig
from ..kernels import resolve_device
from ..layers.common import (apply_remat, cross_entropy, embed,
                             final_logits, init_rms_norm, normal, rms_norm)
from ..layers.mamba import MambaCache, init_mamba1, init_mamba1_cache, mamba1


class MambaBlock(nn.Module):
    """``x + mamba(ln(x))``."""

    def __init__(self, cfg: ArchConfig, generator, device):
        super().__init__()
        self.ln = init_rms_norm(cfg.d_model, cfg.pdtype, device)
        self.mamba = init_mamba1(cfg.d_model, d_state=cfg.ssm_state,
                                 expand=cfg.ssm_expand, conv_w=cfg.ssm_conv,
                                 dtype=cfg.pdtype, generator=generator,
                                 device=device)

    def forward(self, x, cache: MambaCache | None):
        y, cache = mamba1(self.mamba, rms_norm(self.ln, x), cache)
        return x + y, cache


class MambaLM(nn.Module):
    """Token table ``tok``, the blocks, the final norm and the untied head
    ``head_w`` (None when tied)."""

    def __init__(self, cfg: ArchConfig, generator: torch.Generator, device):
        super().__init__()
        dt = cfg.pdtype
        self.tok = normal((cfg.vocab_padded, cfg.d_model), dt, generator,
                          device, 0.02)
        self.blocks = nn.ModuleList(MambaBlock(cfg, generator, device)
                                    for _ in range(cfg.n_layers))
        self.final_norm = init_rms_norm(cfg.d_model, dt, device)
        self.head_w = None if cfg.tie_embeddings else normal(
            (cfg.d_model, cfg.vocab_padded), dt, generator, device,
            float(1.0 / np.sqrt(cfg.d_model)))


def init_params(cfg: ArchConfig, generator: torch.Generator,
                device=None) -> MambaLM:
    """Random parameters drawn from ``generator`` on ``device`` (default
    CUDA)."""
    return MambaLM(cfg, generator, resolve_device(device))


def init_cache(cfg: ArchConfig, batch: int, cap: int = 0,
               dtype=torch.bfloat16, device=None) -> list[MambaCache]:
    """SSM state cache (capacity-free — O(1) in context length): one
    `MambaCache` per layer on ``device`` (default CUDA)."""
    dev = resolve_device(device)
    di = cfg.ssm_expand * cfg.d_model
    return [init_mamba1_cache(batch, di, cfg.ssm_state, cfg.ssm_conv, dtype,
                              dev) for _ in range(cfg.n_layers)]


def _run_blocks(params: MambaLM, x, cache, remat: str = "none"):
    """Run the blocks in order; without a cache (training) each block runs
    under the ``remat`` policy."""
    if cache is None:
        for block in params.blocks:
            x, _ = apply_remat(block, remat)(x, None)
        return x, None
    new_cache = []
    for i, block in enumerate(params.blocks):
        x, c = block(x, cache[i])
        new_cache.append(c)
    return x, new_cache


def forward(cfg: ArchConfig, params: MambaLM, tokens, **_):
    """tokens [B, S] -> (logits [B, S, V], aux 0)."""
    x = embed(params.tok, tokens).to(cfg.pdtype)
    x, _ = _run_blocks(params, x, None, cfg.remat)
    return final_logits(params, x, tied=cfg.tie_embeddings), \
        torch.zeros((), dtype=torch.float32, device=x.device)


def loss_fn(cfg: ArchConfig, params: MambaLM, batch: dict):
    """(mean token cross-entropy, {"loss"}) of ``batch["tokens"]`` against
    ``batch["labels"]``."""
    logits, _ = forward(cfg, params, batch["tokens"])
    loss = cross_entropy(logits, batch["labels"])
    return loss, {"loss": loss}


def prefill(cfg: ArchConfig, params: MambaLM, tokens,
            cache_dtype=torch.bfloat16, **_):
    """(last-token logits [B, 1, V], cache); a ``cap`` is ignored."""
    x = embed(params.tok, tokens).to(cfg.pdtype)
    cache = init_cache(cfg, tokens.shape[0], dtype=cache_dtype,
                       device=tokens.device)
    x, cache = _run_blocks(params, x, cache)
    return final_logits(params, x[:, -1:], tied=cfg.tie_embeddings), cache


def decode_step(cfg: ArchConfig, params: MambaLM, cache, tokens, pos):
    """One token per row; the SSM state carries the position."""
    del pos
    x = embed(params.tok, tokens).to(cfg.pdtype)
    x, cache = _run_blocks(params, x, cache)
    return final_logits(params, x, tied=cfg.tie_embeddings), cache
