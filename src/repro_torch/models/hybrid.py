"""Zamba2-style hybrid: a Mamba2 backbone plus one shared attention block
applied after every ``shared_attn_every`` SSM blocks (weights shared
across applications; per-application LoRA omitted, as in the reference).

The port of ``repro.models.hybrid``: G groups of (``shared_attn_every``
Mamba2 blocks + one application of the shared block) and a tail of
leftover Mamba2 blocks.  Each application owns its KV cache:

    cache = {"groups": [[Mamba2Cache] * per group] * G,
             "attn":   [KVCache] * G,
             "tail":   [Mamba2Cache] * tail}          # "tail" only if any

Long context: the shared attention uses the sliding window
``attn_window_long`` when the prompt exceeds it, and beyond 64k the
attention cache becomes a ring buffer of that window.  On the card every
application attends through the flash kernel (the block's ``attn``).
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..configs.base import ArchConfig
from ..kernels import resolve_device
from ..layers.attention import init_attention, init_kv_cache
from ..layers.common import (SwiGLU, apply_remat, cross_entropy, embed,
                             final_logits, init_rms_norm, normal, rms_norm,
                             swiglu)
from ..launch.activations import sharded_cache
from ..layers.mamba import init_mamba2, init_mamba2_cache, mamba2
from .lm import default_positions


def group_layout(cfg: ArchConfig) -> tuple[int, int, int]:
    """(n_groups, blocks_per_group, tail_blocks)."""
    bpg = cfg.shared_attn_every
    g = cfg.n_layers // bpg
    return g, bpg, cfg.n_layers - g * bpg


class Mamba2Block(nn.Module):
    """``x + mamba2(ln(x))``."""

    def __init__(self, cfg: ArchConfig, generator, device):
        super().__init__()
        self.ln = init_rms_norm(cfg.d_model, cfg.pdtype, device)
        self.mamba = init_mamba2(cfg.d_model, d_state=cfg.ssm_state,
                                 expand=cfg.ssm_expand,
                                 head_dim=cfg.ssm_head_dim,
                                 conv_w=cfg.ssm_conv, dtype=cfg.pdtype,
                                 generator=generator, device=device)

    def forward(self, cfg: ArchConfig, x, cache):
        y, cache = mamba2(self.mamba, rms_norm(self.ln, x), cache,
                          head_dim=cfg.ssm_head_dim)
        return x + y, cache


class SharedAttn(nn.Module):
    """The shared block: ``x + attn(ln1(x))``, then ``x + mlp(ln2(x))``
    (full rotary, no bias, no qk-norm)."""

    def __init__(self, cfg: ArchConfig, generator, device):
        super().__init__()
        dt = cfg.pdtype
        self.ln1 = init_rms_norm(cfg.d_model, dt, device)
        self.attn = init_attention(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                                   cfg.head_dim, dt, generator, device)
        self.ln2 = init_rms_norm(cfg.d_model, dt, device)
        self.mlp = SwiGLU(cfg.d_model, cfg.d_ff, dt, generator, device)

    def forward(self, cfg: ArchConfig, x, positions, cache, cache_pos,
                window: int):
        att, cache = self.attn(rms_norm(self.ln1, x), positions,
                               theta=cfg.rope_theta, window=window,
                               cache=cache, cache_pos=cache_pos)
        x = x + att
        return x + swiglu(self.mlp, rms_norm(self.ln2, x)), cache


class HybridLM(nn.Module):
    """Token table, ``groups`` (G lists of Mamba2 blocks), the shared
    attention block, the ``tail`` blocks, the final norm and the untied
    head ``head_w`` (None when tied)."""

    def __init__(self, cfg: ArchConfig, generator: torch.Generator, device):
        super().__init__()
        g, bpg, tail = group_layout(cfg)
        dt = cfg.pdtype
        self.tok = normal((cfg.vocab_padded, cfg.d_model), dt, generator,
                          device, 0.02)
        self.groups = nn.ModuleList(
            nn.ModuleList(Mamba2Block(cfg, generator, device)
                          for _ in range(bpg)) for _ in range(g))
        self.shared_attn = SharedAttn(cfg, generator, device)
        self.tail = nn.ModuleList(Mamba2Block(cfg, generator, device)
                                  for _ in range(tail))
        self.final_norm = init_rms_norm(cfg.d_model, dt, device)
        self.head_w = None if cfg.tie_embeddings else normal(
            (cfg.d_model, cfg.vocab_padded), dt, generator, device,
            float(1.0 / np.sqrt(cfg.d_model)))


def init_params(cfg: ArchConfig, generator: torch.Generator,
                device=None) -> HybridLM:
    """Random parameters drawn from ``generator`` on ``device`` (default
    CUDA)."""
    return HybridLM(cfg, generator, resolve_device(device))


def _mamba_cache_unit(cfg: ArchConfig, batch: int, dtype, device):
    di = cfg.ssm_expand * cfg.d_model
    nh = di // cfg.ssm_head_dim
    return init_mamba2_cache(batch, di, cfg.ssm_state, nh, cfg.ssm_head_dim,
                             cfg.ssm_state, cfg.ssm_conv, dtype, device)


def init_cache(cfg: ArchConfig, batch: int, cap: int, dtype=torch.bfloat16,
               device=None) -> dict:
    """Zeroed caches on ``device`` (default CUDA).  Beyond 64k the shared
    attention's cache is a ring buffer of the sliding window; below, it
    holds the full context."""
    dev = resolve_device(device)
    g, bpg, tail = group_layout(cfg)
    attn_cap = cfg.attn_window_long if cap > 65536 else cap
    mc = lambda: _mamba_cache_unit(cfg, batch, dtype, dev)
    cache = {"groups": [[mc() for _ in range(bpg)] for _ in range(g)],
             "attn": [init_kv_cache(batch, cfg.n_kv_heads, attn_cap,
                                    cfg.head_dim, dtype, dev)
                      for _ in range(g)]}
    if tail:
        cache["tail"] = [mc() for _ in range(tail)]
    return cache


def _attn_window(cfg: ArchConfig, cap: int) -> int:
    return cfg.attn_window_long if cap > cfg.attn_window_long else -1


def _mamba_run(cfg: ArchConfig, blocks, x, caches):
    """Run Mamba2 blocks in order; without a cache (training) each runs
    under ``cfg.remat``."""
    if caches is None:
        for block in blocks:
            x, _ = apply_remat(block, cfg.remat)(cfg, x, None)
        return x, None
    new = []
    for i, block in enumerate(blocks):
        x, c = block(cfg, x, caches[i])
        new.append(c)
    return x, new


def _run(cfg: ArchConfig, params: HybridLM, x, positions, cache, cache_pos,
         window: int):
    new_cache = None if cache is None else {"groups": [], "attn": []}
    for gi, group in enumerate(params.groups):
        x, mc = _mamba_run(cfg, group,
                           x, None if cache is None else cache["groups"][gi])
        x, ac = params.shared_attn(cfg, x, positions,
                                   None if cache is None
                                   else cache["attn"][gi], cache_pos, window)
        if cache is not None:
            new_cache["groups"].append(mc)
            new_cache["attn"].append(ac)
    if len(params.tail):
        x, tc = _mamba_run(cfg, params.tail, x,
                           None if cache is None else cache["tail"])
        if cache is not None:
            new_cache["tail"] = tc
    return x, new_cache


def forward(cfg: ArchConfig, params: HybridLM, tokens, **_):
    """tokens [B, S] -> (logits [B, S, V], aux 0)."""
    b, s = tokens.shape
    x = embed(params.tok, tokens).to(cfg.pdtype)
    positions = default_positions(cfg, b, s, tokens.device)
    x, _ = _run(cfg, params, x, positions, None, None, -1)
    return final_logits(params, x, tied=cfg.tie_embeddings), \
        torch.zeros((), dtype=torch.float32, device=x.device)


def loss_fn(cfg: ArchConfig, params: HybridLM, batch: dict):
    """(mean token cross-entropy, {"loss"}) of ``batch["tokens"]`` against
    ``batch["labels"]``."""
    logits, _ = forward(cfg, params, batch["tokens"])
    loss = cross_entropy(logits, batch["labels"])
    return loss, {"loss": loss}


def prefill(cfg: ArchConfig, params: HybridLM, tokens,
            cache_dtype=torch.bfloat16, cap: int | None = None, **_):
    """(last-token logits [B, 1, V], cache of capacity ``cap``, default the
    prompt length)."""
    b, s = tokens.shape
    x = embed(params.tok, tokens).to(cfg.pdtype)
    cache = sharded_cache(cfg, lambda dev: init_cache(
        cfg, b, cap or s, cache_dtype, dev), tokens)
    positions = default_positions(cfg, b, s, tokens.device)
    x, cache = _run(cfg, params, x, positions, cache, None,
                    _attn_window(cfg, s))
    return final_logits(params, x[:, -1:], tied=cfg.tie_embeddings), cache


def decode_step(cfg: ArchConfig, params: HybridLM, cache, tokens, pos: int):
    """tokens [B, 1] at absolute position ``pos``; the attention cache's
    write position wraps within a ring buffer."""
    b, _ = tokens.shape
    pos = int(pos)
    x = embed(params.tok, tokens).to(cfg.pdtype)
    cap = cache["attn"][0].k.shape[2]
    write_pos = pos if cap > pos else pos % cap
    positions = default_positions(cfg, b, 1, tokens.device, pos)
    x, cache = _run(cfg, params, x, positions, cache, write_pos, -1)
    return final_logits(params, x, tied=cfg.tie_embeddings), cache
