"""Encoder-decoder backbone (seamless-m4t-medium).

The port of ``repro.models.encdec``.  The speech frontend is a stub, as in
the reference: callers pass precomputed frame embeddings ``frames``
[B, T, d_model].  The encoder is a bidirectional transformer over the
frames (self attention as unmasked cross attention onto itself); the
decoder is causal with cross attention over the encoder memory.  Serving
keeps, per decoder layer, a self-attention KV cache and the cross K/V
projected once at prefill (`EncDecCache`).  On the card every attention —
encoder, decoder self and cross — runs through the flash kernel.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from ..configs.base import ArchConfig
from ..kernels import resolve_device
from ..layers.attention import (KVCache, cross_attention, init_attention,
                                init_kv_cache, project_cross_kv)
from ..layers.common import (SwiGLU, apply_remat, cross_entropy, embed,
                             final_logits, init_rms_norm, normal, rms_norm,
                             swiglu)
from ..launch.activations import sharded_cache
from .lm import default_positions


class EncDecCache(NamedTuple):
    self_kv: list[KVCache]    # per decoder layer [B, kv, cap, hd]
    cross_kv: list[KVCache]   # per decoder layer [B, kv, frames, hd]


class EncBlock(nn.Module):
    def __init__(self, cfg: ArchConfig, generator, device):
        super().__init__()
        dt = cfg.pdtype
        self.ln1 = init_rms_norm(cfg.d_model, dt, device)
        self.attn = init_attention(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                                   cfg.head_dim, dt, generator, device)
        self.ln2 = init_rms_norm(cfg.d_model, dt, device)
        self.mlp = SwiGLU(cfg.d_model, cfg.d_ff, dt, generator, device)

    def forward(self, x):
        h = rms_norm(self.ln1, x)
        x = x + cross_attention(self.attn, h, h)
        return x + swiglu(self.mlp, rms_norm(self.ln2, x))


class DecBlock(nn.Module):
    def __init__(self, cfg: ArchConfig, generator, device):
        super().__init__()
        dt = cfg.pdtype
        mk_attn = lambda: init_attention(cfg.d_model, cfg.n_heads,
                                         cfg.n_kv_heads, cfg.head_dim, dt,
                                         generator, device)
        self.ln1 = init_rms_norm(cfg.d_model, dt, device)
        self.self_attn = mk_attn()
        self.ln_x = init_rms_norm(cfg.d_model, dt, device)
        self.cross_attn = mk_attn()
        self.ln2 = init_rms_norm(cfg.d_model, dt, device)
        self.mlp = SwiGLU(cfg.d_model, cfg.d_ff, dt, generator, device)

    def forward(self, cfg: ArchConfig, x, positions, memory,
                skv: KVCache | None, ckv: KVCache | None, cache_pos):
        att, skv = self.self_attn(rms_norm(self.ln1, x), positions,
                                  theta=cfg.rope_theta, cache=skv,
                                  cache_pos=cache_pos)
        x = x + att
        h = rms_norm(self.ln_x, x)
        x = x + cross_attention(self.cross_attn, h, memory, kv_cache=ckv)
        return x + swiglu(self.mlp, rms_norm(self.ln2, x)), skv


class EncDecLM(nn.Module):
    """Token table, encoder blocks and norm, decoder blocks, the final norm
    and the untied head ``head_w`` (None when tied)."""

    def __init__(self, cfg: ArchConfig, generator: torch.Generator, device):
        super().__init__()
        dt = cfg.pdtype
        self.tok = normal((cfg.vocab_padded, cfg.d_model), dt, generator,
                          device, 0.02)
        self.enc_blocks = nn.ModuleList(EncBlock(cfg, generator, device)
                                        for _ in range(cfg.n_enc_layers))
        self.enc_norm = init_rms_norm(cfg.d_model, dt, device)
        self.dec_blocks = nn.ModuleList(DecBlock(cfg, generator, device)
                                        for _ in range(cfg.n_layers))
        self.final_norm = init_rms_norm(cfg.d_model, dt, device)
        self.head_w = None if cfg.tie_embeddings else normal(
            (cfg.d_model, cfg.vocab_padded), dt, generator, device,
            float(1.0 / np.sqrt(cfg.d_model)))


def init_params(cfg: ArchConfig, generator: torch.Generator,
                device=None) -> EncDecLM:
    """Random parameters drawn from ``generator`` on ``device`` (default
    CUDA)."""
    return EncDecLM(cfg, generator, resolve_device(device))


def _need_frames(frames) -> None:
    if frames is None:
        raise ValueError(
            "the encoder-decoder family needs `frames` [B, T, d_model] (the "
            "stubbed speech frontend's embeddings) to encode; a caller that "
            "passes only tokens, as the serving engine does, has none")


def encode(cfg: ArchConfig, params: EncDecLM, frames, remat: str = "none"):
    """frames: [B, T, D] pre-embedded modality features -> memory (each
    block under the ``remat`` policy: training passes ``cfg.remat``)."""
    _need_frames(frames)
    x = frames.to(cfg.pdtype)
    for block in params.enc_blocks:
        x = apply_remat(block, remat)(x)
    return rms_norm(params.enc_norm, x)


def _run_decoder(cfg: ArchConfig, params: EncDecLM, x, positions, memory,
                 cache: EncDecCache | None, cache_pos):
    """Run the decoder blocks; without a cache (training) each runs under
    ``cfg.remat``."""
    for i, block in enumerate(params.dec_blocks):
        if cache is None:
            x, _ = apply_remat(block, cfg.remat)(cfg, x, positions, memory,
                                                 None, None, None)
        else:
            x, _ = block(cfg, x, positions, memory, cache.self_kv[i],
                         cache.cross_kv[i], cache_pos)
    return x, cache


def forward(cfg: ArchConfig, params: EncDecLM, tokens, *, frames=None, **_):
    """Training: frames [B, T, D] + decoder tokens [B, S] -> (logits
    [B, S, V], aux 0)."""
    b, s = tokens.shape
    memory = encode(cfg, params, frames, cfg.remat)
    x = embed(params.tok, tokens).to(cfg.pdtype)
    positions = default_positions(cfg, b, s, tokens.device)
    x, _ = _run_decoder(cfg, params, x, positions, memory, None, None)
    return final_logits(params, x, tied=cfg.tie_embeddings), \
        torch.zeros((), dtype=torch.float32, device=x.device)


def loss_fn(cfg: ArchConfig, params: EncDecLM, batch: dict):
    """(mean token cross-entropy, {"loss"}) of the decoder's
    ``batch["tokens"]`` against ``batch["labels"]``, encoding
    ``batch["frames"]``."""
    logits, _ = forward(cfg, params, batch["tokens"], frames=batch["frames"])
    loss = cross_entropy(logits, batch["labels"])
    return loss, {"loss": loss}


def init_cache(cfg: ArchConfig, batch: int, cap: int, frames: int,
               dtype=torch.bfloat16, device=None) -> EncDecCache:
    """Zeroed self and cross caches on ``device`` (default CUDA)."""
    dev = resolve_device(device)
    mk = lambda n: [init_kv_cache(batch, cfg.n_kv_heads, n, cfg.head_dim,
                                  dtype, dev) for _ in range(cfg.n_layers)]
    return EncDecCache(self_kv=mk(cap), cross_kv=mk(frames))


def prefill(cfg: ArchConfig, params: EncDecLM, tokens, *, frames=None,
            cache_dtype=torch.bfloat16, cap: int | None = None, **_):
    """Encode the frames once (the cross K/V cached per decoder layer),
    prefill the decoder's self cache; return last-token logits [B, 1, V]
    and the `EncDecCache`."""
    b, s = tokens.shape
    memory = encode(cfg, params, frames)
    cross = [project_cross_kv(block.cross_attn, memory)
             for block in params.dec_blocks]
    cache = EncDecCache(
        self_kv=sharded_cache(cfg, lambda dev: [
            init_kv_cache(b, cfg.n_kv_heads, cap or s, cfg.head_dim,
                          cache_dtype, dev) for _ in range(cfg.n_layers)],
            tokens),
        cross_kv=[KVCache(c.k.to(cache_dtype), c.v.to(cache_dtype))
                  for c in cross])
    x = embed(params.tok, tokens).to(cfg.pdtype)
    positions = default_positions(cfg, b, s, tokens.device)
    x, cache = _run_decoder(cfg, params, x, positions, memory, cache, None)
    return final_logits(params, x[:, -1:], tied=cfg.tie_embeddings), cache


def decode_step(cfg: ArchConfig, params: EncDecLM, cache: EncDecCache,
                tokens, pos: int):
    """tokens [B, 1] at absolute position ``pos`` against the cached self
    and cross K/V."""
    b, _ = tokens.shape
    x = embed(params.tok, tokens).to(cfg.pdtype)
    positions = default_positions(cfg, b, 1, tokens.device, int(pos))
    x, cache = _run_decoder(cfg, params, x, positions, None, cache, int(pos))
    return final_logits(params, x, tied=cfg.tie_embeddings), cache
