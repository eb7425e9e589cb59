"""Decoder LM for the dense and vlm families (qwen1.5, glm4, qwen3, gemma3,
qwen2-vl's backbone).

The reference scans stacked per-layer parameters with ``jax.lax.scan``;
the port keeps one module per layer in an ``nn.ModuleList`` and loops over
it, handing each layer its window and RoPE theta from `layer_schedule` as
Python numbers (gemma3's 5:1 local/global schedule runs that way).  The
KV cache is a list of per-layer `KVCache`s, updated in place.  The MoE
family waits for the port of the other model families.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..configs.base import ArchConfig
from ..kernels import resolve_device
from ..layers.attention import KVCache, init_attention, init_kv_cache
from ..layers.common import (SwiGLU, embed, init_rms_norm, normal, rms_norm,
                             swiglu, unembed)


def _dense_only(cfg: ArchConfig) -> None:
    if cfg.family == "moe":
        raise NotImplementedError(
            "the moe family (layers/moe.py) comes with the port of the MoE "
            "slice (ROADMAP Queue 1 item c)")


# ---------------------------------------------------------------------------
# per-layer schedule (windows / rope thetas)
# ---------------------------------------------------------------------------

def layer_schedule(cfg: ArchConfig, n_units: int
                   ) -> tuple[list[int], list[float]]:
    """(window, theta) per layer: gemma3's every (r+1)-th layer is global
    (no window, the global theta), the rest local."""
    if cfg.local_global_ratio:
        r = cfg.local_global_ratio
        is_global = (np.arange(n_units) % (r + 1)) == r
        windows = np.where(is_global, -1, cfg.sliding_window or -1)
        thetas = np.where(is_global, cfg.rope_theta_global or cfg.rope_theta,
                          cfg.rope_theta)
    else:
        windows = np.full(n_units, cfg.sliding_window or -1)
        thetas = np.full(n_units, cfg.rope_theta)
    return ([int(w) for w in windows],
            [float(np.float32(t)) for t in thetas])


def _rotary_dim(cfg: ArchConfig) -> int:
    rd = int(cfg.head_dim * cfg.partial_rotary)
    return rd - rd % 2


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

class DenseBlock(nn.Module):
    """Pre-norm block: ``x + attn(ln1(x))``, then ``x + mlp(ln2(x))``."""

    def __init__(self, cfg: ArchConfig, generator, device):
        super().__init__()
        dt = cfg.pdtype
        self.ln1 = init_rms_norm(cfg.d_model, dt, device)
        self.attn = init_attention(
            cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, dt,
            generator, device, qkv_bias=cfg.qkv_bias, qk_norm=cfg.qk_norm)
        self.ln2 = init_rms_norm(cfg.d_model, dt, device)
        self.mlp = SwiGLU(cfg.d_model, cfg.d_ff, dt, generator, device)

    def forward(self, cfg: ArchConfig, x, positions, window: int,
                theta: float, cache: KVCache | None, cache_pos):
        h = rms_norm(self.ln1, x)
        att, cache = self.attn(
            h, positions, theta=theta, rotary_dim=_rotary_dim(cfg),
            window=window, mrope_sections=cfg.mrope_sections, cache=cache,
            cache_pos=cache_pos)
        x = x + att
        return x + swiglu(self.mlp, rms_norm(self.ln2, x)), cache


class DenseLM(nn.Module):
    """Token table ``tok [V_pad, d]``, the layers, the final norm and the
    untied head ``head_w [d, V_pad]`` (None when tied)."""

    def __init__(self, cfg: ArchConfig, generator: torch.Generator, device):
        super().__init__()
        dt = cfg.pdtype
        self.tok = normal((cfg.vocab_padded, cfg.d_model), dt, generator,
                          device, 0.02)
        self.layers = nn.ModuleList(DenseBlock(cfg, generator, device)
                                    for _ in range(cfg.n_layers))
        self.final_norm = init_rms_norm(cfg.d_model, dt, device)
        self.head_w = None if cfg.tie_embeddings else normal(
            (cfg.d_model, cfg.vocab_padded), dt, generator, device,
            float(1.0 / np.sqrt(cfg.d_model)))


def init_params(cfg: ArchConfig, generator: torch.Generator,
                device=None) -> DenseLM:
    """Random parameters drawn from ``generator``, which must live on
    ``device`` (default CUDA: weights are made where they are used)."""
    return DenseLM(cfg, generator, resolve_device(device))


# ---------------------------------------------------------------------------
# forward passes
# ---------------------------------------------------------------------------

def _embed_inputs(cfg: ArchConfig, params: DenseLM, tokens, vision_embeds):
    x = embed(params.tok, tokens).to(cfg.pdtype)
    if cfg.embed_scale:
        x = x * torch.tensor(np.sqrt(cfg.d_model), dtype=x.dtype)
    if cfg.family == "vlm" and vision_embeds is not None:
        # patches pre-embedded by the (stubbed) vision frontend; spliced in
        # after the BOS position
        x = x.clone()
        x[:, 1:1 + vision_embeds.shape[1]] = vision_embeds.to(x.dtype)
    return x


def _default_positions(cfg: ArchConfig, b: int, s: int, device, start=0):
    positions = (torch.arange(s, dtype=torch.int32, device=device)
                 + start)[None].expand(b, s)
    if cfg.mrope_sections is not None:
        positions = positions[None].expand(3, b, s)
    return positions


def _run_layers(cfg: ArchConfig, params: DenseLM, x, positions, cache,
                cache_pos):
    windows, thetas = layer_schedule(cfg, cfg.n_layers)
    for i, layer in enumerate(params.layers):
        x, _ = layer(cfg, x, positions, windows[i], thetas[i],
                     None if cache is None else cache[i], cache_pos)
    return x


def forward(cfg: ArchConfig, params: DenseLM, tokens, *, vision_embeds=None,
            positions=None):
    """Training/eval forward: tokens [B,S] -> (logits [B,S,V], aux)."""
    _dense_only(cfg)
    b, s = tokens.shape
    if positions is None:
        positions = _default_positions(cfg, b, s, tokens.device)
    x = _embed_inputs(cfg, params, tokens, vision_embeds)
    x = _run_layers(cfg, params, x, positions, None, None)
    x = rms_norm(params.final_norm, x)
    logits = unembed(params.tok, params.head_w, x, tied=cfg.tie_embeddings)
    return logits, torch.zeros((), dtype=torch.float32, device=x.device)


# -- serving ----------------------------------------------------------------

def init_cache(cfg: ArchConfig, batch: int, cap: int, dtype=torch.bfloat16,
               device=None) -> list[KVCache]:
    """One zeroed `KVCache` [B, n_kv, cap, dh] per layer, on ``device``
    (default CUDA)."""
    _dense_only(cfg)
    dev = resolve_device(device)
    return [init_kv_cache(batch, cfg.n_kv_heads, cap, cfg.head_dim, dtype,
                          dev) for _ in range(cfg.n_layers)]


def prefill(cfg: ArchConfig, params: DenseLM, tokens, *, vision_embeds=None,
            positions=None, cache_dtype=torch.bfloat16,
            cap: int | None = None):
    """Build the KV cache for the whole prompt; return last-token logits
    [B,1,V] and the cache.  `cap` is the cache capacity (>= prompt +
    generated tokens; defaults to the prompt length)."""
    b, s = tokens.shape
    if positions is None:
        positions = _default_positions(cfg, b, s, tokens.device)
    x = _embed_inputs(cfg, params, tokens, vision_embeds)
    cache = init_cache(cfg, b, cap or s, cache_dtype, tokens.device)
    x = _run_layers(cfg, params, x, positions, cache, None)
    x = rms_norm(params.final_norm, x[:, -1:])
    return unembed(params.tok, params.head_w, x,
                   tied=cfg.tie_embeddings), cache


def decode_step(cfg: ArchConfig, params: DenseLM, cache, tokens, pos: int):
    """One serving step: tokens [B,1] at absolute position `pos`,
    attending over cache[<= pos].  Returns (logits [B,1,V], cache)."""
    b, s = tokens.shape
    if s != 1:
        raise ValueError(f"decode_step takes one token per row, got {s}")
    positions = _default_positions(cfg, b, 1, tokens.device, start=int(pos))
    x = _embed_inputs(cfg, params, tokens, None)
    x = _run_layers(cfg, params, x, positions, cache, int(pos))
    x = rms_norm(params.final_norm, x)
    return unembed(params.tok, params.head_w, x,
                   tied=cfg.tie_embeddings), cache
