"""Decoder LM for the dense, moe and vlm families (qwen1.5, glm4, qwen3,
gemma3, olmoe, llama4, qwen2-vl's backbone).

The reference scans stacked per-unit parameters with ``jax.lax.scan``;
the port keeps one module per scan unit in an ``nn.ModuleList`` and loops
over it, handing each unit its window and RoPE theta from `layer_schedule`
as Python numbers (gemma3's 5:1 local/global schedule runs that way).  A
unit is one layer — dense, or MoE in every layer (olmoe) — or a dense+MoE
pair (llama4, ``moe_every=2``, with a shared expert).  The KV cache is a
list of per-unit caches (a `KVCache`, or ``{"dense", "moe"}`` for a pair),
updated in place.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..configs.base import ArchConfig
from ..kernels import resolve_device
from ..layers.attention import KVCache, init_attention, init_kv_cache
from ..layers.common import (SwiGLU, apply_remat, cross_entropy, embed,
                             final_logits, init_rms_norm, normal, rms_norm,
                             swiglu)
from ..layers.moe import MoE, moe_ffn
from ..layers.moe_ep import moe_ffn_ep


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

class _AttnBlock(nn.Module):
    """The attention half of a pre-norm block: ``ln1``, ``attn``, and the
    FFN's input norm ``ln2``."""

    def __init__(self, cfg: ArchConfig, generator, device):
        super().__init__()
        dt = cfg.pdtype
        self.ln1 = init_rms_norm(cfg.d_model, dt, device)
        self.attn = init_attention(
            cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, dt,
            generator, device, qkv_bias=cfg.qkv_bias, qk_norm=cfg.qk_norm)
        self.ln2 = init_rms_norm(cfg.d_model, dt, device)

    def _attend(self, cfg: ArchConfig, x, positions, window, theta, cache,
                cache_pos):
        att, cache = self.attn(
            rms_norm(self.ln1, x), positions, theta=theta,
            rotary_dim=_rotary_dim(cfg), window=window,
            mrope_sections=cfg.mrope_sections, cache=cache,
            cache_pos=cache_pos)
        return x + att, cache


class DenseBlock(_AttnBlock):
    """Pre-norm block: ``x + attn(ln1(x))``, then ``x + mlp(ln2(x))``."""

    def __init__(self, cfg: ArchConfig, generator, device):
        super().__init__(cfg, generator, device)
        self.mlp = SwiGLU(cfg.d_model, cfg.d_ff, cfg.pdtype, generator,
                          device)

    def forward(self, cfg: ArchConfig, x, positions, window: int,
                theta: float, cache: KVCache | None, cache_pos):
        """(x, cache, aux); aux is 0 for a dense block."""
        x, cache = self._attend(cfg, x, positions, window, theta, cache,
                                cache_pos)
        return x + swiglu(self.mlp, rms_norm(self.ln2, x)), cache, 0.0


class MoEBlock(_AttnBlock):
    """Attention as in `DenseBlock`, then the MoE FFN (``moe_impl`` "ep":
    the sorted dispatch, "einsum": the one-hot dispatch) plus, with
    ``shared_expert``, a dense SwiGLU of ``d_ff`` on the same input."""

    def __init__(self, cfg: ArchConfig, generator, device):
        super().__init__(cfg, generator, device)
        self.moe = MoE(cfg.d_model, cfg.expert_d_ff or cfg.d_ff,
                       cfg.n_experts, cfg.pdtype, generator, device)
        self.shared_mlp = SwiGLU(cfg.d_model, cfg.d_ff, cfg.pdtype,
                                 generator, device) \
            if cfg.shared_expert else None

    def forward(self, cfg: ArchConfig, x, positions, window: int,
                theta: float, cache: KVCache | None, cache_pos):
        x, cache = self._attend(cfg, x, positions, window, theta, cache,
                                cache_pos)
        h = rms_norm(self.ln2, x)
        if cfg.moe_impl == "ep":
            y, aux = moe_ffn_ep(self.moe, h, top_k=cfg.top_k,
                                capacity_factor=cfg.capacity_factor,
                                expert_axis=cfg.expert_axis)
        else:
            y, aux = moe_ffn(self.moe, h, top_k=cfg.top_k,
                             capacity_factor=cfg.capacity_factor)
        if self.shared_mlp is not None:
            y = y + swiglu(self.shared_mlp, h)
        return x + y, cache, aux


class MoEPair(nn.Module):
    """llama4's scan unit (``moe_every=2``): a dense block, then an MoE
    block, both with the unit's window and theta.  Its cache is
    ``{"dense": KVCache, "moe": KVCache}``."""

    def __init__(self, cfg: ArchConfig, generator, device):
        super().__init__()
        self.dense = DenseBlock(cfg, generator, device)
        self.moe = MoEBlock(cfg, generator, device)

    def forward(self, cfg: ArchConfig, x, positions, window: int,
                theta: float, cache: dict | None, cache_pos):
        x, _, _ = self.dense(cfg, x, positions, window, theta,
                             None if cache is None else cache["dense"],
                             cache_pos)
        x, _, aux = self.moe(cfg, x, positions, window, theta,
                             None if cache is None else cache["moe"],
                             cache_pos)
        return x, cache, aux


def n_units(cfg: ArchConfig) -> int:
    return cfg.n_layers // 2 if (cfg.family == "moe" and cfg.moe_every == 2) \
        else cfg.n_layers


def layers_per_unit(cfg: ArchConfig) -> int:
    return 2 if (cfg.family == "moe" and cfg.moe_every == 2) else 1


def init_unit(cfg: ArchConfig, generator, device) -> nn.Module:
    if cfg.family == "moe" and cfg.moe_every == 2:
        return MoEPair(cfg, generator, device)
    if cfg.family == "moe":
        return MoEBlock(cfg, generator, device)
    return DenseBlock(cfg, generator, device)


def init_unit_cache(cfg: ArchConfig, batch: int, cap: int, dtype, device):
    mk = lambda: init_kv_cache(batch, cfg.n_kv_heads, cap, cfg.head_dim,
                               dtype, device)
    if cfg.family == "moe" and cfg.moe_every == 2:
        return {"dense": mk(), "moe": mk()}
    return mk()


class DecoderLM(nn.Module):
    """Token table ``tok [V_pad, d]``, the scan units (``layers``), the
    final norm and the untied head ``head_w [d, V_pad]`` (None when
    tied)."""

    def __init__(self, cfg: ArchConfig, generator: torch.Generator, device):
        super().__init__()
        dt = cfg.pdtype
        self.tok = normal((cfg.vocab_padded, cfg.d_model), dt, generator,
                          device, 0.02)
        self.layers = nn.ModuleList(init_unit(cfg, generator, device)
                                    for _ in range(n_units(cfg)))
        self.final_norm = init_rms_norm(cfg.d_model, dt, device)
        self.head_w = None if cfg.tie_embeddings else normal(
            (cfg.d_model, cfg.vocab_padded), dt, generator, device,
            float(1.0 / np.sqrt(cfg.d_model)))


def init_params(cfg: ArchConfig, generator: torch.Generator,
                device=None) -> DecoderLM:
    """Random parameters drawn from ``generator``, which must live on
    ``device`` (default CUDA: weights are made where they are used)."""
    return DecoderLM(cfg, generator, resolve_device(device))


# ---------------------------------------------------------------------------
# forward passes
# ---------------------------------------------------------------------------

def _embed_inputs(cfg: ArchConfig, params: DecoderLM, tokens, vision_embeds):
    x = embed(params.tok, tokens).to(cfg.pdtype)
    if cfg.embed_scale:
        x = x * torch.tensor(np.sqrt(cfg.d_model), dtype=x.dtype)
    if cfg.family == "vlm" and vision_embeds is not None:
        # patches pre-embedded by the (stubbed) vision frontend; spliced in
        # after the BOS position
        x = x.clone()
        x[:, 1:1 + vision_embeds.shape[1]] = vision_embeds.to(x.dtype)
    return x


def default_positions(cfg: ArchConfig, b: int, s: int, device, start=0):
    """Positions ``start .. start+s-1`` for each row ([3, B, S] under
    M-RoPE)."""
    positions = (torch.arange(s, dtype=torch.int32, device=device)
                 + start)[None].expand(b, s)
    if cfg.mrope_sections is not None:
        positions = positions[None].expand(3, b, s)
    return positions


def _run_layers(cfg: ArchConfig, params: DecoderLM, x, positions, cache,
                cache_pos):
    """Run the units in order; returns (x, the units' summed aux loss: a
    Python 0.0 while only dense units ran, so serving a dense model adds
    no device op for it).  Without a cache (training) each unit runs under
    ``cfg.remat`` (`apply_remat`)."""
    windows, thetas = layer_schedule(cfg, n_units(cfg))
    aux = 0.0
    for i, unit in enumerate(params.layers):
        if cache is None:
            x, _, a = apply_remat(unit, cfg.remat)(
                cfg, x, positions, windows[i], thetas[i], None, None)
        else:
            x, _, a = unit(cfg, x, positions, windows[i], thetas[i],
                           cache[i], cache_pos)
        aux = aux + a
    return x, aux


def forward(cfg: ArchConfig, params: DecoderLM, tokens, *, vision_embeds=None,
            positions=None):
    """Training/eval forward: tokens [B,S] -> (logits [B,S,V], aux)."""
    b, s = tokens.shape
    if positions is None:
        positions = default_positions(cfg, b, s, tokens.device)
    x = _embed_inputs(cfg, params, tokens, vision_embeds)
    x, aux = _run_layers(cfg, params, x, positions, None, None)
    return final_logits(params, x, tied=cfg.tie_embeddings), \
        torch.as_tensor(aux, dtype=torch.float32, device=x.device)


def loss_fn(cfg: ArchConfig, params: DecoderLM, batch: dict):
    """(mean token cross-entropy + 0.01 * aux, {"loss", "aux"}) of
    ``batch["tokens"]`` against ``batch["labels"]`` (plus the batch's
    ``vision_embeds`` and ``positions`` for vlm)."""
    logits, aux = forward(cfg, params, batch["tokens"],
                          vision_embeds=batch.get("vision_embeds"),
                          positions=batch.get("positions"))
    loss = cross_entropy(logits, batch["labels"])
    return loss + 0.01 * aux, {"loss": loss, "aux": aux}


# -- serving ----------------------------------------------------------------

def init_cache(cfg: ArchConfig, batch: int, cap: int, dtype=torch.bfloat16,
               device=None) -> list:
    """One zeroed cache per unit (`KVCache` [B, n_kv, cap, dh], or a pair's
    ``{"dense", "moe"}``), on ``device`` (default CUDA)."""
    dev = resolve_device(device)
    return [init_unit_cache(cfg, batch, cap, dtype, dev)
            for _ in range(n_units(cfg))]


def prefill(cfg: ArchConfig, params: DecoderLM, tokens, *, vision_embeds=None,
            positions=None, cache_dtype=torch.bfloat16,
            cap: int | None = None):
    """Build the KV cache for the whole prompt; return last-token logits
    [B,1,V] and the cache.  `cap` is the cache capacity (>= prompt +
    generated tokens; defaults to the prompt length)."""
    b, s = tokens.shape
    if positions is None:
        positions = default_positions(cfg, b, s, tokens.device)
    x = _embed_inputs(cfg, params, tokens, vision_embeds)
    cache = init_cache(cfg, b, cap or s, cache_dtype, tokens.device)
    x, _ = _run_layers(cfg, params, x, positions, cache, None)
    return final_logits(params, x[:, -1:], tied=cfg.tie_embeddings), cache


def decode_step(cfg: ArchConfig, params: DecoderLM, cache, tokens, pos: int):
    """One serving step: tokens [B,1] at absolute position `pos`,
    attending over cache[<= pos].  Returns (logits [B,1,V], cache)."""
    b, s = tokens.shape
    if s != 1:
        raise ValueError(f"decode_step takes one token per row, got {s}")
    positions = default_positions(cfg, b, 1, tokens.device, start=int(pos))
    x = _embed_inputs(cfg, params, tokens, None)
    x, _ = _run_layers(cfg, params, x, positions, cache, int(pos))
    return final_logits(params, x, tied=cfg.tie_embeddings), cache
