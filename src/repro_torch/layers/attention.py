"""Grouped-query self-attention with the variants the dense archs need:

  * GQA with any kv-head count (incl. MQA kv=1 and MHA kv=heads)
  * optional QKV bias (qwen1.5), qk-norm (qwen3), partial rotary (glm4)
  * sliding-window masks (gemma3 local layers)
  * standard RoPE or M-RoPE (qwen2-vl)
  * KV-cache prefill (bulk write) and decode (single-position update)
  * cross attention over an encoder memory (seamless enc-dec), and the
    encoder's bidirectional self attention as cross attention onto itself

`Attention` is an ``nn.Module`` holding the reference's parameters under
its names and layouts (``wq [d, H, dh]`` ... ``wo [H, dh, d]``).  Its
``forward(x, positions, ..., cache, cache_pos) -> (y, cache)`` covers the
reference's three branches: no cache, prefill and decode.  On the card
every branch attends through the flash kernel (``self.attend``, which a
caller may wrap per instance, e.g. to record its operands); on the CPU the
branches mirror the reference's XLA path one for one (`_sdpa` below
``CHUNKED_THRESHOLD``, `chunked_attention` above, the masked full-cap
`_sdpa` at decode).  Training takes the reference's train path on either
device: when autograd records q, k or v (`records_grad`), the no-cache
branch and `cross_attention` attend through `_sdpa` / `chunked_attention`,
which autograd differentiates.  The flash kernel has no backward (nor has
the reference's Pallas kernel), and its wrapper raises on operands that
need a gradient, so no gradient is dropped silently.

The KV cache is updated IN PLACE (the reference returns a new cache): at
full width one serving group's cache is over a gigabyte, and a functional
copy per layer per step would move it 36 times a step.  ``forward``
returns the same `KVCache` it was given.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from ..kernels.flash_attention import flash_attention
from .common import apply_mrope, apply_rope, normal, param, rms_norm

NEG_INF = -0.7 * float(np.finfo(np.float32).max)

# Sequence length at/above which the CPU path replaces the materialized
# [S, S] logits with the chunked online softmax (the reference's threshold
# and chunk; on the card the flash kernel serves every length).
CHUNKED_THRESHOLD = 8192
CHUNK = 2048


class KVCache(NamedTuple):
    k: torch.Tensor  # [B, n_kv, S_cap, Dh]
    v: torch.Tensor  # [B, n_kv, S_cap, Dh]


class Attention(nn.Module):
    """Self-attention parameters plus the forward pass (see the module
    docstring).  Build one with `init_attention`."""

    def __init__(self, d: int, n_heads: int, n_kv: int, head_dim: int,
                 dtype, generator, device, *, qkv_bias: bool = False,
                 qk_norm: bool = False):
        super().__init__()
        s = float(1.0 / np.sqrt(d))
        self.wq = normal((d, n_heads, head_dim), dtype, generator, device, s)
        self.wk = normal((d, n_kv, head_dim), dtype, generator, device, s)
        self.wv = normal((d, n_kv, head_dim), dtype, generator, device, s)
        self.wo = normal((n_heads, head_dim, d), dtype, generator, device,
                         float(1.0 / np.sqrt(n_heads * head_dim)))
        zeros = lambda *shape: param(torch.zeros(shape, dtype=dtype,
                                                 device=device))
        self.bq = self.bk = self.bv = None
        if qkv_bias:
            self.bq = zeros(n_heads, head_dim)
            self.bk = zeros(n_kv, head_dim)
            self.bv = zeros(n_kv, head_dim)
        self.q_norm = self.k_norm = None
        if qk_norm:
            self.q_norm = zeros(head_dim)
            self.k_norm = zeros(head_dim)
        # the attention kernel the card path calls, per instance
        self.attend = flash_attention

    def forward(self, x, positions, *, theta: float = 10000.0,
                rotary_dim: int | None = None, window: int = -1,
                mrope_sections=None, cache: KVCache | None = None,
                cache_pos: int | None = None):
        """Train / no-cache: full causal (+window) attention over x.
        Prefill: cache given, cache_pos None -> bulk-write k/v at [0, S).
        Decode: cache given, cache_pos an int -> write at cache_pos, attend
        over cache[<= cache_pos] (with optional window).
        Returns (y, cache)."""
        b, s, _ = x.shape
        q, k, v = _project_qkv(self, x, positions, theta=theta,
                               rotary_dim=rotary_dim,
                               mrope_sections=mrope_sections)
        on_card = x.device.type == "cuda"
        if cache is not None and cache_pos is not None:    # decode: s == 1
            pos = int(cache_pos)
            cap = cache.k.shape[2]
            if not 0 <= pos < cap:
                raise ValueError(f"cache_pos {pos} outside the cache [0, "
                                 f"{cap})")
            cache.k[:, :, pos:pos + s] = k.transpose(1, 2).to(cache.k.dtype)
            cache.v[:, :, pos:pos + s] = v.transpose(1, 2).to(cache.v.dtype)
            if on_card:
                # the query sits at key position pos of the slice, so the
                # causal + window mask is the reference's full-cap mask
                out = self.attend(q.transpose(1, 2),
                                  cache.k[:, :, :pos + 1],
                                  cache.v[:, :, :pos + 1], causal=True,
                                  window=window).transpose(1, 2)
            else:
                ki = torch.arange(cap, device=x.device)
                w_eff = window if window > 0 else 2 ** 30
                mask = ((ki <= pos) & (ki > pos - w_eff))[None, None, None]
                out = _sdpa(q, cache.k.transpose(1, 2),
                            cache.v.transpose(1, 2), mask)
        else:
            if cache is not None:                          # prefill
                cache.k[:, :, :s] = k.transpose(1, 2).to(cache.k.dtype)
                cache.v[:, :, :s] = v.transpose(1, 2).to(cache.v.dtype)
            if on_card and (cache is not None or not records_grad(q, k, v)):
                out = self.attend(q.transpose(1, 2), k.transpose(1, 2),
                                  v.transpose(1, 2), causal=True,
                                  window=window).transpose(1, 2)
            elif s >= CHUNKED_THRESHOLD:
                out = chunked_attention(q, k, v, window=window, chunk=CHUNK)
            else:
                out = _sdpa(q, k, v, causal_mask(s, s, window=window,
                                                 device=x.device))
        y = out.reshape(b, s, -1) @ self.wo.reshape(-1, self.wo.shape[-1])
        return y, cache


def init_attention(d: int, n_heads: int, n_kv: int, head_dim: int, dtype,
                   generator: torch.Generator, device=None, *,
                   qkv_bias: bool = False, qk_norm: bool = False
                   ) -> Attention:
    """Random attention parameters drawn from ``generator`` (on
    ``device``), scaled as the reference scales them."""
    return Attention(d, n_heads, n_kv, head_dim, dtype, generator, device,
                     qkv_bias=qkv_bias, qk_norm=qk_norm)


def init_kv_cache(batch: int, n_kv: int, cap: int, head_dim: int, dtype,
                  device=None) -> KVCache:
    """A zeroed cache (two separate buffers: updated in place)."""
    shape = (batch, n_kv, cap, head_dim)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))


def _project_qkv(p, x, positions, *, theta, rotary_dim, mrope_sections):
    """q [B,S,H,dh], k/v [B,S,Hkv,dh]: projection, bias, qk-norm, RoPE."""
    b, s, d = x.shape
    q = (x.reshape(b * s, d) @ p.wq.reshape(d, -1)).reshape(
        b, s, *p.wq.shape[1:])
    k = (x.reshape(b * s, d) @ p.wk.reshape(d, -1)).reshape(
        b, s, *p.wk.shape[1:])
    v = (x.reshape(b * s, d) @ p.wv.reshape(d, -1)).reshape(
        b, s, *p.wv.shape[1:])
    if p.bq is not None:
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    if p.q_norm is not None:
        q = rms_norm(p.q_norm, q)
        k = rms_norm(p.k_norm, k)
    if positions is not None:
        if mrope_sections is not None:
            q = apply_mrope(q, positions, theta=theta,
                            sections=mrope_sections)
            k = apply_mrope(k, positions, theta=theta,
                            sections=mrope_sections)
        else:
            q = apply_rope(q, positions, theta=theta, rotary_dim=rotary_dim)
            k = apply_rope(k, positions, theta=theta, rotary_dim=rotary_dim)
    return q, k, v


def project_cross_kv(p: Attention, memory) -> KVCache:
    """The encoder memory's K/V for cross attention, head-major
    [B, Hkv, T, dh] as a KV cache holds them (computed once at prefill)."""
    b, t, d = memory.shape
    m = memory.reshape(b * t, d)
    k = (m @ p.wk.reshape(d, -1)).reshape(b, t, *p.wk.shape[1:])
    v = (m @ p.wv.reshape(d, -1)).reshape(b, t, *p.wv.shape[1:])
    if p.k_norm is not None:
        k = rms_norm(p.k_norm, k)
    return KVCache(k.transpose(1, 2).contiguous(),
                   v.transpose(1, 2).contiguous())


def cross_attention(p: Attention, x, memory, positions=None, *,
                    theta: float = 10000.0, kv_cache: KVCache | None = None):
    """Non-causal attention of ``x`` [B, S, d] over the encoder memory: its
    K/V projected here from ``memory`` [B, T, d], or taken from
    ``kv_cache`` (`project_cross_kv`'s output).  No RoPE (``positions``
    and ``theta`` are the reference's signature).  On the card through the
    layer's ``attend`` hook (the flash kernel, ``causal=False``), on the
    CPU, and in training, through the reference's unmasked `_sdpa`."""
    b, s, d = x.shape
    q = (x.reshape(b * s, d) @ p.wq.reshape(d, -1)).reshape(
        b, s, *p.wq.shape[1:])
    if p.q_norm is not None:
        q = rms_norm(p.q_norm, q)
    kv = kv_cache if kv_cache is not None else project_cross_kv(p, memory)
    if x.device.type == "cuda" and not records_grad(q, kv.k, kv.v):
        out = p.attend(q.transpose(1, 2), kv.k, kv.v, causal=False,
                       window=-1).transpose(1, 2)
    else:
        out = _sdpa(q, kv.k.transpose(1, 2), kv.v.transpose(1, 2), None)
    return out.reshape(b, s, -1) @ p.wo.reshape(-1, p.wo.shape[-1])


def records_grad(*tensors) -> bool:
    """Whether autograd records any of the tensors: the attention then
    takes the differentiable train path, not the forward-only kernel."""
    return any(t.requires_grad for t in tensors)


def _sdpa(q, k, v, mask):
    """q: [B,S,H,Dh], k/v: [B,T,Hkv,Dh], mask: broadcastable [B,1,S,T].
    GQA groups the query heads ([B,S,Hkv,G,Dh]); no head repeat."""
    b, s, hq, dh = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, s, hkv, hq // hkv, dh)
    logits = torch.einsum("bshge,bthe->bhgst", qg, k) * (1.0 / np.sqrt(dh))
    if mask is not None:
        logits = torch.where(mask[:, :, None], logits, NEG_INF)
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    out = torch.einsum("bhgst,bthe->bshge", probs.to(v.dtype), v)
    return out.reshape(q.shape)


def chunked_attention(q, k, v, *, window=-1, chunk: int = 1024,
                      offset: int = 0):
    """Online-softmax attention over KV chunks (the reference's XLA
    flash-attention): carries (acc [B,Hkv,G,Sq,dh] f32, m, l) across
    chunks and touches one [Sq, chunk] logits tile at a time.

    q: [B,Sq,H,dh]; k/v: [B,Sk,Hkv,dh]; causal with optional sliding
    window; `offset` = absolute position of q[0] minus k[0].
    """
    b, sq, hq, dh = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = 1.0 / np.sqrt(dh)
    qg = q.reshape(b, sq, hkv, g, dh)
    qi = torch.arange(sq, device=q.device) + offset          # [Sq] abs pos
    w_eff = window if window > 0 else 2 ** 30
    acc = torch.zeros((b, hkv, g, sq, dh), dtype=torch.float32,
                      device=q.device)
    m = torch.full((b, hkv, g, sq), -torch.inf, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, hkv, g, sq), dtype=torch.float32, device=q.device)
    for c0 in range(0, sk, chunk):
        k_c = k[:, c0:c0 + chunk]
        v_c = v[:, c0:c0 + chunk]
        ki = torch.arange(c0, c0 + k_c.shape[1], device=q.device)
        logits = torch.einsum("bshge,bche->bhgsc", qg, k_c) * scale
        mask = (ki[None, :] <= qi[:, None]) & \
            (ki[None, :] > qi[:, None] - w_eff)                # [Sq, C]
        logits = torch.where(mask, logits, NEG_INF).to(torch.float32)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(logits - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        pv = torch.einsum("bhgsc,bche->bhgse", p.to(v_c.dtype), v_c)
        acc = acc * alpha[..., None] + pv.to(torch.float32)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, dh).to(q.dtype)


def causal_mask(sq: int, sk: int, *, window=-1, offset: int = 0,
                device=None):
    """[1, 1, sq, sk] causal (+sliding window if window > 0) mask.
    `offset` = absolute position of query 0 minus key 0."""
    qi = torch.arange(sq, device=device)[:, None] + offset
    ki = torch.arange(sk, device=device)[None, :]
    w_eff = window if window > 0 else 2 ** 30
    return ((ki <= qi) & (ki > qi - w_eff))[None, None]
