"""Shared building blocks: norms, RoPE (incl. M-RoPE), MLPs, embeddings.

The layers are plain functions over parameter holders (``nn.Module``s whose
tensors carry the reference's names and layouts: ``w_gate [d, f]``,
``tok [V, d]`` ...), so `repro_torch.convert` can copy the JAX package's
parameter pytrees in unchanged.  Parameters are inference tensors
(``requires_grad=False``): the port serves and does not train yet.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn


def param(t: torch.Tensor) -> nn.Parameter:
    """An inference parameter: no autograd graph is ever built over it."""
    return nn.Parameter(t, requires_grad=False)


def normal(shape, dtype, generator: torch.Generator, device,
           scale: float) -> nn.Parameter:
    """``N(0, 1) * scale`` drawn in f32 from ``generator``, cast to
    ``dtype`` (the reference draws in the parameter dtype; the two
    packages' draws differ anyway, so tests carry weights across)."""
    return param((torch.randn(shape, generator=generator, device=device,
                              dtype=torch.float32) * scale).to(dtype))


def rms_norm(scale, x, eps: float = 1e-6):
    """RMS norm in f32, applied as ``1 + scale`` (zero-init scales)."""
    dt = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps))
            * (1.0 + scale.to(torch.float32))).to(dt)


def init_rms_norm(d: int, dtype, device) -> nn.Parameter:
    """Norm scales are raw vectors (zero-init, applied as 1 + scale)."""
    return param(torch.zeros((d,), dtype=dtype, device=device))


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_frequencies(rotary_dim: int, theta, device=None) -> torch.Tensor:
    """``theta ** -(2i / rotary_dim)`` in f32 (theta rounded to f32 first,
    as the reference's per-layer theta array is)."""
    expo = torch.arange(0, rotary_dim, 2, dtype=torch.float32,
                        device=device) / rotary_dim
    return torch.tensor(theta, dtype=torch.float32, device=device) ** (-expo)


def _rotate_pairs(x, sin, cos):
    """Rotate interleaved (even, odd) pairs of the last dim by the angles."""
    x1, x2 = x[..., 0::2], x[..., 1::2]
    o1 = x1 * cos - x2 * sin
    o2 = x2 * cos + x1 * sin
    return torch.stack([o1, o2], dim=-1).reshape(x.shape)


def apply_rope(x, positions, *, theta=10000.0, rotary_dim: int | None = None):
    """x: [B, S, H, Dh]; positions: [B, S] (int). Partial rotary supported:
    only the first ``rotary_dim`` channels rotate."""
    dh = x.shape[-1]
    rd = rotary_dim or dh
    inv = rope_frequencies(rd, theta, x.device)
    ang = positions[..., None].to(torch.float32) * inv   # [B,S,rd/2]
    sin = torch.sin(ang)[:, :, None, :]
    cos = torch.cos(ang)[:, :, None, :]
    out = _rotate_pairs(x[..., :rd], sin, cos)
    if rd < dh:
        out = torch.cat([out.to(x.dtype), x[..., rd:]], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x, positions3, *, theta=10000.0,
                sections: tuple[int, int, int] = (16, 24, 24)):
    """Multimodal RoPE (Qwen2-VL).  positions3: [3, B, S] (t, h, w ids);
    `sections` gives rotary half-dims per section, sum = Dh/2."""
    dh = x.shape[-1]
    if sum(sections) != dh // 2:
        raise ValueError(f"sections {sections} do not sum to {dh // 2}")
    inv = rope_frequencies(dh, theta, x.device)                 # [dh/2]
    ang = positions3[..., None].to(torch.float32) * inv         # [3,B,S,dh/2]
    sec_id = torch.as_tensor(
        np.repeat(np.arange(3), np.asarray(sections)), device=x.device)
    # select ang[sec_id[d], b, l, d] for each rotary dim d
    ang = ang.gather(0, sec_id.expand(1, *ang.shape[1:]))[0]    # [B,S,dh/2]
    sin = torch.sin(ang)[:, :, None, :]
    cos = torch.cos(ang)[:, :, None, :]
    return _rotate_pairs(x, sin, cos).to(x.dtype)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

class SwiGLU(nn.Module):
    """``w_gate``, ``w_up`` [d, f] and ``w_down`` [f, d]."""

    def __init__(self, d: int, f: int, dtype, generator, device):
        super().__init__()
        s_in, s_out = float(1.0 / np.sqrt(d)), float(1.0 / np.sqrt(f))
        self.w_gate = normal((d, f), dtype, generator, device, s_in)
        self.w_up = normal((d, f), dtype, generator, device, s_in)
        self.w_down = normal((f, d), dtype, generator, device, s_out)

    def forward(self, x):
        return swiglu(self, x)


def swiglu(p, x):
    h = torch.nn.functional.silu(x @ p.w_gate) * (x @ p.w_up)
    return h @ p.w_down


def relu_mlp(p, x):
    """``relu(x @ w_in + b_in) @ w_out + b_out`` (the enc-dec family's
    MLP; ``p`` holds the four tensors as attributes)."""
    return torch.relu(x @ p.w_in + p.b_in) @ p.w_out + p.b_out


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------

def embed(tok, tokens):
    """Rows of the ``tok [V, d]`` table for integer ``tokens``."""
    return tok[tokens.long()]


def unembed(tok, head_w, x, *, tied: bool):
    """Logits over the padded vocab: ``x @ tok.T`` when tied, else
    ``x @ head_w``."""
    w = tok.T if tied else head_w
    return x @ w.to(x.dtype)


def cross_entropy(logits, labels, *, ignore_id: int = -1):
    """Mean token cross-entropy in fp32; labels==ignore_id are masked."""
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    safe = torch.where(labels == ignore_id, 0, labels).long()
    ll = torch.take_along_dim(logits, safe[..., None], dim=-1)[..., 0]
    mask = (labels != ignore_id).to(torch.float32)
    nll = (lse - ll) * mask
    return nll.sum() / torch.clamp(mask.sum(), min=1.0)
