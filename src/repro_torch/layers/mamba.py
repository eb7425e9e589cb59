"""Mamba1 (falcon-mamba-7b) and Mamba2 (zamba2) state-space blocks.

The port of ``repro.layers.mamba``.  Projections are separate per-stream
weights (``w_x``, ``w_z``, ``w_b``, ``w_c``, ``w_dt``), as in the
reference.  The selective scan is a plain loop over time carrying the f32
SSM state: the reference cuts its scan into checkpointed chunks only to
bound the memory of the backward pass, and the forward pass computes the
same recurrence step by step.  Decode is the same body with S = 1.

Caches are returned anew (the reference's functional form): they are
O(1) in the context length, a few MB per layer at full width.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..launch.activations import BATCH, MODEL, constrain
from .common import normal, param, rms_norm


class MambaCache(NamedTuple):
    """Mamba1: conv history over the x stream + diagonal SSM state."""
    conv: torch.Tensor   # [B, W-1, d_inner]
    ssm: torch.Tensor    # [B, d_inner, d_state] f32


class Mamba2Cache(NamedTuple):
    conv_x: torch.Tensor  # [B, W-1, d_inner]
    conv_b: torch.Tensor  # [B, W-1, G*N]
    conv_c: torch.Tensor  # [B, W-1, G*N]
    ssm: torch.Tensor     # [B, H, Dh, N] f32


def _causal_conv(w, b, x, conv_state):
    """Depthwise causal conv.  x: [B, S, C], w: [W, C], conv_state:
    [B, W-1, C].  Returns (y, new_state: the last W-1 inputs)."""
    wlen, s = w.shape[0], x.shape[1]
    xp = torch.cat([conv_state.to(x.dtype), x], dim=1)
    y = sum(xp[:, i:i + s, :] * w[i] for i in range(wlen))
    return y + b, xp[:, s:, :]


def _ssm_scan(h, step, *streams):
    """Run ``h, y_t = step(h, *stream_t)`` over the time axis (dim 1) of
    each stream; returns (h_final, ys stacked on dim 1)."""
    ys = []
    for t in range(streams[0].shape[1]):
        h, y = step(h, *(x[:, t] for x in streams))
        ys.append(y)
    return h, torch.stack(ys, dim=1)


# ---------------------------------------------------------------------------
# Mamba-1 (selective scan, per-channel diagonal A)
# ---------------------------------------------------------------------------

class Mamba1(nn.Module):
    """Mamba1 weights under the reference's names (``a_log``, ``d_skip``
    f32 whatever the parameter dtype)."""

    def __init__(self, d: int, *, d_state: int = 16, expand: int = 2,
                 conv_w: int = 4, dt_rank: int | None = None,
                 dtype=torch.float32, generator=None, device=None):
        super().__init__()
        di = expand * d
        dt_rank = dt_rank or max(1, d // 16)
        s = float(1.0 / np.sqrt(d))
        s_di = float(1.0 / np.sqrt(di))
        mk = lambda shape, scale: normal(shape, dtype, generator, device,
                                         scale)
        self.w_x_in = mk((d, di), s)
        self.w_z_in = mk((d, di), s)
        self.conv_w = mk((conv_w, di), float(1.0 / np.sqrt(conv_w)))
        self.conv_b = param(torch.zeros((di,), dtype=dtype, device=device))
        self.w_dt_in = mk((di, dt_rank), s_di)
        self.w_b = mk((di, d_state), s_di)
        self.w_c = mk((di, d_state), s_di)
        self.w_dt = mk((dt_rank, di), float(1.0 / np.sqrt(dt_rank)))
        self.b_dt = param(torch.full((di,), -4.6, dtype=dtype,
                                     device=device))   # softplus^-1(0.01)
        a = torch.arange(1, d_state + 1, dtype=torch.float32, device=device)
        self.a_log = param(torch.log(a)[None, :].repeat(di, 1))
        self.d_skip = param(torch.ones((di,), dtype=torch.float32,
                                       device=device))
        self.w_out = mk((di, d), s_di)


def init_mamba1(d: int, *, d_state: int = 16, expand: int = 2,
                conv_w: int = 4, dt_rank: int | None = None,
                dtype=torch.float32, generator=None, device=None) -> Mamba1:
    return Mamba1(d, d_state=d_state, expand=expand, conv_w=conv_w,
                  dt_rank=dt_rank, dtype=dtype, generator=generator,
                  device=device)


def init_mamba1_cache(batch: int, di: int, d_state: int, conv_w: int,
                      dtype, device=None) -> MambaCache:
    return MambaCache(
        conv=torch.zeros((batch, conv_w - 1, di), dtype=dtype,
                         device=device),
        ssm=torch.zeros((batch, di, d_state), dtype=torch.float32,
                        device=device))


def mamba1(p: Mamba1, x, cache: MambaCache | None = None):
    """x: [B, S, D] -> (y, new_cache)."""
    b, s, d = x.shape
    di = p.w_out.shape[0]
    if cache is None:
        cache = init_mamba1_cache(b, di, p.a_log.shape[1],
                                  p.conv_w.shape[0], x.dtype, x.device)
    x = constrain(x, BATCH)
    xi = constrain(x @ p.w_x_in, BATCH, None, MODEL)
    z = constrain(x @ p.w_z_in, BATCH, None, MODEL)
    xi, new_conv = _causal_conv(p.conv_w, p.conv_b, xi, cache.conv)
    xi = F.silu(xi)
    dt = F.softplus((xi @ p.w_dt_in) @ p.w_dt + p.b_dt)
    dt = constrain(dt, BATCH, None, MODEL)
    bmat = xi @ p.w_b                                      # [B,S,N]
    cmat = xi @ p.w_c                                      # [B,S,N]
    a = -torch.exp(p.a_log)                                # [di,N]

    def step(h, dt_t, xi_t, b_t, c_t):
        da_t = torch.exp(dt_t[..., None] * a)              # [B,di,N]
        dbx_t = (dt_t * xi_t)[..., None] * b_t[:, None, :]
        h = da_t * h + dbx_t                               # [B,di,N]
        return h, torch.einsum("bdn,bn->bd", h, c_t)

    f32 = torch.float32
    h_t, ys = _ssm_scan(cache.ssm, step, dt.to(f32), xi.to(f32),
                        bmat.to(f32), cmat.to(f32))
    y = ys.to(x.dtype)                                     # [B,S,di]
    y = y + xi * p.d_skip.to(x.dtype)
    y = y * F.silu(z)
    return y @ p.w_out, MambaCache(new_conv, h_t)


# ---------------------------------------------------------------------------
# Mamba-2 (SSD: scalar decay per head, multi-head state)
# ---------------------------------------------------------------------------

class Mamba2(nn.Module):
    """Mamba2 weights under the reference's names (``a_log``, ``dt_bias``
    and ``d_skip`` f32 whatever the parameter dtype)."""

    def __init__(self, d: int, *, d_state: int = 64, expand: int = 2,
                 head_dim: int = 64, conv_w: int = 4, n_groups: int = 1,
                 dtype=torch.float32, generator=None, device=None):
        super().__init__()
        di = expand * d
        nh = di // head_dim
        gn = n_groups * d_state
        s = float(1.0 / np.sqrt(d))
        s_conv = float(1.0 / np.sqrt(conv_w))
        mk = lambda shape, scale: normal(shape, dtype, generator, device,
                                         scale)
        zeros = lambda n, dt=dtype: param(torch.zeros((n,), dtype=dt,
                                                      device=device))
        self.w_z = mk((d, di), s)
        self.w_x = mk((d, di), s)
        self.w_b = mk((d, gn), s)
        self.w_c = mk((d, gn), s)
        self.w_dt = mk((d, nh), s)
        self.conv_x_w = mk((conv_w, di), s_conv)
        self.conv_x_b = zeros(di)
        self.conv_b_w = mk((conv_w, gn), s_conv)
        self.conv_b_b = zeros(gn)
        self.conv_c_w = mk((conv_w, gn), s_conv)
        self.conv_c_b = zeros(gn)
        self.a_log = zeros(nh, torch.float32)
        self.dt_bias = param(torch.full((nh,), -4.6, dtype=torch.float32,
                                        device=device))
        self.d_skip = param(torch.ones((nh,), dtype=torch.float32,
                                       device=device))
        self.norm_scale = zeros(di)
        self.w_out = mk((di, d), float(1.0 / np.sqrt(di)))


def init_mamba2(d: int, *, d_state: int = 64, expand: int = 2,
                head_dim: int = 64, conv_w: int = 4, n_groups: int = 1,
                dtype=torch.float32, generator=None, device=None) -> Mamba2:
    return Mamba2(d, d_state=d_state, expand=expand, head_dim=head_dim,
                  conv_w=conv_w, n_groups=n_groups, dtype=dtype,
                  generator=generator, device=device)


def init_mamba2_cache(batch: int, di: int, gn: int, nh: int, head_dim: int,
                      d_state: int, conv_w: int, dtype,
                      device=None) -> Mamba2Cache:
    z = lambda c: torch.zeros((batch, conv_w - 1, c), dtype=dtype,
                              device=device)
    return Mamba2Cache(
        conv_x=z(di), conv_b=z(gn), conv_c=z(gn),
        ssm=torch.zeros((batch, nh, head_dim, d_state), dtype=torch.float32,
                        device=device))


def mamba2(p: Mamba2, x, cache: Mamba2Cache | None = None, *,
           head_dim: int = 64, n_groups: int = 1):
    """x: [B, S, D] -> (y, new_cache)."""
    b, s, d = x.shape
    di = p.w_out.shape[0]
    nh = p.a_log.shape[0]
    gn = p.w_b.shape[1]
    d_state = gn // n_groups
    if cache is None:
        cache = init_mamba2_cache(b, di, gn, nh, head_dim, d_state,
                                  p.conv_x_w.shape[0], x.dtype, x.device)
    x = constrain(x, BATCH)
    z = constrain(x @ p.w_z, BATCH, None, MODEL)
    xi = constrain(x @ p.w_x, BATCH, None, MODEL)
    bmat = x @ p.w_b
    cmat = x @ p.w_c
    dt_in = x @ p.w_dt
    xi, new_cx = _causal_conv(p.conv_x_w, p.conv_x_b, xi, cache.conv_x)
    bmat, new_cb = _causal_conv(p.conv_b_w, p.conv_b_b, bmat, cache.conv_b)
    cmat, new_cc = _causal_conv(p.conv_c_w, p.conv_c_b, cmat, cache.conv_c)
    xi = F.silu(xi).reshape(b, s, nh, head_dim)
    rep = nh // n_groups
    # heads repeated over groups: group g serves heads [g*rep, (g+1)*rep)
    bmat = F.silu(bmat).reshape(b, s, n_groups, d_state) \
        .repeat_interleave(rep, dim=2)                     # [B,S,H,N]
    cmat = F.silu(cmat).reshape(b, s, n_groups, d_state) \
        .repeat_interleave(rep, dim=2)

    f32 = torch.float32
    dt = F.softplus(dt_in.to(f32) + p.dt_bias)             # [B,S,H]
    da = torch.exp(dt * -torch.exp(p.a_log))               # [B,S,H]
    dtx = dt[..., None] * xi.to(f32)                       # [B,S,H,Dh]

    def step(h, da_t, dtx_t, b_t, c_t):
        dbx_t = dtx_t[..., None] * b_t[:, :, None, :]      # [B,H,Dh,N]
        h = da_t[:, :, None, None] * h + dbx_t             # [B,H,Dh,N]
        return h, torch.einsum("bhdn,bhn->bhd", h, c_t)

    h_t, y = _ssm_scan(cache.ssm, step, da, dtx, bmat.to(f32),
                       cmat.to(f32))                       # [B,S,H,Dh]
    y = y + xi.to(f32) * p.d_skip[:, None]
    y = y.reshape(b, s, di).to(x.dtype)
    y = rms_norm(p.norm_scale, y * F.silu(z))
    return y @ p.w_out, Mamba2Cache(new_cx, new_cb, new_cc, h_t)
