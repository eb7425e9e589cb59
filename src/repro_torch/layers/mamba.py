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

from ..kernels import is_dtensor
from ..launch.activations import BATCH, MODEL, constrain, layout, zeros
from ..launch.hlo_analysis import active_recorder
from .common import (column_parallel_matmul, normal, param, rms_norm,
                     row_parallel_matmul)


class MambaCache(NamedTuple):
    """Mamba1: conv history over the x stream + diagonal SSM state."""
    conv: torch.Tensor   # [B, W-1, d_inner]
    ssm: torch.Tensor    # [B, d_inner, d_state] f32


class Mamba2Cache(NamedTuple):
    conv_x: torch.Tensor  # [B, W-1, d_inner]
    conv_b: torch.Tensor  # [B, W-1, G*N]
    conv_c: torch.Tensor  # [B, W-1, G*N]
    ssm: torch.Tensor     # [B, H, Dh, N] f32


def _batch_sharded(x) -> bool:
    """A DTensor whose rows are split over the data axes: its products
    take the tensor-parallel forms below.  A batch the data axes cannot
    split (long_500k's one row) leaves the weights where the rules put
    them, as GSPMD does, rather than gather them for one row."""
    return is_dtensor(x) and any(p.is_shard(0) for p in x.placements)


def _in_proj(x, w):
    """``x @ w`` into the inner width (column-parallel for a sharded
    batch: DTensor left to itself may gather ``w`` in the backward and
    compute the whole width on every rank)."""
    return column_parallel_matmul(x, w) if _batch_sharded(x) else x @ w


def _out_proj(y, w):
    """``y @ w`` out of the inner width (row-parallel for a sharded batch,
    the partial sums laid out as the batch)."""
    if _batch_sharded(y):
        return row_parallel_matmul(y, w)
    return constrain(y @ w, BATCH)


def _causal_conv(w, b, x, conv_state):
    """Depthwise causal conv.  x: [B, S, C], w: [W, C], conv_state:
    [B, W-1, C].  Returns (y, new_state: the last W-1 inputs)."""
    wlen, s = w.shape[0], x.shape[1]
    xp = torch.cat([conv_state.to(x.dtype), x], dim=1)
    y = sum(xp[:, i:i + s, :] * w[i] for i in range(wlen))
    return y + b, xp[:, s:, :]


def _ssm_scan(h, step, *streams):
    """Run ``h, y_t = step(h, *stream_t)`` over the time axis (dim 1) of
    each stream; returns (h_final, ys stacked on dim 1).

    Under a cost recorder (`launch.hlo_analysis.active_recorder`) the body
    runs once inside its ``repeat`` of the trip count, as the reference's
    analyzer multiplies a ``while`` body: h and ys keep their shapes, their
    values are not the scan's.  The forward counts exactly what the loop
    would; under autograd the body's backward is multiplied too, but not the
    loop's accumulation of the T gradients of what the body closes over."""
    n = streams[0].shape[1]
    rec = active_recorder()
    if rec is not None and n > 1:
        with rec.repeat("ssm_scan", n):
            h, y = step(h, *(x[:, 0] for x in streams))
        return h, _StackRepeated.apply(y, n)
    ys = []
    for t in range(streams[0].shape[1]):
        h, y = step(h, *(x[:, t] for x in streams))
        ys.append(y)
    return h, torch.stack(ys, dim=1)


class _StackRepeated(torch.autograd.Function):
    """``torch.stack([y] * n, dim=1)`` whose backward hands the body one
    step's gradient (the recorder multiplies that step by n), as the loop's
    stack hands each step its own."""

    @staticmethod
    def forward(ctx, y, n):
        return torch.stack([y] * n, dim=1)

    @staticmethod
    def backward(ctx, g):
        return g.select(1, 0), None


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


def _mamba1_step(a):
    """The Mamba1 scan body over the decay ``a`` [di, N]."""
    def step(h, dt_t, xi_t, b_t, c_t):
        da_t = torch.exp(dt_t[..., None] * a)              # [B,di,N]
        dbx_t = (dt_t * xi_t)[..., None] * b_t[:, None, :]
        h = da_t * h + dbx_t                               # [B,di,N]
        return h, torch.einsum("bdn,bn->bd", h, c_t)
    return step


def _mamba2_step():
    """The Mamba2 (SSD) scan body: scalar decay per head."""
    def step(h, da_t, dtx_t, b_t, c_t):
        dbx_t = dtx_t[..., None] * b_t[:, :, None, :]      # [B,H,Dh,N]
        h = da_t[:, :, None, None] * h + dbx_t             # [B,H,Dh,N]
        return h, torch.einsum("bhdn,bhn->bhd", h, c_t)
    return step


def _scan_per_shard(step_of, consts, h, streams, h_spec, const_specs,
                    stream_specs):
    """`_ssm_scan` of ``step_of(*consts)`` over DTensor operands, per shard
    (``local_map``): the recurrence is independent per batch row and per
    channel or head, so each rank scans its rows and its "model" slice,
    every operand laid out as its activation spec (`layout`).  ys come
    back laid out as the second stream; the constants' gradients are
    partial sums over the mesh dims that do not shard them."""
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map
    mesh = h.device_mesh
    h_pl = layout(mesh, h.shape, *h_spec)
    c_pls = [layout(mesh, c.shape, *sp) for c, sp in zip(consts, const_specs)]
    s_pls = [layout(mesh, t.shape, *sp) for t, sp in zip(streams,
                                                          stream_specs)]
    c_grads = [tuple(Partial() if q.is_replicate() else q for q in pl)
               for pl in c_pls]
    n = len(consts)
    return local_map(
        lambda h, *args: _ssm_scan(h, step_of(*args[:n]), *args[n:]),
        out_placements=(h_pl, s_pls[1]),
        in_placements=(h_pl, *c_pls, *s_pls),
        in_grad_placements=(h_pl, *c_grads, *s_pls), device_mesh=mesh,
        redistribute_inputs=True)(h, *consts, *streams)


def mamba1(p: Mamba1, x, cache: MambaCache | None = None):
    """x: [B, S, D] -> (y, new_cache)."""
    b, s, d = x.shape
    di = p.w_out.shape[0]
    if cache is None and is_dtensor(x):
        w1, n = p.conv_w.shape[0] - 1, p.a_log.shape[1]
        cache = MambaCache(zeros((b, w1, di), x.dtype, x, BATCH, None, MODEL),
                           zeros((b, di, n), torch.float32, x, BATCH, MODEL))
    elif cache is None:
        cache = init_mamba1_cache(b, di, p.a_log.shape[1],
                                  p.conv_w.shape[0], x.dtype, x.device)
    x = constrain(x, BATCH)
    xi = constrain(_in_proj(x, p.w_x_in), BATCH, None, MODEL)
    z = constrain(_in_proj(x, p.w_z_in), BATCH, None, MODEL)
    xi, new_conv = _causal_conv(p.conv_w, p.conv_b, xi, cache.conv)
    xi = F.silu(xi)
    # the rank's partial [B,S,R] is summed before w_dt (column-parallel);
    # DTensor left to itself gathers w_dt and computes every channel
    dt = F.softplus(constrain(xi @ p.w_dt_in, BATCH) @ p.w_dt + p.b_dt)
    dt = constrain(dt, BATCH, None, MODEL)
    bmat = xi @ p.w_b                                      # [B,S,N]
    cmat = xi @ p.w_c                                      # [B,S,N]
    a = -torch.exp(p.a_log)                                # [di,N]
    f32 = torch.float32
    streams = (dt.to(f32), xi.to(f32), bmat.to(f32), cmat.to(f32))
    if is_dtensor(x):
        h_t, ys = _scan_per_shard(
            _mamba1_step, (a,), cache.ssm, streams, (BATCH, MODEL),
            ((MODEL,),), ((BATCH, None, MODEL),) * 2 + ((BATCH,),) * 2)
    else:
        h_t, ys = _ssm_scan(cache.ssm, _mamba1_step(a), *streams)
    y = ys.to(x.dtype)                                     # [B,S,di]
    y = y + xi * p.d_skip.to(x.dtype)
    y = y * F.silu(z)
    return _out_proj(y, p.w_out), MambaCache(new_conv, h_t)


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
    if cache is None and is_dtensor(x):
        w1 = p.conv_x_w.shape[0] - 1
        cache = Mamba2Cache(
            zeros((b, w1, di), x.dtype, x, BATCH, None, MODEL),
            zeros((b, w1, gn), x.dtype, x, BATCH, None, MODEL),
            zeros((b, w1, gn), x.dtype, x, BATCH, None, MODEL),
            zeros((b, nh, head_dim, d_state), torch.float32, x, BATCH,
                  MODEL))
    elif cache is None:
        cache = init_mamba2_cache(b, di, gn, nh, head_dim, d_state,
                                  p.conv_x_w.shape[0], x.dtype, x.device)
    x = constrain(x, BATCH)
    z = constrain(_in_proj(x, p.w_z), BATCH, None, MODEL)
    xi = constrain(_in_proj(x, p.w_x), BATCH, None, MODEL)
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

    streams = (da, dtx, bmat.to(f32), cmat.to(f32))
    if is_dtensor(x):
        h_t, y = _scan_per_shard(_mamba2_step, (), cache.ssm, streams,
                                 (BATCH, MODEL), (),
                                 ((BATCH, None, MODEL),) * 4)
    else:
        h_t, y = _ssm_scan(cache.ssm, _mamba2_step(), *streams)  # [B,S,H,Dh]
    y = y + xi.to(f32) * p.d_skip[:, None]
    y = y.reshape(b, s, di).to(x.dtype)
    y = rms_norm(p.norm_scale, y * F.silu(z))
    return _out_proj(y, p.w_out), Mamba2Cache(new_cx, new_cb, new_cc, h_t)
