"""One decode step (S = 1) of the Mamba2 mixer after its input
projections, as a CUDA kernel path (``csrc/mamba2_decode.cu``: three
kernels, one launch).

From the five projections (``z``, ``x``, ``B``, ``C``, ``dt_in``), the
mixer's weights and its `Mamba2Cache` it rolls the three conv windows,
applies the convs, biases and silu, computes softplus(dt + dt_bias), the
per-head decay and dt * x, updates the state ``h = da * h + (dt * x) (x)
B``, reads ``y = h . C + D * x`` and returns the gated RMS norm of ``y *
silu(z)`` over d_inner, ready for the output projection.  Each state tile
is read once and written once: to the cache's own tensors with
``in_place=True``, to fresh ones otherwise.  It replaces no TPU kernel:
the reference leaves the step to XLA.  `mamba2_decode_plain` is the plain
version (the same operations in PyTorch as `layers.mamba.mamba2` takes at
S = 1), which the CPU runs.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import launches, reject_dtensors
from ._build import launch

MAX_CONV_W = 8


def covers(d_state: int, conv_w: int) -> bool:
    """Whether the kernel takes a state this wide and a conv of this many
    taps: d_state a multiple of 4 whose quarter is a power of two up to
    32, or 128, 256 or 512; 2 to 8 taps.  Any head_dim and number of
    groups."""
    q = d_state // 4
    return d_state % 4 == 0 and q >= 1 and \
        ((q <= 32 and q & (q - 1) == 0) or d_state in (128, 256, 512)) and \
        2 <= conv_w <= MAX_CONV_W


def _conv(w, bias, x, window):
    """Causal conv of one step: (silu-less output [B, C], the rolled window
    [B, W-1, C], a fresh tensor)."""
    xp = torch.cat([window.to(x.dtype), x[:, None]], dim=1)
    y = sum(xp[:, i] * w[i] for i in range(w.shape[0]))
    return y + bias, xp[:, 1:].clone()


def mamba2_decode_plain(p, z, x, bm, cm, dt_in, cache, *, eps: float,
                        in_place: bool = False):
    """The plain version: (y [B, di], the cache after the step).  ``p``
    holds the mixer's weights under `layers.mamba.Mamba2`'s names; ``cache``
    is (conv_x, conv_b, conv_c, ssm), returned as its own type: itself,
    written, with ``in_place``, else fresh tensors."""
    conv_x, conv_b, conv_c, ssm = cache
    b, di = x.shape
    nh, dh, n = ssm.shape[1:]
    rep = nh // (bm.shape[1] // n)
    f32 = torch.float32
    xc, new_cx = _conv(p.conv_x_w, p.conv_x_b, x, conv_x)
    bc, new_cb = _conv(p.conv_b_w, p.conv_b_b, bm, conv_b)
    cc, new_cc = _conv(p.conv_c_w, p.conv_c_b, cm, conv_c)
    xc = F.silu(xc).reshape(b, nh, dh)
    bc = F.silu(bc).reshape(b, -1, n).repeat_interleave(rep, dim=1)
    cc = F.silu(cc).reshape(b, -1, n).repeat_interleave(rep, dim=1)
    dt = F.softplus(dt_in.to(f32) + p.dt_bias)               # [B,H]
    da = torch.exp(dt * -torch.exp(p.a_log))
    dtx = dt[..., None] * xc.to(f32)                          # [B,H,Dh]
    dbx = dtx[..., None] * bc.to(f32)[:, :, None, :]          # [B,H,Dh,N]
    h = da[:, :, None, None] * ssm + dbx
    y = torch.einsum("bhdn,bhn->bhd", h, cc.to(f32))
    y = (y + xc.to(f32) * p.d_skip[:, None]).reshape(b, di).to(x.dtype)
    v = (y * F.silu(z)).to(f32)
    var = torch.mean(torch.square(v), dim=-1, keepdim=True)
    y = ((v * torch.rsqrt(var + eps))
         * (1.0 + p.norm_scale.to(f32))).to(x.dtype)
    new = (new_cx, new_cb, new_cc, h)
    if in_place:
        for dst, src in zip(cache, new):
            dst.copy_(src)
        return y, cache
    return y, type(cache)(*new)


def mamba2_decode(p, z, x, bm, cm, dt_in, cache, *, eps: float,
                  in_place: bool = False):
    """(y [B, di], the cache after the step): the kernel on CUDA tensors
    (f32, contiguous), the plain version on CPU tensors.

    z, x [B, di]; bm, cm [B, G*N]; dt_in [B, H]; ``p``'s conv weights [W,
    C] and biases [C], ``a_log``, ``dt_bias``, ``d_skip`` [H] and
    ``norm_scale`` [di]; ``cache`` (conv_x [B, W-1, di], conv_b and conv_c
    [B, W-1, G*N], ssm [B, H, Dh, N]).  With ``in_place`` the kernel writes
    the cache's own tensors and returns the cache; otherwise it leaves
    them as they are and returns the cache's type over fresh tensors.  One
    call counts one launch."""
    ops = {"z": z, "x": x, "bm": bm, "cm": cm, "dt_in": dt_in,
           "conv_x_w": p.conv_x_w, "conv_x_b": p.conv_x_b,
           "conv_b_w": p.conv_b_w, "conv_b_b": p.conv_b_b,
           "conv_c_w": p.conv_c_w, "conv_c_b": p.conv_c_b,
           "a_log": p.a_log, "dt_bias": p.dt_bias, "d_skip": p.d_skip,
           "norm_scale": p.norm_scale, "conv_x": cache[0],
           "conv_b": cache[1], "conv_c": cache[2], "ssm": cache[3]}
    reject_dtensors(**ops)
    if x.device.type == "cpu":
        return mamba2_decode_plain(p, z, x, bm, cm, dt_in, cache, eps=eps,
                                   in_place=in_place)
    for name, t in ops.items():
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}; x is on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
        if t.dtype != torch.float32:
            raise ValueError(f"{name} has dtype {t.dtype}, expected float32")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} is not aligned to 16 bytes")
    b, di = x.shape
    _, nh, dh, n = cache[3].shape
    gn = bm.shape[1]
    wlen = p.conv_x_w.shape[0]
    want = {"z": (b, di), "bm": (b, gn), "cm": (b, gn), "dt_in": (b, nh),
            "conv_x_w": (wlen, di), "conv_x_b": (di,),
            "conv_b_w": (wlen, gn), "conv_b_b": (gn,),
            "conv_c_w": (wlen, gn), "conv_c_b": (gn,), "a_log": (nh,),
            "dt_bias": (nh,), "d_skip": (nh,), "norm_scale": (di,),
            "conv_x": (b, wlen - 1, di), "conv_b": (b, wlen - 1, gn),
            "conv_c": (b, wlen - 1, gn), "ssm": (b, nh, dh, n)}
    bad = {k: tuple(ops[k].shape) for k, s in want.items()
           if tuple(ops[k].shape) != s}
    if bad or nh * dh != di or gn % n or nh % (gn // n):
        raise ValueError(f"shapes do not agree with x {tuple(x.shape)} and "
                         f"ssm {tuple(cache[3].shape)}: {bad}")
    if not covers(n, wlen):
        raise ValueError(f"the kernel does not take d_state {n} with a "
                         f"conv of {wlen}")
    out = cache if in_place else tuple(torch.empty_like(t) for t in cache)
    ws = torch.empty(b * (2 * di + 2 * gn + 3 * nh) + 3,
                     dtype=torch.float32, device=x.device)
    y = torch.empty((b, di), dtype=torch.float32, device=x.device)
    launch("mamba2_decode_launch",
           *(t.data_ptr() for t in (z, x, bm, cm, dt_in)),
           *(t.data_ptr() for t in (p.conv_x_w, p.conv_x_b, p.conv_b_w,
                                    p.conv_b_b, p.conv_c_w, p.conv_c_b,
                                    p.a_log, p.dt_bias, p.d_skip,
                                    p.norm_scale)),
           *(t.data_ptr() for t in cache), *(t.data_ptr() for t in out),
           ws.data_ptr(), y.data_ptr(), b, di, gn, nh, dh, n, wlen,
           float(eps), torch.cuda.current_stream(x.device).cuda_stream)
    launches["mamba2_decode"] += 1
    return y, (cache if in_place else type(cache)(*out))
