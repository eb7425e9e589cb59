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

from ..kernels import is_dtensor
from ..kernels.flash_attention import flash_attention
from ..launch.activations import (BATCH, MODEL, constrain, current_mesh,
                                  rows_like)
from ..launch.mesh import mesh_shape
from .common import (apply_mrope, apply_rope, normal, param,
                     per_shard_matmul, rms_norm, row_parallel_matmul)

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
        if is_dtensor(x) and positions is not None and \
                not is_dtensor(positions):
            positions = rows_like(positions, x, positions.ndim - 2)
        x = constrain(x, BATCH)
        # the reference's canonical layout: batch over the data axes, heads
        # over "model"; where the heads do not divide the model axis, the
        # query sequence dim instead (sequence-parallel attention)
        mesh = current_mesh()
        msize = mesh_shape(mesh).get("model", 1) if mesh is not None else 1
        seq_parallel = (cache is None or cache_pos is None) and s > 1 and \
            self.wq.shape[1] % max(msize, 1) != 0 and \
            s % max(msize, 1) == 0
        q, k, v = _project_qkv(self, x, positions, theta=theta,
                               rotary_dim=rotary_dim,
                               mrope_sections=mrope_sections,
                               q_rows=seq_parallel and is_dtensor(x))
        if seq_parallel:
            q = constrain(q, BATCH, MODEL)
            k = constrain(k, BATCH, None, MODEL)
            v = constrain(v, BATCH, None, MODEL)
        else:
            q = constrain(q, BATCH, None, MODEL)
            k = constrain(k, BATCH, None, MODEL)
            v = constrain(v, BATCH, None, MODEL)
        on_card = x.device.type == "cuda"
        if cache is not None and cache_pos is not None:    # decode: s == 1
            pos = int(cache_pos)
            cap = cache.k.shape[2]
            if not 0 <= pos < cap:
                raise ValueError(f"cache_pos {pos} outside the cache [0, "
                                 f"{cap})")
            _write_cache(cache, pos, k, v)
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
                _write_cache(cache, 0, k, v)
            if on_card and (cache is not None or not records_grad(q, k, v)):
                out = self.attend(q.transpose(1, 2), k.transpose(1, 2),
                                  v.transpose(1, 2), causal=True,
                                  window=window).transpose(1, 2)
            elif s >= CHUNKED_THRESHOLD:
                out = chunked_attention(q, k, v, window=window, chunk=CHUNK)
            else:
                out = _sdpa(q, k, v, causal_mask(s, s, window=window,
                                                 device=x.device))
        if seq_parallel:
            out = constrain(out, BATCH, MODEL)
        else:
            out = constrain(out, BATCH, None, MODEL)
        wo = self.wo.reshape(-1, self.wo.shape[-1])
        if seq_parallel and is_dtensor(out):
            y = per_shard_matmul(out.reshape(b, s, -1), wo)
        elif is_dtensor(out):
            y = row_parallel_matmul(out.reshape(b, s, -1), wo)
        else:
            y = out.reshape(b, s, -1) @ wo
        return constrain(y, BATCH), cache


def _write_cache(cache: KVCache, pos: int, k, v) -> None:
    """Write k/v [B, s, Hkv, dh] into the cache's positions [pos, pos+s),
    in place."""
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)
    if is_dtensor(cache.k):
        _write_sharded(cache.k, pos, kt.to(cache.k.dtype))
        _write_sharded(cache.v, pos, vt.to(cache.v.dtype))
        return
    s = k.shape[1]
    cache.k[:, :, pos:pos + s] = kt.to(cache.k.dtype)
    cache.v[:, :, pos:pos + s] = vt.to(cache.v.dtype)


def _write_sharded(buf, pos: int, val) -> None:
    """``buf[:, :, pos:pos+s] = val`` on a DTensor cache [B, Hkv, cap, dh]
    whose sequence dim may be sharded (sequence-parallel decode): each rank
    writes the rows of [pos, pos+s) that its shard holds."""
    from torch.distributed.tensor import Replicate, Shard
    mesh, placements = buf.device_mesh, buf.placements
    local = buf.to_local()
    n = local.shape[2]
    lo = 0
    for i, p in enumerate(placements):
        if isinstance(p, Shard) and p.dim == 2:
            lo = lo * mesh.size(i) + mesh.get_local_rank(i) * n
    val = val.redistribute(mesh, [Replicate() if isinstance(p, Shard) and
                                  p.dim == 2 else p for p in placements]
                           ).to_local()
    a, b = max(pos, lo), min(pos + val.shape[2], lo + n)
    if a < b:
        local[:, :, a - lo:b - lo] = val[:, :, a - pos:b - pos]


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


def _project_qkv(p, x, positions, *, theta, rotary_dim, mrope_sections,
                 q_rows: bool = False):
    """q [B,S,H,dh], k/v [B,S,Hkv,dh]: projection, bias, qk-norm, RoPE.
    ``q_rows`` (DTensor, sequence-parallel attention): q is projected from
    this rank's query rows only, as GSPMD partitions it."""
    b, s, d = x.shape
    if q_rows:
        from torch.distributed.tensor import Replicate
        wq = p.wq.redistribute(x.device_mesh, [Replicate()] * x.device_mesh.ndim)
        q = per_shard_matmul(constrain(x, BATCH, MODEL),
                             wq.reshape(d, -1)).reshape(b, s, *p.wq.shape[1:])
    else:
        q = _heads(x.reshape(b * s, d), p.wq).reshape(b, s,
                                                       *p.wq.shape[1:])
    k = _heads(x.reshape(b * s, d), p.wk).reshape(b, s, *p.wk.shape[1:])
    v = _heads(x.reshape(b * s, d), p.wv).reshape(b, s, *p.wv.shape[1:])
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


def _heads(x2, w):
    """``x2 [N, d] @ w [d, n, dh]`` flattened to [N, n * dh].  A DTensor
    product whose n heads do not divide "model" is computed per shard with
    the heads whole on every rank, as the reference keeps such heads
    replicated: DTensor would otherwise split the flat columns over
    "model", and they could not be split back into heads.  So is one head
    (DTensor cannot flatten a sharded dim of size 1)."""
    if is_dtensor(x2):
        from torch.distributed.tensor import Replicate
        mesh = x2.device_mesh
        names = tuple(mesh.mesh_dim_names)
        m = mesh.size(names.index("model")) if "model" in names else 1
        if w.shape[1] % m or w.shape[1] == 1:
            return per_shard_matmul(x2, w.redistribute(
                mesh, [Replicate()] * mesh.ndim).reshape(w.shape[0], -1))
    return x2 @ w.reshape(w.shape[0], -1)


def project_cross_kv(p: Attention, memory) -> KVCache:
    """The encoder memory's K/V for cross attention, head-major
    [B, Hkv, T, dh] as a KV cache holds them (computed once at prefill)."""
    b, t, d = memory.shape
    m = memory.reshape(b * t, d)
    k = _heads(m, p.wk).reshape(b, t, *p.wk.shape[1:])
    v = _heads(m, p.wv).reshape(b, t, *p.wv.shape[1:])
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
    q = _heads(x.reshape(b * s, d), p.wq).reshape(b, s, *p.wq.shape[1:])
    if p.q_norm is not None:
        q = rms_norm(p.q_norm, q)
    kv = kv_cache if kv_cache is not None else project_cross_kv(p, memory)
    if x.device.type == "cuda" and not records_grad(q, kv.k, kv.v):
        out = p.attend(q.transpose(1, 2), kv.k, kv.v, causal=False,
                       window=-1).transpose(1, 2)
    else:
        out = _sdpa(q, kv.k.transpose(1, 2), kv.v.transpose(1, 2), None)
    y = out.reshape(b, s, -1) @ p.wo.reshape(-1, p.wo.shape[-1])
    return constrain(y, BATCH)


def records_grad(*tensors) -> bool:
    """Whether autograd records any of the tensors: the attention then
    takes the differentiable train path, not the forward-only kernel."""
    return any(t.requires_grad for t in tensors)


def _sdpa(q, k, v, mask):
    """q: [B,S,H,Dh], k/v: [B,T,Hkv,Dh], mask: broadcastable [B,1,S,T].
    GQA groups the query heads ([B,S,Hkv,G,Dh]); no head repeat.  DTensor
    operands go through `_per_shard`."""
    if is_dtensor(q):
        return _per_shard(lambda q, k, v, mask, row0, group:
                          _sdpa(q, k, v, mask) if group is None else
                          _sdpa_seq_sharded(q, k, v, mask, group),
                          q, k, v, mask)
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
    window; `offset` = absolute position of q[0] minus k[0].  DTensor
    operands go through `_per_shard`.
    """
    if is_dtensor(q):
        return _per_shard(lambda q, k, v, _, row0, group: chunked_attention(
            q, k, v, window=window, chunk=chunk, offset=offset + row0),
            q, k, v, None)
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


# ---------------------------------------------------------------------------
# DTensor operands: attention per shard (the reference's shard_map idiom)
# ---------------------------------------------------------------------------

def _per_shard(body, q, k, v, mask):
    """Attention of DTensor operands as ``local_map`` of a plain body, each
    rank on its batch rows (over the data axes) and one of:

      heads   query heads over "model" (k/v heads too where they divide;
              else each rank takes the kv heads its query heads read);
      seq     query rows over "model" (heads that do not divide it), k/v
              whole, the mask's query rows sharded alike;
      kv_seq  the cache's sequence over "model" (decode against a
              sequence-parallel cache): `_sdpa_seq_sharded` combines the
              ranks' partial softmax with all-reduces;
      whole   nothing over "model".

    ``body(q, k, v, mask, row0, group)`` gets local tensors, the first
    query row of this rank's shard and, in kv_seq, the "model" group."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = q.device_mesh
    names = tuple(mesh.mesh_dim_names)
    b, s, hq, _ = q.shape
    hkv = k.shape[2]
    dp = [i for i, a in enumerate(names) if a in ("pod", "data")]
    dsize = int(np.prod([mesh.size(i) for i in dp]))
    mi = names.index("model") if "model" in names else None
    m = mesh.size(mi) if mi is not None else 1
    j = mesh.get_local_rank(mi) if mi is not None else 0
    hl, g = hq // m, hq // hkv
    kp = k.placements[mi] if mi is not None else Replicate()
    if m == 1:
        mode = "whole"
    elif isinstance(kp, Shard) and kp.dim == 1:
        mode = "kv_seq"
    elif hq % m == 0 and (hkv % m == 0 or hl % g == 0 or g % hl == 0):
        mode = "heads"
    elif s % m == 0 and s > 1:
        mode = "seq"
    else:
        mode = "whole"

    def lay(model, batch: bool = True):
        out = [Replicate()] * mesh.ndim
        if batch and b % dsize == 0:
            for i in dp:
                out[i] = Shard(0)
        if mi is not None and model is not None:
            out[mi] = model
        return tuple(out)

    kv_model = {"heads": Shard(2) if hkv % m == 0 else None,
                "kv_seq": Shard(1)}.get(mode)
    q_model = {"heads": Shard(2), "seq": Shard(1)}.get(mode)
    mask_model = {"seq": Shard(2), "kv_seq": Shard(3)}.get(mode)
    group = mesh.get_group(mi) if mode == "kv_seq" else None
    row0 = j * (s // m) if mode == "seq" else 0

    def local(q, k, v, mask):
        if mode == "heads" and hkv % m:
            kv0, kv1 = j * hl // g, ((j + 1) * hl - 1) // g + 1
            k, v = k[:, :, kv0:kv1], v[:, :, kv0:kv1]
        return body(q, k, v, mask, row0, group)

    mask_pl = None
    if mask is not None:
        if not is_dtensor(mask):
            mask = DTensor.from_local(mask, mesh, [Replicate()] * mesh.ndim,
                                      run_check=False)
        mask_pl = lay(mask_model, batch=False)
    out_pl = lay(q_model)
    return local_map(local, out_placements=(out_pl,),
                     in_placements=(out_pl, lay(kv_model), lay(kv_model),
                                    mask_pl),
                     device_mesh=mesh, redistribute_inputs=True)(
        q, k, v, mask)


def _sdpa_seq_sharded(q, k, v, mask, group):
    """`_sdpa` of local shards when k/v hold this rank's part of the
    sequence: local logits, then the softmax's max and sum and the
    weighted values all-reduced over ``group`` (flash decoding)."""
    import torch.distributed._functional_collectives as funcol
    b, s, hq, dh = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, s, hkv, hq // hkv, dh)
    logits = torch.einsum("bshge,bthe->bhgst", qg, k) * (1.0 / np.sqrt(dh))
    if mask is not None:
        logits = torch.where(mask[:, :, None], logits, NEG_INF)
    logits = logits.to(torch.float32)
    m = funcol.all_reduce(logits.amax(dim=-1, keepdim=True), "max", group)
    p = torch.exp(logits - m)
    denom = funcol.all_reduce(p.sum(dim=-1, keepdim=True), "sum", group)
    out = torch.einsum("bhgst,bthe->bshge", (p / denom).to(v.dtype), v)
    return funcol.all_reduce(out, "sum", group).reshape(q.shape)
