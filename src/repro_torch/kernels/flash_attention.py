"""Forward flash attention as a CUDA kernel (``csrc/flash_attention.cu``).

The serving path's attention: every prefill and every decode step of the
dense decoder LM calls `flash_attention` on the card.  It computes what
the reference's Pallas kernel computes (online softmax with f32
accumulators, causal and optional sliding-window masks, queries aligned to
the END of the keys, GQA head ``h`` reading kv head ``h // (H / Hkv)``,
output in ``q.dtype``), for f32 and bf16 operands.  It has no backward:
serving needs none.

The operands are addressed through their strides, so a caller may pass
views: the attention layer passes ``q`` in its projection layout
(``[B, S, H, dh]`` transposed to ``[B, H, S, dh]``) and, at decode, the
slice ``cache.k[:, :, :pos + 1]`` of the KV cache.  The output is allocated
in ``q``'s memory layout.  Only the head dim must be contiguous.
"""
from __future__ import annotations

import numpy as np
import torch

from . import launches
from ._build import launch

# the reference's masking constant (flash_attention.py:37): finite, so a
# fully masked tile gives exp(0) = 1 and the next tile's alpha = 0 wipes it
NEG_INF = -0.7 * float(np.finfo(np.float32).max)

HEAD_DIMS = (32, 64, 128, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check_shapes(q, k, v, causal: bool):
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"expected q [B,H,Sq,dh], k/v [B,Hkv,Sk,dh]; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, h, sq, dh = q.shape
    if k.shape[0] != b or k.shape[3] != dh or h % k.shape[1]:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do not "
                         "agree on batch, head dim or head grouping")
    if causal and sq > k.shape[2]:
        raise ValueError("causal attention needs Sq <= Sk (queries align "
                         "with the end of the keys)")


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = -1):
    """The plain version of the kernel: materialized f32 logits with the
    same masks and ``NEG_INF``, a full softmax, output in ``q.dtype``.

    q: [B, H, Sq, dh]; k/v: [B, Hkv, Sk, dh]; query row i sits at key
    position ``i + Sk - Sq``.
    """
    _check_shapes(q, k, v, causal)
    b, h, sq, dh = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    qg = q.to(torch.float32).reshape(b, hkv, h // hkv, sq, dh)
    logits = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.to(torch.float32)) \
        * (1.0 / np.sqrt(dh))
    q_pos = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
    k_pos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window > 0:
        mask &= k_pos > q_pos - window
    logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", probs, v.to(torch.float32))
    return out.reshape(b, h, sq, dh).to(q.dtype)


def flash_attention(q, k, v, *, causal: bool = True, window: int = -1):
    """Forward attention: the CUDA kernel on CUDA tensors, the plain
    version on CPU tensors.

    q: [B, H, Sq, dh]; k/v: [B, Hkv, Sk, dh], f32 or bf16, any strides with
    a contiguous head dim.  ``window > 0`` keeps keys ``> pos - window``.
    The kernel's q tile is 16 rows for Sq <= 16 (decode) and 64 rows
    otherwise.  Returns [B, H, Sq, dh] in ``q.dtype``, laid out like ``q``.
    """
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    _check_shapes(q, k, v, causal)
    b, h, sq, dh = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if dh not in HEAD_DIMS:
        raise ValueError(f"head dim {dh} not in {HEAD_DIMS}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or t.device.type != "cuda":
            raise ValueError(f"{name} is on {t.device}; q is on {q.device}")
        if t.dtype != q.dtype or t.dtype not in _DTYPES:
            raise ValueError(f"{name} has dtype {t.dtype}; expected q's, "
                             f"one of {sorted(map(str, _DTYPES))}")
        if t.stride(3) != 1:
            raise ValueError(f"{name}'s head dim is not contiguous")
    out = torch.empty_like(q)    # keeps q's layout (dense, not overlapping)
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    launch("flash_attention_launch", q.data_ptr(), k.data_ptr(),
           v.data_ptr(), out.data_ptr(), _DTYPES[q.dtype], b, h, hkv, sq, sk,
           dh, *strides, float(1.0 / np.sqrt(dh)), int(causal), int(window),
           16 if sq <= 16 else 64,
           torch.cuda.current_stream(q.device).cuda_stream)
    launches["flash_attention"] += 1
    return out
