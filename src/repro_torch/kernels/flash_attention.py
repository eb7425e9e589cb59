"""Forward flash attention as CUDA kernels (``csrc/flash_attention.cu``).

The serving path's attention: every prefill and every decode step of the
dense decoder LM calls `flash_attention` on the card.  It computes what
the reference's Pallas kernel computes (online softmax with f32
statistics, causal and optional sliding-window masks, queries aligned to
the END of the keys, GQA head ``h`` reading kv head ``h // (H / Hkv)``,
output in ``q.dtype``), for f32 and bf16 operands.  The logits' scale is
``1 / sqrt(dh)`` unless the caller gives ``scale`` (granite's
``attention_multiplier``).  It has no backward,
as the reference's kernel has none: training attends through the
attention layer's differentiable path, and the wrapper raises on CUDA
operands that need a gradient rather than return an output that would
drop it.

The kernel takes one of three paths, by ``(Sq, dtype)``:

* ``Sq <= 16`` (decode): split-K flash-decoding.  One block per (key
  split, kv head, batch) holds all ``G * Sq`` query rows of its kv head,
  so each K/V row is read once per kv head; `split_plan` cuts the visible
  key range into enough splits to fill the card, and a second kernel
  combines the splits' ``(m, l, acc)`` partials from an f32 workspace.
  `flash_attention_split_plain` is the plain version of that arithmetic.
* ``Sq > 16``, f32 (prefill): a register-tiled CUDA-core kernel, IEEE f32
  (never TF32).
* ``Sq > 16``, bf16 (prefill): a tensor-core kernel (``mma.sync``, f32
  accumulators, the output rounded once to bf16).

The operands are addressed through their strides, so a caller may pass
views: the attention layer passes ``q`` in its projection layout
(``[B, S, H, dh]`` transposed to ``[B, H, S, dh]``) and, at decode, the
slice ``cache.k[:, :, :pos + 1]`` of the KV cache.  The output is allocated
in ``q``'s memory layout.  The head dim must be contiguous, and the
kernels copy 16-byte vectors, so every operand's base and its (batch,
head, sequence) strides must be 16-byte aligned.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from . import launches, reject_dtensors
from ._build import launch

# the reference's masking constant (flash_attention.py:37): finite, so a
# fully masked tile gives exp(0) = 1 and the next tile's alpha = 0 wipes it
NEG_INF = -0.7 * float(np.finfo(np.float32).max)

HEAD_DIMS = (32, 64, 128, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
DECODE_MAX_SQ = 16       # Sq up to this takes the split-K decode path
MIN_SPLIT_KEYS = 64      # each key split covers at least this many keys
BLOCKS_PER_SM = 2        # the decode grid aims at this many blocks per SM


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


def _scale(dh: int, scale: float | None) -> float:
    return float(1.0 / np.sqrt(dh)) if scale is None else float(scale)


def _masked_logits(q, k, causal: bool, window: int, scale: float | None):
    """f32 logits [B, Hkv, G, Sq, Sk] with the kernel's masks and NEG_INF."""
    b, h, sq, dh = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    qg = q.to(torch.float32).reshape(b, hkv, h // hkv, sq, dh)
    logits = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.to(torch.float32)) \
        * _scale(dh, scale)
    q_pos = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
    k_pos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window > 0:
        mask &= k_pos > q_pos - window
    return torch.where(mask, logits, NEG_INF)


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = -1,
                          scale: float | None = None):
    """The plain version of the kernels: materialized f32 logits with the
    same masks and ``NEG_INF``, a full softmax, output in ``q.dtype``.

    q: [B, H, Sq, dh]; k/v: [B, Hkv, Sk, dh]; query row i sits at key
    position ``i + Sk - Sq``.
    """
    _check_shapes(q, k, v, causal)
    b, h, sq, dh = q.shape
    probs = torch.softmax(_masked_logits(q, k, causal, window, scale),
                          dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", probs, v.to(torch.float32))
    return out.reshape(b, h, sq, dh).to(q.dtype)


class SplitPlan(NamedTuple):
    """How the decode kernel cuts the keys: split ``s`` covers keys
    ``[k_begin + s * chunk, min(k_end, k_begin + (s + 1) * chunk))``."""
    splits: int
    chunk: int
    k_begin: int
    k_end: int
    row_groups: int


def decode_rows_per_block(dh: int, rows: int) -> int:
    """Query rows one decode block holds when a kv head has ``rows = G *
    Sq`` of them (``dispatch_decode`` in the .cu): all of them up to 4,
    else up to ``min(64, 2048 // dh)``."""
    return 4 if rows <= 4 else min(64, 2048 // dh)


def split_plan(b: int, h: int, hkv: int, sq: int, sk: int, dh: int, *,
               causal: bool, window: int, sms: int) -> SplitPlan:
    """The decode kernel's key splits.

    Only the keys some query row can see, ``[k_begin, k_end)``, are split:
    a window gives fewer splits, not masked ones.  The split count brings
    the grid (``B * Hkv * row_groups * splits`` blocks) to about
    ``BLOCKS_PER_SM`` blocks per SM, with at least ``MIN_SPLIT_KEYS`` keys
    per split.
    """
    off = sk - sq
    k_end = min(sk, sq + off) if causal else sk
    k_begin = max(0, off - window + 1) if window > 0 else 0
    n = max(1, k_end - k_begin)
    rows = h // hkv * sq
    row_groups = -(-rows // decode_rows_per_block(dh, rows))
    want = -(-BLOCKS_PER_SM * sms // (b * hkv * row_groups))
    splits = max(1, min(want, n // MIN_SPLIT_KEYS))
    chunk = -(-n // splits)
    return SplitPlan(-(-n // chunk), chunk, k_begin, k_end, row_groups)


def flash_attention_split_plain(q, k, v, *, causal: bool = True,
                                window: int = -1, plan: SplitPlan,
                                scale: float | None = None):
    """The plain version of the decode kernels' split + combine arithmetic.

    Each split of ``plan`` keeps its own ``(m_s, l_s, acc_s)`` over its keys
    with the finite ``NEG_INF``: a row that sees no key of the split gets
    ``m_s = NEG_INF``, ``l_s`` = the split's key count and ``acc_s = sum V``.
    The combine weighs split ``s`` by ``exp(m_s - max_s m_s)``, which is
    exactly 0 for such a split beside any split with a real maximum.
    """
    _check_shapes(q, k, v, causal)
    b, h, sq, dh = q.shape
    logits = _masked_logits(q, k, causal, window, scale)
    vf = v.to(torch.float32)
    ms, ls, accs = [], [], []
    for s in range(plan.splits):
        lo = plan.k_begin + s * plan.chunk
        hi = min(plan.k_end, lo + plan.chunk)
        part = logits[..., lo:hi]
        m = part.amax(-1)
        p = torch.exp(part - m[..., None])
        ms.append(m)
        ls.append(p.sum(-1))
        accs.append(torch.einsum("bhgqk,bhkd->bhgqd", p, vf[:, :, lo:hi]))
    m = torch.stack(ms)
    w = torch.exp(m - m.amax(0))
    den = (w * torch.stack(ls)).sum(0).clamp_min(1e-30)
    out = (w[..., None] * torch.stack(accs)).sum(0) / den[..., None]
    return out.reshape(b, h, sq, dh).to(q.dtype)


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check_aligned(name: str, t: torch.Tensor) -> None:
    """The kernels copy 16-byte vectors: the base pointer and every stride
    that is walked (a dim longer than 1) must be a multiple of 16 bytes."""
    step = 16 // t.element_size()
    bad = [s for s, n in zip(t.stride()[:3], t.shape[:3])
           if n > 1 and s % step]
    if t.data_ptr() % 16 or bad:
        raise ValueError(f"{name} is not 16-byte aligned (data_ptr "
                         f"{t.data_ptr():#x}, strides {t.stride()}); the "
                         "kernels need aligned rows")


def flash_attention(q, k, v, *, causal: bool = True, window: int = -1,
                    scale: float | None = None):
    """Forward attention: the CUDA kernels on CUDA tensors, the plain
    version on CPU tensors.

    q: [B, H, Sq, dh]; k/v: [B, Hkv, Sk, dh], f32 or bf16, any 16-byte
    aligned strides with a contiguous head dim.  ``window > 0`` keeps keys
    ``> pos - window``; ``scale`` multiplies the logits (default
    ``1 / sqrt(dh)``).  Returns [B, H, Sq, dh] in ``q.dtype``, laid out
    like ``q``.  One call counts one launch, also where the decode path
    runs its split and combine kernels.  Raises on CUDA operands that
    autograd records: the kernel is forward-only, and on DTensor operands.
    """
    reject_dtensors(q=q, k=k, v=v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     scale=scale)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "flash_attention is forward-only (so is the reference's kernel): "
            "an operand requires a gradient, which the kernel would drop; "
            "training attends through the attention layer's differentiable "
            "path")
    _check_shapes(q, k, v, causal)
    b, h, sq, dh = q.shape
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
        _check_aligned(name, t)
    plan = None
    if sq <= DECODE_MAX_SQ:
        plan = split_plan(b, h, k.shape[1], sq, k.shape[2], dh,
                          causal=causal, window=window,
                          sms=_sm_count(q.device.index or 0))
    return _launch(q, k, v, causal, window, plan, scale)


def _launch(q, k, v, causal: bool, window: int, plan: SplitPlan | None,
            scale: float | None = None):
    """Launch on checked CUDA operands; ``plan`` (the decode path's key
    splits) is required for Sq <= DECODE_MAX_SQ and ignored otherwise."""
    b, h, sq, dh = q.shape
    out = torch.empty_like(q)    # keeps q's layout (dense, not overlapping)
    ws = None
    if sq <= DECODE_MAX_SQ:
        ws = torch.empty(b * h * sq * plan.splits * (dh + 2),
                         dtype=torch.float32, device=q.device)
    else:
        plan = SplitPlan(0, 0, 0, 0, 0)
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    launch("flash_attention_launch", q.data_ptr(), k.data_ptr(),
           v.data_ptr(), out.data_ptr(), _DTYPES[q.dtype], b, h, k.shape[1],
           sq, k.shape[2], dh, *strides, _scale(dh, scale),
           int(causal), int(window), None if ws is None else ws.data_ptr(),
           plan.splits, plan.chunk, plan.k_begin, plan.k_end,
           torch.cuda.current_stream(q.device).cuda_stream)
    launches["flash_attention"] += 1
    return out
