"""Plain PyTorch versions of the egress kernels, and the attention oracle.

Each CUDA kernel in this package must match its plain version here bit for
bit; on CPU tensors the kernel wrappers run these instead.  They are written
straight from the definitions (signed range compares, an explicit counter
keystream), not from the kernels' diff-form arithmetic, so they stay an
independent check.  u32 words travel as int32 bit patterns.
`flash_attention` mirrors the reference's float oracle; the flash kernel's
own plain version lives beside its wrapper (``flash_attention.py``).
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.crypto import arx_mac32
from ..core.table import HWPID_SHIFT, PAGE_MASK, as_int32

# (address, entry) pairs evaluated per chunk: bounds the [B, N] predicate's
# memory at realistic shard sizes (64 Ki addresses x 64 Ki entries)
_PAIRS_PER_CHUNK = 1 << 26


def _to_i32_bits(x64: torch.Tensor) -> torch.Tensor:
    """int64 holding u32 values -> int32 with the same bit pattern."""
    return torch.where(x64 >= 1 << 31, x64 - (1 << 32), x64).to(torch.int32)


# ---------------------------------------------------------------------------
# permcheck: Space-Control permission check (paper §4.2.3)
# ---------------------------------------------------------------------------

def permcheck(ext_addrs, starts, ends, permbits, *, hwpid: int, need: int):
    """Plain permission check.

    Args:
      ext_addrs: i32[B] A-bit tagged page addresses (hwpid<<24 | page).
      starts:    i32[N] sorted range starts (pages); padding = INT32_MAX.
      ends:      i32[N] range ends (exclusive); padding = INT32_MAX.
      permbits:  i32[N] 2-bit permission field already extracted for `hwpid`.
      hwpid:     the tenant context whose A-bits must match.
      need:      required bits (1=R, 2=W, 3=RW).

    Returns:
      allowed: bool[B]
      idx:     i32[B] first entry whose range covers the page, else -1
    """
    ext = as_int32(ext_addrs)
    dev = ext.device
    tag = ext >> HWPID_SHIFT
    page = ext & PAGE_MASK
    s = as_int32(starts, dev)
    e = as_int32(ends, dev)
    perm_ok = (as_int32(permbits, dev) & need) == need
    n = s.shape[0]
    b = page.shape[0]
    any_hit = torch.zeros(b, dtype=torch.bool, device=dev)
    idx = torch.full((b,), -1, dtype=torch.int32, device=dev)
    if n:
        col = torch.arange(n, dtype=torch.int32, device=dev)
        rows = max(1, _PAIRS_PER_CHUNK // n)
        for lo in range(0, b, rows):
            p = page[lo:lo + rows, None]
            in_range = (p >= s) & (p < e)
            any_hit[lo:lo + rows] = (in_range & perm_ok).any(dim=1)
            first = torch.where(in_range, col, n).amin(dim=1)
            idx[lo:lo + rows] = torch.where(first < n, first, -1)
    return (tag == hwpid) & any_hit, idx


# ---------------------------------------------------------------------------
# memcrypt: counter-mode ARX line cipher (paper §4.2.3 memory encryption)
# ---------------------------------------------------------------------------

def memcrypt(data, key0: int, key1: int, base_word: int = 0):
    """Plain memory-encryption keystream XOR.

    data: i32[...] (u32 words); each word w at flat index i is XORed with
    the keystream arx(key, line=(base_word+i)//16, word=(base_word+i)%16),
    positions taken mod 2^32.  64-byte lines = 16 u32 words.  Encrypt ==
    decrypt.
    """
    d = as_int32(data)
    flat = d.reshape(-1)
    pos = (torch.arange(flat.shape[0], dtype=torch.int64, device=d.device)
           + (int(base_word) & 0xFFFFFFFF)) & 0xFFFFFFFF
    ks0, _ = arx_mac32(int(key0), int(key1), pos >> 4, pos & 15)
    return (flat ^ _to_i32_bits(ks0)).reshape(d.shape)


# ---------------------------------------------------------------------------
# checked_memcrypt: fused egress (permission check ⊕ decrypt)
# ---------------------------------------------------------------------------

def checked_memcrypt(data, ext_addrs, starts, ends, permbits, *, hwpid: int,
                     need: int, key0: int, key1: int, base_word: int = 0):
    """Plain fused egress: literally ``memcrypt`` for the keystream and
    ``permcheck`` for the verdict, with denied lanes zeroed and per-word
    fault codes (``repro_torch.core.checker`` semantics: NO_ABITS for an
    untagged or padding lane, NOT_LOCAL for a wrong tenant tag, NO_ENTRY
    when no range covers the page, PERM when the entry denies).

    Returns (out i32[B] u32 bits, fault i32[B]).
    """
    from ..core.checker import (FAULT_NO_ABITS, FAULT_NO_ENTRY, FAULT_NONE,
                                FAULT_NOT_LOCAL, FAULT_PERM)
    d = as_int32(data).reshape(-1)
    ext = as_int32(ext_addrs, d.device)
    allowed, idx = permcheck(ext, starts, ends, permbits, hwpid=hwpid,
                             need=need)
    dec = memcrypt(d, key0, key1, base_word)
    out = torch.where(allowed, dec, 0)
    tag = ext >> HWPID_SHIFT
    fault = torch.where(
        allowed, FAULT_NONE,
        torch.where(tag <= 0, FAULT_NO_ABITS,
                    torch.where(tag != hwpid, FAULT_NOT_LOCAL,
                                torch.where(idx < 0, FAULT_NO_ENTRY,
                                            FAULT_PERM))))
    return out, fault.to(torch.int32)


# ---------------------------------------------------------------------------
# flash attention (the serving path's attention kernel)
# ---------------------------------------------------------------------------

def flash_attention(q, k, v, *, causal: bool = True,
                    scale: float | None = None):
    """Oracle: plain softmax attention. q,k,v: [B, H, S, D] (k/v may have
    fewer heads = GQA; heads are repeated).  Causal rows align with the
    end of the keys; no window (the reference's oracle has none)."""
    if scale is None:
        scale = 1.0 / np.sqrt(q.shape[-1])
    hq, hk = q.shape[1], k.shape[1]
    if hq != hk:
        k = k.repeat_interleave(hq // hk, dim=1)
        v = v.repeat_interleave(hq // hk, dim=1)
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    if causal:
        sq, sk = q.shape[2], k.shape[2]
        mask = torch.ones((sq, sk), dtype=torch.bool,
                          device=q.device).tril(diagonal=sk - sq)
        logits = torch.where(mask, logits, -torch.inf)
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", probs.to(v.dtype), v)
