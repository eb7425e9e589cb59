"""Cryptographic primitives for Space-Control, PyTorch side.

Two planes:
  * Control plane (trusted FM / SPACE firmware): real HMAC-SHA-256 via hashlib.
    This is what generates L_exp and L_host (paper Eq. 1 / Eq. 2).
  * Data plane (per-access): an ARX MAC in tensor arithmetic, the keystream
    the memcrypt kernels compute.  torch has no unsigned 32-bit add or shift
    on the CPU, so the words ride in int64 tensors masked to 32 bits.

Labels are 64-bit (the paper stores L_exp in a 64-bit shadow register),
taken as the first 8 bytes of the HMAC output.
"""
from __future__ import annotations

import hashlib
import hmac as _hmac
import struct

import numpy as np
import torch

LABEL_BITS = 64
U32 = 0xFFFFFFFF


def hmac_label(key: bytes, *fields: int) -> int:
    """HMAC-SHA-256 over packed u64 fields, truncated to 64 bits.

    Used for both L_exp = MAC_{K_FM}(host_id, HWPID, BASE_P, range) and
    L_host = MAC_{K_host}(BASE_P, HWPID, ctr).
    """
    msg = b"".join(struct.pack("<Q", f & 0xFFFFFFFFFFFFFFFF) for f in fields)
    dig = _hmac.new(key, msg, hashlib.sha256).digest()
    return struct.unpack("<Q", dig[:8])[0]


def derive_key(master: bytes, purpose: str) -> bytes:
    """KDF for per-host keys (K_host) from the FM master secret."""
    return hashlib.sha256(master + b"|" + purpose.encode()).digest()


# ---------------------------------------------------------------------------
# ARX MAC (threefry-2x32 inspired) — models the hardware MAC engine and is
# the memcrypt keystream.  Rotation schedule from the Threefry-2x32 paper;
# the CUDA twin is `keystream_x0` in kernels/csrc/egress.cuh.
# ---------------------------------------------------------------------------
_ROTATIONS = (13, 15, 26, 6, 17, 29, 16, 24)
_PARITY = 0x1BD11BDA
N_ROUNDS = 12  # 12 of 20 rounds: the hardware engine trades margin for 1-cycle


def _u32(x, device=None):
    """``x`` reduced to its low 32 bits: a Python int stays an int, anything
    else becomes an int64 tensor (int32 bit patterns map to their unsigned
    value)."""
    if isinstance(x, (int, np.integer)):
        return int(x) & U32
    return torch.as_tensor(x, device=device).to(torch.int64) & U32


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & U32


def arx_mac32(key0, key1, msg0, msg1, rounds: int = N_ROUNDS):
    """Threefry-like 2x32 block function over broadcast u32 operands.

    Returns (x0, x1) as int64 tensors holding u32 values."""
    m0 = _u32(torch.as_tensor(msg0))
    dev = m0.device
    m1 = _u32(msg1, dev)
    k0 = _u32(key0, dev)
    k1 = _u32(key1, dev)
    k2 = k0 ^ k1 ^ _PARITY
    x0 = (m0 + k0) & U32
    x1 = (m1 + k1) & U32
    ks = (k0, k1, k2)
    for rnd in range(rounds):
        r = _ROTATIONS[rnd % 8]
        x0 = (x0 + x1) & U32
        x1 = _rotl(x1, r) ^ x0
        if rnd % 4 == 3:
            j = rnd // 4 + 1
            x0 = (x0 + ks[j % 3]) & U32
            x1 = (x1 + ks[(j + 1) % 3] + j) & U32
    return x0, x1


def arx_mac64(key: int, msg_lo, msg_hi) -> torch.Tensor:
    """64-bit MAC tag from two u32 message words, as (lo, hi) u32 words
    stacked on the last axis (int64 tensor)."""
    t0, t1 = arx_mac32(key & U32, (key >> 32) & U32, msg_lo, msg_hi)
    return torch.stack(torch.broadcast_tensors(t0, t1), dim=-1)
