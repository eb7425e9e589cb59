"""Public entry points of the egress kernels.

Inputs may be numpy arrays (u32 words as ``uint32``) or tensors; they are
moved to ``device`` (default CUDA: raises when there is none — pass
``device="cpu"`` for the plain versions).  Dispatch then goes by the
tensors' device: CUDA launches the kernel, the CPU runs the plain version.
Results stay on the device as int32 tensors (u32 words keep their bits;
``repro_torch.convert.u32_to_numpy`` reads them back).
"""
from __future__ import annotations

from . import resolve_device
from ..core.table import as_int32
from .memcrypt import checked_memcrypt, memcrypt
from .permcheck import permcheck


def permission_check(ext_addrs, starts, ends, permbits, *, hwpid: int,
                     need: int, mode: str = "hier", device=None):
    """(allowed bool[B], idx i32[B]) — see kernels/permcheck.py."""
    dev = resolve_device(device)
    return permcheck(as_int32(ext_addrs, dev), starts, ends, permbits,
                     hwpid=hwpid, need=need, mode=mode, device=dev)


def memory_encrypt(data, *, key0: int, key1: int, base_word: int = 0,
                   device=None):
    """Counter-mode line cipher; involutive (encrypt == decrypt)."""
    return memcrypt(as_int32(data, resolve_device(device)), key0=key0,
                    key1=key1, base_word=base_word)


memory_decrypt = memory_encrypt


def checked_memory_decrypt(data, ext_addrs, starts, ends, permbits, *,
                           hwpid: int, need: int, key0: int, key1: int,
                           base_word: int = 0, device=None):
    """Fused egress: permission check + decrypt, one kernel launch.

    (out i32[B], fault i32[B]) — denied lanes zeroed, FAULT_* codes
    emitted.  See kernels/memcrypt.py (`checked_memcrypt_view`) and the
    plain version `ref.checked_memcrypt`.
    """
    dev = resolve_device(device)
    return checked_memcrypt(as_int32(data, dev), as_int32(ext_addrs, dev),
                            starts, ends, permbits, hwpid=hwpid, need=need,
                            key0=key0, key1=key1, base_word=base_word,
                            device=dev)
