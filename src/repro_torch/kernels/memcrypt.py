"""Counter-mode ARX memory-line cipher (paper §4.2.3) and the fused egress,
as CUDA kernels.

Models the paper's memory encryption engine (<=1 cycle per 64 B cache line):
each 32-bit word at flat position i is XORed with a keystream generated by a
threefry-style 2x32 ARX block over (line = i//16, word = i%16).  Encrypt ==
decrypt.

Two kernels:

  ``memcrypt``              — plain keystream XOR over a u32 buffer
    (``csrc/memcrypt.cu``).
  ``checked_memcrypt_view`` — the fused egress path: tag check + cover
    lookup + keystream XOR in one launch (``csrc/checked_memcrypt.cu``).
    Each word's lane searches the sorted shard as the permcheck kernel
    does (the precondition `permcheck.lane_search_plain` states), so the
    reference's flat/hier selector has nothing to choose.  It reads each
    word once, zeroes denied lanes and emits a fault code per word — the
    checker and the encryption engine back to back at the egress point.

u32 words travel as int32 tensors with the same bit patterns.
"""
from __future__ import annotations

import torch

from ..core.table import as_int32
from . import check_cuda_operands, launches, ref, reject_dtensors
from ._build import launch
from .permcheck import ShardView, check_search_layout, make_shard_view

BLOCK = 1024        # words per reference kernel block (a fabric row pads to it)

_U32 = 0xFFFFFFFF


def memcrypt(data, *, key0: int, key1: int, base_word: int = 0):
    """XOR-keystream encrypt/decrypt of an i32 (u32-bit) tensor of any
    shape: the CUDA kernel for a CUDA tensor, the plain version for a CPU
    one.  Word i of the flattened tensor uses keystream position
    ``base_word + i`` (mod 2^32)."""
    reject_dtensors(data=data)
    d = as_int32(data)
    if d.device.type == "cpu":
        return ref.memcrypt(d, key0, key1, base_word)
    flat = d.reshape(-1).contiguous()
    check_cuda_operands(data=flat)
    out = torch.empty_like(flat)
    launch("memcrypt_launch", flat.data_ptr(), out.data_ptr(), flat.numel(),
           int(key0) & _U32, int(key1) & _U32, int(base_word) & _U32,
           torch.cuda.current_stream(flat.device).cuda_stream)
    launches["memcrypt"] += 1
    return out.reshape(d.shape)


def checked_memcrypt_view_plain(data, ext_addrs, view: ShardView, *,
                                hwpid: int, need: int, key0: int, key1: int,
                                base_word: int = 0):
    """The plain version of the fused kernel: ``ref.checked_memcrypt`` on
    the view's arrays."""
    return ref.checked_memcrypt(data, ext_addrs, view.starts, view.ends,
                                view.permbits, hwpid=hwpid, need=need,
                                key0=key0, key1=key1, base_word=base_word)


def checked_memcrypt_view(data, ext_addrs, view: ShardView, *, hwpid: int,
                          need: int, key0: int, key1: int,
                          base_word: int = 0):
    """Fused egress over a prepared `ShardView`: permission check + decrypt
    in one launch.

    ``data[i]`` is the ciphertext word whose page-tagged address is
    ``ext_addrs[i]``; it is decrypted with the keystream at position
    ``base_word + i`` and released only if the lookup grants ``need`` to
    ``hwpid``.  Returns ``(out i32[B], fault i32[B])`` with ``out`` zeroed
    and a ``repro_torch.core.checker.FAULT_*`` code on every denied lane.
    The CUDA kernel searches the view's sorted shard (the search kernels'
    precondition; on a shard that breaks it, it fails closed).
    """
    dev = view.starts.device
    d = as_int32(data, dev).reshape(-1).contiguous()
    ext = as_int32(ext_addrs, dev)
    b = d.shape[0]
    if tuple(ext.shape) != (b,):
        raise ValueError(
            f"ext_addrs shape {tuple(ext.shape)} != data words ({b},)")
    if dev.type == "cpu":
        return checked_memcrypt_view_plain(
            d, ext, view, hwpid=hwpid, need=need, key0=key0, key1=key1,
            base_word=base_word)
    ext = ext.contiguous()
    check_cuda_operands(data=d, ext=ext, starts=view.starts, ends=view.ends,
                        permbits=view.permbits, tile_min=view.tile_min)
    check_search_layout(view.starts, view.ends, view.permbits, view.tile_min)
    out = torch.empty_like(d)
    fault = torch.empty_like(d)
    launch("checked_memcrypt_launch", d.data_ptr(), ext.data_ptr(), b,
           view.starts.data_ptr(), view.ends.data_ptr(),
           view.permbits.data_ptr(), view.starts.shape[0],
           view.tile_min.data_ptr(), view.n_tiles, int(need), int(hwpid),
           int(key0) & _U32, int(key1) & _U32, int(base_word) & _U32,
           out.data_ptr(), fault.data_ptr(),
           torch.cuda.current_stream(dev).cuda_stream)
    launches["checked_memcrypt"] += 1
    return out, fault


def checked_memcrypt(data, ext_addrs, starts, ends, permbits, *, hwpid: int,
                     need: int, key0: int, key1: int, base_word: int = 0,
                     device=None):
    """Raw-array convenience wrapper around `checked_memcrypt_view`
    (derives the padded ShardView per call)."""
    return checked_memcrypt_view(
        data, ext_addrs, make_shard_view(starts, ends, permbits,
                                         device=device),
        hwpid=hwpid, need=need, key0=key0, key1=key1, base_word=base_word)
