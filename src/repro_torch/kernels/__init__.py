"""The port's CUDA kernels for Hopper — the egress path (Space-Control
permission check + memcrypt) and the serving path's flash attention — plus
the launch helpers every kernel wrapper in this package shares.

Each kernel is hand-written CUDA C++ under ``csrc/`` (built at first use by
``_build.py``) and ships with a plain PyTorch version of the same function
(``ref.py``, or beside its wrapper).  A wrapper given CPU tensors runs the
plain version; given CUDA tensors it launches the kernel or raises — there
is no fallback.
"""
from __future__ import annotations

import functools

import torch

# Kernel launches per kernel since the last reset: each wrapper adds one
# where it launches its CUDA kernel and nowhere else (the CPU path runs the
# plain version and counts nothing), so a run can show that its main path
# went through the kernels.
launches = {"memcrypt": 0, "permcheck": 0, "checked_memcrypt": 0,
            "fabric_egress": 0, "flash_attention": 0}


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    for name in launches:
        launches[name] = 0


@functools.cache
def dtensor_type() -> type:
    """``torch.distributed.tensor.DTensor``, imported at first use (a
    ``from ... import`` of it costs about half a millisecond a call)."""
    from torch.distributed.tensor import DTensor
    return DTensor


def is_dtensor(x) -> bool:
    """Whether ``x`` is a ``DTensor`` (a plain tensor answers at once)."""
    return type(x) is not torch.Tensor and isinstance(x, dtensor_type())


def reject_dtensors(**tensors) -> None:
    """Raise on a ``DTensor`` operand.  A wrapper takes plain (local)
    tensors: a DTensor's data pointer would be its local shard's, so a
    launch on it would compute on whatever part of the tensor this rank
    happens to hold."""
    for name, t in tensors.items():
        if is_dtensor(t):
            raise TypeError(f"{name} is a DTensor ({t.placements} on "
                            f"{t.device_mesh}); pass its local tensor "
                            "(to_local()) where that is the whole tensor")


def check_cuda_operands(**tensors: torch.Tensor) -> None:
    """Raise unless every operand is a contiguous int32 CUDA tensor on one
    device — what the kernels' C interface takes."""
    reject_dtensors(**tensors)
    devices = {t.device for t in tensors.values()}
    if len(devices) != 1:
        raise ValueError(
            f"operands on several devices: {sorted(map(str, devices))}")
    for name, t in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"{name} is on {t.device}, not a CUDA device")
        if t.dtype != torch.int32:
            raise ValueError(f"{name} has dtype {t.dtype}, expected int32")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on.

    ``None`` means CUDA: the port is written for the GPU, so a caller that
    wants the plain CPU versions must say ``device="cpu"``.  Raises when
    CUDA is asked for (explicitly or by default) and absent.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions")
    return dev


def bucket_pad(n: int, block: int) -> int:
    """Pad ``n`` up to ``block`` granularity, then bucket the block count to
    the next power of two.

    The CUDA kernels take any length; the bucketed size still fixes the
    keystream position of a fabric row (``row * bucket_pad(B, BLOCK)``) and
    the kernel steps the adaptive selector scores, so both packages make
    the same decisions on the same batch.
    """
    if block <= 0:
        raise ValueError("block must be positive")
    blocks = max(1, -(-int(n) // block))
    return (1 << (blocks - 1).bit_length()) * block
