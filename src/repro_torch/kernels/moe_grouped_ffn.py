"""The dropless MoE's expert FFN over slots sorted by expert, as a CUDA
kernel (``csrc/moe_grouped_ffn.cu``).

Slot ``s`` of expert ``e`` (``offsets[e] <= s < offsets[e + 1]``) reads
row ``tok[s]`` of ``x`` and gets ``(silu(x @ w_gate[e]) * (x @ w_up[e]))
@ w_down[e]``.  The kernel reads each expert's weights once for all of its
slots and skips an expert with none; it is what a dropless MoE runs on
the card (`layers.moe_dropless`), at decode and at prefill.  It replaces
no TPU kernel: the reference's capacity dispatch leaves its expert
products to XLA.  `moe_grouped_ffn_plain` is the plain version: a loop
over the experts, one product per expert, which the CPU runs.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import launches, reject_dtensors
from ._build import launch

K_TILE = 256            # rows of D one gate/up split covers at least
MAX_SPLITS = 16
# above this many slots a call is a prefill's: the D rows are not split and
# a block holds 16 slots (2 columns a thread) in place of 8 (4 columns)
SPLIT_MAX_SLOTS = 4096


def moe_grouped_ffn_plain(x, tok, offsets, w_gate, w_up, w_down):
    """The plain version: per expert, its slots' rows of ``x`` through its
    SwiGLU.  Reads ``offsets`` on the host."""
    y = x.new_empty((tok.shape[0], x.shape[1]))
    bounds = offsets.tolist()
    for e in range(w_gate.shape[0]):
        lo, hi = bounds[e], bounds[e + 1]
        if hi > lo:
            xe = x[tok[lo:hi].long()]
            y[lo:hi] = (F.silu(xe @ w_gate[e]) * (xe @ w_up[e])) @ w_down[e]
    return y


def plan(n_slots: int, n_experts: int, d: int) -> tuple[int, int, int]:
    """(K splits of the D rows, Z blocks sharing an expert's slot chunks,
    slots a block holds): a decode's few slots an expert are spread over
    splits of D, a prefill's many over Z, 16 slots a block."""
    decode = n_slots <= SPLIT_MAX_SLOTS
    splits = max(1, min(d // K_TILE, MAX_SPLITS)) if decode else 1
    sb = 8 if decode else 16
    z = max(1, min(-(-n_slots // (n_experts * sb)), 1024))
    return splits, z, sb


def moe_grouped_ffn(x, tok, offsets, w_gate, w_up, w_down):
    """``y [n_slots, D]`` in sorted slot order: the kernel on CUDA tensors
    (f32, contiguous), the plain version on CPU tensors.

    x [T, D]; tok [n_slots] int32 (the token of each slot, slots sorted by
    expert); offsets [E + 1] int32 (expert e's slots start at offsets[e]);
    w_gate/w_up [E, D, F]; w_down [E, F, D].  One call counts one launch.
    """
    reject_dtensors(x=x, tok=tok, offsets=offsets, w_gate=w_gate,
                    w_up=w_up, w_down=w_down)
    if x.device.type == "cpu":
        return moe_grouped_ffn_plain(x, tok, offsets, w_gate, w_up, w_down)
    e, d, f = w_gate.shape
    ops = {"x": x, "tok": tok, "offsets": offsets, "w_gate": w_gate,
           "w_up": w_up, "w_down": w_down}
    for name, t in ops.items():
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}; x is on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
        want = torch.int32 if name in ("tok", "offsets") else torch.float32
        if t.dtype != want:
            raise ValueError(f"{name} has dtype {t.dtype}, expected {want}")
    if x.ndim != 2 or x.shape[1] != d or w_up.shape != w_gate.shape or \
            w_down.shape != (e, f, d) or offsets.shape != (e + 1,) or \
            tok.ndim != 1:
        raise ValueError(
            f"shapes do not agree: x {tuple(x.shape)}, tok {tuple(tok.shape)}"
            f", offsets {tuple(offsets.shape)}, w_gate {tuple(w_gate.shape)}"
            f", w_up {tuple(w_up.shape)}, w_down {tuple(w_down.shape)}")
    if d % 4 or f % 4:
        raise ValueError(f"D ({d}) and F ({f}) must be multiples of 4")
    n_slots = tok.shape[0]
    splits, z, sb = plan(n_slots, e, d)
    ws = torch.empty(splits * n_slots * 2 * f, dtype=torch.float32,
                     device=x.device)
    h = torch.empty((n_slots, f), dtype=torch.float32, device=x.device)
    y = torch.empty((n_slots, d), dtype=torch.float32, device=x.device)
    launch("moe_grouped_ffn_launch", x.data_ptr(), tok.data_ptr(),
           offsets.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(),
           w_down.data_ptr(), ws.data_ptr(), h.data_ptr(), y.data_ptr(),
           n_slots, e, d, f, splits, z, sb,
           torch.cuda.current_stream(x.device).cuda_stream)
    launches["moe_grouped_ffn"] += 1
    return y
