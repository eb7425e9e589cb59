"""Work of the serving cell's decode, from the routing counts and the
published config (f32: 4 bytes a value).

A grouped expert FFN call (``moe_grouped_ffn``): bytes are the weights of
each expert hit (``w_gate``, ``w_up`` [D, F] and ``w_down`` [F, D]) read
once, and each slot's input row read and output row written once (the
kernel gathers the tokens' rows itself; its partial sums and ``h`` are
intermediates, not counted); operations are 2 x 3 x D x F a slot.

A tenant's decode step of ``batch`` tokens at position ``pos``: every
weight of the stage read once (a Mamba2 layer's projections, conv and
norms; an attention layer's projections; each layer's router and shared
expert; the tied table as the head), the experts hit (from the counter
``moe.experts_hit``), each Mamba2 layer's SSM state and conv windows read
and written, each attention layer's keys and values at positions
``0..pos`` read and the new ones written, the token rows read and the
logits written.

The f32 peak: 128 f32 fused multiply-adds a clock an SM (CUDA C++
Programming Guide, arithmetic instruction throughput, compute capability
9.0), 2 operations each, at the card's SM count and maximum SM clock: 67
TFLOP/s at 132 SMs and 1,980 MHz, NVIDIA's published float32 rate."""
from __future__ import annotations

from . import peaks

F32 = 4
F32_FLOPS_PER_CLOCK_PER_SM = 256


def f32_flops_per_s(sms: int, max_sm_mhz: float) -> float:
    return F32_FLOPS_PER_CLOCK_PER_SM * sms * max_sm_mhz * 1e6


def card_f32_flops_per_s() -> float:
    """Card 0's f32 peak (from its int32 issue rate, which ``peaks`` reads
    from the card at 64 a clock an SM)."""
    return peaks.card_int32_ops_per_s() * F32_FLOPS_PER_CLOCK_PER_SM \
        / peaks.INT32_OPS_PER_CLOCK_PER_SM


def expert_bytes(d: int, f: int) -> int:
    """One expert's weights."""
    return 3 * d * f * F32


def grouped_ffn_work(slots: int, experts_hit: int, d: int,
                     f: int) -> tuple[int, int]:
    """(bytes, f32 operations) of grouped FFN calls over ``slots`` slots in
    all, ``experts_hit`` experts with a slot summed over the calls."""
    return (experts_hit * expert_bytes(d, f) + 2 * slots * d * F32,
            6 * d * f * slots)


def _mamba_layer_weights(pub: dict) -> int:
    d = pub["hidden_size"]
    di = pub["mamba_expand"] * d
    gn = pub["mamba_n_groups"] * pub["mamba_d_state"]
    nh, w = pub["mamba_n_heads"], pub["mamba_d_conv"]
    conv = di + 2 * gn
    return d * (2 * di + 2 * gn + nh) + (w + 1) * conv + 3 * nh + di \
        + di * d


def _attention_layer_weights(pub: dict) -> int:
    d, hq, hkv = (pub["hidden_size"], pub["num_attention_heads"],
                  pub["num_key_value_heads"])
    dh = pub.get("head_dim") or d // hq
    return d * (hq + 2 * hkv) * dh + hq * dh * d


def _layer_kinds(pub: dict) -> list[str]:
    return list(pub["layer_types"][:pub["num_hidden_layers"]])


def decode_bytes(pub: dict, batch: int, pos: int) -> int:
    """Bytes of one tenant's decode step at ``pos`` (the first key
    position being 0), less its experts' weights (`expert_bytes` times the
    experts hit)."""
    d, v = pub["hidden_size"], pub["vocab_size"]
    e, fs = pub["num_local_experts"], pub["shared_intermediate_size"]
    di = pub["mamba_expand"] * d
    gn = pub["mamba_n_groups"] * pub["mamba_d_state"]
    state = pub["mamba_n_heads"] * pub["mamba_d_head"] * \
        pub["mamba_d_state"] + (pub["mamba_d_conv"] - 1) * (di + 2 * gn)
    hkv = pub["num_key_value_heads"]
    dh = pub.get("head_dim") or d // pub["num_attention_heads"]
    n = 0
    for kind in _layer_kinds(pub):
        n += 2 * d + d * e + 3 * d * fs            # norms, router, shared
        if kind == "mamba":
            n += _mamba_layer_weights(pub) + 2 * batch * state
        else:
            n += _attention_layer_weights(pub) + \
                batch * hkv * dh * 2 * (pos + 2)   # read 0..pos, write pos
    n += v * d + d + batch * d + batch * v          # head, rows, logits
    return n * F32
