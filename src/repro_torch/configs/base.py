"""Architecture configuration schema + the four assigned input shapes.

The port's own copy of the schema: ``pdtype`` is a ``torch.dtype``."""
from __future__ import annotations

from dataclasses import dataclass, replace

import torch


@dataclass(frozen=True)
class ArchConfig:
    arch_id: str
    family: str                    # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int | None = None    # default d_model // n_heads

    # attention variants
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    rope_theta_global: float | None = None   # gemma3 global layers
    partial_rotary: float = 1.0
    sliding_window: int | None = None        # local window size
    local_global_ratio: int | None = None    # gemma3: 5 local : 1 global
    mrope_sections: tuple[int, int, int] | None = None
    tie_embeddings: bool = False
    embed_scale: bool = False                # gemma3 multiplies by sqrt(d)
    # softmax scale of attention logits; None: 1 / sqrt(head_dim)
    attention_multiplier: float | None = None
    norm_eps: float = 1e-6                   # every RMSNorm of the model

    # per-layer mixer pattern ("mamba" | "attention"), read for the first
    # n_layers entries; None: the family's fixed layout
    layer_types: tuple[str, ...] | None = None
    # granite-style scalings: embeddings x embedding_multiplier, each
    # residual branch x residual_multiplier, logits / logits_scaling
    embedding_multiplier: float = 1.0
    residual_multiplier: float = 1.0
    logits_scaling: float = 1.0

    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_every: int = 1             # 2 => MoE on every other layer (llama4)
    shared_expert: bool = False
    expert_d_ff: int | None = None
    capacity_factor: float = 1.25
    # "einsum": GShard one-hot-matmul dispatch (paper-faithful baseline);
    # "ep": shard_map expert-parallel sorted dispatch (beyond-paper, SSPerf)
    moe_impl: str = "einsum"
    shared_expert_d_ff: int | None = None    # width of the shared MLP

    # SSM
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_head_dim: int = 64         # mamba2
    mamba_version: int = 1

    # hybrid (zamba2)
    shared_attn_every: int = 0     # apply shared attn block every N ssm blocks

    # enc-dec (seamless)
    n_enc_layers: int = 0
    frames_ratio: int = 4          # encoder frames = seq_len // ratio

    # vlm
    n_patches: int = 0             # vision patches per sample (pre-embedded)

    # numerics / memory
    grad_accum: int = 1            # microbatches per train step (see steps.py)
    param_dtype: str = "bfloat16"
    moment_dtype: str = "float32"
    remat: str = "full"            # none | full
    long_context_ok: bool = False  # may run long_500k
    attn_window_long: int = 8192   # hybrid window for long_500k decode

    # sharding hints (see launch/sharding.py)
    fsdp: bool = False             # extra weight sharding over "data"
    expert_axis: str = "model"     # mesh axis for the expert dimension

    # lowering: unroll layer scans (used by the roofline cost extrapolation —
    # XLA's HloCostAnalysis counts while bodies once, so per-unit costs are
    # measured on small UNROLLED variants and extrapolated to full depth)
    scan_unroll: bool = False

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim",
                               self.d_model // max(self.n_heads, 1))

    @property
    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    @property
    def vocab_padded(self) -> int:
        """Vocab padded to a multiple of 256 so embedding/head shard over any
        mesh axis (MaxText-style); loss labels never reference pad ids."""
        return -(-self.vocab // 256) * 256

    def n_params(self) -> int:
        """Approximate parameter count (embeddings + blocks + head)."""
        d, f, v = self.d_model, self.d_ff, self.vocab
        hd = self.head_dim
        attn = d * hd * (self.n_heads * 2 + self.n_kv_heads * 2)
        dense_ffn = 3 * d * f
        if self.family == "ssm":
            di = self.ssm_expand * d
            blk = d * 2 * di + di * (max(1, d // 16) + 2 * self.ssm_state) \
                + max(1, d // 16) * di + di * d + 4 * di
            core = self.n_layers * blk
        elif self.family == "hybrid":
            di = self.ssm_expand * d
            ng = 1
            blk = d * (2 * di + 2 * ng * self.ssm_state + di // self.ssm_head_dim) \
                + di * d
            core = self.n_layers * blk + attn + dense_ffn  # one shared block
        elif self.family == "moe":
            ef = self.expert_d_ff or f
            moe_layers = self.n_layers // self.moe_every
            dense_layers = self.n_layers - moe_layers
            moe_blk = self.n_experts * 3 * d * ef + d * self.n_experts
            if self.shared_expert:
                moe_blk += 3 * d * f
            core = moe_layers * (attn + moe_blk) + dense_layers * (attn + dense_ffn)
        elif self.family == "encdec":
            core = (self.n_enc_layers + self.n_layers) * (attn + dense_ffn) \
                + self.n_layers * attn  # cross attention
        else:
            core = self.n_layers * (attn + dense_ffn)
        emb = v * d * (1 if self.tie_embeddings else 2)
        return core + emb

    def n_active_params(self) -> int:
        """Active params per token (MoE: top_k experts only)."""
        if self.family != "moe":
            return self.n_params()
        d, f = self.d_model, self.d_ff
        ef = self.expert_d_ff or f
        hd = self.head_dim
        attn = d * hd * (self.n_heads * 2 + self.n_kv_heads * 2)
        moe_layers = self.n_layers // self.moe_every
        dense_layers = self.n_layers - moe_layers
        act_blk = self.top_k * 3 * d * ef + d * self.n_experts
        if self.shared_expert:
            act_blk += 3 * d * f
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        return moe_layers * (attn + act_blk) \
            + dense_layers * (attn + 3 * d * f) + emb


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # train | prefill | decode


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def smoke_config(cfg: ArchConfig) -> ArchConfig:
    """Reduced same-family config for CPU smoke tests."""
    return replace(
        cfg,
        n_layers=min(cfg.n_layers, 4 if cfg.moe_every == 1 else 4),
        d_model=128,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 4) if cfg.n_kv_heads > 1 else 1,
        d_ff=256,
        vocab=512,
        head_dim=32,
        n_experts=min(cfg.n_experts, 8) if cfg.n_experts else 0,
        top_k=min(cfg.top_k, 2) if cfg.top_k else 0,
        expert_d_ff=64 if cfg.expert_d_ff else None,
        ssm_state=min(cfg.ssm_state, 16) if cfg.ssm_state else 0,
        ssm_head_dim=32,
        n_enc_layers=min(cfg.n_enc_layers, 2),
        sliding_window=16 if cfg.sliding_window else None,
        n_patches=8 if cfg.n_patches else 0,
        mrope_sections=(4, 6, 6) if cfg.mrope_sections else None,
        param_dtype="float32",
        remat="none",
        shared_attn_every=cfg.shared_attn_every and 2,
        shared_expert_d_ff=128 if cfg.shared_expert_d_ff else None,
        layer_types=_smoke_layer_types(cfg.layer_types),
    )


def _smoke_layer_types(types):
    """Four layers with every mixer kind of ``types``: each kind once, in
    the order the pattern first uses it, then the first kind again."""
    if types is None:
        return None
    kinds = list(dict.fromkeys(types))
    return tuple(kinds + [kinds[0]] * (4 - len(kinds)))
