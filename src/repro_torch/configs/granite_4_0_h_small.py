"""granite-4.0-h-small [hybrid_moe] — IBM Granite 4.0-H Small (32B-A9B).
[hf: ibm-granite/granite-4.0-h-small config.json, model_type
granitemoehybrid]  40 layers: 36 Mamba2 mixers and 4 NoPE GQA attention
mixers (layers 5, 15, 25, 35), every layer followed by a dropless MoE of
72 experts (width 768, top-10) plus one shared expert (width 1,536).
A port-only arch: the reference has no such family."""
from .base import ArchConfig

LAYER_TYPES = tuple("attention" if i % 10 == 5 else "mamba"
                    for i in range(40))

CONFIG = ArchConfig(
    arch_id="granite-4.0-h-small", family="hybrid_moe",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=768, vocab=100_352, tie_embeddings=True,
    layer_types=LAYER_TYPES, attention_multiplier=0.0078125,
    embedding_multiplier=12.0, residual_multiplier=0.22,
    logits_scaling=16.0, norm_eps=1e-5,
    n_experts=72, top_k=10, expert_d_ff=768, shared_expert=True,
    shared_expert_d_ff=1536,
    ssm_state=128, ssm_expand=2, ssm_conv=4, ssm_head_dim=64,
    mamba_version=2, long_context_ok=True,
    param_dtype="float32",
)
