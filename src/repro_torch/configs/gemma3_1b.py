"""gemma3-1b [dense] — 5:1 local:global attention, 128k ctx, vocab 262144.
[hf:google/gemma-3-1b-pt; unverified]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    arch_id="gemma3-1b", family="dense",
    n_layers=26, d_model=1152, n_heads=4, n_kv_heads=1,
    d_ff=6912, vocab=262_144, head_dim=256,
    sliding_window=512, local_global_ratio=5,
    rope_theta=10_000.0, rope_theta_global=1_000_000.0,
    tie_embeddings=True, embed_scale=True, qk_norm=True,
    long_context_ok=True,  # local layers window-bounded; global kv=1 (DESIGN §4)
    grad_accum=2,  # fits 16 GiB/dev at train_4k (EXPERIMENTS.md §Dry-run)
)
