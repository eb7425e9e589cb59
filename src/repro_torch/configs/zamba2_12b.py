"""zamba2-1.2b [hybrid] — Mamba2 backbone + shared attention blocks.
[arXiv:2411.15242; hf]  38 mamba2 blocks; one shared attn block applied every
6 blocks (per-application LoRA omitted — DESIGN.md §4)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    arch_id="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab=32_000, ssm_state=64, ssm_head_dim=64,
    mamba_version=2, shared_attn_every=6,
    long_context_ok=True, attn_window_long=8192,
    grad_accum=8,  # fits 16 GiB/dev at train_4k (EXPERIMENTS.md §Dry-run)
)
