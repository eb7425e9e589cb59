"""qwen3-4b [dense] — qk_norm, GQA kv=8. [hf:Qwen/Qwen3-8B; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    arch_id="qwen3-4b", family="dense",
    n_layers=36, d_model=2560, n_heads=32, n_kv_heads=8,
    d_ff=9728, vocab=151_936, qk_norm=True, head_dim=128, fsdp=True,
    grad_accum=4,  # fits 16 GiB/dev at train_4k (EXPERIMENTS.md §Dry-run)
)
