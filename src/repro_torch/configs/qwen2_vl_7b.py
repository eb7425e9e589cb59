"""qwen2-vl-7b [vlm] — M-RoPE, dynamic resolution; backbone only, vision
patches arrive pre-embedded. [arXiv:2409.12191; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    arch_id="qwen2-vl-7b", family="vlm",
    n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4,
    d_ff=18_944, vocab=152_064, qkv_bias=True,
    mrope_sections=(16, 24, 24), n_patches=1024, fsdp=True,
    grad_accum=4,  # fits 16 GiB/dev at train_4k (EXPERIMENTS.md §Dry-run)
)
