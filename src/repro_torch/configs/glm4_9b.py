"""glm4-9b [dense] — RoPE (partial rotary 0.5), GQA kv=2. [hf:THUDM/glm-4-9b; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    arch_id="glm4-9b", family="dense",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=2,
    d_ff=13_696, vocab=151_552, partial_rotary=0.5, fsdp=True,
    grad_accum=8,  # fits 16 GiB/dev at train_4k (EXPERIMENTS.md §Dry-run)
)
