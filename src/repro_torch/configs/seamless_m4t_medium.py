"""seamless-m4t-medium [audio] — encoder-decoder; speech frontend stubbed
(input_specs provides precomputed frame embeddings). [arXiv:2308.11596; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    arch_id="seamless-m4t-medium", family="encdec",
    n_layers=12, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=4096, vocab=256_206, n_enc_layers=12, frames_ratio=4,
    grad_accum=2,  # fits 16 GiB/dev at train_4k (EXPERIMENTS.md §Dry-run)
)
