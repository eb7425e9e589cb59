"""falcon-mamba-7b [ssm] — attention-free Mamba1 x64. [arXiv:2410.05355; unverified]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    arch_id="falcon-mamba-7b", family="ssm",
    n_layers=64, d_model=4096, n_heads=1, n_kv_heads=1,
    d_ff=0, vocab=65_024, ssm_state=16, mamba_version=1,
    long_context_ok=True, fsdp=True,
    grad_accum=8,  # fits 16 GiB/dev at train_4k (EXPERIMENTS.md §Dry-run)
)
