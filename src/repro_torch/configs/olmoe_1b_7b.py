"""olmoe-1b-7b [moe] — 64 experts top-8, d_ff=1024/expert. [arXiv:2409.02060; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    arch_id="olmoe-1b-7b", family="moe",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1024, vocab=50_304,
    n_experts=64, top_k=8, expert_d_ff=1024, expert_axis="model",
    qk_norm=True,
    # production default: shard_map EP sorted dispatch (204x dispatch-
    # FLOP reduction, EXPERIMENTS.md §Perf); "einsum" = faithful baseline
    moe_impl="ep",
    grad_accum=4,  # fits 16 GiB/dev at train_4k (EXPERIMENTS.md §Dry-run)
)
