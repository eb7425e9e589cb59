"""llama4-maverick-400b-a17b [moe] — MoE every other layer, 128e top-1 +
shared expert (400B total / 17B active reading — DESIGN.md §4).
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    arch_id="llama4-maverick-400b-a17b", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=8192, vocab=202_048,
    n_experts=128, top_k=1, moe_every=2, shared_expert=True,
    expert_d_ff=8192, fsdp=True, expert_axis="data",
    moment_dtype="bfloat16",  # fit v5e HBM (DESIGN.md §5)
    # production default: shard_map EP sorted dispatch (204x dispatch-
    # FLOP reduction, EXPERIMENTS.md §Perf); "einsum" = faithful baseline
    moe_impl="ep",
    grad_accum=16,  # fits 16 GiB/dev at train_4k (EXPERIMENTS.md §Dry-run)
)
