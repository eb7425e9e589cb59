"""Assigned architecture configs (one module per arch) + registry."""
from .base import SHAPES, ArchConfig, ShapeConfig, smoke_config
from .falcon_mamba_7b import CONFIG as falcon_mamba_7b
from .gemma3_1b import CONFIG as gemma3_1b
from .granite_4_0_h_small import CONFIG as granite_4_0_h_small
from .glm4_9b import CONFIG as glm4_9b
from .llama4_maverick_400b_a17b import CONFIG as llama4_maverick_400b_a17b
from .olmoe_1b_7b import CONFIG as olmoe_1b_7b
from .qwen15_05b import CONFIG as qwen15_05b
from .qwen2_vl_7b import CONFIG as qwen2_vl_7b
from .qwen3_4b import CONFIG as qwen3_4b
from .seamless_m4t_medium import CONFIG as seamless_m4t_medium
from .zamba2_12b import CONFIG as zamba2_12b

ARCHS: dict[str, ArchConfig] = {
    c.arch_id: c
    for c in [
        qwen15_05b, glm4_9b, qwen3_4b, gemma3_1b, zamba2_12b,
        llama4_maverick_400b_a17b, olmoe_1b_7b, seamless_m4t_medium,
        qwen2_vl_7b, falcon_mamba_7b,
    ]
}

# archs of the port alone (no counterpart in the reference, so outside the
# parity, dry-run and sharding sweeps over ARCHS)
PORT_ARCHS: dict[str, ArchConfig] = {
    c.arch_id: c for c in [granite_4_0_h_small]
}


def get_arch(arch_id: str) -> ArchConfig:
    known = {**ARCHS, **PORT_ARCHS}
    if arch_id not in known:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(known)}")
    return known[arch_id]
