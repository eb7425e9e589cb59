"""Model registry: family -> model module, and the serving entry points.

The dense and vlm families run on `repro_torch.models.lm`; the moe family
(same module in the reference) and the ssm, hybrid and encdec families
raise `NotImplementedError` naming the slice that brings them.
"""
from __future__ import annotations

from types import ModuleType

import torch

from ..configs.base import ArchConfig
from . import lm

_PENDING = {
    "moe": "the moe family (layers/moe.py) comes with the port of the MoE "
           "slice (ROADMAP Queue 1 item c)",
    "ssm": "the ssm family (models/ssm.py, layers/mamba.py) comes with the "
           "port of the remaining model families (ROADMAP Queue 1 item e)",
    "hybrid": "the hybrid family (models/hybrid.py) comes with the port of "
              "the remaining model families (ROADMAP Queue 1 item e)",
    "encdec": "the encdec family (models/encdec.py, cross attention) comes "
              "with the port of the remaining model families (ROADMAP "
              "Queue 1 item e)",
}


def model_module(cfg: ArchConfig) -> ModuleType:
    if cfg.family in _PENDING:
        raise NotImplementedError(_PENDING[cfg.family])
    if cfg.family not in ("dense", "vlm"):
        raise ValueError(f"unknown family {cfg.family!r}")
    return lm


def init_params(cfg: ArchConfig, generator: torch.Generator, device=None):
    """Random parameters drawn from ``generator`` on ``device``."""
    return model_module(cfg).init_params(cfg, generator, device)


def prefill(cfg: ArchConfig, params, batch: dict,
            cache_dtype=torch.bfloat16, cap: int | None = None):
    """(last-token logits [B,1,V], cache) for ``batch["tokens"]``."""
    kwargs = {}
    if cfg.family == "vlm":
        kwargs["vision_embeds"] = batch.get("vision_embeds")
    return model_module(cfg).prefill(cfg, params, batch["tokens"],
                                     cache_dtype=cache_dtype, cap=cap,
                                     **kwargs)


def decode_step(cfg: ArchConfig, params, cache, tokens, pos: int):
    return model_module(cfg).decode_step(cfg, params, cache, tokens, pos)


def cache_shapes(cfg: ArchConfig, batch: int, cap: int,
                 dtype=torch.bfloat16):
    """The serving cache on the meta device: shapes and dtypes, no
    allocation."""
    return model_module(cfg).init_cache(cfg, batch, cap, dtype,
                                        device="meta")
