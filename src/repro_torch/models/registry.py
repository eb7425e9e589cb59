"""Model registry: family -> model module, the serving entry points and
the input specs of each (arch x shape) step.

Every family of the reference is here: dense, moe and vlm on
`repro_torch.models.lm`, ssm on `.ssm`, hybrid on `.hybrid` and encdec on
`.encdec`, each with its training loss (`loss_fn`), and the port's own
hybrid_moe (granite) on `.hybrid_moe`.  `input_specs(cfg,
shape)` gives every input of a step as a tensor on the meta device: shape
and dtype, no allocation.
"""
from __future__ import annotations

from types import ModuleType

import torch

from ..configs.base import SHAPES, ArchConfig, ShapeConfig
from . import encdec, hybrid, hybrid_moe, lm, ssm

_FAMILY_MOD: dict[str, ModuleType] = {
    "dense": lm, "moe": lm, "vlm": lm,
    "ssm": ssm, "hybrid": hybrid, "encdec": encdec,
    "hybrid_moe": hybrid_moe,
}


def model_module(cfg: ArchConfig) -> ModuleType:
    if cfg.family not in _FAMILY_MOD:
        raise ValueError(f"unknown family {cfg.family!r}")
    return _FAMILY_MOD[cfg.family]


def init_params(cfg: ArchConfig, generator: torch.Generator, device=None):
    """Random parameters drawn from ``generator`` on ``device``."""
    return model_module(cfg).init_params(cfg, generator, device)


def param_shapes(cfg: ArchConfig):
    """The model on the meta device: every parameter's shape and dtype,
    with no allocation and no draw from a generator."""
    return model_module(cfg).init_params(cfg, None, "meta")


def loss_fn(cfg: ArchConfig, params, batch: dict):
    """(the loss to differentiate, metrics) of one batch: ``tokens`` and
    ``labels``, plus ``vision_embeds``/``positions`` (vlm) or ``frames``
    (encdec)."""
    return model_module(cfg).loss_fn(cfg, params, batch)


def prefill(cfg: ArchConfig, params, batch: dict,
            cache_dtype=torch.bfloat16, cap: int | None = None):
    """(last-token logits [B,1,V], cache) for ``batch["tokens"]`` (plus
    ``vision_embeds`` for vlm and ``frames`` for encdec).  The ssm cache is
    O(1) in the context, so ``cap`` is not passed to it."""
    kwargs = {}
    if cap is not None and cfg.family != "ssm":
        kwargs["cap"] = cap
    if cfg.family == "vlm":
        kwargs["vision_embeds"] = batch.get("vision_embeds")
    if cfg.family == "encdec":
        kwargs["frames"] = batch.get("frames")
    return model_module(cfg).prefill(cfg, params, batch["tokens"],
                                     cache_dtype=cache_dtype, **kwargs)


def decode_step(cfg: ArchConfig, params, cache, tokens, pos: int):
    return model_module(cfg).decode_step(cfg, params, cache, tokens, pos)


def cache_shapes(cfg: ArchConfig, batch: int, cap: int,
                 dtype=torch.bfloat16):
    """The serving cache on the meta device: shapes and dtypes, no
    allocation.  encdec's cross cache holds ``cap // frames_ratio``
    frames; the ssm cache has no capacity."""
    mod = model_module(cfg)
    if cfg.family == "encdec":
        return mod.init_cache(cfg, batch, cap, cap // cfg.frames_ratio,
                              dtype, device="meta")
    if cfg.family == "ssm":
        return mod.init_cache(cfg, batch, dtype=dtype, device="meta")
    return mod.init_cache(cfg, batch, cap, dtype, device="meta")


# ---------------------------------------------------------------------------
# input specs per (arch x shape)
# ---------------------------------------------------------------------------

def sds(shape, dtype) -> torch.Tensor:
    """A stand-in for one input: its shape and dtype on the meta device."""
    return torch.empty(shape, dtype=dtype, device="meta")


def supports_shape(cfg: ArchConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """(supported, reason-if-not).  long_500k needs sub-quadratic attention
    (ssm, hybrid or local-global); pure full attention skips it."""
    if shape.name == "long_500k" and not cfg.long_context_ok:
        return False, ("pure full-attention arch: 500k dense-KV decode is the "
                       "quadratic regime this shape excludes (DESIGN.md §4)")
    return True, ""


def input_specs(cfg: ArchConfig, shape: ShapeConfig | str) -> dict:
    """Meta tensors for every input of the step the shape runs: the batch
    of a train or prefill step, or a decode step's cache (per layer, from
    `cache_shapes`), one new token per row and its position."""
    if isinstance(shape, str):
        shape = SHAPES[shape]
    b, s = shape.global_batch, shape.seq_len
    tok = torch.int32
    if shape.kind in ("train", "prefill"):
        batch = {"tokens": sds((b, s), tok)}
        if shape.kind == "train":
            batch["labels"] = sds((b, s), tok)
        if cfg.family == "vlm":
            batch["vision_embeds"] = sds((b, cfg.n_patches, cfg.d_model),
                                         torch.bfloat16)
            if shape.kind == "train":
                batch["positions"] = sds((3, b, s), tok)
        if cfg.family == "encdec":
            batch["frames"] = sds((b, s // cfg.frames_ratio, cfg.d_model),
                                  torch.bfloat16)
        return batch
    # decode: one new token against a cache of seq_len
    return {"cache": cache_shapes(cfg, b, s),
            "tokens": sds((b, 1), tok),
            "pos": sds((), torch.int32)}
