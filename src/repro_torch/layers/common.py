"""Shared building blocks: norms, RoPE (incl. M-RoPE), MLPs, embeddings.

The layers are plain functions over parameter holders (``nn.Module``s whose
tensors carry the reference's names and layouts: ``w_gate [d, f]``,
``tok [V, d]`` ...), so `repro_torch.convert` can copy the JAX package's
parameter pytrees in unchanged.  Parameters are made as inference tensors
(``requires_grad=False``), so serving builds no autograd graph; the trainer
turns them trainable with ``model.requires_grad_(True)`` and wraps each
layer in `apply_remat`.
"""
from __future__ import annotations

import warnings

import numpy as np
import torch
from torch import nn

from ..kernels import is_dtensor
from ..launch.activations import BATCH, constrain


def param(t: torch.Tensor) -> nn.Parameter:
    """A parameter made as an inference tensor: no autograd graph is built
    over it until the trainer sets ``requires_grad``."""
    return nn.Parameter(t, requires_grad=False)


def normal(shape, dtype, generator: torch.Generator, device,
           scale: float) -> nn.Parameter:
    """``N(0, 1) * scale`` drawn in f32 from ``generator``, cast to
    ``dtype`` (the reference draws in the parameter dtype; the two
    packages' draws differ anyway, so tests carry weights across)."""
    return param((torch.randn(shape, generator=generator, device=device,
                              dtype=torch.float32) * scale).to(dtype))


def rms_norm(scale, x, eps: float = 1e-6):
    """RMS norm in f32, applied as ``1 + scale`` (zero-init scales)."""
    dt = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps))
            * (1.0 + scale.to(torch.float32))).to(dt)


def init_rms_norm(d: int, dtype, device) -> nn.Parameter:
    """Norm scales are raw vectors (zero-init, applied as 1 + scale)."""
    return param(torch.zeros((d,), dtype=dtype, device=device))


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_frequencies(rotary_dim: int, theta, device=None) -> torch.Tensor:
    """``theta ** -(2i / rotary_dim)`` in f32 (theta rounded to f32 first,
    as the reference's per-layer theta array is)."""
    expo = torch.arange(0, rotary_dim, 2, dtype=torch.float32,
                        device=device) / rotary_dim
    return torch.tensor(theta, dtype=torch.float32, device=device) ** (-expo)


def _rotate_pairs(x, sin, cos):
    """Rotate interleaved (even, odd) pairs of the last dim by the angles."""
    x1, x2 = x[..., 0::2], x[..., 1::2]
    o1 = x1 * cos - x2 * sin
    o2 = x2 * cos + x1 * sin
    return torch.stack([o1, o2], dim=-1).reshape(x.shape)


def apply_rope(x, positions, *, theta=10000.0, rotary_dim: int | None = None):
    """x: [B, S, H, Dh]; positions: [B, S] (int). Partial rotary supported:
    only the first ``rotary_dim`` channels rotate."""
    dh = x.shape[-1]
    rd = rotary_dim or dh
    inv = rope_frequencies(rd, theta, x.device)
    ang = positions[..., None].to(torch.float32) * inv   # [B,S,rd/2]
    sin = torch.sin(ang)[:, :, None, :]
    cos = torch.cos(ang)[:, :, None, :]
    out = _rotate_pairs(x[..., :rd], sin, cos)
    if rd < dh:
        out = torch.cat([out.to(x.dtype), x[..., rd:]], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x, positions3, *, theta=10000.0,
                sections: tuple[int, int, int] = (16, 24, 24)):
    """Multimodal RoPE (Qwen2-VL).  positions3: [3, B, S] (t, h, w ids);
    `sections` gives rotary half-dims per section, sum = Dh/2."""
    dh = x.shape[-1]
    if sum(sections) != dh // 2:
        raise ValueError(f"sections {sections} do not sum to {dh // 2}")
    inv = rope_frequencies(dh, theta, x.device)                 # [dh/2]
    ang = positions3[..., None].to(torch.float32) * inv         # [3,B,S,dh/2]
    sec_id = torch.as_tensor(
        np.repeat(np.arange(3), np.asarray(sections)), device=x.device)
    # select ang[sec_id[d], b, l, d] for each rotary dim d
    ang = ang.gather(0, sec_id.expand(1, *ang.shape[1:]))[0]    # [B,S,dh/2]
    sin = torch.sin(ang)[:, :, None, :]
    cos = torch.cos(ang)[:, :, None, :]
    return _rotate_pairs(x, sin, cos).to(x.dtype)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

class SwiGLU(nn.Module):
    """``w_gate``, ``w_up`` [d, f] and ``w_down`` [f, d]."""

    def __init__(self, d: int, f: int, dtype, generator, device):
        super().__init__()
        s_in, s_out = float(1.0 / np.sqrt(d)), float(1.0 / np.sqrt(f))
        self.w_gate = normal((d, f), dtype, generator, device, s_in)
        self.w_up = normal((d, f), dtype, generator, device, s_in)
        self.w_down = normal((f, d), dtype, generator, device, s_out)

    def forward(self, x):
        return swiglu(self, x)


def swiglu(p, x):
    """The SwiGLU MLP (DTensor operands through `_swiglu_sharded`)."""
    if is_dtensor(x):
        return _swiglu_sharded(p, x)
    h = torch.nn.functional.silu(x @ p.w_gate) * (x @ p.w_up)
    return h @ p.w_down


def _data_and_model(mesh) -> tuple[list[int], int | None]:
    names = tuple(mesh.mesh_dim_names)
    return ([i for i, a in enumerate(names) if a in ("pod", "data")],
            names.index("model") if "model" in names else None)


def per_shard_matmul(x, w):
    """``x @ w`` of a DTensor activation as ``local_map`` of a plain
    product: each rank multiplies its own shard of ``x`` (any dims but the
    last, the sequence included) by the whole ``w``, so no sharded dims are
    flattened together; ``w``'s gradient is a partial sum over the mesh
    dims that shard ``x``."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map
    mesh = x.device_mesh
    pl = tuple(x.placements)
    gw = tuple(Replicate() if q.is_replicate() else Partial() for q in pl)
    return local_map(torch.matmul, out_placements=(pl,),
                     in_placements=(pl, (Replicate(),) * mesh.ndim),
                     in_grad_placements=(pl, gw), device_mesh=mesh,
                     redistribute_inputs=True)(x, w)


def column_parallel_matmul(x, w):
    """``x [..., K] @ w [K, N]`` with N over "model" where it divides
    (Megatron's column parallel product): each rank multiplies its rows of
    ``x`` by its column slice; ``x``'s gradient is a partial sum over
    "model" and ``w``'s over the data axes."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = x.device_mesh
    dp, mi = _data_and_model(mesh)
    split = mi is not None and w.shape[-1] % mesh.size(mi) == 0
    rows = tuple(Replicate() if i == mi else q
                 for i, q in enumerate(x.placements))
    out = tuple(Shard(x.ndim - 1) if split and i == mi else q
                for i, q in enumerate(rows))
    gx = tuple(Partial() if split and i == mi else q
               for i, q in enumerate(rows))
    win = tuple(Shard(1) if split and i == mi else Replicate()
                for i in range(mesh.ndim))
    gw = tuple(Shard(1) if split and i == mi else Replicate()
               if q.is_replicate() else Partial() for i, q in enumerate(rows))
    return local_map(torch.matmul, out_placements=(out,),
                     in_placements=(rows, win), in_grad_placements=(gx, gw),
                     device_mesh=mesh, redistribute_inputs=True)(x, w)


def row_parallel_matmul(x, w):
    """``x [..., K] @ w [K, N]`` with K over "model" (Megatron's row
    parallel product): each rank multiplies its K slice, the partial
    outputs are summed over "model" and laid out as ``x``'s rows;
    ``w``'s gradient is a partial sum over the data axes."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = x.device_mesh
    dp, mi = _data_and_model(mesh)
    rows = tuple(Replicate() if i == mi else q
                 for i, q in enumerate(x.placements))
    xin = tuple(Shard(x.ndim - 1) if i == mi else q
                for i, q in enumerate(rows))
    part = tuple(Partial() if i == mi else q for i, q in enumerate(rows))
    win = tuple(Shard(0) if i == mi else Replicate()
                for i in range(mesh.ndim))
    gw = tuple(Shard(0) if i == mi else Replicate() if q.is_replicate()
               else Partial() for i, q in enumerate(rows))
    y = local_map(torch.matmul, out_placements=(part,),
                  in_placements=(xin, win), in_grad_placements=(xin, gw),
                  device_mesh=mesh, redistribute_inputs=True)(x, w)
    return y.redistribute(mesh, rows)


def _swiglu_sharded(p, x):
    """`swiglu` of DTensors, tensor-parallel as Megatron lays it out: each
    rank multiplies its batch rows by its "model" slice of the hidden
    width, the partial outputs are summed over "model", and the weights'
    gradients come back as partial sums over the data axes (the
    data-parallel reduction).  DTensor left to itself gathers a weight
    rather than move an activation, and computes the whole width."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = x.device_mesh
    dp, mi = _data_and_model(mesh)
    f = p.w_gate.shape[-1]
    split = mi is not None and f % mesh.size(mi) == 0

    def lay(data, model):
        return tuple(data if i in dp else model if i == mi else Replicate()
                     for i in range(mesh.ndim))

    x = constrain(x, BATCH)
    rows = tuple(x.placements)
    part = tuple(Partial() if split and i == mi else q
                 for i, q in enumerate(rows))
    cols = lay(Replicate(), Shard(1) if split else Replicate())
    down = lay(Replicate(), Shard(0) if split else Replicate())
    gcols = lay(Partial(), Shard(1) if split else Replicate())
    gdown = lay(Partial(), Shard(0) if split else Replicate())
    y = local_map(
        lambda x, wg, wu, wd: (torch.nn.functional.silu(x @ wg) * (x @ wu))
        @ wd, out_placements=(part,), in_placements=(rows, cols, cols, down),
        in_grad_placements=(part, gcols, gcols, gdown), device_mesh=mesh,
        redistribute_inputs=True)(x, p.w_gate, p.w_up, p.w_down)
    return y.redistribute(mesh, rows)


def relu_mlp(p, x):
    """``relu(x @ w_in + b_in) @ w_out + b_out`` (the enc-dec family's
    MLP; ``p`` holds the four tensors as attributes)."""
    return torch.relu(x @ p.w_in + p.b_in) @ p.w_out + p.b_out


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------

def embed(tok, tokens):
    """Rows of the ``tok [V, d]`` table for integer ``tokens`` (a DTensor
    table through `_vocab_parallel_embed`)."""
    if is_dtensor(tok):
        return _vocab_parallel_embed(tok, tokens)
    return tok[tokens.long()]


def _vocab_parallel_embed(tok, tokens):
    """`embed` of a DTensor table whose vocab rows are sharded: each rank
    looks up the ids its rows hold, zeros the rest, and the partial rows
    are summed over the vocab's mesh axes, then laid out as the tokens
    (the gather GSPMD partitions for the reference)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = tok.device_mesh
    table = tuple(p if isinstance(p, Shard) and p.dim == 0 else Replicate()
                  for p in tok.placements)
    vdims = [i for i, p in enumerate(table) if isinstance(p, Shard)]
    n_loc = tok.shape[0]
    row0 = 0
    for i in vdims:
        n_loc //= mesh.size(i)
        row0 = row0 * mesh.size(i) + mesh.get_local_rank(i)
    row0 *= n_loc
    rows = tuple(Partial() if i in vdims else p
                 for i, p in enumerate(tokens.placements))

    def body(ids, t):
        local = ids.long() - row0
        hit = (local >= 0) & (local < n_loc)
        x = torch.nn.functional.embedding(torch.where(hit, local, 0), t)
        return x * hit.unsqueeze(-1).to(x.dtype)

    x = local_map(body, out_placements=(rows,),
                  in_placements=(tuple(tokens.placements), table),
                  device_mesh=mesh, redistribute_inputs=True)(tokens, tok)
    return x.redistribute(mesh, tokens.placements)


def _vocab_parallel_nll(logits, labels, ignore_id: int):
    """Per-token (nll, mask) of DTensor logits whose vocab dim may be
    sharded over "model": each rank takes the log-sum-exp and the label's
    logit over its vocab slice, combined by all-reduces over "model" (the
    max, which needs no gradient, through the functional collective)."""
    import torch.distributed._functional_collectives as funcol
    import torch.distributed.nn.functional as dist_fn
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = logits.device_mesh
    dp, mi = _data_and_model(mesh)
    m = mesh.size(mi) if mi is not None else 1
    split = m > 1 and logits.shape[-1] % m == 0
    group = mesh.get_group(mi) if split else None
    v_loc = logits.shape[-1] // m if split else logits.shape[-1]
    v0 = mesh.get_local_rank(mi) * v_loc if split else 0
    rows = tuple(Shard(0) if i in dp else Replicate()
                 for i in range(mesh.ndim))
    lay = tuple(Shard(2) if split and i == mi else q
                for i, q in enumerate(rows))

    def body(lg, lab):
        lg = lg.to(torch.float32)
        top = lg.detach().amax(dim=-1, keepdim=True)
        if split:
            top = funcol.all_reduce(top, "max", group)
        se = torch.exp(lg - top).sum(dim=-1)
        local = torch.where(lab == ignore_id, 0, lab).long() - v0
        hit = (local >= 0) & (local < v_loc)
        ll = torch.take_along_dim(lg, torch.where(hit, local, 0)
                                  .unsqueeze(-1), dim=-1)[..., 0] * hit
        if split:      # differentiable sums (deprecated name, kept by 2.11)
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", FutureWarning)
                se = dist_fn.all_reduce(se, group=group)
                ll = dist_fn.all_reduce(ll, group=group)
        mask = (lab != ignore_id).to(torch.float32)
        return (torch.log(se) + top[..., 0] - ll) * mask, mask

    return local_map(body, out_placements=(rows, rows),
                     in_placements=(lay, rows), device_mesh=mesh,
                     redistribute_inputs=True)(logits, labels)


def unembed(tok, head_w, x, *, tied: bool):
    """Logits over the padded vocab: ``x @ tok.T`` when tied, else
    ``x @ head_w``."""
    w = tok.T if tied else head_w
    return x @ w.to(x.dtype)


def final_logits(params, x, *, tied: bool):
    """Logits of a model's last hidden states: its ``final_norm``, then
    `unembed` through ``tok`` (tied) or ``head_w``."""
    return unembed(params.tok, params.head_w, rms_norm(params.final_norm, x),
                   tied=tied)


def cross_entropy(logits, labels, *, ignore_id: int = -1):
    """Mean token cross-entropy in fp32; labels==ignore_id are masked
    (DTensor logits through `_vocab_parallel_nll`)."""
    if is_dtensor(logits):
        nll, mask = _vocab_parallel_nll(logits, labels, ignore_id)
        return nll.sum() / torch.clamp(mask.sum(), min=1.0)
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    safe = torch.where(labels == ignore_id, 0, labels).long()
    ll = torch.take_along_dim(logits, safe[..., None], dim=-1)[..., 0]
    mask = (labels != ignore_id).to(torch.float32)
    nll = (lse - ll) * mask
    return nll.sum() / torch.clamp(mask.sum(), min=1.0)


# ---------------------------------------------------------------------------
# activation checkpointing
# ---------------------------------------------------------------------------

def _save_matmuls(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of ``dots``: keep matmul outputs."""
    from torch.utils.checkpoint import CheckpointPolicy
    if op in (torch.ops.aten.mm.default, torch.ops.aten.bmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def apply_remat(fn, policy: str):
    """Activation-checkpoint policy for one layer's forward ``fn``.

    none — save everything (no recompute; activation-memory bound)
    full — save only the layer's inputs; the backward recomputes the rest
           (``torch.utils.checkpoint``, non-reentrant)
    dots — matmul outputs (``aten.mm``/``aten.bmm``) are saved, elementwise
           work is recomputed: the backward runs no forward matmul again.
    """
    if policy == "none":
        return fn
    from torch.utils import checkpoint as ckpt
    if policy == "full":
        return lambda *a, **k: ckpt.checkpoint(fn, *a, use_reentrant=False,
                                               **k)
    if policy == "dots":
        contexts = lambda: ckpt.create_selective_checkpoint_contexts(
            _save_matmuls)
        return lambda *a, **k: ckpt.checkpoint(
            fn, *a, use_reentrant=False, context_fn=contexts, **k)
    raise ValueError(f"unknown remat policy {policy!r}")
