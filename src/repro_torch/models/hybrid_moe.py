"""Hybrid Mamba2 / attention LM with a dropless MoE in every layer: IBM
Granite 4.0-H (HF ``granitemoehybrid``).  A family of the port alone.

Layer i's mixer is ``cfg.layer_types[i]``: a Mamba2 mixer
(`layers.mamba.mamba2`) or GQA attention without position embedding
(NoPE) whose logits are scaled by ``cfg.attention_multiplier``.  Every
layer then runs the dropless MoE (`layers.moe_dropless`) plus a shared
SwiGLU expert on the same normed input:

    h = embed(tok) * embedding_multiplier
    h = h + residual_multiplier * mixer(rms(h))
    h = h + residual_multiplier * (moe(rms(h)) + shared(rms(h)))
    logits = rms(h) @ embed.T / logits_scaling

Every RMSNorm uses ``cfg.norm_eps``.  The cache holds two kinds of state
side by side, one entry a layer: a `Mamba2Cache` (conv windows and the
SSM state) for a Mamba2 layer, a `KVCache` (updated in place) for an
attention layer:

    cache = {"layers": [Mamba2Cache | KVCache] * n_layers}

On the card every attention runs through the flash kernel with the
config's scale, and every expert FFN, at prefill and at decode, through
the grouped kernel.  `from_published` loads weights in the published
layout (the plain reference's) into the port's parameters.
"""
from __future__ import annotations

import torch
from torch import nn

from .. import tracing
from ..configs.base import ArchConfig
from ..kernels import launches, resolve_device
from ..layers.attention import init_attention, init_kv_cache
from ..layers.common import (SwiGLU, cross_entropy, embed, init_rms_norm,
                             normal, param, rms_norm, swiglu)
from ..layers.mamba import init_mamba2, init_mamba2_cache, mamba2
from ..layers.moe import init_moe
from ..layers.moe_dropless import moe_ffn_dropless


def layer_kinds(cfg: ArchConfig) -> tuple[str, ...]:
    """Each layer's mixer kind, "mamba" or "attention"."""
    kinds = tuple(cfg.layer_types or ())[:cfg.n_layers]
    if len(kinds) != cfg.n_layers or set(kinds) - {"mamba", "attention"}:
        raise ValueError(f"layer_types {cfg.layer_types!r} does not give "
                         f"{cfg.n_layers} layers of mamba or attention")
    return kinds


class HybridMoeLayer(nn.Module):
    """``ln1``, the ``mixer`` (Mamba2 or attention), ``ln2``, the ``moe``
    and the ``shared`` expert."""

    def __init__(self, cfg: ArchConfig, kind: str, generator, device):
        super().__init__()
        d, dt = cfg.d_model, cfg.pdtype
        self.kind = kind
        self.ln1 = init_rms_norm(d, dt, device)
        if kind == "mamba":
            self.mixer = init_mamba2(d, d_state=cfg.ssm_state,
                                     expand=cfg.ssm_expand,
                                     head_dim=cfg.ssm_head_dim,
                                     conv_w=cfg.ssm_conv, dtype=dt,
                                     generator=generator, device=device)
        else:
            self.mixer = init_attention(d, cfg.n_heads, cfg.n_kv_heads,
                                        cfg.head_dim, dt, generator, device)
        self.ln2 = init_rms_norm(d, dt, device)
        self.moe = init_moe(d, cfg.expert_d_ff or cfg.d_ff, cfg.n_experts, dt,
                            generator, device)
        self.shared = SwiGLU(d, cfg.shared_expert_d_ff, dt, generator,
                             device)


class HybridMoeLM(nn.Module):
    """Token table ``tok`` (tied head), ``layers`` and ``final_norm``."""

    def __init__(self, cfg: ArchConfig, generator, device):
        super().__init__()
        if not cfg.tie_embeddings:
            raise ValueError("the hybrid MoE family ties its head")
        self.tok = normal((cfg.vocab_padded, cfg.d_model), cfg.pdtype,
                          generator, device, 0.02)
        self.layers = nn.ModuleList(
            HybridMoeLayer(cfg, kind, generator, device)
            for kind in layer_kinds(cfg))
        self.final_norm = init_rms_norm(cfg.d_model, cfg.pdtype, device)


def init_params(cfg: ArchConfig, generator: torch.Generator,
                device=None) -> HybridMoeLM:
    """Random parameters drawn from ``generator`` on ``device`` (default
    CUDA)."""
    return HybridMoeLM(cfg, generator, resolve_device(device))


def init_cache(cfg: ArchConfig, batch: int, cap: int, dtype=torch.bfloat16,
               device=None) -> dict:
    """Zeroed caches on ``device`` (default CUDA): per layer, Mamba2's conv
    windows and SSM state (f32), or an attention KV cache of ``cap``."""
    dev = resolve_device(device)
    di = cfg.ssm_expand * cfg.d_model
    layers = []
    for kind in layer_kinds(cfg):
        if kind == "mamba":
            layers.append(init_mamba2_cache(
                batch, di, cfg.ssm_state, di // cfg.ssm_head_dim,
                cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_conv, dtype, dev))
        else:
            layers.append(init_kv_cache(batch, cfg.n_kv_heads, cap,
                                        cfg.head_dim, dtype, dev))
    return {"layers": layers}


def _mamba_layer(cfg: ArchConfig, layer, x, cache):
    """``x + rm * mamba2(rms(x))`` -> (x, the layer's new cache)."""
    with tracing.span("hybrid_moe.mamba"):
        y, cache = mamba2(layer.mixer, rms_norm(layer.ln1, x, cfg.norm_eps),
                          cache, head_dim=cfg.ssm_head_dim, eps=cfg.norm_eps)
    return x + cfg.residual_multiplier * y, cache


def _attention_layer(cfg: ArchConfig, layer, x, cache, pos):
    """``attention(rms(x))`` (NoPE, the config's logits scale; decode at
    ``pos``, or prefill or no cache where it is None) -> (y, the layer's
    cache)."""
    with tracing.span("hybrid_moe.attention"):
        return layer.mixer(rms_norm(layer.ln1, x, cfg.norm_eps), None,
                           cache=cache, cache_pos=pos,
                           scale=cfg.attention_multiplier)


def _ffn(cfg: ArchConfig, layer, x, hits=None):
    """(``x + rm * (moe(rms(x)) + shared(rms(x)))``, each token's experts
    [B, S, K])."""
    h = rms_norm(layer.ln2, x, cfg.norm_eps)
    y, idx = moe_ffn_dropless(layer.moe, h, top_k=cfg.top_k, hits=hits)
    return x + cfg.residual_multiplier * (y + swiglu(layer.shared, h)), idx


def _routes(cfg: ArchConfig, cache: dict) -> list | None:
    """The cache's routing record (per layer, a list of [B, tokens, K]),
    made at its first use; None while routes are off (`tracing`)."""
    if not tracing.routes_on():
        return None
    return cache.setdefault("routes", [[] for _ in range(cfg.n_layers)])


def _run(cfg: ArchConfig, params: HybridMoeLM, x, cache, cache_pos):
    new = []
    routes = None if cache is None else _routes(cfg, cache)
    for i, layer in enumerate(params.layers):
        c = None if cache is None else cache["layers"][i]
        if layer.kind == "mamba":
            x, c = _mamba_layer(cfg, layer, x, c)
        else:
            y, c = _attention_layer(cfg, layer, x, c, cache_pos)
            x = x + cfg.residual_multiplier * y
        x, idx = _ffn(cfg, layer, x)
        if routes is not None:
            routes[i].append(idx)
        new.append(c)
    return x, None if cache is None else {**cache, "layers": new}


def _embed(cfg: ArchConfig, params: HybridMoeLM, tokens):
    return embed(params.tok, tokens).to(cfg.pdtype) * cfg.embedding_multiplier


def _logits(cfg: ArchConfig, params: HybridMoeLM, x):
    h = rms_norm(params.final_norm, x, cfg.norm_eps)
    return (h @ params.tok.T.to(h.dtype)) / cfg.logits_scaling


def forward(cfg: ArchConfig, params: HybridMoeLM, tokens, **_):
    """tokens [B, S] -> (logits [B, S, V], aux 0)."""
    x, _ = _run(cfg, params, _embed(cfg, params, tokens), None, None)
    return _logits(cfg, params, x), \
        torch.zeros((), dtype=torch.float32, device=x.device)


def loss_fn(cfg: ArchConfig, params: HybridMoeLM, batch: dict):
    """(mean token cross-entropy, {"loss"}) of ``batch["tokens"]`` against
    ``batch["labels"]``."""
    logits, _ = forward(cfg, params, batch["tokens"])
    loss = cross_entropy(logits, batch["labels"])
    return loss, {"loss": loss}


def prefill(cfg: ArchConfig, params: HybridMoeLM, tokens,
            cache_dtype=torch.bfloat16, cap: int | None = None, **_):
    """(last-token logits [B, 1, V], cache of capacity ``cap``, default the
    prompt length)."""
    b, s = tokens.shape
    cache = init_cache(cfg, b, cap or s, cache_dtype, tokens.device)
    x, cache = _run(cfg, params, _embed(cfg, params, tokens), cache, None)
    return _logits(cfg, params, x[:, -1:]), cache


def decode_step(cfg: ArchConfig, params: HybridMoeLM, cache, tokens,
                pos: int):
    """tokens [B, 1] at position ``pos`` -> (logits [B, 1, V], cache).

    On the card a cache's first decode step runs eagerly; its second
    captures `DecodeGraphs` (kept in the cache) and every later step
    replays them.  The graphed logits are a buffer the next step of the
    same cache overwrites."""
    graphs = cache.get("graphs")
    if graphs is None and cache.get("warm"):
        graphs = cache["graphs"] = DecodeGraphs(cfg, params, cache, tokens)
    if graphs is not None:
        return graphs.step(cfg, params, cache, tokens, int(pos)), cache
    x, cache = _run(cfg, params, _embed(cfg, params, tokens), cache,
                    int(pos))
    cache["warm"] = tokens.device.type == "cuda"
    return _logits(cfg, params, x), cache


class DecodeGraphs:
    """One cache's decode step as CUDA graphs, replayed step after step.

    Eagerly a decode step issues ~1,400 small operations a tenant (the
    Mamba2 recurrence, routing, norms), ~32 ms of host time against ~11 ms
    of device work at granite's widths: the host sets the pace.  Here one
    graph holds each run of layers between attention mixers: its Mamba2
    layers (their state updated in place in the cache) and every layer's
    MoE and shared expert (the grouped kernel's launches among them); the
    last graph ends with the logits.  Each attention mixer runs eagerly
    between two graphs, since its key length grows every step: it is
    `Attention.forward`'s decode (norm, q/k/v projection, the cache write
    at ``pos``, the flash kernel over keys ``0..pos``, the output
    projection), as in an eager step.

    Captured at a cache's second decode step (the first, eager, has loaded
    every kernel and library handle), never under the recorder: spans are
    kept around the replays (``hybrid_moe.graph``) and the attention
    mixers (``hybrid_moe.attention``), and the MoE counts its experts hit
    into a device scalar of its own, added to ``moe.experts_hit`` after
    each replayed step while counters are on.  With routes on, each step's
    experts are copied out of the graphs' buffer into the cache's record.
    """

    def __init__(self, cfg: ArchConfig, params: HybridMoeLM, cache: dict,
                 tokens):
        kinds = layer_kinds(cfg)
        dev = tokens.device
        self.attn = [i for i, k in enumerate(kinds) if k == "attention"]
        self.tokens = tokens.clone()
        self.hits = torch.zeros((), dtype=torch.int64, device=dev)
        self.routes = torch.zeros((cfg.n_layers, tokens.shape[0], 1,
                                   cfg.top_k), dtype=torch.int64, device=dev)
        self.y = [torch.zeros((tokens.shape[0], 1, cfg.d_model),
                              dtype=cfg.pdtype, device=dev)
                  for _ in self.attn]
        self.slots = tokens.shape[0] * cfg.top_k * cfg.n_layers
        self.graphs = []          # (graph, grouped-kernel launches, output)
        counted = launches["moe_grouped_ffn"]
        x, lo = None, 0
        for j, a in enumerate(self.attn + [cfg.n_layers]):
            g = torch.cuda.CUDAGraph()
            n0 = launches["moe_grouped_ffn"]
            with torch.cuda.graph(g):
                if j == 0:
                    self.hits.zero_()
                    x = _embed(cfg, params, self.tokens)
                else:
                    x = x + cfg.residual_multiplier * self.y[j - 1]
                    x, idx = _ffn(cfg, params.layers[lo - 1], x, self.hits)
                    self.routes[lo - 1].copy_(idx)
                for i in range(lo, a):
                    x, new = _mamba_layer(cfg, params.layers[i], x,
                                          cache["layers"][i])
                    for dst, src in zip(cache["layers"][i], new):
                        dst.copy_(src)
                    x, idx = _ffn(cfg, params.layers[i], x, self.hits)
                    self.routes[i].copy_(idx)
                # x: the next attention mixer's input, or the logits
                x = x if a < cfg.n_layers else _logits(cfg, params, x)
            self.graphs.append((g, launches["moe_grouped_ffn"] - n0, x))
            lo = a + 1
        launches["moe_grouped_ffn"] = counted   # capture launched nothing

    def step(self, cfg: ArchConfig, params: HybridMoeLM, cache: dict,
             tokens, pos: int):
        self.tokens.copy_(tokens)
        for j, (g, n, out) in enumerate(self.graphs):
            with tracing.span("hybrid_moe.graph"):
                g.replay()
            launches["moe_grouped_ffn"] += n
            if j < len(self.attn):
                a = self.attn[j]
                y, _ = _attention_layer(cfg, params.layers[a], out,
                                        cache["layers"][a], pos)
                self.y[j].copy_(y)
        if tracing.counting():
            tracing.count("moe.slots", self.slots)
            tracing.count("moe.experts_hit", self.hits.clone())
        routes = _routes(cfg, cache)
        if routes is not None:
            step_routes = self.routes.clone()
            for i, r in enumerate(routes):
                r.append(step_routes[i])
        return self.graphs[-1][2]


# ---------------------------------------------------------------------------
# the published layout (HF config.json keys; weights as a plain reference
# of the published equations takes them)
# ---------------------------------------------------------------------------

# ArchConfig field <- config.json key
_PUBLISHED = {
    "n_layers": "num_hidden_layers", "d_model": "hidden_size",
    "n_heads": "num_attention_heads", "n_kv_heads": "num_key_value_heads",
    "d_ff": "intermediate_size", "expert_d_ff": "intermediate_size",
    "vocab": "vocab_size", "n_experts": "num_local_experts",
    "top_k": "num_experts_per_tok",
    "shared_expert_d_ff": "shared_intermediate_size",
    "ssm_state": "mamba_d_state", "ssm_expand": "mamba_expand",
    "ssm_conv": "mamba_d_conv", "ssm_head_dim": "mamba_d_head",
    "attention_multiplier": "attention_multiplier",
    "embedding_multiplier": "embedding_multiplier",
    "residual_multiplier": "residual_multiplier",
    "logits_scaling": "logits_scaling", "norm_eps": "rms_norm_eps",
    "tie_embeddings": "tie_word_embeddings",
}


def config_from_published(pub: dict, **overrides) -> ArchConfig:
    """The ArchConfig of a granitemoehybrid config.json (its keys as
    published); layers past ``num_hidden_layers`` of ``layer_types`` are
    not built."""
    if pub.get("position_embedding_type") != "nope" or \
            pub.get("mamba_n_groups", 1) != 1 or pub.get("attention_bias") \
            or pub.get("mamba_proj_bias") or not pub.get("mamba_conv_bias"):
        raise ValueError("only NoPE attention without bias and Mamba2 with "
                         "one group, conv bias and no projection bias")
    kw = {f: pub[k] for f, k in _PUBLISHED.items()}
    d, hq = pub["hidden_size"], pub["num_attention_heads"]
    di = pub["mamba_expand"] * d
    if pub["mamba_n_heads"] * pub["mamba_d_head"] != di:
        raise ValueError("mamba_n_heads x mamba_d_head != mamba_expand x "
                         "hidden_size")
    kw.update(
        arch_id=pub.get("name", "granitemoehybrid"), family="hybrid_moe",
        head_dim=pub.get("head_dim") or d // hq,
        layer_types=tuple(pub["layer_types"]), shared_expert=True,
        mamba_version=2, long_context_ok=True,
        param_dtype=pub.get("param_dtype", "float32"),
        embedding_multiplier=float(kw["embedding_multiplier"]),
        logits_scaling=float(kw["logits_scaling"]))
    return ArchConfig(**{**kw, **overrides})


# port parameter <- published weight, a Mamba2 mixer's
_MAMBA = {"w_z": "in_z", "w_x": "in_x", "w_b": "in_B", "w_c": "in_C",
          "w_dt": "in_dt", "conv_x_w": "conv_x", "conv_x_b": "conv_x_bias",
          "conv_b_w": "conv_B", "conv_b_b": "conv_B_bias",
          "conv_c_w": "conv_C", "conv_c_b": "conv_C_bias",
          "dt_bias": "dt_bias", "a_log": "A_log", "d_skip": "D",
          "w_out": "out"}
_ATTENTION = {"wq": "q", "wk": "k", "wv": "v", "wo": "o"}
_FFN = {("moe", "router"): "router", ("moe", "w_gate"): "gate",
        ("moe", "w_up"): "up", ("moe", "w_down"): "down",
        ("shared", "w_gate"): "shared_gate", ("shared", "w_up"): "shared_up",
        ("shared", "w_down"): "shared_down"}


def from_published(cfg: ArchConfig, weights: dict) -> HybridMoeLM:
    """The port's parameters from weights in the published layout (the
    plain reference's: ``embed [V, D]``, ``final_norm``, and per layer
    ``input_norm``, ``post_norm``, the mixer's and the experts' tensors;
    `tests/plain_granite.py` lists them).  A norm weight ``w`` becomes the
    scale ``w - 1`` (the port applies ``1 + scale``), the attention
    projections are split by head, and the table is padded to
    ``cfg.vocab_padded`` rows; every other tensor is taken as it is, so
    the two share storage wherever the dtype is the same."""
    params = HybridMoeLM(cfg, None, torch.device("meta"))

    def put(module, name, t):
        want = getattr(module, name)
        t = t.to(want.dtype).reshape(want.shape)
        setattr(module, name, param(t))

    def norm(module, name, w):
        put(module, name, w - 1.0)

    table = weights["embed"]
    pad = cfg.vocab_padded - table.shape[0]
    if pad:
        table = torch.cat([table, table.new_zeros((pad, table.shape[1]))])
    put(params, "tok", table)
    norm(params, "final_norm", weights["final_norm"])
    if len(weights["layers"]) != cfg.n_layers:
        raise ValueError(f"{len(weights['layers'])} layers of weights for "
                         f"{cfg.n_layers}")
    for layer, lw in zip(params.layers, weights["layers"]):
        if lw["kind"] != layer.kind:
            raise ValueError(f"a {lw['kind']} layer's weights where the "
                             f"config has {layer.kind}")
        names = _MAMBA if layer.kind == "mamba" else _ATTENTION
        for name, key in names.items():
            put(layer.mixer, name, lw[key])
        if layer.kind == "mamba":
            norm(layer.mixer, "norm_scale", lw["gate_norm"])
        norm(layer, "ln1", lw["input_norm"])
        norm(layer, "ln2", lw["post_norm"])
        for (part, name), key in _FFN.items():
            put(getattr(layer, part), name, lw[key])
    return params
