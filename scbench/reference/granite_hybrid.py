"""Plain reference of IBM Granite 4.0-H (HF ``granitemoehybrid``): the full
forward pass of one sequence, in plain ``torch`` and float32, from the
published equations.  It imports nothing of the program under test.

    h = embed(tok) * embedding_multiplier
    per layer:  h = h + residual_multiplier * mixer(rms(h))
                h = h + residual_multiplier * (moe(rms(h)) + shared(rms(h)))
    logits = rms(h) @ embed.T / logits_scaling

``mixer`` is layer i's ``layer_types[i]``: Mamba2 (z, x, B, C and dt
projections; a causal depthwise conv with bias and silu on x, B and C;
``dt = softplus(dt + dt_bias)``; ``A = -exp(A_log)``; the recurrence token
by token, plus ``D * x``; then ``rms(y * silu(z))`` and the out
projection) or causal GQA attention with no position embedding (NoPE),
its logits scaled by ``attention_multiplier``.  The MoE routes each token
to the top-k of the router's logits, gates them by the softmax over those
k logits, and computes every (token, expert) pair (dropless) in a loop over
the experts; an expert and the shared MLP are ``silu(x @ a) * (x @ b)``
then the output projection, ``a`` and ``b`` being the two halves of the
published ``input_linear``.  Each RMSNorm is computed in float32 with
``rms_norm_eps`` and cast back before its weight multiplies it.

Departures from the published description: none beyond running in
float32 (published: bfloat16).  ``dtype=torch.bfloat16`` runs the same
mathematics in bfloat16 and ``capacity_factor`` drops the slots past each
expert's capacity: both exist only to show that the comparison with the
program rejects them.

``weights`` is a dict: ``embed [V, D]``, ``final_norm [D]`` and
``layers``, one dict a layer with ``kind``, ``input_norm``,
``post_norm``, ``router [D, E]``, ``gate``/``up`` ``[E, D, F]``, ``down
[E, F, D]``, ``shared_gate``/``shared_up`` ``[D, Fs]``, ``shared_down
[Fs, D]``, and for a Mamba2 layer ``in_z``/``in_x`` ``[D, Di]``,
``in_B``/``in_C`` ``[D, G*N]``, ``in_dt [D, H]``, ``conv_x``/``conv_B``/
``conv_C`` ``[W, C]`` with their ``*_bias``, ``dt_bias``, ``A_log``, ``D``
``[H]``, ``gate_norm [Di]``, ``out [Di, D]``; for an attention layer ``q
[D, Hq*dh]``, ``k``/``v`` ``[D, Hkv*dh]``, ``o [Hq*dh, D]``.  ``config``
holds the published config.json's keys.  `init_weights` draws such a dict
from a generator.
"""
import math

import torch
import torch.nn.functional as F

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def rms(x, w, eps):
    x32 = x.float()
    x32 = x32 * torch.rsqrt(x32.pow(2).mean(-1, keepdim=True) + eps)
    return w * x32.to(x.dtype)


def causal_conv(x, w, b):
    """Depthwise causal conv over time: x [S, C], w [W, C]; y[t] = b +
    sum_i w[i] * x[t - W + 1 + i]."""
    s, width = x.shape[0], w.shape[0]
    xp = torch.cat([x.new_zeros((width - 1, x.shape[1])), x])
    return b + sum(w[i] * xp[i:i + s] for i in range(width))


def mamba2(lw, h, cfg):
    s = h.shape[0]
    nh, dh = cfg["mamba_n_heads"], cfg["mamba_d_head"]
    ng, n = cfg["mamba_n_groups"], cfg["mamba_d_state"]
    z = h @ lw["in_z"]
    x = F.silu(causal_conv(h @ lw["in_x"], lw["conv_x"], lw["conv_x_bias"]))
    bm = F.silu(causal_conv(h @ lw["in_B"], lw["conv_B"], lw["conv_B_bias"]))
    cm = F.silu(causal_conv(h @ lw["in_C"], lw["conv_C"], lw["conv_C_bias"]))
    dt = F.softplus(h @ lw["in_dt"] + lw["dt_bias"])            # [S, H]
    a = -torch.exp(lw["A_log"].float()).to(h.dtype)              # [H]
    x = x.reshape(s, nh, dh)
    group = torch.arange(nh, device=h.device) // (nh // ng)      # head -> g
    bm = bm.reshape(s, ng, n)[:, group]                          # [S, H, N]
    cm = cm.reshape(s, ng, n)[:, group]
    state = h.new_zeros((nh, dh, n))
    ys = []
    for t in range(s):
        decay = torch.exp(dt[t] * a)                             # [H]
        state = state * decay[:, None, None] + \
            (dt[t][:, None] * x[t])[:, :, None] * bm[t][:, None, :]
        ys.append(state @ cm[t][:, :, None])
    y = torch.stack(ys)[..., 0] + lw["D"][None, :, None] * x     # [S, H, Dh]
    y = y.reshape(s, nh * dh)
    g = y.float() * F.silu(z.float())
    g = g * torch.rsqrt(g.pow(2).mean(-1, keepdim=True)
                        + cfg["rms_norm_eps"])
    return (lw["gate_norm"] * g.to(h.dtype)) @ lw["out"]


def attention(lw, h, cfg):
    s = h.shape[0]
    hq, hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    dh = cfg["hidden_size"] // hq if cfg.get("head_dim") is None \
        else cfg["head_dim"]
    q = (h @ lw["q"]).reshape(s, hq, dh).transpose(0, 1)         # [Hq,S,dh]
    k = (h @ lw["k"]).reshape(s, hkv, dh).transpose(0, 1)
    v = (h @ lw["v"]).reshape(s, hkv, dh).transpose(0, 1)
    k = k.repeat_interleave(hq // hkv, dim=0)
    v = v.repeat_interleave(hq // hkv, dim=0)
    logits = (q @ k.transpose(1, 2)) * cfg["attention_multiplier"]
    causal = torch.ones((s, s), dtype=torch.bool, device=h.device).tril()
    logits = logits.masked_fill(~causal, float("-inf"))
    p = torch.softmax(logits.float(), dim=-1).to(h.dtype)
    return (p @ v).transpose(0, 1).reshape(s, hq * dh) @ lw["o"]


def swiglu(x, a, b, out):
    return (F.silu(x @ a) * (x @ b)) @ out


def kept_slots(idx, n_experts, capacity_factor, capacity_group):
    """[S, K] bool: which slots an expert's capacity keeps.  Capacity is
    ``ceil(g * factor * K / E)`` slots an expert in each group of ``g``
    consecutive tokens, handed out in flat (token, k) order."""
    s, k = idx.shape
    keep = torch.ones_like(idx, dtype=torch.bool)
    if capacity_factor is None:
        return keep
    g = capacity_group or s
    for t0 in range(0, s, g):
        blk = idx[t0:t0 + g].reshape(-1)
        cap = math.ceil(blk.numel() // k * capacity_factor * k / n_experts)
        onehot = F.one_hot(blk, n_experts)
        pos = (onehot.cumsum(0) * onehot).sum(-1) - 1
        keep[t0:t0 + g] = (pos < cap).reshape(-1, k)
    return keep


def moe(lw, h, cfg, capacity_factor=None, capacity_group=None,
        margins=None, routes=None):
    top_k, n_experts = cfg["num_experts_per_tok"], cfg["num_local_experts"]
    logits = h @ lw["router"]
    top, idx = torch.topk(logits, top_k, dim=-1)
    if margins is not None and top_k < n_experts:
        nxt = torch.topk(logits, top_k + 1, dim=-1).values[:, -1]
        margins.append((top[:, -1] - nxt).float())
    if routes is not None:
        routes.append(idx)
    gates = torch.softmax(top.float(), dim=-1).to(h.dtype)      # [S, K]
    gates = gates * kept_slots(idx, n_experts, capacity_factor,
                               capacity_group)
    out = torch.zeros_like(h)
    for e in range(n_experts):
        tok, slot = torch.nonzero(idx == e, as_tuple=True)
        if tok.numel():
            y = swiglu(h[tok], lw["gate"][e], lw["up"][e], lw["down"][e])
            out.index_add_(0, tok, y * gates[tok, slot][:, None])
    return out


def forward(weights, cfg, tokens, *, dtype=torch.float32,
            capacity_factor=None, capacity_group=None, margins=None,
            routes=None):
    """Logits [S, V] (float32) of the sequence ``tokens`` [S].  Lists
    given as ``margins`` and ``routes`` get, for each layer, each token's
    routing margin [S] (its k-th largest router logit less its (k+1)-th)
    and its experts [S, K]."""
    w = cast(weights, dtype)
    eps, rm = cfg["rms_norm_eps"], cfg["residual_multiplier"]
    h = w["embed"][tokens.long()] * cfg["embedding_multiplier"]
    for lw in w["layers"]:
        x = rms(h, lw["input_norm"], eps)
        mix = mamba2(lw, x, cfg) if lw["kind"] == "mamba" \
            else attention(lw, x, cfg)
        h = h + rm * mix
        x = rms(h, lw["post_norm"], eps)
        ffn = moe(lw, x, cfg, capacity_factor, capacity_group,
                  margins, routes) + swiglu(
            x, lw["shared_gate"], lw["shared_up"], lw["shared_down"])
        h = h + rm * ffn
    h = rms(h, w["final_norm"], eps)
    return ((h @ w["embed"].T) / cfg["logits_scaling"]).float()


def init_weights(cfg, generator, device=None):
    """Weights for ``cfg`` (config.json keys; layers 0 to
    ``num_hidden_layers - 1`` of ``layer_types``) drawn from ``generator``
    on ``device``, float32: each matrix N(0, 1 / fan-in) (the table N(0,
    0.02^2)), each norm weight 1 + N(0, 0.1^2), Mamba2's ``A_log`` the log
    of U(1, 16), ``dt_bias`` the inverse softplus of a dt log-uniform over
    [1e-3, 1e-1], ``D`` 1 + N(0, 0.1^2), the conv biases N(0, 0.1^2)."""
    def normal(*shape, std):
        return torch.randn(shape, generator=generator, device=device) \
            .mul_(std)

    def uniform(n, lo, hi):
        return torch.rand(n, generator=generator, device=device) \
            .mul_(hi - lo).add_(lo)

    def norm(n):
        return normal(n, std=0.1).add_(1.0)

    d, v = cfg["hidden_size"], cfg["vocab_size"]
    e, f = cfg["num_local_experts"], cfg["intermediate_size"]
    fs = cfg["shared_intermediate_size"]
    layers = []
    for kind in cfg["layer_types"][:cfg["num_hidden_layers"]]:
        lw = {"kind": kind, "input_norm": norm(d)}
        if kind == "mamba":
            nh, w = cfg["mamba_n_heads"], cfg["mamba_d_conv"]
            di = nh * cfg["mamba_d_head"]
            gn = cfg["mamba_n_groups"] * cfg["mamba_d_state"]
            for name, width in (("z", di), ("x", di), ("B", gn), ("C", gn),
                                ("dt", nh)):
                lw["in_" + name] = normal(d, width, std=d ** -0.5)
            for name, width in (("x", di), ("B", gn), ("C", gn)):
                lw["conv_" + name] = normal(w, width, std=w ** -0.5)
                lw[f"conv_{name}_bias"] = normal(width, std=0.1)
            dt = torch.exp(uniform(nh, math.log(1e-3), math.log(1e-1)))
            lw.update(dt_bias=dt + torch.log(-torch.expm1(-dt)),
                      A_log=torch.log(uniform(nh, 1.0, 16.0)),
                      D=norm(nh), gate_norm=norm(di),
                      out=normal(di, d, std=di ** -0.5))
        else:
            hq, hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
            dh = cfg.get("head_dim") or d // hq
            lw.update(q=normal(d, hq * dh, std=d ** -0.5),
                      k=normal(d, hkv * dh, std=d ** -0.5),
                      v=normal(d, hkv * dh, std=d ** -0.5),
                      o=normal(hq * dh, d, std=(hq * dh) ** -0.5))
        lw.update(post_norm=norm(d), router=normal(d, e, std=d ** -0.5),
                  gate=normal(e, d, f, std=d ** -0.5),
                  up=normal(e, d, f, std=d ** -0.5),
                  down=normal(e, f, d, std=f ** -0.5),
                  shared_gate=normal(d, fs, std=d ** -0.5),
                  shared_up=normal(d, fs, std=d ** -0.5),
                  shared_down=normal(fs, d, std=fs ** -0.5))
        layers.append(lw)
    return {"embed": normal(v, d, std=0.02), "final_norm": norm(d),
            "layers": layers}


def cast(weights, dtype):
    """The weights in ``dtype`` (the same tensors where they already are)."""
    def one(v):
        return v.to(dtype) if isinstance(v, torch.Tensor) else v
    return {"embed": one(weights["embed"]),
            "final_norm": one(weights["final_norm"]),
            "layers": [{k: one(v) for k, v in lw.items()}
                       for lw in weights["layers"]]}
