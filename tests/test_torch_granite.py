"""granite-4.0-h-small (the port's hybrid_moe family) against the plain
reference `plain_granite` on the CPU, at smoke widths with both mixer
kinds, the shared expert and uneven routing.

Tolerances: the port and the reference compute the same f32 mathematics
in another order (separate projections against one product, a loop of
decode steps against one pass over the sequence, the sorted dispatch
against a loop over the experts), so they differ by f32 rounding only:
logits of order 0.1 agree to 1e-6 absolute, where computing the reference
in bfloat16 is off by over 1e-4 (checked below) and a dropped slot by
over 1e-3.
"""
import json
from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest
import torch

import plain_granite as pg
from repro_torch import tracing
from repro_torch.configs import ARCHS, PORT_ARCHS, get_arch, smoke_config
from repro_torch.kernels import moe_grouped_ffn as mgf
from repro_torch.launch import serve
from repro_torch.launch.serve import ServeEngine
from repro_torch.layers import moe_dropless as md
from repro_torch.layers.moe import init_moe
from repro_torch.models import hybrid_moe as hm
from repro_torch.models import registry

ATOL = 1e-6
ROOT = Path(__file__).resolve().parents[1]
ARCH = "granite-4.0-h-small"


@pytest.fixture(autouse=True)
def recorder_off():
    tracing.disable()
    tracing.take()
    tracing.take_counters()
    yield
    tracing.disable()
    tracing.take()
    tracing.take_counters()


def small_pub(layer_types=("mamba", "attention", "mamba")):
    """The published config.json keys (the benchmark's file) at smoke
    widths: GQA 4/2 heads of 32, 8 experts top-2, Mamba2 8 heads of 32."""
    pub = json.loads((ROOT / "scbench" / "configs" /
                      f"{ARCH}.json").read_text())
    return {**pub, "hidden_size": 128, "num_attention_heads": 4,
            "num_key_value_heads": 2, "head_dim": 32,
            "intermediate_size": 64, "shared_intermediate_size": 128,
            "vocab_size": 512, "num_local_experts": 8,
            "num_experts_per_tok": 2, "mamba_d_state": 16,
            "mamba_d_head": 32, "mamba_n_heads": 8,
            "num_hidden_layers": len(layer_types),
            "layer_types": list(layer_types)}


def model(seed, layer_types=("mamba", "attention", "mamba")):
    """(config, published keys, weights, the port's parameters): weights
    drawn by the plain reference from ``seed`` in the published layout,
    each router skewed so that routing is uneven (expert 0 draws most
    tokens), and loaded into the port by its own loader."""
    pub = small_pub(layer_types)
    weights = pg.init_weights(pub, torch.Generator().manual_seed(seed))
    for lw in weights["layers"]:
        lw["router"][:, 0] += 0.5 * lw["router"][:, 1:].abs().mean()
    cfg = hm.config_from_published(pub, arch_id=ARCH)
    return cfg, pub, weights, hm.from_published(cfg, weights)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_prefill_then_decode_matches_the_full_forward(seed):
    cfg, pub, weights, params = model(seed)
    rng = np.random.default_rng(seed)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (2, 14)))
    plen = 9
    logits, cache = registry.prefill(cfg, params, {"tokens": toks[:, :plen]},
                                     cache_dtype=torch.float32, cap=16)
    kinds = [type(c).__name__ for c in cache["layers"]]
    assert kinds == ["Mamba2Cache", "KVCache", "Mamba2Cache"]
    got = [logits[:, 0]]
    for pos in range(plen, toks.shape[1]):
        logits, cache = registry.decode_step(cfg, params, cache,
                                             toks[:, pos:pos + 1], pos)
        got.append(logits[:, 0])
    got = torch.stack(got, dim=1)                 # positions plen-1 .. S-1
    for b in range(2):
        want = pg.forward(weights, pub, toks[b])[plen - 1:]
        assert want.abs().max() > 1e-2
        torch.testing.assert_close(got[b], want, atol=ATOL, rtol=0)


def test_lower_precision_and_drops_fail_the_tolerance():
    cfg, pub, weights, _ = model(0)
    toks = torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab,
                                                             24))
    want = pg.forward(weights, pub, toks)
    bf16 = pg.forward(weights, pub, toks, dtype=torch.bfloat16)
    drops = pg.forward(weights, pub, toks, capacity_factor=1.25,
                       capacity_group=4)
    assert (bf16 - want).abs().max() > 100 * ATOL
    assert (drops - want).abs().max() > 1000 * ATOL


def test_reference_margins_are_the_routing_gaps():
    cfg, pub, w, _ = model(6)
    toks = torch.as_tensor(np.random.default_rng(6).integers(0, cfg.vocab,
                                                             10))
    margins = []
    logits = pg.forward(w, pub, toks, margins=margins)
    torch.testing.assert_close(logits, pg.forward(w, pub, toks))
    assert len(margins) == cfg.n_layers
    assert all(m.shape == (10,) and (m >= 0).all() for m in margins)
    # layer 0's by hand: the router over the first normed hidden state
    h = w["embed"][toks] * pub["embedding_multiplier"]
    x = pg.rms(h, w["layers"][0]["input_norm"], pub["rms_norm_eps"])
    h = h + pub["residual_multiplier"] * pg.mamba2(w["layers"][0], x, pub)
    x = pg.rms(h, w["layers"][0]["post_norm"], pub["rms_norm_eps"])
    top = torch.sort(x @ w["layers"][0]["router"], descending=True).values
    k = cfg.top_k
    torch.testing.assert_close(margins[0], top[:, k - 1] - top[:, k])


def _routed_moe(seed=0, d=32, f=16, e=8, k=3):
    """An MoE whose router sends every token to expert 2 and none to
    experts 5-7: a large weight of expert 2 (and a large negative one of
    5-7) on input channel 0, which every token below has positive."""
    g = torch.Generator().manual_seed(seed)
    p = init_moe(d, f, e, torch.float32, g, "cpu")
    with torch.no_grad():
        p.router[0, 2] = 50.0
        p.router[0, 5:] = -50.0
    x = torch.randn((3, 7, d), generator=g)
    x[..., 0] = x[..., 0].abs() + 1.0
    return p, x, k


def _loop_reference(p, x, k):
    lw = {"router": p.router, "gate": p.w_gate, "up": p.w_up,
          "down": p.w_down}
    cfg = {"num_experts_per_tok": k, "num_local_experts": p.router.shape[1]}
    return pg.moe(lw, x.reshape(-1, x.shape[-1]), cfg).reshape(x.shape)


def test_dropless_dispatch_matches_the_per_expert_loop():
    p, x, k = _routed_moe()
    from repro_torch.layers.moe import route
    _, _, idx = route(x.reshape(-1, x.shape[-1]), p.router, k)
    order, tok, offsets, counts = md.sort_slots(idx, 8)
    assert counts[2] == 21 and (counts[5:] == 0).all()
    assert counts.sum() == 21 * k and offsets[-1] == 21 * k
    assert torch.equal(idx.reshape(-1)[order].diff() >= 0,
                       torch.ones(21 * k - 1, dtype=torch.bool))
    assert torch.equal(tok.long(), order // k)
    got, routes = md.moe_ffn_dropless(p, x, top_k=k)
    torch.testing.assert_close(got, _loop_reference(p, x, k), atol=ATOL,
                               rtol=0)
    assert torch.equal(routes.reshape(-1, k), idx)


def test_prefill_chunks_give_the_same_result(monkeypatch):
    p, x, k = _routed_moe(seed=1)
    whole, routes = md.moe_ffn_dropless(p, x, top_k=k)
    monkeypatch.setattr(md, "PREFILL_CHUNK", 5)
    chunked, chunked_routes = md.moe_ffn_dropless(p, x, top_k=k)
    torch.testing.assert_close(chunked, whole, atol=ATOL, rtol=0)
    assert torch.equal(chunked_routes, routes)


def test_grouped_ffn_wrapper_takes_the_plain_version_on_the_cpu():
    p, x, k = _routed_moe(seed=2)
    xt = x.reshape(-1, x.shape[-1])
    from repro_torch.layers.moe import route
    _, _, idx = route(xt, p.router, k)
    _, tok, offsets, _ = md.sort_slots(idx, 8)
    args = (xt, tok, offsets, p.w_gate, p.w_up, p.w_down)
    assert torch.equal(mgf.moe_grouped_ffn(*args),
                       mgf.moe_grouped_ffn_plain(*args))


@pytest.mark.parametrize("n_slots, want", [
    (160, (16, 1, 8)), (4096, (16, 8, 8)), (20480, (1, 18, 16)),
    (81920, (1, 72, 16)), (1, (16, 1, 8))])
def test_grouped_ffn_plan(n_slots, want):
    assert mgf.plan(n_slots, 72, 4096) == want


def test_engine_serves_two_tenants_with_fused_egress():
    cfg, pub, weights, params = model(3)
    engine = ServeEngine(cfg, params, batch=2, cap=24, fused_egress=True,
                         n_hosts=2, device="cpu")
    rng = np.random.default_rng(3)
    for name in ("tenant-a", "tenant-b"):
        engine.add_tenant(name, host_id=0)
        for prompt in rng.integers(0, cfg.vocab, (2, 8)):
            engine.submit(name, prompt)
    for _ in range(5):
        res = engine.step(gen=12)
        assert all(r["fault"] == 0 for r in res.values())
    for t in engine.tenants.values():
        assert t.logits.shape == (2, 1, cfg.vocab_padded)
        for seq in range(2):
            out = t.out[seq]
            toks = out[:t.plen] + [int(t.first[seq])] + out[t.plen:-1]
            want = pg.forward(weights, pub, torch.tensor(toks))[-1]
            torch.testing.assert_close(t.logits[seq, 0], want, atol=ATOL,
                                       rtol=0)


def test_engine_records_spans_and_counters():
    cfg, _, _, params = model(4)
    engine = ServeEngine(cfg, params, batch=2, cap=16, n_hosts=1,
                         device="cpu")
    engine.add_tenant("t", host_id=0)
    for prompt in np.random.default_rng(4).integers(0, cfg.vocab, (2, 5)):
        engine.submit("t", prompt)
    engine.step(gen=8)                # prefill and the first decode
    tracing.enable()
    engine.step(gen=8)
    spans = tracing.take()
    counts = tracing.take_counters()
    names = [s.name for s in spans]
    assert names[0] == "serve.step" and names.count("serve.decode") == 1
    assert names.count("hybrid_moe.mamba") == 2
    assert names.count("hybrid_moe.attention") == 1
    assert names.count("moe.grouped_ffn") == 3
    # one decode of 2 tokens through 3 MoE layers at top-2 of 8
    assert counts["moe.slots"] == 3 * 2 * cfg.top_k
    assert 3 * cfg.top_k <= counts["moe.experts_hit"] <= 3 * 2 * cfg.top_k


def test_counters_only_leave_spans_off():
    tracing.enable(spans=False, counters=True)
    with tracing.span("x"):
        tracing.count("c", 2)
        tracing.count("c", torch.tensor(3))
    assert tracing.take() == [] and tracing.take_counters() == {"c": 5}
    assert tracing.take_counters() == {}


def test_archs_stay_the_references_and_granite_is_port_only():
    from repro.configs import ARCHS as REF_ARCHS
    assert list(ARCHS) == list(REF_ARCHS) and ARCH not in ARCHS
    assert list(PORT_ARCHS) == [ARCH] and get_arch(ARCH) is PORT_ARCHS[ARCH]
    assert get_arch("qwen3-4b") is ARCHS["qwen3-4b"]
    with pytest.raises(KeyError):
        get_arch("granite-4.0-h-tiny")


def test_granite_config_is_the_published_one():
    cfg = get_arch(ARCH)
    assert hm.layer_kinds(cfg).count("attention") == 4
    assert [i for i, k in enumerate(hm.layer_kinds(cfg))
            if k == "attention"] == [5, 15, 25, 35]
    pub = json.loads((ROOT / "scbench" / "configs" /
                      f"{ARCH}.json").read_text())
    bench = hm.config_from_published(pub, arch_id=ARCH)
    assert bench == replace(cfg, n_layers=10)
    assert hm.layer_kinds(bench) == ("mamba",) * 5 + ("attention",) + \
        ("mamba",) * 4


def test_serve_lists_the_port_only_archs(monkeypatch):
    seen = {}
    monkeypatch.setattr(serve, "run_demo",
                        lambda engine, **kw: seen.update(cfg=engine.cfg))
    serve.main(["--arch", ARCH, "--device", "cpu", "--batch", "2",
                "--prompt-len", "4", "--gen", "2"])
    assert seen["cfg"].family == "hybrid_moe"
    assert seen["cfg"].layer_types == ("mamba", "attention", "mamba",
                                       "mamba")


def test_norm_eps_default_is_unchanged():
    assert all(c.norm_eps == 1e-6 for c in ARCHS.values())
    assert get_arch(ARCH).norm_eps == 1e-5


def test_loss_fn_is_registered():
    cfg, pub, weights, params = model(5)
    toks = torch.as_tensor(np.random.default_rng(5).integers(0, cfg.vocab,
                                                             (2, 6)))
    loss, m = registry.loss_fn(cfg, params, {"tokens": toks,
                                             "labels": toks})
    want = torch.stack([torch.nn.functional.cross_entropy(
        pg.forward(weights, pub, t), t) for t in toks]).mean()
    assert loss.ndim == 0 and m["loss"] is loss
    torch.testing.assert_close(loss, want, atol=1e-5, rtol=0)
    shapes = registry.cache_shapes(cfg, 2, 16, torch.float32)["layers"]
    assert shapes[1].k.shape == (2, cfg.n_kv_heads, 16, cfg.head_dim)
    assert shapes[0].ssm.device.type == "meta"


def test_loader_shares_storage_and_converts_the_norms():
    """`from_published` takes every matrix as it is (no second copy of
    the weights on the card) and turns each norm weight into the port's
    scale ``w - 1``."""
    cfg, _, w, params = model(9)
    mamba, attn = params.layers[0], params.layers[1]
    for got, want in ((params.tok, w["embed"]),
                      (mamba.mixer.w_x, w["layers"][0]["in_x"]),
                      (attn.mixer.wq, w["layers"][1]["q"]),
                      (attn.moe.w_gate, w["layers"][1]["gate"]),
                      (attn.shared.w_down, w["layers"][1]["shared_down"])):
        assert got.data_ptr() == want.data_ptr()
    assert attn.mixer.wq.shape == (cfg.d_model, cfg.n_heads, cfg.head_dim)
    torch.testing.assert_close(1.0 + mamba.ln1, w["layers"][0]["input_norm"])
    torch.testing.assert_close(1.0 + mamba.mixer.norm_scale,
                               w["layers"][0]["gate_norm"])
    torch.testing.assert_close(1.0 + params.final_norm, w["final_norm"])
    with pytest.raises(ValueError, match="layers of weights"):
        hm.from_published(replace(cfg, n_layers=2, layer_types=(
            "mamba", "attention")), w)
