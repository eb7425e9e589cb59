"""Port parity: the dense decoder LM (`repro_torch.models.lm` through
`registry`) against the JAX package at smoke widths, with the reference's
parameters carried across by `convert.lm_params_from_numpy` — prefill
logits and KV cache, then teacher-forced decode steps, and the training
forward, f32 at 2e-5.  qwen1.5 has QKV bias and MHA; qwen3 qk-norm and
GQA; gemma3 a sliding window with its 5:1 local/global schedule (6
layers, so one global layer), MQA and the embedding scale; qwen2-vl
M-RoPE."""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs import smoke_config as jsmoke
from repro.models import lm as jlm
from repro.models import registry as jreg
from repro_torch import convert
from repro_torch.configs import ARCHS, smoke_config
from repro_torch.models import lm, registry

TOL = 2e-5
CASES = {"qwen1.5-0.5b": 2, "qwen3-4b": 2, "gemma3-1b": 6,
         "qwen2-vl-7b": 2}


def _configs(arch):
    n = CASES[arch]
    return (replace(jsmoke(JARCHS[arch]), n_layers=n),
            replace(smoke_config(ARCHS[arch]), n_layers=n))


def close(port, ref):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("arch", sorted(CASES))
def test_prefill_and_decode_match(arch):
    jcfg, cfg = _configs(arch)
    jp = jreg.init_params(jcfg, jax.random.key(1))
    params = convert.lm_params_from_numpy(cfg, jax.tree.map(np.asarray, jp),
                                          device="cpu")
    rng = np.random.default_rng(len(arch))
    b, s, cap = 2, 24, 28                  # prompt beyond gemma3's window 16
    toks = rng.integers(3, cfg.vocab - 1, (b, s)).astype(np.int32)
    jl, jc = jreg.prefill(jcfg, jp, {"tokens": jnp.asarray(toks)},
                          cache_dtype=jnp.float32, cap=cap)
    tl, tc = registry.prefill(cfg, params,
                              {"tokens": torch.from_numpy(toks)},
                              cache_dtype=torch.float32, cap=cap)
    close(tl, jl)
    kv = convert.kv_cache_to_numpy(tc)
    close(torch.from_numpy(kv["k"]), jc.k)
    close(torch.from_numpy(kv["v"]), jc.v)
    for pos in range(s, s + 3):             # teacher-forced decode steps
        nxt = rng.integers(3, cfg.vocab - 1, (b, 1)).astype(np.int32)
        jl, jc = jreg.decode_step(jcfg, jp, jc, jnp.asarray(nxt), pos)
        tl, tc = registry.decode_step(cfg, params, tc, torch.from_numpy(nxt),
                                      pos)
        close(tl, jl)


@pytest.mark.parametrize("arch", ["qwen3-4b", "gemma3-1b"])
def test_forward_and_cache_round_trip(arch):
    jcfg, cfg = _configs(arch)
    jp = jreg.init_params(jcfg, jax.random.key(2))
    params = convert.lm_params_from_numpy(cfg, jax.tree.map(np.asarray, jp),
                                          device="cpu")
    toks = np.random.default_rng(3).integers(3, cfg.vocab - 1, (2, 20)) \
        .astype(np.int32)
    jl, _ = jlm.forward(jcfg, jp, jnp.asarray(toks))
    tl, aux = lm.forward(cfg, params, torch.from_numpy(toks))
    close(tl, jl)
    assert float(aux) == 0.0
    # a reference cache crosses over and back unchanged
    _, jc = jreg.prefill(jcfg, jp, {"tokens": jnp.asarray(toks)},
                         cache_dtype=jnp.float32, cap=24)
    back = convert.kv_cache_to_numpy(convert.kv_cache_from_numpy(
        jc, device="cpu"))
    np.testing.assert_array_equal(back["k"], np.asarray(jc.k))
    np.testing.assert_array_equal(back["v"], np.asarray(jc.v))


def test_layer_schedule_and_cache_shapes():
    jcfg, cfg = _configs("gemma3-1b")
    jw, jt = jlm.layer_schedule(jcfg, 12)
    tw, tt = lm.layer_schedule(cfg, 12)
    assert tw == np.asarray(jw).tolist()
    assert tt == np.asarray(jt).tolist()
    shapes = registry.cache_shapes(cfg, 3, 40)
    jshapes = jreg.cache_shapes(jcfg, 3, 40)
    assert len(shapes) == cfg.n_layers
    assert all(c.k.device.type == "meta" for c in shapes)
    assert (cfg.n_layers, *shapes[0].k.shape) == jshapes.k.shape


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "falcon-mamba-7b",
                                  "zamba2-1.2b", "seamless-m4t-medium"])
def test_unported_families_name_their_slice(arch):
    cfg = smoke_config(ARCHS[arch])
    item = "c" if arch == "olmoe-1b-7b" else "e"
    with pytest.raises(NotImplementedError, match=f"Queue 1 item {item}\\)"):
        registry.init_params(cfg, torch.Generator(), "cpu")


def test_bf16_parameters_cross_exactly():
    """JAX's bf16 numpy arrays (no torch dtype of their own) cross as
    their bits: every parameter arrives as the same bf16 value."""
    jcfg = replace(jsmoke(JARCHS["qwen3-4b"]), n_layers=2,
                   param_dtype="bfloat16")
    cfg = replace(smoke_config(ARCHS["qwen3-4b"]), n_layers=2,
                  param_dtype="bfloat16")
    tree = jax.tree.map(np.asarray, jreg.init_params(jcfg,
                                                     jax.random.key(4)))
    params = convert.lm_params_from_numpy(cfg, tree, device="cpu")
    assert params.tok.dtype == torch.bfloat16
    np.testing.assert_array_equal(params.tok.float().numpy(),
                                  tree["embed"]["tok"].astype(np.float32))
    np.testing.assert_array_equal(
        params.layers[1].attn.wq.float().numpy(),
        tree["units"]["attn"]["wq"][1].astype(np.float32))
