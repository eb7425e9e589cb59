"""Port parity: every model family (`repro_torch.models` through
`registry`) against the JAX package at smoke widths, with the reference's
parameters carried across by `convert.params_from_numpy` — prefill logits
and serving cache, then teacher-forced decode steps, and the training
forward, f32 at 2e-5.  qwen1.5 has QKV bias and MHA; qwen3 qk-norm and
GQA; gemma3 a sliding window with its 5:1 local/global schedule (6
layers, so one global layer), MQA and the embedding scale; qwen2-vl
M-RoPE; olmoe MoE in every layer through the sorted dispatch, with the
default capacity (binding at decode); llama4 dense+MoE pairs with a
shared expert; falcon-mamba Mamba1 blocks; zamba2 two groups of Mamba2
blocks around the shared attention block plus a tail block; seamless the
encoder over frames and the decoder's self and cross attention."""
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
         "qwen2-vl-7b": 2, "olmoe-1b-7b": 2,
         "llama4-maverick-400b-a17b": 4, "falcon-mamba-7b": 2,
         "zamba2-1.2b": 5, "seamless-m4t-medium": 2}


def _configs(arch):
    n = CASES[arch]
    return (replace(jsmoke(JARCHS[arch]), n_layers=n),
            replace(smoke_config(ARCHS[arch]), n_layers=n))


def _model(arch, seed):
    jcfg, cfg = _configs(arch)
    jp = jreg.init_params(jcfg, jax.random.key(seed))
    params = convert.params_from_numpy(cfg, jax.tree.map(np.asarray, jp),
                                       device="cpu")
    return jcfg, cfg, jp, params


def close(port, ref):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref),
                               rtol=TOL, atol=TOL)


def _ref_tree(cache):
    """A reference cache as nested dicts of numpy arrays (NamedTuples by
    field), the layout `convert.cache_to_numpy` gives the port's; shape
    tuples stay as they are."""
    if hasattr(cache, "_fields"):
        return {f: _ref_tree(getattr(cache, f)) for f in cache._fields}
    if isinstance(cache, dict):
        return {k: _ref_tree(v) for k, v in cache.items()}
    if isinstance(cache, tuple):
        return cache
    return np.asarray(cache, np.float32)


def close_trees(port: dict, ref: dict, exact: bool = False):
    assert port.keys() == ref.keys()
    for k in ref:
        if isinstance(ref[k], dict):
            close_trees(port[k], ref[k], exact)
        elif exact:
            np.testing.assert_array_equal(port[k], ref[k])
        else:
            assert port[k].shape == ref[k].shape, k
            close(port[k], ref[k])


def _frames(cfg, rng, b):
    return rng.normal(size=(b, 8, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("arch", sorted(CASES))
def test_prefill_and_decode_match(arch):
    jcfg, cfg, jp, params = _model(arch, 1)
    rng = np.random.default_rng(len(arch))
    b, s, cap = 2, 24, 28                  # prompt beyond gemma3's window 16
    toks = rng.integers(3, cfg.vocab - 1, (b, s)).astype(np.int32)
    jbatch, tbatch = {"tokens": jnp.asarray(toks)}, \
        {"tokens": torch.from_numpy(toks)}
    if cfg.family == "encdec":
        frames = _frames(cfg, rng, b)
        jbatch["frames"] = jnp.asarray(frames)
        tbatch["frames"] = torch.from_numpy(frames)
    jl, jc = jreg.prefill(jcfg, jp, jbatch, cache_dtype=jnp.float32, cap=cap)
    tl, tc = registry.prefill(cfg, params, tbatch,
                              cache_dtype=torch.float32, cap=cap)
    close(tl, jl)
    close_trees(convert.cache_to_numpy(tc), _ref_tree(jc))
    for pos in range(s, s + 3):             # teacher-forced decode steps
        nxt = rng.integers(3, cfg.vocab - 1, (b, 1)).astype(np.int32)
        jl, jc = jreg.decode_step(jcfg, jp, jc, jnp.asarray(nxt), pos)
        tl, tc = registry.decode_step(cfg, params, tc, torch.from_numpy(nxt),
                                      pos)
        close(tl, jl)
    close_trees(convert.cache_to_numpy(tc), _ref_tree(jc))


@pytest.mark.parametrize("arch", ["qwen3-4b", "gemma3-1b"])
def test_forward_and_cache_round_trip(arch):
    jcfg, cfg, jp, params = _model(arch, 2)
    toks = np.random.default_rng(3).integers(3, cfg.vocab - 1, (2, 20)) \
        .astype(np.int32)
    jl, _ = jlm.forward(jcfg, jp, jnp.asarray(toks))
    tl, aux = lm.forward(cfg, params, torch.from_numpy(toks))
    close(tl, jl)
    assert float(aux) == 0.0
    # a reference cache crosses over and back unchanged
    _, jc = jreg.prefill(jcfg, jp, {"tokens": jnp.asarray(toks)},
                         cache_dtype=jnp.float32, cap=24)
    back = convert.cache_to_numpy(convert.cache_from_numpy(
        cfg, jax.tree.map(np.asarray, jc), device="cpu"))
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


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "llama4-maverick-400b-a17b",
                                  "falcon-mamba-7b", "zamba2-1.2b",
                                  "seamless-m4t-medium"])
def test_training_forward_matches(arch):
    """The no-cache forward (logits and, for MoE, the summed aux loss)."""
    jcfg, cfg, jp, params = _model(arch, 6)
    rng = np.random.default_rng(7)
    toks = rng.integers(3, cfg.vocab - 1, (2, 20)).astype(np.int32)
    jkw, tkw = {}, {}
    if cfg.family == "encdec":
        frames = _frames(cfg, rng, 2)
        jkw["frames"], tkw["frames"] = jnp.asarray(frames), \
            torch.from_numpy(frames)
    jl, jaux = jreg.model_module(jcfg).forward(jcfg, jp, jnp.asarray(toks),
                                               **jkw)
    tl, taux = registry.model_module(cfg).forward(
        cfg, params, torch.from_numpy(toks), **tkw)
    close(tl, jl)
    close(taux, jaux)
    if cfg.family == "moe":
        assert float(taux) > 0


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "llama4-maverick-400b-a17b",
                                  "falcon-mamba-7b", "zamba2-1.2b",
                                  "seamless-m4t-medium"])
def test_reference_cache_crosses_and_decodes(arch):
    """A reference prefill cache crosses into the port
    (`convert.cache_from_numpy`) and back unchanged, and the port decodes
    from it as the reference does."""
    jcfg, cfg, jp, params = _model(arch, 8)
    rng = np.random.default_rng(9)
    toks = rng.integers(3, cfg.vocab - 1, (2, 10)).astype(np.int32)
    batch = {"tokens": jnp.asarray(toks)}
    if cfg.family == "encdec":
        batch["frames"] = jnp.asarray(_frames(cfg, rng, 2))
    _, jc = jreg.prefill(jcfg, jp, batch, cache_dtype=jnp.float32, cap=12)
    tc = convert.cache_from_numpy(cfg, jax.tree.map(np.asarray, jc),
                                  device="cpu")
    close_trees(convert.cache_to_numpy(tc), _ref_tree(jc), exact=True)
    nxt = rng.integers(3, cfg.vocab - 1, (2, 1)).astype(np.int32)
    jl, _ = jreg.decode_step(jcfg, jp, jc, jnp.asarray(nxt), 10)
    tl, _ = registry.decode_step(cfg, params, tc, torch.from_numpy(nxt), 10)
    close(tl, jl)


def test_every_family_has_its_module_and_cache_shapes():
    """`registry.model_module` takes every config; `cache_shapes` gives the
    reference's shapes on the meta device (encdec's cross cache at
    cap // frames_ratio frames, the ssm cache without capacity)."""
    for arch in ARCHS:
        jcfg, cfg = jsmoke(JARCHS[arch]), smoke_config(ARCHS[arch])
        mod = registry.model_module(cfg)
        assert mod.__name__.rsplit(".", 1)[1] == \
            jreg.model_module(jcfg).__name__.rsplit(".", 1)[1]
        port = convert.cache_to_numpy(_on_cpu(
            registry.cache_shapes(cfg, 2, 40, torch.float32)))
        ref = jax.tree.map(lambda x: x.shape,
                           jreg.cache_shapes(jcfg, 2, 40, jnp.float32))
        assert jax.tree.map(np.shape, port) == \
            jax.tree.map(tuple, _ref_tree(ref), is_leaf=lambda x:
                         isinstance(x, tuple))


def _on_cpu(cache):
    """A meta-device cache as CPU zeros of the same structure."""
    if isinstance(cache, torch.Tensor):
        assert cache.device.type == "meta"
        return torch.zeros(cache.shape, dtype=cache.dtype)
    if hasattr(cache, "_fields"):
        return type(cache)(*(_on_cpu(c) for c in cache))
    if isinstance(cache, dict):
        return {k: _on_cpu(v) for k, v in cache.items()}
    return [_on_cpu(c) for c in cache]


def test_encdec_needs_frames():
    """The reference's prefill crashes on a missing ``frames``
    (`encode(cfg, params, None)`); the port names what is missing."""
    _, cfg, _, params = _model("seamless-m4t-medium", 10)
    toks = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="frames"):
        registry.prefill(cfg, params, {"tokens": toks},
                         cache_dtype=torch.float32, cap=8)


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
