"""Port parity: AdamW (`repro_torch.optim`) against ``repro.optim`` on the
same trees — `apply_updates` with f32 and bf16 moments, the cosine
schedule, `global_norm`, `clip_by_global_norm` — plus the reference's
``tests/test_optim.py`` properties (convergence, bf16 moments, int8 error
bound, unbiased stochastic rounding, compression ratio), which run here
without hypothesis.  f32 parity at 1e-6 (relative, with a 1e-6 floor): the
same arithmetic in the same order, pow and sqrt may differ in the last
bit."""
from collections import OrderedDict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as jopt
from repro_torch import optim

TOL = 1e-6
SHAPES = {"embed.tok": (64, 16), "layers.0.attn.wq": (16, 4, 4),
          "layers.0.ln1": (16,), "final_norm": (16,)}


def _trees(seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return OrderedDict((k, rng.normal(size=s).astype(dtype))
                       for k, s in SHAPES.items())


def _t(tree, dtype=torch.float32):
    return OrderedDict((k, torch.from_numpy(np.array(v)).to(dtype))
                       for k, v in tree.items())


def _j(tree, dtype=jnp.float32):
    return {k: jnp.asarray(v, dtype) for k, v in tree.items()}


def close(port, ref, tol=TOL):
    np.testing.assert_allclose(
        np.asarray(torch.as_tensor(port).to(torch.float32)),
        np.asarray(ref, np.float32), rtol=tol, atol=tol)


@pytest.mark.parametrize("mdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("pdt", ["float32", "bfloat16"])
def test_apply_updates_matches_reference(pdt, mdt):
    tdt, jdt = getattr(torch, pdt), getattr(jnp, pdt)
    tm, jm = getattr(torch, mdt), getattr(jnp, mdt)
    p0, steps = _trees(0), 4
    params, jparams = _t(p0, tdt), _j(p0, jdt)
    state = optim.init_state(params, moment_dtype=tm)
    jstate = jopt.init_state(jparams, moment_dtype=jm)
    for step in range(steps):
        g = _trees(10 + step)
        lr = float(jopt.cosine_schedule(jnp.asarray(step), peak_lr=1e-2,
                                        warmup=2, total=10))
        params, state = optim.apply_updates(params, _t(g, tdt), state, lr=lr)
        jparams, jstate = jopt.apply_updates(jparams, _j(g, jdt), jstate,
                                             lr=lr)
    assert int(state.step) == int(jstate.step) == steps
    # bf16 parameters round each step: one bf16 ulp (2^-7 relative) where
    # the f32 math differs in its last bit
    tol = TOL if pdt == "float32" else 2 ** -7
    for k in SHAPES:
        assert params[k].dtype == tdt and state.mu[k].dtype == tm
        close(params[k], np.asarray(jparams[k], np.float32), tol)
        close(state.mu[k], np.asarray(jstate.mu[k], np.float32), tol)
        close(state.nu[k], np.asarray(jstate.nu[k], np.float32), tol)


def test_apply_updates_bf16_moments_exact_where_reference_rounds():
    """With f32 parameters and bf16 moments the moments round to bf16
    after the same f32 math: they agree to the bit on most entries."""
    p0 = _trees(1)
    params, jparams = _t(p0), _j(p0)
    state = optim.init_state(params, moment_dtype=torch.bfloat16)
    jstate = jopt.init_state(jparams, moment_dtype=jnp.bfloat16)
    g = _trees(2)
    params, state = optim.apply_updates(params, _t(g), state, lr=1e-3)
    jparams, jstate = jopt.apply_updates(jparams, _j(g), jstate, lr=1e-3)
    for k in SHAPES:
        same = (state.mu[k].to(torch.float32).numpy()
                == np.asarray(jstate.mu[k], np.float32)).mean()
        assert same > 0.99
        close(params[k], jparams[k])


def test_cosine_schedule_matches_reference():
    for step in [0, 1, 50, 99, 100, 101, 550, 999, 1000, 5000]:
        kw = dict(peak_lr=3e-4, warmup=100, total=1000)
        port = optim.cosine_schedule(torch.tensor(step, dtype=torch.int32),
                                     **kw)
        ref = jopt.cosine_schedule(jnp.asarray(step, jnp.int32), **kw)
        assert port.dtype == torch.float32
        close(port, ref)
    assert float(optim.cosine_schedule(torch.tensor(0), peak_lr=1.0,
                                       warmup=0, total=10)) == 1.0


def test_global_norm_and_clip_match_reference():
    g = _trees(3)
    close(optim.global_norm(_t(g)), jopt.global_norm(_j(g)))
    for max_norm in (0.5, 1e6):
        port, gn = optim.clip_by_global_norm(_t(g), max_norm)
        ref, jgn = jopt.clip_by_global_norm(_j(g), max_norm)
        close(gn, jgn)
        for k in SHAPES:
            close(port[k], ref[k])
    # a bf16 leaf is scaled in f32 and cast back to bf16, as the reference
    port, _ = optim.clip_by_global_norm(_t(g, torch.bfloat16), 0.5)
    ref, _ = jopt.clip_by_global_norm(_j(g, jnp.bfloat16), 0.5)
    for k in SHAPES:
        assert port[k].dtype == torch.bfloat16
        close(port[k], np.asarray(ref[k], np.float32), 2 ** -7)


def test_clip_by_global_norm_properties():
    g = OrderedDict(a=torch.full((4,), 10.0), b=torch.full((9,), 10.0))
    clipped, gn = optim.clip_by_global_norm(g, 1.0)
    assert float(gn) == pytest.approx(np.sqrt(13 * 100.0), rel=1e-5)
    assert float(optim.global_norm(clipped)) == pytest.approx(1.0, rel=1e-4)
    c2, _ = optim.clip_by_global_norm(OrderedDict(a=torch.tensor([0.1])),
                                      1.0)
    np.testing.assert_allclose(c2["a"].numpy(), [0.1], rtol=1e-6)


def test_adamw_converges_on_quadratic():
    params = OrderedDict(w=torch.tensor([5.0, -3.0]), b=torch.tensor([2.0]))
    target = OrderedDict(w=torch.tensor([1.0, 1.0]), b=torch.tensor([0.0]))
    state = optim.init_state(params)
    for _ in range(400):
        g = OrderedDict((k, 2 * (params[k] - target[k])) for k in params)
        params, state = optim.apply_updates(params, g, state, lr=0.05,
                                            weight_decay=0.0)
    loss = sum(float(((params[k] - target[k]) ** 2).sum()) for k in params)
    assert loss < 1e-3


def test_adamw_bf16_moments():
    params = OrderedDict(w=torch.ones(8, dtype=torch.bfloat16))
    before = params["w"].clone()
    state = optim.init_state(params, moment_dtype=torch.bfloat16)
    assert state.mu["w"].dtype == torch.bfloat16
    g = OrderedDict(w=torch.full((8,), 0.1, dtype=torch.bfloat16))
    params, state = optim.apply_updates(params, g, state, lr=1e-2)
    assert state.mu["w"].dtype == params["w"].dtype == torch.bfloat16
    assert not torch.equal(params["w"], before)


def test_init_state_of_a_module_is_keyed_by_parameter_names():
    m = torch.nn.Sequential(torch.nn.Linear(3, 2), torch.nn.Linear(2, 1))
    state = optim.init_state(m, moment_dtype=torch.bfloat16)
    names = [n for n, _ in m.named_parameters()]
    assert list(state.mu) == list(state.nu) == names
    assert all(state.mu[n].shape == p.shape and not state.mu[n].any()
               for n, p in m.named_parameters())
    assert state.step.dtype == torch.int32 and int(state.step) == 0


# ---------------------------------------------------------------------------
# int8 gradient compression
# ---------------------------------------------------------------------------

def test_int8_roundtrip_error_bound():
    g = OrderedDict(w=torch.from_numpy(
        np.random.default_rng(0).normal(size=(1024,)).astype(np.float32)))
    q, s = optim.compress_int8(g, torch.Generator().manual_seed(0))
    assert q["w"].dtype == torch.int8
    back = optim.decompress_int8(q, s)
    err = (back["w"] - g["w"]).abs()
    assert float(err.max()) <= float(s["w"]) * 1.0 + 1e-7
    # the scale is the reference's: max |g| / 127
    _, js = jopt.compress_int8({"w": jnp.asarray(g["w"].numpy())},
                               jax.random.key(0))
    close(s["w"], js["w"])


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 2 ** 31 - 1])
def test_int8_stochastic_rounding_unbiased(seed):
    """E[decompress(compress(g))] == g: mean error over many draws ~ 0."""
    g = OrderedDict(w=torch.full((256,), 0.31416))
    gen = torch.Generator().manual_seed(seed)
    outs = []
    for _ in range(24):
        q, s = optim.compress_int8(g, gen)
        outs.append(optim.decompress_int8(q, s)["w"].numpy())
    assert abs(np.stack(outs).mean() - 0.31416) < float(s["w"]) * 0.2


def test_int8_compression_ratio():
    g = OrderedDict(w=torch.zeros(4096))
    q, s = optim.compress_int8(g, torch.Generator().manual_seed(0))
    assert q["w"].numel() * q["w"].element_size() * 4 == \
        g["w"].numel() * g["w"].element_size()
    assert optim.decompress_int8(q, s, torch.bfloat16)["w"].dtype == \
        torch.bfloat16
