"""Port parity: the Mamba1 and Mamba2 blocks (`repro_torch.layers.mamba`)
against the JAX package's `repro.layers.mamba` on the same weights: a
prompt from an empty state, then single teacher-forced steps from the
returned cache, f32 at 2e-5.  The outputs and every cache field (the conv
histories and the f32 SSM state) are compared after the prompt and after
each step; so is the port's causal conv, and a prompt run in one call
against the same prompt run in two halves."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.layers import mamba as jm
from repro_torch.layers import mamba as tm
from repro_torch.layers.common import param

TOL = 2e-5
D = 32


def _load(jp, module):
    for name, arr in jp.items():
        setattr(module, name, param(torch.from_numpy(np.array(arr))))
    return module


def _mamba1(seed):
    jp = jax.tree.map(np.asarray, jm.init_mamba1(
        D, d_state=8, expand=2, conv_w=4, key=jax.random.key(seed)))
    return jp, _load(jp, tm.init_mamba1(D, d_state=8, device="meta"))


def _mamba2(seed, n_groups):
    jp = jax.tree.map(np.asarray, jm.init_mamba2(
        D, d_state=16, expand=2, head_dim=16, n_groups=n_groups,
        key=jax.random.key(seed)))
    # non-trivial decays and norm scales (the reference zero-inits them)
    rng = np.random.default_rng(seed)
    jp["a_log"] = rng.normal(size=jp["a_log"].shape).astype(np.float32)
    jp["norm_scale"] = 0.1 * rng.normal(size=jp["norm_scale"].shape) \
        .astype(np.float32)
    return jp, _load(jp, tm.init_mamba2(D, d_state=16, head_dim=16,
                                        n_groups=n_groups, device="meta"))


def close(port, ref):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref),
                               rtol=TOL, atol=TOL)


def close_cache(port, ref):
    assert type(port).__name__ == type(ref).__name__
    for f in ref._fields:
        close(getattr(port, f), getattr(ref, f))
    assert port.ssm.dtype == torch.float32


def _run(jfn, tfn, jp, p, seed, b=2, s=11, steps=4):
    x = np.random.default_rng(seed).normal(size=(b, s + steps, D)) \
        .astype(np.float32)
    jy, jc = jfn(jp, jnp.asarray(x[:, :s]), None)
    ty, tc = tfn(p, torch.from_numpy(x[:, :s]), None)
    close(ty, jy)
    close_cache(tc, jc)
    for t in range(s, s + steps):              # teacher-forced steps
        jy, jc = jfn(jp, jnp.asarray(x[:, t:t + 1]), jc)
        ty, tc = tfn(p, torch.from_numpy(x[:, t:t + 1]), tc)
        close(ty, jy)
        close_cache(tc, jc)
    return x, ty, tc


@pytest.mark.parametrize("seed", [0, 1])
def test_mamba1_prompt_then_steps(seed):
    jp, p = _mamba1(seed)
    _run(jm.mamba1, tm.mamba1, jp, p, seed + 10)


@pytest.mark.parametrize("n_groups", [1, 2])
def test_mamba2_prompt_then_steps(n_groups):
    jp, p = _mamba2(3, n_groups)
    _run(lambda q, x, c: jm.mamba2(q, x, c, head_dim=16, n_groups=n_groups),
         lambda q, x, c: tm.mamba2(q, x, c, head_dim=16, n_groups=n_groups),
         jp, p, 20 + n_groups)


def test_a_prompt_in_two_halves_equals_one_call():
    """The cache carries everything: the prompt split at any point gives
    the same outputs and final state."""
    jp, p = _mamba2(4, 1)
    x = torch.from_numpy(np.random.default_rng(5).normal(size=(2, 12, D))
                         .astype(np.float32))
    y, c = tm.mamba2(p, x, None, head_dim=16)
    y1, c1 = tm.mamba2(p, x[:, :5], None, head_dim=16)
    y2, c2 = tm.mamba2(p, x[:, 5:], c1, head_dim=16)
    torch.testing.assert_close(torch.cat([y1, y2], 1), y, rtol=TOL,
                               atol=TOL)
    for f in c._fields:
        torch.testing.assert_close(getattr(c2, f), getattr(c, f), rtol=TOL,
                                   atol=TOL)


def test_causal_conv_matches_reference():
    rng = np.random.default_rng(6)
    w, b = rng.normal(size=(4, 10)), rng.normal(size=10)
    x, st = rng.normal(size=(2, 7, 10)), rng.normal(size=(2, 3, 10))
    jy, js = jm._causal_conv(*(jnp.asarray(a, jnp.float32)
                               for a in (w, b, x, st)))
    ty, ts = tm._causal_conv(*(torch.from_numpy(a.astype(np.float32))
                               for a in (w, b, x, st)))
    close(ty, jy)
    close(ts, js)
