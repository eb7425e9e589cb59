"""Port parity: the layers (`repro_torch.layers.common`, `.attention`)
against the JAX package on seeded numpy inputs, f32 at 2e-5 — rms_norm,
RoPE (partial rotary) and M-RoPE, `_sdpa` with GQA, `chunked_attention`
with an offset and a window, and the attention layer's three branches (no
cache, prefill, decode) with QKV bias, qk-norm and GQA."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.layers import attention as jattn
from repro.layers import common as jcommon
from repro_torch.layers import attention as tattn
from repro_torch.layers import common as tcommon

TOL = 2e-5


def close(port, ref):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref),
                               rtol=TOL, atol=TOL)


def test_rms_norm():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 48)).astype(np.float32) * 3
    scale = rng.normal(size=(48,)).astype(np.float32) * 0.1
    close(tcommon.rms_norm(torch.from_numpy(scale), torch.from_numpy(x)),
          jcommon.rms_norm(jnp.asarray(scale), jnp.asarray(x)))


@pytest.mark.parametrize("rotary_dim,theta", [(None, 10000.0),
                                              (16, 1e6)])
def test_apply_rope(rotary_dim, theta):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 7, 3, 32)).astype(np.float32)
    pos = rng.integers(0, 4000, (2, 7)).astype(np.int32)
    close(tcommon.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                             theta=theta, rotary_dim=rotary_dim),
          jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta=theta,
                             rotary_dim=rotary_dim))


def test_apply_mrope():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 6, 4, 32)).astype(np.float32)
    pos3 = rng.integers(0, 300, (3, 2, 6)).astype(np.int32)
    close(tcommon.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos3),
                              sections=(4, 6, 6)),
          jcommon.apply_mrope(jnp.asarray(x), jnp.asarray(pos3),
                              sections=(4, 6, 6)))


def test_swiglu_and_cross_entropy():
    rng = np.random.default_rng(3)
    p = {n: rng.normal(size=s).astype(np.float32) * 0.1 for n, s in
         (("w_gate", (16, 40)), ("w_up", (16, 40)), ("w_down", (40, 16)))}
    x = rng.normal(size=(3, 16)).astype(np.float32)
    tp = tcommon.SwiGLU(16, 40, torch.float32, None, "cpu")
    for n, a in p.items():
        setattr(tp, n, tcommon.param(torch.from_numpy(a)))
    close(tp(torch.from_numpy(x)),
          jcommon.swiglu({n: jnp.asarray(a) for n, a in p.items()},
                         jnp.asarray(x)))
    logits = rng.normal(size=(2, 5, 11)).astype(np.float32)
    labels = rng.integers(-1, 11, (2, 5)).astype(np.int32)
    close(tcommon.cross_entropy(torch.from_numpy(logits),
                                torch.from_numpy(labels)),
          jcommon.cross_entropy(jnp.asarray(logits), jnp.asarray(labels)))


def _qkv(rng, b, sq, sk, hq, hkv, dh):
    return (rng.normal(size=(b, sq, hq, dh)).astype(np.float32),
            rng.normal(size=(b, sk, hkv, dh)).astype(np.float32),
            rng.normal(size=(b, sk, hkv, dh)).astype(np.float32))


@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2), (4, 1)])
def test_sdpa_with_causal_mask(hq, hkv):
    q, k, v = _qkv(np.random.default_rng(hq + hkv), 2, 20, 20, hq, hkv, 16)
    close(tattn._sdpa(*map(torch.from_numpy, (q, k, v)),
                      tattn.causal_mask(20, 20, window=6)),
          jattn._sdpa(*map(jnp.asarray, (q, k, v)),
                      jattn.causal_mask(20, 20, window=6)))


@pytest.mark.parametrize("window,offset,chunk", [(-1, 0, 16), (8, 0, 16),
                                                 (-1, 56, 16), (12, 56, 24)])
def test_chunked_attention(window, offset, chunk):
    sq = 64 - offset
    q, k, v = _qkv(np.random.default_rng(100 + window + offset), 1, sq, 64,
                   8, 2, 16)
    close(tattn.chunked_attention(*map(torch.from_numpy, (q, k, v)),
                                  window=window, chunk=chunk, offset=offset),
          jattn.chunked_attention(*map(jnp.asarray, (q, k, v)),
                                  window=window, chunk=chunk, offset=offset))


def _layer_pair(rng, *, d=64, h=4, hkv=2, dh=16, bias=True, qk_norm=True):
    """A JAX attention param dict and the port's `Attention` holding the
    same (non-zero) numbers."""
    jp = jattn.init_attention(d, h, hkv, dh, jnp.float32, jax.random.key(0),
                              qkv_bias=bias, qk_norm=qk_norm)
    jp = {n: jnp.asarray(rng.normal(size=a.shape).astype(np.float32)
                         * (0.1 if a.ndim < 3 else 1.0 / np.sqrt(d)))
          for n, a in jp.items()}
    tp = tattn.init_attention(d, h, hkv, dh, torch.float32, None, "cpu",
                              qkv_bias=bias, qk_norm=qk_norm)
    for n, a in jp.items():
        setattr(tp, n, tcommon.param(torch.from_numpy(np.array(a))))
    return jp, tp


@pytest.mark.parametrize("window", [-1, 5])
def test_attention_three_branches(window):
    """No cache, prefill into a cache, then two decode steps: outputs and
    caches agree."""
    rng = np.random.default_rng(7)
    jp, tp = _layer_pair(rng)
    b, s, cap = 2, 12, 16
    x = rng.normal(size=(b, s, 64)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s))
    kw = dict(theta=10000.0, rotary_dim=8, window=window)
    jy, _ = jattn.attention(jp, jnp.asarray(x), jnp.asarray(pos), **kw)
    ty, none = tp(torch.from_numpy(x), torch.from_numpy(pos.copy()), **kw)
    assert none is None
    close(ty, jy)

    jc = jattn.init_kv_cache(b, 2, cap, 16, jnp.float32)
    tc = tattn.init_kv_cache(b, 2, cap, 16, torch.float32, "cpu")
    jy, jc = jattn.attention(jp, jnp.asarray(x), jnp.asarray(pos), cache=jc,
                             **kw)
    ty, tc = tp(torch.from_numpy(x), torch.from_numpy(pos.copy()), cache=tc,
                **kw)
    close(ty, jy)
    close(tc.k, jc.k)
    close(tc.v, jc.v)
    for p in (s, s + 1):
        xd = rng.normal(size=(b, 1, 64)).astype(np.float32)
        pd = np.full((b, 1), p, np.int32)
        jy, jc = jattn.attention(jp, jnp.asarray(xd), jnp.asarray(pd),
                                 cache=jc, cache_pos=p, **kw)
        ty, tc = tp(torch.from_numpy(xd), torch.from_numpy(pd), cache=tc,
                    cache_pos=p, **kw)
        close(ty, jy)
        close(tc.k, jc.k)


def test_relu_mlp():
    rng = np.random.default_rng(8)
    p = {n: rng.normal(size=s).astype(np.float32) for n, s in
         (("w_in", (12, 20)), ("b_in", (20,)), ("w_out", (20, 12)),
          ("b_out", (12,)))}
    x = rng.normal(size=(4, 12)).astype(np.float32)
    tp = torch.nn.Module()
    for n, a in p.items():
        setattr(tp, n, tcommon.param(torch.from_numpy(a)))
    close(tcommon.relu_mlp(tp, torch.from_numpy(x)),
          jcommon.relu_mlp({n: jnp.asarray(a) for n, a in p.items()},
                           jnp.asarray(x)))
