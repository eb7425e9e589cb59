"""Port parity: the flash kernel's plain version
(`repro_torch.kernels.flash_attention`) against the JAX package's Pallas
kernel in interpret mode, over the sweeps of tests/test_kernels_flash.py:
shapes (ragged included), GQA/MQA, non-causal, sliding window (held, as the
reference holds it, against `_sdpa` with `causal_mask`), bf16 at 3e-2 and
dh 128, f32 at 2e-5.  The wrapper on CPU tensors runs the plain version and
launches nothing."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention_pallas
from repro.layers.attention import _sdpa, causal_mask
from repro_torch.kernels import launches
from repro_torch.kernels import ref as tref
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain)

F32_TOL, BF16_TOL = 2e-5, 3e-2


def _qkv(rng, b, h, hkv, sq, sk, dh):
    return (rng.normal(size=(b, h, sq, dh)).astype(np.float32),
            rng.normal(size=(b, hkv, sk, dh)).astype(np.float32),
            rng.normal(size=(b, hkv, sk, dh)).astype(np.float32))


def _both(q, k, v, dtype, **kw):
    """(Pallas interpret, port plain) on the same numpy inputs."""
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    got_j = flash_attention_pallas(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                                   interpret=True, **kw)
    kw.pop("block_q", None)
    kw.pop("block_k", None)
    got_t = flash_attention_plain(
        *(torch.from_numpy(a).to(dtype) for a in (q, k, v)), **kw)
    return np.asarray(got_j, np.float32), got_t.float().numpy(), got_t


@pytest.mark.parametrize("sq,sk,bq,bk", [
    (128, 128, 128, 128), (256, 256, 128, 128), (256, 384, 128, 128),
    (200, 200, 128, 128), (256, 256, 64, 128)])
def test_plain_matches_pallas_shapes(sq, sk, bq, bk):
    q, k, v = _qkv(np.random.default_rng(sq + sk), 2, 4, 4, sq, sk, 64)
    want, got, _ = _both(q, k, v, torch.float32, causal=True, block_q=bq,
                         block_k=bk)
    np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("h,hkv", [(8, 2), (4, 1), (4, 4)])
def test_plain_matches_pallas_gqa(h, hkv):
    q, k, v = _qkv(np.random.default_rng(h * 10 + hkv), 1, h, hkv, 128, 128,
                   64)
    want, got, _ = _both(q, k, v, torch.float32, causal=True)
    np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)


def test_plain_matches_pallas_non_causal():
    q, k, v = _qkv(np.random.default_rng(1), 1, 2, 2, 128, 256, 64)
    want, got, _ = _both(q, k, v, torch.float32, causal=False)
    np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("w", [64, 160])
def test_plain_sliding_window_matches_sdpa_and_pallas(w):
    sq = 256
    q, k, v = _qkv(np.random.default_rng(w), 1, 2, 2, sq, sq, 64)
    want = _sdpa(*(jnp.asarray(a).transpose(0, 2, 1, 3) for a in (q, k, v)),
                 causal_mask(sq, sq, window=w)).transpose(0, 2, 1, 3)
    pallas, got, _ = _both(q, k, v, torch.float32, causal=True, window=w)
    np.testing.assert_allclose(got, np.asarray(want), rtol=F32_TOL,
                               atol=F32_TOL)
    np.testing.assert_allclose(got, pallas, rtol=F32_TOL, atol=F32_TOL)


def test_plain_bf16_and_dh128():
    q, k, v = _qkv(np.random.default_rng(2), 1, 2, 2, 128, 128, 64)
    want, got, t = _both(q, k, v, torch.bfloat16, causal=True)
    assert t.dtype == torch.bfloat16
    np.testing.assert_allclose(got, want, rtol=BF16_TOL, atol=BF16_TOL)
    q, k, v = _qkv(np.random.default_rng(3), 1, 2, 2, 128, 128, 128)
    want, got, _ = _both(q, k, v, torch.float32, causal=True)
    np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)


def test_decode_row_on_a_strided_cache_slice():
    """Sq = 1 against the first pos+1 keys of a cache: the wrapper takes the
    strided slice, and bottom-right alignment gives the reference decode's
    full-cap mask (ki <= pos, ki > pos - window)."""
    rng = np.random.default_rng(4)
    cap, pos, w = 48, 29, 10
    q = rng.normal(size=(2, 1, 4, 32)).astype(np.float32)   # [B,S,H,dh]
    kc = rng.normal(size=(2, 2, cap, 32)).astype(np.float32)
    vc = rng.normal(size=(2, 2, cap, 32)).astype(np.float32)
    ki = jnp.arange(cap)
    mask = ((ki <= pos) & (ki > pos - w))[None, None, None, :]
    want = _sdpa(jnp.asarray(q), jnp.asarray(kc).transpose(0, 2, 1, 3),
                 jnp.asarray(vc).transpose(0, 2, 1, 3), mask)
    before = dict(launches)
    tk, tv = torch.from_numpy(kc), torch.from_numpy(vc)
    got = flash_attention(torch.from_numpy(q).transpose(1, 2),
                          tk[:, :, :pos + 1], tv[:, :, :pos + 1],
                          causal=True, window=w).transpose(1, 2)
    assert launches == before, "the CPU path launches no kernel"
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_TOL,
                               atol=F32_TOL)


def test_oracle_matches_reference_oracle():
    q, k, v = _qkv(np.random.default_rng(5), 2, 8, 2, 40, 56, 16)
    for causal in (True, False):
        want = jref.flash_attention(*map(jnp.asarray, (q, k, v)),
                                    causal=causal)
        got = tref.flash_attention(*map(torch.from_numpy, (q, k, v)),
                                   causal=causal)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=F32_TOL, atol=F32_TOL)
        np.testing.assert_allclose(
            flash_attention_plain(*map(torch.from_numpy, (q, k, v)),
                                  causal=causal).numpy(),
            np.asarray(want), rtol=F32_TOL, atol=F32_TOL)


def test_rejects_causal_rows_without_keys():
    q, k, v = (torch.zeros(1, 2, 9, 16), torch.zeros(1, 2, 4, 16),
               torch.zeros(1, 2, 4, 16))
    with pytest.raises(ValueError, match="Sq <= Sk"):
        flash_attention(q, k, v, causal=True)
