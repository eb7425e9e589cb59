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
from repro_torch.kernels.flash_attention import (
    MIN_SPLIT_KEYS, SplitPlan, _check_aligned, decode_rows_per_block,
    flash_attention, flash_attention_plain, flash_attention_split_plain,
    split_plan)

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


# -- the decode path's split plan and its split + combine arithmetic --------

SERVE_DECODE = (4, 32, 8, 1, 1056, 128)   # qwen3-4b, batch 4, 1056 keys
H100_SMS = 132


@pytest.mark.parametrize("b,h,hkv,sq,sk,dh,causal,window", [
    SERVE_DECODE + (True, -1), SERVE_DECODE + (True, 128),
    (1, 4, 1, 16, 3190, 128, True, -1), (2, 8, 2, 9, 40, 64, True, 8),
    (1, 2, 2, 1, 1, 32, True, -1), (3, 4, 4, 5, 700, 256, False, 300),
    (1, 32, 1, 16, 5000, 32, True, 2000)])
def test_split_plan_covers_the_visible_keys(b, h, hkv, sq, sk, dh, causal,
                                            window):
    plan = split_plan(b, h, hkv, sq, sk, dh, causal=causal, window=window,
                      sms=H100_SMS)
    off = sk - sq
    assert plan.k_end == sk
    assert plan.k_begin == (max(0, off - window + 1) if window > 0 else 0)
    bounds = [(plan.k_begin + s * plan.chunk,
               min(plan.k_end, plan.k_begin + (s + 1) * plan.chunk))
              for s in range(plan.splits)]
    # back to back, no gap, no overlap, no empty split, nothing past k_end
    assert bounds[0][0] == plan.k_begin and bounds[-1][1] == plan.k_end
    assert all(a[1] == c[0] for a, c in zip(bounds, bounds[1:]))
    assert all(lo < hi for lo, hi in bounds)
    n = plan.k_end - plan.k_begin
    assert plan.chunk >= min(n, MIN_SPLIT_KEYS)
    rows = h // hkv * sq
    assert plan.row_groups == -(-rows // decode_rows_per_block(dh, rows))


def test_split_plan_window_gives_fewer_splits():
    full = split_plan(*SERVE_DECODE, causal=True, window=-1, sms=H100_SMS)
    windowed = split_plan(*SERVE_DECODE, causal=True, window=128,
                          sms=H100_SMS)
    assert windowed.splits < full.splits
    assert windowed.k_end - windowed.k_begin == 128


def test_split_plan_fills_the_card_at_the_serving_shape():
    b, h, hkv = SERVE_DECODE[:3]
    plan = split_plan(*SERVE_DECODE, causal=True, window=-1, sms=H100_SMS)
    assert plan.row_groups == 1        # the 4 query heads share one block
    assert b * hkv * plan.splits >= 2 * H100_SMS


def _split_pallas(case, plan_of):
    b, h, hkv, sq, sk, dh, window = case
    q, k, v = _qkv(np.random.default_rng(sq * 131 + sk), b, h, hkv, sq, sk,
                   dh)
    want = np.asarray(flash_attention_pallas(
        *map(jnp.asarray, (q, k, v)), causal=True, window=window,
        interpret=True), np.float32)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    plan = plan_of(b, h, hkv, sq, sk, dh, window)
    got = flash_attention_split_plain(tq, tk, tv, causal=True, window=window,
                                      plan=plan)
    np.testing.assert_allclose(got.numpy(), want, rtol=F32_TOL, atol=F32_TOL)
    return plan


def _forced(chunk, from_zero):
    """A plan with chunk ``chunk``, over the visible keys or from key 0
    (then every split before the window is fully masked for every row)."""
    def plan_of(b, h, hkv, sq, sk, dh, window):
        vis = split_plan(b, h, hkv, sq, sk, dh, causal=True, window=window,
                         sms=H100_SMS)
        lo = 0 if from_zero else vis.k_begin
        n = vis.k_end - lo
        return SplitPlan(-(-n // chunk), chunk, lo, vis.k_end,
                         vis.row_groups)
    return plan_of


# (b, h, hkv, sq, sk, dh, window)
SPLIT_CASES = [
    (1, 4, 2, 9, 40, 64, 8),       # Sq 9, window 8: rows see different keys
    (2, 4, 2, 1, 300, 32, 40),     # Sq 1, window 40 over 300 keys
    (1, 4, 4, 5, 77, 32, -1),      # MHA, Sk not a multiple of the chunk
    (1, 8, 2, 16, 77, 32, 20),     # GQA
    (2, 4, 1, 3, 129, 64, -1),     # MQA
]


@pytest.mark.parametrize("case", SPLIT_CASES)
@pytest.mark.parametrize("chunk,from_zero", [(4, False), (16, False),
                                             (64, True), (None, False)])
def test_split_plain_matches_pallas(case, chunk, from_zero):
    """Split + combine against the Pallas kernel (interpret mode): small
    chunks leave whole splits fully masked for some rows (Sq 9 with window
    8: the splits past key 31 for row 0), chunks from key 0 leave the splits
    before the window masked for every row, and chunk None is the plan the
    kernel would take."""
    plan_of = (_forced(chunk, from_zero) if chunk else
               lambda *a: split_plan(*a[:6], causal=True, window=a[6],
                                     sms=H100_SMS))
    plan = _split_pallas(case, plan_of)
    if chunk and plan.k_end - plan.k_begin > chunk:
        assert plan.splits > 1


def test_split_plain_weighs_fully_masked_splits_zero():
    """Row 0 of Sq 9 / window 8 sees keys 24..31 only: the splits [32, 36)
    and [36, 40) give it m = NEG_INF, l = 4, acc = sum V; the combine must
    give them weight exactly 0, so perturbing those V rows moves row 0 not
    at all."""
    q, k, v = map(torch.from_numpy, _qkv(np.random.default_rng(9), 1, 2, 2,
                                         9, 40, 32))
    plan = SplitPlan(4, 4, 24, 40, 1)
    base = flash_attention_split_plain(q, k, v, window=8, plan=plan)
    v2 = v.clone()
    v2[:, :, 32:] += 1e3
    moved = flash_attention_split_plain(q, k, v2, window=8, plan=plan)
    assert torch.equal(base[:, :, 0], moved[:, :, 0])
    assert not torch.equal(base[:, :, 8], moved[:, :, 8])


def test_misaligned_operand_is_refused():
    """The kernels copy 16-byte vectors; an operand whose base or walked
    strides are not 16-byte aligned is refused before any launch."""
    t = torch.zeros(2, 3, 10, 33)
    _check_aligned("q", t[..., :32].contiguous())
    with pytest.raises(ValueError, match="16-byte aligned"):
        _check_aligned("q", t[..., 1:33])          # base off by 4 bytes
    with pytest.raises(ValueError, match="16-byte aligned"):
        _check_aligned("k", t[..., :32])           # row stride 33 floats
    _check_aligned("q", torch.zeros(4, 1, 8, 32).transpose(1, 2))
