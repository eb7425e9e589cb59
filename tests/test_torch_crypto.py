"""Port parity: `repro_torch.core.crypto` against `repro.core.crypto` — the
control-plane HMAC labels and KDF, and the ARX MAC the memcrypt keystream
is built on (u32 words carried in masked int64), bit for bit."""
import numpy as np
import pytest
import torch

from repro.core import crypto as jc
from repro_torch.core import crypto as tc


def test_hmac_label_and_derive_key_match():
    for fields in [(), (1,), (0, 5, 0x1000, (7 << 24) | 32),
                   (2**64 - 1, -1, 2**70)]:
        assert tc.hmac_label(b"k", *fields) == jc.hmac_label(b"k", *fields)
    for purpose in ("K_FM", "K_host:0", "K_host:254"):
        assert tc.derive_key(b"m", purpose) == jc.derive_key(b"m", purpose)


@pytest.mark.parametrize("rounds", [4, 12, 20])
def test_arx_mac32_matches(rounds):
    rng = np.random.default_rng(rounds)
    k0, k1 = (int(x) for x in rng.integers(0, 1 << 32, 2, dtype=np.uint64))
    m0 = rng.integers(0, 1 << 32, 4096, dtype=np.uint32)
    m1 = rng.integers(0, 1 << 32, 4096, dtype=np.uint32)
    j0, j1 = jc.arx_mac32(np.uint32(k0), np.uint32(k1), m0, m1,
                          rounds=rounds)
    t0, t1 = tc.arx_mac32(k0, k1, torch.from_numpy(m0.astype(np.int64)),
                          torch.from_numpy(m1.view(np.int32)), rounds=rounds)
    np.testing.assert_array_equal(np.asarray(j0, np.int64), t0.numpy())
    np.testing.assert_array_equal(np.asarray(j1, np.int64), t1.numpy())


def test_arx_mac64_matches():
    rng = np.random.default_rng(7)
    lo = rng.integers(0, 1 << 32, 512, dtype=np.uint32)
    hi = rng.integers(0, 1 << 32, 512, dtype=np.uint32)
    key = 0x0123_4567_89AB_CDEF
    np.testing.assert_array_equal(
        np.asarray(jc.arx_mac64(key, lo, hi), np.int64),
        tc.arx_mac64(key, lo.astype(np.int64), hi.astype(np.int64)).numpy())
