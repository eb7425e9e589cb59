"""Port parity: `repro_torch.kernels.memcrypt` against the JAX package's
`memcrypt_pallas` and `checked_memcrypt_view_pallas` (Pallas interpret
mode) — the keystream at any base word (wraparound included), and the
fused egress with its denied, forged-tag and -1 padding lanes, bit for bit.
The CUDA kernels are held against their plain versions on the card in
test_torch_cuda.py."""
import jax.numpy as jnp
import numpy as np
import pytest

from repro.kernels import memcrypt as jmc
from repro.kernels import ops as jops
from repro.kernels import permcheck as jpc
from repro.kernels import ref as jref
from repro_torch import convert
from repro_torch.core import FAULT_NO_ABITS, FAULT_PERM
from repro_torch.kernels import ops, ref
from repro_torch.kernels import memcrypt as tmc
from torch_parity import (assert_equal, assert_u32_equal, mk_ext, mk_table,
                          words)

SDM = 1 << 20


@pytest.mark.parametrize("shape", [(16,), (1000,), (8, 128), (3, 5, 7)])
@pytest.mark.parametrize("base_word", [0, 11, 2**32 - 5])
def test_memcrypt_matches_jax(shape, base_word):
    rng = np.random.default_rng(len(shape))
    data = words(rng, shape)
    j = jmc.memcrypt_pallas(jnp.asarray(data), key0=0xAB, key1=0xCD,
                            base_word=base_word, interpret=True)
    t = tmc.memcrypt(convert.u32_from_numpy(data, "cpu"), key0=0xAB,
                     key1=0xCD, base_word=base_word)
    assert t.shape == shape
    assert_u32_equal(j, t)
    assert_u32_equal(jref.memcrypt(data, 0xAB, 0xCD, base_word),
                     ref.memcrypt(convert.u32_from_numpy(data, "cpu"),
                                  0xAB, 0xCD, base_word))


def test_memory_encrypt_involution_and_keys():
    rng = np.random.default_rng(1)
    data = words(rng, (4096,))
    ct = ops.memory_encrypt(data, key0=1, key1=2, base_word=3, device="cpu")
    assert not np.array_equal(convert.u32_to_numpy(ct), data)
    back = ops.memory_decrypt(ct, key0=1, key1=2, base_word=3, device="cpu")
    np.testing.assert_array_equal(convert.u32_to_numpy(back), data)
    other = ops.memory_decrypt(ct, key0=1, key1=3, base_word=3, device="cpu")
    assert not np.array_equal(convert.u32_to_numpy(other), data)
    assert_u32_equal(jops.memory_encrypt(jnp.asarray(data), key0=1, key1=2,
                                         base_word=3), ct)


@pytest.mark.parametrize("n_entries,batch", [(0, 100), (1, 100),
                                             (500, 1500), (2048, 2048)])
def test_checked_memcrypt_matches_jax(n_entries, batch):
    rng = np.random.default_rng(batch + n_entries)
    starts, ends, perms = mk_table(rng, n_entries, SDM)
    ext = mk_ext(rng, starts, batch, SDM, tags=(3, 3, 3, 0, 7, -1))
    data = words(rng, batch)
    jv = jpc.make_shard_view(starts, ends, perms)
    tv = convert.shard_view_from_numpy(jv, device="cpu")
    for need in (1, 2):
        jo, jf = jmc.checked_memcrypt_view_pallas(
            jnp.asarray(data), jnp.asarray(ext), jv, hwpid=3, need=need,
            key0=0xAB, key1=0xCD, base_word=11, interpret=True)
        to, tf = tmc.checked_memcrypt_view(
            convert.u32_from_numpy(data, "cpu"), ext, tv, hwpid=3,
            need=need, key0=0xAB, key1=0xCD, base_word=11)
        assert_u32_equal(jo, to)
        assert_equal(jf, tf)


def test_fused_denied_forged_and_padding_lanes():
    """Read-only grant: a write is zeroed with FAULT_PERM, a forged tag
    gives NOT_LOCAL, an untagged lane and a -1 padding lane give NO_ABITS,
    a page outside every range NO_ENTRY — the same words and codes as the
    reference's composed oracle."""
    starts = np.asarray([100, 300], np.int32)
    ends = np.asarray([200, 400], np.int32)
    permbits = np.asarray([1, 3], np.uint32)          # R, then RW
    ext = np.asarray([(3 << 24) | 150, (3 << 24) | 350, (9 << 24) | 150,
                      (0 << 24) | 150, -1, (3 << 24) | 250], np.int32)
    data = np.arange(1, 7, dtype=np.uint32) * 0x01010101
    for need in (1, 2):
        jo, jf = jref.checked_memcrypt(data, ext, starts, ends, permbits,
                                       hwpid=3, need=need, key0=5, key1=6)
        to, tf = ops.checked_memory_decrypt(
            data, ext, starts, ends, permbits, hwpid=3, need=need, key0=5,
            key1=6, device="cpu")
        assert_u32_equal(jo, to)
        assert_equal(jf, tf)
    assert tf.tolist() == [FAULT_PERM, 0, 2, FAULT_NO_ABITS, FAULT_NO_ABITS,
                           3]
    assert convert.u32_to_numpy(to)[[0, 2, 3, 4, 5]].tolist() == [0] * 5
    with pytest.raises(ValueError):
        tmc.checked_memcrypt(data, ext[:3], starts, ends, permbits, hwpid=3,
                             need=1, key0=5, key1=6, device="cpu")
