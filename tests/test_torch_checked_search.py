"""Port parity of the fused egress as the checked_memcrypt kernel computes
it: the per-lane search of the sorted shard, the fault order and the
keystream on granted words (`torch_parity.search_egress`), held bit for bit
against the JAX package's oracle (``repro.kernels.ref.checked_memcrypt``)
and its Pallas kernel (``checked_memcrypt_view_pallas``, interpret mode) on
every edge shard, and, on a shard that breaks the search's precondition,
held to release nothing the oracle withholds.  The CUDA kernel runs the
same cases on the card in test_torch_cuda.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import memcrypt as jmc
from repro.kernels import permcheck as jpc
from repro.kernels import ref as jref
from repro_torch import convert
from repro_torch.kernels import memcrypt as tmc
from repro_torch.kernels import permcheck as tpc
from torch_parity import (BROKEN_SHARDS, EDGE_SHARDS, assert_equal,
                          assert_u32_equal, broken_pages, broken_shard,
                          edge_ext, edge_pages, edge_shard, search_egress,
                          words)

KEYS = dict(key0=0xAB, key1=0xCD)


def _against_jax(data, ext, starts, ends, perms, *, need, base_word):
    """`search_egress` on the port's view against the JAX oracle and the
    Pallas kernel on the JAX package's view of the same shard: words and
    codes."""
    view = tpc.make_shard_view(starts, ends, perms, device="cpu")
    to, tf = search_egress(convert.u32_from_numpy(data, "cpu"), ext, view,
                           hwpid=3, need=need, base_word=base_word, **KEYS)
    jv = jpc.make_shard_view(starts, ends, perms)
    ro, rf = jref.checked_memcrypt(data, ext, jv.starts, jv.ends,
                                   jv.permbits, hwpid=3, need=need,
                                   base_word=base_word, **KEYS)
    assert_u32_equal(ro, to)
    assert_equal(rf, tf)
    jo, jf = jmc.checked_memcrypt_view_pallas(
        jnp.asarray(data), jnp.asarray(ext), jv, hwpid=3, need=need,
        base_word=base_word, interpret=True, **KEYS)
    assert_u32_equal(jo, to)
    assert_equal(jf, tf)
    return tf


@pytest.mark.parametrize("name", list(EDGE_SHARDS))
def test_checked_search_matches_reference_and_jax(name):
    """Pages on, below and past every entry, adjacent entries, the -1
    padding lane, forged and untagged lanes: every word and fault code,
    the NO_ENTRY / PERM split included, for need 1 and 2."""
    rng = np.random.default_rng(len(name) + 40)
    starts, ends, perms = edge_shard(name, rng)
    ext = edge_ext(rng, edge_pages(rng, starts, ends))
    data = words(rng, ext.size)
    codes = set()
    for need in (1, 2):
        tf = _against_jax(data, ext, starts, ends, perms, need=need,
                          base_word=11)
        codes |= set(tf.unique().tolist())
    if starts.size > 100:
        assert codes == {0, 1, 2, 3, 4}


def test_checked_search_wraps_the_counter_on_an_odd_batch():
    """4097 words whose keystream counter wraps past 2^32 inside the
    batch, on a 9-tile shard."""
    rng = np.random.default_rng(41)
    starts, ends, perms = edge_shard("tiles_9000", rng)
    ext = edge_ext(rng, rng.choice(edge_pages(rng, starts, ends), 4097))
    tf = _against_jax(words(rng, 4097), ext, starts, ends, perms, need=2,
                      base_word=2**32 - 100)
    assert bool((tf == 0).any())


@pytest.mark.parametrize("name", BROKEN_SHARDS)
def test_checked_search_fails_closed_on_a_broken_shard(name):
    """On an unsorted, overlapping shard the search may withhold a word
    the plain version releases, never the reverse: every released word
    equals the plain version's, every withheld word is 0 with a fault
    code, and page 50 of "four" (in no entry) is withheld."""
    rng = np.random.default_rng(len(name) + 20)
    starts, ends, perms = broken_shard(name, rng)
    view = tpc.make_shard_view(starts, ends, perms, device="cpu")
    pages, ext = broken_pages(rng, starts, ends)
    data = convert.u32_from_numpy(words(rng, ext.size), "cpu")
    for need in (1, 2, 3):
        args = dict(hwpid=3, need=need, base_word=5, **KEYS)
        so, sf = search_egress(data, ext, view, **args)
        po, pf = tmc.checked_memcrypt_view_plain(data, ext, view, **args)
        released = sf == 0
        assert not bool((released & (pf != 0)).any())
        assert_equal(so[released], po[released])
        assert bool((so[~released] == 0).all())
        if name == "four":
            assert not bool(released[torch.from_numpy(pages == 50)].any())
