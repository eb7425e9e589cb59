"""Port parity: `repro_torch.kernels.permcheck` against the JAX package's
`permcheck_view_pallas` (Pallas interpret mode) — shard views, the
diff-form operands, every mode across tile boundaries, the empty shard,
the capacity guard, and the adaptive selector's decision batch for batch.
The CUDA kernel is held against its plain version on the card in
test_torch_cuda.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import permcheck as jpc
from repro.kernels import ref as jref
from repro_torch import convert
from repro_torch.kernels import ops, ref
from repro_torch.kernels import permcheck as tpc
from torch_parity import assert_equal, mk_ext, mk_table

SDM = 1 << 22


@pytest.mark.parametrize("n_entries", [1, 1023, 1025, 2048, 4096])
def test_view_matches_jax_across_tile_boundaries(n_entries):
    rng = np.random.default_rng(n_entries)
    starts, ends, perms = mk_table(rng, n_entries, SDM)
    edges = np.concatenate([starts, ends - 1, ends]).astype(np.int32)
    ext = np.concatenate([
        mk_ext(rng, starts, 512, SDM),
        (3 << 24) | rng.choice(edges, 512).astype(np.int32)])
    jv = jpc.make_shard_view(starts, ends, perms)
    tv = tpc.make_shard_view(starts, ends, perms, device="cpu")
    for name in ("starts", "ends", "permbits", "tile_min", "tile_max"):
        assert_equal(np.asarray(getattr(jv, name)).view(np.int32),
                     getattr(tv, name))
    for need in (1, 2, 3):
        mode = ("flat", "hier", "adaptive")[need - 1]
        ja, ji = jpc.permcheck_view_pallas(jnp.asarray(ext), jv, hwpid=3,
                                           need=need, interpret=True,
                                           mode=mode)
        ta, ti = tpc.permcheck_view(ext, tv, hwpid=3, need=need, mode=mode)
        assert_equal(ja, ta)
        assert_equal(ji, ti)


def test_grant_sizes_match():
    rng = np.random.default_rng(0)
    starts, ends, perms = mk_table(rng, 300, SDM)
    jv = jpc.make_shard_view(starts, ends, perms)
    tv = convert.shard_view_from_numpy(jv, device="cpu")
    for need in (1, 2, 3):
        for a, b in zip(
                jpc.grant_sizes(jv.starts, jv.ends, jv.permbits,
                                jnp.uint32(need)),
                tpc.grant_sizes(tv.starts, tv.ends, tv.permbits, need)):
            assert_equal(np.asarray(a).view(np.int32), b)


def test_empty_shard_denies_everything():
    ext = ((2 << 24) | np.arange(64)).astype(np.int32)
    empty = np.zeros(0, np.int32)
    for mode in ("flat", "hier", "adaptive"):
        allowed, idx = tpc.permcheck(ext, empty, empty, empty, hwpid=2,
                                     need=1, mode=mode, device="cpu")
        assert not bool(allowed.any()) and bool((idx == -1).all())


def test_capacity_guard_and_mode_check():
    big = np.zeros(tpc.MAX_ENTRIES + 1, np.int32)
    with pytest.raises(ValueError):
        tpc.make_shard_view(big, big, big, device="cpu")
    view = tpc.make_shard_view(big[:4], big[:4] + 1, big[:4], device="cpu")
    with pytest.raises(ValueError):
        tpc.permcheck_view(np.zeros(4, np.int32), view, hwpid=1, need=1,
                           mode="dense")


@pytest.mark.parametrize("n_entries,batch,modes", [
    (900, 1000, {"flat"}),             # one tile: nothing to skip
    (3000, 1500, {"hier"}),            # 3 live tiles of 4: hier even uniform
    (4096, 2048, {"flat", "hier"})])
def test_selected_mode_agrees_with_jax(n_entries, batch, modes):
    """Hot and uniform traces, padded batches: the port's selector picks
    the reference's mode, both for the permcheck block and the fused
    kernel's super-block."""
    rng = np.random.default_rng(batch)
    starts, ends, perms = mk_table(rng, n_entries, SDM)
    jv = jpc.make_shard_view(starts, ends, perms)
    tv = tpc.make_shard_view(starts, ends, perms, device="cpu")
    seen = set()
    for hot in (1.0, 0.0):
        hot_starts = starts[:8] if hot else starts
        ext = mk_ext(rng, hot_starts, batch, SDM, hot=hot)
        for block in (1024, 8192):
            mode = tpc.selected_mode(ext, tv, block=block)
            assert mode == jpc.selected_mode(jnp.asarray(ext), jv,
                                             block=block)
            seen.add(mode)
    assert seen == modes


def test_shard_view_cache_and_table_view():
    from repro.core.table import HostTable as JHostTable
    from repro_torch.core.table import HostTable
    rng = np.random.default_rng(4)
    hts = (JHostTable(2048), HostTable(2048))
    for i in range(1500):
        w = np.zeros(8, np.uint32)
        w[0] = rng.integers(0, 1 << 32, dtype=np.uint32)
        for ht in hts:
            ht.insert(i * 3, 2, w)
    jt, tt = hts[0].to_device(), hts[1].to_device(device="cpu")
    cache = tpc.ShardViewCache()
    v1 = tpc.table_shard_view(tt, 5, cache=cache)
    assert tpc.table_shard_view(tt, 5, cache=cache) is v1
    assert (cache.rebuilds, cache.reuses) == (1, 1)
    jv = jpc.table_shard_view(jt, 5)
    for name in ("starts", "ends", "permbits", "tile_min", "tile_max"):
        assert_equal(np.asarray(getattr(jv, name)).view(np.int32),
                     getattr(v1, name))
    cache.drop(5)
    assert tpc.table_shard_view(tt, 5, cache=cache) is not v1


def test_ops_permission_check_matches():
    rng = np.random.default_rng(5)
    starts, ends, perms = mk_table(rng, 100, 1 << 16)
    ext = mk_ext(rng, starts, 700, 1 << 16)
    ja, ji = jops.permission_check(jnp.asarray(ext), jnp.asarray(starts),
                                   jnp.asarray(ends), jnp.asarray(perms),
                                   hwpid=3, need=1)
    ta, ti = ops.permission_check(ext, starts, ends, perms, hwpid=3,
                                  need=1, device="cpu")
    assert_equal(ja, ta)
    assert_equal(ji, ti)
    ra, ri = jref.permcheck(ext, starts, ends, perms, hwpid=3, need=2)
    pa, pi = ref.permcheck(torch.from_numpy(ext), starts, ends,
                           perms.view(np.int32), hwpid=3, need=2)
    assert_equal(ra, pa)
    assert_equal(ri, pi)
