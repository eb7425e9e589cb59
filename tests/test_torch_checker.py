"""Port parity: `repro_torch.core.checker` against `repro.core.checker` —
binary search with its probe counts, the framework checker's verdicts and
fault codes, tree-PLRU, BISnp invalidation with its epoch fence, and the
set-associative PermCache: verdicts, probes and the whole cache state
(tags, entries, PLRU bits, hits, misses) after every batch, including
batches whose lanes collide on one set."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import checker as jc
from repro.core.fm import FabricManager as JFM
from repro.core.fm import Proposal as JProposal
from repro_torch import convert
from repro_torch.core import checker as tc
from repro_torch.core.fm import FabricManager as TFM
from repro_torch.core.fm import Proposal as TProposal
from torch_parity import assert_equal

FIELDS = ("allowed", "fault", "entry_idx", "probes")


def _tables(n_grants, *, seed=0, capacity=512):
    """The same FM grant history on both packages -> (jax table, port
    table); grants cover several tenants, R-only and RW, with gaps."""
    rng = np.random.default_rng(seed)
    fms = (JFM(1 << 16, capacity), TFM(1 << 16, capacity))
    for fm, proposal in zip(fms, (JProposal, TProposal)):
        fm.enroll_host(0)
    for k in range(n_grants):
        hwpid, start = 1 + k % 5, int(k * 100 + rng.integers(0, 30))
        perm = 3 if k % 3 else 1
        for fm, proposal in zip(fms, (JProposal, TProposal)):
            fm.propose(proposal(0, hwpid, 0, start, 60, perm))
    return fms[0].table.to_device(), fms[1].table.to_device(device="cpu")


def _batch(rng, b, *, hot_sets=False):
    if hot_sets:     # many distinct pages colliding on a few cache sets
        pages = rng.integers(0, 8, b) * 64 + rng.integers(0, 3, b) * 4096
    else:
        pages = rng.integers(0, 4200, b)
    tags = rng.choice([1, 2, 3, 4, 0, -1], b)
    ext = ((tags << 24) | pages).astype(np.int32)
    return ext, rng.random(b) < 0.3


def _results_equal(j, t):
    for f in FIELDS:
        assert_equal(getattr(j, f), getattr(t, f))


@pytest.mark.parametrize("n_grants", [0, 1, 2, 40])
def test_binary_search_and_check_access_match(n_grants):
    rng = np.random.default_rng(n_grants)
    jt, tt = _tables(n_grants, seed=n_grants)
    pages = rng.integers(-3, 4200, 2048).astype(np.int32)
    for a, b in zip(jc.binary_search(jt.starts, jt.n, jnp.asarray(pages)),
                    tc.binary_search(tt.starts, tt.n,
                                     torch.from_numpy(pages))):
        assert_equal(a, b)
    jl = jc.make_hwpid_local([1, 2, 3, 127])
    tl = tc.make_hwpid_local([1, 2, 3, 127], device="cpu")
    assert_equal(np.asarray(jl).view(np.int32), tl)
    ext, wr = _batch(rng, 2048)
    _results_equal(jc.check_access(jt, jl, jnp.asarray(ext), jnp.asarray(wr)),
                   tc.check_access(tt, tl, ext, wr))


def test_plru_victim_and_touch_match():
    rng = np.random.default_rng(0)
    for ways in (1, 2, 4, 8):
        bits = rng.integers(0, 1 << max(ways - 1, 1), 256).astype(np.uint32)
        way = rng.integers(0, ways, 256).astype(np.int32)
        assert_equal(jc.plru_victim(bits, ways),
                     tc.plru_victim(torch.from_numpy(bits.view(np.int32)),
                                    ways))
        assert_equal(np.asarray(jc.plru_touch(bits, way, ways)).view(np.int32),
                     tc.plru_touch(torch.from_numpy(bits.view(np.int32)),
                                   torch.from_numpy(way), ways))


def test_invalidate_perm_cache_epoch_fence_matches():
    rng = np.random.default_rng(1)
    j = jc.make_perm_cache(epoch=3)
    j = j._replace(tag=jnp.asarray(rng.integers(0, 500, (64, 4)), jnp.int32),
                   entry=jnp.asarray(rng.integers(0, 40, (64, 4)), jnp.int32))
    t = convert.perm_cache_from_numpy(j, device="cpu")
    for start, n, epoch, shifted in [(100, 50, 4, None), (0, 10, 4, 30),
                                     (300, 100, 2, None), (0, 0, 7, None),
                                     (10, 5, 8, 0)]:
        j = jc.invalidate_perm_cache(j, start, n, epoch,
                                     min_shifted_entry=shifted)
        t = tc.invalidate_perm_cache(t, start, n, epoch,
                                     min_shifted_entry=shifted)
        got = convert.perm_cache_to_numpy(t)
        for f in ("tag", "entry"):
            np.testing.assert_array_equal(np.asarray(getattr(j, f)), got[f])
        assert int(j.epoch) == got["epoch"]


@pytest.mark.parametrize("ways", [1, 2, 4])
@pytest.mark.parametrize("fenced", [True, False])
def test_cached_check_access_state_matches(ways, fenced):
    """Twelve batches through both caches — uniform, set-colliding, and
    one all-same-page batch that hits the all-hit fast path — with the
    verdicts, probes and every field of the cache equal after each."""
    rng = np.random.default_rng(ways)
    jt, tt = _tables(40, seed=ways)
    jl = jc.make_hwpid_local([1, 2, 3])
    tl = tc.make_hwpid_local([1, 2, 3], device="cpu")
    epoch = jt.epoch if fenced else jt.epoch - 1
    j = jc.make_perm_cache(ways=ways, epoch=epoch)
    t = tc.make_perm_cache(ways=ways, epoch=epoch, device="cpu")
    all_hit = 0
    for it in range(12):
        ext, wr = _batch(rng, 512, hot_sets=it % 3 == 2)
        if it in (6, 7):          # same page twice: the second batch all-hits
            page = int(tt.starts[0])     # tenant 1's first (R) grant
            ext = np.full(512, (1 << 24) | page, np.int32)
            wr = np.zeros(512, bool)
        jr, j = jc.cached_check_access_jit(jt, jl, jnp.asarray(ext),
                                           jnp.asarray(wr), j)
        tr, t = tc.cached_check_access(tt, tl, ext, wr, t)
        _results_equal(jr, tr)
        got = convert.perm_cache_to_numpy(t)
        for f in ("tag", "entry", "plru"):
            np.testing.assert_array_equal(np.asarray(getattr(j, f)), got[f])
        assert (int(j.hits), int(j.misses), int(j.epoch)) == \
            (got["hits"], got["misses"], got["epoch"])
        all_hit += int(tr.probes.sum()) == 0
    assert all_hit >= 1


def test_desync_result_and_cache_validation():
    r = tc.desync_check_result(5, device="cpu")
    assert not bool(r.allowed.any())
    assert r.fault.tolist() == [tc.FAULT_DESYNC] * 5
    assert r.entry_idx.tolist() == [-1] * 5 and int(r.probes.sum()) == 0
    for kwargs in ({"ways": 3}, {"capacity_bytes": 1000},
                   {"capacity_bytes": 64 * 4 * 3}):
        with pytest.raises(ValueError):
            tc.make_perm_cache(device="cpu", **kwargs)
    c = tc.make_perm_cache(device="cpu")
    assert (c.n_sets, c.n_ways, c.capacity_bytes, c.hit_rate) == \
        (64, 4, tc.PERM_CACHE_BYTES, 0.0)
