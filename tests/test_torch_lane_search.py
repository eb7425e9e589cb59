"""Port parity of the search the permcheck and fabric-egress kernels run.

`permcheck.lane_search_plain` repeats the kernels' two-level probe sequence
step for step; here it is held, on every edge the search has, against an
independent ``np.searchsorted``, against the port's plain version
(``ref.permcheck``) and against the JAX package's Pallas kernels
(permcheck, fabric egress) in interpret mode; on a shard that breaks the
precondition it must fail closed.  The views the fabric builds
after admit, evict, partial release and shared grants must meet the
search's precondition (sorted, non-overlapping, sentinel tail).  The CUDA
kernels run the same edge cases on the card in test_torch_cuda.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.fabric import stack_views as j_stack_views
from repro.kernels import fabric_egress as jfe
from repro.kernels import permcheck as jpc
from repro_torch import convert
from repro_torch.core import ShardedFabric, pack_ext_addr
from repro_torch.core.fabric import stack_views
from repro_torch.kernels import ref
from repro_torch.kernels import permcheck as tpc
from torch_parity import (BROKEN_SHARDS, EDGE_SHARDS, assert_equal,
                          assert_search_precondition, assert_u32_equal,
                          broken_pages, broken_shard, edge_ext, edge_pages,
                          edge_shard, search_egress, search_verdict, words)


def _row(view, r):
    """Row ``r`` of a stacked FabricView as a ShardView."""
    return tpc.ShardView(view.starts[r], view.ends[r], view.permbits[r],
                         view.tile_min[r], view.tile_max[r])


@pytest.mark.parametrize("name", list(EDGE_SHARDS))
def test_lane_search_finds_the_last_start_at_or_below(name):
    rng = np.random.default_rng(len(name))
    starts, ends, perms = edge_shard(name, rng)
    view = tpc.make_shard_view(starts, ends, perms, device="cpu")
    assert_search_precondition(view.starts, view.ends, view.tile_min)
    pages = edge_pages(rng, starts, ends)
    k = tpc.lane_search_plain(torch.from_numpy(pages), view.starts,
                              view.tile_min)
    want = np.searchsorted(starts, pages, side="right") - 1
    assert_equal(k, want.astype(np.int32))


@pytest.mark.parametrize("name", list(EDGE_SHARDS))
def test_search_verdict_matches_reference_and_jax(name):
    """allowed and idx from the search equal the port's plain version and
    the JAX kernel in each of its modes, for every need."""
    rng = np.random.default_rng(len(name) + 1)
    starts, ends, perms = edge_shard(name, rng)
    ext = edge_ext(rng, edge_pages(rng, starts, ends))
    view = tpc.make_shard_view(starts, ends, perms, device="cpu")
    jv = jpc.make_shard_view(starts, ends, perms)
    for need in (1, 2, 3):
        sa, si = search_verdict(ext, view, hwpid=3, need=need)
        ra, ri = ref.permcheck(torch.from_numpy(ext), view.starts, view.ends,
                               view.permbits, hwpid=3, need=need)
        assert_equal(sa, ra)
        assert_equal(si, ri)
        mode = ("flat", "hier", "adaptive")[need - 1]
        ja, ji = jpc.permcheck_view_pallas(jnp.asarray(ext), jv, hwpid=3,
                                           need=need, interpret=True,
                                           mode=mode)
        assert_equal(ja, sa)
        assert_equal(ji, si)


@pytest.mark.parametrize("name", BROKEN_SHARDS)
def test_search_fails_closed_on_a_broken_shard(name):
    """On an unsorted, overlapping shard the search may miss the entry that
    covers a page, but it grants no page the plain version denies, and the
    entry it names covers the page; page 50 of "four" lies in no entry and
    is denied."""
    rng = np.random.default_rng(len(name) + 20)
    starts, ends, perms = broken_shard(name, rng)
    view = tpc.make_shard_view(starts, ends, perms, device="cpu")
    pages, ext = broken_pages(rng, starts, ends)
    page = torch.from_numpy(pages)
    for need in (1, 2, 3):
        sa, si = search_verdict(ext, view, hwpid=3, need=need)
        ra, _ = ref.permcheck(torch.from_numpy(ext), view.starts, view.ends,
                              view.permbits, hwpid=3, need=need)
        assert not bool((sa & ~ra).any())
        k = si.clamp(min=0).long()
        named = (view.starts[k] <= page) & (page < view.ends[k])
        assert bool((named | (si < 0)).all())
        if name == "four":
            assert not bool(sa[page == 50].any())


def test_search_on_stacked_rows_padded_with_sentinel_tiles():
    """Rows of one FabricView differ in live tiles; the shorter rows are
    padded with dead tiles (INT32_MAX starts and tile minima).  Row by row,
    the search's verdict equals the plain version, and the fused egress
    built on that verdict equals the JAX fabric kernel."""
    rng = np.random.default_rng(11)
    names = ["single", "tiles_9000", "empty", "tile_1024", "single_top"]
    tables = [edge_shard(n, rng) for n in names]
    hwpids = list(range(1, len(names) + 1))
    tviews = [tpc.make_shard_view(*t, device="cpu") for t in tables]
    view = stack_views(tviews, hwpids, range(len(names)), epoch=1)
    assert view.tile_min.shape == (len(names), 16)
    batch = 2048
    ext = np.stack([
        edge_ext(rng, rng.choice(edge_pages(rng, s, e), batch), hwpid=h)
        for (s, e, _), h in zip(tables, hwpids)])
    data = words(rng, ext.shape)
    jview = j_stack_views([jpc.make_shard_view(*t) for t in tables], hwpids,
                          list(range(len(names))), epoch=1)
    jo, jf = jfe.fabric_egress_pallas(jnp.asarray(data), jnp.asarray(ext),
                                      jview, need=2, key0=5, key1=6,
                                      interpret=True)
    to, tf = tpc_fabric_from_search(data, ext, view, need=2, key0=5, key1=6)
    assert_u32_equal(jo, to)
    assert_equal(jf, tf)
    for r, h in enumerate(hwpids):
        row = _row(view, r)
        assert_search_precondition(row.starts, row.ends, row.tile_min)
        sa, si = search_verdict(ext[r], row, hwpid=h, need=1)
        ra, ri = ref.permcheck(torch.from_numpy(ext[r]), row.starts,
                               row.ends, row.permbits, hwpid=h, need=1)
        assert_equal(sa, ra)
        assert_equal(si, ri)


def tpc_fabric_from_search(data, ext, view, *, need, key0, key1):
    """The fabric egress as the kernel computes it, on the CPU: per row
    `search_egress` at base word row * 2048 (B = 2048 is its own
    bucket)."""
    d = convert.u32_from_numpy(data, "cpu")
    rows = [search_egress(d[r], ext[r], _row(view, r), hwpid=h, need=need,
                          key0=key0, key1=key1, base_word=r * ext.shape[1])
            for r, h in enumerate(view.hwpids.tolist())]
    return (torch.stack([o for o, _ in rows]),
            torch.stack([f for _, f in rows]))


def test_views_after_churn_meet_the_search_precondition():
    """Admit, evict, re-admit into freed spans, partial release and shared
    grants: every view a host builds, and every row of the stacked fabric
    view, stays sorted, non-overlapping and sentinel-padded, and the search
    on it agrees with the plain version."""
    rng = np.random.default_rng(12)
    fab = ShardedFabric(1 << 14, 512, 4, device="cpu")
    for h in range(4):
        fab.enroll(h)
    tenants = {h: [fab.admit(h, int(rng.integers(8, 64))) for _ in range(3)]
               for h in range(4)}
    fab.quiesce()
    for h in range(4):                  # evict the middle tenant, re-admit
        fab.evict(h, tenants[h][1][0])
        tenants[h][1] = fab.admit(h, 4)
    pid, start = tenants[0][0]
    fab.fm.release_range(pid, start + 2, 3)       # a hole inside a grant
    fab.grant_shared(tenants[2][2][1], 6, tenants[1][0][0], 1, perm=1)
    fab.quiesce()
    assign = {h: [p for p, _ in ts] for h, ts in tenants.items()}
    view = fab.fabric_view(assign)
    for r, (h, p) in enumerate(fab.fabric_rows(assign)):
        for v in (fab.runtimes[h].shard_view(p), _row(view, r)):
            assert_search_precondition(v.starts, v.ends, v.tile_min)
            lo, hi = fab.runtimes[h].page_lo, fab.runtimes[h].page_hi
            ext = np.asarray(pack_ext_addr(
                np.full(600, p), rng.integers(lo - 8, hi + 8, 600)))
            sa, si = search_verdict(ext, v, hwpid=p, need=1)
            ra, ri = ref.permcheck(torch.from_numpy(ext), v.starts, v.ends,
                                   v.permbits, hwpid=p, need=1)
            assert_equal(sa, ra)
            assert_equal(si, ri)
    fab.fm.table.check_invariants()


def test_search_layout_is_checked():
    """The CUDA wrappers refuse operands the kernels would index out of
    bounds: entries not T x 1024, more than 64 tiles, mismatched arrays."""
    rng = np.random.default_rng(13)
    view = tpc.make_shard_view(*edge_shard("tile_1025", rng), device="cpu")
    tpc.check_search_layout(view.starts, view.ends, view.permbits,
                            view.tile_min)
    bad = [(view.starts[:-1], view.ends[:-1], view.permbits[:-1],
            view.tile_min),
           (view.starts, view.ends[:1024], view.permbits, view.tile_min),
           (view.starts.repeat(33), view.ends.repeat(33),
            view.permbits.repeat(33), view.tile_min.repeat(33))]
    for args in bad:
        with pytest.raises(ValueError, match="1024"):
            tpc.check_search_layout(*args)
