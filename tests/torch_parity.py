"""Shared helpers of the ``test_torch_*`` parity tests: seeded inputs made
with numpy, the comparisons, and the fixture that gives a test the CUDA
device or skips it."""
import numpy as np
import pytest
import torch

from repro_torch.convert import u32_to_numpy
from repro_torch.kernels import permcheck as tpc
from repro_torch.kernels import ref


@pytest.fixture
def cuda():
    """The CUDA device; skips the test (decided here, never at import)
    where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the GPU machine")
    return torch.device("cuda")


def mk_table(rng, n_entries, sdm_pages):
    """Random sorted non-overlapping ranges + per-entry 2-bit perms."""
    bounds = np.sort(rng.choice(sdm_pages, size=2 * n_entries, replace=False))
    return (bounds[0::2].astype(np.int32), bounds[1::2].astype(np.int32),
            rng.integers(0, 4, n_entries).astype(np.uint32))


def mk_ext(rng, starts, batch, sdm_pages, *, hwpid=3, hot=0.5,
           tags=(3, 3, 3, 0, 5, -1)):
    """Tagged addresses: a ``hot`` share on entry starts, the rest uniform;
    tags drawn from ``tags`` (``hwpid`` the tenant's, 0 untagged, -1 the
    padding lane's tag, others forged)."""
    if starts.size:
        on_entry = starts[rng.integers(0, starts.size, batch)]
    else:
        on_entry = rng.integers(0, sdm_pages, batch)
    pages = np.where(rng.random(batch) < hot, on_entry,
                     rng.integers(0, sdm_pages, batch)).astype(np.int32)
    t = rng.choice(np.asarray(tags, np.int32), batch).astype(np.int32)
    return (t << 24) | (pages & 0xFFFFFF)


def words(rng, shape):
    """Random u32 words (numpy uint32)."""
    return rng.integers(0, 1 << 32, shape, dtype=np.uint32)


def as_np(x):
    """A JAX array or a port tensor as numpy; int32 port tensors stay
    int32 (compare u32 words with `assert_u32_equal`)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def assert_equal(a, b):
    np.testing.assert_array_equal(as_np(a), as_np(b))


def assert_u32_equal(jax_words, port_words):
    """JAX u32 words against the port's int32 bit patterns."""
    np.testing.assert_array_equal(np.asarray(jax_words, np.uint32),
                                  u32_to_numpy(port_words))


INT32_MAX = int(np.iinfo(np.int32).max)

# Shards at the edges of the search kernels' two-level search: no entry, a
# single entry (one at the top of the page space, so the -1 padding lane's
# page 0xFFFFFF is covered), runs of adjacent entries (end == next start)
# with gaps and a first start above page 0 or at it, live counts just past a
# power of two (a search's step count changes there), one full tile, a tile
# plus one entry, many tiles, and a full 65,536-entry shard with no sentinel.
EDGE_SHARDS = {
    "empty": (0, 1),
    "single": (1, 100),
    "single_top": (1, 0xFFFF00),
    "pair": (2, 9),
    "adjacent_33": (33, 50),
    "adjacent_from_0": (17, 0),
    "tile_513": (513, 7),
    "tile_1023": (1023, 7),
    "tile_1024": (1024, 7),
    "tile_1025": (1025, 7),
    "tiles_9000": (9000, 3),
    "full_65536": (65536, 1),
}


def edge_shard(name, rng):
    """(starts, ends, perms) of the named edge shard: ``n`` entries from
    ``first`` on, 1-8 pages each, half of them adjacent to the previous one
    and the rest after a gap of 1-5 pages."""
    n, first = EDGE_SHARDS[name]
    if name == "single_top":
        return (np.array([first], np.int32), np.array([1 << 24], np.int32),
                np.array([3], np.uint32))
    lengths = rng.integers(1, 9, n)
    gaps = np.where(rng.random(n) < 0.5, 0, rng.integers(1, 6, n))
    gaps[:1] = 0
    starts = first + np.cumsum(gaps) + np.concatenate(
        [[0], np.cumsum(lengths)[:-1]])
    return (starts.astype(np.int32), (starts + lengths).astype(np.int32),
            rng.integers(0, 4, n).astype(np.uint32))


def edge_pages(rng, starts, ends, *, sample=1500):
    """Pages at every edge of (a sample of) the entries: each start, start
    - 1, end - 1, end and end + 1, plus page 0, page 1, the page below the
    first start and the top page 0xFFFFFF."""
    if starts.size > sample:
        pick = np.sort(rng.choice(starts.size, sample, replace=False))
        starts, ends = starts[pick], ends[pick]
    pages = np.concatenate([
        [0, 1, 0xFFFFFE, 0xFFFFFF], starts[:1] - 1, starts, starts - 1,
        ends - 1, ends, ends + 1])
    return np.clip(pages, 0, 0xFFFFFF).astype(np.int32)


def edge_ext(rng, pages, *, hwpid=3):
    """Tagged addresses over ``pages``: most carry ``hwpid``, the rest are
    untagged, forged, or the -1 padding lane (ext == -1, page 0xFFFFFF)."""
    tags = rng.choice(np.array([hwpid] * 5 + [0, hwpid + 2], np.int32),
                      pages.size)
    ext = (tags.astype(np.int32) << 24) | pages
    ext[rng.random(pages.size) < 0.05] = -1
    return ext.astype(np.int32)


def assert_search_precondition(starts, ends, tile_min):
    """The search kernels' precondition on one shard view row: live
    entries a prefix, strictly sorted by start, non-empty, non-overlapping;
    INT32_MAX sentinels after them; ``tile_min`` the first start of each
    1024-entry tile (INT32_MAX for a dead tile), at most 64 tiles."""
    s, e, tm = (np.asarray(as_np(x)) for x in (starts, ends, tile_min))
    assert s.shape == e.shape and s.size == tm.size * 1024
    assert 1 <= tm.size <= 64
    n = int((s != INT32_MAX).sum())
    assert (s[n:] == INT32_MAX).all() and (e[n:] == INT32_MAX).all()
    assert (np.diff(s[:n].astype(np.int64)) > 0).all()
    assert (s[:n] < e[:n]).all()
    assert (e[:max(n - 1, 0)] <= s[1:n]).all()
    np.testing.assert_array_equal(tm, s[::1024])


# Shards that break the search's precondition: "four" is unsorted and
# overlapping, [(60, 110), (70, 80), (90, 95), (30, 40)], so page 50 lies in
# no entry; the others are edge shards shuffled, with every third end
# stretched over the entries after it.
BROKEN_SHARDS = ["four", "adjacent_33", "tile_1025", "tiles_9000"]


def broken_shard(name, rng):
    """(starts, ends, perms) of the named broken shard."""
    if name == "four":
        return (np.array([60, 70, 90, 30], np.int32),
                np.array([110, 80, 95, 40], np.int32),
                np.full(4, 3, np.uint32))
    starts, ends, perms = edge_shard(name, rng)
    ends = ends.copy()
    ends[::3] += 20
    order = rng.permutation(starts.size)
    return starts[order], ends[order], perms[order]


def broken_pages(rng, starts, ends):
    """Pages 0-129 and the edges of the entries, tagged for HWPID 3."""
    pages = np.concatenate([np.arange(130, dtype=np.int32), edge_pages(
        rng, np.sort(starts), np.sort(ends))])
    return pages, ((3 << 24) | pages).astype(np.int32)


def search_verdict(ext_addrs, view, *, hwpid, need):
    """The permission check as the search kernels compute it, on the CPU:
    `permcheck.lane_search_plain`, then one read of the found entry's end
    and permission bits.  Returns (allowed bool[B], idx i32[B])."""
    ext = torch.as_tensor(np.asarray(ext_addrs, np.int32)).reshape(-1)
    page = ext & 0xFFFFFF
    k = tpc.lane_search_plain(page, view.starts, view.tile_min)
    kc = k.clamp(min=0).long()
    covered = (k >= 0) & (page < view.ends[kc])
    ok = covered & ((view.permbits[kc] & need) == need)
    return ((ext >> 24) == hwpid) & ok, torch.where(covered, k, -1)


def search_egress(data, ext_addrs, view, *, hwpid, need, key0, key1,
                  base_word=0):
    """The fused egress as the checked_memcrypt and fabric_egress kernels
    compute it (``egress::egress_block``), on the CPU: `search_verdict`,
    the fault code in the reference's order (NO_ABITS for tag <= 0, then
    NOT_LOCAL, NO_ENTRY, PERM) and, on a granted word only, the word XORed
    with the keystream at ``base_word + lane`` (mod 2^32).  ``data`` i32[B]
    (u32 bits).  Returns (out i32[B], fault i32[B])."""
    ext = torch.as_tensor(np.asarray(ext_addrs, np.int32)).reshape(-1)
    allowed, idx = search_verdict(ext, view, hwpid=hwpid, need=need)
    dec = ref.memcrypt(data, key0, key1, base_word)
    tag = ext >> 24
    fault = torch.where(allowed, 0, torch.where(
        tag <= 0, 1, torch.where(tag != hwpid, 2,
                                 torch.where(idx < 0, 3, 4))))
    return torch.where(allowed, dec, 0), fault.to(torch.int32)
