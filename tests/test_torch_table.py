"""Port parity: `repro_torch.core.table` against `repro.core.table` — the
constants, ext-address packing, permission words, tile summaries, and the
numpy HostTable's shadow commits (insert, revoke, revoke_range, vacuum),
bit for bit on seeded inputs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import table as jt
from repro_torch.core import table as tt
from torch_parity import as_np, assert_equal, mk_table


def test_constants_match():
    for name in ("PAGE_SHIFT", "PAGE_BYTES", "HWPID_BITS", "MAX_HWPID",
                 "HWPID_SHIFT", "PAGE_MASK", "ENTRY_BYTES", "PERM_WORDS",
                 "EMPTY_START", "PERM_NONE", "PERM_R", "PERM_W", "PERM_RW",
                 "SUMMARY_TILE", "_NO_END", "MAX_DIRTY_RANGES"):
        assert getattr(jt, name) == getattr(tt, name), name


def test_pack_unpack_ext_addr_match():
    rng = np.random.default_rng(0)
    hwpid = rng.integers(-1, 128, 4096).astype(np.int32)
    page = rng.integers(-5, 1 << 25, 4096).astype(np.int32)
    ext_j = jt.pack_ext_addr(hwpid, page)
    ext_t = tt.pack_ext_addr(hwpid, page)
    assert_equal(ext_j, ext_t)
    for a, b in zip(jt.unpack_ext_addr(ext_j), tt.unpack_ext_addr(ext_t)):
        assert_equal(a, b)


def test_perm_words_extract_and_tenant_permbits_match():
    rng = np.random.default_rng(1)
    rows = []
    for _ in range(64):
        pids = rng.choice(np.arange(1, 128), 6, replace=False)
        m = {int(p): int(rng.integers(0, 4)) for p in pids}
        w = tt.perm_words_for(m)
        np.testing.assert_array_equal(w, jt.perm_words_for(m))
        rows.append(w)
    perms = np.stack(rows)
    hw = rng.integers(-1, 128, 64).astype(np.int32)
    assert_equal(jt.extract_perm(jnp.asarray(perms), hw),
                 tt.extract_perm(torch.from_numpy(perms.view(np.int32)), hw))
    with pytest.raises(ValueError):
        tt.perm_words_for({128: 1})
    ht = tt.HostTable(128)
    for i, w in enumerate(rows[:20]):
        ht.insert(i * 10, 5, w)
    dev_j = jt.PermissionTable(jnp.asarray(ht.starts), jnp.asarray(ht.sizes),
                               jnp.asarray(ht.perms), jnp.asarray(ht.meta),
                               jnp.asarray(ht.n))
    dev_t = ht.to_device(device="cpu")
    for hwpid in (1, 15, 16, 33, 127):
        assert_equal(jt.tenant_permbits(dev_j, hwpid),
                     tt.tenant_permbits(dev_t, hwpid))


@pytest.mark.parametrize("n_entries", [0, 1, 1023, 1024, 1025, 3000])
@pytest.mark.parametrize("n_tiles", [None, 4])
def test_tile_summary_matches(n_entries, n_tiles):
    rng = np.random.default_rng(n_entries)
    starts, ends, _ = mk_table(rng, n_entries, 1 << 20)
    starts[::7] = tt.EMPTY_START       # dead entries summarize as empty
    for a, b in zip(jt.tile_summary(starts, ends, n_tiles=n_tiles),
                    tt.tile_summary(starts, ends, n_tiles=n_tiles)):
        assert_equal(a, b)


def test_summary_candidate_tiles_matches():
    rng = np.random.default_rng(2)
    starts, ends, _ = mk_table(rng, 4000, 1 << 20)
    tmin_j, tmax_j = jt.tile_summary(starts, ends)
    tmin_t, tmax_t = tt.tile_summary(starts, ends)
    pages = rng.integers(0, 1 << 20, 4096).astype(np.int32)
    for block in (256, 1024, 4096):
        assert_equal(
            jt.summary_candidate_tiles(pages, tmin_j, tmax_j, block=block),
            tt.summary_candidate_tiles(pages, tmin_t, tmax_t, block=block))


def _host_tables_equal(a, b):
    for name in ("starts", "sizes", "perms", "meta"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    assert (a.n, a.epoch, a.last_commit) == (b.n, b.epoch, b.last_commit)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_host_table_commits_match(seed):
    """The same random insert / remove_hwpid / revoke_range / vacuum
    sequence, in and out of transactions, leaves both HostTables
    byte-identical with the same CommitInfo after every commit; the device
    snapshots agree too."""
    rng = np.random.default_rng(seed)
    a, b = jt.HostTable(256), tt.HostTable(256)
    for step in range(60):
        op = rng.integers(0, 10)
        hwpid = int(rng.integers(1, 128))
        start = int(rng.integers(0, 2000))
        n = int(rng.integers(1, 80))
        perm = int(rng.integers(1, 4))
        for ht, mod in ((a, jt), (b, tt)):
            if op < 6:
                ht.insert(start, n, mod.perm_words_for({hwpid: perm}),
                          owner_host=step % 4)
            elif op < 8:
                ht.revoke_range(start, n, hwpid)
            elif op == 8:
                ht.remove_hwpid(hwpid)
            else:
                with ht.transaction():
                    ht.insert(start, n, mod.perm_words_for({hwpid: 3}))
                    ht.vacuum()
                ht.commit()
        _host_tables_equal(a, b)
        b.check_invariants()
    ja, tb = a.to_device(), b.to_device(device="cpu")
    for name in ("starts", "sizes", "perms", "meta"):
        np.testing.assert_array_equal(
            np.asarray(getattr(ja, name)).view(np.int32),
            as_np(getattr(tb, name)))
    assert (int(ja.n), ja.epoch) == (tb.n, tb.epoch)
    for x, y in zip(a.tile_summary(), b.tile_summary(device="cpu")):
        assert_equal(x, y)


def test_make_table_matches():
    a, b = jt.make_table(100), tt.make_table(100, device="cpu")
    for name in ("starts", "sizes", "meta"):
        assert_equal(getattr(a, name), getattr(b, name))
    assert b.perms.shape == (100, tt.PERM_WORDS) and b.n == 0
    assert a.capacity == b.capacity and a.nbytes_metadata() == 0


def test_permission_table_converts_both_ways():
    """The JAX package's device table -> the port's and back, bits kept."""
    from repro_torch import convert
    ht = jt.HostTable(64)
    for i, pid in enumerate((1, 17, 127)):
        ht.insert(i * 50, 20, jt.perm_words_for({pid: 3}), owner_host=i)
    jtab = ht.to_device()
    ttab = convert.permission_table_from_numpy(jtab, device="cpu")
    back = convert.permission_table_to_numpy(ttab)
    for name in ("starts", "sizes", "perms", "meta"):
        np.testing.assert_array_equal(np.asarray(getattr(jtab, name)),
                                      back[name])
    assert (back["n"], back["epoch"]) == (int(jtab.n), jtab.epoch)
    assert back["perms"].dtype == np.uint32
