"""Port parity: the shared tensor pool (`repro_torch.core.pool`) against
the JAX package on the scenarios of tests/test_pool.py — page accounting,
duplicate names, grants and denials, R-only writes, cross-tenant
isolation, revocation, and the free list under churn.  Both packages run
the same scenario; every region, gathered row and verdict must agree."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import FabricManager as JFM
from repro.core import Proposal as JProposal
from repro.core import SharedTensorPool as JPool
from repro.core import checked_gather as jgather
from repro.core import make_hwpid_local as jlocal
from repro_torch.core import (FAULT_NO_ENTRY, PERM_R, PERM_RW, FabricManager,
                              Proposal, SharedTensorPool, checked_gather,
                              make_hwpid_local)
from repro_torch.core.table import PAGE_BYTES
from torch_parity import assert_equal

PORT = (SharedTensorPool, FabricManager, Proposal, checked_gather,
        lambda pids: make_hwpid_local(pids, device="cpu"),
        lambda a: torch.as_tensor(np.asarray(a)),
        lambda fm: fm.table.to_device("cpu"))
JAX = (JPool, JFM, JProposal, jgather, jlocal, jnp.asarray,
       lambda fm: fm.table.to_device())


def _region_tuple(r):
    return (r.name, r.start_page, r.n_pages, r.row_shape, r.rows,
            r.bytes_per_row)


def _scenario(pkg, grants, gathers, revoke_after=None):
    """A 64 x 32 f32 region (32 rows a page) on host 0; ``grants`` [(pid
    index, first page offset, n pages, perm)], ``gathers`` [(pid index,
    rows, is_write)]."""
    pool_cls, fm_cls, proposal, gather, local, arr, to_dev = pkg
    pool = pool_cls()
    w = np.arange(64 * 32, dtype=np.float32).reshape(64, 32)
    region = pool.register("experts", arr(w))
    fm = fm_cls(sdm_pages=pool.total_pages + 8, table_capacity=256)
    hosts = [fm.enroll_host(0), fm.enroll_host(1)]
    pids = [hosts[0].get_next_pid(), hosts[1].get_next_pid()]
    for who, off, n, perm in grants:
        fm.propose(proposal(who, pids[who], 0xA + who,
                            region.start_page + off, n, perm))
    out = [_region_tuple(region)]
    for i, (who, rows, is_write) in enumerate(gathers):
        if i == revoke_after:
            fm.revoke_hwpid(pids[0])
        r = gather(pool, "experts", arr(np.asarray(rows, np.int32)),
                   hwpid=pids[who], table=to_dev(fm),
                   hwpid_local=local([pids[who]]), is_write=is_write)
        out.append((np.asarray(r.data), np.asarray(r.check.allowed),
                    np.asarray(r.check.fault)))
    return out


def _same(grants, gathers, revoke_after=None):
    want = _scenario(JAX, grants, gathers, revoke_after)
    got = _scenario(PORT, grants, gathers, revoke_after)
    assert got[0] == want[0]
    for g, w in zip(got[1:], want[1:]):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
    return got


def test_region_page_accounting():
    for pool, arr in ((JPool(), jnp.zeros), (SharedTensorPool(),
                                             torch.zeros)):
        r = pool.register("w", arr((100, 128)))
        assert r.bytes_per_row == 512
        assert r.n_pages == -(-100 * 512 // PAGE_BYTES)
    assert_equal(
        SharedTensorPool().register("w", torch.zeros(100, 128))
        .pages_for_rows([0, 7, 8, 16]), [1, 1, 2, 3])


def test_duplicate_region_rejected():
    pool = SharedTensorPool()
    pool.register("a", torch.zeros(4, 4))
    with pytest.raises(ValueError):
        pool.register("a", torch.zeros(4, 4))
    with pytest.raises(ValueError):
        pool.register_at("a", torch.zeros(4, 4), start_page=9)


def test_grants_and_denials():
    out = _same([(0, 0, 1, PERM_R)], [(0, [0, 1, 31], False),
                                      (0, [32, 63], False)])
    assert out[1][1].all()
    assert not out[2][1].any() and (out[2][0] == 0).all()
    assert (out[2][2] == FAULT_NO_ENTRY).all()


def test_write_needs_w():
    out = _same([(0, 0, 2, PERM_R)], [(0, [0], True)])
    assert not out[1][1][0]


def test_cross_tenant_isolation():
    out = _same([(0, 0, 1, PERM_RW), (1, 1, 1, PERM_RW)],
                [(0, [0, 1, 2, 3], False), (0, [63], False),
                 (1, [63], False)])
    assert out[1][1].all() and not out[2][1].any() and out[3][1].all()


def test_revocation_applies_to_pool():
    out = _same([(0, 0, 2, PERM_RW)], [(0, [3], False), (0, [3], False)],
                revoke_after=1)
    assert out[1][1][0] and not out[2][1][0]


def test_free_list_and_external_spans():
    """Churn reuses released spans (coalesced, first fit); a region placed
    at an external span never enters the pool's free list."""
    seen = []
    for pool, zeros in ((JPool(), jnp.zeros), (SharedTensorPool(),
                                               torch.zeros)):
        spans = [_region_tuple(pool.register(n, zeros((rows, 1024))))
                 for n, rows in (("a", 3), ("b", 5), ("c", 2))]
        pool.unregister("a")
        pool.unregister("b")
        spans.append(_region_tuple(pool.register("d", zeros((7, 1024)))))
        spans.append(_region_tuple(pool.register_at(
            "kv", zeros((4, 1024)), start_page=500)))
        pool.unregister("kv")
        spans.append(_region_tuple(pool.register("e", zeros((1, 1024)))))
        pool.update("e", zeros((1, 1024)) + 1)
        seen.append((spans, pool._free, pool.total_pages,
                     float(np.asarray(pool.tensor("e")).sum())))
    assert seen[0] == seen[1]
