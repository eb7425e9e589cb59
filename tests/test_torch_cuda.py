"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  This file imports neither JAX nor the JAX package, so it runs on a
machine that has only PyTorch and CUDA:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Elsewhere every test skips (the ``cuda`` fixture decides, never at import).
Each test also checks that the wrapper counted exactly its own launches.
"""
import copy
import functools
import importlib
import importlib.util
from dataclasses import replace
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import repro_torch.core as tcore
from repro_torch import convert
from repro_torch.checkpointing import store
from repro_torch.configs import ARCHS, smoke_config
from repro_torch.core import ShardedFabric, pack_ext_addr
from repro_torch.core.fabric import stack_views
from repro_torch.kernels import launches, ops, reset_launches
from repro_torch.kernels import fabric_egress as tfe
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import memcrypt as tmc
from repro_torch.kernels import permcheck as tpc
from repro_torch.layers import moe as tmoe
from repro_torch.layers import moe_ep as tep
from repro_torch.memsim import clock as tclock
from repro_torch.models import registry
from repro_torch.workloads import gapbs as tgapbs
from repro_torch.workloads import graphs as tgraphs
from torch_parity import (BROKEN_SHARDS, EDGE_SHARDS,  # noqa: F401
                          LIFECYCLE_EVENTS, assert_equal,
                          assert_fabric_view_layout,
                          assert_fabric_views_equal, broken_pages,
                          broken_shard, chaos_matrix, cuda, edge_ext,
                          edge_pages, edge_shard, fresh_fabric_view,
                          lifecycle_deployment, lifecycle_event,
                          lifecycle_ext, mk_ext, mk_table, search_egress,
                          search_verdict, traced_fabric, words)

SDM = 1 << 22


def _launched(name, fn):
    before = launches[name]
    out = fn()
    torch.cuda.synchronize()
    assert launches[name] == before + 1, name
    return out


@pytest.mark.cuda
def test_memcrypt_kernel(cuda):  # noqa: F811
    rng = np.random.default_rng(0)
    data = convert.u32_from_numpy(words(rng, (7, 100_003)), cuda)
    for base in (0, 12345, 2**32 - 9):
        out = _launched("memcrypt", lambda: tmc.memcrypt(
            data, key0=0xAB, key1=0xCD, base_word=base))
        assert out.shape == data.shape
        assert_equal(out, tmc.ref.memcrypt(data, 0xAB, 0xCD, base))


@pytest.mark.cuda
@pytest.mark.parametrize("n_entries", [0, 1, 1025, 9000, 65536])
def test_permcheck_kernel_all_modes(cuda, n_entries):  # noqa: F811
    rng = np.random.default_rng(n_entries)
    starts, ends, perms = mk_table(rng, n_entries, SDM)
    view = tpc.make_shard_view(starts, ends, perms, device=cuda)
    for hot in (1.0, 0.0):
        ext = torch.from_numpy(mk_ext(rng, starts[:4] if hot else starts,
                                      3001, SDM, hot=hot)).to(cuda)
        for need in (1, 2, 3):
            pa, pi = tpc.permcheck_view_plain(ext, view, hwpid=3, need=need)
            for mode in ("flat", "hier", "adaptive"):
                ka, ki = _launched("permcheck", lambda: tpc.permcheck_view(
                    ext, view, hwpid=3, need=need, mode=mode))
                assert_equal(ka, pa)
                assert_equal(ki, pi)


@pytest.mark.cuda
@pytest.mark.parametrize("n_entries", [0, 1, 2500, 65536])
def test_checked_memcrypt_kernel(cuda, n_entries):  # noqa: F811
    rng = np.random.default_rng(n_entries + 1)
    starts, ends, perms = mk_table(rng, n_entries, SDM)
    view = tpc.make_shard_view(starts, ends, perms, device=cuda)
    for hot in (1.0, 0.0):
        ext = torch.from_numpy(mk_ext(rng, starts[:4] if hot else starts,
                                      9000, SDM, hot=hot)).to(cuda)
        d = convert.u32_from_numpy(words(rng, 9000), cuda)
        for need in (1, 2):
            args = dict(hwpid=3, need=need, key0=1, key1=2, base_word=77)
            ko, kf = _launched("checked_memcrypt",
                               lambda: tmc.checked_memcrypt_view(
                                   d, ext, view, **args))
            po, pf = tmc.checked_memcrypt_view_plain(d, ext, view, **args)
            assert_equal(ko, po)
            assert_equal(kf, pf)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(EDGE_SHARDS))
def test_checked_memcrypt_kernel_search_edges(cuda, name):  # noqa: F811
    """The fused kernel's search at its edges (EDGE_SHARDS), need 1 and 2,
    with a keystream counter that wraps past 2^32 inside the batch;
    through the 16-byte path, a ragged tail and a batch that starts 4
    bytes off alignment."""
    rng = np.random.default_rng(len(name) + 40)
    starts, ends, perms = edge_shard(name, rng)
    view = tpc.make_shard_view(starts, ends, perms, device=cuda)
    ext = torch.from_numpy(edge_ext(rng, edge_pages(rng, starts, ends)))
    ext = ext.to(cuda)
    d = convert.u32_from_numpy(words(rng, ext.numel()), cuda)
    for sl in (slice(None), slice(None, -1), slice(1, None)):
        for need in (1, 2):
            args = dict(hwpid=3, need=need, key0=1, key1=2,
                        base_word=2**32 - 100)
            ko, kf = _launched("checked_memcrypt",
                               lambda: tmc.checked_memcrypt_view(
                                   d[sl], ext[sl], view, **args))
            po, pf = tmc.checked_memcrypt_view_plain(d[sl], ext[sl], view,
                                                     **args)
            assert_equal(ko, po)
            assert_equal(kf, pf)


@pytest.mark.cuda
def test_checked_memcrypt_kernel_odd_misaligned_and_empty(cuda):  # noqa: F811
    """4097 and 4096 words on a 9-tile shard, the counter wrapping inside
    the batch: an odd length, both operands 4 bytes off, only the data
    off (the 16-byte path needs every operand aligned), both aligned; then
    an empty batch."""
    rng = np.random.default_rng(4097)
    starts, ends, perms = edge_shard("tiles_9000", rng)
    view = tpc.make_shard_view(starts, ends, perms, device=cuda)
    ext = edge_ext(rng, rng.choice(edge_pages(rng, starts, ends), 4098))
    ext = torch.from_numpy(ext).to(cuda)
    d = convert.u32_from_numpy(words(rng, 4098), cuda)
    args = dict(hwpid=3, need=2, key0=5, key1=6, base_word=2**32 - 100)
    for x, e in ((d[:4097], ext[:4097]), (d[1:], ext[1:]),
                 (d[1:4097], ext[:4096]), (d[:4096], ext[:4096])):
        ko, kf = _launched("checked_memcrypt",
                           lambda: tmc.checked_memcrypt_view(x, e, view,
                                                             **args))
        po, pf = tmc.checked_memcrypt_view_plain(x, e, view, **args)
        assert ko.shape == kf.shape == (x.numel(),)
        assert_equal(ko, po)
        assert_equal(kf, pf)
    assert set(pf.unique().tolist()) == {0, 1, 2, 3, 4}
    ko, kf = tmc.checked_memcrypt_view(d[:0], ext[:0], view, **args)
    assert ko.shape == kf.shape == (0,)


@pytest.mark.cuda
@pytest.mark.parametrize("name", BROKEN_SHARDS)
def test_checked_memcrypt_kernel_fails_closed(cuda, name):  # noqa: F811
    """On an unsorted, overlapping shard the fused kernel gives what the
    search gives on the CPU (`search_egress`): it releases no word and
    gives no FAULT_NONE where the plain version withholds the word, and
    page 50 of "four" (in no entry) is withheld."""
    rng = np.random.default_rng(len(name) + 20)
    starts, ends, perms = broken_shard(name, rng)
    view = tpc.make_shard_view(starts, ends, perms, device=cuda)
    host = tpc.make_shard_view(starts, ends, perms, device="cpu")
    pages, ext = broken_pages(rng, starts, ends)
    x = torch.from_numpy(ext).to(cuda)
    d = convert.u32_from_numpy(words(rng, ext.size), cuda)
    for need in (1, 2, 3):
        args = dict(hwpid=3, need=need, key0=7, key1=8, base_word=5)
        ko, kf = _launched("checked_memcrypt",
                           lambda: tmc.checked_memcrypt_view(d, x, view,
                                                             **args))
        so, sf = search_egress(d.cpu(), ext, host, **args)
        assert_equal(ko, so)
        assert_equal(kf, sf)
        po, pf = tmc.checked_memcrypt_view_plain(d, x, view, **args)
        released = kf == 0
        assert not bool((released & (pf != 0)).any())
        assert_equal(ko[released], po[released])
        if name == "four":
            assert not bool(released[torch.from_numpy(pages == 50)
                                     .to(cuda)].any())


@pytest.mark.cuda
def test_fabric_egress_kernel_flat_and_hier_rows(cuda):  # noqa: F811
    rng = np.random.default_rng(4)
    views, exts = [], []
    for r, n in enumerate([5, 1500, 40, 9000, 1, 4096]):
        starts, ends, perms = mk_table(rng, n, SDM)
        views.append(tpc.make_shard_view(starts, ends, perms, device=cuda))
        hot = r % 2 == 0
        exts.append(mk_ext(rng, starts[:3] if hot else starts, 4000, SDM,
                           hot=1.0 if hot else 0.5,
                           tags=(r + 1,) * 4 + (0, 9, -1)))
    view = stack_views(views, range(1, 7), range(6), epoch=0)
    ext = torch.from_numpy(np.stack(exts)).to(cuda)
    data = convert.u32_from_numpy(words(rng, tuple(ext.shape)), cuda)
    for need in (1, 2):
        ko, kf = _launched("fabric_egress", lambda: tfe.fabric_egress(
            data, ext, view, need=need, key0=3, key1=4))
        po, pf = tfe.fabric_egress_plain(data, ext, view, need=need, key0=3,
                                         key1=4)
        assert_equal(ko, po)
        assert_equal(kf, pf)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(EDGE_SHARDS))
def test_permcheck_kernel_search_edges(cuda, name):  # noqa: F811
    """The search at its edges (tests/torch_parity.py EDGE_SHARDS): pages
    on, below and past every entry, adjacent entries, the -1 padding lane,
    the empty and the full 65,536-entry shard; through the 16-byte path, a
    ragged tail and a batch that starts 4 bytes off alignment."""
    rng = np.random.default_rng(len(name))
    starts, ends, perms = edge_shard(name, rng)
    view = tpc.make_shard_view(starts, ends, perms, device=cuda)
    ext = torch.from_numpy(edge_ext(rng, edge_pages(rng, starts, ends)))
    ext = ext.to(cuda)
    for x in (ext, ext[:-1], ext[1:]):
        for need in (1, 2, 3):
            pa, pi = tpc.permcheck_view_plain(x, view, hwpid=3, need=need)
            for mode in tpc.MODES:
                ka, ki = _launched("permcheck", lambda: tpc.permcheck_view(
                    x, view, hwpid=3, need=need, mode=mode))
                assert_equal(ka, pa)
                assert_equal(ki, pi)


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1500, 1501, 2048])
def test_fabric_egress_kernel_search_edges(cuda, batch):  # noqa: F811
    """Stacked edge shards — rows padded with dead tiles beside a 9-tile
    row, an empty row, one at the top of the page space — at a batch on the
    16-byte path (1500, 2048) and a ragged one (1501)."""
    rng = np.random.default_rng(batch)
    names = ["single", "tiles_9000", "empty", "tile_1024", "single_top",
             "pair", "tile_513", "adjacent_from_0"]
    tables = [edge_shard(n, rng) for n in names]
    views = [tpc.make_shard_view(*t, device=cuda) for t in tables]
    hwpids = list(range(1, len(names) + 1))
    view = stack_views(views, hwpids, range(len(names)), epoch=0)
    ext = np.stack([edge_ext(rng, rng.choice(edge_pages(rng, s, e), batch),
                             hwpid=h) for (s, e, _), h in zip(tables, hwpids)])
    ext = torch.from_numpy(ext).to(cuda)
    data = convert.u32_from_numpy(words(rng, tuple(ext.shape)), cuda)
    for need in (1, 2, 3):
        ko, kf = _launched("fabric_egress", lambda: tfe.fabric_egress(
            data, ext, view, need=need, key0=7, key1=8))
        po, pf = tfe.fabric_egress_plain(data, ext, view, need=need, key0=7,
                                         key1=8)
        assert_equal(ko, po)
        assert_equal(kf, pf)
    assert set(pf.unique().tolist()) == {0, 1, 2, 3, 4}


@pytest.mark.cuda
@pytest.mark.parametrize("name", BROKEN_SHARDS)
def test_search_kernels_fail_closed_on_a_broken_shard(cuda,  # noqa: F811
                                                      name):
    """On an unsorted, overlapping shard both kernels give what the probe
    sequence gives on the CPU (`search_verdict`), so they grant no page
    the plain version denies: page 50 of "four" lies in no entry."""
    rng = np.random.default_rng(len(name) + 20)
    starts, ends, perms = broken_shard(name, rng)
    view = tpc.make_shard_view(starts, ends, perms, device=cuda)
    host = tpc.make_shard_view(starts, ends, perms, device="cpu")
    pages, ext = broken_pages(rng, starts, ends)
    x = torch.from_numpy(ext).to(cuda)
    for need in (1, 2, 3):
        ka, ki = _launched("permcheck", lambda: tpc.permcheck_view(
            x, view, hwpid=3, need=need))
        sa, si = search_verdict(ext, host, hwpid=3, need=need)
        assert_equal(ka, sa)
        assert_equal(ki, si)
        pa, _ = tpc.permcheck_view_plain(x, view, hwpid=3, need=need)
        assert not bool((ka & ~pa).any())
    if name == "four":
        assert not bool(ka[torch.from_numpy(pages == 50).to(cuda)].any())
    fview = stack_views([view], [3], [0], epoch=0)
    data = convert.u32_from_numpy(words(rng, (1, ext.size)), cuda)
    ko, kf = _launched("fabric_egress", lambda: tfe.fabric_egress(
        data, x[None], fview, need=1, key0=7, key1=8))
    po, pf = tfe.fabric_egress_plain(data, x[None], fview, need=1, key0=7,
                                     key1=8)
    granted = kf[0] == 0
    assert_equal(granted, search_verdict(ext, host, hwpid=3, need=1)[0])
    assert bool((pf[0][granted] == 0).all())
    assert_equal(ko[0][granted], po[0][granted])


@pytest.mark.cuda
def test_entry_points_default_to_the_card(cuda):  # noqa: F811
    """With no ``device=``, the entry points run on CUDA and launch the
    kernels; a small fabric agrees with the same fabric on the CPU."""
    rng = np.random.default_rng(5)
    starts, ends, perms = mk_table(rng, 50, 1 << 16)
    ext = mk_ext(rng, starts, 700, 1 << 16)
    allowed, _ = _launched("permcheck", lambda: ops.permission_check(
        ext, starts, ends, perms, hwpid=3, need=1))
    assert allowed.device.type == "cuda"
    outs = []
    for device in (None, "cpu"):
        rng = np.random.default_rng(6)
        fab = ShardedFabric(1 << 14, 512, 4, device=device)
        for h in range(4):
            fab.enroll(h)
        tenants = {h: fab.admit(h, 48) for h in range(4)}
        fab.quiesce()
        assign = {h: t[0] for h, t in tenants.items()}
        ext = np.stack([np.asarray(pack_ext_addr(
            np.full(1500, t[0]), t[1] + rng.integers(-8, 56, 1500)))
            for t in tenants.values()])
        data = words(rng, ext.shape)
        outs.append(fab.step_egress(data, ext, assign))
        fab.evict(2, assign[2])
        fab.quiesce()
        outs.append(fab.step_egress(data, ext, assign))
    for (a, fa), (b, fb) in zip(outs[:2], outs[2:]):
        assert a.device.type == "cuda"
        assert_equal(a, b)
        assert_equal(fa, fb)


def _qkv(rng, b, h, hkv, sq, sk, dh, dtype, device):
    mk = lambda *shape: torch.from_numpy(
        rng.normal(size=shape).astype(np.float32)).to(device, dtype)
    return mk(b, h, sq, dh), mk(b, hkv, sk, dh), mk(b, hkv, sk, dh)


# (b, h, hkv, sq, sk, dh, causal, window): the reference's sweeps
# (tests/test_kernels_flash.py) plus the decode and window edge cases
FLASH_CASES = [
    (2, 4, 4, 128, 128, 64, True, -1),
    (2, 4, 4, 256, 384, 64, True, -1),
    (2, 4, 4, 200, 200, 64, True, -1),
    (1, 8, 2, 128, 128, 64, True, -1),
    (1, 4, 1, 128, 128, 64, True, -1),
    (1, 2, 2, 128, 256, 64, False, -1),
    (1, 2, 2, 256, 256, 64, True, 64),
    (1, 2, 2, 256, 256, 64, True, 160),
    (1, 2, 2, 128, 128, 128, True, -1),
    (2, 4, 2, 1, 77, 32, True, -1),
    (2, 4, 2, 1, 300, 256, True, 40),
    (1, 4, 1, 37, 100, 128, True, 16),
    (1, 4, 2, 9, 40, 64, True, 8),
    # the decode path: qwen3-4b's serving step, Sq 2 and 16 with G = 4
    (4, 32, 8, 1, 1056, 128, True, -1),
    (2, 8, 2, 2, 300, 128, True, -1),
    (2, 8, 2, 16, 500, 64, True, -1),
    # a 9th entry forces split chunks from key 0: the splits before the
    # window are fully masked for every row and must weigh exactly 0
    (1, 8, 2, 16, 600, 128, True, 40, 64),
    (2, 4, 2, 1, 1000, 32, True, 100, 64),
    # prefill with ragged Sq and a window at dh 64, 128, 256
    (1, 4, 2, 200, 200, 64, True, 50),
    (1, 4, 2, 200, 260, 128, True, 70),
    (1, 4, 2, 200, 200, 256, True, 33),
    # prefill at qwen3-4b's serving shape
    (4, 32, 8, 1024, 1024, 128, True, -1),
    # cross attention (seamless): non-causal prefill with Sq > Sk, and the
    # non-causal split-K decode over the encoder frames
    (4, 16, 16, 256, 64, 64, False, -1),
    (4, 16, 16, 1, 64, 64, False, -1),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLASH_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel(cuda, case, dtype):  # noqa: F811
    b, h, hkv, sq, sk, dh, causal, window = case[:8]
    rng = np.random.default_rng(sq * 7 + sk)
    q, k, v = _qkv(rng, b, h, hkv, sq, sk, dh, dtype, cuda)
    want = tfa.flash_attention_plain(q, k, v, causal=causal, window=window)
    tol = 2e-5 if dtype == torch.float32 else 3e-2
    if len(case) > 8:
        plan = tfa.SplitPlan(-(-sk // case[8]), case[8], 0, sk, 0)
        call = (lambda: tfa._launch(q, k, v, causal, window, plan))
    else:
        call = (lambda: tfa.flash_attention(q, k, v, causal=causal,
                                            window=window))
    got = _launched("flash_attention", call)
    assert got.dtype == dtype and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                               atol=tol)


@pytest.mark.cuda
def test_flash_attention_kernel_strided_operands(cuda):  # noqa: F811
    """The decode layout: q as a [B,S,H,dh] projection transposed, k/v a
    slice of a larger cache — no copies, same result; the output keeps
    q's layout."""
    rng = np.random.default_rng(11)
    q4 = torch.from_numpy(rng.normal(size=(3, 1, 8, 128)).astype(
        np.float32)).to(cuda)
    cache = torch.from_numpy(rng.normal(size=(2, 3, 2, 500, 128)).astype(
        np.float32)).to(cuda)
    q, k, v = q4.transpose(1, 2), cache[0, :, :, :321], cache[1, :, :, :321]
    got = _launched("flash_attention", lambda: tfa.flash_attention(
        q, k, v, causal=True, window=100))
    assert got.transpose(1, 2).is_contiguous()
    want = tfa.flash_attention_plain(q.contiguous(), k.contiguous(),
                                     v.contiguous(), causal=True, window=100)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.cuda
def test_flash_attention_refuses_misaligned_operands(cuda):  # noqa: F811
    """The kernels copy 16-byte vectors: a q whose base is 4 bytes off, or
    k/v rows 129 floats apart, raise ValueError and launch nothing."""
    rng = np.random.default_rng(12)
    q, k, v = _qkv(rng, 1, 4, 2, 1, 64, 128, torch.float32, cuda)
    wide = torch.zeros(1, 4, 1, 129, device=cuda)
    ragged = torch.zeros(1, 2, 64, 129, device=cuda)
    before = launches["flash_attention"]
    for args in ((wide[..., 1:], k, v), (q, ragged[..., :128], v),
                 (q, k, ragged[..., 1:])):
        with pytest.raises(ValueError, match="16-byte aligned"):
            tfa.flash_attention(*args)
    assert launches["flash_attention"] == before


# ---------------------------------------------------------------------------
# The framework checker's PermCache, the chaos matrix, a traced clocked
# fabric and the checkpoint store: the card held to the port on the CPU,
# which the CPU parity tests hold to the JAX package.
# ---------------------------------------------------------------------------

def _port(device):
    """The port's pieces for the shared fabric scenarios, on ``device``."""
    return SimpleNamespace(
        core=tcore, clock=tclock, gapbs=tgapbs, graphs=tgraphs,
        replay=importlib.import_module("repro_torch.memsim.replay"),
        Fabric=functools.partial(ShardedFabric, device=device),
        zeros=lambda n: np.zeros(n, bool))


@pytest.mark.cuda
@pytest.mark.parametrize("ways", [1, 2, 4])
@pytest.mark.parametrize("fenced", [True, False])
def test_cached_check_access_state_on_the_card(cuda, ways,  # noqa: F811
                                               fenced):
    """Random batches, most of them many lanes to a set, through the same
    PermCache on the card and on the CPU: the CheckResult and the cache's
    tags, entries, PLRU bits, counters and epoch equal after each batch.
    On the card a scatter with repeated indices has no set order, so this
    holds the checker's last-lane-wins reduction to the CPU's."""
    rng = np.random.default_rng(ways)
    fm = tcore.FabricManager(1 << 16, 512)
    fm.enroll_host(0)
    for k in range(40):
        fm.propose(tcore.Proposal(0, 1 + k % 5, 0,
                                  int(k * 100 + rng.integers(0, 30)), 60,
                                  3 if k % 3 else 1))
    epoch = fm.epoch if fenced else fm.epoch - 1
    devs = ("cpu", cuda)
    tables = {d: fm.table.to_device(device=d) for d in devs}
    local = {d: tcore.make_hwpid_local([1, 2, 3], device=d) for d in devs}
    caches = {d: tcore.make_perm_cache(ways=ways, epoch=epoch, device=d)
              for d in devs}
    all_hit = 0
    for it in range(16):
        if it in (8, 9):     # one page twice: the second batch all-hits
            ext = np.full(2048, (1 << 24) | int(tables["cpu"].starts[0]),
                          np.int32)
            wr = np.zeros(2048, bool)
        else:
            if it % 4 == 3:
                pages = rng.integers(0, 4200, 2048)
            else:            # many distinct pages colliding on a few sets
                pages = rng.integers(0, 6, 2048) * 64 + \
                    rng.integers(0, 5, 2048) * 4096
            ext = ((rng.choice([1, 2, 3, 4, 0, -1], 2048) << 24) |
                   pages).astype(np.int32)
            wr = rng.random(2048) < 0.3
        res = {}
        for d in devs:
            res[d], caches[d] = tcore.cached_check_access(
                tables[d], local[d], torch.as_tensor(ext, device=d),
                torch.as_tensor(wr, device=d), caches[d])
        for f in ("allowed", "fault", "entry_idx", "probes"):
            assert_equal(getattr(res["cpu"], f), getattr(res[cuda], f))
        for f in ("tag", "entry", "plru", "hits", "misses"):
            assert_equal(getattr(caches["cpu"], f), getattr(caches[cuda], f))
        assert int(caches["cpu"].epoch) == int(caches[cuda].epoch)
        assert caches[cuda].tag.is_cuda
        all_hit += int(res[cuda].probes.sum()) == 0
    assert all_hit >= 1


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [1, 2, 3, 4, 5])
def test_chaos_matrix_on_the_card(cuda, seed):  # noqa: F811
    """The 4-host chaos matrix with the runtimes on the card: zero stale
    reads and every round's counters, verdicts and fault codes as on the
    CPU."""
    assert chaos_matrix(_port(cuda), seed) == chaos_matrix(_port("cpu"), seed)


@pytest.mark.cuda
def test_incremental_fabric_view_on_the_card(cuda):  # noqa: F811
    """The lifecycle sequence of the CPU parity test with the fabric on the
    card, one step launched between commits: after each event the carried
    and patched stacked view equals one derived from scratch on the card
    bit for bit and the CPU fabric's, every row meets the search layout,
    and the step's words and faults equal the CPU fabric's."""
    rng = np.random.default_rng(9)
    fabs = [ShardedFabric(1 << 14, 4096, 4, device=d) for d in (cuda, "cpu")]
    states = [lifecycle_deployment(fab, tcore.Proposal) for fab in fabs]
    picks = rng.integers(0, 1 << 30, len(LIFECYCLE_EVENTS))
    for kind, pick in zip((None,) + LIFECYCLE_EVENTS, (0, *picks)):
        if kind is not None:
            for fab, state in zip(fabs, states):
                lifecycle_event(fab, state, kind, int(pick))
        assert states[0] == states[1], kind
        assign = states[0]["assign"]
        view = fabs[0].fabric_view(assign)
        assert view.starts.is_cuda and view.hwpids.is_cuda
        assert_fabric_views_equal(view, fresh_fabric_view(fabs[0], assign))
        assert_fabric_views_equal(view, fabs[1].fabric_view(assign))
        assert_fabric_view_layout(view)
        ext = lifecycle_ext(rng, fabs[0], states[0], 1024)
        data = words(rng, ext.shape)
        out, fault = _launched("fabric_egress", lambda: fabs[0].step_egress(
            data, ext, assign))
        want, want_fault = fabs[1].step_egress(data, ext, assign)
        assert_equal(out, want)
        assert_equal(fault, want_fault)
    counted = [{k: fab.stats()[k] for k in
                ("view_builds", "views_kept", "rows_restacked")}
               for fab in fabs]
    assert counted[0] == counted[1] and counted[0]["views_kept"] > 0


@pytest.mark.cuda
def test_traced_fabric_on_the_card(cuda):  # noqa: F811
    """A traced clocked fabric stepping through the fabric kernel: the same
    words, fault codes, trace JSON and replay report as on the CPU."""
    before = launches["fabric_egress"]
    got = traced_fabric(_port(cuda))
    assert launches["fabric_egress"] == before + 4
    assert got == traced_fabric(_port("cpu"))


@pytest.mark.cuda
def test_store_round_trip_of_card_tensors(cuda, tmp_path):  # noqa: F811
    g = torch.Generator(device=cuda).manual_seed(0)
    tree = {"w": torch.randn(64, 32, device=cuda, generator=g),
            "ids": torch.arange(100, dtype=torch.int32, device=cuda),
            "cpu": [torch.ones(3), 7]}
    store.save(str(tmp_path), 1, tree)
    like = {"w": torch.zeros(64, 32, device=cuda),
            "ids": torch.zeros(100, dtype=torch.int32, device=cuda),
            "cpu": [torch.zeros(3), 0]}
    got, step = store.restore(str(tmp_path), like)
    assert step == 1 and got["cpu"][1] == 7
    for k in ("w", "ids"):
        assert got[k].device == tree[k].device and got[k].dtype == \
            tree[k].dtype
        assert torch.equal(got[k], tree[k])
    assert torch.equal(got["cpu"][0], tree["cpu"][0])


# ---------------------------------------------------------------------------
# The serving families: each smoke config on the card held to the same
# weights on the CPU (which the CPU parity tests hold to the JAX package)
# ---------------------------------------------------------------------------

FAMILY_LAYERS = {"olmoe-1b-7b": 4, "llama4-maverick-400b-a17b": 4,
                 "falcon-mamba-7b": 4, "zamba2-1.2b": 5,
                 "seamless-m4t-medium": 4}


@pytest.mark.cuda
@pytest.mark.parametrize("arch", sorted(FAMILY_LAYERS))
def test_family_on_the_card_matches_the_cpu(cuda, arch):  # noqa: F811
    """Prefill and three decode steps: logits within 1e-4 of the CPU run;
    every attention family launches the flash kernel, falcon-mamba none."""
    cfg = replace(smoke_config(ARCHS[arch]), n_layers=FAMILY_LAYERS[arch])
    cpu = registry.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    card = copy.deepcopy(cpu).to(cuda)
    rng = np.random.default_rng(4)
    toks = torch.from_numpy(rng.integers(3, cfg.vocab - 1, (2, 16))
                            .astype(np.int32))
    batch = {"tokens": toks}
    if cfg.family == "encdec":
        batch["frames"] = torch.from_numpy(
            rng.normal(size=(2, 8, cfg.d_model)).astype(np.float32))
    launches["flash_attention"] = 0
    runs = []
    for params, dev in ((cpu, "cpu"), (card, cuda)):
        lg, cache = registry.prefill(
            cfg, params, {k: v.to(dev) for k, v in batch.items()},
            cache_dtype=torch.float32, cap=20)
        out = [lg]
        for pos in range(16, 19):
            nxt = torch.full((2, 1), pos, dtype=torch.int32, device=dev)
            lg, cache = registry.decode_step(cfg, params, cache, nxt, pos)
            out.append(lg)
        runs.append(out)
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        torch.testing.assert_close(b.cpu(), a, rtol=1e-4, atol=1e-4)
    if cfg.family == "ssm":
        assert launches["flash_attention"] == 0
    else:
        assert launches["flash_attention"] > 0


@pytest.mark.cuda
def test_moe_ep_matches_einsum_on_the_card(cuda):  # noqa: F811
    """With capacity lifted the sorted and the one-hot dispatch compute
    the same function on the card."""
    p = tmoe.init_moe(64, 48, 8, torch.float32,
                      torch.Generator(device=cuda).manual_seed(5), cuda)
    x = torch.randn((2, 24, 64), generator=torch.Generator(
        device=cuda).manual_seed(6), device=cuda)
    for top_k in (1, 2, 4):
        ye, ae = tmoe.moe_ffn(p, x, top_k=top_k, capacity_factor=8.0)
        yp, ap = tep.moe_ffn_ep(p, x, top_k=top_k, capacity_factor=8.0)
        torch.testing.assert_close(yp, ye, rtol=2e-5, atol=2e-5)
        torch.testing.assert_close(ap, ae, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_shared_experts_flow_on_the_card(cuda):  # noqa: F811
    """examples/torch_serve_shared_experts.py on the card: A's fetches all
    denied after its revocation, B's tokens unchanged, B's denied rows
    zero (the example raises otherwise)."""
    path = Path(__file__).resolve().parents[1] / "examples" / \
        "torch_serve_shared_experts.py"
    spec = importlib.util.spec_from_file_location("shared_experts", path)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    cfg = replace(smoke_config(ARCHS["olmoe-1b-7b"]), n_layers=2)
    launches["flash_attention"] = 0
    out = example.run(cfg, device=cuda, log=lambda m: None)
    assert out["a_revoked"][1] == out["fetches_per_tenant"]
    assert out["b_after"][0] == out["b_before"][0]
    assert launches["flash_attention"] == 4 * cfg.n_layers


# Launches of each reference example's port on the card: the quickstart's
# checks run the framework checker (no kernel); the multihost example
# encrypts and decrypts the secret words (memcrypt) and takes 4 fabric
# steps, one fabric-egress launch each.
EXAMPLE_LAUNCHES = {
    "torch_quickstart.py": {},
    "torch_multihost_graph_sharing.py": {"memcrypt": 2, "fabric_egress": 4},
}


@pytest.mark.cuda
@pytest.mark.parametrize("script", list(EXAMPLE_LAUNCHES))
def test_example_on_the_card_equals_the_cpu(cuda, script):  # noqa: F811
    """The example's record on the card (verdicts, fault codes, ciphertext,
    CPI rows, each fabric step's denied lanes, codes and words, the fabric
    stats) equals its ``device="cpu"`` record, and the card run launched
    exactly its kernels."""
    path = Path(__file__).resolve().parents[1] / "examples" / script
    spec = importlib.util.spec_from_file_location(path.stem, path)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    reset_launches()
    card = example.run(device=cuda, log=lambda m: None)
    torch.cuda.synchronize()
    counts = dict(launches)
    cpu = example.run(device="cpu", log=lambda m: None)
    assert card == cpu
    assert counts == {name: EXAMPLE_LAUNCHES[script].get(name, 0)
                      for name in launches}


# ---------------------------------------------------------------------------
# Training: the flash kernel is forward-only, so training attends through
# the differentiable path; a train step on the card is held to the CPU.
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_flash_attention_refuses_operands_that_need_a_gradient(
        cuda):  # noqa: F811
    """The kernel has no backward: a grad-requiring CUDA operand raises
    instead of returning an output that drops its gradient."""
    rng = np.random.default_rng(13)
    q, k, v = _qkv(rng, 1, 4, 2, 32, 32, 64, torch.float32, cuda)
    before = launches["flash_attention"]
    for i in range(3):
        args = [q, k, v]
        args[i] = args[i].clone().requires_grad_(True)
        with pytest.raises(RuntimeError, match="forward-only"):
            tfa.flash_attention(*args)
    assert launches["flash_attention"] == before
    with torch.no_grad():      # inference on the same tensors still runs
        _launched("flash_attention", lambda: tfa.flash_attention(
            q.clone().requires_grad_(True), k, v))


TRAIN_LAYERS = {"qwen1.5-0.5b": 2, "olmoe-1b-7b": 2, "zamba2-1.2b": 5,
                "seamless-m4t-medium": 2}


def _rel(a, b) -> float:
    a, b = a.detach().cpu().double(), b.detach().cpu().double()
    return float((a - b).norm() / max(float(b.norm()), 1e-30))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", sorted(TRAIN_LAYERS))
def test_train_step_on_the_card_matches_the_cpu(cuda, arch):  # noqa: F811
    """One `train_step` (2-5 layers, f32, remat full) on the same weights
    and batch: loss and grad-norm within 1e-5, each gradient leaf within
    1e-4 of its norm, each parameter's step within 1e-3 of its norm (AdamW
    amplifies gradient entries near its eps); every parameter gets a
    non-zero gradient, and no flash launch happens."""
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.launch.steps import build_train_step
    from repro_torch.launch.train import make_batch
    from repro_torch.optim import init_state
    cfg = replace(smoke_config(ARCHS[arch]), n_layers=TRAIN_LAYERS[arch],
                  remat="full")
    cpu = registry.init_params(cfg, torch.Generator().manual_seed(7), "cpu")
    card = copy.deepcopy(cpu).to(cuda)
    before = {n: p.detach().clone() for n, p in cpu.named_parameters()}
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=32,
                                  global_batch=2))
    step = build_train_step(cfg, peak_lr=1e-3, warmup=0, total_steps=10)
    batch = make_batch(cfg, data, 0, "cpu")
    if cfg.family == "encdec":   # the launcher's zero frames reach no norm
        batch["frames"] = torch.randn(batch["frames"].shape,
                                      generator=torch.Generator()
                                      .manual_seed(8))
    launches["flash_attention"] = 0
    metrics = []
    for model, dev in ((cpu, torch.device("cpu")), (card, cuda)):
        _, m = step(model, init_state(model),
                    {k: v.to(dev) for k, v in batch.items()})
        metrics.append(m)
    torch.cuda.synchronize()
    assert launches["flash_attention"] == 0
    for name in ("loss", "grad_norm"):
        assert _rel(metrics[1][name], metrics[0][name]) <= 1e-5, name
    card_params = dict(card.named_parameters())
    for n, p in cpu.named_parameters():
        g = card_params[n].grad
        assert g is not None and bool(g.ne(0).any()), n
        assert _rel(g, p.grad) <= 1e-4, n
        assert _rel(card_params[n].cpu() - before[n], p - before[n]) <= 1e-3, n


@pytest.mark.cuda
def test_train_isolated_tenants_on_the_card(cuda):  # noqa: F811
    """examples/torch_train_isolated_tenants.py on the card: the loss
    decreases, the restore continues, and the checkpoint leaf goes through
    the memcrypt kernel and back (the example raises otherwise)."""
    path = Path(__file__).resolve().parents[1] / "examples" / \
        "torch_train_isolated_tenants.py"
    spec = importlib.util.spec_from_file_location("torch_train_tenants",
                                                  path)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    launches["memcrypt"] = launches["flash_attention"] = 0
    example.main(["--device", "cuda"])
    assert launches["memcrypt"] == 2
    assert launches["flash_attention"] == 0


@pytest.mark.cuda
def test_olmoe_decode_on_the_1x1_nccl_mesh_equals_no_mesh(cuda):  # noqa: F811
    """A 2-layer olmoe-1b-7b at full width: prefill and 3 greedy decode
    steps under the 1x1 mesh in a one-rank NCCL group are bit-identical to
    the same steps without a mesh; each MoE layer reduces its output and
    aux every call, and the flash kernel runs under the mesh."""
    import torch.distributed as dist

    from repro_torch.launch import mesh as tmesh
    from repro_torch.launch.activations import use_mesh
    assert not dist.is_initialized()
    cfg = replace(ARCHS["olmoe-1b-7b"], n_layers=2, param_dtype="float32")
    params = registry.init_params(
        cfg, torch.Generator(cuda).manual_seed(0), cuda)
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        3, cfg.vocab - 1, (4, 64)).astype(np.int32)).to(cuda)
    mesh = tmesh.make_smoke_mesh(cuda)
    try:
        assert "nccl" in dist.get_backend()
        runs = []
        for m in (None, mesh):
            tep.reset_collectives()
            launches["flash_attention"] = 0
            with use_mesh(m):
                lg, cache = registry.prefill(cfg, params, {"tokens": toks},
                                             cache_dtype=torch.float32,
                                             cap=68)
                out = [lg]
                for i in range(3):
                    lg, _ = registry.decode_step(
                        cfg, params, cache,
                        out[-1][:, -1:].argmax(-1).to(torch.int32), 64 + i)
                    out.append(lg)
            torch.cuda.synchronize()
            runs.append((out, dict(tep.collectives),
                         launches["flash_attention"]))
        (base, c0, f0), (got, c1, f1) = runs
        for a, b in zip(base, got):
            assert torch.equal(a, b)
        assert sum(c0.values()) == 0
        assert c1["all_reduce"] == 2 * cfg.n_layers * 4
        assert f1 == f0 == cfg.n_layers * 4
    finally:
        dist.destroy_process_group()
