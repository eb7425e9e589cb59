"""Port parity: `repro_torch.kernels.fabric_egress` against the JAX
package's `fabric_egress_pallas` (Pallas interpret mode) — flat and hier
rows in one call, the per-row selector, and the keystream position
``row * bucket_pad(B, 1024) + lane`` of an unpadded row, bit for bit.  The
CUDA kernel is held against its plain version on the card."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.fabric import stack_views as j_stack_views
from repro.kernels import fabric_egress as jfe
from repro.kernels import permcheck as jpc
from repro_torch import convert
from repro_torch.core.fabric import stack_views
from repro_torch.kernels import bucket_pad
from repro_torch.kernels import fabric_egress as tfe
from repro_torch.kernels import memcrypt as tmc
from repro_torch.kernels import permcheck as tpc
from torch_parity import (assert_equal, assert_u32_equal, mk_ext, mk_table,
                          words)

SDM = 1 << 20


def _fleet(rng, sizes, batch, device=None):
    """Stacked views over shards of the given entry counts (single- and
    multi-tile rows side by side) plus one batch per row: hot rows hit a
    few entries of their shard, the others are uniform."""
    jviews, tviews, exts = [], [], []
    for r, n in enumerate(sizes):
        starts, ends, perms = mk_table(rng, n, SDM)
        jviews.append(jpc.make_shard_view(starts, ends, perms))
        if device is not None:
            tviews.append(tpc.make_shard_view(starts, ends, perms,
                                              device=device))
        hot = r % 2 == 0
        exts.append(mk_ext(rng, starts[:3] if hot else starts, batch, SDM,
                           hot=1.0 if hot else 0.5,
                           tags=(r + 1,) * 4 + (0, 9, -1)))
    hwpids = list(range(1, len(sizes) + 1))
    jview = j_stack_views(jviews, hwpids, list(range(len(sizes))), epoch=3)
    tview = (stack_views(tviews, hwpids, list(range(len(sizes))), epoch=3)
             if device is not None else None)
    return jview, tview, np.stack(exts)


def test_stacked_views_and_selector_match():
    rng = np.random.default_rng(0)
    jview, tview, ext = _fleet(rng, [5, 4096, 40, 3000], 1500, device="cpu")
    for name in ("starts", "ends", "permbits", "tile_min", "tile_max",
                 "hwpids"):
        assert_equal(np.asarray(getattr(jview, name)).view(np.int32),
                     getattr(tview, name))
    assert tview.host_ids == jview.host_ids and tview.n_hosts == 4
    bp = bucket_pad(ext.shape[1], 1024)
    padded = np.full((4, bp), -1, np.int32)
    padded[:, :ext.shape[1]] = ext
    for block in (1024, 2048):
        j = jfe._per_host_use_hier(jnp.asarray(padded & 0xFFFFFF),
                                   jview.tile_min, jview.tile_max,
                                   block=block)
        t = tfe._per_host_use_hier(torch.from_numpy(padded & 0xFFFFFF),
                                   tview.tile_min, tview.tile_max,
                                   block=block)
        assert_equal(j, t)
    assert set(t.tolist()) == {0, 1}     # flat and hier rows side by side


@pytest.mark.parametrize("sizes,batch", [([1, 2], 300),
                                         ([5, 1500, 40, 3000], 1500)])
def test_fabric_egress_matches_jax(sizes, batch):
    rng = np.random.default_rng(batch)
    jview, _, ext = _fleet(rng, sizes, batch)
    tview = convert.fabric_view_from_numpy(jview, device="cpu")
    data = words(rng, ext.shape)
    for need in (1, 2):
        jo, jf = jfe.fabric_egress_pallas(
            jnp.asarray(data), jnp.asarray(ext), jview, need=need,
            key0=0xAB, key1=0xCD, interpret=True)
        to, tf = tfe.fabric_egress(convert.u32_from_numpy(data, "cpu"), ext,
                                   tview, need=need, key0=0xAB, key1=0xCD)
        assert_u32_equal(jo, to)
        assert_equal(jf, tf)


def test_row_keystream_position_counts_padded_rows():
    """Row r decrypts at base word r * bucket_pad(B, 1024) even though the
    port never pads a row: B = 1500 puts row 1 at word 2048, not 1500."""
    rng = np.random.default_rng(2)
    _, tview, ext = _fleet(rng, [30, 30], 1500, device="cpu")
    data = convert.u32_from_numpy(words(rng, ext.shape), "cpu")
    out, fault = tfe.fabric_egress(data, ext, tview, need=1, key0=1, key1=2)
    for r in range(2):
        view = tpc.ShardView(tview.starts[r], tview.ends[r],
                             tview.permbits[r], tview.tile_min[r],
                             tview.tile_max[r])
        o, f = tmc.checked_memcrypt_view(
            data[r], ext[r], view, hwpid=r + 1, need=1, key0=1, key1=2,
            base_word=r * 2048)
        assert_equal(o, out[r])
        assert_equal(f, fault[r])
    assert bool((out[1] != 0).any())


def test_operand_shapes_are_checked():
    rng = np.random.default_rng(3)
    _, tview, ext = _fleet(rng, [3, 3], 64, device="cpu")
    with pytest.raises(ValueError):
        tfe.fabric_egress(ext[:, :10], ext, tview, need=1, key0=0, key1=0)
    with pytest.raises(ValueError):
        tfe.fabric_egress(ext[:1], ext[:1], tview, need=1, key0=0, key1=0)
