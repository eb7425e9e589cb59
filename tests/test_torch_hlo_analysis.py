"""The port's cost analyzer (`repro_torch.launch.hlo_analysis`) held to the
semantics of ``tests/test_hlo_analysis.py`` that carry over from HLO to an
eager step: exact dot FLOPs, L layers counting L times one, nested repeats
multiplying, slice-sized bytes for slice reads and in-place writes,
elementwise counts, the per-wire sizes of every collective on a fake group,
per-rank counting of DTensor and ``local_map`` ops on the fake 16x16 mesh,
and the Mamba scan's trip-count hook against the scan step by step.

A test that makes a fake default process group destroys it before it
returns."""
import contextlib

import pytest
import torch
import torch.distributed as dist

from repro_torch.launch import hlo_analysis as H
from repro_torch.launch.hlo_analysis import CostRecorder, analyze_step


def _count(fn, *args, fake_mode=None) -> CostRecorder:
    rec = CostRecorder(fake_mode)
    with rec:
        fn(*args)
    return rec


def test_matmul_counts_exact_dot_flops():
    a = analyze_step(lambda x, w: x @ w, torch.ones(64, 32),
                     torch.ones(32, 48))
    assert a["dot_flops"] == 2 * 64 * 32 * 48
    assert a["bytes"] == 4 * (64 * 32 + 32 * 48 + 64 * 48)
    assert set(a) == {"dot_flops", "elem_flops", "flops", "bytes",
                      "coll_bytes", "coll_bytes_total", "wire_bytes",
                      "wire_bytes_total", "top_dots", "top_collectives",
                      "top_bytes", "while_trips"}


def _stack(x, ws):
    for w in ws:
        x = torch.tanh(x @ w)
    return x


@pytest.mark.parametrize("layers", [3, 12, 31])
def test_layer_stack_counts_layers_times_one_layer(layers):
    g = torch.Generator().manual_seed(0)
    x = torch.randn(8, 16, generator=g)
    ws = [torch.randn(16, 16, generator=g) for _ in range(layers)]
    one = _count(_stack, x, ws[:1]).cost
    many = _count(_stack, x, ws).cost
    assert many.dot_flops == layers * one.dot_flops
    assert many.elem_flops == layers * one.elem_flops
    assert many.bytes == layers * one.bytes


def test_nested_repeats_count_the_product():
    x, w = torch.ones(4, 8), torch.ones(8, 8)
    one = _count(lambda: x @ w).cost
    rec = CostRecorder()
    with rec:
        with rec.repeat("outer", 3):
            with rec.repeat("inner", 5):
                x @ w
    assert rec.cost.dot_flops == 15 * one.dot_flops
    assert rec.cost.bytes == 15 * one.bytes
    assert rec.cost.while_trips == [("inner", 5), ("outer", 3)]
    loops = _count(lambda: [[x @ w for _ in range(5)] for _ in range(3)])
    assert loops.cost.dot_flops == 15 * one.dot_flops


def test_slice_write_bills_the_update_not_the_buffer():
    buf = torch.zeros(4096, 1024)
    upd = torch.ones(1, 1024)

    def write():
        buf[7:8] = upd

    a = analyze_step(write)
    assert 0 < a["bytes"] < (1 << 20)
    assert a["bytes"] == 2 * 4 * 1024


def test_per_step_slices_bill_the_slices():
    x = torch.ones(64, 512)
    a = analyze_step(lambda: [x[t] * 2.0 for t in range(64)])
    assert 0 < a["bytes"] < 1.5e6


def test_elementwise_counts_no_dots():
    a = analyze_step(lambda x: torch.tanh(x) + 1.0, torch.ones(1000))
    assert a["dot_flops"] == 0
    assert a["elem_flops"] >= 1000


@contextlib.contextmanager
def _fake_group(world: int):
    from torch.testing._internal.distributed.fake_pg import FakeStore
    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_collective_wire_bytes_follow_the_reference_formula():
    import torch.distributed._functional_collectives as funcol
    g = 8
    n = 4 * 1024                     # bytes of the f32 input
    x = torch.ones(1024)
    with _fake_group(g):
        group = dist.group.WORLD
        cases = {
            "all-gather": (lambda: funcol.all_gather_tensor(x, 0, group),
                           g * n * (g - 1) / g),
            "reduce-scatter": (
                lambda: funcol.reduce_scatter_tensor(x, "sum", 0, group),
                n * (g - 1) / g),
            "all-reduce": (lambda: funcol.all_reduce(x, "sum", group),
                           n * 2 * (g - 1) / g),
            "all-to-all": (
                lambda: funcol.all_to_all_single(x, None, None, group),
                n * (g - 1) / g),
            "collective-broadcast": (lambda: funcol.broadcast(x, 0, group),
                                     n),
        }
        for kind, (fn, wire) in cases.items():
            rec = _count(lambda: funcol.wait_tensor(fn()))
            assert rec.cost.wire_bytes == {kind: wire}, kind
            assert rec.n_collectives == 1
        # the plain c10d calls the expert-parallel MoE makes
        y = torch.ones(1024)
        rec = _count(lambda: dist.all_reduce(y, group=group))
        assert rec.cost.wire_bytes == {"all-reduce": n * 2 * (g - 1) / g}
        out = torch.empty(g * 1024)
        rec = _count(lambda: dist.all_gather_into_tensor(out, y, group))
        assert rec.cost.wire_bytes == {"all-gather": g * n * (g - 1) / g}


def test_dtensor_and_local_map_count_per_rank_once():
    """On the fake 16x16 mesh: batch over "data" and columns over "model"
    count global/256 per rank, a replicated product counts global, and a
    ``local_map`` body counts its local shapes once."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.launch.mesh import make_production_mesh
    b, s, k, n = 256, 64, 32, 160
    glob = 2 * b * s * k * n
    with _fake_group(256):
        mesh = make_production_mesh(device="cpu")
        fake = FakeTensorMode()

        def dt(shape, placements):
            with fake:
                return DTensor.from_local(torch.empty(shape), mesh,
                                          placements, run_check=False)

        x = dt((b // 16, s, k), [Shard(0), Replicate()])
        w = dt((k, n // 16), [Replicate(), Shard(1)])
        sharded = _count(lambda: x @ w, fake_mode=fake)
        assert sharded.cost.dot_flops == glob / 256
        assert sharded.cost.coll_bytes == {}

        xr = dt((b, s, k), [Replicate(), Replicate()])
        wr = dt((k, n), [Replicate(), Replicate()])
        assert _count(lambda: xr @ wr, fake_mode=fake).cost.dot_flops == glob

        body = local_map(torch.matmul,
                         out_placements=([Shard(0), Shard(2)],),
                         in_placements=([Shard(0), Replicate()],
                                        [Replicate(), Shard(1)]),
                         device_mesh=mesh)
        mapped = _count(lambda: body(x, w), fake_mode=fake)
        assert mapped.cost.dot_flops == glob / 256
        top = mapped.analyze()["top_dots"]
        assert len(top) == 1 and top[0]["count"] == 1


def _mamba_cost(layer, x, hook: bool, grad: bool = False, monkeypatch=None):
    from repro_torch.layers import mamba as M
    if not hook:
        monkeypatch.setattr(M, "active_recorder", lambda: None)
    rec = CostRecorder()
    with rec:
        with torch.set_grad_enabled(grad):
            y, cache = layer(x)
            if grad:
                y.sum().backward()
    if not hook:
        monkeypatch.undo()
    return rec, y, cache


@pytest.mark.parametrize("version", [1, 2])
def test_mamba_trip_count_hook_counts_as_step_by_step(version, monkeypatch):
    """At small T the scan run once and multiplied by T counts exactly
    the FLOPs and bytes of the scan run step by step; its outputs keep
    their shapes; and with no recorder the scan is the loop, bit for bit."""
    from repro_torch.layers import mamba as M
    g = torch.Generator().manual_seed(3)
    t = 7
    if version == 1:
        p = M.init_mamba1(16, d_state=4, generator=g, device="cpu")
        layer = lambda x: M.mamba1(p, x)
    else:
        p = M.init_mamba2(32, d_state=4, head_dim=16, generator=g,
                          device="cpu")
        layer = lambda x: M.mamba2(p, x, head_dim=16)
    d = 16 if version == 1 else 32
    x = torch.randn(2, t, d, generator=g)
    hooked, y1, c1 = _mamba_cost(layer, x, hook=True)
    loop, y2, c2 = _mamba_cost(layer, x, hook=False,
                               monkeypatch=monkeypatch)
    assert hooked.cost.dot_flops == loop.cost.dot_flops > 0
    assert hooked.cost.elem_flops == loop.cost.elem_flops
    assert hooked.cost.bytes == loop.cost.bytes
    assert hooked.cost.while_trips == [("ssm_scan", t)]
    assert loop.cost.while_trips == []
    assert y1.shape == y2.shape
    assert [c.shape for c in c1] == [c.shape for c in c2]
    # no recorder: the loop itself, bit for bit
    y3, c3 = layer(x)
    assert torch.equal(y3, y2)
    assert all(torch.equal(a, b) for a, b in zip(c3, c2))
    # under autograd the body's backward is multiplied by T too
    p.requires_grad_(True)
    hooked, _, _ = _mamba_cost(layer, x, hook=True, grad=True)
    loop, _, _ = _mamba_cost(layer, x, hook=False, grad=True,
                             monkeypatch=monkeypatch)
    assert hooked.cost.dot_flops == loop.cost.dot_flops


def test_hook_is_off_without_a_recorder():
    assert H.active_recorder() is None
    rec = CostRecorder()
    with rec:
        assert H.active_recorder() is rec
    assert H.active_recorder() is None
