"""Pieces of the fabric driver and its readers at small sizes on the CPU:
the judge's sample buffers, the launch spans, the collector kept off in
the window, and the host-time reader against hand-worked values."""
import gc
import random
import types

import pytest
import torch

from scbench import harness
from scbench.drivers import fabric
from scbench.tests import _tiny


def test_reservoir_copies_into_its_buffers():
    bufs = [[torch.zeros(2, 3, dtype=torch.int32) for _ in range(2)]]
    keep = fabric.Reservoir(random.Random(0), 1, bufs)
    assert keep.nbytes == 2 * 6 * 4
    out, fault, ext = (torch.full((2, 3), v, dtype=torch.int32)
                       for v in (1, 2, 3))
    got = keep.keep(0, out, fault, ext)
    # out and fault are copies in the buffer; ext, with no room, is itself
    assert got[0] is bufs[0][0] and got[1] is bufs[0][1] and got[2] is ext
    out += 10
    assert int(got[0].sum()) == 6 and int(got[1].sum()) == 12


def test_reservoir_copies_ext_where_it_has_room():
    bufs = [[torch.zeros(4, dtype=torch.int32) for _ in range(3)]]
    keep = fabric.Reservoir(random.Random(0), 1, bufs)
    ext = torch.arange(4, dtype=torch.int32)
    got = keep.keep(0, ext, ext, ext)
    ext += 1
    assert got[2] is bufs[0][2] and got[2].tolist() == [0, 1, 2, 3]


def test_offer_step_keeps_the_first_and_fewer_later():
    keep = fabric.Reservoir(random.Random(3), 2, [])
    kept = [keep.offer_step("s") for _ in range(2000)]
    assert kept[0] and 3 <= sum(kept) <= 20


def test_time_launches_wraps_and_restores_only_when_traced():
    from repro_torch.kernels import fabric_egress as mod
    launch = mod.launch
    record = harness.RunRecord()
    off = types.SimpleNamespace(trace=False,
                                spans=harness.Spans(record, False))
    fabric.time_launches(off)()
    assert mod.launch is launch
    on = types.SimpleNamespace(trace=True,
                               spans=harness.Spans(record, True))
    undo = fabric.time_launches(on)
    try:
        assert mod.launch is not launch
    finally:
        undo()
    assert mod.launch is launch


@pytest.mark.parametrize("cell", ["fabric255-gapbs", "fabric255-churn"])
def test_collector_is_off_in_the_window_and_back_after(cell):
    seen = []

    def watch(step):
        def f(slot, assign):
            seen.append(gc.isenabled())
            return step(slot, assign)
        return f
    assert gc.isenabled()
    record, line = _tiny.run(cell, wrap_step=watch)
    assert record.correct
    # warm-up steps run with the collector on, the window's with it off
    ring = _tiny.FABRIC["params"]["ring_steps"]
    assert all(seen[:ring]) and not any(seen[ring:])
    assert gc.isenabled() and gc.get_freeze_count() == 0


def test_step_host_ms_leaves_out_the_launch():
    read = harness.reader("fabric.step_host_ms")
    record = harness.RunRecord()
    assert read(record) is None
    record.spans["fabric.step_egress"] = [0.004, 0.002]
    assert read(record) == pytest.approx(3.0)
    record.spans["fabric.launch"] = [0.003, 0.001]
    assert read(record) == pytest.approx(1.0)
