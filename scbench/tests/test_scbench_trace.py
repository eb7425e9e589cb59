"""The reduction of a profiler trace to busy, idle and breakdown, on
hand-made events (a CPU run has no device events to reduce)."""
import random
from types import SimpleNamespace

import pytest
import torch

from scbench import harness

CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU


def ev(name, start, end, device=CPU):
    return SimpleNamespace(name=name, device_type=device,
                           time_range=SimpleNamespace(start=start, end=end))


def test_busy_idle_and_labels_by_hand():
    events = [
        ev("scbench:window", 0, 100),
        ev("scbench:fabric.step_egress", 0, 30),
        ev("scbench:control.commit", 40, 90),
        ev("scbench:window", 0, 100, CUDA),        # a range, not work
        ev("kernel_a", 10, 20, CUDA),
        ev("kernel_a", 15, 25, CUDA),              # overlaps: counted once
        ev("copy", 60, 70, CUDA),
        ev("kernel_b", 95, 120, CUDA),             # clipped at the window
    ]
    t = harness.summarize(events)
    assert t.window_s == pytest.approx(100e-6)
    assert t.busy_s == pytest.approx((15 + 10 + 5) * 1e-6)
    assert t.device_s("kernel_a") == pytest.approx(20e-6)
    # idle gaps 0-10, 25-60 and 70-95, each put down to the span that
    # holds its midpoint (5: the step; 42.5 and 82.5: the commit)
    assert t.idle_s_by_host == pytest.approx({
        "fabric.step_egress": 10e-6, "control.commit": 60e-6})
    b = t.breakdown()
    assert [n for n, _ in b["device_ops"]] == ["kernel_b", "kernel_a",
                                               "copy"]
    assert b["idle_gaps"][0] == ["control.commit", pytest.approx(60e-6)]


def test_span_index_finds_the_innermost_span():
    rng = random.Random(1)
    spans, t = [], 0.0
    for i in range(500):
        a = t + rng.random()
        b = a + 3 * rng.random()
        spans.append((a, b, f"outer{i}"))
        if rng.random() < 0.3:
            spans.append((a + 0.1, a + 0.2, f"inner{i}"))
        t = b + rng.random()
    index = harness._SpanIndex(spans)
    for _ in range(2000):
        m = rng.random() * t
        holding = [sp for sp in spans if sp[0] <= m <= sp[1]]
        want = min(holding, key=lambda sp: sp[1] - sp[0])[2] if holding \
            else "outside harness spans"
        assert index.label(m) == want


def test_percentile_matches_statistics():
    import statistics
    vals = [random.Random(2).random() for _ in range(37)]
    q = statistics.quantiles(vals, n=20, method="inclusive")
    assert harness.percentile(vals, 95) == pytest.approx(q[18])
    assert harness.percentile([4.0], 95) == 4.0
