"""Tiny CPU runs of each cell through the whole harness (the port's plain
versions in place of its kernels): correct against the reference, the
result line with exactly the contract's keys, the controls and the planted
faults of the timed path seen as not correct, and no card, no result."""
import json

import pytest
import torch

from scbench import harness, run as run_py
from scbench.tests import _tiny

CELLS = [w["name"] for w in harness.benchmark()["workloads"]]
LINE_KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]
DEVICE = {"platform": "gpu", "kind": "stand-in", "count": 1,
          "memory_peak_bytes": 1}


@pytest.mark.parametrize("trace", [False, True], ids=["e2e", "traced"])
@pytest.mark.parametrize("cell", CELLS)
def test_tiny_run_is_correct_with_the_contracts_keys(cell, trace):
    record, line = _tiny.run(cell, trace=trace)
    assert record.correct, record.checks
    assert line["failed"] == 0 and line["attempted"] > 0
    want = {m["name"] for m in harness.metrics_for(harness.benchmark(), cell,
                                                   trace)}
    got = set(line["metrics"])
    if trace:
        # on the CPU no kernel runs: the kernel's roofline reads nothing
        want = {m for m in want
                if not m.startswith("fabric_egress.roofline_pct")}
    assert got == want
    out = harness.result_line(record, line, DEVICE)
    keys = LINE_KEYS[:5] + (["breakdown"] if trace else []) + ["checks"]
    assert list(out) == keys
    assert json.loads(json.dumps(out)) == out


def stale(step):
    first = []

    def f(slot, assign):
        got = step(slot, assign)
        first.append(got)
        return first[0]
    return f


def half_rows(step):
    def f(slot, assign):
        out, fault = (t.clone() for t in step(slot, assign))
        n = out.shape[0] // 2
        out[n:] = 0
        fault[n:] = 0
        return out, fault
    return f


def altered(step):
    def f(slot, assign):
        out, fault = step(slot, assign)
        out = out.clone()
        out[0, 0] ^= 1
        return out, fault
    return f


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("broken", [
    {"control": "range"},
    {"wrap_step": stale},
    {"wrap_step": half_rows},
    {"wrap_step": altered},
], ids=["control-range", "state-unchanged", "half-the-rows",
        "answer-altered"])
def test_broken_timed_path_is_not_correct(cell, broken):
    record, line = _tiny.run(cell, **broken)
    assert line["correct"] is False and line["failed"] > 0


def test_revocation_control_is_not_correct():
    record, line = _tiny.run("fabric255-churn", control="revocation")
    assert line["correct"] is False
    assert record.checks["word_mismatches"][0] > 0


def test_no_card_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run_py.main(["--workload", CELLS[0], "--seed", "1",
                        "--seconds", "1"]) == 1
    assert capsys.readouterr().out == ""


def test_misplaced_span_is_not_correct(monkeypatch):
    """A planted allocator fault: every span lands one host shard too far
    (in the next host's pages), which the kernel and the reference would
    otherwise agree on word for word.  (In the churn cell the FM refuses
    the first re-admit that overlaps, and the run stops with no result.)"""
    from repro_torch.core.fabric import ShardedFabric
    alloc = ShardedFabric._alloc_span

    def misplaced(self, host_id, n_pages):
        lo, hi = self.shard_range(host_id)
        return alloc(self, host_id, n_pages) + (hi - lo)
    monkeypatch.setattr(ShardedFabric, "_alloc_span", misplaced)
    record, line = _tiny.run("fabric255-gapbs")
    assert line["correct"] is False
    assert record.checks["grant_violations"][0] > 0
