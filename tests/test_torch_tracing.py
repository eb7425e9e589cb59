"""The port's span recorder (`repro_torch.tracing`) and the spans it
records inside the fabric's view re-derivation and the FM's commit fan-out:
off by default and free of records, nesting and parents when on, one span
of each kind per re-derivation, epoch and quiesce, none on a memo hit, the
stacked view bit-identical with the recorder on or off, and the fabric's
`view_builds`, `views_kept` and `rows_restacked` counters."""
import numpy as np
import pytest
import torch

from repro_torch import tracing
from repro_torch.core import ShardedFabric, pack_ext_addr
from repro_torch.kernels.permcheck import ShardViewCache

REBUILD = ("fabric.view_rebuild", "fabric.shard_extract",
           "fabric.shard_views", "fabric.stack_views")
N_HOSTS, SPAN, B = 4, 16, 64


@pytest.fixture(autouse=True)
def recorder_off():
    tracing.disable()
    tracing.take()
    yield
    tracing.disable()
    tracing.take()


def names(spans):
    return [s.name for s in spans]


def deployment():
    """Four hosts, two tenants on host 0 and one on each other host, every
    commit delivered; returns (fabric, assignment, data, ext)."""
    fab = ShardedFabric(1 << 12, 256, N_HOSTS, device="cpu")
    for h in range(N_HOSTS):
        fab.enroll(h)
    assign = {0: [fab.admit(0, SPAN)[0], fab.admit(0, SPAN)[0]]}
    for h in range(1, N_HOSTS):
        assign[h] = fab.admit(h, SPAN)[0]
    fab.quiesce()
    rows = fab.fabric_rows(assign)
    rng = np.random.default_rng(5)
    data = rng.integers(0, 1 << 32, (len(rows), B), dtype=np.uint64) \
        .astype(np.uint32)
    ext = np.zeros((len(rows), B), np.int32)
    for i, (_, pid) in enumerate(rows):
        start = fab._grants[pid][1]
        ext[i] = np.asarray(pack_ext_addr(
            np.full(B, pid), start + rng.integers(-4, SPAN + 4, B)))
    return fab, assign, data, ext


def churn(fab, assign):
    """Evict host 1's tenant and admit its replacement, revoke host 2's
    tenant, each fenced by a quiesce; returns the new assignment."""
    fab.evict(1, assign[1])
    assign = {**assign, 1: fab.admit(1, SPAN)[0]}
    fab.quiesce()
    fab.fm.revoke_hwpid(assign[2])
    fab.quiesce()
    return assign


def view_fields(view):
    return [getattr(view, f) for f in view._fields]


def assert_views_equal(a, b):
    for x, y in zip(view_fields(a), view_fields(b)):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y)
        else:
            assert x == y


def test_off_records_nothing_and_returns_the_shared_noop():
    first = tracing.span("a")
    assert tracing.span("b") is first
    with first:
        with tracing.span("c"):
            pass
    assert tracing.take() == []


def test_on_records_names_nesting_and_parents_and_take_clears():
    tracing.enable()
    with tracing.span("outer"):
        with tracing.span("inner"):
            pass
        with tracing.span("second"):
            with tracing.span("deep"):
                pass
    with tracing.span("after"):
        pass
    spans = tracing.take()
    assert names(spans) == ["outer", "inner", "second", "deep", "after"]
    assert [s.parent for s in spans] == [-1, 0, 0, 2, -1]
    for s in spans:
        assert 0 < s.start_ns <= s.end_ns
    outer, inner, second, deep, after = spans
    assert outer.start_ns <= inner.start_ns <= inner.end_ns \
        <= second.start_ns <= deep.start_ns <= deep.end_ns \
        <= second.end_ns <= outer.end_ns <= after.start_ns
    assert tracing.take() == []
    tracing.disable()
    with tracing.span("off again"):
        pass
    assert tracing.take() == []


def test_take_refuses_while_a_span_is_open():
    tracing.enable()
    with tracing.span("open"):
        with pytest.raises(RuntimeError):
            tracing.take()
    assert names(tracing.take()) == ["open"]


def test_spans_are_profiler_ranges():
    tracing.enable()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tracing.span("fabric.view_rebuild"):
            torch.ones(4).sum()
    got = {e.name for e in prof.events()}
    assert tracing.PREFIX + "fabric.view_rebuild" in got


def test_commit_then_step_records_one_rebuild_split_and_a_memo_hit_none():
    fab, assign, data, ext = deployment()
    fab.step_egress(data, ext, assign)
    tracing.enable()
    fab.step_egress(data, ext, assign)              # memo hit
    assert tracing.take() == []
    fab.evict(3, assign[3])
    assign = {**assign, 3: fab.admit(3, SPAN)[0]}
    fab.quiesce()
    tracing.take()
    fab.step_egress(data, ext, assign)
    spans = tracing.take()
    assert names(spans) == list(REBUILD)
    assert [s.parent for s in spans] == [-1, 0, 0, 0]
    fab.step_egress(data, ext, assign)              # memo hit again
    assert tracing.take() == []


def test_each_epoch_records_one_fm_commit_and_each_quiesce_one_bus_quiesce():
    fab, assign, _, _ = deployment()
    tracing.enable()
    epoch = fab.fm.epoch
    fab.evict(1, assign[1])                         # one epoch
    new = fab.admit(1, SPAN)[0]                     # one epoch
    fab.fm.revoke_hwpid(new)                        # one epoch
    with fab.fm.transaction():                      # one epoch for both
        fab.admit(2, SPAN)
        fab.admit(3, SPAN)
    fab.quiesce()
    fab.quiesce()                                   # nothing left to deliver
    spans = tracing.take()
    assert fab.fm.epoch - epoch == 4
    assert names(spans).count("fm.commit") == 4
    assert names(spans).count("bus.quiesce") == 2
    assert all(s.parent == -1 for s in spans)


def test_stacked_view_is_bit_identical_with_the_recorder_on_and_off():
    runs = []
    for on in (False, True):
        fab, assign, data, ext = deployment()
        if on:
            tracing.enable()
        got = [fab.fabric_view(assign)]
        assign = churn(fab, assign)
        got.append(fab.fabric_view(assign))
        outs = fab.step_egress(data, ext, assign)
        tracing.disable()
        runs.append((got, outs))
    (views_off, outs_off), (views_on, outs_on) = runs
    for a, b in zip(views_off, views_on):
        assert_views_equal(a, b)
    for a, b in zip(outs_off, outs_on):
        assert torch.equal(a, b)


def test_view_after_churn_equals_a_fresh_rebuild():
    fab, assign, _, _ = deployment()
    tracing.enable()
    fab.fabric_view(assign)
    assign = churn(fab, assign)
    after = fab.fabric_view(assign)
    for rt in fab.runtimes.values():               # drop every memo layer
        rt._shard_epoch = -1
        rt.views = ShardViewCache()
    fab._fabric_view_key = None
    assert_views_equal(after, fab.fabric_view(assign))


def test_stats_view_builds_counts_the_builds():
    fab, assign, data, ext = deployment()
    n_rows = len(fab.fabric_rows(assign))
    assert fab.stats()["view_builds"] == 0
    fab.step_egress(data, ext, assign)
    assert fab.stats()["view_builds"] == n_rows
    fab.step_egress(data, ext, assign)              # memo hit: no build
    assert fab.stats()["view_builds"] == n_rows
    assign = churn(fab, assign)
    assert fab.stats()["view_builds"] == n_rows     # stats() builds nothing
    fab.step_egress(data, ext, assign)
    # host 1's replacement (its view was dropped with the evicted tenant)
    # and host 2's revoked shard build; the other rows' views are carried
    assert fab.stats()["view_builds"] == n_rows + 2


def counters(fab):
    st = fab.stats()
    return st["view_builds"], st["views_kept"], st["rows_restacked"]


def test_churn_builds_the_changed_rows_and_keeps_the_rest():
    fab, assign, data, ext = deployment()
    n_rows = len(fab.fabric_rows(assign))
    fab.step_egress(data, ext, assign)
    assert counters(fab) == (n_rows, 0, n_rows)   # one full stack
    assign = churn(fab, assign)
    fab.step_egress(data, ext, assign)
    assert counters(fab) == (n_rows + 2, n_rows - 2, n_rows + 2)
    # host 2's tenant is revoked already: only host 1's replacement builds
    assign = churn(fab, assign)
    fab.step_egress(data, ext, assign)
    assert counters(fab) == (n_rows + 3, 2 * n_rows - 3, n_rows + 3)


def test_a_memo_hit_and_stats_change_no_counter():
    fab, assign, data, ext = deployment()
    fab.step_egress(data, ext, assign)
    before = counters(fab)
    fab.step_egress(data, ext, assign)              # memo hit
    fab.fabric_view(assign)
    assert counters(fab) == before
    assign = churn(fab, assign)
    fab.stats()
    assert counters(fab) == before                  # stats() builds nothing
    assert all(rt._shard_epoch < fab.fm.table.epoch
               for rt in fab.runtimes.values())


def test_a_commit_that_changes_no_row_builds_and_writes_nothing():
    """Rows on hosts 0-2 only; a tenant admitted on host 3 changes no
    row's shard: every view is carried, no row is written, and the new
    stacked view shares the last one's ``hwpids``."""
    fab, assign, data, ext = deployment()
    del assign[3]
    first = fab.fabric_view(assign)
    before = counters(fab)
    fab.admit(3, SPAN)
    fab.quiesce()
    after = fab.fabric_view(assign)
    n_rows = len(fab.fabric_rows(assign))
    assert counters(fab) == (before[0], before[1] + n_rows, before[2])
    assert after.epoch == fab.fm.table.epoch > first.epoch
    assert after.hwpids is first.hwpids
    for f in ("starts", "ends", "permbits", "tile_min", "tile_max"):
        assert torch.equal(getattr(after, f), getattr(first, f))
        assert getattr(after, f) is not getattr(first, f)


def test_a_patched_rebuild_records_the_four_spans():
    fab, assign, data, ext = deployment()
    fab.step_egress(data, ext, assign)
    assign = churn(fab, assign)
    restacked = counters(fab)[2]
    tracing.enable()
    fab.step_egress(data, ext, assign)
    spans = tracing.take()
    assert names(spans) == list(REBUILD)
    assert [s.parent for s in spans] == [-1, 0, 0, 0]
    assert counters(fab)[2] == restacked + 2        # patched, not restacked
