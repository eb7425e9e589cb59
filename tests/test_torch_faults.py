"""Port parity: fault injection on the control plane (`repro_torch.core.
faults`, the bus's fault stash, the FM's scheduled crash, the fabric's
heartbeat monitor and crash/rejoin) against the JAX package.

Each scenario runs once through each package (the port on ``device="cpu"``)
with the same seeds and returns what it observed: fault-plan counters, the
fabric's ``stats()`` fault and bus counters, and every ``check()`` verdict
and fault code.  The two records must be equal, and each run also makes the
assertions of the reference's own test (``tests/test_faults.py``,
``tests/test_adversarial.py``)."""
import functools
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest

import repro.core as jcore
from repro.core.bus import ERROR_LEDGER_CAP as J_LEDGER_CAP
from repro.memsim import clock as jclock
import repro_torch.core as tcore
from repro_torch.core.bus import ERROR_LEDGER_CAP as T_LEDGER_CAP
from repro_torch.memsim import clock as tclock
from torch_parity import (CHAOS_SPEC, as_np, chaos_matrix, check_span,
                          fault_counters, mk_fabric, span_allowed, span_ext)

JAX = SimpleNamespace(
    core=jcore, clock=jclock, ledger_cap=J_LEDGER_CAP,
    Fabric=jcore.ShardedFabric, zeros=lambda n: jnp.zeros(n, bool))
PORT = SimpleNamespace(
    core=tcore, clock=tclock, ledger_cap=T_LEDGER_CAP,
    Fabric=functools.partial(tcore.ShardedFabric, device="cpu"),
    zeros=lambda n: np.zeros(n, bool))


def _both(scenario, *args, **kw):
    """Run ``scenario(P, *args, **kw)`` through both packages; the records must
    be equal.  Returns the port's record."""
    want = scenario(JAX, *args, **kw)
    got = scenario(PORT, *args, **kw)
    assert got == want
    return got


# ---------------------------------------------------------------------------
# FaultPlan primitives
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [1, 2, 3, 4, 5])
def test_fault_plan_copy_lists_match(seed):
    """One draw per copy (plus one on the delay band), the stash aged
    before the current copy's fate, released copies after it: the same
    copy lists, counters and stash sizes publish for publish."""
    def run(P):
        plan = P.core.FaultPlan(P.core.FaultSpec(**CHAOS_SPEC), seed=seed)
        log = []
        for ev in range(300):
            for h in range(4):
                log.append(plan.copies(h, ev))
            if ev % 37 == 36:
                log.append([plan.flush(h) for h in range(4)])
            log.append((plan.dropped, plan.duplicated, plan.delayed,
                        plan.stashed(), plan.stashed(2)))
        return log
    log = _both(run)
    assert sum(len(x) == 0 for x in log if isinstance(x, list)) > 0


def test_fault_plan_primitives_match():
    def run(P):
        plan = P.core.FaultPlan(P.core.FaultSpec(reorder_p=1.0), seed=0)
        e1, e2 = "e1", "e2"
        assert plan.copies(0, e1) == []
        assert plan.copies(0, e2) == [e1]
        assert plan.stashed(0) == 1
        assert plan.flush(0) == [e2] and plan.stashed() == 0
        crash = P.core.FaultPlan(fm_crash_epochs=(3, 5))
        fired = [crash.should_crash_fm(e) for e in (3, 3, 4, 5, 5)]
        for kw in ({"drop_p": 0.6, "dup_p": 0.6}, {"max_delay": 0}):
            with pytest.raises(ValueError):
                P.core.FaultSpec(**kw)
        return [fired, crash.fm_crashes]
    assert _both(run) == [[True, False, False, True, False], 2]


def test_lru_cache_matches():
    def run(P):
        c = P.core.LruCache(8 * 64)
        rng = np.random.default_rng(0)
        log = [c.access(int(k)) for k in rng.integers(0, 20, 400)]
        c.invalidate_range(range(5, 12))
        log += [c.access(int(k)) for k in rng.integers(0, 20, 100)]
        c.invalidate_all()
        log += [c.access(3), c.hits, c.misses, c.miss_ratio]
        with pytest.raises(ValueError):
            P.core.LruCache(100)
        return log
    _both(run)


# ---------------------------------------------------------------------------
# Sequence gaps, resync, FM crash, host crash, heartbeats
# ---------------------------------------------------------------------------

def _no_fault_path(P):
    fab, rts, tenants = mk_fabric(P)
    for h in range(4):
        fab.fm.revoke_hwpid(tenants[h][0])
    fab.quiesce()
    st = fab.stats()["faults"]
    assert st["desync_events"] == st["desynced"] == st["denied_desync"] == 0
    return fault_counters(fab)


def _dropped_event_resyncs(P):
    fab, rts, tenants = mk_fabric(P)
    pid1, start1 = tenants[1]
    log = [check_span(P, rts[1], pid1, start1)]
    fab.inject_faults(P.core.FaultPlan(P.core.FaultSpec(drop_p=1.0), seed=0))
    fab.fm.revoke_hwpid(pid1)
    fab.fm.bus.faults = None
    fab.fm.faults = None
    fab.fm.vacuum()
    fab.fm.bus.drain()
    assert rts[1].desynced and rts[1].desync_events == 1
    log.append(check_span(P, rts[1], pid1, start1))
    assert rts[1].resyncs == 1 and not rts[1].desynced
    pid0, start0 = tenants[0]
    log += [check_span(P, rts[0], pid0, start0),
            check_span(P, rts[0], pid0, start0)]
    assert all(log[-1][0]) and not any(log[1][0])
    return log + fault_counters(fab)


def _desync_fails_closed_then_snapshot(P):
    fab, rts, tenants = mk_fabric(P)
    pid1, start1 = tenants[1]
    pid0, start0 = tenants[0]
    fab.inject_faults(P.core.FaultPlan(P.core.FaultSpec(drop_p=1.0), seed=0))
    fab.fm.revoke_hwpid(pid1)
    fab.fm.bus.faults = None
    fab.fm.faults = None
    fab.fm.vacuum()
    fab.fm.bus.drain()
    fab.fm.crash()
    log = []
    for _ in range(70):
        allowed, fault = check_span(P, rts[1], pid0, start0)
        assert not any(allowed) and max(fault) == P.core.FAULT_DESYNC
        log.append((rts[1]._resync_wait, rts[1].quarantined))
    assert rts[1].quarantined and rts[1].denied_desync == 70
    with pytest.raises(P.core.FMUnavailable):
        fab.fm.vacuum()
    fab.fm.restart()
    fab.fm.bus.drain()
    assert rts[1].snapshot_resyncs == 1 and not rts[1].desynced
    log += [check_span(P, rts[1], pid1, start1),
            check_span(P, rts[0], pid0, start0),
            check_span(P, rts[0], pid0, start0)]
    assert not any(log[-3][0]) and all(log[-1][0])
    return log + fault_counters(fab)


def _reordered_copy_self_heals(P):
    fab, rts, tenants = mk_fabric(P, n_hosts=2)
    plan = fab.inject_faults(P.core.FaultPlan(P.core.FaultSpec(reorder_p=1.0),
                                              seed=0))
    fab.fm.revoke_hwpid(tenants[1][0])
    fab.fm.bus.faults = None
    fab.fm.faults = None
    fab.fm.vacuum()
    fab.fm.bus.faults = plan
    fab.fm.bus.drain()
    fab.fm.bus.faults = None
    assert all(rt.desync_events == 1 and rt.self_heals == 1 and
               not rt.desynced and rt.resyncs == 0 for rt in rts)
    log = [check_span(P, rts[0], *tenants[0]),
           check_span(P, rts[1], *tenants[1])]
    assert all(log[0][0]) and not any(log[1][0])
    return log + fault_counters(fab, plan)


def _duplicates_harmless(P):
    fab, rts, tenants = mk_fabric(P, n_hosts=2)
    plan = fab.inject_faults(P.core.FaultPlan(P.core.FaultSpec(dup_p=1.0),
                                              seed=0))
    fab.fm.revoke_hwpid(tenants[1][0])
    fab.quiesce()
    assert all(not rt.desynced for rt in rts)
    log = [check_span(P, rts[1], *tenants[1]),
           check_span(P, rts[0], *tenants[0])]
    assert not any(log[0][0]) and all(log[1][0])
    return log + fault_counters(fab, plan)


def _fm_crash_between_journal_and_broadcast(P):
    fab, rts, tenants = mk_fabric(P)
    pid1, start1 = tenants[1]
    crash_epoch = fab.fm.epoch + 1
    fab.inject_faults(P.core.FaultPlan(fm_crash_epochs=(crash_epoch,)))
    published0 = fab.fm.bus.published
    fab.fm.revoke_hwpid(pid1)
    assert fab.fm.crashed and fab.fm.bus.published == published0
    rec = fab.fm.journal[-1]
    assert rec.epoch == crash_epoch and not rec.broadcast
    assert ("discard", pid1) in rec.hwpid_ops
    log = [check_span(P, rts[1], pid1, start1)]
    with pytest.raises(P.core.FMUnavailable):
        fab.fm.revoke_hwpid(tenants[0][0])
    fab.fm.restart()
    assert fab.fm.journal[-1].broadcast
    log.append(sorted(fab.fm.hwpid_global()))
    fab.quiesce()
    log += [check_span(P, rts[1], pid1, start1),
            check_span(P, rts[0], *tenants[0])]
    assert not any(log[0][0]) and not any(log[2][0]) and all(log[3][0])
    assert all(rt.snapshot_resyncs == 1 for rt in rts)
    return log + fault_counters(fab)


def _host_crash_and_cold_rejoin(P):
    fab, rts, tenants = mk_fabric(P)
    pid2, start2 = tenants[2]
    log = [check_span(P, rts[2], pid2, start2)]
    fab.crash_host(2)
    with pytest.raises(RuntimeError):
        rts[2].check(span_ext(P, pid2, start2), P.zeros(8))
    fab.fm.revoke_hwpid(tenants[3][0])
    fab.quiesce()
    fab.rejoin_host(2)
    assert not rts[2].desynced
    log += [check_span(P, rts[2], pid2, start2),
            check_span(P, rts[3], *tenants[3]),
            int(rts[2].permcache.misses)]
    assert all(log[1][0]) and not any(log[2][0]) and log[3] > 0
    return log + fault_counters(fab)


def _heartbeat_monitor(P):
    fab, rts, tenants = mk_fabric(P, n_hosts=2)
    t = {"now": 0.0}
    fab.enable_host_monitor(timeout=10.0, clock=lambda: t["now"])
    log = [fab.dead_hosts()]
    t["now"] = 5.0
    rts[0].check(span_ext(P, *tenants[0]), P.zeros(8))
    t["now"] = 12.0
    log.append(fab.dead_hosts())
    fab.crash_host(1)
    log.append(fab.dead_hosts())
    fab.rejoin_host(1)
    log.append(fab.dead_hosts())
    # a delivered BISnp beats too: revoke, let time pass, deliver host 0
    fab.fm.revoke_hwpid(tenants[1][0])
    t["now"] = 30.0
    fab.deliver(0)
    log += [fab.dead_hosts(), fab.host_monitor.last_beat(0)]
    assert log[:4] == [[], [1], [], []] and log[4] == [1]
    return log


def _error_ledger(P):
    bus = P.core.BISnpBus(max_lag=None, max_handler_failures=10 ** 9)
    bus.attach(0, lambda ev: (_ for _ in ()).throw(RuntimeError("boom")))
    n = P.ledger_cap + 40
    for e in range(n):
        bus.publish(P.core.BISnpEvent(0, 4, epoch=e + 1))
        bus.deliver(0)
    assert bus.error_count == n and len(bus.errors) == P.ledger_cap
    fab, rts, tenants = mk_fabric(P, n_hosts=1)
    fab.fm.bus.attach(99, lambda ev: (_ for _ in ()).throw(
        RuntimeError("boom")))
    fab.fm.revoke_hwpid(tenants[0][0])
    fab.fm.bus.deliver(99)
    assert fab.stats()["bus"]["error_count"] == 1
    return [bus.error_count, len(bus.errors)] + fault_counters(fab)


def _wedged_consumer(P):
    bus = P.core.BISnpBus(max_lag=None, max_handler_failures=3)
    bus.attach(0, lambda ev: (_ for _ in ()).throw(RuntimeError("boom")))
    for e in range(1, 4):
        bus.publish(P.core.BISnpEvent(0, 4, epoch=e))
    with pytest.raises(RuntimeError, match="wedged"):
        bus.quiesce()
    bus2 = P.core.BISnpBus(max_lag=None, max_handler_failures=3)
    bus2.attach(0, lambda ev: (_ for _ in ()).throw(RuntimeError("boom")))
    bus2.publish(P.core.BISnpEvent(0, 4, epoch=1))
    bus2.quiesce()
    return [bus.error_count, bus2.error_count]


@pytest.mark.parametrize("scenario", [
    _no_fault_path, _dropped_event_resyncs,
    _desync_fails_closed_then_snapshot, _reordered_copy_self_heals,
    _duplicates_harmless, _fm_crash_between_journal_and_broadcast,
    _host_crash_and_cold_rejoin, _heartbeat_monitor, _error_ledger,
    _wedged_consumer], ids=lambda f: f.__name__.strip("_"))
def test_fault_scenario_matches(scenario):
    _both(scenario)


# ---------------------------------------------------------------------------
# Clocked mode: link degradation + outages
# ---------------------------------------------------------------------------

def _link_outage_and_degrade(P):
    cf = P.clock.ClockedFabric(P.clock.TimingConfig(jitter=0))
    base = cf.topo.downlink(0).send(0, 64)
    lk = cf.topo.downlink(1)
    lk.outages = [(0, 500)]
    out = lk.send(0, 64)
    assert out >= 500 + lk.occupancy(64) and lk.outage_waits == 1
    occ0 = lk.occupancy(64)
    lk.degrade_factor = 2.0
    return [base, out, occ0, lk.occupancy(64), lk.send(600, 64),
            lk.stats(), cf.stats()]


def _clocked_link_faults_converge(P):
    cf = P.clock.ClockedFabric(P.clock.TimingConfig(jitter=0))
    fab = P.Fabric(sdm_pages=1 << 14, table_capacity=2048, n_shards=2,
                   clock=cf)
    rts = [fab.enroll(h) for h in range(2)]
    tenants = {h: fab.admit(h, 16) for h in range(2)}
    fab.inject_faults(P.core.FaultPlan(link_faults={
        1: P.core.LinkFault(degrade=4.0, outages=((0, 2000),))}))
    fab.fm.revoke_hwpid(tenants[1][0])
    fab.quiesce()
    assert all(not rt.desynced for rt in rts)
    log = [check_span(P, rts[1], *tenants[1]),
           check_span(P, rts[0], *tenants[0])]
    assert not any(log[0][0]) and all(log[1][0])
    assert cf.topo.downlink(1).outage_waits >= 1
    return log + [cf.now, fab.fm.bus.timeline, cf.stats()] + \
        fault_counters(fab)


@pytest.mark.parametrize("scenario", [_link_outage_and_degrade,
                                      _clocked_link_faults_converge],
                         ids=lambda f: f.__name__.strip("_"))
def test_clocked_fault_scenario_matches(scenario):
    _both(scenario)


# ---------------------------------------------------------------------------
# The acceptance matrix, side by side
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [1, 2, 3, 4, 5])
def test_chaos_matrix_matches_with_zero_stale_reads(seed):
    _both(chaos_matrix, seed)


# ---------------------------------------------------------------------------
# Adversarial fault streams (tests/test_adversarial.py)
# ---------------------------------------------------------------------------

def _targeted_drop(P, host_id, page):
    """A plan that suppresses exactly the copies covering one page on one
    host (an adversary choosing which event of a multi-range commit to
    lose)."""
    class TargetedDrop(P.core.FaultPlan):
        def copies(self, h, ev):
            if h == host_id and \
                    ev.start_page <= page < ev.start_page + ev.n_pages:
                self.dropped += 1
                return []
            return [ev]
    return TargetedDrop(P.core.FaultSpec())


def _partial_multirange_drop(P):
    fab = P.Fabric(sdm_pages=1 << 14, table_capacity=2048, n_shards=1)
    rt = fab.enroll(0)
    pid, start_a = fab.admit(0, 8)
    other, start_o = fab.admit(0, 8)
    start_b = 4096
    assert fab.fm.propose(P.core.Proposal(0, pid, 0x1000 + pid, start_b, 8,
                                          P.core.PERM_RW)) is not None
    fab.quiesce()
    log = []
    for start in (start_a, start_b):
        log += [check_span(P, rt, pid, start), check_span(P, rt, pid, start)]
    fab.inject_faults(_targeted_drop(P, 0, start_a))
    fab.fm.revoke_hwpid(pid)
    fab.fm.bus.faults = None
    fab.fm.faults = None
    fab.fm.bus.drain()
    assert int(rt.permcache.epoch) == fab.fm.epoch
    cached = set(as_np(rt.permcache.tag).ravel().tolist())
    assert any(start_a + i in cached for i in range(8))
    assert rt.desynced and rt.desync_events == 1
    log.append(check_span(P, rt, pid, start_a))
    assert rt.resyncs == 1 and not rt.desynced
    log += [check_span(P, rt, pid, start_a), check_span(P, rt, pid, start_b),
            check_span(P, rt, other, start_o)]
    assert not any(log[-4][0] + log[-3][0] + log[-2][0])
    assert all(log[-1][0])
    return log + fault_counters(fab)


def _faulted_stream_sweep(P, seed):
    rng = np.random.default_rng(seed)
    fab = P.Fabric(sdm_pages=1 << 14, table_capacity=2048, n_shards=2)
    rts = [fab.enroll(h) for h in range(2)]
    victim = {h: fab.admit(h, 16) for h in range(2)}
    fab.quiesce()
    plan = fab.inject_faults(P.core.FaultPlan(
        P.core.FaultSpec(drop_p=0.30, dup_p=0.30, delay_p=0.25, max_delay=2),
        seed=seed))
    for h in range(2):
        fab.evict(h, victim[h][0])
    fab.fm.vacuum()
    regrant = {h: fab.admit(h, 16) for h in range(2)}
    for h in range(2):
        assert regrant[h][1] == victim[h][1]
        assert regrant[h][0] != victim[h][0]
    log = []
    for rnd in range(8):
        for h in range(2):
            if rng.random() < 0.7:
                fab.deliver(h, int(rng.integers(1, 3)))
            allowed, fault = check_span(P, rts[h], *victim[h], 4)
            assert not any(allowed), (seed, rnd, h)
            log.append(fault)
    fab.quiesce()
    fab.fm.bus.faults = None
    fab.fm.faults = None
    fab.fm.restart()
    fab.quiesce()
    assert plan.dropped + plan.duplicated + plan.delayed > 0
    for h in range(2):
        log += [check_span(P, rts[h], *victim[h], 4),
                check_span(P, rts[h], *regrant[h], 4)]
        assert not any(log[-2][0]) and all(log[-1][0])
    return log + fault_counters(fab, plan)


def test_partial_multirange_drop_matches():
    _both(_partial_multirange_drop)


@pytest.mark.parametrize("seed", [11, 12, 13, 14, 15])
def test_faulted_stream_sweep_matches(seed):
    _both(_faulted_stream_sweep, seed)
