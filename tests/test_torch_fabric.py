"""Port parity: the control plane and the fabric (`repro_torch.core.bus`,
`fm`, `space`, `fabric`) against the JAX package — the BISnp bus, the FM's
journal across a crash and restart, multi-tenant revocation isolation, and
one whole `ShardedFabric` scenario (enroll, admit, quiesce, step, evict,
quiesce, step, the FAULT_DESYNC gate) run through both packages with equal
outputs, faults, checker results and `stats()`."""
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import ShardedFabric as JFabric
from repro.core.bus import BISnpBus as JBus
from repro.core.fm import BISnpEvent as JEvent
from repro.core.fm import FabricManager as JFM
from repro.core.fm import Proposal as JProposal
from repro_torch.core import (FAULT_DESYNC, PERM_R, PERM_RW, BISnpBus,
                              BISnpEvent, FabricManager, FMUnavailable,
                              Proposal, ShardedFabric, pack_ext_addr)
from repro_torch.core.fabric import patch_views, stack_views
from repro_torch.kernels.permcheck import make_shard_view
from torch_parity import (LIFECYCLE_EVENTS, assert_equal,
                          assert_fabric_view_layout,
                          assert_fabric_views_equal, assert_u32_equal,
                          fresh_fabric_view, lifecycle_deployment,
                          lifecycle_event, lifecycle_ext, words)

CHECK_FIELDS = ("allowed", "fault", "entry_idx", "probes")


def test_bus_delivery_matches():
    """Same publish/deliver schedule on both buses: same delivery order per
    host, forced deliveries under the lag bound, and error isolation."""
    logs = []
    for bus, event in ((JBus(max_lag=3), JEvent), (BISnpBus(max_lag=3),
                                                   BISnpEvent)):
        log = []
        for h in range(3):
            def handler(ev, h=h):
                if h == 2 and ev.epoch == 4:
                    raise RuntimeError("handler fault")
                log.append((h, ev.epoch, ev.seq))
            bus.attach(h, handler)
        for e in range(1, 9):
            bus.publish(event(e, 1, epoch=e))
            bus.deliver(e % 3, 1)
        assert bus.max_observed_lag() <= 3
        bus.quiesce()
        logs.append((log, bus.published, bus.delivered,
                     bus.forced_deliveries, bus.error_count, bus.hosts))
    assert logs[0] == logs[1]


def test_fm_journal_crash_restart_matches():
    """Grants, a revoke, a range release and a vacuum, then an FM crash and
    restart: the table, journal, audit log, HWPID liveness and published
    events agree between the packages, and a crashed FM refuses work."""
    seen = []
    for fm_cls, proposal in ((JFM, JProposal), (FabricManager, Proposal)):
        fm = fm_cls(1 << 12, 64)
        events = []
        fm.bus.attach(0, lambda ev: events.append(
            (ev.start_page, ev.n_pages, ev.epoch, ev.min_entry_idx, ev.seq,
             ev.snapshot)))
        fm.enroll_host(0)
        fm.enroll_host(1)
        labels = [fm.propose(proposal(h, p, 0x100 + p, s, n, perm))
                  for h, p, s, n, perm in [(0, 1, 0, 64, PERM_RW),
                                           (1, 2, 64, 64, PERM_R),
                                           (0, 3, 32, 64, PERM_RW)]]
        with fm.transaction():
            fm.revoke_hwpid(2)
            fm.release_range(3, 40, 8)
        fm.vacuum()
        fm.crash()
        with pytest.raises(Exception):
            fm.propose(proposal(0, 4, 0, 200, 8, PERM_R))
        fm.restart()
        fm.bus.quiesce()
        t = fm.table
        seen.append((labels, t.starts.tolist(), t.sizes.tolist(),
                     t.perms.tolist(), t.n, t.epoch,
                     [(r.epoch, r.ranges, r.min_entry_idx, r.hwpid_ops,
                       r.broadcast) for r in fm.journal],
                     fm.audit_log, sorted(fm.hwpid_global()), events,
                     fm.sync_host(0), fm.tombstone_count()))
    assert seen[0] == seen[1]
    fm = FabricManager(64, 8)
    fm.crash()
    with pytest.raises(FMUnavailable):
        fm.sync_host(0)


def _both_fabrics(**kwargs):
    return JFabric(**kwargs), ShardedFabric(device="cpu", **kwargs)


def _port_stats(tfab, jfab, *, built, kept, restacked):
    """The port's `stats()` without its own keys, which are first held to
    the counts the test's commits make: ``view_builds`` views built,
    ``views_kept`` views carried to a new epoch unbuilt (together the JAX
    fabric's `ShardView` re-resolutions) and ``rows_restacked`` rows
    written into stacked views."""
    st = tfab.stats()
    assert (st.pop("view_builds"), st.pop("views_kept"),
            st.pop("rows_restacked")) == (built, kept, restacked)
    assert built + kept == sum(
        rt.views.rebuilds for rt in jfab.runtimes.values())
    return st


def _check_equal(jrt, trt, ext, wr):
    jr = jrt.check(jnp.asarray(ext), jnp.asarray(wr))
    tr = trt.check(ext, wr)
    for f in CHECK_FIELDS:
        assert_equal(getattr(jr, f), getattr(tr, f))
    return tr


def test_multi_tenant_rows_isolate_revocation():
    """Two co-resident tenants on host 0 and one on host 1: both packages
    give the same words and faults on every row; revoking one tenant zeroes
    exactly its row while its neighbour's words are bit-identical."""
    rng = np.random.default_rng(3)
    fabs = _both_fabrics(sdm_pages=1 << 14, table_capacity=2048, n_shards=4)
    tenants = []
    for fab in fabs:
        for h in range(4):
            fab.enroll(h)
        tenants.append([fab.admit(0, 48), fab.admit(0, 48), fab.admit(1, 48)])
        fab.quiesce()
    assert tenants[0] == tenants[1]
    (t00, _), (t01, _), (t10, _) = tenants[0]
    spans = {p: s for p, s in tenants[0]}
    assign = {0: [t00, t01], 1: [t10]}
    rows = fabs[1].fabric_rows(assign)
    assert rows == fabs[0].fabric_rows(assign) == [(0, t00), (0, t01),
                                                   (1, t10)]
    b = 256
    data = words(rng, (3, b))
    ext = np.zeros((3, b), np.int32)
    for i, (_, pid) in enumerate(rows):
        tags = np.full(b, pid, np.int32)
        tags[::19] = 0
        ext[i] = np.asarray(pack_ext_addr(tags, spans[pid] +
                                          rng.integers(-8, 56, b)))
    steps = []
    for fab in fabs:
        before = fab.step_egress(data, ext, assign, need=1)
        fab.fm.revoke_hwpid(t00)
        fab.quiesce()
        steps.append((before, fab.step_egress(data, ext, assign, need=1)))
    for jstep, tstep in zip(*steps):
        assert_u32_equal(jstep[0], tstep[0])
        assert_equal(jstep[1], tstep[1])
    (out, fault), (out2, fault2) = steps[1]
    assert bool((out2[0] == 0).all()) and bool((fault2[0] > 0).all())
    assert_equal(out2[1], out[1])
    assert_equal(fault2[2], fault[2])
    tr = fabs[1].runtimes[0].check(ext[0], np.zeros(b, bool))
    assert not bool(tr.allowed.any())


def test_sharded_fabric_scenario_matches_jax():
    """One deployment driven identically through both packages: enroll,
    admit (one host with a shard spanning tiles), quiesce, egress step,
    evict + quiesce, step, checks through the PermCache (a cold and a warm
    batch), then a BISnp sequence gap with the FM down — the host fails
    closed with FAULT_DESYNC until the FM restarts — and `stats()`."""
    rng = np.random.default_rng(7)
    fabs = _both_fabrics(sdm_pages=1 << 14, table_capacity=4096,
                         n_shards=4)
    admitted = []
    for fab in fabs:
        for h in range(4):
            fab.enroll(h)
        got = [fab.admit(0, 48), fab.admit(0, 48), fab.admit(1, 48),
               fab.admit(2, 1000)]
        proposal = Proposal if isinstance(fab, ShardedFabric) else JProposal
        with fab.fm.transaction():           # host 3: a 2-tile shard
            for k in range(1100):
                fab.fm.propose(proposal(3, 120, 0, 3 * (1 << 12) + 2 * k, 1,
                                        PERM_R))
        fab.runtimes[3]._grant_installed(120)
        fab.quiesce()
        admitted.append(got)
    assert admitted[0] == admitted[1]
    spans = {pid: (s, n) for (pid, s), n in zip(admitted[0],
                                                (48, 48, 48, 1000))}
    spans[120] = (3 * (1 << 12), 2200)
    pids = [p for p, _ in admitted[0]]
    assign = {0: pids[:2], 1: pids[2], 2: pids[3], 3: 120}
    rows = fabs[1].fabric_rows(assign)
    b = 1500
    data = words(rng, (len(rows), b))
    ext = np.zeros((len(rows), b), np.int32)
    for i, (_, pid) in enumerate(rows):
        s, n = spans[pid]
        tags = np.full(b, pid, np.int32)
        tags[::19], tags[5::23] = 0, 9
        ext[i] = np.asarray(pack_ext_addr(tags, s + rng.integers(-8, n + 8,
                                                                 b)))
    wr = rng.random(b) < 0.2
    outs = []
    for fab in fabs:
        got = [fab.step_egress(data, ext, assign, need=1)]
        fab.evict(0, pids[0])
        fab.quiesce()
        got.append(fab.step_egress(data, ext, assign, need=2))
        outs.append(got)
    for (jo, jf), (to, tf) in zip(*outs):
        assert_u32_equal(jo, to)
        assert_equal(jf, tf)
    assert bool((outs[1][1][1][0] > 0).all())      # evicted row: all denied
    jfab, tfab = fabs
    for h, row in ((0, 1), (2, 3), (3, 4)):
        for _ in range(2):                         # cold, then warm cache
            _check_equal(jfab.runtimes[h], tfab.runtimes[h], ext[row], wr)
    # desync gate: a sequence gap while the FM is down fails closed
    for fab, event in ((jfab, JEvent), (tfab, BISnpEvent)):
        rt = fab.runtimes[1]
        rt.on_bisnp(event(0, 0, epoch=fab.fm.epoch,
                          seq=rt._expected_seq + 2))
        fab.fm.crash()
    tr = _check_equal(jfab.runtimes[1], tfab.runtimes[1], ext[2], wr)
    assert tr.fault.tolist() == [FAULT_DESYNC] * b
    for fab in fabs:
        fab.fm.restart()
        fab.quiesce()
    _check_equal(jfab.runtimes[1], tfab.runtimes[1], ext[2], wr)
    # 5 rows built and stacked; the evict changes host 0's shard, so its
    # 2 rows build and are written again, hosts 1-3 carry their 3 views
    assert jfab.stats() == _port_stats(tfab, jfab, built=7, kept=3,
                                       restacked=7)
    assert jfab.storage_overhead() == tfab.storage_overhead()
    assert (jfab.view_rebuilds, jfab.view_reuses) == \
        (tfab.view_rebuilds, tfab.view_reuses)


def test_shared_residency_and_churn_match():
    """grant_shared pins a region resident on the grantee's host, evict
    releases it, and mixed-size admit/evict churn reuses coalesced spans:
    shard sizes, spans, free pages and verdicts agree with the JAX package."""
    rng = np.random.default_rng(11)
    fabs = _both_fabrics(sdm_pages=1 << 12, table_capacity=256, n_shards=4)
    seen = []
    for fab in fabs:
        for h in range(4):
            fab.enroll(h)
        pid, _ = fab.admit(1, 16)
        fab.grant_shared(3000, 64, pid, 1, perm=PERM_R)
        fab.quiesce()
        got = [fab.runtimes[1].shard_entries(), fab.runtimes[1]
               .resident_ranges()]
        fab.evict(1, pid)
        fab.quiesce()
        got += [fab.runtimes[1].shard_entries(),
                fab.runtimes[1].resident_ranges()]
        live = []
        for size in (40, 8, 100, 24, 8, 200):
            live.append(fab.admit(0, size))
            if len(live) > 2:
                fab.evict(0, live.pop(1)[0])
        fab.quiesce()
        got += [live, fab.free_pages(0), fab.vacuums,
                _port_stats(fab, fabs[0], built=0, kept=0, restacked=0)
                if fab is fabs[1] else fab.stats()]
        seen.append(got)
    assert seen[0] == seen[1]
    pid, start = seen[1][4][-1]
    ext = np.asarray(pack_ext_addr(np.full(300, pid),
                                   start + rng.integers(-20, 220, 300)))
    _check_equal(fabs[0].runtimes[0], fabs[1].runtimes[0], ext,
                 np.zeros(300, bool))


def test_crash_host_bricks_and_rejoin_is_cold():
    """A crashed host refuses checks; a rejoined one answers again from a
    cold cache (this host holds no grant, so it denies)."""
    fab = ShardedFabric(1 << 10, 64, 2, device="cpu")
    fab.enroll(0)
    fab.crash_host(0)
    with pytest.raises(RuntimeError):
        fab.runtimes[0].check(np.zeros(4, np.int32), np.zeros(4, bool))
    fab.rejoin_host(0)
    assert not bool(fab.runtimes[0].check(np.zeros(4, np.int32),
                                          np.zeros(4, bool)).allowed.any())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_incremental_fabric_view_equals_a_fresh_derivation(seed):
    """A seeded sequence of lifecycle events (evict and re-admit, revoke,
    evict of the revoked tenant, admit into a new span, a shared grant and
    its release, a hole inside a grant, vacuum, host crash and rejoin, FM
    crash and restart) through both packages: after each, the port's
    stacked view, carried and patched, equals one derived from scratch bit
    for bit, every row meets the search layout, and the step's words and
    faults equal the JAX fabric's."""
    rng = np.random.default_rng(seed)
    fabs = _both_fabrics(sdm_pages=1 << 14, table_capacity=4096,
                         n_shards=4)
    states = [lifecycle_deployment(fab, proposal)
              for fab, proposal in zip(fabs, (JProposal, Proposal))]
    jfab, tfab = fabs
    picks = rng.integers(0, 1 << 30, len(LIFECYCLE_EVENTS))
    for kind, pick in zip((None,) + LIFECYCLE_EVENTS, (0, *picks)):
        if kind is not None:
            for fab, state in zip(fabs, states):
                lifecycle_event(fab, state, kind, int(pick))
        assert states[0] == states[1], kind
        assign = states[1]["assign"]
        view = tfab.fabric_view(assign)
        assert_fabric_views_equal(view, fresh_fabric_view(tfab, assign))
        assert_fabric_view_layout(view)
        ext = lifecycle_ext(rng, tfab, states[1], 128)
        data = words(rng, ext.shape)
        jout, jfault = jfab.step_egress(data, ext, assign)
        tout, tfault = tfab.step_egress(data, ext, assign)
        assert_u32_equal(jout, tout)
        assert_equal(jfault, tfault)
    st = tfab.stats()
    assert st["view_builds"] < st["view_builds"] + st["views_kept"] == sum(
        rt.views.rebuilds for rt in jfab.runtimes.values())


def _view(rng, n, hwpid):
    """A ShardView of ``n`` sorted entries, the permbits of ``hwpid``."""
    bounds = np.sort(rng.choice(1 << 16, 2 * n, replace=False))
    return make_shard_view(bounds[0::2], bounds[1::2],
                           rng.integers(0, 4, n).astype(np.uint32),
                           epoch=hwpid, device="cpu")


def test_patch_views_writes_changed_rows_and_refuses_other_padding():
    """A patch equals `stack_views` of the new views where a row's view
    shrinks from two tiles to one under the same padding, where rows
    trade places, and where only the HWPIDs move; the base stays as it
    was; a new row count or padding is refused."""
    rng = np.random.default_rng(4)
    a, b, c = _view(rng, 1100, 1), _view(rng, 30, 2), _view(rng, 5, 3)
    big = _view(rng, 1500, 4)
    base = stack_views([a, b, c], [1, 2, 3], [0, 1, 2], epoch=7)
    kept = base._replace(**{f: getattr(base, f).clone()
                            for f in base._fields[:6]})
    cases = [([c, b, big], [3, 2, 4], (2, 1, 2), 2),   # a shrinks, c moves
             ([b, a, c], [2, 1, 3], (1, 0, 2), 2),     # two rows trade
             ([a, b, c], [5, 2, 3], (0, 1, 2), 0)]     # the HWPIDs alone
    for views, hwpids, hosts, n_written in cases:
        got, written = patch_views(base, [a, b, c], [1, 2, 3], views,
                                   hwpids, hosts, epoch=8)
        assert written == n_written
        assert_fabric_views_equal(got, stack_views(views, hwpids, hosts,
                                                   epoch=8))
    assert_fabric_views_equal(base, kept)
    assert patch_views(base, [a, b, c], [1, 2, 3], [a, b], [1, 2], (0, 1),
                       epoch=8) is None
    assert patch_views(base, [a, b, c], [1, 2, 3], [b, b, c], [2, 2, 3],
                       (0, 1, 2), epoch=8) is None
