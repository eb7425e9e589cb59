"""Port parity: the memsim (`repro_torch.memsim.clock`, `lru`, `replay`,
`model`), the clocked BISnp bus and fabric timing traces against the JAX
package.

The memsim is host-side numpy in both packages, so integer state, cycle
counts and schedules must match exactly and floats within 1e-12.  The
clocked fabric must leave every host's PermCache as the reference's does
and as the manually pumped bus does; a small traced fabric must give the
reference's trace JSON, replay report and timing penalty."""
import dataclasses
import functools
import importlib
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest

import repro.core as jcore
from repro.memsim import clock as jclock
from repro.memsim import lru as jlru
from repro.memsim import model as jmodel
from repro.workloads import gapbs as jgapbs
from repro.workloads import graphs as jgraphs
import repro_torch.core as tcore
from repro_torch.memsim import clock as tclock
from repro_torch.memsim import lru as tlru
from repro_torch.memsim import model as tmodel
from repro_torch.workloads import gapbs as tgapbs
from repro_torch.workloads import graphs as tgraphs
from torch_parity import as_np, traced_fabric

# the packages' ``memsim.replay`` names the function; these are the modules
jreplay = importlib.import_module("repro.memsim.replay")
treplay = importlib.import_module("repro_torch.memsim.replay")

JAX = SimpleNamespace(core=jcore, clock=jclock, replay=jreplay, lru=jlru,
                      model=jmodel, gapbs=jgapbs, graphs=jgraphs,
                      Fabric=jcore.ShardedFabric,
                      zeros=lambda n: jnp.zeros(n, bool))
PORT = SimpleNamespace(core=tcore, clock=tclock, replay=treplay, lru=tlru,
                       model=tmodel, gapbs=tgapbs, graphs=tgraphs,
                       Fabric=functools.partial(tcore.ShardedFabric,
                                                device="cpu"),
                       zeros=lambda n: np.zeros(n, bool))


def _both(scenario, *args, **kw):
    want = scenario(JAX, *args, **kw)
    got = scenario(PORT, *args, **kw)
    assert got == want
    return got


# ---------------------------------------------------------------------------
# Clock, Link, topology (tests/test_timing.py)
# ---------------------------------------------------------------------------

def _clock_order(P):
    c = P.clock.Clock()
    order = []
    for cyc, tag in ((5, "a5"), (3, "b3"), (5, "c5"), (3, "d3")):
        c.at(cyc, lambda t=tag: order.append(t))
    n = c.run()
    assert order == ["b3", "d3", "a5", "c5"] and c.now == 5 and c.idle
    with pytest.raises(ValueError):
        c.at(-1, lambda: None)
    fired = []
    c.at(10, lambda: (fired.append(c.now),
                      c.after(5, lambda: fired.append(c.now))))
    c.run()
    with pytest.raises(ValueError):
        c.at(3, lambda: None)
    c.at(40, lambda: None)
    ran = c.run(until=100)
    c.at(100, lambda: None)
    return [n, order, fired, ran, c.now, c.step(), c.step(), c.events_run,
            c.pending]


def _link_math(P):
    cfg = P.clock.TimingConfig(link_latency=100, downlink_gbps=4.0)
    link = P.clock.Link("l", latency=100, gbps=4.0, cfg=cfg)
    a1, a2 = link.send(0, 64), link.send(0, 64)
    assert (a1, a2) == (164, 228)
    assert link.queue_factor() == pytest.approx(1.5)
    cfg = P.clock.TimingConfig()
    a = P.clock.Link("a", latency=500, gbps=19.2, cfg=cfg)
    b = P.clock.Link("b", latency=500, gbps=19.2, cfg=cfg)
    last = [a.send(10, 64) for _ in range(37)][-1]
    burst = b.send_burst(10, 37, 64)
    assert burst == last and b.send_burst(10, 0, 64) == 10
    return [a1, a2, link.stats(), link.utilization(256), last, burst,
            a.stats(), b.stats(), cfg.bytes_per_cycle(19.2)]


def _clocked_fabric_seeded(P):
    cf = P.clock.ClockedFabric(P.clock.TimingConfig(jitter=400), seed=11)
    arrivals = [cf.bisnp_send(0) for _ in range(64)]
    assert arrivals == sorted(arrivals)
    runs = []
    for seed in (7, 7, 8):
        cf = P.clock.ClockedFabric(P.clock.TimingConfig(jitter=50), seed=seed)
        runs.append(([cf.bisnp_send(h % 3) for h in range(30)], cf.stats()))
    assert runs[0] == runs[1] and runs[0][0] != runs[2][0]
    topo = P.clock.FabricTopology(P.clock.TimingConfig())
    n0 = len(topo.links())
    topo.downlink(4)
    topo.downlink(4)
    return [arrivals, runs, n0, len(topo.links()), sorted(topo.downlinks)]


def _bus_clocked_delivery(P):
    cf = P.clock.ClockedFabric(P.clock.TimingConfig())
    bus = P.core.BISnpBus(max_lag=None, clock=cf)
    seen = {0: [], 1: []}
    bus.attach(0, lambda ev: seen[0].append(ev.epoch))
    bus.attach(1, lambda ev: seen[1].append(ev.epoch))
    for e in range(1, 4):
        bus.publish(P.core.BISnpEvent(e * 10, 4, epoch=e))
    assert cf.now == 0 and bus.delivered == 0
    n = bus.deliver(0)
    now_after = cf.now
    assert n == 3 and seen[0] == [1, 2, 3] and now_after > 0
    bus.publish(P.core.BISnpEvent(90, 4, epoch=4))
    bus.publish(P.core.BISnpEvent(95, 4, epoch=5))
    m = bus.deliver_until(1, 4)
    bus.quiesce()
    assert seen[1] == [1, 2, 3, 4, 5] and len(bus.timeline) == 10
    return [n, now_after, m, cf.now, seen, bus.timeline,
            bus.propagation_cycles()]


@pytest.mark.parametrize("scenario", [
    _clock_order, _link_math, _clocked_fabric_seeded, _bus_clocked_delivery],
    ids=lambda f: f.__name__.strip("_"))
def test_timing_scenario_matches(scenario):
    _both(scenario)


# ---------------------------------------------------------------------------
# Clocked bus: converges to the manual pump (tests/test_fabric.py)
# ---------------------------------------------------------------------------

def _build(P, clock):
    fab = P.Fabric(sdm_pages=1 << 14, table_capacity=2048, n_shards=4,
                   clock=clock)
    rts = [fab.enroll(h) for h in range(4)]
    tenants = {h: fab.admit(h, 64) for h in range(4)}
    fab.quiesce()
    return fab, rts, tenants


def _churn(fab, tenants, rng):
    for _ in range(3):
        victim = int(rng.integers(0, 4))
        fab.evict(victim, tenants[victim][0])
        if rng.integers(0, 2):
            fab.deliver(int(rng.integers(0, 4)), int(rng.integers(0, 3)))
        tenants[victim] = fab.admit(victim, 64)
        if rng.integers(0, 2):
            fab.deliver(int(rng.integers(0, 4)))
    fab.quiesce()


def _converge(P, seed, clocked):
    """The churn schedule on a manual or a clocked fabric: every host's
    PermCache state and its verdicts on a sweep of its span."""
    clock = P.clock.ClockedFabric(P.clock.TimingConfig(jitter=7),
                                  seed=seed) if clocked else None
    fab, rts, tenants = _build(P, clock)
    _churn(fab, tenants, np.random.default_rng(seed))
    out = [fab.fm.epoch, fab.fm.bus.timeline]
    for h in range(4):
        c = rts[h].permcache
        pid, start = tenants[h]
        ext = P.core.pack_ext_addr(np.full(32, pid, np.int32),
                                   (start + np.arange(32) % 64)
                                   .astype(np.int32))
        res = rts[h].check(ext, P.zeros(32))
        out.append([int(c.epoch)] + [as_np(getattr(c, f)).tolist() for f in
                                     ("tag", "entry", "plru")] +
                   [as_np(res.allowed).tolist(), as_np(res.fault).tolist()])
    return out


@pytest.mark.parametrize("seed", [3, 17, 92])
def test_clocked_converges_to_manual_pump(seed):
    """Clocked mode changes when events arrive, never what arrives or in
    what order: the port's clocked fabric leaves each PermCache as the
    reference's clocked fabric (timeline included) and as the port's own
    manually pumped fabric does."""
    clocked = _both(_converge, seed, True)
    manual = _converge(PORT, seed, False)
    assert clocked[1] and all(t1 >= t0 for _, _, t0, t1 in clocked[1])
    assert manual[0] == clocked[0] and manual[2:] == clocked[2:]


# ---------------------------------------------------------------------------
# Trace record -> finalize -> replay
# ---------------------------------------------------------------------------

def _unit_trace(P, *, n_hosts=3, steps=4, batch=64, span=512, seed=0,
                cache=16 * 1024):
    rng = np.random.default_rng(seed)
    tr = P.replay.FabricTrace(label="unit")
    rows = [(h, 10 + h) for h in range(n_hosts)]
    tr.record_commit(1, n_hosts)
    for _ in range(steps):
        pages = rng.integers(0, span, (n_hosts, batch)).astype(np.int64)
        tr.record_egress(rows, pages, epoch=1)
    tr.record_commit(2, n_hosts)
    return tr.finalize(perm_cache_bytes=cache)


def _replay_unit(P):
    out = []
    for span, cache in ((512, 16 * 1024), (4096, 16 * 1024), (64, 1024),
                        (128, 0)):
        tr = _unit_trace(P, span=span, cache=cache, seed=span)
        rt = P.replay.FabricTrace.from_json(tr.to_json())
        assert _replay_dict(P, rt) == _replay_dict(P, tr)
        out.append([tr.to_json(), _replay_dict(P, tr),
                    P.replay.replay(tr, perm="nocache", seed=5).to_dict(),
                    P.replay.timing_penalty(tr)])
    raw = P.replay.FabricTrace()
    raw.record_commit(1, 2)
    with pytest.raises(RuntimeError):
        P.replay.replay(raw)
    return out


def _replay_dict(P, tr):
    return P.replay.replay(tr).to_dict()


def test_replay_matches():
    _both(_replay_unit)


@pytest.mark.parametrize("kw", [
    dict(), dict(n_hosts=6, n_procs=3, steps=3, batch=96, span=256)],
    ids=["8hosts", "6hosts_3procs"])
def test_traced_fabric_matches(kw):
    """A small clocked deployment traced through `step_egress`: the same
    words and fault codes per step, the same trace JSON, replay report,
    timing penalty and live propagation cycles as the reference."""
    rec = _both(traced_fabric, **kw)
    pen = rec["penalty"]
    assert 0.0 <= pen["penalty_cached_pct"] < pen["penalty_nocache_pct"]
    assert rec["trace"]["events"] and rec["live"]


# ---------------------------------------------------------------------------
# lru + model on the fixtures of tests/test_cache_memsim.py
# ---------------------------------------------------------------------------

def _lru(P):
    rng = np.random.default_rng(0)
    keys = rng.integers(0, 100, 2000)
    out = [P.lru.reuse_distances(np.asarray([1, 2, 3, 1, 2, 2, 4, 1])),
           P.lru.reuse_distances(keys),
           P.lru.hit_curve(keys, [1, 2, 4, 8, 16, 32, 64, 128])]
    for cap in (1, 2, 4, 8, 16):
        small = rng.integers(0, 40, 400)
        out.append(P.lru.lru_hits(small, cap))
        c = P.core.LruCache(cap * 64)
        out.append(np.asarray([c.access(int(k)) for k in small]))
    for n_sets, ways in ((1, 4), (16, 4), (64, 2), (7, 1)):
        out.append(P.lru.set_assoc_hits(keys, n_sets, ways))
    out += [P.model.positional_distances(np.asarray([7, 8, 7, 7, 9, 8])),
            P.model.positional_distances(keys)]
    starts = np.arange(0, 4096, 4, dtype=np.int64)
    out += list(P.model.binary_search_nodes(
        len(starts), np.asarray([0, 5, 4000, 4095]), starts))
    out += list(P.model.binary_search_nodes(1, np.asarray([10, 20]),
                                            np.asarray([0])))
    return out


def test_lru_matches():
    want, got = _lru(JAX), _lru(PORT)
    assert len(want) == len(got)
    for w, g in zip(want, got):
        if isinstance(w, dict):
            assert w == g
        else:
            np.testing.assert_array_equal(w, g)


@pytest.fixture(scope="module")
def bfs_traces():
    """The tier-1 memsim fixture (a BFS trace of an RMAT scale-12 graph),
    made by each package."""
    out = []
    for P in (JAX, PORT):
        g = P.graphs.make_graph(scale=12, avg_degree=8, seed=3)
        out.append(P.gapbs.trace_bfs(g, cap=120_000, seed=0))
    return out


def _assert_results_equal(a, b):
    da, db = dataclasses.asdict(a), dataclasses.asdict(b)
    assert da.keys() == db.keys()
    for k in da:
        x, y = da[k], db[k]
        if isinstance(x, np.ndarray):
            np.testing.assert_array_equal(x, y)
        elif isinstance(x, dict):
            assert x.keys() == y.keys()
            for kk in x:
                assert abs(x[kk] - y[kk]) <= 1e-12, (k, kk)
        elif isinstance(x, float):
            assert abs(x - y) <= 1e-12, k
        else:
            assert x == y, k


@pytest.mark.parametrize("case", [
    dict(n_entries=1, cache_bytes=0, n_hosts=1),
    dict(n_entries=1, cache_bytes=0, n_hosts=8),
    dict(n_entries="wc", cache_bytes=0, n_hosts=1),
    dict(n_entries="wc", cache_bytes=2048, n_hosts=1),
    dict(n_entries="wc", cache_bytes=16384, n_hosts=1),
    dict(n_entries="wc", cache_bytes=0, n_hosts=1, system="mondrian-ext"),
    dict(n_entries="wc", cache_bytes=0, n_hosts=1, system="deact-like"),
    dict(n_entries="wc", cache_bytes=0, n_hosts=1, system="flat-table"),
], ids=lambda c: "-".join(str(v) for v in c.values()))
def test_model_matches(bfs_traces, case):
    """`run_pair` (and the cxl `simulate` inside it) on the same trace: the
    result's integers and arrays exact, its floats within 1e-12."""
    jt, tt = bfs_traces
    np.testing.assert_array_equal(jt.pages, tt.pages)
    case = dict(case)
    sdm_pages = int(jt.pages.max() // 4096) + 1
    if case["n_entries"] == "wc":
        case["n_entries"] = sdm_pages
        case["sdm_pages"] = sdm_pages
    jres, jbase = jmodel.run_pair(jt, kernel="bfs", **case)
    tres, tbase = tmodel.run_pair(tt, kernel="bfs", **case)
    _assert_results_equal(jres, tres)
    _assert_results_equal(jbase, tbase)
    assert tres.cpi_norm >= 1.0
