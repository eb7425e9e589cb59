"""Shared helpers of the ``test_torch_*`` parity tests: seeded inputs made
with numpy, the comparisons, and the fixture that gives a test the CUDA
device or skips it."""
import numpy as np
import pytest
import torch

from repro_torch.convert import u32_to_numpy
from repro_torch.kernels import permcheck as tpc
from repro_torch.kernels import ref


@pytest.fixture
def cuda():
    """The CUDA device; skips the test (decided here, never at import)
    where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the GPU machine")
    return torch.device("cuda")


def mk_table(rng, n_entries, sdm_pages):
    """Random sorted non-overlapping ranges + per-entry 2-bit perms."""
    bounds = np.sort(rng.choice(sdm_pages, size=2 * n_entries, replace=False))
    return (bounds[0::2].astype(np.int32), bounds[1::2].astype(np.int32),
            rng.integers(0, 4, n_entries).astype(np.uint32))


def mk_ext(rng, starts, batch, sdm_pages, *, hwpid=3, hot=0.5,
           tags=(3, 3, 3, 0, 5, -1)):
    """Tagged addresses: a ``hot`` share on entry starts, the rest uniform;
    tags drawn from ``tags`` (``hwpid`` the tenant's, 0 untagged, -1 the
    padding lane's tag, others forged)."""
    if starts.size:
        on_entry = starts[rng.integers(0, starts.size, batch)]
    else:
        on_entry = rng.integers(0, sdm_pages, batch)
    pages = np.where(rng.random(batch) < hot, on_entry,
                     rng.integers(0, sdm_pages, batch)).astype(np.int32)
    t = rng.choice(np.asarray(tags, np.int32), batch).astype(np.int32)
    return (t << 24) | (pages & 0xFFFFFF)


def words(rng, shape):
    """Random u32 words (numpy uint32)."""
    return rng.integers(0, 1 << 32, shape, dtype=np.uint32)


def as_np(x):
    """A JAX array or a port tensor as numpy; int32 port tensors stay
    int32 (compare u32 words with `assert_u32_equal`)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def assert_equal(a, b):
    np.testing.assert_array_equal(as_np(a), as_np(b))


def assert_u32_equal(jax_words, port_words):
    """JAX u32 words against the port's int32 bit patterns."""
    np.testing.assert_array_equal(np.asarray(jax_words, np.uint32),
                                  u32_to_numpy(port_words))


INT32_MAX = int(np.iinfo(np.int32).max)

# Shards at the edges of the search kernels' two-level search: no entry, a
# single entry (one at the top of the page space, so the -1 padding lane's
# page 0xFFFFFF is covered), runs of adjacent entries (end == next start)
# with gaps and a first start above page 0 or at it, live counts just past a
# power of two (a search's step count changes there), one full tile, a tile
# plus one entry, many tiles, and a full 65,536-entry shard with no sentinel.
EDGE_SHARDS = {
    "empty": (0, 1),
    "single": (1, 100),
    "single_top": (1, 0xFFFF00),
    "pair": (2, 9),
    "adjacent_33": (33, 50),
    "adjacent_from_0": (17, 0),
    "tile_513": (513, 7),
    "tile_1023": (1023, 7),
    "tile_1024": (1024, 7),
    "tile_1025": (1025, 7),
    "tiles_9000": (9000, 3),
    "full_65536": (65536, 1),
}


def edge_shard(name, rng):
    """(starts, ends, perms) of the named edge shard: ``n`` entries from
    ``first`` on, 1-8 pages each, half of them adjacent to the previous one
    and the rest after a gap of 1-5 pages."""
    n, first = EDGE_SHARDS[name]
    if name == "single_top":
        return (np.array([first], np.int32), np.array([1 << 24], np.int32),
                np.array([3], np.uint32))
    lengths = rng.integers(1, 9, n)
    gaps = np.where(rng.random(n) < 0.5, 0, rng.integers(1, 6, n))
    gaps[:1] = 0
    starts = first + np.cumsum(gaps) + np.concatenate(
        [[0], np.cumsum(lengths)[:-1]])
    return (starts.astype(np.int32), (starts + lengths).astype(np.int32),
            rng.integers(0, 4, n).astype(np.uint32))


def edge_pages(rng, starts, ends, *, sample=1500):
    """Pages at every edge of (a sample of) the entries: each start, start
    - 1, end - 1, end and end + 1, plus page 0, page 1, the page below the
    first start and the top page 0xFFFFFF."""
    if starts.size > sample:
        pick = np.sort(rng.choice(starts.size, sample, replace=False))
        starts, ends = starts[pick], ends[pick]
    pages = np.concatenate([
        [0, 1, 0xFFFFFE, 0xFFFFFF], starts[:1] - 1, starts, starts - 1,
        ends - 1, ends, ends + 1])
    return np.clip(pages, 0, 0xFFFFFF).astype(np.int32)


def edge_ext(rng, pages, *, hwpid=3):
    """Tagged addresses over ``pages``: most carry ``hwpid``, the rest are
    untagged, forged, or the -1 padding lane (ext == -1, page 0xFFFFFF)."""
    tags = rng.choice(np.array([hwpid] * 5 + [0, hwpid + 2], np.int32),
                      pages.size)
    ext = (tags.astype(np.int32) << 24) | pages
    ext[rng.random(pages.size) < 0.05] = -1
    return ext.astype(np.int32)


def assert_search_precondition(starts, ends, tile_min):
    """The search kernels' precondition on one shard view row: live
    entries a prefix, strictly sorted by start, non-empty, non-overlapping;
    INT32_MAX sentinels after them; ``tile_min`` the first start of each
    1024-entry tile (INT32_MAX for a dead tile), at most 64 tiles."""
    s, e, tm = (np.asarray(as_np(x)) for x in (starts, ends, tile_min))
    assert s.shape == e.shape and s.size == tm.size * 1024
    assert 1 <= tm.size <= 64
    n = int((s != INT32_MAX).sum())
    assert (s[n:] == INT32_MAX).all() and (e[n:] == INT32_MAX).all()
    assert (np.diff(s[:n].astype(np.int64)) > 0).all()
    assert (s[:n] < e[:n]).all()
    assert (e[:max(n - 1, 0)] <= s[1:n]).all()
    np.testing.assert_array_equal(tm, s[::1024])


# Shards that break the search's precondition: "four" is unsorted and
# overlapping, [(60, 110), (70, 80), (90, 95), (30, 40)], so page 50 lies in
# no entry; the others are edge shards shuffled, with every third end
# stretched over the entries after it.
BROKEN_SHARDS = ["four", "adjacent_33", "tile_1025", "tiles_9000"]


def broken_shard(name, rng):
    """(starts, ends, perms) of the named broken shard."""
    if name == "four":
        return (np.array([60, 70, 90, 30], np.int32),
                np.array([110, 80, 95, 40], np.int32),
                np.full(4, 3, np.uint32))
    starts, ends, perms = edge_shard(name, rng)
    ends = ends.copy()
    ends[::3] += 20
    order = rng.permutation(starts.size)
    return starts[order], ends[order], perms[order]


def broken_pages(rng, starts, ends):
    """Pages 0-129 and the edges of the entries, tagged for HWPID 3."""
    pages = np.concatenate([np.arange(130, dtype=np.int32), edge_pages(
        rng, np.sort(starts), np.sort(ends))])
    return pages, ((3 << 24) | pages).astype(np.int32)


def search_verdict(ext_addrs, view, *, hwpid, need):
    """The permission check as the search kernels compute it, on the CPU:
    `permcheck.lane_search_plain`, then one read of the found entry's end
    and permission bits.  Returns (allowed bool[B], idx i32[B])."""
    ext = torch.as_tensor(np.asarray(ext_addrs, np.int32)).reshape(-1)
    page = ext & 0xFFFFFF
    k = tpc.lane_search_plain(page, view.starts, view.tile_min)
    kc = k.clamp(min=0).long()
    covered = (k >= 0) & (page < view.ends[kc])
    ok = covered & ((view.permbits[kc] & need) == need)
    return ((ext >> 24) == hwpid) & ok, torch.where(covered, k, -1)


def search_egress(data, ext_addrs, view, *, hwpid, need, key0, key1,
                  base_word=0):
    """The fused egress as the checked_memcrypt and fabric_egress kernels
    compute it (``egress::egress_block``), on the CPU: `search_verdict`,
    the fault code in the reference's order (NO_ABITS for tag <= 0, then
    NOT_LOCAL, NO_ENTRY, PERM) and, on a granted word only, the word XORed
    with the keystream at ``base_word + lane`` (mod 2^32).  ``data`` i32[B]
    (u32 bits).  Returns (out i32[B], fault i32[B])."""
    ext = torch.as_tensor(np.asarray(ext_addrs, np.int32)).reshape(-1)
    allowed, idx = search_verdict(ext, view, hwpid=hwpid, need=need)
    dec = ref.memcrypt(data, key0, key1, base_word)
    tag = ext >> 24
    fault = torch.where(allowed, 0, torch.where(
        tag <= 0, 1, torch.where(tag != hwpid, 2,
                                 torch.where(idx < 0, 3, 4))))
    return torch.where(allowed, dec, 0), fault.to(torch.int32)


# ---------------------------------------------------------------------------
# Fabric scenarios run through either package.  ``P`` names one package's
# pieces: ``P.core`` (its ``core`` package), ``P.Fabric`` (its
# ``ShardedFabric``, bound to a device for the port), ``P.zeros(n)`` (a
# write mask of n False) and, for the timing path, ``P.clock``,
# ``P.replay`` and ``P.gapbs`` (its ``memsim.clock``, ``memsim.replay`` and
# ``workloads.gapbs``).  Each returns a record of plain Python values, so the
# records of two runs compare with ``==``.
# ---------------------------------------------------------------------------

CHAOS_SPEC = dict(drop_p=0.15, dup_p=0.10, reorder_p=0.10, delay_p=0.10,
                  max_delay=3)


def mk_fabric(P, n_hosts=4, span=32, clock=None):
    """A fabric of ``n_hosts`` hosts with one ``span``-page tenant each,
    quiesced.  Returns (fabric, runtimes, {host: (hwpid, start)})."""
    fab = P.Fabric(sdm_pages=1 << 14, table_capacity=2048, n_shards=n_hosts,
                   clock=clock)
    rts = [fab.enroll(h) for h in range(n_hosts)]
    tenants = {h: fab.admit(h, span) for h in range(n_hosts)}
    fab.quiesce()
    return fab, rts, tenants


def span_ext(P, pid, start, n=8):
    """Tagged addresses of pages ``start .. start + n - 1`` for ``pid``."""
    return P.core.pack_ext_addr(np.full(n, pid, np.int32),
                                (start + np.arange(n)).astype(np.int32))


def check_span(P, rt, pid, start, n=8):
    """(allowed, fault) of one read check of a span, as lists."""
    res = rt.check(span_ext(P, pid, start, n), P.zeros(n))
    return as_np(res.allowed).tolist(), as_np(res.fault).tolist()


def span_allowed(P, rt, pid, start, n=8):
    return all(check_span(P, rt, pid, start, n)[0])


def fault_counters(fab, plan=None):
    """The fabric's fault and bus counters and epoch, and the plan's."""
    st = fab.stats()
    out = [st["faults"], st["bus"], st["epoch"]]
    if plan is not None:
        out.append((plan.dropped, plan.duplicated, plan.delayed,
                    plan.fm_crashes, plan.stashed()))
    return out


def chaos_matrix(P, seed, *, rounds=14):
    """The reference's chaos matrix (``tests/test_faults.py``) at 4 hosts:
    churn under dropped, duplicated, reordered and delayed BISnp copies,
    one FM crash epoch and one host crash and rejoin, every revoked span
    checked every round; then restart + quiesce.  Asserts zero stale reads
    and converged verdicts; the record holds every round's counters and
    every check's verdict and fault codes."""
    rng = np.random.default_rng(seed)
    n_hosts = 4
    fab, rts, tenants = mk_fabric(P, n_hosts=n_hosts, span=16)
    plan = fab.inject_faults(P.core.FaultPlan(
        P.core.FaultSpec(**CHAOS_SPEC), seed=seed,
        fm_crash_epochs=(fab.fm.epoch + 2 + int(rng.integers(0, 3)),)))
    live = {h: [tenants[h]] for h in range(n_hosts)}
    revoked = []
    crashed_host = None
    stale_reads = 0
    log = []
    for rnd in range(rounds):
        op = int(rng.integers(0, 3))
        if not fab.fm.crashed:
            try:
                if op == 0:
                    hs = [h for h in live if live[h] and h != crashed_host]
                    if hs:
                        h = hs[int(rng.integers(0, len(hs)))]
                        pid, start = live[h].pop()
                        fab.fm.revoke_hwpid(pid)
                        revoked.append((h, pid, start))
                elif op == 1:
                    h = int(rng.integers(0, n_hosts))
                    if h != crashed_host and fab.free_pages(h) >= 16:
                        live[h].append(fab.admit(h, 16))
            except P.core.FMUnavailable:
                pass
        elif rng.random() < 0.5:
            fab.fm.restart()
        if rnd == 5 and crashed_host is None:
            crashed_host = int(rng.integers(0, n_hosts))
            fab.crash_host(crashed_host)
        if rnd == 10 and crashed_host is not None:
            fab.rejoin_host(crashed_host)
            crashed_host = None
        for h in range(n_hosts):
            if h != crashed_host and rng.random() < 0.7:
                fab.deliver(h, int(rng.integers(1, 4)))
        for (h, pid, start) in revoked:
            if h == crashed_host:
                continue
            allowed, fault = check_span(P, rts[h], pid, start, 4)
            stale_reads += sum(allowed)
            log.append((rnd, h, pid, allowed, fault))
        log.append(fault_counters(fab, plan))
    assert stale_reads == 0
    if crashed_host is not None:
        fab.rejoin_host(crashed_host)
    fab.quiesce()
    fab.fm.bus.faults = None
    fab.fm.faults = None
    fab.fm.restart()
    fab.quiesce()
    assert all(not rt.desynced for rt in rts)
    assert plan.dropped + plan.duplicated + plan.delayed > 0
    for (h, pid, start) in revoked:
        assert not span_allowed(P, rts[h], pid, start, 4)
    for h, grants in live.items():
        for pid, start in grants:
            assert span_allowed(P, rts[h], pid, start, 4), (seed, h, pid)
    return log + fault_counters(fab, plan)


def traced_fabric(P, *, n_hosts=8, n_procs=8, scale=10, steps=4, batch=128,
                  span=1024, cap=20_000, seed=0):
    """The reference's clocked timing row (``benchmarks/scale_bench.py``
    ``_bench_timing``) at a small size: a `ClockedFabric` deployment, GAPBS
    traces replayed as egress batches between `begin_trace` and
    `end_trace`, an evict + re-admit commit after every second step, then
    `replay` and `timing_penalty` of the finalized trace.  The record holds
    the trace's JSON, the replay report, the penalties, the live bus's
    propagation cycles and every step's words and fault codes."""
    g = P.graphs.make_graph(scale=scale, avg_degree=12, seed=7)
    traces = {k: P.gapbs.TRACES[k](g, cap=cap, seed=seed)
              for k in ("pr", "bfs", "bc", "tc")}
    cfg = P.clock.TimingConfig()
    cf = P.clock.ClockedFabric(cfg, seed=seed)
    fab = P.Fabric(1 << 18, table_capacity=8192, n_shards=n_hosts, clock=cf)
    for h in range(n_hosts):
        fab.enroll(h)
    active = [p * n_hosts // n_procs for p in range(n_procs)]
    fab.begin_trace(label=f"hosts={n_hosts}")
    tenants = {h: fab.admit(h, span) for h in active}
    fab.quiesce()
    assign = {h: tenants[h][0] for h in active}
    names = list(traces)
    ext_steps = np.stack([
        P.gapbs.egress_batches(traces[names[i % len(names)]],
                               hwpid=tenants[h][0], batch=batch,
                               n_steps=steps, page_offset=tenants[h][1],
                               page_span=span)[0]
        for i, h in enumerate(active)])
    rng = np.random.default_rng(seed)
    victim = active[0]
    outs = []
    for s in range(steps):
        ext = ext_steps[:, s]
        data = rng.integers(0, 1 << 32, ext.shape, dtype=np.uint32)
        out, fault = fab.step_egress(data, ext, assign, need=1)
        outs.append((as_np(out).view(np.uint32).tolist(),
                     as_np(fault).tolist()))
        if s % 2 == 1:
            fab.evict(victim, tenants[victim][0])
            tenants[victim] = fab.admit(victim, span)
            assign[victim] = tenants[victim][0]
            fab.quiesce()
    fab.quiesce()
    trace = fab.end_trace()
    rep = P.replay.replay(trace, cfg, seed=seed)
    return {"trace": trace.to_json(), "replay": rep.to_dict(),
            "penalty": P.replay.timing_penalty(trace, cfg),
            "live": fab.fm.bus.propagation_cycles(), "cycles": cf.now,
            "steps": outs}


# ---------------------------------------------------------------------------
# A seeded sequence of lifecycle events on a fabric (the port's or the JAX
# package's: both take the same calls), for the incremental view tests.
# ---------------------------------------------------------------------------

LIFECYCLE_EVENTS = ("readmit", "revoke", "evict_revoked", "admit_new",
                    "grant_shared", "release_shared", "release_range",
                    "vacuum", "crash_rejoin", "fm_restart")
LIFECYCLE_SPAN = 16


def lifecycle_deployment(fab, proposal):
    """Four hosts: two tenants on host 0, one on hosts 1 and 2, and on
    host 3 one tenant whose 1,101 one-page grants fill two 1024-entry
    tiles; quiesced.  ``proposal`` is the fabric's `Proposal` class.
    Returns the state the events keep: ``assign`` {host: [hwpids]} (the
    rows), ``spans`` {hwpid: (start, n)}, the revoked and the shared
    tenant."""
    for h in range(4):
        fab.enroll(h)
    state = {"assign": {}, "spans": {}, "revoked": [], "shared": None}
    for h in (0, 0, 1, 2, 3):
        pid, start = fab.admit(h, LIFECYCLE_SPAN)
        state["assign"].setdefault(h, []).append(pid)
        state["spans"][pid] = (start, LIFECYCLE_SPAN)
    start = state["spans"][pid][0] + LIFECYCLE_SPAN
    with fab.fm.transaction():
        for k in range(1100):
            fab.fm.propose(proposal(3, pid, 0, start + 2 * k, 1, 1))
    fab.quiesce()
    return state


def _replace_tenant(fab, state, h, pid):
    """Evict ``pid`` from host ``h`` and admit its replacement in its
    place among the rows."""
    fab.evict(h, pid)
    new, start = fab.admit(h, LIFECYCLE_SPAN)
    pids = state["assign"][h]
    pids[pids.index(pid)] = new
    state["spans"][new] = (start, LIFECYCLE_SPAN)


def lifecycle_event(fab, state, kind, pick):
    """Apply one event of ``LIFECYCLE_EVENTS``, its tenant or host chosen
    by the integer ``pick``, and quiesce."""
    live = [(h, p) for h, ps in sorted(state["assign"].items()) for p in ps
            if p not in state["revoked"] and p != state["shared"]
            and h != 3]
    h, pid = live[pick % len(live)]
    if kind == "readmit":             # the same span, the tombstone reused
        _replace_tenant(fab, state, h, pid)
    elif kind == "revoke":
        fab.fm.revoke_hwpid(pid)
        state["revoked"].append(pid)
    elif kind == "evict_revoked":
        gone = state["revoked"].pop(0)
        host = next(g for g, ps in state["assign"].items() if gone in ps)
        _replace_tenant(fab, state, host, gone)
    elif kind == "admit_new":         # a new span, one row more
        new, start = fab.admit(h, LIFECYCLE_SPAN)
        state["assign"][h].append(new)
        state["spans"][new] = (start, LIFECYCLE_SPAN)
    elif kind == "grant_shared":      # a read-only region of host 2's shard
        lo, hi = fab.shard_range(2)
        fab.grant_shared(hi - 64, 32, pid, h, perm=1)
        state["shared"] = pid
    elif kind == "release_shared":
        gone, state["shared"] = state["shared"], None
        host = next(g for g, ps in state["assign"].items() if gone in ps)
        _replace_tenant(fab, state, host, gone)
    elif kind == "release_range":     # a hole inside a grant
        start, n = state["spans"][pid]
        fab.fm.release_range(pid, start + 4, 4)
    elif kind == "vacuum":
        fab.fm.vacuum()
    elif kind == "crash_rejoin":
        fab.crash_host(h)
        fab.rejoin_host(h)
    elif kind == "fm_restart":        # a snapshot resync reaches every host
        fab.fm.crash()
        fab.fm.restart()
    else:
        raise ValueError(kind)
    fab.quiesce()


def lifecycle_ext(rng, fab, state, batch):
    """Tagged addresses of one step over the rows: each row's tenant on
    its span and a few pages around it, every 19th lane untagged."""
    rows = fab.fabric_rows(state["assign"])
    ext = np.zeros((len(rows), batch), np.int32)
    for i, (_, pid) in enumerate(rows):
        start, n = state["spans"][pid]
        tags = np.full(batch, pid, np.int32)
        tags[::19] = 0
        pages = start + rng.integers(-4, n + 4, batch)
        ext[i] = (tags << 24) | (pages & 0xFFFFFF)
    return ext


def fresh_fabric_view(fab, assign):
    """The port's stacked view derived from scratch: a `make_shard_view`
    of each row's resident arrays at the current epoch, stacked by
    `stack_views`."""
    from repro_torch.core.fabric import stack_views
    rows = fab.fabric_rows(assign)
    epoch = fab.fm.table.epoch
    views = []
    for h, pid in rows:
        s, e, pw = fab.runtimes[h]._resident_entries()
        permbits = (pw[:, pid // 16] >> np.uint32((pid % 16) * 2)) \
            & np.uint32(3)
        views.append(tpc.make_shard_view(s, e, permbits, epoch=epoch,
                                         device=fab.device))
    return stack_views(views, [p for _, p in rows], [h for h, _ in rows],
                       epoch=epoch)


def assert_fabric_views_equal(got, want):
    """Every field of two FabricViews equal, the tensors bit for bit."""
    for f in got._fields:
        a, b = getattr(got, f), getattr(want, f)
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and a.shape == b.shape, f
            assert torch.equal(a.cpu(), b.cpu()), f
        else:
            assert a == b, f


def assert_fabric_view_layout(view):
    """Every row of a stacked view meets the search kernels' layout and
    precondition, and holds no permission bit in its padding."""
    for i in range(view.n_hosts):
        tpc.check_search_layout(view.starts[i], view.ends[i],
                                view.permbits[i], view.tile_min[i])
        assert_search_precondition(view.starts[i], view.ends[i],
                                   view.tile_min[i])
        pad = as_np(view.starts[i]) == INT32_MAX
        assert (as_np(view.permbits[i])[pad] == 0).all()
