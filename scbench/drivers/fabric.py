"""Driver of the fabric cells: a ``ShardedFabric`` deployment whose tenants
replay GAPBS traffic through ``ShardedFabric.step_egress``, back to back,
with optional lifecycle commits every ``commit_every`` steps.

Set-up enrolls every host, admits one tenant per slot (a span of
``span_pages`` each), stages the ring of steps on the device and runs each
ring step once.  The window issues steps until ``seconds`` have passed (and
the ring and the cycle of commits have gone round once) and ends on a
synchronise.  One output of every ring step, and some outputs of
first steps after a commit, are kept (reservoir samples drawn from the
seed), with the addresses of its step and the reference's account of
the grants then, and judged against ``reference.egress`` once the window
has closed.  The samples are copied into buffers made before the window,
so the window's peak device memory less those buffers is what the
deployment itself holds.  Python's collector is frozen and off in the
window: set-up's objects are never scanned, and no collection lands on
a step at random.

Lifecycle commits, in a cycle of three: evict a live tenant and admit its
replacement on the same host; revoke a tenant (``fm.revoke_hwpid``); at
the next slot evict the revoked tenant and admit its replacement.  Each
commit ends with ``quiesce`` (every host has observed it).
"""
from __future__ import annotations

import gc
import random
import statistics
import time

import torch

from ..harness import TRACE_SECONDS, Tracer
from ..reference import egress as ref
from ..roofline import fabric as work
from ..roofline import peaks
from ..traffic import fabric_ring

# commit kinds, in their cycle
LIFECYCLE = ("evict", "revoke", "evict_revoked")
KEPT_AFTER_COMMIT = 8


class Reservoir:
    """Samples drawn from the seed: one step of each ring slot, uniformly
    over the window (``offer_step`` says whether to keep the n-th offer),
    and ``k`` of the first steps after a commit (``offer_commit``).  Each
    sample's tensors are copied into a buffer of ``buffers``, made
    before the window (``keep``)."""

    def __init__(self, rng: random.Random, k: int, buffers: list):
        self.rng = rng
        self.k = k
        self.buffers = buffers
        self.seen: dict = {}
        self.items: dict = {}
        self.after_commit: list = []
        self.commits_seen = 0

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for buf in self.buffers for t in buf)

    def keep(self, i: int, out, fault, ext) -> tuple:
        """(out, fault, ext) copied into buffer ``i``; ``ext`` itself where
        the buffer has no room for it (no commit retags the ring)."""
        buf = self.buffers[i]
        kept = []
        for dst, src in zip(buf, (out, fault, ext)):
            dst.copy_(src)
            kept.append(dst)
        return (*kept, ext)[:3]

    def offer_step(self, key) -> bool:
        n = self.seen[key] = self.seen.get(key, 0) + 1
        return self.rng.random() * n < 1

    def offer_commit(self) -> int | None:
        """Slot of ``after_commit`` to fill, or None."""
        self.commits_seen += 1
        if len(self.after_commit) < self.k:
            self.after_commit.append(None)
            return len(self.after_commit) - 1
        j = self.rng.randrange(self.commits_seen)
        return j if j < self.k else None


def run(ctx) -> None:
    from repro_torch.core import ShardedFabric

    cfg, p, rec, dev = ctx.config, ctx.params, ctx.record, ctx.device
    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else None
    n_hosts, n_tenants = cfg["hosts"], cfg["tenants"]
    span = cfg["span_pages"]
    b = p["words_per_row"]
    ring_steps = p["ring_steps"]
    need = p["need"]
    key0, key1 = fabric_ring.keys(ctx.seed)
    ctx.phase("imports")

    fab = ShardedFabric(cfg["sdm_pages"], cfg["table_capacity"],
                        n_shards=n_hosts,
                        perm_cache_bytes=cfg["perm_cache_bytes"],
                        device=dev)
    for h in range(n_hosts):
        fab.enroll(h)
    hosts = sorted(t * n_hosts // n_tenants for t in range(n_tenants))
    ledger = ref.GrantLedger(hosts, n_hosts, cfg["sdm_pages"], span)
    for row, h in enumerate(hosts):
        ledger.admit(row, *fab.admit(h, span))
    fab.quiesce()
    ctx.phase("deployment")
    ext, data = fabric_ring.make_ring(cfg, p, ctx.seed, ledger.hwpid,
                                      ledger.lo, dev)
    ctx.phase("traffic")
    n_foreign = round(p["foreign_share"] * b)

    def assignment() -> dict:
        return {h: ledger.hwpid[r] for r, h in enumerate(hosts)}

    def program_step(slot, assign):
        return fab.step_egress(data[slot], ext[slot], assign, need=need,
                               key0=key0, key1=key1)

    def control_step(slot, assign):
        return ref.egress(
            data[slot], ext[slot], ledger.grants(ledger.snapshot(), dev),
            key0=key0, key1=key1, words_per_row=b,
            ignore_range=ctx.control == "range",
            ignore_revocation=ctx.control == "revocation")

    step = control_step if ctx.control else program_step
    if ctx.wrap_step is not None:
        step = ctx.wrap_step(step)
    step = ctx.spans.wrap("fabric.step_egress", step)

    ops_per_s = peaks.card_int32_ops_per_s() if on_card else \
        peaks.int32_ops_per_s(132, 1980.0)

    def step_bound_s() -> float:
        live_rows = sum(ledger.live)
        n_bytes, n_ops = work.step_work(
            [b] * len(hosts), live_rows * (b - n_foreign),
            [int(e) for e in ledger.entry])
        return peaks.least_time_s(n_bytes, n_ops, ops_per_s)

    assign = assignment()
    for slot in range(ring_steps):          # every ring step once
        step(slot, assign)
    commit_every = p.get("commit_every")
    # a sample keeps its step's addresses only where commits retag them
    n_kept = ring_steps + (KEPT_AFTER_COMMIT if commit_every else 0)
    per_sample = 3 if commit_every else 2
    keep = Reservoir(random.Random(f"keep:{ctx.seed}"), KEPT_AFTER_COMMIT,
                     [[torch.empty_like(ext[0]) for _ in range(per_sample)]
                      for _ in range(n_kept)])
    if on_card:
        sync()
    ctx.phase("warm-up")
    rng = random.Random(f"commit:{ctx.seed}")
    # the window goes round the ring, and the cycle of commits, once
    min_steps = max(ring_steps,
                    commit_every * len(LIFECYCLE) + 1 if commit_every else 0)
    commits = 0
    pending = None     # (t_call, kind, row, sample slot) of the last commit
    bound_now = step_bound_s()
    bound_s = profiled_bound_s = 0.0
    tracer = Tracer(ctx.trace, sync)
    steps = 0
    cycles = []         # host seconds of each commit, first step, the rest
    unpatch = time_launches(ctx)

    gc.collect()
    gc.freeze()
    gc.disable()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    tracer.start()      # before the window: the profiler's start-up is long
    t0 = time.perf_counter()
    rec.setup_s = t0 - ctx.t_start
    deadline = t0 + ctx.seconds
    stalled = 0.0       # seconds the profiler's stop held the window
    next_second = t0 + 1.0
    per_second = []     # steps issued by the end of each second
    while True:
        slot = steps % ring_steps
        out, fault = step(slot, assign)
        steps += 1
        bound_s += bound_now
        if tracer.active:
            profiled_bound_s += bound_now
        if keep.offer_step(slot):
            keep.items[slot] = (*keep.keep(slot, out, fault, ext[slot]),
                                ledger.snapshot())
        if pending is not None:
            t_call, kind, row, j = pending
            pending = None
            if kind != "landing":
                cycles[-1][1] = time.perf_counter() - t_step
            if j is not None:
                keep.after_commit[j] = (
                    slot, *keep.keep(ring_steps + j, out, fault, ext[slot]),
                    ledger.snapshot())
            if ctx.trace:
                if on_card:
                    sync()
                now = time.perf_counter()
                if kind != "landing":
                    rec.spans["control.commit_to_step"].append(now - t_call)
                if kind in ("revoke", "landing"):
                    if bool((fault[row] > 0).all()):
                        rec.spans["control.revoke_land"].append(now - t_call)
                    else:
                        pending = (t_call, "landing", row, None)
        if tracer.active and time.perf_counter() - t0 >= TRACE_SECONDS:
            stalled += tracer.stop()
        if commit_every and steps % commit_every == 0:
            kind = LIFECYCLE[commits % len(LIFECYCLE)]
            t_call = time.perf_counter()
            if cycles:
                cycles[-1][2] = t_call - t_step - cycles[-1][1]
            with ctx.spans("control.commit"):
                row = commit(fab, ledger, ext, hosts, rng, kind, span)
            assign = assignment()
            bound_now = step_bound_s()
            commits += 1
            pending = (t_call, kind, row, keep.offer_commit())
            t_step = time.perf_counter()
            cycles.append([t_step - t_call, 0.0, 0.0])
        now = time.perf_counter()
        if now >= next_second:
            per_second.append(steps)
            next_second += 1.0
        if steps >= min_steps and now >= deadline:
            break
    if on_card:
        sync()
    t1 = time.perf_counter()
    gc.enable()
    gc.unfreeze()
    tracer.stop()
    unpatch()

    # a traced window leaves out the profiler's stop, in which nothing ran
    rec.window_s = t1 - t0 - stalled
    rec.attempted = steps
    ctx.log("steps issued in each second of the window: "
            f"{[b - a for a, b in zip([0] + per_second, per_second)]}")
    log_cycles(ctx, cycles[:-1])
    rec.counters.update(words=steps * len(hosts) * b, steps=steps,
                        commits=commits, bound_s=bound_s,
                        profiled_bound_s=profiled_bound_s)
    if on_card:
        peak = torch.cuda.max_memory_allocated()
        rec.memory_peak_bytes = peak - keep.nbytes
        ctx.log(f"device memory: window peak {peak} B, of which the "
                f"judge's sample buffers {keep.nbytes} B")
    rec.trace = tracer.summary()
    del fab, out, fault

    # judge every kept output against the reference
    samples = [(slot, *v) for slot, v in sorted(keep.items.items())]
    samples += [s for s in keep.after_commit if s is not None]
    words = faults = failed = 0
    for slot, got_out, got_fault, got_ext, snap in samples:
        want = ref.egress(data[slot], got_ext, ledger.grants(snap, dev),
                          key0=key0, key1=key1, words_per_row=b)
        w, f = ref.mismatches((got_out, got_fault), want)
        words += w
        faults += f
        failed += bool(w or f)
    rec.failed = failed
    rec.counters["judged_steps"] = len(samples)
    rec.checks = {"word_mismatches": (words, 0),
                  "fault_mismatches": (faults, 0),
                  "grant_violations": (ledger.violations, 0)}


def time_launches(ctx):
    """In a traced run, time every launch of the egress kernel as the span
    ``fabric.launch`` (the host blocks there while the device's queue is
    full); returns what undoes it."""
    if not ctx.trace:
        return lambda: None
    from repro_torch.kernels import fabric_egress as mod
    launch = mod.launch
    mod.launch = ctx.spans.wrap("fabric.launch", launch)

    def undo():
        mod.launch = launch
    return undo


def log_cycles(ctx, cycles) -> None:
    """Quartiles of the host milliseconds of each commit cycle's parts:
    the commit, the first step after it (the view's re-derivation) and
    the other steps until the next commit."""
    if len(cycles) < 4:
        return
    for i, part in enumerate(("commit", "first step", "other steps")):
        ms = [1e3 * c[i] for c in cycles]
        q = statistics.quantiles(ms, n=4)
        ctx.log(f"cycle {part} ms: quartiles {q[0]:.3f} {q[1]:.3f} "
                f"{q[2]:.3f}, max {max(ms):.3f}, sum {sum(ms):.1f}")


def commit(fab, ledger, ext, hosts, rng, kind, span) -> int:
    """One lifecycle commit of ``kind``, fenced by ``quiesce``; returns the
    row it changed."""
    if kind == "evict_revoked":
        row = next(r for r in range(len(hosts)) if not ledger.live[r])
    else:
        row = rng.choice([r for r in range(len(hosts)) if ledger.live[r]])
    h, hwpid = hosts[row], ledger.hwpid[row]
    if kind == "revoke":
        fab.fm.revoke_hwpid(hwpid)
        ledger.revoke(row)
    else:
        old_lo = ledger.lo[row]
        fab.evict(h, hwpid)
        ledger.revoke(row)
        new_hwpid, new_lo = fab.admit(h, span)
        ledger.admit(row, new_hwpid, new_lo)
        if (new_hwpid, new_lo) != (hwpid, old_lo):
            fabric_ring.retag_row(ext, row, old_lo, span, new_hwpid, new_lo)
    fab.quiesce()
    return row
