"""Serving launcher: continuous-batching multi-tenant decode on the sharded
fabric, on the GPU.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \\
        --preset smoke --requests 8 --prompt-len 32 --gen 16

The port of ``repro.launch.serve``.  The engine runs the paper's
serving-side integration end to end on the port's `ShardedFabric`:

  * each tenant is ADMITTED on a fabric host: `ShardedFabric.admit`
    allocates its KV page span inside the host's shard, assigns a
    deployment-unique HWPID and commits the RW grant; the KV block is
    registered in the shared tensor pool AT that span (`register_at`);
  * hosts are MULTI-TENANT: co-resident tenants share one `HostRuntime` —
    one resident shard, one epoch-fenced PermCache;
  * every decode step's KV-page touch set is validated through
    `HostRuntime.check` after the host's BISnp queue is drained up to the
    table epoch (`bus.deliver_until`, the per-step fence close);
  * with ``fused_egress=True`` the step also pulls every active tenant's KV
    lines through ONE `ShardedFabric.step_egress` launch of the fabric
    kernel (one row per (host, tenant) pair) and cross-checks the kernel's
    fault lanes against the framework verdicts;
  * eviction flows through `ShardedFabric.evict`; mid-run revocation kills
    a tenant's decoding at its very next KV-page touch while co-resident
    tenants keep serving.

Decoding runs eager on the model in `repro_torch.models` (every attention
through the flash kernel on the card): dense, vlm, moe, ssm and hybrid
serve, each with the cache its family's `registry.prefill` returns.  The
encoder-decoder family needs frames to encode and the engine has none, so
its first prefill raises a ValueError that says so (the reference crashes
there).  Batching: every active tenant
decodes one token per engine `step()`; finished groups retire and refill
from the tenant's queue, and tenants can join or leave between steps.
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..configs import ARCHS, smoke_config
from ..core import (FAULT_DESYNC, FAULT_NONE, SharedTensorPool,
                    pack_ext_addr)
from ..core.fabric import ShardedFabric
from ..core.table import PAGE_BYTES
from ..kernels import resolve_device
from ..models import registry


@dataclass
class Tenant:
    name: str
    hwpid: int
    host_id: int
    queue: list = field(default_factory=list)   # prompt arrays
    done: list = field(default_factory=list)    # (prompt, generated)
    aborted: list = field(default_factory=list)  # prompts killed in flight
    kv_start_page: int = 0
    kv_n_pages: int = 0
    revoked: bool = False
    # in-flight decode group (continuous-batching slot state)
    group: list | None = None
    cache: object = None
    cur: torch.Tensor | None = None
    out: list | None = None
    plen: int = 0
    pos: int = 0
    gen_left: int = 0
    last_fault: int = FAULT_NONE


class ServeEngine:
    """Continuous-batching multi-tenant decode on a `ShardedFabric`:
    per-step KV-page checks through each host's fenced PermCache, with an
    optional single-launch fused egress across every (host, tenant) row.
    Model, fabric and cache live on ``device`` (default CUDA)."""

    def __init__(self, cfg, params, *, batch: int, cap: int,
                 fused_egress: bool = False, n_hosts: int = 4,
                 sdm_pages: int = 1 << 20, table_capacity: int = 8192,
                 device=None):
        self.cfg = cfg
        self.params = params
        self.batch = batch
        self.cap = cap
        self.device = resolve_device(device)
        # optional: pull each step's KV lines through the batched fabric
        # check⊕decrypt kernel (one launch for ALL tenants on all hosts)
        # on top of the cached framework check
        self.fused_egress = fused_egress
        self.pool = SharedTensorPool()
        self.fabric = ShardedFabric(sdm_pages, table_capacity,
                                    n_shards=n_hosts, device=self.device)
        self.fm = self.fabric.fm
        self.tenants: dict[str, Tenant] = {}
        self.faults = 0
        self.steps = 0
        # fail-closed stalls: step ticks where a tenant's host was desynced
        # and denied the batch WITHOUT aborting the group
        self.stalls = 0

    # -- observability -----------------------------------------------------
    @property
    def bisnp_events(self) -> int:
        """Back-invalidates observed across every enrolled host."""
        return sum(rt.bisnp_seen for rt in self.fabric.runtimes.values())

    def cache_stats(self) -> dict:
        """Aggregate PermCache counters over the fabric's hosts."""
        hits = sum(int(rt.permcache.hits)
                   for rt in self.fabric.runtimes.values())
        misses = sum(int(rt.permcache.misses)
                     for rt in self.fabric.runtimes.values())
        total = hits + misses
        return {"hits": hits, "misses": misses,
                "hit_rate": hits / total if total else 0.0}

    def view_stats(self) -> dict:
        """Aggregate view-memo counters (the fabric's stacked-view memo
        plus each host's per-tenant ShardView cache) and the control-plane
        health counters (`error_count`: bus handler failures ever;
        `stalls`: fail-closed desync ticks absorbed by the engine).
        ``rebuilds`` counts re-resolutions after an epoch moved, views
        built and views carried to the new epoch unchanged alike."""
        return {
            "rebuilds": self.fabric.view_rebuilds
            + sum(rt.views.rebuilds + rt.views.kept
                  for rt in self.fabric.runtimes.values()),
            "reuses": self.fabric.view_reuses
            + sum(rt.views.reuses for rt in self.fabric.runtimes.values()),
            "error_count": self.fm.bus.error_count,
            "stalls": self.stalls,
        }

    # -- tenancy -----------------------------------------------------------
    def add_tenant(self, name: str, host_id: int) -> Tenant:
        """Admission through the fabric: allocate the KV span inside the
        host's shard (the coalescing free list reuses evicted tenants'
        pages), grant it RW to a fresh deployment-unique HWPID (one
        commit), and join the serving loop."""
        if name in self.tenants:
            raise ValueError(f"tenant {name} already admitted")
        if host_id not in self.fabric.runtimes:
            self.fabric.enroll(host_id)
        kv_bytes = self.batch * self.cap * 64  # page-accounting granularity
        n_pages = max(1, -(-kv_bytes // PAGE_BYTES))
        # base_p follows the reference (PYTHONHASHSEED-dependent)
        hwpid, start = self.fabric.admit(host_id, n_pages,
                                         base_p=hash(name) & 0xFFFF)
        self.pool.register_at(
            f"kv:{name}",
            torch.zeros((n_pages, PAGE_BYTES // 4), dtype=torch.float32,
                        device=self.device),
            start_page=start)
        t = Tenant(name, hwpid, host_id,
                   kv_start_page=start, kv_n_pages=n_pages)
        self.tenants[name] = t
        return t

    def evict_tenant(self, name: str) -> Tenant:
        """Eviction through the fabric: abort in-flight work, revoke every
        grant in ONE commit, recycle the KV span onto the host's free list,
        and return the HWPID to the deployment pool."""
        t = self.tenants.pop(name)
        if t.group is not None:
            t.aborted += t.group
            t.group = None
        t.queue.clear()
        self.fabric.evict(t.host_id, t.hwpid)
        self.pool.unregister(f"kv:{name}")
        t.revoked = True
        return t

    def revoke(self, name: str) -> None:
        """Mid-flight revocation: the FM drops the tenant's grants and
        broadcasts the BISnp; the tenant's next KV-page touch faults and
        aborts only its requests while co-resident tenants keep serving."""
        self.fm.revoke_hwpid(self.tenants[name].hwpid)
        self.tenants[name].revoked = True

    def submit(self, name: str, prompt: np.ndarray) -> None:
        self.tenants[name].queue.append(prompt)

    # -- the serving loop --------------------------------------------------
    def _kv_pages_for_step(self, t: Tenant) -> torch.Tensor:
        """Pages this step's KV writes touch (one line per active slot)."""
        b = max(len(t.group or ()), 1)
        off = (t.pos * b + np.arange(b)) * 64 % (t.kv_n_pages * PAGE_BYTES)
        return torch.as_tensor(t.kv_start_page + off // PAGE_BYTES,
                               dtype=torch.int32, device=self.device)

    def _start_group(self, t: Tenant, gen: int) -> None:
        group = [t.queue.pop(0) for _ in range(
            min(self.batch, len(t.queue)))]
        plen = max(len(p) for p in group)
        toks = np.full((self.batch, plen), 2, np.int32)
        for i, p in enumerate(group):
            toks[i, :len(p)] = p
        logits, cache = registry.prefill(
            self.cfg, self.params,
            {"tokens": torch.from_numpy(toks).to(self.device)},
            cache_dtype=torch.float32, cap=plen + gen)
        t.group = group
        t.cache = cache
        t.out = [list(p) for p in group]
        t.cur = logits[:, -1].argmax(dim=-1)[:, None].to(torch.int32)
        t.plen = plen
        t.pos = plen
        t.gen_left = gen

    def _abort_group(self, t: Tenant, fault: int) -> None:
        self.faults += 1
        t.last_fault = fault
        t.aborted += t.group
        t.group = None
        t.cache = None

    def _fused_step_egress(self, active: list) -> list:
        """One batched kernel launch for the whole step: every active
        (tenant, ext) pair becomes one fabric row (per-(host, tenant) row
        layout), ragged batches padded with -1 (denied, zeroed).  Returns
        the per-row fault slices, row-aligned with `active`."""
        order = sorted(active, key=lambda a: a[0].host_id)
        assign: dict[int, list[int]] = {}
        for t, _ in order:
            assign.setdefault(t.host_id, []).append(t.hwpid)
        bmax = max(int(e.shape[0]) for _, e in order)
        ext = torch.full((len(order), bmax), -1, dtype=torch.int32,
                         device=self.device)
        for i, (_, e) in enumerate(order):
            ext[i, :e.shape[0]] = e
        data = torch.zeros((len(order), bmax), dtype=torch.int32,
                           device=self.device)
        _, fault = self.fabric.step_egress(data, ext, assign, need=2)
        by_tenant = {t.name: (i, int(e.shape[0]))
                     for i, (t, e) in enumerate(order)}
        out = []
        for t, _ in active:
            i, b = by_tenant[t.name]
            out.append(fault[i, :b])
        return out

    def step(self, *, gen: int, only: str | None = None) -> dict:
        """One engine tick: every tenant with work decodes one token.

        Returns {tenant: {"aborted": bool, "fault": int, "retired": int}}
        for tenants that made progress this tick.
        """
        results: dict[str, dict] = {}
        # phase 1: start groups, collect every active tenant's KV touch set
        active: list[tuple[Tenant, torch.Tensor]] = []
        for name, t in list(self.tenants.items()):
            if only is not None and name != only:
                continue
            if self.fabric.runtimes[t.host_id].crashed:
                # fail-stop host: its tenants stall until rejoin_host
                if t.queue or t.group is not None:
                    self.stalls += 1
                    t.last_fault = FAULT_DESYNC
                    results[name] = {"aborted": False, "stalled": True,
                                     "fault": FAULT_DESYNC, "retired": 0}
                continue
            if t.group is None:
                if not t.queue:
                    continue
                self._start_group(t, gen)
            pages = self._kv_pages_for_step(t)
            ext = pack_ext_addr(torch.full(pages.shape, t.hwpid,
                                           dtype=torch.int32,
                                           device=self.device), pages)
            active.append((t, ext))
        if not active:
            return results
        # phase 2: close each involved host's BISnp fence up to the table
        # epoch it is about to check against (no fabric-wide quiesce)
        for host_id in {t.host_id for t, _ in active}:
            if host_id in self.fm.bus.hosts:
                self.fm.bus.deliver_until(host_id, self.fm.epoch)
        # phase 3: framework egress check per tenant, through the host's
        # fenced PermCache and resident shard (THE checked egress path);
        # a desynced host answers a uniform FAULT_DESYNC deny here
        checks = [self.fabric.runtimes[t.host_id].check(
            ext, torch.ones(ext.shape, dtype=torch.bool, device=self.device))
            for t, ext in active]
        if self.fused_egress:
            # device-level egress: one batched launch for all tenants; the
            # kernel's fault lanes must agree with the framework verdicts.
            # Desynced hosts are excluded — their deny is a control-plane
            # stall, not a permission verdict.
            fusable = [(t, e) for t, e in active
                       if not self.fabric.runtimes[t.host_id].desynced]
            if fusable:
                chk_by_name = {t.name: chk
                               for (t, _), chk in zip(active, checks)}
                for (t, _), kfault in zip(fusable,
                                          self._fused_step_egress(fusable)):
                    chk = chk_by_name[t.name]
                    if not bool(((kfault > 0) == ~chk.allowed).all()):
                        raise AssertionError(
                            "fused kernel and cached checker disagree for "
                            f"tenant {t.name}")
        # phase 4: enforce verdicts, decode survivors
        for (t, _), chk in zip(active, checks):
            if not bool(chk.allowed.all()):
                fault = int(chk.fault.max())
                if fault == FAULT_DESYNC:
                    # fail-closed stall: the in-flight group is NOT aborted
                    # — it retries next tick; co-resident hosts untouched
                    self.stalls += 1
                    t.last_fault = fault
                    results[t.name] = {"aborted": False, "stalled": True,
                                       "fault": fault, "retired": 0}
                    continue
                # response-side enforcement: the denied KV lines read as
                # zero and the tenant's in-flight group aborts
                self._abort_group(t, fault)
                results[t.name] = {"aborted": True, "stalled": False,
                                   "fault": fault, "retired": 0}
                continue
            logits, t.cache = registry.decode_step(
                self.cfg, self.params, t.cache, t.cur, t.pos)
            t.cur = logits[:, -1].argmax(dim=-1)[:, None].to(torch.int32)
            # one host read-back per generated token, as the reference
            for i, tok in enumerate(t.cur[:len(t.group), 0].tolist()):
                t.out[i].append(tok)
            t.pos += 1
            t.gen_left -= 1
            self.steps += 1
            retired = 0
            if t.gen_left == 0:
                t.done += [(g, o[len(g):])
                           for g, o in zip(t.group, t.out)]
                retired = len(t.group)
                t.group = None
                t.cache = None
            results[t.name] = {"aborted": False, "stalled": False,
                               "fault": FAULT_NONE, "retired": retired}
        return results

    def has_work(self, only: str | None = None) -> bool:
        for name, t in self.tenants.items():
            if only is not None and name != only:
                continue
            if t.queue or t.group is not None:
                return True
        return False

    def run(self, *, gen: int, max_steps: int | None = None) -> dict:
        """Drive the continuous loop until every queue drains (or
        max_steps).  Returns per-tenant retirement/abort counts."""
        ticks = 0
        while self.has_work() and (max_steps is None or ticks < max_steps):
            self.step(gen=gen)
            ticks += 1
        return {name: {"served": len(t.done), "aborted": len(t.aborted)}
                for name, t in self.tenants.items()}

    def run_tenant(self, name: str, gen: int) -> dict:
        """Decode all queued prompts for one tenant, `gen` tokens each
        (single-tenant drain of the continuous loop)."""
        t = self.tenants[name]
        served0 = len(t.done)
        while self.has_work(only=name):
            out = self.step(gen=gen, only=name).get(name)
            if out and out["aborted"]:
                return {"tenant": name, "served": len(t.done) - served0,
                        "aborted": True, "fault": out["fault"]}
        return {"tenant": name, "served": len(t.done) - served0,
                "aborted": False}


def run_demo(engine: ServeEngine, *, requests: int, prompt_len: int,
             gen: int, seed: int = 0, log=print) -> dict:
    """The serving scenario of `main`: tenant-a and tenant-b co-resident on
    host 0 run ``requests`` prompts continuously; then tenant-a is revoked
    mid-service (it must abort at its next KV-page touch) while tenant-b
    keeps serving; tenant-a is evicted and tenant-c is admitted on the
    freed pages and served.  Returns the outcomes and timings."""
    cfg = engine.cfg
    rng = np.random.default_rng(seed)
    engine.add_tenant("tenant-a", host_id=0)
    engine.add_tenant("tenant-b", host_id=0)
    for i in range(requests):
        who = "tenant-a" if i % 2 == 0 else "tenant-b"
        engine.submit(who, rng.integers(3, cfg.vocab - 1, prompt_len))

    t0 = time.perf_counter()
    res = engine.run(gen=gen)
    dt = time.perf_counter() - t0
    tok = engine.steps * engine.batch
    cs = engine.cache_stats()
    log(f"continuous run: {res}")
    log(f"{engine.steps} decode steps, ~{tok / dt:,.0f} tok/s, "
        f"faults={engine.faults}, bisnp={engine.bisnp_events}, "
        f"perm-cache hit rate {cs['hit_rate']:.2f}")

    # live revocation: tenant-a loses access mid-service while its
    # co-resident neighbour on the same host keeps serving
    engine.submit("tenant-a", rng.integers(3, cfg.vocab - 1, prompt_len))
    engine.submit("tenant-b", rng.integers(3, cfg.vocab - 1, prompt_len))
    engine.revoke("tenant-a")
    ra = engine.run_tenant("tenant-a", gen)
    if not (ra["aborted"] and ra["fault"] > 0):
        raise AssertionError("revoked tenant must fault at the KV egress "
                             "check")
    rb = engine.run_tenant("tenant-b", gen)
    if rb["aborted"]:
        raise AssertionError("co-resident tenant must keep serving")
    log(f"after revocation: {ra} (isolation enforced; "
        f"co-resident {rb['tenant']} served {rb['served']})")

    # churn: evict the revoked tenant, admit a replacement on its pages
    evicted = engine.evict_tenant("tenant-a")
    fresh = engine.add_tenant("tenant-c", host_id=0)
    log(f"evicted {evicted.name} (pages [{evicted.kv_start_page},"
        f"+{evicted.kv_n_pages})); admitted {fresh.name} at "
        f"[{fresh.kv_start_page},+{fresh.kv_n_pages})")
    engine.submit("tenant-c", rng.integers(3, cfg.vocab - 1, prompt_len))
    rc = engine.run_tenant("tenant-c", gen)
    if rc["aborted"]:
        raise AssertionError("replacement tenant must be served")
    log(f"replacement tenant served: {rc}")
    return {"continuous": res, "continuous_s": dt,
            "tokens_per_s": tok / dt, "revoked": ra, "coresident": rb,
            "evicted": (evicted.kv_start_page, evicted.kv_n_pages),
            "readmitted": (fresh.kv_start_page, fresh.kv_n_pages),
            "replacement": rc,
            "tenants": {"tenant-a": evicted,
                        "tenant-b": engine.tenants["tenant-b"],
                        "tenant-c": fresh}}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b", choices=list(ARCHS))
    ap.add_argument("--preset", default="smoke", choices=["smoke", "full"])
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = ARCHS[args.arch] if args.preset == "full" \
        else smoke_config(ARCHS[args.arch])
    params = registry.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), dev)
    engine = ServeEngine(cfg, params, batch=args.batch,
                         cap=args.prompt_len + args.gen, device=dev)
    run_demo(engine, requests=args.requests, prompt_len=args.prompt_len,
             gen=args.gen)


if __name__ == "__main__":
    main()
