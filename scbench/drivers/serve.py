"""Driver of the serving cell: a model of the port served by ``ServeEngine``
to HWPID tenants on a ``ShardedFabric``, decode only, closed loop, back
to back.

Set-up draws the weights from the seed in the published layout
(``reference.granite_hybrid.init_weights`` over the configuration file's
published keys), loads them into the program through its own loader
(``hybrid_moe.from_published``, which shares their storage), admits
``tenants`` tenants on ``hosts`` hosts (tenant i on host i * hosts //
tenants), queues ``batch`` prompts of ``prompt_len`` token ids a tenant
(drawn from the seed over the whole vocabulary) and runs one engine tick,
which prefills every tenant's group and decodes its first token, then one
more tick.  Every tick of the window then checks each tenant's KV lines
(``HostRuntime.check`` and one fused ``step_egress`` launch for all
tenants) and decodes one token for each of its sequences.  With ``gen``
tokens to generate no group retires in the window.

The timed step is one engine tick, ``tick(n, active) -> (tokens,
faults)`` (``n`` counts the ticks from 0): the token each active tenant's sequences decoded (int32 [T,
B], on the device) and each lane's fault code (int32 [T, B], on the host;
-1 where the tenant made no step).

Words: each active sequence's tick is one checked KV line through the
fused egress, so the words of the window are the tokens it decoded: the
lanes whose fault code is 0.

Judging: ``CANDIDATES`` x ``samples`` (tick, tenant, sequence) triples
are kept, drawn from the seed over the window's ticks (a reservoir): the
tenant's last logits for that sequence, copied on the device into a
buffer made before the window, and the tokens it had consumed.  After the
window the plain reference (``reference.granite_hybrid``) runs its full
forward over each candidate's tokens on the card, in the reservoir's
order, until ``samples`` are judged: its last logits against the kept
ones.  The program keeps every token's experts (`tracing` routes, on
from set-up), and each candidate's routing is compared with the
reference's first.  At the first token and layer where they differ, a
reference margin (its k-th router logit less its (k+1)-th) under
``TIE_MARGIN`` is a tie: the two f32 computations, whose router logits
differ by ~1e-6, picked different experts by rounding, which moves the
later logits by up to ~1e-2 through the Mamba2 state, so the candidate is
passed over.  A wider margin there is a routing fault
(``routing_mismatches``, limit 0).
Besides, ``TICKS_KEPT`` whole ticks are kept, drawn from the seed: every
active sequence's logits and the token the tick reported for it.  Each
reported token has to be a greedy pick of its logits (its logit the
row's largest); one that is not is a ``token_mismatches``.  The logit
comparison judges what the program computed on a few sequences, this one
what it answered on every sequence of a tick.
``--control drops`` and ``--control bf16`` put the reference with
capacity 1.25 (per decode batch of ``batch`` tokens) or in bfloat16 in
the program's place; ``--control range`` puts the reference's own logits
at the position before, so the comparison has to tell the logits of a
range of tokens from those of the range one token shorter.

On the CPU (tests only: ``run.py`` needs a card) the cell runs at the
widths and sizes of its workload file's ``cpu`` entry, with the port's
plain versions in place of its kernels.

A traced run counts the MoE's slots and experts hit on the device from the
window's start, and switches the port's spans on only once the profiler
has stopped, so that no span's range lands in the trace.
"""
from __future__ import annotations

import gc
import random
import time

import numpy as np
import torch

from ..harness import TRACE_SECONDS, Tracer
from ..reference import granite_hybrid as ref
from ..roofline import moe as work
from ..roofline import peaks

CONTROLS = {"drops": {"capacity_factor": 1.25},
            "bf16": {"dtype": torch.bfloat16},
            "range": {}}
CANDIDATES = 8
TICKS_KEPT = 2
TIE_MARGIN = 1e-4


class Samples:
    """A reservoir of ``k`` decode results drawn from the seed: each kept
    one is its tenant, its sequence, the tokens consumed and the logits,
    copied into a buffer of ``bufs``."""

    def __init__(self, rng: random.Random, bufs: torch.Tensor):
        self.rng = rng
        self.bufs = bufs
        self.items: list = []
        self.seen = 0

    def offer(self, tenants: list, batch: int, first: dict) -> None:
        self.seen += 1
        k = self.bufs.shape[0]
        j = len(self.items) if len(self.items) < k else \
            self.rng.randrange(self.seen)
        if j >= k:
            return
        t = self.rng.choice(tenants)
        seq = self.rng.randrange(batch)
        self.bufs[j].copy_(t.logits[seq, -1])
        out = t.out[seq]
        tokens = out[:t.plen] + [first[t.name][seq]] + out[t.plen:-1]
        item = (t.name, seq, tokens, self.seen)
        if j == len(self.items):
            self.items.append(item)
        else:
            self.items[j] = item


class Ticks:
    """A reservoir of ``k`` ticks drawn from the seed: every active
    sequence's logits (rows in the tick's tenant order, then sequence) and
    the tick's reported tokens and fault codes, copied into buffers made
    before the window."""

    def __init__(self, rng: random.Random, k: int, rows: int, vocab: int,
                 shape: tuple, device):
        self.rng = rng
        self.logits = torch.empty((k, rows, vocab), dtype=torch.float32,
                                  device=device)
        self.tokens = torch.empty((k, *shape), dtype=torch.int32,
                                  device=device)
        self.faults = torch.empty((k, *shape), dtype=torch.int32)
        self.kept = 0
        self.seen = 0

    @property
    def nbytes(self) -> int:
        return (self.logits.numel() + self.tokens.numel()) * 4

    def offer(self, active: list, tokens, faults) -> None:
        self.seen += 1
        k = self.logits.shape[0]
        j = self.kept if self.kept < k else self.rng.randrange(self.seen)
        if j >= k:
            return
        self.kept = max(self.kept, j + 1)
        b = tokens.shape[1]
        for i, t in enumerate(active):
            if t.logits is not None:
                self.logits[j, i * b:(i + 1) * b].copy_(t.logits[:, -1])
        self.tokens[j].copy_(tokens)
        self.faults[j].copy_(faults)

    def mismatches(self) -> tuple[int, int]:
        """(sequences whose reported token is not a greedy pick of its
        logits, sequences judged), over the kept ticks' lanes with no
        fault."""
        bad = judged = 0
        for j in range(self.kept):
            tok = self.tokens[j].reshape(-1).long()
            ok = (self.faults[j].reshape(-1) == 0).to(tok.device)
            lg = self.logits[j]
            inside = (tok >= 0) & (tok < lg.shape[1])
            picked = lg.gather(1, tok.clamp(0, lg.shape[1] - 1)[:, None])
            greedy = inside & (picked[:, 0] == lg.max(1).values)
            bad += int((ok & ~greedy).sum())
            judged += int(ok.sum())
        return bad, judged


def run(ctx) -> None:
    from repro_torch import tracing
    from repro_torch.launch.serve import ServeEngine
    from repro_torch.models import hybrid_moe

    pub, p, rec, dev = ctx.config, ctx.params, ctx.record, ctx.device
    on_card = dev.type == "cuda"
    if not on_card:
        pub = {**pub, **p["cpu"]["config"]}
        p = {**p, **p["cpu"]["params"]}
    sync = torch.cuda.synchronize if on_card else None
    n_hosts, n_tenants = p["hosts"], p["tenants"]
    batch, plen, gen = p["batch"], p["prompt_len"], p["gen"]
    cfg = hybrid_moe.config_from_published(pub, arch_id=pub["name"])
    tracing.enable(spans=False, counters=False, routes=True)
    ctx.phase("imports")

    with torch.no_grad():
        weights = ref.init_weights(
            pub, torch.Generator(device=dev).manual_seed(ctx.seed), dev)
    params = hybrid_moe.from_published(cfg, weights)
    if on_card:
        sync()
    ctx.phase("weights")
    engine = ServeEngine(cfg, params, batch=batch, cap=plen + gen,
                         fused_egress=True, n_hosts=n_hosts, device=dev)
    rng = np.random.default_rng(ctx.seed)
    for i in range(n_tenants):
        name = f"tenant-{i}"
        engine.add_tenant(name, host_id=i * n_hosts // n_tenants)
        for prompt in rng.integers(0, cfg.vocab, (batch, plen)):
            engine.submit(name, prompt)
    tenants = list(engine.tenants.values())
    ctx.phase("deployment")

    def tick(n, active):
        res = engine.step(gen=gen)
        tokens = torch.stack([t.cur[:, 0] for t in active])
        faults = torch.tensor(
            [[res[t.name]["fault"] if t.name in res else -1] * batch
             for t in active], dtype=torch.int32)
        return tokens, faults
    step = tick
    if ctx.wrap_step is not None:
        step = ctx.wrap_step(step)
    step = ctx.spans.wrap("serve.step", step)

    step(0, tenants)          # prefill every tenant, decode one token
    if on_card:
        sync()
        ctx.log(f"device memory after prefill: {torch.cuda.memory_allocated()}"
                f" B held, {torch.cuda.max_memory_allocated()} B at the peak")
    ctx.phase("prefill")
    step(1, tenants)
    # the prefill's picks, read once here: a sample's tokens are the
    # prompt, this pick and then what decode picked (`Tenant.out`)
    first = {t.name: t.first.tolist() for t in tenants}
    routes = {t.name: t.cache["routes"] for t in tenants}   # grows in place
    pool = CANDIDATES * p["samples"]
    keep = Samples(random.Random(f"samples:{ctx.seed}"),
                   torch.empty((pool, cfg.vocab_padded),
                               dtype=torch.float32, device=dev))
    whole = Ticks(random.Random(f"ticks:{ctx.seed}"), TICKS_KEPT,
                  n_tenants * batch, cfg.vocab_padded, (n_tenants, batch),
                  dev)
    if on_card:
        sync()
    ctx.phase("warm-up")

    tracer = Tracer(ctx.trace, sync)
    ticks = words = fault_lanes = tenant_steps = faulted = 0
    decode_bytes = 0
    bytes_of = {}
    counts_profiled = {}
    gc.collect()
    gc.freeze()
    gc.disable()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    if ctx.trace:
        tracing.enable(spans=False, counters=True, routes=True)
    tracer.start()
    t0 = time.perf_counter()
    rec.setup_s = t0 - ctx.t_start
    deadline = t0 + ctx.seconds
    stalled = 0.0
    spanned = 0         # ticks with the port's spans on (traced run)
    while True:
        active = [t for t in tenants if t.group is not None]
        tokens, faults = step(ticks + 2, active)
        ticks += 1
        if len(active) == n_tenants:
            whole.offer(active, tokens, faults)
        for t, lanes in zip(active, faults.tolist()):
            if lanes[0] < 0:
                continue
            tenant_steps += 1
            if lanes[0]:
                faulted += 1
                fault_lanes += len(t.out)
                continue
            words += len(t.out)
            pos = t.pos - 1             # the position this step decoded
            if pos not in bytes_of:
                bytes_of[pos] = work.decode_bytes(pub, batch, pos)
            decode_bytes += bytes_of[pos]
        keep.offer([t for t in active if t.logits is not None], batch, first)
        spanned += tracing.spans_on()
        if tracer.active and time.perf_counter() - t0 >= TRACE_SECONDS:
            stalled += tracer.stop()
            counts_profiled = tracing.take_counters()
            tracing.enable(spans=True, counters=True, routes=True)
        if ticks >= pool and time.perf_counter() >= deadline and \
                (spanned or not ctx.trace):
            break
    if on_card:
        sync()
    t1 = time.perf_counter()
    gc.enable()
    gc.unfreeze()
    tracer.stop()
    counts = tracing.take_counters()
    spans = tracing.take()
    tracing.disable()

    rec.window_s = t1 - t0 - stalled
    rec.attempted = tenant_steps
    ctx.log(f"ticks {ticks}, tenant decodes {tenant_steps}, tokens {words}")
    rec.counters.update(words=words, ticks=ticks)
    d, f = pub["hidden_size"], pub["intermediate_size"]
    if ctx.trace:
        for s in spans:
            rec.spans[s.name].append((s.end_ns - s.start_ns) * 1e-9)
        hit = counts.get("moe.experts_hit", 0) + \
            counts_profiled.get("moe.experts_hit", 0)
        n_bytes = decode_bytes + hit * work.expert_bytes(d, f)
        rec.counters["decode_bound_s"] = n_bytes / peaks.HBM_BYTES_PER_S
        if on_card and counts_profiled:
            b, ops = work.grouped_ffn_work(counts_profiled["moe.slots"],
                                           counts_profiled["moe.experts_hit"],
                                           d, f)
            rec.counters["profiled_ffn_bound_s"] = peaks.least_time_s(
                b, ops, work.card_f32_flops_per_s())
        ctx.log(f"counters: profiled {counts_profiled}, rest {counts}")
    if on_card:
        peak = torch.cuda.max_memory_allocated()
        held = keep.bufs.numel() * 4 + whole.nbytes
        rec.memory_peak_bytes = peak - held
        ctx.log(f"device memory: window peak {peak} B, of which the "
                f"judge's sample buffers {held} B")
    rec.trace = tracer.summary()
    if rec.trace is not None and rec.counters.get("profiled_ffn_bound_s"):
        kernel_s = rec.trace.device_s("moe_grouped_ffn")
        if kernel_s > 0:
            ctx.log(f"moe_grouped_ffn: {kernel_s:.6f} s on the device in "
                    f"the trace, "
                    f"{100 * rec.counters['profiled_ffn_bound_s'] / kernel_s}"
                    f" % of its roofline")

    # judge: the reference's full forward over each sample's tokens
    for t in tenants:
        t.cache = None
    del engine
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    control = dict(CONTROLS[ctx.control]) if ctx.control else None
    if ctx.control == "drops":
        control["capacity_group"] = batch
    abs_err = rel_err = 0.0
    bad = judged = tied = misrouted = 0
    with torch.no_grad():
        for j, (name, seq, tokens, tick) in enumerate(keep.items):
            if judged == p["samples"]:
                break
            toks = torch.tensor(tokens, dtype=torch.int64, device=dev)
            margins, ref_routes = [], []
            logits = ref.forward(weights, pub, toks, margins=margins,
                                 routes=ref_routes)
            want = logits[-1]
            split = first_split(routes[name], ref_routes, seq)
            if split is not None:
                pos, layer = split
                margin = float(margins[layer][pos])
                where = (f"candidate {name} seq {seq} at tick {tick}: "
                         f"routing differs first at token {pos} of "
                         f"{len(tokens)}, layer {layer}, margin "
                         f"{margin:.3e}")
                if margin < TIE_MARGIN:
                    tied += 1
                    ctx.log(where + ", a tie: passed over")
                    continue
                misrouted += 1
                ctx.log(where + ": a routing fault")
            judged += 1
            if control is None:
                got = keep.bufs[j]
            elif ctx.control == "range":
                got = logits[-2]
            else:
                got = ref.forward(weights, pub, toks, **control)[-1]
            err = float((got - want).abs().max())
            rel = err / float(want.abs().max())
            ctx.log(f"sample {name} seq {seq} at tick {tick} "
                    f"({len(tokens)} tokens): max abs err {err:.3e}, "
                    f"rel {rel:.3e}, max |logit| "
                    f"{float(want.abs().max()):.3f}")
            abs_err, rel_err = max(abs_err, err), max(rel_err, rel)
            bad += err > LOGIT_ABS_LIMIT or rel > LOGIT_REL_LIMIT
    not_greedy, picks = whole.mismatches()
    ctx.log(f"ticks kept whole {whole.kept}: {picks} tokens judged, "
            f"{not_greedy} not a greedy pick of their logits")
    rec.failed = faulted + bad + misrouted + not_greedy
    rec.counters.update(judged=judged, tied=tied, picks_judged=picks)
    rec.checks = {"logit_max_abs_err": (abs_err, LOGIT_ABS_LIMIT),
                  "logit_max_rel_err": (rel_err, LOGIT_REL_LIMIT),
                  "routing_mismatches": (misrouted, 0),
                  "token_mismatches": (not_greedy, 0),
                  "egress_fault_lanes": (fault_lanes, 0),
                  "samples_missing": (p["samples"] - judged, 0)}


def first_split(record: list, ref_routes: list, seq: int):
    """(token, layer) where the program's experts for sequence ``seq``
    (its routing record: per layer, [B, tokens, K] tensors in order)
    first differ from the reference's (per layer, [S, K]), as sets; None
    where they agree for every token the reference saw."""
    first = None
    for layer, (calls, want) in enumerate(zip(record, ref_routes)):
        got = torch.cat([c[seq] for c in calls])[:want.shape[0]]
        differs = (got.sort(-1).values != want.sort(-1).values).any(-1)
        hit = torch.nonzero(differs)
        if hit.numel() and (first is None or int(hit[0]) < first[0]):
            first = (int(hit[0]), layer)
    return first


# Limits of the logit comparison, f32 program against the f32 reference
# (logits of about 1.4-1.6 at these weights), from two readings on the
# card (PERF.md section 2): the program's largest error over its seeds,
# 5.8e-6 absolute and 3.9e-6 relative over 36 samples of 9 seeds with the
# weights `init_weights` draws (f32 sums in another order over ~2,100
# positions; 1.9e-4 absolute and 1.3e-4 relative with an earlier draw of
# slower Mamba2 decays, A = -1 and dt ~ 0.01), and the reference computed
# in bfloat16, 2.1e-2 to 3.9e-2 absolute and 1.3e-2 to 2.6e-2 relative,
# which must fail.  The limits sit ten times above the earlier draw's
# largest reading and ten times below bf16's smallest.
LOGIT_ABS_LIMIT = 2e-3
LOGIT_REL_LIMIT = 2e-3
