#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's checked egress path, its serving path and
its training path on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one CUDA card and the
CUDA toolkit.  Phases, each reported on its own line:

  1. device — the card as torch and ``nvidia-smi`` name it, power limit;
  2. build — the six kernels compiled from ``src/repro_torch/kernels/
     csrc`` (nvcc, sm_90a), with ptxas' register and spill lines; the
     three search kernels (permcheck, checked_memcrypt, fabric_egress)
     must not spill;
  3. kernel phases — each kernel held against its plain PyTorch version on
     the card (the egress kernels bit-exact; flash attention within the
     reference's 2e-5 (f32) / 3e-2 (bf16) on the reference's sweeps and at
     qwen3-4b's serving shapes, prefill and decode, f32 and bf16), and
     timed beside its bound and, where one PyTorch call computes the same
     function, that call.  A lookup's bound counts the probes and the
     table words of a search of the sorted shard (``search_work``).  The
     flash shapes are timed L2-cold, over a rotation of q/k/v sets larger
     than twice the L2 (as each layer of a decode step finds its own
     cache), with the L2-warm time beside; each regime must run exactly
     its own kernels (``FLASH_PATHS``), and the f32 prefill kernel must
     not spill; the grouped expert FFN (``moe_grouped_ffn``) at
     granite-4.0-h-small's widths (72 experts x 4096 x 768, top-10) at a
     tenant decode's 16 tokens and a prefill chunk's 8,192, held against
     its per-expert loop within 1e-4 of the outputs' scale and timed
     beside its bound; then granite at full width with one Mamba2 and one
     attention layer: a prefill, then decode steps (eager, captured into
     CUDA graphs, replayed) whose grouped-kernel and flash launches are
     counted from zero;
  4. main path 1, the checked egress path — the quickstart flow on one
     host through the port's FabricManager and ops, then a 255-host /
     127-tenant ShardedFabric (1 GiB SDM, 8192-entry table, 4096 words per
     row) stepping through the fabric kernel with an evict + quiesce
     mid-run, then a host's checker through its PermCache twice;
 4b. the examples — ``examples/torch_quickstart.py`` (the framework
     checker on the card, no kernel) and ``examples/torch_multihost_graph_
     sharing.py`` (8 hosts on one GAPBS graph: the secret words through
     the memcrypt kernel, 4 fabric steps through the fabric-egress kernel
     with a revocation mid-run) on the card, each record (verdicts, fault
     codes, ciphertext, CPI rows, denied lanes, words, fabric stats) equal
     to a ``device="cpu"`` run's; the multihost run launches memcrypt
     twice and fabric_egress 4 times, and nothing else;
  5. main path 2, serving — qwen3-4b at full width (f32 parameters made on
     the card from a seed) through ``ServeEngine(fused_egress=True)``: the
     serving CLI's sequence (two co-resident tenants, revocation, eviction,
     re-admission) with each layer's first prefill and decode attention,
     and every fabric launch's words and fault codes, held against the
     plain version; then one decode step's launches, wall time and device
     busy share, and the first group's logits against a plain-attention
     run;
  6. main path 3, the chaos storm — the reference's fault matrix at 255
     hosts (112 tenants, 5 seeds x 14 rounds): dropped, duplicated,
     reordered and delayed BISnp copies, one FM crash epoch, one host that
     falls silent, is listed by the heartbeat monitor, is fenced and
     rejoins cold.  Every round every revoked span is checked through
     `HostRuntime.check` on the card and, with every live tenant's row,
     through one `step_egress` (the fabric kernel): no route may release
     a word.  Then restart + quiesce barriers until every host is back in
     sync; every fabric launch is held against the plain version;
  7. main path 4, the clocked timing path — 127 tenants on 255 hosts on a
     `ClockedFabric`, GAPBS traces of an RMAT scale-13 graph as 127 x
     512-word fabric steps between `begin_trace` and `end_trace`, each
     launch held against the plain version; the same run with
     ``device="cpu"`` must give the same trace, replay report and words;
     then the replay's propagation percentiles and the PermCache timing
     penalty (simulated cycles at the paper's Table 2 timings, not card
     times) and the steady step's kernel time;
  8. main path 5, MoE serving — olmoe-1b-7b at full width and depth (f32)
     through main path 2's sequence and checks, its decode step's device
     time by op beside the expert-weight floor (every expert read once a
     step), and the logits check under the router rule: a top-k choice
     that flips between the kernel and the plain-attention run at a
     probability gap under ``ROUTER_FLIP_GAP`` is the router's
     discontinuity (the per-layer attention check then stands), a flip at
     a larger gap a fault;
 8b. main path 5b, the mesh — the same olmoe parameters on the 1x1
     ("data", "model") mesh in a one-rank NCCL process group: a prefill at
     batch 4 and 8 greedy decode steps, bit-identical to the same steps
     without a mesh (else the first module that differs is named), every
     MoE layer through the model-axis body (its ``all_reduce`` calls
     counted), the flash kernel launched; the decode step's wall under the
     mesh with the layers' ``constrain`` calls and without them;
     ``validate_specs`` of every arch on both production meshes;
  9. the family phase — falcon-mamba-7b at full width with 8 of its 64
     layers (no kernel: held to a ``device="cpu"`` run on the same
     weights) and zamba2-1.2b at full width and depth, both served through
     the engine; seamless-m4t-medium at full width and depth through
     prefill/decode with 64 encoder frames (the engine has none), every
     attention, cross attention included, through the flash kernel;
 10. the shared-experts flow of ``examples/torch_serve_shared_experts.py``
     at olmoe's full width and depth (16 layers: three 8 GiB expert
     regions, each row mapped to its own page past 2 GiB);
 11. main path 6, training — first one train step of qwen1.5-0.5b at full
     width with 2 layers (f32) on the card and on the CPU from the same
     weights and batch (loss, grad-norm, every gradient and every
     parameter's step held by norm); then the launcher's loop on
     qwen1.5-0.5b ``--preset full`` (bf16 parameters, f32 moments, remat
     full) at batch 8 x 256 for 50 steps on the 1x1 NCCL mesh, its state
     placed by the rule engine, its first losses equal to a meshless
     run's bit for bit (every parameter has a non-zero gradient after
     step 1, the loss DECREASED, no flash launch: training attends through
     the differentiable path), an asynchronous checkpoint at step 25
     restored from LATEST bit for bit and re-placed onto the mesh by
     ``elastic_reshard`` into a fresh model that finishes the run and
     trains 10 more steps, and the re-placed checkpoint's first leaf
     encrypted and decrypted with the host key through the memcrypt
     kernel; then the step's wall, device time by op (the remat recompute
     by a profiler scope), tokens/s, peak memory and FLOP share.
 12. the dry run, a host check — ``python -m repro_torch.launch.dryrun
     --arch qwen1.5-0.5b --shape decode_32k --mesh single`` in a process
     of its own with the card hidden from it (the dry run traces fake host
     tensors on a fake 256-rank process group and never touches a
     device): its record must say OK with the reference's 1,668,721,700
     argument bytes per rank, and this process' card memory must not
     move; the record's FLOPs and the phase's wall are logged.  It holds
     the DTensor, FakeStore and ``local_map`` calls the dry run makes to
     this machine's torch.
  Each main path's kernel launch counts are zeroed just before it and read
  just after: each of its kernels must have launched.

Then one JSON line of per-kernel results and, last, the run's verdict
``{"ok": true, "device": {...}}``.  Any mismatch or failed check raises
and the script exits non-zero; without a CUDA device it prints no result
and exits 2.
"""
from __future__ import annotations

import copy
import functools
import gc
import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys
import time
from collections import OrderedDict
from dataclasses import replace
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.configs import PORT_ARCHS  # noqa: E402
from repro_torch.convert import u32_from_numpy  # noqa: E402
from repro_torch.core import (FAULT_NO_ENTRY, FAULT_PERM,  # noqa: E402
                              PERM_RW, RING_USER, FabricManager, FaultPlan,
                              FaultSpec, FMUnavailable, Proposal,
                              ShardedFabric, pack_ext_addr, tenant_permbits)
from repro_torch.core.fabric import stack_views  # noqa: E402
from repro_torch.data import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.kernels import (_build, bucket_pad, launches,  # noqa: E402
                                 ops, reset_launches)
from repro_torch.kernels import fabric_egress as fe  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import memcrypt as mc  # noqa: E402
from repro_torch.kernels import moe_grouped_ffn as mgf  # noqa: E402
from repro_torch.kernels import permcheck as pc  # noqa: E402
from repro_torch.checkpointing import elastic_reshard, store  # noqa: E402
from repro_torch.launch import activations, train  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.launch import sharding as sh  # noqa: E402
from repro_torch.launch.activations import use_mesh  # noqa: E402
from repro_torch.launch.serve import ServeEngine, run_demo  # noqa: E402
from repro_torch.launch.steps import build_train_step  # noqa: E402
from repro_torch.layers import attention as attn_mod  # noqa: E402
from repro_torch.layers import mamba as mamba_mod  # noqa: E402
from repro_torch.layers import moe_dropless, moe_ep  # noqa: E402
from repro_torch.layers.attention import Attention  # noqa: E402
from repro_torch.layers.moe import init_moe, route  # noqa: E402
from repro_torch.memsim.clock import ClockedFabric, TimingConfig  # noqa: E402
from repro_torch.memsim.replay import replay, timing_penalty  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.optim import init_state  # noqa: E402
from repro_torch.workloads import gapbs, graphs  # noqa: E402

SEED = 0
# H100 SXM HBM bandwidth (NVIDIA H100 datasheet).
PEAK_BYTES_PER_S = 3.35e12
# The kernels do int32 work: add, logic, shift, funnel shift and compare
# issue at 64 per clock per SM on compute capability 9.0 (CUDA C++
# Programming Guide, arithmetic instruction throughput).  The int32 peak is
# that times the card's SM count times its maximum SM clock, both read from
# the card (132 SMs at 1980 MHz give 16.7e12 per second on an H100 SXM; the
# datasheet's 67 TFLOP/s counts each fp32 FMA as two operations).
INT32_OPS_PER_CLOCK_PER_SM = 64
KEYSTREAM_OPS = 52      # per word: 6 setup, 12 rounds x (add, rotate, xor),
#                         7 key adds, 2 position, 1 data XOR (egress.cuh)
PROBE_OPS = 3           # per probe of a sorted search: compare, select, add
INT32_MAX = np.iinfo(np.int32).max

SDM_PAGES = 1 << 18     # 1 GiB SDM at 4 KiB pages
N_HOSTS, N_PROCS = 255, 127
PAGES_PER_PROC = 32
WORDS_PER_ROW = 4096
KEY0, KEY1 = 0xAB, 0xCD

SOURCES = {
    "memcrypt": ("src/repro_torch/kernels/csrc/memcrypt.cu",
                 "src/repro/kernels/memcrypt.py:79"),
    "permcheck": ("src/repro_torch/kernels/csrc/permcheck.cu",
                  "src/repro/kernels/permcheck.py:398"),
    "checked_memcrypt": ("src/repro_torch/kernels/csrc/checked_memcrypt.cu",
                         "src/repro/kernels/memcrypt.py:148"),
    "fabric_egress": ("src/repro_torch/kernels/csrc/fabric_egress.cu",
                      "src/repro/kernels/fabric_egress.py:170"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:96"),
    "moe_grouped_ffn": ("src/repro_torch/kernels/csrc/moe_grouped_ffn.cu",
                        "none (the reference's capacity dispatch leaves "
                        "its expert products to XLA)"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls after one warm-up,
    from CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_times(fn, kernel: str, reps: int = 5) -> dict:
    """Device time (ms) per call of ``fn`` of each CUDA kernel whose symbol
    contains ``kernel`` (the wrapper's helper ops excluded), from
    `torch.profiler`; empty when the profiler records no device time (one
    retry: the profiler now and then returns no device events)."""
    fn()
    torch.cuda.synchronize()
    for _ in range(2):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        times = {e.key: _device_us(e) / reps / 1e3
                 for e in prof.key_averages()
                 if kernel in e.key and _device_us(e) > 0}
        if times:
            return times
    return {}


def kernel_only_ms(fn, kernel: str, reps: int = 5):
    """Device time of the CUDA kernels whose symbols contain ``kernel`` per
    call of ``fn``; None when the profiler records no device time."""
    return sum(kernel_times(fn, kernel, reps).values()) or None


def _device_us(evt) -> float:
    """Device time (us) of a device-side profiler event; 0 for host-side
    ops, whose device time would count their kernels twice."""
    if getattr(evt, "device_type", None) != torch.autograd.DeviceType.CUDA:
        return 0.0
    return float(getattr(evt, "self_device_time_total", None)
                 or getattr(evt, "self_cuda_time_total", 0.0))


@functools.cache
def int32_peak() -> tuple[float, int, float]:
    """(int32 operations per second, SM count, maximum SM clock in MHz) of
    card 0."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = float(subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.strip())
    return INT32_OPS_PER_CLOCK_PER_SM * sms * mhz * 1e6, sms, mhz


def bound(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """Least time (ms) for the work: bytes over HBM bandwidth or int32
    operations over the int32 peak, whichever is larger."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / int32_peak()[0] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def fabric_bound(ext, fault, view) -> tuple[float, str]:
    """Bound of one fabric egress over this data: 16 bytes per word (data
    and address in, word and fault out), 4 per row (its HWPID) and the
    table words the search reads; the search's probes on every word and
    the keystream on the granted words."""
    probes, table_bytes = search_work(ext & 0xFFFFFF, view)
    return bound(16 * ext.numel() + 4 * ext.shape[0] + table_bytes,
                 KEYSTREAM_OPS * int((fault == 0).sum())
                 + PROBE_OPS * probes)


def compare(name: str, got, want) -> tuple[int, int]:
    """(mismatching elements, max |difference|) of kernel vs plain outputs;
    raises on any mismatch."""
    mism, err = 0, 0
    for g, w in zip(got, want):
        d = (g.to(torch.int64) - w.to(torch.int64)).abs()
        mism += int((d != 0).sum())
        err = max(err, int(d.max()) if d.numel() else 0)
    if mism:
        raise AssertionError(f"{name}: {mism} elements differ from the "
                             f"plain version (max |diff| {err})")
    return mism, err


def table(rng, n_entries: int, sdm_pages: int, dev):
    bounds = np.sort(rng.choice(sdm_pages, size=2 * n_entries, replace=False))
    starts = bounds[0::2].astype(np.int32)
    ends = bounds[1::2].astype(np.int32)
    perms = rng.integers(0, 4, n_entries).astype(np.uint32)
    return starts, ends, perms, pc.make_shard_view(starts, ends, perms,
                                                   device=dev)


def trace(rng, starts, batch: int, sdm_pages: int, kind: str, hwpid: int,
          forged: bool = True):
    """Tagged addresses: "hot" draws pages from 16 entries' starts (the
    locality the paper's cache exploits), "uniform" over the whole SDM;
    with ``forged``, a share of untagged, foreign-tag and -1 padding lanes."""
    if kind == "hot":
        pages = starts[rng.integers(0, 16, batch)] + rng.integers(0, 2, batch)
    else:
        pages = rng.integers(0, sdm_pages, batch)
    tags = np.full(batch, hwpid, np.int64)
    if forged:
        tags = rng.choice([hwpid] * 6 + [0, hwpid % 126 + 1, -1], batch)
    return ((tags << 24) | (pages & 0xFFFFFF)).astype(np.int32)


def ceil_log2(x: torch.Tensor) -> torch.Tensor:
    """ceil(log2 x) elementwise, 0 for x <= 1."""
    return torch.ceil(torch.log2(x.clamp(min=1).to(torch.float64))).long()


def search_work(pages, view) -> tuple[float, float]:
    """(probes, table bytes) of a search of the sorted shard for this data.

    Per address: ceil(log2 live tiles) probes of the live tiles' first
    starts, for the last one at or below its page; ceil(log2 live entries
    of that tile) probes of the tile's starts, for the last one at or below
    (none when the page lies below the shard's first start); 1 read of the
    entry found.  Bytes: 4 for each distinct first start or start that a
    probe reads, 4 for the end of each distinct entry found and 4 for its
    permission bits where it covers the page: each table word once,
    however many addresses read it.  ``pages`` [..., B] against a view
    with starts [..., N]; each row searches its own shard."""
    n = view.starts.shape[-1]
    starts = view.starts.reshape(-1, n).long()
    rows = starts.shape[0]
    ends = view.ends.reshape(rows, n).long()
    tmin = view.tile_min.reshape(rows, -1).long()
    n_tiles = tmin.shape[1]
    pages = pages.reshape(rows, -1).long()
    live = (starts != INT32_MAX).reshape(rows, n_tiles, -1).sum(-1)
    row = torch.arange(rows, device=pages.device)[:, None]

    def search(n_live, read, base, width):
        """A fixed-trip search for the last value <= page among the
        ``n_live`` values of ``read`` from column ``base`` on: ceil(log2
        n_live) probes.  Returns (offset found, probes, flat indices
        read)."""
        first = torch.where(n_live > 1,
                            1 << (ceil_log2(n_live) - 1).clamp(min=0), 0)
        off = torch.zeros_like(pages)
        probes = torch.zeros_like(pages)
        seen = []
        s = 1 << max(width - 1, 1).bit_length() - 1
        while s:
            on = s <= first
            idx = (base + off + s).clamp(max=read.shape[1] - 1)
            off = torch.where(on & (read.gather(1, idx) <= pages), off + s,
                              off)
            probes += on
            seen.append((row * read.shape[1] + idx)[on.expand_as(idx)])
            s >>= 1
        return off, probes, seen

    t, p1, seen_t = search((live > 0).sum(-1, keepdim=True), tmin, 0,
                           n_tiles)
    found = tmin.gather(1, t) <= pages
    seen_t.append(row * n_tiles + t)
    in_tile = torch.where(found, live.gather(1, t), 0)
    e, p2, seen_s = search(in_tile, starts, t * pc.ENTRY_TILE,
                           pc.ENTRY_TILE)
    k = (t * pc.ENTRY_TILE + e).clamp(max=n - 1)
    covered = found & (pages < ends.gather(1, k))
    flat_k = row * n + k
    words = sum(torch.unique(torch.cat([x.reshape(-1) for x in xs])).numel()
                for xs in (seen_t, seen_s, [flat_k[found]],
                           [flat_k[covered]]))
    return float((p1 + p2 + 1).sum()), 4.0 * words


def library_permcheck(ext, starts, ends, permbits, hwpid: int, need: int):
    """The same function as one library search: `torch.searchsorted` over
    the sorted starts plus the end, tag and permission compares (a yardstick
    only; the port never calls it)."""
    page = ext & 0xFFFFFF
    k = torch.searchsorted(starts, page, right=True) - 1
    kc = k.clamp(min=0)
    cov = (k >= 0) & (page < ends[kc])
    allowed = ((ext >> 24) == hwpid) & cov & ((permbits[kc] & need) == need)
    return allowed, torch.where(cov, k, -1).to(torch.int32)


def kernel_phases(dev, results: dict) -> None:
    rng = np.random.default_rng(SEED)

    # -- memcrypt: 2^24 words ------------------------------------------------
    n = 1 << 24
    data = u32_from_numpy(rng.integers(0, 1 << 32, n, dtype=np.uint32), dev)
    base = 2**32 - 4096            # the counter wraps inside the buffer
    got = mc.memcrypt(data, key0=KEY0, key1=KEY1, base_word=base)
    want = mc.ref.memcrypt(data, KEY0, KEY1, base)
    mism, err = compare("memcrypt", [got], [want])
    b_ms, b_by = bound(8 * n, KEYSTREAM_OPS * n)
    results["memcrypt"] = dict(
        shape=f"{n} words", mismatches=mism, max_abs_err=err,
        call_ms=cuda_ms(lambda: mc.memcrypt(data, key0=KEY0, key1=KEY1,
                                            base_word=base), 50),
        kernel_only_ms=kernel_only_ms(lambda: mc.memcrypt(
            data, key0=KEY0, key1=KEY1, base_word=base), "memcrypt_kernel"),
        plain_ms=cuda_ms(lambda: mc.ref.memcrypt(data, KEY0, KEY1, base), 3),
        bound_ms=b_ms, bound_by=b_by, library_ms=None)
    log(f"phase memcrypt: {n} words bit-exact; "
        f"kernel {results['memcrypt']['kernel_only_ms']} ms, call "
        f"{results['memcrypt']['call_ms']:.4f} ms (bound {b_ms:.4f} ms, "
        f"{b_by})")

    # -- permcheck: 65536-entry shard, 2^16 addresses, 3 modes x 2 traces ----
    sdm = 1 << 24
    starts, ends, perms, view = table(rng, pc.MAX_ENTRIES, sdm, dev)
    b = 1 << 16
    phases, mism_all, err_all = [], 0, 0
    for kind in ("hot", "uniform"):
        ext = torch.from_numpy(trace(rng, starts, b, sdm, kind, 3)).to(dev)
        chosen = pc.selected_mode(ext, view)
        probes, table_bytes = search_work(ext & 0xFFFFFF, view)
        b_ms, b_by = bound(9 * b + table_bytes, PROBE_OPS * probes)
        want = pc.permcheck_view_plain(ext, view, hwpid=3, need=1)
        plain_ms = cuda_ms(lambda: pc.permcheck_view_plain(
            ext, view, hwpid=3, need=1), 1)
        lib = library_permcheck(ext, view.starts, view.ends, view.permbits,
                                3, 1)
        compare("searchsorted yardstick", lib, want)
        lib_ms = cuda_ms(lambda: library_permcheck(
            ext, view.starts, view.ends, view.permbits, 3, 1), 20)
        for mode in ("flat", "hier", "adaptive"):
            got = pc.permcheck_view(ext, view, hwpid=3, need=1, mode=mode)
            m, e = compare(f"permcheck {mode}/{kind}", got, want)
            mism_all, err_all = mism_all + m, max(err_all, e)
            call = (lambda: pc.permcheck_view(ext, view, hwpid=3, need=1,
                                              mode=mode))
            ms = cuda_ms(call, 5)
            k_ms = kernel_only_ms(call, "permcheck_kernel")
            phases.append(dict(mode=mode, trace=kind, selected=chosen,
                               call_ms=ms, kernel_only_ms=k_ms,
                               plain_ms=plain_ms, library_ms=lib_ms,
                               bound_ms=b_ms, bound_by=b_by))
            log(f"phase permcheck {mode:8s} {kind:7s}: bit-exact; kernel "
                f"{k_ms} ms, call {ms:.4f} ms (bound {b_ms:.4f} ms {b_by}; "
                f"searchsorted {lib_ms:.4f} ms; selector picks {chosen})")
    head = next(p for p in phases
                if p["mode"] == "adaptive" and p["trace"] == "hot")
    results["permcheck"] = dict(
        shape=f"{b} addresses x {pc.MAX_ENTRIES} entries",
        mismatches=mism_all, max_abs_err=err_all,
        **{k: head[k] for k in ("call_ms", "kernel_only_ms", "plain_ms",
                                "library_ms", "bound_ms", "bound_by")},
        phases=phases)

    # -- checked_memcrypt: same shard, denied / forged / padding lanes -------
    phases, mism_all, err_all = [], 0, 0
    fault_mix = np.zeros(6, np.int64)
    for kind in ("hot", "uniform"):
        ext = torch.from_numpy(trace(rng, starts, b, sdm, kind, 3)).to(dev)
        ext[::97] = -1                              # padding lanes
        d = u32_from_numpy(rng.integers(0, 1 << 32, b, dtype=np.uint32), dev)
        args = dict(hwpid=3, need=2, key0=KEY0, key1=KEY1, base_word=11)
        got = mc.checked_memcrypt_view(d, ext, view, **args)
        want = mc.checked_memcrypt_view_plain(d, ext, view, **args)
        m, e = compare(f"checked_memcrypt/{kind}", got, want)
        mism_all, err_all = mism_all + m, max(err_all, e)
        faults = torch.bincount(want[1], minlength=6).tolist()
        fault_mix += faults
        n_ok = int((want[1] == 0).sum())
        probes, table_bytes = search_work(ext & 0xFFFFFF, view)
        b_ms, b_by = bound(16 * b + table_bytes,
                           KEYSTREAM_OPS * n_ok + PROBE_OPS * probes)
        call = (lambda: mc.checked_memcrypt_view(d, ext, view, **args))
        ms = cuda_ms(call, 5)
        plain_ms = cuda_ms(lambda: mc.checked_memcrypt_view_plain(
            d, ext, view, **args), 1)
        phases.append(dict(trace=kind, call_ms=ms, plain_ms=plain_ms,
                           kernel_only_ms=kernel_only_ms(
                               call, "checked_memcrypt_kernel"),
                           bound_ms=b_ms, bound_by=b_by, faults=faults))
        log(f"phase checked_memcrypt {kind:7s}: bit-exact; faults by code "
            f"{faults}; kernel {phases[-1]['kernel_only_ms']} ms, call "
            f"{ms:.4f} ms (bound {b_ms:.4f} ms {b_by})")
    if fault_mix[:5].min() == 0:
        raise AssertionError(f"fault mix lacks a code: {fault_mix}")
    head = phases[0]
    results["checked_memcrypt"] = dict(
        shape=f"{b} words x {pc.MAX_ENTRIES} entries", mismatches=mism_all,
        max_abs_err=err_all, library_ms=None,
        **{k: head[k] for k in ("call_ms", "kernel_only_ms", "plain_ms",
                                "bound_ms", "bound_by")},
        phases=phases)

    # -- fabric_egress: 127 rows x 4096 words, flat and hier rows mixed ------
    views, exts = [], []
    for r in range(N_PROCS):
        n_entries = (8192, 4096, 2048)[r % 3] if r % 16 == 0 else 2
        s, e, p, v = table(rng, n_entries, 1 << 22, dev)
        views.append(v)
        kind = "hot" if r % 32 == 0 else "uniform"
        exts.append(trace(rng, s if n_entries > 16 else np.repeat(s, 8),
                          WORDS_PER_ROW, 1 << 22, kind, r % 127 + 1))
    fview = stack_views(views, [r % 127 + 1 for r in range(N_PROCS)],
                        range(N_PROCS), epoch=0)
    ext = torch.from_numpy(np.stack(exts)).to(dev)
    d = u32_from_numpy(rng.integers(0, 1 << 32, tuple(ext.shape),
                                    dtype=np.uint32), dev)
    use_hier = fe._per_host_use_hier(
        pc.pad_batch(ext, mc.BLOCK) & 0xFFFFFF, fview.tile_min,
        fview.tile_max, block=min(8, WORDS_PER_ROW // 1024) * 1024)
    n_hier = int(use_hier.sum())
    if not 0 < n_hier < N_PROCS:
        raise AssertionError(f"{n_hier} hier rows: flat and hier rows must "
                             "share the launch")
    args = dict(need=1, key0=KEY0, key1=KEY1)
    got = fe.fabric_egress(d, ext, fview, **args)
    want = fe.fabric_egress_plain(d, ext, fview, **args)
    mism, err = compare("fabric_egress", got, want)
    b_ms, b_by = fabric_bound(ext, want[1], fview)
    results["fabric_egress"] = dict(
        shape=f"{N_PROCS} rows x {WORDS_PER_ROW} words, {n_hier} hier rows, "
              f"{fview.starts.shape[1]} entries per row",
        mismatches=mism, max_abs_err=err,
        call_ms=cuda_ms(lambda: fe.fabric_egress(d, ext, fview, **args), 20),
        kernel_only_ms=kernel_only_ms(
            lambda: fe.fabric_egress(d, ext, fview, **args),
            "fabric_egress_kernel"),
        plain_ms=cuda_ms(lambda: fe.fabric_egress_plain(d, ext, fview,
                                                        **args), 1),
        bound_ms=b_ms, bound_by=b_by, library_ms=None)
    log(f"phase fabric_egress: {N_PROCS}x{WORDS_PER_ROW}, {n_hier} hier "
        f"rows, bit-exact; kernel {results['fabric_egress']['kernel_only_ms']}"
        f" ms, call {results['fabric_egress']['call_ms']:.4f} ms "
        f"(bound {b_ms:.4f} ms {b_by})")


def quickstart(dev) -> None:
    """The quickstart flow on one host through the port's FM and ops:
    grant, validated context, encrypt, check, fused decrypt, revoke."""
    rng = np.random.default_rng(SEED + 1)
    fm = FabricManager(sdm_pages=262_144, table_capacity=4096)
    host0 = fm.enroll_host(0)
    hwpid = host0.get_next_pid()
    base_p = 0x7F00_0000
    assert fm.propose(Proposal(0, hwpid, base_p, 0, 1024, PERM_RW))
    host0.context_switch(core=0, hwpid=hwpid, base_p=base_p)
    assert host0.arm_label(core=0, ring=RING_USER)
    tag = host0.current_hwpid(0)

    plain = rng.integers(0, 1 << 32, 8192, dtype=np.uint32)
    ct = ops.memory_encrypt(plain, key0=KEY0, key1=KEY1)
    pages = (np.arange(8192) // 4) % 2048         # half inside the grant
    ext = pack_ext_addr(np.full(8192, tag), pages).to(dev)

    def decrypt():
        t = fm.table.to_device()
        s = t.starts[:t.n]
        e = s + t.sizes[:t.n]
        pb = tenant_permbits(t, tag)[:t.n]
        allowed, _ = ops.permission_check(ext, s, e, pb, hwpid=tag, need=1)
        out, fault = ops.checked_memory_decrypt(
            ct, ext, s, e, pb, hwpid=tag, need=1, key0=KEY0, key1=KEY1)
        return allowed.cpu().numpy(), out.cpu().numpy().view(np.uint32), \
            fault.cpu().numpy()

    allowed, out, fault = decrypt()
    inside = pages < 1024
    assert (allowed == inside).all()
    assert (out[inside] == plain[inside]).all() and (out[~inside] == 0).all()
    assert (fault[~inside] == FAULT_NO_ENTRY).all()
    fm.revoke_hwpid(hwpid)
    allowed, out, fault = decrypt()
    assert not allowed.any() and not out.any()
    assert (fault[inside] == FAULT_PERM).all()
    log("main quickstart: grant -> encrypt -> check -> fused decrypt -> "
        "revoke on the card: OK")


def fabric_main_path(dev) -> dict:
    """The 255-host / 127-tenant deployment through `step_egress`, with one
    tenant evicted mid-run, then a host's checker twice."""
    rng = np.random.default_rng(SEED + 2)
    t0 = time.perf_counter()
    fab = ShardedFabric(SDM_PAGES, table_capacity=8192, n_shards=N_HOSTS)
    for h in range(N_HOSTS):
        fab.enroll(h)
    active = [p * N_HOSTS // N_PROCS for p in range(N_PROCS)]
    tenants = {h: fab.admit(h, PAGES_PER_PROC) for h in active}
    fab.quiesce()
    setup_s = time.perf_counter() - t0
    assign = {h: tenants[h][0] for h in active}
    rows = fab.fabric_rows(assign)
    ext = np.stack([
        np.asarray(pack_ext_addr(
            np.full(WORDS_PER_ROW, pid),
            tenants[h][1] + rng.integers(0, PAGES_PER_PROC, WORDS_PER_ROW)))
        for h, pid in rows])
    data = rng.integers(0, 1 << 32, ext.shape, dtype=np.uint32)
    bp = bucket_pad(WORDS_PER_ROW, mc.BLOCK)
    assert bp == WORDS_PER_ROW      # rows sit back to back in the keystream
    clear = mc.ref.memcrypt(u32_from_numpy(data, dev), KEY0, KEY1, 0)
    victim_row = 0
    step_ms = []
    for step in range(6):
        if step == 3:
            h, pid = rows[victim_row]
            fab.evict(h, pid)
            fab.quiesce()
        torch.cuda.synchronize()
        t = time.perf_counter()
        out, fault = fab.step_egress(data, ext, assign, need=1,
                                     key0=KEY0, key1=KEY1)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
        live = torch.ones(len(rows), dtype=torch.bool, device=dev)
        if step >= 3:
            live[victim_row] = False
            assert bool((fault[victim_row] > 0).all()), "revoked row leaked"
            assert bool((out[victim_row] == 0).all()), "revoked row leaked"
        assert bool((fault[live] == 0).all()), f"step {step}: false denial"
        assert bool((out[live] == clear[live]).all()), \
            f"step {step}: bad words"
        if step == 3:
            # the deployment's own launch, revoked row included, against
            # the plain version on the same inputs, code for code
            fview = fab.fabric_view(assign)
            compare("fabric_egress main path", (out, fault),
                    fe.fabric_egress_plain(data, ext, fview, need=1,
                                           key0=KEY0, key1=KEY1))
            b_ms, b_by = fabric_bound(torch.from_numpy(ext).to(dev), fault,
                                      fview)
    log(f"main fabric: {N_HOSTS} hosts, {N_PROCS} tenants, "
        f"{WORDS_PER_ROW} words/row, 6 steps, evict+quiesce after step 2: "
        f"revoked row fully denied, {N_PROCS - 1} rows fault-free; step 3 "
        f"bit-exact against the plain version (words and fault codes); "
        f"setup {setup_s:.3f} s; step wall ms "
        f"{[round(x, 4) for x in step_ms]}; kernel bound {b_ms:.4f} ms "
        f"({b_by})")

    # where a steady step's time goes: device time by op over the wall time
    # of an unprofiled steady step (the device's busy share)
    def step():
        return fab.step_egress(data, ext, assign, need=1, key0=KEY0,
                               key1=KEY1)

    reps = 20
    wall_ms = cuda_ms(step, reps)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            step()
        torch.cuda.synchronize()
    device_ops = sorted(((e.key, _device_us(e) / reps / 1e3)
                         for e in prof.key_averages() if _device_us(e) > 0),
                        key=lambda kv: -kv[1])
    device_ms = sum(ms for _, ms in device_ops)
    kernel_ms = sum(ms for k, ms in device_ops if "fabric_egress_kernel" in k)
    log(f"main fabric steady step: {wall_ms:.4f} ms per step, device busy "
        f"{device_ms:.4f} ms ({100 * device_ms / wall_ms:.1f} %); kernel "
        f"{kernel_ms:.4f} ms against its bound {b_ms:.4f} ms; top device "
        f"ops {[(k[:40], round(v, 4)) for k, v in device_ops[:6]]}")

    h, pid = rows[1]
    rt = fab.runtimes[h]
    wr = np.zeros(WORDS_PER_ROW, bool)
    first = rt.check(ext[1], wr)
    second = rt.check(ext[1], wr)
    assert bool(first.allowed.all()) and bool(second.allowed.all())
    assert int(second.probes.sum()) == 0, "second batch missed the cache"
    log(f"main checker: host {h} first batch probes "
        f"{int(first.probes.sum())}, second batch all hits, probes 0; "
        f"cache hit rate {rt.permcache.hit_rate:.4f}")
    return dict(setup_s=setup_s, step_wall_ms=step_ms,
                steady_step_ms=wall_ms, steady_device_ms=device_ms,
                step_kernel_ms=kernel_ms, step_bound_ms=b_ms,
                step_bound_by=b_by, device_ops=device_ops[:8],
                stats=fab.stats()["bus"])


# -- the reference's examples on the card ------------------------------------

# The kernels each example's card run launches, and how often: the
# quickstart checks through the framework checker (no kernel); the
# multihost example encrypts and decrypts the secret words and takes 4
# fabric steps.
EXAMPLE_LAUNCHES = {
    "torch_quickstart": {},
    "torch_multihost_graph_sharing": {"memcrypt": 2, "fabric_egress": 4},
}


def load_example(name: str):
    """``examples/<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    return example


def examples_path(dev) -> dict:
    """Each example on the card, its launch counts zeroed before and read
    after, then with ``device="cpu"`` (the plain versions): the two
    records must be equal, key for key."""
    t0 = time.perf_counter()
    out = {"launches": dict.fromkeys(launches, 0)}
    for name, want in EXAMPLE_LAUNCHES.items():
        example = load_example(name)
        t = time.perf_counter()
        reset_launches()
        card = example.run(device=dev,
                           log=lambda m: log("examples: " + m.lstrip("\n")))
        torch.cuda.synchronize()
        counts = dict(launches)
        card_s = time.perf_counter() - t
        t = time.perf_counter()
        cpu = example.run(device="cpu", log=lambda m: None)
        cpu_s = time.perf_counter() - t
        if counts != {k: want.get(k, 0) for k in launches}:
            raise AssertionError(f"examples: {name} launched {counts}, not "
                                 f"{want} and nothing else")
        differ = sorted(set(card) ^ set(cpu)) + \
            [k for k in cpu if k in card and card[k] != cpu[k]]
        if differ:
            raise AssertionError(f"examples: {name} on the card differs from "
                                 f"its device='cpu' run at {differ}")
        for k, n in counts.items():
            out["launches"][k] += n
        out[name] = dict(launches=counts, card_s=card_s, cpu_s=cpu_s,
                         compared=sorted(cpu))
        if "replay" in card:
            out[name].update(
                denied=[step["denied"] for step in card["replay"]],
                cpi=card["cpi"], stats_bus=card["stats"]["bus"])
        log(f"examples: {name} on the card equals its device='cpu' run "
            f"({', '.join(sorted(cpu))}); launches {counts}; card "
            f"{card_s:.3f} s, CPU {cpu_s:.3f} s")
    out["wall_s"] = time.perf_counter() - t0
    log(f"examples: phase wall {out['wall_s']:.3f} s")
    return out


# -- the serving slice ------------------------------------------------------

# Peak float rates of one H100 SXM (NVIDIA H100 datasheet, dense): 67 TFLOP/s
# in f32 on the CUDA cores (the flash kernel's f32 path: IEEE FMA, no
# TF32), 989 TFLOP/s in bf16 on the tensor cores.
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
L2_BYTES = 50 * 2**20       # H100 SXM L2 cache (NVIDIA H100 datasheet)
FLASH_F32_TOL, FLASH_BF16_TOL = 2e-5, 3e-2   # tests/test_kernels_flash.py
# (b, h, hkv, sq, sk, dh, causal, window): the reference's flash sweeps
# (ragged, GQA/MQA, non-causal, window, dh 128) plus rows on the kernel's
# 16-row q tile (Sq <= 16: decode and short prompts)
FLASH_SWEEP = [
    (2, 4, 4, 128, 128, 64, True, -1), (2, 4, 4, 256, 384, 64, True, -1),
    (2, 4, 4, 200, 200, 64, True, -1), (1, 8, 2, 128, 128, 64, True, -1),
    (1, 4, 1, 128, 128, 64, True, -1), (1, 2, 2, 128, 256, 64, False, -1),
    (1, 2, 2, 256, 256, 64, True, 64), (1, 2, 2, 256, 256, 64, True, 160),
    (1, 2, 2, 128, 128, 128, True, -1), (2, 4, 2, 1, 300, 256, True, 40),
    (1, 4, 2, 9, 40, 64, True, 8),
    # seamless's cross attention: non-causal prefill with Sq > Sk, and the
    # non-causal split-K decode over the encoder frames
    (4, 16, 16, 256, 64, 64, False, -1), (4, 16, 16, 1, 64, 64, False, -1),
]
# qwen3-4b serving: batch 4, prompt 1024, 32 generated tokens
SERVE_ARCH, SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = "qwen3-4b", 4, 1024, 32
SERVE_REQUESTS = 8
LOGITS_TOL = 1e-3
# A top-k choice flips where two router probabilities are closer than the
# attention error (about 1e-6 in f32): a flip at a gap under this is the
# router's discontinuity, at a larger gap a fault.
ROUTER_FLIP_GAP = 1e-5
# decode-step device time by op: aten ops (self device time) per category
OP_CATEGORIES = {
    "expert bmm": ("aten::bmm",),
    "dense matmul": ("aten::mm", "aten::addmm"),
    "dispatch and gather": (
        "aten::index", "aten::index_put_", "aten::_index_put_impl_",
        "aten::cumsum", "aten::sort", "aten::one_hot", "aten::gather",
        "aten::take_along_dim", "aten::bincount", "aten::cat",
        "aten::scatter", "aten::where", "aten::nonzero"),
}


def close(got, want, tol: float) -> float:
    """max |got - want|; raises unless |got - want| <= tol + tol * |want|
    everywhere (the reference tests' rtol = atol)."""
    g, w = got.float(), want.float()
    err = float((g - w).abs().max())
    if not bool(((g - w).abs() <= tol + tol * w.abs()).all()):
        raise AssertionError(f"max |diff| {err} beyond rtol = atol = {tol}")
    return err


# the kernels each flash regime must run (flash_attention.cu)
FLASH_PATHS = {"decode": ("flash_decode_split_kernel",
                          "flash_decode_combine_kernel"),
               "prefill f32": ("flash_prefill_f32_kernel",),
               "prefill bf16": ("flash_prefill_bf16_kernel",)}


def flash_symbol(key: str) -> str:
    """``flash_..._kernel<...>`` out of a profiler key or a demangled
    symbol."""
    m = re.search(r"flash_\w+_kernel(<[^>]*>)?", key)
    return m.group(0) if m else key


def check_flash_build(build_log: str) -> None:
    """ptxas' registers and spills of every flash kernel, one line each;
    raises if the f32 prefill kernel (the CUDA-core path) spills."""
    entry, spills = None, {}
    for line in build_log.splitlines():
        m = re.search(r"entry function '(\w+)'", line)
        if m:
            entry = m.group(1)
            continue
        if entry is None or "flash_" not in entry:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills[entry] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            name = re.search(r"flash_(decode|prefill)_[a-z0-9]+_kernel",
                             entry).group(0)
            args = ["bf16" if "bfloat16" in entry else "f32"] + re.findall(
                r"Li(\d+)E", entry)     # dtype, dh[, rows per block]
            log(f"  flash build: {name}<{', '.join(args)}>: {m.group(1)} "
                f"registers, {spills.get(entry, 0)} bytes spilled")
            entry = None
    bad = [e for e, n in spills.items() if "prefill_f32" in e and n]
    if bad:
        raise AssertionError(f"the f32 prefill kernel spills: {bad}")


# the three search kernels (egress.cuh lane_search), each in its 16-byte
# (WIDE) and its scalar instantiation
SEARCH_KERNELS = ("permcheck_kernel", "checked_memcrypt_kernel",
                  "fabric_egress_kernel")


def check_search_build(build_log: str) -> None:
    """ptxas' registers and spills of each search kernel instantiation, one
    line each; raises if one spills or is missing from the log."""
    entry, spills, seen = None, {}, set()
    for line in build_log.splitlines():
        m = re.search(r"entry function '(\w+)'", line)
        if m:
            entry = m.group(1) if any(k in m.group(1)
                                      for k in SEARCH_KERNELS) else None
            continue
        if entry is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills[entry] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            name = next(k for k in SEARCH_KERNELS if k in entry)
            wide = "true" if "ILb1E" in entry else "false"
            seen.add(name)
            log(f"  search build: {name}<WIDE={wide}>: {m.group(1)} "
                f"registers, {spills.get(entry, 0)} bytes spilled")
            entry = None
    bad = [e for e, n in spills.items() if n]
    if bad or seen != set(SEARCH_KERNELS):
        raise AssertionError(f"search kernels spill ({bad}) or are missing "
                             f"from the build log (seen {sorted(seen)})")


def flash_work(b, h, hkv, sq, sk, dh, causal, window, itemsize):
    """(bytes, flops) the attention function needs: q, k, v and o once;
    4 * dh FLOPs per visible (query, key) pair."""
    q_pos = np.arange(sq)[:, None] + (sk - sq)
    k_pos = np.arange(sk)[None, :]
    vis = np.ones((sq, sk), bool)
    if causal:
        vis &= k_pos <= q_pos
    if window > 0:
        vis &= k_pos > q_pos - window
    n_bytes = itemsize * dh * (2 * b * h * sq + 2 * b * hkv * sk)
    return n_bytes, 4.0 * b * h * int(vis.sum()) * dh


def flash_bound(case, dtype) -> tuple[float, str]:
    n_bytes, flops = flash_work(*case, itemsize=torch.finfo(dtype).bits // 8)
    peak = PEAK_F32_FLOPS if dtype == torch.float32 else PEAK_BF16_FLOPS
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def flash_phase(dev, results: dict) -> None:
    """The flash kernel against its plain version on every sweep and on the
    serving shapes, timed beside its bound and PyTorch's SDPA."""
    rng = np.random.default_rng(SEED + 3)

    def qkv(b, h, hkv, sq, sk, dh, dtype):
        mk = lambda *shape: torch.from_numpy(
            rng.normal(size=shape).astype(np.float32)).to(dev, dtype)
        return mk(b, h, sq, dh), mk(b, hkv, sk, dh), mk(b, hkv, sk, dh)

    err_all = 0.0
    for case in FLASH_SWEEP:
        b, h, hkv, sq, sk, dh, causal, window = case
        for dtype, tol in ((torch.float32, FLASH_F32_TOL),
                           (torch.bfloat16, FLASH_BF16_TOL)):
            q, k, v = qkv(b, h, hkv, sq, sk, dh, dtype)
            want = fa.flash_attention_plain(q, k, v, causal=causal,
                                            window=window)
            got = fa.flash_attention(q, k, v, causal=causal, window=window)
            torch.cuda.synchronize()
            err = close(got, want, tol)
            if dtype == torch.float32:
                err_all = max(err_all, err)
    log(f"phase flash sweeps: {len(FLASH_SWEEP)} shapes x (f32, bf16) "
        f"within tolerance; f32 max |diff| {err_all:.3e}")

    cfg = ARCHS[SERVE_ARCH]
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    cap = SERVE_PROMPT + SERVE_GEN
    shapes = [
        ("prefill f32", (SERVE_BATCH, h, hkv, SERVE_PROMPT, SERVE_PROMPT,
                         dh, True, -1), torch.float32),
        ("decode f32", (SERVE_BATCH, h, hkv, 1, cap, dh, True, -1),
         torch.float32),
        ("prefill bf16", (SERVE_BATCH, h, hkv, SERVE_PROMPT, SERVE_PROMPT,
                          dh, True, -1), torch.bfloat16),
        ("decode bf16", (SERVE_BATCH, h, hkv, 1, cap, dh, True, -1),
         torch.bfloat16),
    ]
    phases = []
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    for label, case, dtype in shapes:
        b, h_, hkv_, sq, sk, dh_, causal, window = case
        q, k, v = qkv(b, h_, hkv_, sq, sk, dh_, dtype)
        tol = FLASH_F32_TOL if dtype == torch.float32 else FLASH_BF16_TOL
        want = fa.flash_attention_plain(q, k, v, causal=causal,
                                        window=window)
        got = fa.flash_attention(q, k, v, causal=causal, window=window)
        err = close(got, want, tol)
        # distinct q/k/v sets, more bytes in all than the L2 holds twice:
        # cycling through them, each call finds its operands cold in L2, as
        # each of a decode step's layers finds its own cache
        set_bytes = sum(t.numel() * t.element_size() for t in (q, k, v))
        sets = [(q, k, v)] + [
            tuple(torch.randn(t.shape, generator=gen, device=dev,
                              dtype=torch.float32).to(dtype)
                  for t in (q, k, v))
            for _ in range(max(2, -(-2 * L2_BYTES // set_bytes)))]
        for qs, ks, vs in sets[1:2]:
            close(fa.flash_attention(qs, ks, vs, causal=causal,
                                     window=window),
                  fa.flash_attention_plain(qs, ks, vs, causal=causal,
                                           window=window), tol)
        turn = iter(range(1 << 62))

        def cold():
            qs, ks, vs = sets[next(turn) % len(sets)]
            return fa.flash_attention(qs, ks, vs, causal=causal,
                                      window=window)

        # SDPA aligns a causal mask top-left: it computes the same function
        # only at Sq == Sk (prefill) or Sq == 1 without a mask (decode)
        sdpa = functools.partial(
            torch.nn.functional.scaled_dot_product_attention, q, k, v,
            is_causal=sq > 1, enable_gqa=True)
        close(sdpa(), want, tol if dtype != torch.float32 else 1e-4)

        def sdpa_cold():
            qs, ks, vs = sets[next(turn) % len(sets)]
            return torch.nn.functional.scaled_dot_product_attention(
                qs, ks, vs, is_causal=sq > 1, enable_gqa=True)


        warm = (lambda: fa.flash_attention(q, k, v, causal=causal,
                                           window=window))
        b_ms, b_by = flash_bound(case, dtype)
        reps = len(sets) * (4 if sq > 1 else 40)
        times = {flash_symbol(key): ms for key, ms in kernel_times(
            cold, "flash_", reps=len(sets) * 2).items()}
        path = FLASH_PATHS["decode" if sq <= fa.DECODE_MAX_SQ else label]
        ran = {re.sub(r"<.*", "", key) for key in times}
        if times and ran != set(path):
            raise AssertionError(f"flash {label} ran {sorted(times)}, not "
                                 f"{path}")
        ph = dict(shape=label, q=list(q.shape), k=list(k.shape),
                  max_abs_err=err, sets=len(sets), set_mb=set_bytes / 1e6,
                  call_ms=cuda_ms(cold, reps), kernels=times,
                  kernel_only_ms=sum(times.values()) or None,
                  warm_ms=kernel_only_ms(warm, "flash_"),
                  plain_ms=cuda_ms(lambda: fa.flash_attention_plain(
                      q, k, v, causal=causal, window=window), 3),
                  library_ms=cuda_ms(sdpa_cold, reps), bound_ms=b_ms,
                  bound_by=b_by)
        phases.append(ph)
        log(f"phase flash {label}: q {tuple(q.shape)} k {tuple(k.shape)} "
            f"max |diff| {err:.3e}; L2-cold over {len(sets)} sets of "
            f"{set_bytes / 1e6:.1f} MB: kernel {ph['kernel_only_ms']} ms, "
            f"call {ph['call_ms']:.4f} ms; L2-warm kernel {ph['warm_ms']} "
            f"ms; plain {ph['plain_ms']:.4f} ms, SDPA (cold) "
            f"{ph['library_ms']:.4f} ms (bound {b_ms:.4f} ms, {b_by}); "
            f"kernels {times}")
        del sets
    head = phases[0]
    results["flash_attention"] = dict(
        shape=head["shape"], mismatches=0, max_abs_err=max(
            err_all, *(p["max_abs_err"] for p in phases[:2])),
        **{k: head[k] for k in ("call_ms", "kernel_only_ms", "plain_ms",
                                "library_ms", "bound_ms", "bound_by")},
        phases=phases)


# granite-4.0-h-small's dropless MoE (72 experts x 4096 x 768, top-10)
GRANITE_ARCH = "granite-4.0-h-small"
# the grouped kernel against its per-expert loop: f32 sums of 4,096 and
# 768 terms in other orders agree to ~1e-5 on outputs of order 1; a wrong
# slot, expert or weight row is off by order 1
GROUPED_FFN_TOL = 1e-4
GROUPED_FFN_TOKENS = (16, 8192)   # a tenant decode's batch; a prefill chunk
GRANITE_DECODE = dict(layer_types=("mamba", "attention"), batch=16,
                      prompt=128, steps=4)


def grouped_ffn_phase(dev, results: dict) -> dict:
    """The grouped expert FFN at granite's widths against its per-expert
    loop at a decode's and a prefill chunk's token counts, timed beside
    its bound (the weights of the experts hit and each slot's row in and
    out, or 2 x 3 x D x F f32 operations a slot); then granite at full
    width with one Mamba2 and one attention layer: a prefill, and decode
    steps (eager, then captured, then replayed) with the launch counts
    zeroed just before them.  Returns the decode run's launches."""
    cfg = PORT_ARCHS[GRANITE_ARCH]
    e, d, f, k = cfg.n_experts, cfg.d_model, cfg.expert_d_ff, cfg.top_k
    g = torch.Generator(device=dev).manual_seed(SEED + 5)
    p = init_moe(d, f, e, torch.float32, g, dev)
    phases = []
    for t in GROUPED_FFN_TOKENS:
        x = torch.randn((t, d), generator=g, device=dev)
        _, _, idx = route(x, p.router, k)
        _, tok, offsets, counts = moe_dropless.sort_slots(idx, e)
        args = (x, tok, offsets, p.w_gate, p.w_up, p.w_down)
        want = mgf.moe_grouped_ffn_plain(*args)
        err = float((mgf.moe_grouped_ffn(*args) - want).abs().max())
        scale = float(want.abs().max())
        if not (scale > 0.5 and err <= GROUPED_FFN_TOL * scale):
            raise AssertionError(f"moe_grouped_ffn at {t} tokens: max abs "
                                 f"err {err:.3e} over |y| {scale:.3f}")
        hit = int((counts > 0).sum())
        t_bytes = (hit * 3 * d * f + 2 * t * k * d) * 4 / PEAK_BYTES_PER_S
        t_ops = 6 * d * f * t * k / PEAK_F32_FLOPS
        b_ms, b_by = (t_bytes * 1e3, "bytes") if t_bytes >= t_ops else \
            (t_ops * 1e3, "operations")
        call = (lambda: mgf.moe_grouped_ffn(*args))
        phases.append(dict(
            tokens=t, slots=t * k, experts_hit=hit, max_abs_err=err,
            call_ms=cuda_ms(call, 20 if t <= 16 else 3),
            kernel_only_ms=kernel_only_ms(call, "moe_grouped_ffn_", 3),
            plain_ms=cuda_ms(lambda: mgf.moe_grouped_ffn_plain(*args), 3),
            bound_ms=b_ms, bound_by=b_by))
        log(f"phase moe_grouped_ffn {t} tokens x top-{k} over {e} x {d} x "
            f"{f} ({hit} experts hit): max abs err {err:.3e} (|y| "
            f"{scale:.3f}); kernel {phases[-1]['kernel_only_ms']} ms, call "
            f"{phases[-1]['call_ms']:.4f} ms, plain loop "
            f"{phases[-1]['plain_ms']:.4f} ms (bound {b_ms:.4f} ms {b_by})")
        del x, idx, tok, offsets, counts, args, want
    head = phases[0]
    results["moe_grouped_ffn"] = dict(
        shape=f"{GROUPED_FFN_TOKENS[0]} tokens x top-{k} over {e} x {d} x "
              f"{f}", mismatches=0,
        max_abs_err=max(ph["max_abs_err"] for ph in phases), library_ms=None,
        **{key: head[key] for key in ("call_ms", "kernel_only_ms",
                                      "plain_ms", "bound_ms", "bound_by")},
        phases=phases)
    del p
    free_card()

    # granite's decode at full width, two layers: the kernel on the path
    run = GRANITE_DECODE
    gcfg = replace(cfg, n_layers=len(run["layer_types"]),
                   layer_types=run["layer_types"])
    params = registry.init_params(
        gcfg, torch.Generator(device=dev).manual_seed(SEED), dev)
    toks = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, gcfg.vocab, (run["batch"], run["prompt"] + run["steps"]))).to(dev)
    t0 = time.perf_counter()
    with torch.no_grad():
        lg, cache = registry.prefill(
            gcfg, params, {"tokens": toks[:, :run["prompt"]]},
            cache_dtype=torch.float32, cap=run["prompt"] + run["steps"])
        torch.cuda.synchronize()
        reset_launches()
        for i in range(run["steps"]):
            pos = run["prompt"] + i
            lg, cache = registry.decode_step(gcfg, params, cache,
                                             toks[:, pos:pos + 1], pos)
        torch.cuda.synchronize()
    counts = dict(launches)
    wall = time.perf_counter() - t0
    n_attn = run["layer_types"].count("attention")
    want = {"moe_grouped_ffn": run["steps"] * gcfg.n_layers,
            "flash_attention": run["steps"] * n_attn}
    if {name: counts[name] for name in want} != want or \
            "graphs" not in cache or not bool(torch.isfinite(lg).all()):
        raise AssertionError(f"granite decode: launches {counts}, want "
                             f"{want}; graphs {'graphs' in cache}")
    log(f"phase granite decode ({gcfg.n_layers} layers {run['layer_types']}"
        f" at full width, batch {run['batch']}, {run['steps']} steps after "
        f"a {run['prompt']}-token prefill): launches {counts}; wall "
        f"{wall:.3f} s")
    del params, cache, lg
    free_card()
    return {"launches": counts, "wall_s": wall}


class AttendCheck:
    """An attention layer's ``attend``: launches the flash kernel and, on
    the layer's first prefill and first decode call, holds the kernel's
    output against the plain version on the same q/k/v."""

    def __init__(self):
        self.err = {}

    def __call__(self, q, k, v, *, causal, window):
        out = fa.flash_attention(q, k, v, causal=causal, window=window)
        kind = "prefill" if q.shape[2] > 1 else "decode"
        if kind not in self.err:
            self.err[kind] = close(out, fa.flash_attention_plain(
                q, k, v, causal=causal, window=window), FLASH_F32_TOL)
        return out


class FabricCheck:
    """Stands in for ``fabric_egress`` during a timed run (serving, the
    chaos storm, the timing path): launches the kernel and keeps a copy of
    each launch's operands and results, which `check` holds against the
    plain version once the run is over."""

    def __init__(self):
        self.kernel = fe.fabric_egress
        self.launches = []

    def __call__(self, data, ext_addrs, view, **kw):
        got = self.kernel(data, ext_addrs, view, **kw)
        copy = view._replace(**{f: getattr(view, f).clone() for f in (
            "starts", "ends", "permbits", "tile_min", "tile_max", "hwpids")})
        self.launches.append((data.clone(), ext_addrs.clone(), copy, kw,
                              tuple(x.clone() for x in got)))
        return got

    def check(self) -> int:
        """Compare every recorded launch with the plain version on its own
        operands, code for code; returns the words compared."""
        words = 0
        for data, ext, view, kw, got in self.launches:
            compare("fabric_egress (serving)", got,
                    fe.fabric_egress_plain(data, ext, view, **kw))
            words += got[0].numel()
        return words


def attention_modules(params) -> list:
    """Every attention layer of a model, in module order: a unit's, both of
    a pair's, zamba2's shared block, seamless's encoder, decoder self and
    cross attention."""
    return [m for m in params.modules() if isinstance(m, Attention)]


def set_attend(params, fn) -> None:
    for m in attention_modules(params):
        m.attend = fn


def check_attention(params) -> list:
    """One `AttendCheck` on each attention layer; returns them."""
    checks = []
    for m in attention_modules(params):
        m.attend = AttendCheck()
        checks.append(m.attend)
    return checks


def attend_errors(checks) -> dict:
    """Largest kernel-vs-plain error per kind over the `AttendCheck`s that
    saw it (an encoder layer never decodes)."""
    return {kind: max(c.err[kind] for c in checks if kind in c.err)
            for kind in ("prefill", "decode")
            if any(kind in c.err for c in checks)}


def free_card() -> None:
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


class RouterRecord:
    """Stands in for `moe_ep._route` during a model check: records each
    call's ``gate_idx`` and, per token, the gap between its k-th and
    (k+1)-th router probability."""

    def __init__(self):
        self.route = moe_ep._route
        self.calls = []

    def __call__(self, xt, router, top_k):
        out = self.route(xt, router, top_k)
        probs = torch.softmax(xt.to(router.dtype) @ router, dim=-1)
        top = probs.topk(top_k + 1, dim=-1).values
        self.calls.append((out[1].clone(),
                           (top[:, top_k - 1] - top[:, top_k]).clone()))
        return out


def router_flip(kernel_calls, plain_calls, label: str):
    """The first router call whose ``gate_idx`` differs between the kernel
    and the plain-attention run (every earlier call agreed, so only the
    attention error separates its inputs): None where none differs; raises
    where a differing token's k-th and (k+1)-th probabilities lie
    ``ROUTER_FLIP_GAP`` or more apart."""
    if len(kernel_calls) != len(plain_calls):
        raise AssertionError(f"{label}: {len(kernel_calls)} router calls in "
                             f"the kernel run, {len(plain_calls)} in the "
                             "plain run")
    for i, ((gk, gap), (gp, _)) in enumerate(zip(kernel_calls,
                                                 plain_calls)):
        diff = (gk != gp).any(-1)
        if not bool(diff.any()):
            continue
        toks = diff.nonzero()[:, 0]
        flip = dict(call=i, tokens=int(toks.numel()),
                    max_gap=float(gap[toks].max()),
                    slots=[(int(t), gk[t].tolist(), gp[t].tolist(),
                            float(gap[t])) for t in toks[:8]])
        log(f"{label}: router call {i} (of {len(kernel_calls)}) picks "
            f"other experts for {flip['tokens']} token(s) in the kernel and "
            f"the plain run: (token, kernel experts, plain experts, k-th - "
            f"(k+1)-th probability) {flip['slots']}")
        if flip["max_gap"] >= ROUTER_FLIP_GAP:
            raise AssertionError(f"{label}: a top-k choice flipped at a "
                                 f"probability gap {flip['max_gap']:.3e} >= "
                                 f"{ROUTER_FLIP_GAP}")
        return flip
    return None


def plain_attention_check(cfg, params, toks, gen0, *, cap: int, pos: int,
                          label: str) -> dict:
    """The first group's prefill and first decode step with the flash
    kernel and with plain attention (both decode the kernel run's first
    token): logits within ``LOGITS_TOL`` and argmax tokens identical, under
    the router rule for MoE; the kernel run's first generated tokens must
    equal the engine's ``gen0``."""
    runs, routes = {}, {}
    for name, fn in (("kernel", fa.flash_attention),
                     ("plain", fa.flash_attention_plain)):
        set_attend(params, fn)
        rec = RouterRecord()
        moe_ep._route = rec
        try:
            torch.cuda.synchronize()
            t = time.perf_counter()
            lg0, cache = registry.prefill(cfg, params, {"tokens": toks},
                                          cache_dtype=torch.float32, cap=cap)
            torch.cuda.synchronize()
            pre_ms = (time.perf_counter() - t) * 1e3
            # teacher-forced: both runs decode the kernel run's first token
            nxt = (runs["kernel"][0] if runs else lg0[:, -1]).argmax(-1)
            lg1, _ = registry.decode_step(cfg, params, cache,
                                          nxt[:, None].to(torch.int32), pos)
        finally:
            moe_ep._route = rec.route
        runs[name] = (lg0[:, -1], lg1[:, -1], pre_ms)
        routes[name] = rec.calls
        del cache
    set_attend(params, fa.flash_attention)
    (k0, k1, prefill_ms), (p0, p1, plain_ms) = runs["kernel"], runs["plain"]
    # the engine feeds the prefill's argmax to the first decode step and
    # records what that step picks: its first generated token
    engine_tokens = k1.argmax(-1).tolist()
    if engine_tokens != gen0:
        raise AssertionError(f"{label}: the kernel run's first tokens "
                             f"{engine_tokens} are not the engine's {gen0}")
    flip = router_flip(routes["kernel"], routes["plain"], label)
    err = float(max((k0 - p0).abs().max(), (k1 - p1).abs().max()))
    if flip is None:
        close(k0, p0, LOGITS_TOL)
        close(k1, p1, LOGITS_TOL)
        if not (bool((k0.argmax(-1) == p0.argmax(-1)).all()) and
                bool((k1.argmax(-1) == p1.argmax(-1)).all())):
            raise AssertionError(f"{label}: argmax tokens differ from the "
                                 "plain-attention run")
        log(f"{label} logits: the first group's prefill and first decode "
            f"step against plain attention: max |diff| {err:.3e} "
            f"(tolerance {LOGITS_TOL}), argmax tokens identical and equal "
            f"to the engine's {engine_tokens}; prefill wall "
            f"{prefill_ms:.1f} ms (plain attention {plain_ms:.1f} ms)")
    else:
        log(f"{label} logits: router discontinuity at call {flip['call']} "
            f"(gap {flip['max_gap']:.3e} < {ROUTER_FLIP_GAP}); the model "
            f"check falls back to the per-layer attention check; logits max "
            f"|diff| {err:.3e} (not held to {LOGITS_TOL}); the kernel run's "
            f"tokens equal the engine's {engine_tokens}")
    return dict(logits_max_abs_diff=err, router_flip=flip,
                router_calls=len(routes["kernel"]), prefill_ms=prefill_ms,
                plain_prefill_ms=plain_ms)


def serve_family(dev, cfg, *, batch: int, prompt: int, gen: int,
                 requests: int, label: str):
    """Make ``cfg`` on the card from the seed and serve it through
    ``ServeEngine(fused_egress=True)`` with the serving CLI's sequence,
    each attention layer's first prefill and decode and every fabric
    launch held against the plain version.  Returns (params, engine, demo,
    facts)."""
    t0 = time.perf_counter()
    params = registry.init_params(
        cfg, torch.Generator(device=dev).manual_seed(SEED), dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    attn = "" if cfg.family == "ssm" else (
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads, dh {cfg.head_dim}, d_ff "
        f"{cfg.d_ff}, ")
    log(f"{label}: {cfg.arch_id} at full width (f32): {cfg.n_layers} "
        f"layers, d {cfg.d_model}, {attn}vocab {cfg.vocab}; "
        f"{n_params / 1e9:.3f} B parameters made in {init_s:.2f} s")
    checks = check_attention(params)
    engine = ServeEngine(cfg, params, batch=batch, cap=prompt + gen,
                         fused_egress=True, device=dev)
    fabric_check = FabricCheck()
    fe.fabric_egress = fabric_check    # ShardedFabric.step_egress's kernel
    reset_launches()
    try:
        demo = run_demo(engine, requests=requests, prompt_len=prompt,
                        gen=gen, seed=SEED, log=lambda m: log(f"{label}: {m}"))
        torch.cuda.synchronize()
        counts = dict(launches)
    finally:
        fe.fabric_egress = fabric_check.kernel
    log(f"{label} path launches: {counts}")
    n = len(fabric_check.launches)
    if n != counts["fabric_egress"] or n == 0:
        raise AssertionError(f"{label}: {n} recorded fabric calls, "
                             f"{counts['fabric_egress']} launches")
    log(f"{label}: {n} fabric launches held against the plain version on "
        f"their own inputs after the run: 0 mismatching words and fault "
        f"codes over {fabric_check.check()} words")
    flash_err = attend_errors(checks)
    if checks:
        if counts["flash_attention"] == 0:
            raise AssertionError(f"flash_attention never launched on the "
                                 f"{label} path")
        log(f"{label}: every attention layer's first prefill and first "
            f"decode held against the plain version on its own q/k/v: max "
            f"|diff| {flash_err}")
    set_attend(params, fa.flash_attention)
    return params, engine, demo, dict(
        arch=cfg.arch_id, layers=cfg.n_layers, params=n_params,
        init_s=init_s, launches=counts, flash_vs_plain=flash_err,
        continuous_s=demo["continuous_s"],
        tokens_per_s_continuous=demo["tokens_per_s"],
        outcomes={k: demo[k] for k in ("continuous", "revoked",
                                       "coresident", "evicted",
                                       "readmitted", "replacement")})


def first_group(demo, batch: int, dev):
    """The first group of tenant-a: its prompts as a token tensor and the
    first token the engine generated for each."""
    done = demo["tenants"]["tenant-a"].done[:batch]
    toks = torch.from_numpy(np.stack([p for p, _ in done])
                            .astype(np.int32)).to(dev)
    return toks, [g[0] for _, g in done]


def decode_step_profile(engine, tenant: str, gen: int, prompts) -> dict:
    """One steady decode step of ``tenant``: launches, wall times, device
    busy time, and the device time by op (the flash and fabric kernels by
    symbol, the rest by the aten op that launched it, self time)."""
    for p in prompts:
        engine.submit(tenant, p)
    engine.step(gen=gen, only=tenant)                 # prefill + decode 1
    reset_launches()
    engine.step(gen=gen, only=tenant)
    torch.cuda.synchronize()
    per_step = {k: n for k, n in launches.items() if n}
    step_ms = []
    for _ in range(5):
        torch.cuda.synchronize()
        t = time.perf_counter()
        engine.step(gen=gen, only=tenant)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
    reps = 3
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            engine.step(gen=gen, only=tenant)
        torch.cuda.synchronize()
    events = prof.key_averages()
    device_ops = sorted(((e.key, _device_us(e) / reps / 1e3)
                         for e in events if _device_us(e) > 0),
                        key=lambda kv: -kv[1])
    device_ms = sum(ms for _, ms in device_ops)
    by_op = {"attention (flash kernel)": sum(
        ms for k, ms in device_ops if "flash_" in k),
        "fabric egress kernel": sum(
            ms for k, ms in device_ops if "fabric_egress_kernel" in k)}
    self_ms = {e.key: float(getattr(e, "self_device_time_total", None)
                            or getattr(e, "self_cuda_time_total", 0.0))
               / reps / 1e3
               for e in events if e.key.startswith("aten::")}
    for cat, names in OP_CATEGORIES.items():
        by_op[cat] = sum(self_ms.get(n, 0.0) for n in names)
    named = {n for names in OP_CATEGORIES.values() for n in names}
    by_op["elementwise and other aten ops"] = sum(
        ms for k, ms in self_ms.items() if k not in named)
    by_op["unattributed"] = device_ms - sum(by_op.values())
    return dict(launches_per_decode_step=per_step, decode_step_ms=step_ms,
                decode_step_median_ms=float(np.median(step_ms)),
                decode_device_ms=device_ms, decode_device_by_op=by_op,
                decode_flash_ms=by_op["attention (flash kernel)"],
                decode_device_ops=device_ops[:10])


def serve_main_path(dev, arch: str, label: str, then=None) -> dict:
    """A decoder LM (qwen3-4b, olmoe-1b-7b) at full width and depth, f32
    (reference defect 5), through the serving CLI's sequence
    (`serve_family`); then one decode step's launches, wall time, device
    busy time and device time by op (for MoE beside the expert-weight
    floor: every expert read once a step), and the first group's logits
    against a plain-attention run.  ``then(cfg, params)``, if given, runs
    last on the same parameters (its result under ``"then"``; its wall is
    not the phase's)."""
    t0 = time.perf_counter()
    cfg = replace(ARCHS[arch], param_dtype="float32")
    params, engine, demo, out = serve_family(
        dev, cfg, batch=SERVE_BATCH, prompt=SERVE_PROMPT, gen=SERVE_GEN,
        requests=SERVE_REQUESTS, label=label)
    for name in ("flash_attention", "fabric_egress"):
        if out["launches"][name] == 0:
            raise AssertionError(f"{name} never launched on the {label} "
                                 "path")
    rng = np.random.default_rng(SEED + 4)
    prof = decode_step_profile(
        engine, "tenant-b", SERVE_GEN,
        [rng.integers(3, cfg.vocab - 1, SERVE_PROMPT)
         for _ in range(SERVE_BATCH)])
    per_step = prof["launches_per_decode_step"]
    n_attn = len(attention_modules(params))
    log(f"{label}: launches in one decode step of one tenant: {per_step}")
    if per_step.get("flash_attention") != n_attn or \
            per_step.get("fabric_egress") != 1:
        raise AssertionError(f"expected {n_attn} flash and 1 fabric launch "
                             f"per decode step, got {per_step}")
    floor = {}
    if cfg.family == "moe":
        floor["expert_bytes"] = sum(
            getattr(u.moe, w).numel() * 4 for u in params.layers
            for w in ("w_gate", "w_up", "w_down"))
        floor["expert_floor_ms"] = \
            floor["expert_bytes"] / PEAK_BYTES_PER_S * 1e3
    decode_ms = prof["decode_step_median_ms"]
    by_op = {k: round(v, 3) for k, v in prof["decode_device_by_op"].items()}
    log(f"{label} decode step (batch {SERVE_BATCH}, one tenant): wall ms "
        f"{[round(x, 3) for x in prof['decode_step_ms']]} (median "
        f"{decode_ms:.3f}, {SERVE_BATCH * 1e3 / decode_ms:.1f} tok/s); "
        f"device busy {prof['decode_device_ms']:.3f} ms "
        f"({100 * prof['decode_device_ms'] / decode_ms:.1f} %), flash "
        f"{prof['decode_flash_ms']:.3f} ms"
        + (f"; expert-weight floor {floor['expert_bytes'] / 1e9:.2f} GB / "
           f"{PEAK_BYTES_PER_S:.3e} B/s = {floor['expert_floor_ms']:.3f} ms"
           if floor else "")
        + f"; device ms by op {by_op}; top device ops "
        f"{[(k[:48], round(v, 4)) for k, v in prof['decode_device_ops'][:8]]}")
    toks, gen0 = first_group(demo, SERVE_BATCH, dev)
    check = plain_attention_check(cfg, params, toks, gen0,
                                  cap=SERVE_PROMPT + SERVE_GEN,
                                  pos=SERVE_PROMPT, label=label)
    tok_s = SERVE_BATCH * SERVE_PROMPT * 1e3 / check["prefill_ms"]
    log(f"{label} prefill: {SERVE_BATCH} x {SERVE_PROMPT} tokens in "
        f"{check['prefill_ms']:.1f} ms ({tok_s:.0f} tokens/s)")
    del engine, demo
    free_card()
    wall = time.perf_counter() - t0
    after = then(cfg, params) if then is not None else None
    del params
    free_card()
    log(f"{label}: phase wall {wall:.3f} s; cut: f32 parameters (reference "
        f"defect 5)")
    return dict(out, **prof, **check, **floor, prefill_tokens_per_s=tok_s,
                wall_s=wall, cut="f32 parameters (reference defect 5)",
                then=after)

# -- the fault-tolerance and clocked-timing slice ---------------------------

# Phase A: the reference's chaos matrix (tests/test_faults.py,
# benchmarks/faults_bench.py) at the paper's 255 hosts.  112 tenants leave
# 15 of the 127 HWPIDs free, one more than the storm's 14 rounds can admit,
# so no admit finds the pool empty.
CHAOS_SEEDS = (1, 2, 3, 4, 5)
CHAOS_ROUNDS = 14
CHAOS_TENANTS = 112
CHAOS_SPAN = 16
CHAOS_WORDS = 64            # words per row of each round's fabric step
CHAOS_SPEC = dict(drop_p=0.15, dup_p=0.10, reorder_p=0.10, delay_p=0.10,
                  max_delay=3)
MONITOR_TIMEOUT = 2         # rounds of silence before a host is listed dead
FAIL_ROUND, REJOIN_ROUND = 5, 10


def _span_ext(pid: int, start: int, n: int) -> np.ndarray:
    return np.asarray(pack_ext_addr(np.full(n, pid, np.int32),
                                    (start + np.arange(n)).astype(np.int32)))


def chaos_seed(dev, seed: int) -> dict:
    """One seeded storm: churn under dropped, duplicated, reordered and
    delayed BISnp copies, one FM crash epoch, and one host that falls
    silent at round 5, is listed by the heartbeat monitor, fenced with
    `crash_host` and rejoins cold at round 10.  Every round each revoked
    (host, HWPID, span) is checked through `HostRuntime.check` and, with
    every live tenant's row, through one `step_egress`; neither may
    release a word.  Then restart + quiesce barriers until every host is
    back in sync and every revoked span denies."""
    rng = np.random.default_rng(seed)
    data_rng = np.random.default_rng(seed + 1000)
    t0 = time.perf_counter()
    fab = ShardedFabric(SDM_PAGES, table_capacity=8192, n_shards=N_HOSTS,
                        device=dev)
    rts = [fab.enroll(h) for h in range(N_HOSTS)]
    live = {h: [] for h in range(N_HOSTS)}
    for p in range(CHAOS_TENANTS):
        h = p * N_HOSTS // CHAOS_TENANTS
        live[h].append(fab.admit(h, CHAOS_SPAN))
    fab.quiesce()
    setup_s = time.perf_counter() - t0
    clock = {"round": 0}
    monitor = fab.enable_host_monitor(timeout=MONITOR_TIMEOUT,
                                      clock=lambda: clock["round"])
    plan = fab.inject_faults(FaultPlan(
        FaultSpec(**CHAOS_SPEC), seed=seed,
        fm_crash_epochs=(fab.fm.epoch + 2 + int(rng.integers(0, 3)),)))
    revoked: list[tuple[int, int, int]] = []
    down, fenced, detected_round = None, False, None
    stale_check = stale_words = false_denials = words = checks = 0
    zeros = np.zeros(4, bool)
    for rnd in range(CHAOS_ROUNDS):
        clock["round"] = rnd
        op = int(rng.integers(0, 3))
        if not fab.fm.crashed:
            try:
                if op == 0:
                    hs = [h for h in live if live[h] and h != down]
                    if hs:
                        h = hs[int(rng.integers(0, len(hs)))]
                        pid, start = live[h].pop()
                        fab.fm.revoke_hwpid(pid)
                        revoked.append((h, pid, start))
                elif op == 1:
                    h = int(rng.integers(0, N_HOSTS))
                    if h != down and fab.free_pages(h) >= CHAOS_SPAN:
                        live[h].append(fab.admit(h, CHAOS_SPAN))
            except FMUnavailable:
                pass                    # the crash point fired mid-op
        elif rng.random() < 0.5:
            fab.fm.restart()
        if rnd == FAIL_ROUND and down is None:
            down = int(rng.integers(0, N_HOSTS))     # falls silent
        if down is not None and not fenced:
            dead = fab.dead_hosts()
            if dead:
                if dead != [down]:
                    raise AssertionError(f"seed {seed} round {rnd}: monitor "
                                         f"lists {dead}, silent host {down}")
                detected_round = rnd
                fab.crash_host(down)                 # fence it
                fenced = True
                if fab.dead_hosts():
                    raise AssertionError("a fenced host stays listed")
        if rnd == REJOIN_ROUND and down is not None:
            if not fenced:
                raise AssertionError(f"seed {seed}: host {down} silent "
                                     f"since round {FAIL_ROUND}, never "
                                     "listed by the monitor")
            fab.rejoin_host(down)
            if down in fab.dead_hosts():
                raise AssertionError("a rejoined host is listed dead")
            down, fenced = None, False
        for h in range(N_HOSTS):
            if h != down and rng.random() < 0.7:
                fab.deliver(h, int(rng.integers(1, 4)))
        # route 1: the framework checker of each revoked span's host
        for (h, pid, start) in revoked:
            if h == down:
                continue
            res = rts[h].check(_span_ext(pid, start, 4), zeros)
            stale_check += int(res.allowed.sum())
            checks += 1
        # route 2: one fabric step over every live row and every revoked
        # row of the running hosts
        assign = {}
        spans = {}
        for h in range(N_HOSTS):
            pids = [(p, s, True) for p, s in live[h]] + \
                [(p, s, False) for hh, p, s in revoked if hh == h]
            if h != down and pids:
                assign[h] = [p for p, _, _ in pids]
                spans.update({p: (s, ok) for p, s, ok in pids})
        rows = fab.fabric_rows(assign)
        ext = np.stack([np.asarray(pack_ext_addr(
            np.full(CHAOS_WORDS, pid),
            spans[pid][0] + data_rng.integers(0, CHAOS_SPAN, CHAOS_WORDS)))
            for _, pid in rows])
        data = data_rng.integers(0, 1 << 32, ext.shape, dtype=np.uint32)
        out, fault = fab.step_egress(data, ext, assign, need=1, key0=KEY0,
                                     key1=KEY1)
        released = ((fault == 0) | (out != 0)).cpu().numpy()
        is_live = np.array([spans[pid][1] for _, pid in rows])
        stale_words += int(released[~is_live].sum())
        false_denials += int((fault[torch.from_numpy(is_live).to(
            fault.device)] != 0).sum())
        words += ext.size
        for h in range(N_HOSTS):
            if h != down:
                monitor.beat(h)     # each running host's own timer
    storm_s = time.perf_counter() - t0 - setup_s

    # recovery: the storm passes; count barriers until reconvergence
    if down is not None:
        if not fenced:
            fab.crash_host(down)
        fab.rejoin_host(down)
    fab.quiesce()                       # flushes the plan's delayed copies
    fab.fm.bus.faults = None
    fab.fm.faults = None

    def converged() -> bool:
        if any(rt.desynced for rt in rts):
            return False
        return not any(bool(rts[h].check(_span_ext(pid, start, 4),
                                         zeros).allowed.any())
                       for h, pid, start in revoked)

    recovery = 0
    while recovery < 8:
        recovery += 1
        fab.fm.restart()                # idempotent snapshot resync
        fab.quiesce()
        if converged():
            break
    else:
        raise AssertionError(f"seed {seed}: no reconvergence in 8 barriers")
    st = fab.stats()["faults"]
    return dict(seed=seed, stale_reads_check=stale_check,
                stale_words_egress=stale_words, false_denials=false_denials,
                checks=checks, egress_words=words, revoked=len(revoked),
                dropped=plan.dropped, duplicated=plan.duplicated,
                delayed=plan.delayed, fm_crashes=plan.fm_crashes,
                desync_events=st["desync_events"],
                self_heals=st["self_heals"], resyncs=st["resyncs"],
                snapshot_resyncs=st["snapshot_resyncs"],
                fm_restarts=st["fm_restarts"],
                detected_round=detected_round, recovery_rounds=recovery,
                setup_s=setup_s, storm_s=storm_s,
                wall_s=time.perf_counter() - t0)


def chaos_path(dev) -> dict:
    """Phase A: the chaos storm for every seed, every fabric launch held
    against the plain version on its own operands after the storm."""
    t0 = time.perf_counter()
    fabric_check = FabricCheck()
    fe.fabric_egress = fabric_check
    reset_launches()
    try:
        seeds = []
        for seed in CHAOS_SEEDS:
            r = chaos_seed(dev, seed)
            seeds.append(r)
            log(f"main chaos seed {seed}: {N_HOSTS} hosts, "
                f"{CHAOS_TENANTS} tenants, {CHAOS_ROUNDS} rounds: stale "
                f"reads through check {r['stale_reads_check']} "
                f"({r['checks']} checks), stale words through fabric_egress "
                f"{r['stale_words_egress']} ({r['egress_words']} words), "
                f"false denials {r['false_denials']}; dropped "
                f"{r['dropped']}, duplicated {r['duplicated']}, delayed "
                f"{r['delayed']}, fm_crashes {r['fm_crashes']}, "
                f"desync_events {r['desync_events']}, self_heals "
                f"{r['self_heals']}, resyncs {r['resyncs']}, "
                f"snapshot_resyncs {r['snapshot_resyncs']}; silent host "
                f"listed dead at round {r['detected_round']}; recovery "
                f"rounds {r['recovery_rounds']}; setup {r['setup_s']:.3f} s,"
                f" storm {r['storm_s']:.3f} s, wall {r['wall_s']:.3f} s")
            if r["stale_reads_check"] or r["stale_words_egress"] or \
                    r["false_denials"]:
                raise AssertionError(f"chaos seed {seed}: {r}")
            if r["dropped"] + r["duplicated"] + r["delayed"] == 0 or \
                    r["fm_crashes"] != 1:
                raise AssertionError(f"chaos seed {seed} left a fault class "
                                     f"unexercised: {r}")
        torch.cuda.synchronize()
        counts = dict(launches)
    finally:
        fe.fabric_egress = fabric_check.kernel
    n = len(fabric_check.launches)
    if n != counts["fabric_egress"]:
        raise AssertionError(f"{n} recorded fabric calls, "
                             f"{counts['fabric_egress']} launches")
    checked = fabric_check.check()
    wall = time.perf_counter() - t0
    log(f"main chaos: {n} fabric launches held against the plain version "
        f"after the storms: 0 mismatching words and fault codes over "
        f"{checked} words; phase wall {wall:.3f} s")
    return dict(seeds=seeds, launches=counts, wall_s=wall)


# Phase B: the reference's clocked timing row (benchmarks/scale_bench.py
# `_bench_timing` at its full settings): 127 tenants on 255 hosts with
# 1024-page spans, GAPBS traces of an RMAT scale-13 graph.
TIMING_SPAN = 1024
TIMING_STEPS = 6
TIMING_BATCH = 512
TIMING_GRAPH = dict(scale=13, avg_degree=12, seed=7)
TIMING_CAP = 100_000
TIMING_TRACES = ("pr", "bfs", "bc", "tc")


def timed_trace(device, traces, *, sync) -> dict:
    """One traced run of the clocked deployment on ``device``: returns the
    trace's JSON, the replay report, the timing penalty, the live bus's
    propagation cycles, every step's words and fault codes, and the wall
    times."""
    t0 = time.perf_counter()
    cfg = TimingConfig()
    cf = ClockedFabric(cfg, seed=SEED)
    fab = ShardedFabric(SDM_PAGES, table_capacity=8192, n_shards=N_HOSTS,
                        clock=cf, device=device)
    for h in range(N_HOSTS):
        fab.enroll(h)
    active = [p * N_HOSTS // N_PROCS for p in range(N_PROCS)]
    fab.begin_trace(label=f"hosts={N_HOSTS}")
    tenants = {h: fab.admit(h, TIMING_SPAN) for h in active}
    fab.quiesce()
    assign = {h: tenants[h][0] for h in active}
    ext_steps = np.stack([
        gapbs.egress_batches(traces[TIMING_TRACES[i % len(TIMING_TRACES)]],
                             hwpid=tenants[h][0], batch=TIMING_BATCH,
                             n_steps=TIMING_STEPS,
                             page_offset=tenants[h][1],
                             page_span=TIMING_SPAN)[0]
        for i, h in enumerate(active)])
    setup_s = time.perf_counter() - t0
    rng = np.random.default_rng(SEED)
    victim = active[0]
    outs, step_ms = [], []
    for s in range(TIMING_STEPS):
        ext = ext_steps[:, s]
        data = rng.integers(0, 1 << 32, ext.shape, dtype=np.uint32)
        sync()
        t = time.perf_counter()
        out, fault = fab.step_egress(data, ext, assign, need=1, key0=KEY0,
                                     key1=KEY1)
        sync()
        step_ms.append((time.perf_counter() - t) * 1e3)
        outs.append((out, fault))
        if s % 2 == 1:                  # churn commits between steps
            fab.evict(victim, tenants[victim][0])
            tenants[victim] = fab.admit(victim, TIMING_SPAN)
            assign[victim] = tenants[victim][0]
            fab.quiesce()
    fab.quiesce()
    trace = fab.end_trace()
    wall_s = time.perf_counter() - t0
    rep = replay(trace, cfg, seed=SEED)
    live = fab.fm.bus.propagation_cycles() or [0]
    return dict(fab=fab, assign=assign, ext=ext, data=data,
                trace=trace.to_json(), replay=rep.to_dict(),
                penalty=timing_penalty(trace, cfg),
                live_prop_p99_ns=float(np.percentile(live, 99))
                / cfg.clock_ghz, clock_cycles=cf.now, outs=outs,
                setup_s=setup_s, step_ms=step_ms, wall_s=wall_s)


def timing_path(dev) -> dict:
    """Phase B: the traced clocked deployment on the card, each fabric
    launch held against the plain version after the run; the same phase
    with ``device="cpu"`` must give the same trace, replay report and
    words; then the replayed timing figures."""
    t0 = time.perf_counter()
    g = graphs.make_graph(**TIMING_GRAPH)
    traces = {k: gapbs.TRACES[k](g, cap=TIMING_CAP, seed=SEED)
              for k in TIMING_TRACES}
    traces_s = time.perf_counter() - t0
    fabric_check = FabricCheck()
    fe.fabric_egress = fabric_check
    reset_launches()
    try:
        card = timed_trace(dev, traces, sync=torch.cuda.synchronize)
        counts = dict(launches)
    finally:
        fe.fabric_egress = fabric_check.kernel
    n = len(fabric_check.launches)
    if n != TIMING_STEPS or counts["fabric_egress"] != n:
        raise AssertionError(f"{n} recorded fabric calls and "
                             f"{counts['fabric_egress']} launches in "
                             f"{TIMING_STEPS} steps")
    checked = fabric_check.check()
    t = time.perf_counter()
    cpu = timed_trace(torch.device("cpu"), traces, sync=lambda: None)
    cpu_s = time.perf_counter() - t
    for key in ("trace", "replay", "penalty", "live_prop_p99_ns",
                "clock_cycles"):
        if card[key] != cpu[key]:
            raise AssertionError(f"timing path: the card's {key} differs "
                                 "from the CPU run's")
    for (co, cf), (po, pf) in zip(card["outs"], cpu["outs"]):
        compare("fabric_egress (timing path, card against CPU run)",
                (co.cpu(), cf.cpu()), (po, pf))
    pen, rep = card["penalty"], card["replay"]
    if not pen["penalty_cached_pct"] < pen["penalty_nocache_pct"]:
        raise AssertionError(f"timing path: cached penalty not below the "
                             f"no-cache penalty: {pen}")
    prop = rep["propagation"]
    rows = card["outs"][0][0].shape[0]
    crit = rep["critical_path"]
    links = {k: v["utilization"] for k, v in rep["links"].items()
             if not k.startswith("host") or k == crit["link"]}
    log(f"main timing: {N_HOSTS} hosts, {N_PROCS} tenants ({TIMING_SPAN}"
        f"-page spans), ClockedFabric(TimingConfig(), seed={SEED}); GAPBS "
        f"{list(TIMING_TRACES)} traces of RMAT scale "
        f"{TIMING_GRAPH['scale']} (cap {TIMING_CAP}) made in "
        f"{traces_s:.3f} s; {TIMING_STEPS} steps of {rows} x "
        f"{TIMING_BATCH} words, evict + re-admit after every second step; "
        f"{n} fabric launches bit-exact against the plain version after "
        f"the run ({checked} words); trace JSON, replay report, penalties "
        f"and every step's words equal to the device='cpu' run's "
        f"({cpu_s:.3f} s)")
    log(f"main timing (card): setup {card['setup_s']:.3f} s, step wall ms "
        f"{[round(x, 4) for x in card['step_ms']]}, phase wall "
        f"{card['wall_s']:.3f} s")
    log(f"main timing (simulated cycles at the paper's Table 2 timings, "
        f"not card times): propagation p50 {prop['p50_ns']} ns, p99 "
        f"{prop['p99_ns']} ns, max {prop['max_ns']} ns over {prop['n']} "
        f"copies; live bus p99 {card['live_prop_p99_ns']:.1f} ns; critical "
        f"path {crit}; link utilization {links}; penalty cached "
        f"{pen['penalty_cached_pct']} % / no cache "
        f"{pen['penalty_nocache_pct']} % ({pen['perm_cache_bytes']} B "
        f"PermCache); {len(card['trace']['events'])} trace events")

    # the steady step's kernel time at this view (no trace recording)
    fab, assign, ext, data = (card[k] for k in ("fab", "assign", "ext",
                                                 "data"))

    def step():
        return fab.step_egress(data, ext, assign, need=1, key0=KEY0,
                               key1=KEY1)

    kernel_ms = kernel_only_ms(step, "fabric_egress_kernel")
    _, fault = step()
    b_ms, b_by = fabric_bound(torch.from_numpy(ext).to(dev), fault,
                              fab.fabric_view(assign))
    log(f"main timing steady step: fabric_egress kernel {kernel_ms} ms "
        f"against its bound {b_ms:.5f} ms ({b_by}) at {rows} x "
        f"{TIMING_BATCH}")
    wall = time.perf_counter() - t0
    log(f"main timing: phase wall {wall:.3f} s")
    return dict(propagation=prop, critical_path=crit,
                link_utilization=links, penalty=pen,
                live_prop_p99_ns=card["live_prop_p99_ns"],
                clock_cycles=card["clock_cycles"],
                trace_events=len(card["trace"]["events"]),
                launches=counts, setup_s=card["setup_s"],
                step_ms=card["step_ms"], card_wall_s=card["wall_s"],
                cpu_run_s=cpu_s, traces_s=traces_s, kernel_ms=kernel_ms,
                bound_ms=b_ms, bound_by=b_by, wall_s=wall)


# -- the remaining serving families ------------------------------------------

# Main path 5: olmoe-1b-7b at full width and depth (f32: reference defect 5)
# through the serving sequence of main path 2, at its batch, prompt, gen and
# request count.
MOE_ARCH = "olmoe-1b-7b"
# The family phase: falcon-mamba at full width with 8 of its 64 layers,
# zamba2 at full width and depth, served at batch 4, prompt 256, 16
# generated tokens, 4 requests; seamless at full width and depth through
# prefill/decode with 64 frames and a 256-token prompt.
FAMILY_BATCH, FAMILY_PROMPT, FAMILY_GEN, FAMILY_REQUESTS = 4, 256, 16, 4
FAMILY_LAYERS = {"falcon-mamba-7b": 8}
SEAMLESS_FRAMES = 64
SSM_CPU_TOL = 1e-3          # falcon-mamba on the card against a CPU run
# The shared-experts flow at olmoe's full width and depth: each expert
# weight's pool region holds 16 x 64 rows of 8 MiB (8 GiB), so rows from
# the 256th on lie past 2 GiB.  At most ~55 GB on the card: the 24 GiB pool,
# one tenant's fetched experts (24 GiB) and the rest of the model.
SHARED_EXPERT_LAYERS = 16

def ssm_cpu_check(cfg, params, toks, gen0, label: str) -> dict:
    """falcon-mamba runs no kernel: the first group's prefill and first
    decode step on the card against a ``device="cpu"`` run of the port on
    the same weights, within ``SSM_CPU_TOL``."""
    outs = []
    for model, dev in ((params, toks.device), (None, torch.device("cpu"))):
        if model is None:
            model = copy.deepcopy(params).to(dev)
        t = time.perf_counter()
        lg0, cache = registry.prefill(cfg, model, {"tokens": toks.to(dev)},
                                      cache_dtype=torch.float32)
        nxt = (outs[0][0].to(dev) if outs else lg0[:, -1]).argmax(-1)
        lg1, _ = registry.decode_step(cfg, model, cache,
                                      nxt[:, None].to(torch.int32),
                                      toks.shape[1])
        if dev.type == "cuda":
            torch.cuda.synchronize()
        outs.append((lg0[:, -1].cpu(), lg1[:, -1].cpu(),
                     (time.perf_counter() - t) * 1e3))
    (k0, k1, card_ms), (c0, c1, cpu_ms) = outs
    err = max(close(k0, c0, SSM_CPU_TOL), close(k1, c1, SSM_CPU_TOL))
    if k1.argmax(-1).tolist() != gen0:
        raise AssertionError(f"{label}: first tokens {k1.argmax(-1)} are "
                             f"not the engine's {gen0}")
    log(f"{label} logits: the first group's prefill and first decode step "
        f"on the card against a device='cpu' run on the same weights: max "
        f"|diff| {err:.3e} (tolerance {SSM_CPU_TOL}); card {card_ms:.1f} ms,"
        f" CPU {cpu_ms:.1f} ms")
    return dict(logits_max_abs_diff=err, card_ms=card_ms, cpu_ms=cpu_ms)


def seamless_path(dev) -> dict:
    """seamless-m4t-medium at full width and depth through
    ``registry.prefill``/``decode_step`` with frames (the engine has none:
    reference defect 6): greedy decode on the kernel, every attention
    layer's first prefill and decode held against the plain version, then
    the whole run teacher-forced with plain attention."""
    t0 = time.perf_counter()
    cfg = replace(ARCHS["seamless-m4t-medium"], param_dtype="float32")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = registry.init_params(cfg, gen, dev)
    frames = torch.randn((FAMILY_BATCH, SEAMLESS_FRAMES, cfg.d_model),
                         generator=gen, device=dev)
    toks = torch.randint(3, cfg.vocab - 1, (FAMILY_BATCH, FAMILY_PROMPT),
                         generator=gen, device=dev, dtype=torch.int32)
    cap = FAMILY_PROMPT + FAMILY_GEN
    runs = {}
    for name in ("kernel", "plain"):
        if name == "kernel":
            checks = check_attention(params)
            reset_launches()
        else:
            set_attend(params, fa.flash_attention_plain)
        torch.cuda.synchronize()
        t = time.perf_counter()
        lg, cache = registry.prefill(cfg, params, {"tokens": toks,
                                                   "frames": frames},
                                     cache_dtype=torch.float32, cap=cap)
        torch.cuda.synchronize()
        pre_ms = (time.perf_counter() - t) * 1e3
        logits, step_ms = [lg[:, -1]], []
        for i in range(FAMILY_GEN):
            nxt = (runs["kernel"][0][i] if runs else logits[-1]).argmax(-1)
            torch.cuda.synchronize()
            t = time.perf_counter()
            lg, cache = registry.decode_step(cfg, params, cache,
                                             nxt[:, None].to(torch.int32),
                                             FAMILY_PROMPT + i)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t) * 1e3)
            logits.append(lg[:, -1])
        if name == "kernel":
            counts = dict(launches)
        runs[name] = (logits, pre_ms, step_ms)
        del cache
    set_attend(params, fa.flash_attention)
    if counts["flash_attention"] == 0:
        raise AssertionError("flash_attention never launched on the "
                             "seamless path")
    err = max(close(k, p, LOGITS_TOL)
              for k, p in zip(runs["kernel"][0], runs["plain"][0]))
    if not all(bool((k.argmax(-1) == p.argmax(-1)).all())
               for k, p in zip(runs["kernel"][0], runs["plain"][0])):
        raise AssertionError("seamless: argmax tokens differ from the "
                             "plain-attention run")
    flash_err = attend_errors(checks)
    _, pre_ms, step_ms = runs["kernel"]
    wall = time.perf_counter() - t0
    log(f"family seamless: {cfg.arch_id} at full width (f32): "
        f"{cfg.n_enc_layers} + {cfg.n_layers} layers, d {cfg.d_model}, "
        f"vocab {cfg.vocab}; frames {tuple(frames.shape)}, prompt "
        f"{tuple(toks.shape)}, {FAMILY_GEN} greedy steps; launches {counts};"
        f" every attention layer's first prefill and decode against the "
        f"plain version: max |diff| {flash_err}; logits of the prefill and "
        f"every step against plain attention: max |diff| {err:.3e}, argmax "
        f"identical; prefill wall {pre_ms:.1f} ms, decode step wall median "
        f"{float(np.median(step_ms)):.3f} ms; phase wall {wall:.3f} s")
    del params
    free_card()
    return dict(arch=cfg.arch_id, launches=counts, flash_vs_plain=flash_err,
                logits_max_abs_diff=err, prefill_ms=pre_ms,
                decode_step_ms=step_ms, wall_s=wall)


def family_paths(dev) -> dict:
    """The family phase: falcon-mamba (8 of 64 layers) and zamba2 served,
    seamless through prefill/decode with frames; each path's launch counts
    zeroed before it and read after it."""
    out = {}
    for arch in ("falcon-mamba-7b", "zamba2-1.2b"):
        t0 = time.perf_counter()
        full = ARCHS[arch]
        cfg = replace(full, param_dtype="float32",
                      n_layers=FAMILY_LAYERS.get(arch, full.n_layers))
        label = f"family {arch}"
        params, engine, demo, facts = serve_family(
            dev, cfg, batch=FAMILY_BATCH, prompt=FAMILY_PROMPT,
            gen=FAMILY_GEN, requests=FAMILY_REQUESTS, label=label)
        toks, gen0 = first_group(demo, FAMILY_BATCH, dev)
        if cfg.family == "ssm":
            if facts["launches"]["flash_attention"]:
                raise AssertionError("falcon-mamba launched flash attention")
            check = ssm_cpu_check(cfg, params, toks, gen0, label)
        else:
            check = plain_attention_check(
                cfg, params, toks, gen0, cap=FAMILY_PROMPT + FAMILY_GEN,
                pos=FAMILY_PROMPT, label=label)
        del params, engine, demo
        free_card()
        wall = time.perf_counter() - t0
        log(f"{label}: phase wall {wall:.3f} s")
        cut = "f32 parameters"
        if cfg.n_layers != full.n_layers:
            cut = f"{cfg.n_layers} of {full.n_layers} layers; {cut}"
        out[arch] = dict(facts, **check, wall_s=wall, cut=cut)
    out["seamless-m4t-medium"] = seamless_path(dev)
    return out


def shared_experts_path(dev) -> dict:
    """examples/torch_serve_shared_experts.py at olmoe's full width with
    ``SHARED_EXPERT_LAYERS`` layers: the example raises unless A's fetches
    are all denied after its revocation, B's tokens do not change and B's
    denied rows come back zero."""
    t0 = time.perf_counter()
    example = load_example("torch_serve_shared_experts")
    cfg = replace(ARCHS[MOE_ARCH], param_dtype="float32",
                  n_layers=SHARED_EXPERT_LAYERS)
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    res = example.run(cfg, device=dev, seed=SEED,
                      log=lambda m: log(f"shared experts: {m}"))
    torch.cuda.synchronize()
    counts = dict(launches)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if counts["flash_attention"] != 4 * cfg.n_layers:
        raise AssertionError(f"shared experts: {counts['flash_attention']} "
                             f"flash launches, not {4 * cfg.n_layers}")
    free_card()
    wall = time.perf_counter() - t0
    # each region's byte size; its last row starts this far into it
    region_bytes = cfg.n_layers * cfg.n_experts * cfg.d_model * \
        cfg.expert_d_ff * 4
    last_row_off = region_bytes - cfg.d_model * cfg.expert_d_ff * 4
    log(f"shared experts: 3 expert regions of {region_bytes / 2**30:.1f} GiB"
        f" each, last row at byte {last_row_off} (2 GiB = {2**31}); peak "
        f"memory {peak_gb:.2f} GB")
    log(f"shared experts: olmoe full width, {cfg.n_layers} layers: A denied "
        f"{res['a_before'][1]} fetches before and {res['a_revoked'][1]} of "
        f"{res['fetches_per_tenant']} after its revocation; B denied "
        f"{res['b_before'][1]} (zero-filled), tokens {res['b_before'][0]} "
        f"before and {res['b_after'][0]} after; launches {counts}; phase "
        f"wall {wall:.3f} s")
    return dict(launches=counts, wall_s=wall, n_layers=cfg.n_layers,
                region_bytes=region_bytes, peak_gb=peak_gb,
                **{k: res[k] for k in ("a_before", "b_before", "a_revoked",
                                       "b_after", "fetches_per_tenant")})


# -- the mesh and sharding slice ----------------------------------------------

# Main path 5b: main path 5's olmoe-1b-7b parameters on the 1x1 ("data",
# "model") mesh in a one-rank NCCL process group: prefill and greedy decode
# steps at batch 4, once without a mesh and once under it, in one process.
MESH_DECODE_STEPS = 8
MESH_TIMED_STEPS = 8        # decode steps per timing turn (4 turns, ABBA)


def _decode_run(cfg, params, toks, steps: int):
    """Prefill ``toks`` and take ``steps`` greedy decode steps: (the
    prefill's and each step's last logits, the tokens fed, the cache)."""
    lg, cache = registry.prefill(cfg, params, {"tokens": toks},
                                 cache_dtype=torch.float32,
                                 cap=toks.shape[1] + steps)
    logits, fed = [lg[:, -1]], []
    for i in range(steps):
        nxt = logits[-1].argmax(-1)[:, None].to(torch.int32)
        fed.append(nxt)
        lg, _ = registry.decode_step(cfg, params, cache, nxt,
                                     toks.shape[1] + i)
        logits.append(lg[:, -1])
    torch.cuda.synchronize()
    return logits, fed, cache


def first_divergence(cfg, params, toks, mesh) -> str:
    """The first module (in call order) whose output differs between the
    prefill without a mesh and under ``mesh``: where a mismatch starts."""
    outs = {}

    def hook(name):
        def record(_mod, _args, out):
            t = out[0] if isinstance(out, tuple) else out
            if isinstance(t, torch.Tensor):
                outs.setdefault(name, []).append(t.detach().clone())
        return record

    handles = [m.register_forward_hook(hook(n))
               for n, m in params.named_modules() if n]
    try:
        runs = []
        for m in (None, mesh):
            outs = {}
            with use_mesh(m):
                registry.prefill(cfg, params, {"tokens": toks},
                                 cache_dtype=torch.float32,
                                 cap=toks.shape[1])
            runs.append(outs)
    finally:
        for h in handles:
            h.remove()
    for name, got in runs[0].items():
        other = runs[1].get(name, [])
        if len(other) != len(got) or not all(
                torch.equal(a, b) for a, b in zip(got, other)):
            return name
    return "no module output (the final norm or the unembedding)"


def validate_every_arch() -> dict:
    """`validate_specs` of every arch's parameters on both production
    meshes (abstract: host work only); each must come back empty."""
    meshes = {"pod": mesh_mod.make_abstract_mesh(mesh_mod.POD_SHAPE,
                                                 mesh_mod.POD_AXES),
              "multipod": mesh_mod.make_abstract_mesh(
                  mesh_mod.MULTIPOD_SHAPE, mesh_mod.MULTIPOD_AXES)}
    out = {}
    for arch, cfg in ARCHS.items():
        shapes = registry.param_shapes(cfg)
        for kind, am in meshes.items():
            errs = sh.validate_specs(
                shapes, sh.param_spec_tree(cfg, am, shapes), am)
            if errs:
                raise AssertionError(f"mesh: {arch} on the {kind} mesh: "
                                     f"{len(errs)} specs do not divide: "
                                     f"{errs[:3]}")
            out[f"{arch}/{kind}"] = len(list(shapes.parameters()))
    return out


COLLECTIVE_REPS = 200


def collective_host_us(mesh, dev, d_model: int) -> dict:
    """Host microseconds per call of each of the MoE bodies' collectives
    at a decode step's sizes (y [batch, d_model], a scalar aux), alone,
    after a warm-up; the device is synchronised only at the end.  The
    all_reduce also where autograd records its operand (the
    differentiable path training takes)."""
    y = torch.randn(SERVE_BATCH, d_model, device=dev)
    y_grad = y.clone().requires_grad_(True)
    aux = torch.ones((), device=dev)
    model = moe_ep._mesh_axis(mesh, ("model",))
    data = moe_ep._mesh_axis(mesh, ("data",))
    calls = {"all_reduce y": lambda: moe_ep._all_reduce(y, model),
             "all_reduce y, autograd recording": lambda: moe_ep._all_reduce(
                 y_grad, model),
             "pmean aux": lambda: moe_ep._pmean(aux.clone(), model),
             "all_gather y": lambda: moe_ep._all_gather(y, data),
             "broadcast aux": lambda: moe_ep._broadcast_first(aux.clone(),
                                                              data),
             "mesh axis lookup": lambda: moe_ep._mesh_axis(mesh,
                                                           ("model",))}
    out = {}
    for name, fn in calls.items():
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(COLLECTIVE_REPS):
            fn()
        out[name] = (time.perf_counter() - t) / COLLECTIVE_REPS * 1e6
        torch.cuda.synchronize()
    return out


def _timed_decode_ms(cfg, params, cache, toks, pos: int) -> list:
    out = []
    for i in range(MESH_TIMED_STEPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        registry.decode_step(cfg, params, cache, toks, pos + i)
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t) * 1e3)
    return out


def mesh_path(dev, cfg, params, smi: str) -> dict:
    """Main path 5b: olmoe-1b-7b at full width and depth (main path 5's
    parameters) prefilled at batch 4 x ``SERVE_PROMPT`` and decoded
    ``MESH_DECODE_STEPS`` greedy steps without a mesh and under the 1x1
    NCCL mesh: logits and tokens bit-identical (else the first module that
    differs is named), every MoE layer's model-axis body reducing its
    output and aux (``all_reduce`` calls counted), the flash kernel
    launched; the decode step's wall under the mesh with the layers'
    ``constrain`` calls and with them replaced by a pass-through (ABBA
    turns); ``validate_specs`` of every arch on both production meshes.
    The process group is destroyed at the end."""
    t0 = time.perf_counter()
    if dist.is_initialized():
        raise AssertionError("mesh: a process group exists before the phase")
    mesh = mesh_mod.make_smoke_mesh(dev)
    backend = dist.get_backend()
    if "nccl" not in backend or dist.get_world_size() != 1:
        raise AssertionError(f"mesh: backend {backend}, world "
                             f"{dist.get_world_size()}")
    try:
        rng = np.random.default_rng(SEED + 20)
        toks = torch.from_numpy(rng.integers(
            3, cfg.vocab - 1, (SERVE_BATCH, SERVE_PROMPT)).astype(
                np.int32)).to(dev)
        set_attend(params, fa.flash_attention)
        base, base_fed, _ = _decode_run(cfg, params, toks, MESH_DECODE_STEPS)
        reset_launches()
        moe_ep.reset_collectives()
        t = time.perf_counter()
        with use_mesh(mesh):
            got, got_fed, cache = _decode_run(cfg, params, toks,
                                              MESH_DECODE_STEPS)
        mesh_run_s = time.perf_counter() - t
        counts, coll = dict(launches), dict(moe_ep.collectives)
        differ = [i for i, (a, b) in enumerate(zip(base, got))
                  if not torch.equal(a, b)]
        fed_equal = all(torch.equal(a, b) for a, b in zip(base_fed, got_fed))
        if differ or not fed_equal:
            where = first_divergence(cfg, params, toks, mesh)
            raise AssertionError(
                f"mesh: logits differ under the 1x1 mesh at steps {differ} "
                f"(tokens equal: {fed_equal}); first differing module in "
                f"the prefill: {where}")
        n_moe = sum(1 for u in params.layers if hasattr(u, "moe"))
        calls = 1 + MESH_DECODE_STEPS
        if counts["flash_attention"] == 0:
            raise AssertionError("mesh: flash_attention never launched under "
                                 "the mesh")
        if coll["all_reduce"] != 2 * n_moe * calls or \
                coll["all_gather"] != n_moe * calls:
            raise AssertionError(f"mesh: collectives {coll} for {n_moe} MoE "
                                 f"layers x {calls} calls")
        log(f"mesh: olmoe-1b-7b on the 1x1 mesh {mesh} ({backend}, world "
            f"{dist.get_world_size()}): prefill {SERVE_BATCH} x "
            f"{SERVE_PROMPT} + {MESH_DECODE_STEPS} greedy decode steps "
            f"bit-identical to the same steps without a mesh ({len(base)} "
            f"logits tensors, tokens {[int(t[0, 0]) for t in got_fed]} in "
            f"row 0); launches {counts}; collectives {coll} ({n_moe} MoE "
            f"layers: all_reduce of y and aux each call); run "
            f"{mesh_run_s:.3f} s")

        # the decode step's wall under the mesh, with the constrain calls
        # and with the layers' constrain replaced by a pass-through
        nxt = got_fed[-1]
        pos = SERVE_PROMPT        # rewrites the cache's first decode slots
        no_calls = lambda x, *spec: x
        turns = {"with constrain": [], "without constrain": []}
        meshless = _timed_decode_ms(cfg, params, cache, nxt, pos)
        with use_mesh(mesh):
            _timed_decode_ms(cfg, params, cache, nxt, pos)     # warm-up
            for kind in ("with constrain", "without constrain",
                         "without constrain", "with constrain"):
                if kind == "without constrain":
                    attn_mod.constrain, mamba_mod.constrain = no_calls, \
                        no_calls
                try:
                    turns[kind] += _timed_decode_ms(cfg, params, cache, nxt,
                                                    pos)
                finally:
                    attn_mod.constrain = mamba_mod.constrain = \
                        activations.constrain
        med = {k: float(np.median(v)) for k, v in turns.items()}
        med["no mesh"] = float(np.median(meshless))
        n_calls = 8 * len(attention_modules(params))
        log(f"mesh decode step on {smi} (batch {SERVE_BATCH}, median of "
            f"{2 * MESH_TIMED_STEPS} steps in ABBA turns): "
            f"{ {k: round(v, 3) for k, v in med.items()} } ms; "
            f"{n_calls} constrain calls a step (8 per attention layer)")
        del cache
        coll_us = collective_host_us(mesh, dev, cfg.d_model)
        log(f"mesh: host us per collective call on one NCCL rank (decode "
            f"step sizes, {COLLECTIVE_REPS} calls each): "
            f"{ {k: round(v, 1) for k, v in coll_us.items()} }")
        t = time.perf_counter()
        validated = validate_every_arch()
        validate_s = time.perf_counter() - t
        log(f"mesh: validate_specs empty for every arch's parameters on "
            f"both production meshes ({len(validated)} (arch, mesh) pairs, "
            f"host only, {validate_s:.2f} s)")
    finally:
        dist.destroy_process_group()
    if dist.is_initialized():
        raise AssertionError("mesh: the process group outlived the phase")
    wall = time.perf_counter() - t0
    log(f"mesh: phase wall {wall:.3f} s on {smi}")
    return dict(launches=counts, collectives=coll, backend=backend,
                decode_steps=MESH_DECODE_STEPS, moe_layers=n_moe,
                mesh_run_s=mesh_run_s, decode_step_ms=turns,
                decode_step_median_ms=med, constrain_calls=n_calls,
                collective_host_us=coll_us,
                validated=validated,
                validate_s=validate_s, wall_s=wall)


# -- the training slice --------------------------------------------------------

# Main path 6: the launcher's loop on qwen1.5-0.5b at full width and depth
# (`--preset full`: bf16 parameters, f32 moments, remat full) at its
# default batch and learning rate; the reference example's encrypted-at-rest
# checkpoint leaf through the memcrypt kernel.
TRAIN_ARCH = "qwen1.5-0.5b"
TRAIN_BATCH, TRAIN_SEQ = 8, 256
TRAIN_STEPS, TRAIN_CKPT_AT, TRAIN_MORE = 50, 25, 10
TRAIN_LR, TRAIN_WARMUP = 3e-4, 20
TRAIN_PROFILE_STEPS = 1
TRAIN_MESHLESS_STEPS = 3    # the meshless run the mesh run's losses must equal
HOST_KEY = dict(key0=0x5EC2E7, key1=0x7E9A27)   # the reference example's
# (a): one step of the full-width model cut to 2 layers, f32, on the card
# and on the CPU from the same weights and batch.  The devices sum in
# other orders; AdamW divides by sqrt(nu) + eps, so a parameter's step can
# differ by up to lr where its gradient is near eps: steps are held by norm.
GRAD_CHECK_LAYERS, GRAD_CHECK_BATCH, GRAD_CHECK_SEQ = 2, 2, 128
GRAD_CHECK_TOL = dict(loss=1e-5, grad_norm=1e-5, grad=1e-4, step=1e-3)
TRAIN_OP_CATEGORIES = {
    "matmuls (mm)": ("aten::mm", "aten::addmm"),
    "attention (bmm, softmax)": ("aten::bmm", "aten::_softmax",
                                 "aten::_softmax_backward_data"),
}
CE_BACKWARD = ("LogsumexpBackward", "TakeAlongDimBackward", "GatherBackward")


def _rel(got, want) -> float:
    """||got - want|| / ||want|| in f64 on the host."""
    got = got.detach().to("cpu", torch.float64)
    want = want.detach().to("cpu", torch.float64)
    return float((got - want).norm() / max(float(want.norm()), 1e-30))


def train_grad_check(dev) -> dict:
    """(a) One `train_step` of qwen1.5-0.5b at full width with
    ``GRAD_CHECK_LAYERS`` layers in f32 on the card and on the CPU, from
    the same weights and batch: loss, grad-norm, every gradient leaf and
    every parameter's step within ``GRAD_CHECK_TOL`` (relative, by norm),
    and no flash launch."""
    cfg = replace(ARCHS[TRAIN_ARCH], n_layers=GRAD_CHECK_LAYERS,
                  param_dtype="float32")
    t0 = time.perf_counter()
    cpu, cpu_opt = train.init_model(cfg, torch.device("cpu"), SEED)
    card = copy.deepcopy(cpu).to(dev)
    card_opt = init_state(card)
    before = {n: p.detach().clone() for n, p in cpu.named_parameters()}
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=GRAD_CHECK_SEQ,
                                  global_batch=GRAD_CHECK_BATCH, seed=SEED))
    step_fn = build_train_step(cfg, peak_lr=TRAIN_LR, warmup=0,
                               total_steps=100)
    batch = data.batch(0)
    flash0 = launches["flash_attention"]
    _, m_card = step_fn(card, card_opt, train.make_batch(cfg, data, 0, dev))
    torch.cuda.synchronize()
    flash = launches["flash_attention"] - flash0
    t_cpu = time.perf_counter()
    _, m_cpu = step_fn(cpu, cpu_opt, train.make_batch(cfg, data, 0, "cpu"))
    t_cpu = time.perf_counter() - t_cpu
    err = {k: _rel(m_card[k], m_cpu[k]) for k in ("loss", "grad_norm")}
    card_p = dict(card.named_parameters())
    grad_err, step_err = {}, {}
    for n, p in cpu.named_parameters():
        grad_err[n] = _rel(card_p[n].grad, p.grad)
        step_err[n] = _rel(card_p[n].detach().cpu() - before[n],
                           p.detach() - before[n])
    err["grad"] = max(grad_err.values())
    err["step"] = max(step_err.values())
    worst = {k: max(d, key=d.get) for k, d in (("grad", grad_err),
                                               ("step", step_err))}
    log(f"train (a): qwen1.5-0.5b full width, {GRAD_CHECK_LAYERS} layers, "
        f"f32, batch {GRAD_CHECK_BATCH} x {GRAD_CHECK_SEQ} (tokens "
        f"{batch['tokens'].shape}): card vs CPU loss "
        f"{float(m_card['loss']):.6f} / {float(m_cpu['loss']):.6f}; "
        f"relative errors {err} (worst grad {worst['grad']}, worst step "
        f"{worst['step']}); limits {GRAD_CHECK_TOL}; flash launches "
        f"{flash}; CPU step {t_cpu:.2f} s")
    bad = {k: v for k, v in err.items() if not v <= GRAD_CHECK_TOL[k]}
    if bad:
        raise AssertionError(f"train (a): card and CPU disagree: {bad}")
    if flash:
        raise AssertionError(f"train (a): {flash} flash launches in a "
                             "training step")
    del cpu, card, cpu_opt, card_opt
    free_card()
    return dict(errors=err, limits=GRAD_CHECK_TOL, worst=worst,
                cpu_step_s=t_cpu, wall_s=time.perf_counter() - t0)


def _train_flops(cfg, b: int, s: int) -> tuple[float, float]:
    """(model FLOPs of one train step: forward + backward of every matmul
    and the full [S, S] attention products the layers compute; the same
    plus the remat forward recompute of every layer)."""
    d, hd = cfg.d_model, cfg.head_dim
    layer = d * hd * (2 * cfg.n_heads + 2 * cfg.n_kv_heads) + 3 * d * cfg.d_ff
    t = b * s
    attn_fwd = 4 * b * cfg.n_heads * s * s * hd * cfg.n_layers
    fwd = 2 * t * (layer * cfg.n_layers + cfg.vocab_padded * d) + attn_fwd
    model = 3 * fwd
    recompute = 2 * t * layer * cfg.n_layers + attn_fwd
    return model, model + recompute


def profile_train_steps(cfg, model, opt, data, step_fn, first: int,
                        dev) -> tuple[dict, object]:
    """Device time of ``TRAIN_PROFILE_STEPS`` steps from ``first`` by op:
    matmul and attention aten ops (self time), the cross-entropy (forward
    scope and its backward nodes), AdamW and the clip (scopes around the
    step's calls), and the remat recompute (a scope around each layer's
    forward, named by whether a backward is running it); the device busy
    share of the profiled wall and the top device ops."""
    import repro_torch.launch.steps as steps_mod
    import repro_torch.models.lm as lm_mod
    wrapped = {}

    def scoped(mod, name, label):
        fn = getattr(mod, name)
        wrapped[(mod, name)] = fn

        def run(*a, **k):
            with torch.profiler.record_function(label):
                return fn(*a, **k)
        setattr(mod, name, run)

    def scoped_remat(fn, policy):
        def layer(*a, **k):
            # the checkpoint reruns the layer inside the backward
            label = "train::layer_forward" \
                if torch._C._current_graph_task_id() == -1 \
                else "train::remat_recompute"
            with torch.profiler.record_function(label):
                return fn(*a, **k)
        return wrapped[(lm_mod, "apply_remat")](layer, policy)

    scoped(lm_mod, "cross_entropy", "train::cross_entropy")
    scoped(steps_mod, "apply_updates", "train::adamw")
    scoped(steps_mod, "clip_by_global_norm", "train::clip")
    wrapped[(lm_mod, "apply_remat")] = lm_mod.apply_remat
    lm_mod.apply_remat = scoped_remat
    batches = [train.make_batch(cfg, data, first + i, dev)
               for i in range(TRAIN_PROFILE_STEPS)]
    try:
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            for b in batches:
                opt, _ = step_fn(model, opt, b)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t) * 1e3 / TRAIN_PROFILE_STEPS
    finally:
        for (mod, name), fn in wrapped.items():
            setattr(mod, name, fn)
    n = TRAIN_PROFILE_STEPS
    # The scopes are user annotations: the profiler also lists each as a
    # device-side span (gaps included), which is not device work.  Device
    # time is the kernels' and copies' own; a scope's is its CPU event's
    # kernels, children included.
    cuda_type = torch.autograd.DeviceType.CUDA
    raw = prof.events()
    annotation = lambda e: bool(getattr(e, "is_user_annotation", False)) \
        or e.name.startswith("train::")
    device = [e for e in raw if e.device_type == cuda_type
              and not annotation(e)]
    device_ms = sum(e.device_time_total for e in device) / n / 1e3
    host = [e for e in raw if e.device_type != cuda_type]
    scope = lambda pick: sum(e.device_time_total for e in host
                             if pick(e.name)) / n / 1e3
    self_ms = {}
    for e in host:
        if e.name.startswith("aten::"):
            self_ms[e.name] = self_ms.get(e.name, 0.0) + \
                e.self_device_time_total / n / 1e3
    by_op = {cat: sum(self_ms.get(k, 0.0) for k in names)
             for cat, names in TRAIN_OP_CATEGORIES.items()}
    by_op["cross-entropy"] = scope(lambda k: k == "train::cross_entropy") \
        + scope(lambda k: "evaluate_function" in k
                and any(c in k for c in CE_BACKWARD))
    by_op["AdamW"] = scope(lambda k: k == "train::adamw")
    by_op["clip"] = scope(lambda k: k == "train::clip")
    by_op["elementwise and other"] = device_ms - sum(by_op.values())
    kernels: dict = {}
    for e in device:
        kernels[e.name] = kernels.get(e.name, 0.0) + \
            e.device_time_total / n / 1e3
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:12]
    top_aten = sorted(self_ms.items(), key=lambda kv: -kv[1])[:12]
    return dict(wall_ms=wall, device_ms=device_ms, busy=device_ms / wall,
                by_op=by_op,
                remat_recompute_ms=scope(
                    lambda k: k == "train::remat_recompute"),
                layer_forward_ms=scope(lambda k: k == "train::layer_forward"),
                top_kernels=top, top_aten_self=top_aten), opt


def training_path(dev, smi: str) -> dict:
    """Main path 6, on the launcher's 1x1 NCCL mesh: (b) the launcher's
    loop (`launch.train.train_loop`) on qwen1.5-0.5b ``--preset full`` at
    batch 8 x 256 for 50 steps, its state placed by the rule engine
    (`train.mesh_specs`, `train.place_state`) and its steps under the mesh,
    the first ``TRAIN_MESHLESS_STEPS`` losses equal to a meshless run's bit
    for bit; (c) an asynchronous checkpoint at step 25 restored from LATEST
    into a fresh model and optimizer bit for bit, re-placed onto the mesh
    by `elastic_reshard` (every DTensor equal to the restored leaf), the
    run resumed from it to step 50, then 10 more steps; (d) the re-placed
    checkpoint's first leaf through the memcrypt kernel (its local tensor;
    the wrapper refuses the DTensor); (e) the step's wall, device time by
    op, tokens/s, peak memory and FLOP share, each beside the card's name
    and limit.  The process group is destroyed at the end."""
    t0 = time.perf_counter()
    cfg = train.preset_config(TRAIN_ARCH, "full")
    ckpt_dir = ROOT / "build" / "train_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    free_card()
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                                  global_batch=TRAIN_BATCH))
    step_fn = build_train_step(cfg, peak_lr=TRAIN_LR, warmup=TRAIN_WARMUP,
                               total_steps=max(TRAIN_STEPS, 100))
    plain_loop = functools.partial(
        train.train_loop, cfg, data=data, step_fn=step_fn, device=dev,
        log_every=5, last_step=TRAIN_STEPS - 1,
        log=lambda m: log(f"train: {m}"))
    # the meshless run's first steps, from the same seed
    model, opt = train.init_model(cfg, dev, SEED)
    meshless = plain_loop(model=model, opt=opt,
                          steps=range(TRAIN_MESHLESS_STEPS),
                          log=lambda m: log(f"train meshless: {m}"))["losses"]
    del model, opt
    free_card()
    if dist.is_initialized():
        raise AssertionError("train: a process group exists before the "
                             "phase")
    mesh = mesh_mod.make_smoke_mesh(dev)
    try:
        return _training_on_mesh(dev, smi, cfg, data, step_fn, plain_loop,
                                 mesh, meshless, ckpt_dir, t0)
    finally:
        dist.destroy_process_group()


def _training_on_mesh(dev, smi, cfg, data, step_fn, plain_loop, mesh,
                      meshless, ckpt_dir, t0) -> dict:
    def loop(**kw):
        with use_mesh(mesh):
            return plain_loop(**kw)

    torch.cuda.reset_peak_memory_stats()
    model, opt = train.init_model(cfg, dev, SEED)
    n_params = sum(p.numel() for p in model.parameters())
    pspecs, ospecs = train.mesh_specs(cfg, mesh, model, opt)
    opt = train.place_state(model, opt, mesh, pspecs, ospecs)
    reset_launches()
    t_run = time.perf_counter()
    # (b) step 0 alone: after it every parameter has a non-zero gradient
    run0 = loop(model=model, opt=opt, steps=range(0, 1))
    no_grad = [n for n, p in model.named_parameters()
               if p.grad is None or not bool(p.grad.ne(0).any())]
    if no_grad:
        raise AssertionError(f"train: {len(no_grad)} parameters without a "
                             f"non-zero gradient after step 1: {no_grad[:6]}")
    # (c) steps 1-24 and the asynchronous checkpoint at 25, joined at the
    # loop's end; restored from LATEST into a fresh model and state
    t = time.perf_counter()
    run1 = loop(model=model, opt=run0["opt"], steps=range(1, TRAIN_CKPT_AT),
                ckpt_dir=str(ckpt_dir), ckpt_every=TRAIN_CKPT_AT)
    on_mesh = (run0["losses"] + run1["losses"])[:TRAIN_MESHLESS_STEPS]
    if on_mesh != meshless:
        raise AssertionError(f"train: losses on the 1x1 mesh {on_mesh} are "
                             f"not the meshless run's {meshless}")
    log(f"train (b): the first {TRAIN_MESHLESS_STEPS} losses on the 1x1 "
        f"mesh ({dist.get_backend()}) equal the meshless run's bit for bit: "
        f"{on_mesh}")
    save_loop_s = time.perf_counter() - t
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    t = time.perf_counter()
    model2, opt2 = train.init_model(cfg, dev, SEED + 1)
    opt2, at = train.restore_state(str(ckpt_dir), model2, opt2)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t
    if at != TRAIN_CKPT_AT:
        raise AssertionError(f"train: LATEST is step {at}, not "
                             f"{TRAIN_CKPT_AT}")
    saved = train.train_state(model, run1["opt"])
    restored = train.train_state(model2, opt2)
    bits = lambda x: x.detach().view(torch.int16) \
        if x.dtype == torch.bfloat16 else x.detach()
    differ = [n for n, p in saved[0].items()
              if not torch.equal(bits(p), bits(restored[0][n]))]
    differ += [f"{f}.{n}" for f in ("mu", "nu")
               for n, m in getattr(saved[1], f).items()
               if not torch.equal(m, getattr(restored[1], f)[n])]
    if differ or {int(saved[1].step), int(restored[1].step)} != {at}:
        raise AssertionError(f"train: the restored state differs from the "
                             f"saved one: {differ[:6]}")
    dtypes = sorted({str(x.dtype) for x in restored[0].values()}
                    | {str(x.dtype) for x in opt2.mu.values()})
    # the restored checkpoint re-placed onto the mesh
    t = time.perf_counter()
    placed = elastic_reshard(
        (OrderedDict((k, p.detach()) for k, p in restored[0].items()),
         restored[1]),
        (sh.named(mesh, pspecs), sh.named(mesh, ospecs)))
    torch.cuda.synchronize()
    reshard_s = time.perf_counter() - t
    pairs = list(zip(store._flatten(placed), store._flatten(restored)))
    differ = [path for (path, d), (_, want) in pairs
              if not torch.equal(bits(d.to_local()), bits(want))]
    if differ or len(pairs) != 3 * len(restored[0]) + 1:
        raise AssertionError(f"train: the re-placed checkpoint differs: "
                             f"{differ[:6]} ({len(pairs)} leaves)")
    # (d) the re-placed checkpoint's first leaf (the token table) as u32
    # words, encrypted with the host key through the memcrypt kernel
    leaf_name, leaf_d = next(iter(placed[0].items()))
    try:
        mc.memcrypt(leaf_d, **HOST_KEY)
        raise AssertionError("train: memcrypt launched on a DTensor")
    except TypeError:
        pass
    leaf = leaf_d.to_local()
    words = leaf.reshape(-1).view(torch.int32)
    enc = ops.memory_encrypt(words, device=dev, **HOST_KEY)
    dec = ops.memory_decrypt(enc, device=dev, **HOST_KEY)
    plain = mc.ref.memcrypt(words, HOST_KEY["key0"], HOST_KEY["key1"], 0)
    torch.cuda.synchronize()
    compare("train leaf memcrypt", [enc], [plain])
    changed = int((enc != words).sum())
    if changed == 0:
        raise AssertionError("train: the ciphertext equals the plaintext")
    compare("train leaf decrypt", [dec], [words])
    log(f"train (c, d): checkpoint {TRAIN_CKPT_AT} ({len(saved[0])} "
        f"parameters + moments, {dtypes}) restored from LATEST bit for "
        f"bit in {restore_s:.2f} s and re-placed onto the mesh by "
        f"elastic_reshard ({len(pairs)} DTensors, "
        f"{leaf_d.placements} for the leaf, each equal to the restored "
        f"leaf) in {reshard_s:.2f} s; the wrapper refuses the DTensor; leaf "
        f"{leaf_name} {tuple(leaf.shape)} "
        f"{leaf.dtype} = {words.numel()} u32 words: ciphertext equals the "
        f"plain version, {changed} words changed, decrypts to the leaf")
    first_losses = run0["losses"] + run1["losses"]
    step_s = list(run1["step_s"])
    del model, saved, run0, run1, opt, enc, dec, plain, placed, pairs, \
        leaf_d
    free_card()
    opt2 = train.place_state(model2, opt2, mesh, pspecs, ospecs)
    # the run resumes from the restored state: steps 25-49, then 10 more
    run2 = loop(model=model2, opt=opt2,
                steps=range(TRAIN_CKPT_AT, TRAIN_STEPS))
    wall = time.perf_counter() - t_run
    losses = first_losses + run2["losses"]
    done = train.done_line(losses, wall)
    log(f"train: {done}")
    run3 = loop(model=model2, opt=run2["opt"],
                steps=range(TRAIN_STEPS, TRAIN_STEPS + TRAIN_MORE))
    torch.cuda.synchronize()
    counts = dict(launches)
    all_losses = losses + run3["losses"]
    if len(losses) != TRAIN_STEPS or not np.isfinite(all_losses).all():
        raise AssertionError(f"train: losses {all_losses}")
    if not done.endswith("(DECREASED)"):
        raise AssertionError(f"train: the loss did not decrease: {done}")
    gnorm = float(run3["metrics"]["grad_norm"])
    if not gnorm > 0:
        raise AssertionError(f"train: grad-norm {gnorm}")
    if counts["flash_attention"] or counts["memcrypt"] < 2:
        raise AssertionError(f"train: launches {counts}: training must not "
                             "launch flash, the leaf must launch memcrypt")

    # (e) records
    step_ms = [x * 1e3 for x in step_s + run2["step_s"]]
    med = float(np.median(step_ms))
    tokens = TRAIN_BATCH * TRAIN_SEQ
    # the leaf's memcrypt timed before the step profile (a profiler
    # run after it has returned no device events)
    leaf_call_ms = cuda_ms(lambda: mc.memcrypt(words, **HOST_KEY), 10)
    leaf_ms = kernel_only_ms(lambda: mc.memcrypt(words, **HOST_KEY),
                             "memcrypt")
    leaf_plain_ms = cuda_ms(lambda: mc.ref.memcrypt(
        words, HOST_KEY["key0"], HOST_KEY["key1"], 0), 3)
    leaf_bound = bound(8 * words.numel(), KEYSTREAM_OPS * words.numel())
    t = time.perf_counter()
    with use_mesh(mesh):
        prof, opt_next = profile_train_steps(
            cfg, model2, run3["opt"], data, step_fn,
            TRAIN_STEPS + TRAIN_MORE, dev)
    profile_s = time.perf_counter() - t
    recompute_ms = prof["remat_recompute_ms"]
    model_flops, hw_flops = _train_flops(cfg, TRAIN_BATCH, TRAIN_SEQ)
    by_op = {k: round(v, 3) for k, v in prof["by_op"].items()}
    rec = dict(
        arch=TRAIN_ARCH, preset="full", params=n_params,
        batch=TRAIN_BATCH, seq=TRAIN_SEQ, steps=TRAIN_STEPS,
        more_steps=TRAIN_MORE, losses=all_losses, done=done,
        launches=counts, step_ms=step_ms, step_median_ms=med,
        tokens_per_s=tokens * 1e3 / med, peak_memory_gb=peak_gb,
        restore_s=restore_s, save_loop_s=save_loop_s, profile_s=profile_s,
        mesh=str(mesh), mesh_backend=dist.get_backend(),
        meshless_losses=meshless, reshard_s=reshard_s,
        checkpoint_dtypes=dtypes, profile=prof,
        busy_of_median=prof["device_ms"] / med,
        remat_recompute_ms=recompute_ms, model_flops=model_flops,
        flops_with_recompute=hw_flops,
        model_flop_share=model_flops / (med / 1e3) / PEAK_BF16_FLOPS,
        hw_flop_share=hw_flops / (med / 1e3) / PEAK_BF16_FLOPS,
        flop_floor_ms=hw_flops / PEAK_BF16_FLOPS * 1e3,
        leaf_words=words.numel(), leaf_memcrypt_ms=leaf_ms,
        leaf_call_ms=leaf_call_ms,
        leaf_plain_ms=leaf_plain_ms, leaf_bound_ms=leaf_bound[0],
        leaf_bound_by=leaf_bound[1])
    log(f"train (e) on {smi}: qwen1.5-0.5b full ({n_params / 1e6:.1f} M "
        f"parameters, bf16, remat full), batch {TRAIN_BATCH} x {TRAIN_SEQ}: "
        f"step wall median {med:.2f} ms (steps 1-49: "
        f"{min(step_ms):.2f}-{max(step_ms):.2f}), {rec['tokens_per_s']:.0f} "
        f"tokens/s; device time {prof['device_ms']:.2f} ms a step "
        f"({100 * rec['busy_of_median']:.1f} % of the median wall; "
        f"{100 * prof['busy']:.1f} % of the {prof['wall_ms']:.2f} ms "
        f"profiled wall); device ms by op {by_op}; remat recompute "
        f"{recompute_ms:.2f} ms (the layers' first forward "
        f"{prof['layer_forward_ms']:.2f} ms); peak memory {peak_gb:.2f} GB "
        f"(steps 0-24); "
        f"{model_flops / 1e12:.2f} TFLOP a step ({hw_flops / 1e12:.2f} with "
        f"recompute, floor {rec['flop_floor_ms']:.2f} ms at "
        f"{PEAK_BF16_FLOPS:.3e} FLOP/s): "
        f"{100 * rec['model_flop_share']:.1f} % of the bf16 peak "
        f"({100 * rec['hw_flop_share']:.1f} % with recompute)")
    log(f"train (e) on {smi}: top device kernels "
        f"{[(k[:60], round(v, 3)) for k, v in prof['top_kernels']]}; top "
        f"aten ops by self device ms "
        f"{[(k, round(v, 3)) for k, v in prof['top_aten_self']]}; "
        f"asynchronous save + steps 1-24 {save_loop_s:.2f} s, profile "
        f"{profile_s:.2f} s")
    log(f"train (d) on {smi}: memcrypt of the {words.numel()}-word leaf "
        f"{leaf_ms} ms by the profiler, {leaf_call_ms:.4f} ms a call by "
        f"CUDA events (plain {leaf_plain_ms:.3f} ms, bound "
        f"{leaf_bound[0]:.4f} ms by {leaf_bound[1]}); path launches "
        f"{counts}")
    del model2, opt2, opt_next, run2, run3, words, restored
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    free_card()
    rec["wall_s"] = time.perf_counter() - t0
    log(f"train: phase wall {rec['wall_s']:.3f} s")
    return rec


DRYRUN_CELL = ("qwen1.5-0.5b", "decode_32k")
DRYRUN_ARG_BYTES = 1_668_721_700     # the reference's, per rank (pod 16x16)


def dryrun_path() -> dict:
    """The dry run of one cell in a subprocess, as a user runs it: a host
    check (fake tensors on a fake process group; the card is hidden from
    the subprocess), so this process' card memory must not move."""
    out_dir = ROOT / "build" / "dryrun_smoke"
    shutil.rmtree(out_dir, ignore_errors=True)
    arch, shape = DRYRUN_CELL
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", shape, "--mesh", "single", "--out", str(out_dir)],
        cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
                       "CUDA_VISIBLE_DEVICES": ""},
        capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    if proc.returncode != 0 or "All dry-run cells passed." not in \
            proc.stdout:
        raise AssertionError(f"dryrun: rc {proc.returncode}\n"
                             f"{proc.stdout[-3000:]}{proc.stderr[-3000:]}")
    after = torch.cuda.memory_allocated()
    rec = json.loads((out_dir / f"{arch.replace('.', '_')}__{shape}__"
                      "pod_16x16.json").read_text())
    args = rec["memory_analysis"]["argument_size_in_bytes"]
    if rec["status"] != "OK" or args != DRYRUN_ARG_BYTES:
        raise AssertionError(f"dryrun: status {rec['status']}, argument "
                             f"bytes {args}, not {DRYRUN_ARG_BYTES}")
    if after != before:
        raise AssertionError(f"dryrun: card memory moved {before} -> "
                             f"{after} bytes")
    shutil.rmtree(out_dir, ignore_errors=True)
    out = {"arch": arch, "shape": shape, "mesh": rec["mesh"],
           "status": rec["status"], "argument_bytes": args,
           "dot_flops": rec["hlo_analysis"]["dot_flops"],
           "flops_per_device": rec["flops_per_device"],
           "collective_bytes": rec["collective_bytes_per_device"]["total"],
           "lower_s": rec["lower_s"], "compile_s": rec["compile_s"],
           "memory_allocated": after, "wall_s": wall,
           "torch": torch.__version__}
    log(f"dryrun (host): {arch} x {shape} x {rec['mesh']} OK on a fake "
        f"256-rank group: argument bytes {args} per rank, dot FLOPs "
        f"{out['dot_flops']:.4e}, FLOPs {out['flops_per_device']:.4e}, "
        f"collective bytes {out['collective_bytes']:.4e} per rank; state "
        f"{rec['lower_s']} s, traced step {rec['compile_s']} s, phase wall "
        f"{wall:.3f} s; card memory {after} bytes before and after")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    log(f"device: {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}")
    log(f"nvidia-smi: {smi}")
    ops_per_s, sms, mhz = int32_peak()
    log(f"peaks: HBM {PEAK_BYTES_PER_S:.3e} B/s; int32 {sms} SMs x "
        f"{mhz:.0f} MHz x {INT32_OPS_PER_CLOCK_PER_SM} = {ops_per_s:.4e} "
        f"ops/s")

    t = time.perf_counter()
    _build.library()
    log(f"build: {len(_build.sources())} sources -> {_build.LIB_NAME} in "
        f"{time.perf_counter() - t:.2f} s")
    for line in _build.build_log().splitlines():
        if "registers" in line or "spill" in line or line.startswith("==") \
                or "entry function" in line:
            log(f"  ptxas {line.strip()}")
    check_flash_build(_build.build_log())
    check_search_build(_build.build_log())

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("f32 matmuls must not run in TF32")
    results: dict = {}
    kernel_phases(dev, results)
    flash_phase(dev, results)
    granite = grouped_ffn_phase(dev, results)

    # main path 1: the checked egress path
    reset_launches()
    quickstart(dev)
    if launches["checked_memcrypt"] != 2:
        raise AssertionError(f"quickstart launched checked_memcrypt "
                             f"{launches['checked_memcrypt']} times, not 2")
    main = fabric_main_path(dev)
    counts = dict(launches)
    log(f"main egress path launches: {counts}")
    for name in ("memcrypt", "permcheck", "checked_memcrypt",
                 "fabric_egress"):
        if counts[name] == 0:
            raise AssertionError(f"{name} never launched on the main path")
    # the examples (the phase resets and reads the counts inside)
    examples = examples_path(dev)
    # main path 2: serving; main paths 3 and 4: the chaos storm and the
    # clocked timing path (each resets and reads the counts inside)
    serve = serve_main_path(dev, SERVE_ARCH, "main serve")
    chaos = chaos_path(dev)
    timing = timing_path(dev)
    # main path 5: MoE serving; then the family and shared-experts phases
    # (each resets and reads the counts inside)
    # main path 5b: the same olmoe parameters on the 1x1 NCCL mesh
    moe = serve_main_path(dev, MOE_ARCH, "main moe",
                          then=lambda cfg, params: mesh_path(dev, cfg, params,
                                                             smi))
    meshed = moe.pop("then")
    families = family_paths(dev)
    shared = shared_experts_path(dev)
    # main path 6: training (after the card-vs-CPU gradient check, which
    # launches no kernel; the path resets and reads the counts inside)
    grad_check = train_grad_check(dev)
    training = training_path(dev, smi)
    # the dry run: a host check, no kernel
    dry = dryrun_path()
    for path in (granite, examples, serve, chaos, timing, moe, meshed,
                 *families.values(), shared, training):
        for name, n in path["launches"].items():
            counts[name] += n
    for name, path in (("chaos", chaos), ("timing", timing)):
        if path["launches"]["fabric_egress"] == 0:
            raise AssertionError(f"fabric_egress never launched on the "
                                 f"{name} path")
    log(f"slice phases on {smi}: chaos storm wall {chaos['wall_s']:.3f} s "
        f"({len(CHAOS_SEEDS)} seeds), timing path wall "
        f"{timing['wall_s']:.3f} s")
    log(f"family phases on {smi}: moe serve wall {moe['wall_s']:.3f} s; "
        + "; ".join(f"{a} wall {p['wall_s']:.3f} s"
                    for a, p in families.items())
        + f"; shared experts wall {shared['wall_s']:.3f} s")
    log(f"training phase on {smi}: gradient check wall "
        f"{grad_check['wall_s']:.3f} s, training path wall "
        f"{training['wall_s']:.3f} s")
    log(f"mesh phase on {smi}: wall {meshed['wall_s']:.3f} s")
    log(f"dryrun phase (host) beside {smi}: wall {dry['wall_s']:.3f} s")
    log(f"examples phase on {smi}: wall {examples['wall_s']:.3f} s "
        f"(quickstart card {examples['torch_quickstart']['card_s']:.3f} s, "
        f"multihost card "
        f"{examples['torch_multihost_graph_sharing']['card_s']:.3f} s + CPU "
        f"{examples['torch_multihost_graph_sharing']['cpu_s']:.3f} s); "
        f"shared experts at {shared['n_layers']} layers wall "
        f"{shared['wall_s']:.3f} s")

    line = {"kernels": [], "main_path": main, "granite_decode": granite,
            "examples_path": examples,
            "serve_path": serve,
            "chaos_path": chaos, "timing_path": timing,
            "moe_serve_path": moe, "mesh_path": meshed,
            "family_paths": families,
            "shared_experts_path": shared,
            "train_grad_check": grad_check, "training_path": training,
            "dryrun_path": dry, "card": smi, "peaks": {"bytes_per_s": PEAK_BYTES_PER_S,
                                   "int32_ops_per_s": ops_per_s,
                                   "f32_flops": PEAK_F32_FLOPS,
                                   "bf16_flops": PEAK_BF16_FLOPS,
                                   "sms": sms, "max_sm_mhz": mhz}}
    for name, r in results.items():
        src, replaces = SOURCES[name]
        # the kernel's own device time; the whole wrapper call (helper ops
        # and host dispatch included) when the profiler saw no device time
        ms = r["kernel_only_ms"] or r["call_ms"]
        line["kernels"].append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=counts[name], max_abs_err=r["max_abs_err"],
            mismatches=r["mismatches"], ms=ms, kernel_ms=ms,
            ms_from="profiler" if r["kernel_only_ms"] else "call",
            call_ms=r["call_ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"],
            shape=r["shape"], phases=r.get("phases")))
    log(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
