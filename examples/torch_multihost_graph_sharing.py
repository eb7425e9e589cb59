"""The paper's evaluation scenario end to end on the PyTorch port: 8 hosts
share one graph in SDM (host 0 allocates, hosts 1..6 run GAPBS kernels, one
FM), with Space-Control isolation and the analytical CXL timing model
producing the paper's headline numbers.

Demonstrates:
  1. graph partitions guarded by per-process permission entries (CSR slices
     — the paper's "users on a host can read or update only its assigned
     partitions");
  2. a malicious process + compromised-OS scenario (§5.1): remapped page
     tables read only ciphertext (the memcrypt kernel);
  3. CPI overhead of the enforcement vs a checks-free cxl baseline;
  4. the fabric-scale replay: one fabric-egress kernel launch per step,
     with a revocation mid-run.

The same flow and the same printout as ``examples/multihost_graph_sharing.py``.

    PYTHONPATH=src python examples/torch_multihost_graph_sharing.py
    PYTHONPATH=src python examples/torch_multihost_graph_sharing.py --device cpu

The card is the default (raises when there is none): the secret words and
every fabric step go through the kernels.  ``--device cpu`` runs their
plain versions.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.convert import u32_to_numpy
from repro_torch.core import (
    PERM_R,
    PERM_RW,
    FabricManager,
    Proposal,
    ShardedFabric,
    check_access,
    make_hwpid_local,
    pack_ext_addr,
)
from repro_torch.kernels import resolve_device
from repro_torch.kernels.ops import memory_decrypt, memory_encrypt
from repro_torch.memsim.model import run_pair
from repro_torch.workloads import gapbs
from repro_torch.workloads.graphs import make_graph


def run(device=None, log=print) -> dict:
    """The scenario on ``device``.  Returns what it found: the spot-check's
    verdicts and faults, the ciphertext words, the CPI rows, each fabric
    step's denied lanes per host, fault codes and words, and the fabric
    stats; raises if isolation does not hold."""
    dev = resolve_device(device)

    # --- host 0 allocates the graph in SDM
    g = make_graph(scale=12, avg_degree=12, seed=7)
    lay = gapbs.SDMLayout.for_graph(g)
    log(f"graph: {g.n} vertices, {g.m} edges; SDM layout "
        f"{lay.total_pages} pages")

    fm = FabricManager(sdm_pages=lay.total_pages, table_capacity=4096)
    hosts = [fm.enroll_host(i) for i in range(8)]

    # hosts 1..6 run kernels; each gets R on the graph structure and RW on
    # its own property-array partition (CSR slice isolation)
    kernels = ["pr", "bfs", "bc", "tc", "cc", "pr"]
    pids = []
    part = (lay.prop1_pg - lay.prop0_pg) // 6 or 1
    for i, kern in enumerate(kernels, start=1):
        pid = hosts[i].get_next_pid()
        pids.append(pid)
        fm.propose(Proposal(i, pid, 0x100 + i, lay.offsets_pg,
                            lay.prop0_pg - lay.offsets_pg, PERM_R))
        fm.propose(Proposal(i, pid, 0x100 + i, lay.prop0_pg + (i - 1) * part,
                            part, PERM_RW))
    table = fm.table.to_device(dev)
    log(f"permission table: {fm.table.n} entries "
        f"({fm.table.n * 64} B metadata = "
        f"{fm.table.n * 64 / (lay.total_pages * 4096) * 100:.4f}% of SDM)")

    # --- isolation spot-check: host1's process vs host2's partition
    own = lay.prop0_pg
    other = lay.prop0_pg + part
    r = check_access(
        table, make_hwpid_local([pids[0]], device=dev),
        pack_ext_addr(torch.full((2,), pids[0], dtype=torch.int32,
                                 device=dev),
                      torch.tensor([own, other], dtype=torch.int32,
                                   device=dev)),
        torch.tensor([True, True], device=dev))
    log(f"host1 writes own partition: {bool(r.allowed[0])}, "
        f"host2's partition: {bool(r.allowed[1])} (fault {int(r.fault[1])})")

    # --- compromised OS reads only ciphertext (§5.1.2)
    secret = np.frombuffer(b"graph partition secret bytes" + b"\0" * 4,
                           dtype=np.uint32)
    enc = memory_encrypt(secret, key0=0xC0FFEE, key1=0xBEEF, device=dev)
    stolen = u32_to_numpy(enc)  # what an OS alias mapping observes
    if np.array_equal(stolen, secret):
        raise AssertionError("the OS alias mapping saw the plaintext")
    back = memory_decrypt(enc, key0=0xC0FFEE, key1=0xBEEF, device=dev)
    if not np.array_equal(u32_to_numpy(back), secret):
        raise AssertionError("the trusted context did not decrypt")
    log("OS alias mapping sees ciphertext; trusted context decrypts. OK")

    # --- per-kernel enforcement overhead (paper Fig. 7 flavor)
    log("\nkernel  CPI(space-control)/CPI(cxl)   [6 hosts, 1-entry layout]")
    cpi = []
    for kern in ["pr", "bfs", "bc", "tc"]:
        tr = gapbs.TRACES[kern](g, cap=150_000, seed=1)
        res, base = run_pair(tr, n_entries=1, cache_bytes=2048, n_hosts=6,
                             kernel=kern, sdm_pages=lay.total_pages)
        log(f"  {kern:4s}  {res.cpi_norm:.4f}  "
            f"(plpki={res.plpki:.2f}, cache miss={res.miss_ratio:.4f})")
        cpi.append((kern, res.cpi_norm, res.plpki, res.miss_ratio))

    # --- fabric-scale batched egress (sharded fabric + async BISnp bus)
    # The same scenario on the deployment-simulation subsystem: the SDM page
    # space is sharded across 8 hosts, each worker replays its GAPBS
    # reference stream against its resident shard, and every step's H
    # host-batches run through ONE batched check⊕decrypt kernel launch.  A
    # mid-run revocation (one FM commit, BISnp'd over the async bus) kills
    # exactly one host's lanes while the rest stay fault-free.
    log("\nfabric-scale replay: 8 hosts, sharded permission table, one "
        "batched egress launch per step")
    n_hosts, span, batch, steps = 8, 256, 1024, 4
    fab = ShardedFabric(sdm_pages=n_hosts * 1024, table_capacity=4096,
                        n_shards=n_hosts, device=dev)
    for h in range(n_hosts):
        fab.enroll(h)
    tenants = {h: fab.admit(h, span) for h in range(n_hosts)}
    fab.quiesce()   # all hosts observe the grants -> fenced all-hit

    rng = np.random.default_rng(0)
    fabric_kernels = ["pr", "bfs", "bc", "tc"] * 2
    ext_by_host = {}
    for h, kern in enumerate(fabric_kernels):
        pid, start = tenants[h]
        tr = gapbs.TRACES[kern](g, cap=40_000, seed=h)
        ext_by_host[h], _ = gapbs.egress_batches(
            tr, hwpid=pid, batch=batch, n_steps=steps,
            page_offset=start, page_span=span)
    hwpid_by_host = {h: tenants[h][0] for h in range(n_hosts)}
    victim = 3
    replay = []
    for s in range(steps):
        if s == steps // 2:   # revoke host 3's tenant mid-replay
            fab.evict(victim, tenants[victim][0])
            fab.quiesce()
        ext = np.stack([ext_by_host[h][s] for h in range(n_hosts)])
        data = rng.integers(0, 1 << 32, ext.shape, dtype=np.uint32)
        out, fault = fab.step_egress(data, ext, hwpid_by_host, need=1)
        fault = fault.cpu()
        per_host = (fault != 0).sum(dim=1).tolist()
        log(f"  step {s}: denied lanes/host = {per_host}")
        if not all(per_host[h] == 0 for h in range(n_hosts)
                   if h != victim or s < steps // 2):
            raise AssertionError(f"step {s}: a lane outside the revoked "
                                 f"host was denied: {per_host}")
        if s >= steps // 2 and per_host[victim] != batch:
            raise AssertionError("revoked host must be fully denied")
        replay.append({"denied": per_host, "fault": fault.tolist(),
                       "out": u32_to_numpy(out).tolist()})
    st = fab.stats()
    log(f"fabric stats: epoch={st['epoch']}, bus={st['bus']}, "
        f"shard entries/host={list(st['shard_entries'].values())}")
    log("multihost sharing example OK")
    return {"spot_check": {"allowed": r.allowed.tolist(),
                           "fault": r.fault.tolist()},
            "ciphertext": stolen.tolist(), "cpi": cpi, "replay": replay,
            "stats": st}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)
    run(device=args.device)


if __name__ == "__main__":
    main()
