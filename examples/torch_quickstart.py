"""Quickstart: the Space-Control API on the PyTorch port.

Walks the paper's Fig. 2 workflow — enroll hosts, register a process with
SPACE, propose a permission entry, FM approval + L_exp issuance — then shows
enforcement on tagged accesses and revocation via BISnp.  The same flow and
the same printout as ``examples/quickstart.py``; the checker runs on the
card's tensors.

    PYTHONPATH=src python examples/torch_quickstart.py
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu

The card is the default (raises when there is none); ``--device cpu`` runs
the same checks on the CPU.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.core import (
    PERM_R,
    PERM_RW,
    RING_KERNEL,
    RING_USER,
    FabricManager,
    LruCache,
    Proposal,
    check_access,
    make_hwpid_local,
    pack_ext_addr,
)
from repro_torch.kernels import resolve_device


def run(device=None, log=print) -> dict:
    """Grant, validated context, checks inside and outside the grant and
    untagged, a second tenant, revocation.  Returns each check's verdicts
    and fault codes; raises if the flow does not hold."""
    dev = resolve_device(device)

    def pages(values):
        return torch.tensor(values, dtype=torch.int32, device=dev)

    def tags(hwpid: int, n: int):
        return torch.full((n,), hwpid, dtype=torch.int32, device=dev)

    def writes(values):
        return torch.tensor(values, dtype=torch.bool, device=dev)

    # --- deployment: one FM, two hosts sharing a 1 GiB SDM (262144 pages)
    fm = FabricManager(sdm_pages=262_144, table_capacity=4096)
    host0 = fm.enroll_host(0)
    host1 = fm.enroll_host(1)

    # --- process creation on host0 (paper §4.1.1)
    hwpid = host0.get_next_pid()      # SPACE assigns the HWPID, not the OS
    base_p = 0x7F00_0000              # page-table root of the process
    label = fm.propose(Proposal(host_id=0, hwpid=hwpid, base_p=base_p,
                                start_page=0, n_pages=1024, perm=PERM_RW))
    if label is None:
        raise AssertionError("the FM did not approve the proposal")
    log(f"process hwpid={hwpid} granted [0, 1024) RW; L_exp={label:#018x}")

    # --- runtime protection (paper §4.1.2)
    host0.context_switch(core=0, hwpid=hwpid, base_p=base_p)
    if not host0.arm_label(core=0, ring=RING_USER):
        raise AssertionError("the user-ring context did not validate")
    tag = host0.current_hwpid(0)      # A-bits for every LD/ST of this ctx
    log(f"validated context tags A-bits = {tag}")

    # a kernel-mode attempt to arm the label is refused
    host0.context_switch(core=1, hwpid=hwpid, base_p=base_p)
    if host0.arm_label(core=1, ring=RING_KERNEL):
        raise AssertionError("a kernel-ring ARM_LABEL was accepted")
    log("kernel-ring ARM_LABEL refused (shadow register unset)")

    # --- enforcement at the egress point
    table = fm.table.to_device(dev)
    local = make_hwpid_local([hwpid], device=dev)

    ok = check_access(table, local,
                      pack_ext_addr(tags(tag, 3), pages([0, 512, 1023])),
                      writes([False, True, False]))
    log(f"granted pages  : {ok.allowed.tolist()} (faults: "
        f"{ok.fault.tolist()} )")

    bad = check_access(table, local,
                       pack_ext_addr(tags(tag, 2), pages([1024, 9999])),
                       writes([False, False]))
    log(f"outside grant  : {bad.allowed.tolist()} (faults: "
        f"{bad.fault.tolist()} )")

    untagged = check_access(table, local,
                            pack_ext_addr(tags(0, 1), pages([10])),
                            writes([False]))
    log(f"untagged access: {untagged.allowed.tolist()} (fault "
        f"{int(untagged.fault[0])} = FAULT_NO_ABITS)")

    # --- second tenant on host1 gets a disjoint range
    pid2 = host1.get_next_pid()
    fm.propose(Proposal(1, pid2, 0x1234, start_page=1024, n_pages=1024,
                        perm=PERM_R))
    table = fm.table.to_device(dev)
    cross = check_access(table, make_hwpid_local([pid2], device=dev),
                         pack_ext_addr(tags(pid2, 2), pages([512, 1500])),
                         writes([False, False]))
    log(f"tenant2 reads own page: {bool(cross.allowed[1])}, "
        f"tenant1's page: {bool(cross.allowed[0])}")

    # --- revocation (paper §4.1.3): BISnp invalidates permission caches
    cache = LruCache(2048)
    fm.on_bisnp(lambda ev: cache.invalidate_all())
    cache.access(0)
    fm.revoke_hwpid(hwpid)
    table = fm.table.to_device(dev)
    gone = check_access(table, local,
                        pack_ext_addr(tags(tag, 1), pages([0])),
                        writes([False]))
    invalidated = not cache.access(0)
    log(f"after revocation tenant1 access allowed: {bool(gone.allowed[0])}; "
        f"cache invalidated: {invalidated}")
    log("quickstart OK")

    def verdict(res):
        return {"allowed": res.allowed.tolist(), "fault": res.fault.tolist()}

    return {"hwpid": hwpid, "label": label, "tag": tag,
            "granted": verdict(ok), "outside": verdict(bad),
            "untagged": verdict(untagged), "cross": verdict(cross),
            "revoked": verdict(gone), "cache_invalidated": invalidated}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card) or cpu")
    args = ap.parse_args(argv)
    run(device=args.device)


if __name__ == "__main__":
    main()
