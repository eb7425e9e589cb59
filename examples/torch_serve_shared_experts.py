"""Serve an MoE model whose expert weights live in a Space-Control-guarded
shared pool — the paper's flagship framework integration ("sharing of
machine learning model weights (especially in expert models) across hosts",
paper §1) — on the PyTorch port.

Two tenants serve the same OLMoE-style model from one shared expert pool:
  * tenant A is granted ALL experts,
  * tenant B is granted only the first half of every layer's experts.
Expert weights are fetched through ``checked_gather`` at each MoE layer; for
tenant B the denied experts come back zero-filled.  Mid-run the FM revokes
tenant A: every one of its expert fetches is then denied, while tenant B's
next tokens do not change — live revocation in the serving path.

    PYTHONPATH=src python examples/torch_serve_shared_experts.py
    PYTHONPATH=src python examples/torch_serve_shared_experts.py --device cpu

The model runs on the card unless ``--device cpu`` is given; `run` takes
any olmoe-family config (``chip_smoke.py`` runs it at olmoe's full width).
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from repro_torch.configs import ARCHS, smoke_config
from repro_torch.core import (PERM_R, FabricManager, Proposal,
                              SharedTensorPool, checked_gather,
                              make_hwpid_local)
from repro_torch.core.table import PAGE_BYTES
from repro_torch.kernels import resolve_device
from repro_torch.layers.common import param
from repro_torch.models import registry

EXPERT_WEIGHTS = ("w_gate", "w_up", "w_down")


def run(cfg, *, device=None, seed: int = 0, batch: int = 2,
        prompt_len: int = 12, log=print) -> dict:
    """Publish the experts, grant A all and B half, serve one step per
    tenant, revoke A, serve again.  Returns each serve's (next tokens,
    denied fetches, denied rows all zero); raises if isolation does not
    hold."""
    dev = resolve_device(device)
    params = registry.init_params(
        cfg, torch.Generator(device=dev).manual_seed(seed), dev)
    n_layers, n_exp = len(params.layers), cfg.n_experts
    moes = [unit.moe for unit in params.layers]

    # --- publish expert weights into the shared pool: rows are (layer,
    # expert) pairs; the model's own copies are dropped, so every expert
    # the model uses comes out of the pool
    pool = SharedTensorPool()
    regions = {}
    for name in EXPERT_WEIGHTS:
        w = torch.stack([getattr(m, name) for m in moes])   # [L, E, ...]
        regions[name] = pool.register(name, w.reshape(-1, *w.shape[2:]))
        for m in moes:
            setattr(m, name, None)
    log(f"expert pool: {pool.total_pages} pages "
        f"({sum(r.n_pages for r in regions.values()) * PAGE_BYTES // 2**20}"
        f" MiB)")

    fm = FabricManager(sdm_pages=pool.total_pages + 8, table_capacity=4096)
    host_a, host_b = fm.enroll_host(0), fm.enroll_host(1)
    pid_a, pid_b = host_a.get_next_pid(), host_b.get_next_pid()
    # tenant A: everything; tenant B: experts [0, E/2) of every layer
    for r in regions.values():
        fm.propose(Proposal(0, pid_a, 0xA, r.start_page, r.n_pages, PERM_R))
    for r in regions.values():
        bpr = r.bytes_per_row
        for layer in range(n_layers):
            first = r.start_page + layer * n_exp * bpr // PAGE_BYTES
            fm.propose(Proposal(1, pid_b, 0xB, first,
                                max(1, -(-(n_exp // 2) * bpr // PAGE_BYTES)),
                                PERM_R))

    def fetch_experts(hwpid, local, table, layer):
        """One layer's expert weights through the permission checker:
        (weights by name, allowed [E] per name)."""
        out, allowed = {}, {}
        rows = torch.arange(layer * n_exp, (layer + 1) * n_exp, device=dev)
        for name in EXPERT_WEIGHTS:
            res = checked_gather(pool, name, rows, hwpid=hwpid, table=table,
                                 hwpid_local=local)
            out[name], allowed[name] = res.data, res.check.allowed
        return out, allowed

    def serve(hwpid, local, tokens, label):
        """One greedy step with every MoE layer's experts fetched through
        the checker; returns (next tokens, denied fetches, denied rows
        all zero)."""
        table = fm.table.to_device(dev)
        denied, zero = 0, True
        for layer, m in enumerate(moes):
            w, allowed = fetch_experts(hwpid, local, table, layer)
            for name in EXPERT_WEIGHTS:
                denied += int((~allowed[name]).sum())
                zero &= not bool(w[name][~allowed[name]].any())
                setattr(m, name, param(w[name]))
        logits, _ = registry.model_module(cfg).forward(cfg, params, tokens)
        for m in moes:
            for name in EXPERT_WEIGHTS:
                setattr(m, name, None)
        nxt = logits[:, -1].argmax(dim=-1).tolist()
        log(f"  {label}: denied expert fetches={denied:3d} next "
            f"tokens={nxt}")
        return nxt, denied, zero

    rng = np.random.default_rng(seed)
    tokens = torch.from_numpy(rng.integers(3, cfg.vocab - 1, (
        batch, prompt_len)).astype(np.int32)).to(dev)
    local_a = make_hwpid_local([pid_a], device=dev)
    local_b = make_hwpid_local([pid_b], device=dev)
    per_tenant = n_layers * n_exp * len(EXPERT_WEIGHTS)

    log(f"batched serving step ({batch} requests/tenant):")
    a1 = serve(pid_a, local_a, tokens, "tenant A (all experts) ")
    b1 = serve(pid_b, local_b, tokens, "tenant B (half experts)")
    log("FM revokes tenant A mid-serving (BISnp -> permission caches):")
    fm.revoke_hwpid(pid_a)
    a2 = serve(pid_a, local_a, tokens, "tenant A (revoked)     ")
    b2 = serve(pid_b, local_b, tokens, "tenant B (unaffected)  ")
    if a1[1] != 0:
        raise AssertionError(f"tenant A was denied {a1[1]} fetches before "
                             "its revocation")
    if b1[1] != per_tenant // 2 or b2[1] != b1[1] or not (b1[2] and b2[2]):
        raise AssertionError("tenant B must be denied exactly the upper "
                             "half of the experts, zero-filled")
    if a2[1] != per_tenant or not a2[2]:
        raise AssertionError(f"revoked tenant A fetched "
                             f"{per_tenant - a2[1]} expert rows, or its "
                             "denied rows are not zero")
    if b2[0] != b1[0]:
        raise AssertionError(f"tenant B's tokens changed with A's "
                             f"revocation: {b1[0]} -> {b2[0]}")
    log("tenant B unaffected by A's revocation — isolation holds.  OK")
    return {"a_before": a1, "b_before": b1, "a_revoked": a2,
            "b_after": b2, "fetches_per_tenant": per_tenant}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)
    # a small OLMoE-family model
    cfg = dataclasses.replace(smoke_config(ARCHS["olmoe-1b-7b"]), n_layers=2,
                              n_experts=8, top_k=2)
    run(cfg, device=args.device)


if __name__ == "__main__":
    main()
