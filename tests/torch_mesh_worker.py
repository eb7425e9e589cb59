"""The ranks of the multi-rank CPU tests (``tests/test_torch_moe_ep_mesh.py``).

`spawn_ranks` starts one ``spawn`` process per rank; each joins a gloo
process group over a ``FileStore`` under the test's own directory (the
tests run in several workers at once, so no TCP port is shared), runs
`rank_main` and writes its results to ``rank<r>.npz``.  A rank imports
torch and the port only.
"""
from __future__ import annotations

import os
import time
from collections import OrderedDict
from types import SimpleNamespace

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

WORLD = 4
# (case, mesh shape, mesh axes, expert axis, capacity factor, FFN width key)
CASES = [
    ("2x2-model-cf8", (2, 2), ("data", "model"), "model", 8.0, "w"),
    ("2x2-model-cf1", (2, 2), ("data", "model"), "model", 1.0, "w"),
    ("2x2-data-cf8", (2, 2), ("data", "model"), "data", 8.0, "w"),
    ("2x2-data-cf1", (2, 2), ("data", "model"), "data", 1.0, "w"),
    ("pod-model-cf8", (2, 1, 2), ("pod", "data", "model"), "model", 8.0,
     "w"),
    ("pod-model-cf1", (2, 1, 2), ("pod", "data", "model"), "model", 1.0,
     "w"),
    ("pod-data-cf8", (2, 1, 2), ("pod", "data", "model"), "data", 8.0, "w"),
    ("pod-data-cf1", (2, 1, 2), ("pod", "data", "model"), "data", 1.0, "w"),
    # an FFN width that the model axis does not divide (ROADMAP defect 9)
    ("2x2-data-oddffn", (2, 2), ("data", "model"), "data", 8.0, "odd"),
]
TOP_K = 2


def moe_params(inputs, key: str):
    """The MoE weights ``key`` names (``w``: the FFN width the model axis
    divides, ``odd``: one it does not) as the tensors `moe_ffn_ep` reads."""
    return SimpleNamespace(router=torch.from_numpy(inputs["router"]), **{
        f"w_{part}": torch.from_numpy(inputs[f"{key}_{part}"])
        for part in ("gate", "up", "down")})


def _reshard_checks(mesh, ckpt_dir: str, rank: int) -> dict:
    """Save a tree on rank 0, restore it on every rank and re-place it on
    the 2x2 mesh; each DTensor's local shard and full tensor against the
    restored tree.  Then the launcher's placement, which raises on a mesh
    of more than one device."""
    from torch.distributed.tensor import DTensor, Shard

    from repro_torch.checkpointing import elastic_reshard, store
    from repro_torch.launch import sharding as sh
    from repro_torch.launch import train
    from repro_torch.optim import AdamWState
    g = torch.Generator().manual_seed(5)
    tree = {"w": torch.randn(8, 6, generator=g),
            "opt": AdamWState(torch.tensor(3, dtype=torch.int32),
                              OrderedDict(a=torch.randn(4, 10, generator=g)),
                              OrderedDict(a=torch.randn(4, 10,
                                                        generator=g)))}
    if rank == 0:
        store.save(ckpt_dir, 7, tree)
    dist.barrier()
    like = {"w": torch.zeros(8, 6),
            "opt": AdamWState(torch.tensor(0, dtype=torch.int32),
                              OrderedDict(a=torch.zeros(4, 10)),
                              OrderedDict(a=torch.zeros(4, 10)))}
    restored, step = store.restore(ckpt_dir, like)
    specs = {"w": sh.P("data", "model"),
             "opt": AdamWState(sh.P(), OrderedDict(a=sh.P(("data",
                                                           "model"))),
                               OrderedDict(a=sh.P(None, "model")))}
    placed = elastic_reshard(restored, sh.named(mesh, specs))
    leaves = [(placed["w"], restored["w"], (Shard(0), Shard(1))),
              (placed["opt"].step, restored["opt"].step, None),
              (placed["opt"].mu["a"], restored["opt"].mu["a"],
               (Shard(0), Shard(0))),
              (placed["opt"].nu["a"], restored["opt"].nu["a"],
               (None, Shard(1)))]
    ok = [step == 7, torch.equal(restored["w"], tree["w"])]
    for d, want, placements in leaves:
        ok.append(isinstance(d, DTensor))
        ok.append(torch.equal(d.full_tensor(), want))
        if placements is not None:
            ok.append(all(p is None or d.placements[i] == p
                          for i, p in enumerate(placements)))
    # the local shards: w rows by data, columns by model
    di, mi = mesh.get_local_rank("data"), mesh.get_local_rank("model")
    ok.append(torch.equal(placed["w"].to_local(),
                          tree["w"][di * 4:(di + 1) * 4, mi * 3:(mi + 1) * 3]))
    ok.append(torch.equal(placed["opt"].mu["a"].to_local(),
                          tree["opt"].mu["a"][rank:rank + 1]))
    try:
        train.place_state(torch.nn.Linear(2, 2), tree["opt"], mesh, {}, {})
        raised = ""
    except NotImplementedError as e:
        raised = str(e)
    return {"reshard_ok": np.array(ok), "place_state_raised": raised}


def rank_main(rank: int, store_path: str, in_path: str, out_dir: str,
              ckpt_dir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, WORLD),
                            rank=rank, world_size=WORLD)
    try:
        from torch.distributed.device_mesh import init_device_mesh

        from repro_torch.launch.activations import use_mesh
        from repro_torch.layers import moe_ep
        inputs = dict(np.load(in_path))
        x = torch.from_numpy(inputs["x"])
        meshes, out = {}, {}
        for case, shape, axes, mode, cf, key in CASES:
            if axes not in meshes:
                meshes[axes] = init_device_mesh("cpu", shape,
                                                mesh_dim_names=axes)
            moe_ep.reset_collectives()
            with use_mesh(meshes[axes]):
                y, aux = moe_ep.moe_ffn_ep(
                    moe_params(inputs, key), x, top_k=TOP_K,
                    capacity_factor=cf, expert_axis=mode)
            out[f"{case}_y"] = y.numpy()
            out[f"{case}_aux"] = aux.numpy()
            out[f"{case}_collectives"] = np.array(
                [moe_ep.collectives[k] for k in sorted(moe_ep.collectives)])
        out.update(_reshard_checks(meshes[("data", "model")], ckpt_dir,
                                   rank))
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


def spawn_ranks(tmp, in_path: str, timeout: float) -> list[dict]:
    """Run `rank_main` in ``WORLD`` spawned processes; each rank's results.
    Kills every rank and raises if one fails or the join times out."""
    ctx = mp.get_context("spawn")
    store_path, ckpt_dir = str(tmp / "store"), str(tmp / "ckpt")
    os.makedirs(ckpt_dir, exist_ok=True)
    procs = [ctx.Process(target=rank_main,
                         args=(r, store_path, in_path, str(tmp), ckpt_dir))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    try:
        deadline = time.monotonic() + timeout
        for p in procs:
            p.join(max(deadline - time.monotonic(), 0.0))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        if hung:
            raise TimeoutError(f"ranks {hung} still running after "
                               f"{timeout} s")
        failed = {r: p.exitcode for r, p in enumerate(procs) if p.exitcode}
        if failed:
            raise RuntimeError(f"ranks failed with exit codes {failed}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(WORLD)]
