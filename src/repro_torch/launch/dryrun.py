"""Multi-pod dry run (the port of ``repro.launch.dryrun``).

For every (architecture x input shape x mesh) cell, one step of the port
runs once on a fake process group of 256 (pod 16x16) or 512 (multipod
2x16x16) ranks, traced as rank 0: its parameters, AdamW state, batch and
cache are ``DTensor``s placed by the rule engine (`sharding`) with fake
local shards, so nothing is computed or allocated on any device.  A
`hlo_analysis.CostRecorder` counts the step per rank and the record lands
in ``experiments/dryrun_torch/*.json`` under the reference's file name, in
the reference's keys (``benchmarks/render_tables.dryrun_table`` reads
both).

    PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch A]
        [--shape S] [--mesh single|multi|both] [--out DIR]

The group: the reference forces 512 host devices through ``XLA_FLAGS``;
here the default process group is a ``FakeStore`` "fake" group of the
mesh's size, made (and, for the other mesh, remade) by `run_cell`.  A
process that already has a group of its own (a test worker, the card
smoke) runs the dry run in a subprocess.

The device: the dry run traces fake HOST tensors, always.  That is not a
CPU fallback: the reference's dry run is itself a host program that never
touches a TPU.  The attention layer picks the flash kernel for CUDA
tensors, and a kernel launch cannot take fake tensors, so the trace stays
on the host; there is no ``--device`` flag, as the reference has none.

The recorder alone counts the collectives: PyTorch's ``CommDebugMode``
stacked beside it raises in its module tracker under activation
checkpointing with several microbatches.

Differences in meaning from the reference's record, one line each:
  * ``compile_s`` is the wall time of the traced step (there is no
    compile); ``lower_s`` the time to build and place the state;
  * ``flops_per_device``/``bytes_accessed_per_device`` are the recorder's
    totals (eager has no raw, loop-blind cost analysis to keep beside them);
  * ``memory_analysis``'s ``temp_size_in_bytes`` is the recorder's peak of
    bytes made during the step; ``output_size_in_bytes`` counts the
    parameters a train step updates in place beside what it returns, and
    there is no ``generated_code_size_in_bytes``;
  * the decode position is a Python int (the host attention reads it);
    its 4 bytes still count as an argument.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from collections import OrderedDict

import torch
import torch.distributed as dist
from torch import nn

from ..configs import ARCHS, SHAPES
from ..configs.base import ArchConfig, ShapeConfig
from ..kernels import is_dtensor
from ..models import registry
from ..optim import AdamWState
from . import sharding as sh
from .activations import use_mesh
from .hlo_analysis import CostRecorder, _nbytes
from .mesh import make_production_mesh, mesh_devices, sharded_zeros
from .steps import build_prefill_step, build_serve_step, build_train_step

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")


def _local_bytes(tree) -> int:
    """Bytes of the tree's tensors on this rank (a DTensor's local
    shard)."""
    from torch.utils._pytree import tree_leaves
    return sum(_nbytes(t.to_local() if is_dtensor(t) else t)
               for t in tree_leaves(tree) if isinstance(t, torch.Tensor))


def collective_bytes(rec: CostRecorder) -> dict[str, float]:
    """Sum output bytes of the collective ops the recorder saw, per rank."""
    out = {c: float(rec.coll_out_bytes.get(c, 0.0)) for c in _COLLECTIVES}
    out["total"] = sum(out[c] for c in _COLLECTIVES)
    return out


def fake_group(world_size: int) -> None:
    """Make the default process group a "fake" group of ``world_size``
    ranks (this process is rank 0), replacing a fake group of another
    size.  Raises if the process has a real group."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError(
                "the dry run needs a process of its own: this one has a "
                f"{dist.get_backend()} process group; run it in a subprocess")
        if dist.get_world_size() == world_size:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def _place(mesh, spec, like: torch.Tensor):
    return sharded_zeros(mesh, sh.spec_placements(mesh, spec), like.shape,
                         like.dtype, "cpu")


def _placed_model(cfg: ArchConfig, mesh):
    """The model with every parameter a DTensor placed by the rules."""
    model = registry.param_shapes(cfg)
    specs = sh.param_spec_tree(cfg, mesh, model)
    for name, p in list(model.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        mod = model.get_submodule(owner) if owner else model
        mod._parameters[leaf] = nn.Parameter(_place(mesh, specs[name], p),
                                             requires_grad=False)
    return model, specs


def lower_cell(cfg: ArchConfig, shape: ShapeConfig, mesh):
    """(step, its arguments, the bytes of the arguments on this rank) for
    one (arch x shape) on ``mesh``: the state the reference lowers with,
    placed as DTensors.  Call it under the fake mode the step runs on."""
    batch_shapes = registry.input_specs(cfg, shape)
    model, pspecs = _placed_model(cfg, mesh)
    if shape.kind == "train":
        mdt = getattr(torch, cfg.moment_dtype)
        moments = lambda: OrderedDict(
            (n, _place(mesh, pspecs[n], torch.empty(p.shape, dtype=mdt,
                                                    device="meta")))
            for n, p in model.named_parameters())
        opt = AdamWState(_place(mesh, sh.P(), torch.empty(
            (), dtype=torch.int32, device="meta")), moments(), moments())
        bspecs = sh.batch_spec_tree(cfg, mesh, batch_shapes)
        batch = {k: _place(mesh, bspecs[k], v)
                 for k, v in batch_shapes.items()}
        return build_train_step(cfg), (model, opt, batch), \
            _local_bytes((list(model.parameters()), opt, batch))
    if shape.kind == "prefill":
        bspecs = sh.batch_spec_tree(cfg, mesh, batch_shapes)
        batch = {k: _place(mesh, bspecs[k], v)
                 for k, v in batch_shapes.items()}
        return build_prefill_step(cfg), (model, batch), \
            _local_bytes((list(model.parameters()), batch))
    cshapes = batch_shapes["cache"]
    cache = sh.sharded_zeros_tree(mesh, sh.cache_spec_tree(cfg, mesh,
                                                           cshapes),
                                  cshapes, "cpu")
    tok = batch_shapes["tokens"]
    tokens = _place(mesh, sh.batch_spec_tree(cfg, mesh,
                                             {"tokens": tok})["tokens"], tok)
    pos = shape.seq_len - 1
    return build_serve_step(cfg), (model, cache, tokens, pos), \
        _local_bytes((list(model.parameters()), cache, tokens)) + 4


def _out_bytes(shape: ShapeConfig, args, out) -> int:
    if shape.kind == "train":     # parameters updated in place, then state
        return _local_bytes((list(args[0].parameters()), out))
    return _local_bytes(out)


def run_cell(arch_id: str, shape_name: str, multi_pod: bool,
             out_dir: str | None = "experiments/dryrun_torch",
             verbose: bool = True) -> dict:
    cfg = ARCHS[arch_id]
    shape = SHAPES[shape_name]
    ok, reason = registry.supports_shape(cfg, shape)
    mesh_name = "multipod_2x16x16" if multi_pod else "pod_16x16"
    rec: dict = {"arch": arch_id, "shape": shape_name, "mesh": mesh_name}
    if not ok:
        rec["status"] = "SKIP"
        rec["reason"] = reason
        return rec

    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.experimental import implicit_replication
    fake_group(512 if multi_pod else 256)
    mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
    fake = FakeTensorMode(allow_non_fake_inputs=True)
    t0 = time.time()
    with fake:
        step, args, arg_bytes = lower_cell(cfg, shape, mesh)
    t1 = time.time()
    recorder = CostRecorder(fake)
    with implicit_replication(), use_mesh(mesh), recorder:
        out = step(*args)
    t2 = time.time()
    analysis = recorder.analyze(top_k=6)
    coll = collective_bytes(recorder)
    n_dev = mesh_devices(mesh)

    rec.update({
        "status": "OK",
        "devices": n_dev,
        "lower_s": round(t1 - t0, 2),
        "compile_s": round(t2 - t1, 2),
        "flops_per_device": analysis["flops"],
        "bytes_accessed_per_device": analysis["bytes"],
        "collective_bytes_per_device": coll,
        "hlo_analysis": {
            "dot_flops": analysis["dot_flops"],
            "elem_flops": analysis["elem_flops"],
            "bytes": analysis["bytes"],
            "coll_bytes": analysis["coll_bytes"],
            "coll_bytes_total": analysis["coll_bytes_total"],
            "wire_bytes_total": analysis["wire_bytes_total"],
            "while_trips": analysis["while_trips"][:16],
        },
        "memory_analysis": {
            "argument_size_in_bytes": int(arg_bytes),
            "output_size_in_bytes": int(_out_bytes(shape, args, out)),
            "temp_size_in_bytes": int(recorder.peak_bytes),
        },
        "n_params": cfg.n_params(),
        "n_active_params": cfg.n_active_params(),
    })
    if verbose:
        print(f"[{arch_id} x {shape_name} x {mesh_name}] OK "
              f"compile={rec['compile_s']}s "
              f"flops/dev={rec['flops_per_device']:.3e} "
              f"coll B/dev={coll['total']:.3e} "
              f"collectives={recorder.n_collectives}", flush=True)
        print("  memory_analysis:", rec["memory_analysis"], flush=True)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        fname = f"{arch_id.replace('.', '_')}__{shape_name}__{mesh_name}.json"
        with open(os.path.join(out_dir, fname), "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="both")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    args = ap.parse_args(argv)

    archs = list(ARCHS) if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    failures = []
    for mp in meshes:            # one fake group per mesh size
        for a in archs:
            for s in shapes:
                try:
                    rec = run_cell(a, s, mp, args.out)
                    if rec["status"] == "SKIP":
                        print(f"[{a} x {s}] SKIP: {rec['reason']}")
                except Exception as e:  # noqa: BLE001 - report and continue
                    failures.append((a, s, mp, repr(e)))
                    print(f"[{a} x {s} x mp={mp}] FAIL: {e}",
                          file=sys.stderr)
    if dist.is_initialized():
        dist.destroy_process_group()
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print(" ", f)
        sys.exit(1)
    print("\nAll dry-run cells passed.")


if __name__ == "__main__":
    main()
