"""Training launcher: data pipeline -> train_step -> checkpointed loop
(the port of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \\
        --preset full --steps 50 --batch 8 --seq 256

Presets:
  smoke  — reduced same-family config (CPU-friendly)
  100m   — ~100M-param dense config
  full   — the assigned config (bf16 parameters, remat full)

The port trains on ONE device, the card unless ``--device`` names another
(``--device cpu`` runs the plain PyTorch versions), on the reference's 1x1
smoke mesh (``launch/mesh.make_smoke_mesh``: a one-rank process group,
NCCL on the card, gloo on the CPU): the rule engine gives every parameter
and AdamW moment its partition spec, `place_state` re-places the state
onto those shardings, and the steps run under the mesh.  A larger mesh
raises ``NotImplementedError``: the reference shards a whole model only in
its dry run, which `launch.dryrun` ports.  Fault tolerance: asynchronous checkpoints every ``--ckpt-every`` steps and
restore-from-LATEST on restart (``--resume``).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from collections import OrderedDict

import numpy as np
import torch
import torch.distributed as dist

from ..checkpointing import store
from ..configs import ARCHS, smoke_config
from ..configs.base import ArchConfig
from ..data.pipeline import DataConfig, SyntheticLM
from ..kernels import resolve_device
from ..models import registry
from ..optim import AdamWState, init_state
from . import sharding as sh
from .activations import use_mesh
from .mesh import make_smoke_mesh, mesh_devices
from .steps import build_train_step


def preset_config(arch_id: str, preset: str) -> ArchConfig:
    cfg = ARCHS[arch_id]
    if preset == "full":
        return cfg
    if preset == "smoke":
        return smoke_config(cfg)
    if preset == "100m":
        # ~100M params: emb 2*50304*640=64M + 10 layers x ~3.6M
        return dataclasses.replace(
            smoke_config(cfg), n_layers=10, d_model=640, n_heads=10,
            n_kv_heads=min(cfg.n_kv_heads, 10) if cfg.n_kv_heads > 1 else 1,
            d_ff=2048, vocab=50304, head_dim=64, remat="none",
            param_dtype="float32")
    raise ValueError(preset)


def init_model(cfg: ArchConfig, device, seed: int = 0):
    """(model with trainable parameters drawn from ``seed``, zeroed AdamW
    state in ``cfg.moment_dtype``) on ``device``."""
    gen = torch.Generator(device).manual_seed(seed)
    model = registry.init_params(cfg, gen, device)
    model.requires_grad_(True)
    return model, init_state(model,
                             moment_dtype=getattr(torch, cfg.moment_dtype))


def train_state(model, opt: AdamWState) -> tuple:
    """What a checkpoint holds: (the parameters by name, in the model's
    order, the optimizer state)."""
    return OrderedDict(model.named_parameters()), opt


def restore_state(ckpt_dir: str, model, opt: AdamWState,
                  step: int | None = None) -> tuple[AdamWState, int]:
    """Load a checkpoint (default: LATEST) into ``model``'s parameters, in
    place, and return (the restored optimizer state, its step)."""
    (params, opt), at = store.restore(ckpt_dir, train_state(model, opt),
                                      step)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(params[name])
    return opt, at


def mesh_specs(cfg: ArchConfig, mesh, model, opt: AdamWState) -> tuple:
    """(parameter specs, AdamW state specs) from the rule engine; raises
    unless every assignment divides its dimension (`validate_specs`)."""
    pspecs = sh.param_spec_tree(cfg, mesh, model)
    ospecs = AdamWState(step=sh.P(), mu=pspecs, nu=pspecs)
    errs = sh.validate_specs(model, pspecs, mesh) + \
        sh.validate_specs(opt, ospecs, mesh)
    if errs:
        raise ValueError(f"{len(errs)} specs do not divide: {errs[:5]}")
    return pspecs, ospecs


def place_state(model, opt: AdamWState, mesh, pspecs,
                ospecs) -> AdamWState:
    """Re-place the parameters and the AdamW state onto the mesh through
    the specs' `sharding.named` shardings (``store.elastic_reshard``).  On
    the 1x1 mesh each DTensor's local tensor is the whole tensor: the model
    keeps it as its parameter's data, and the state returned holds them,
    so the steps and the kernels see plain tensors."""
    n = mesh_devices(mesh)
    if n != 1:
        raise NotImplementedError(
            f"the launcher trains on the 1x1 smoke mesh; a {n}-device mesh "
            "shards the whole model, which the reference does only in its "
            "dry run; the port's, launch/dryrun.py (ROADMAP item f2), "
            "places its own state on a fake process group")
    params = OrderedDict((k, p.detach())
                         for k, p in model.named_parameters())
    params, opt = store.elastic_reshard(
        (params, opt), (sh.named(mesh, pspecs), sh.named(mesh, ospecs)))
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.data = params[name].to_local()
    local = lambda tree: OrderedDict((k, v.to_local())
                                     for k, v in tree.items())
    return AdamWState(opt.step.to_local(), local(opt.mu), local(opt.nu))


def make_batch(cfg: ArchConfig, data: SyntheticLM, step: int,
               device) -> dict:
    """The pipeline's batch for ``step`` on ``device``, plus the zero
    ``vision_embeds`` and M-RoPE ``positions`` (vlm) or zero ``frames``
    (encdec) the reference's launcher feeds."""
    batch = {k: torch.from_numpy(v).to(device)
             for k, v in data.batch(step).items()}
    b, s = batch["tokens"].shape
    if cfg.family == "vlm":
        batch["vision_embeds"] = torch.zeros(
            (b, cfg.n_patches, cfg.d_model), dtype=torch.float32,
            device=device)
        batch["positions"] = torch.arange(
            s, dtype=torch.int32, device=device)[None, None].expand(3, b, s)
    if cfg.family == "encdec":
        batch["frames"] = torch.zeros(
            (b, s // cfg.frames_ratio, cfg.d_model), dtype=torch.float32,
            device=device)
    return batch


def train_loop(cfg: ArchConfig, model, opt: AdamWState, data: SyntheticLM,
               step_fn, steps: range, *, device, ckpt_dir: str | None = None,
               ckpt_every: int = 50, log_every: int = 10,
               log_file: str | None = None, last_step: int | None = None,
               log=print) -> dict:
    """Run ``step_fn`` over ``steps`` with the launcher's log lines and
    asynchronous checkpoints after every ``ckpt_every``-th step (joined
    before returning).  Returns {"opt", "losses", "step_s", "metrics"}
    (the last step's metrics)."""
    last_step = steps[-1] if last_step is None else last_step
    losses, step_s = [], []
    pending = None
    metrics = {}
    for step in steps:
        batch = make_batch(cfg, data, step, device)
        t0 = time.perf_counter()
        opt, metrics = step_fn(model, opt, batch)
        loss = float(metrics["loss"])
        dt = time.perf_counter() - t0
        losses.append(loss)
        step_s.append(dt)
        if step % log_every == 0 or step == last_step:
            tok_s = batch["tokens"].numel() / dt
            msg = (f"step {step:5d} loss {loss:.4f} "
                   f"gnorm {float(metrics['grad_norm']):.3f} "
                   f"lr {float(metrics['lr']):.2e} "
                   f"{dt:.2f}s/step {tok_s:,.0f} tok/s")
            log(msg)
            if log_file:
                with open(log_file, "a") as f:
                    f.write(msg + "\n")
        if ckpt_dir and (step + 1) % ckpt_every == 0:
            if pending is not None:
                pending.join()
            pending = store.save(ckpt_dir, step + 1, train_state(model, opt),
                                 blocking=False)
    if pending is not None:
        pending.join()
    return {"opt": opt, "losses": losses, "step_s": step_s,
            "metrics": metrics}


def done_line(losses: list[float], wall: float) -> str:
    first = float(np.mean(losses[:5]))
    last = float(np.mean(losses[-5:]))
    return (f"done: {len(losses)} steps in {wall:.0f}s  "
            f"loss {first:.4f} -> {last:.4f} "
            f"({'DECREASED' if last < first else 'check convergence'})")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b", choices=list(ARCHS))
    ap.add_argument("--preset", default="smoke",
                    choices=["smoke", "100m", "full"])
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--log-file", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = preset_config(args.arch, args.preset)
    own_group = not dist.is_initialized()
    mesh = make_smoke_mesh(dev)
    print(f"arch={args.arch} preset={args.preset} "
          f"params={cfg.n_params()/1e6:.1f}M "
          f"devices={mesh_devices(mesh)} ({dev})", flush=True)

    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                  global_batch=args.batch))
    model, opt = init_model(cfg, dev)

    start_step = 0
    if args.resume and args.ckpt_dir and store.latest_step(args.ckpt_dir):
        opt, start_step = restore_state(args.ckpt_dir, model, opt)
        print(f"resumed from step {start_step}", flush=True)

    pspecs, ospecs = mesh_specs(cfg, mesh, model, opt)
    opt = place_state(model, opt, mesh, pspecs, ospecs)
    step_fn = build_train_step(cfg, peak_lr=args.lr, warmup=args.warmup,
                               total_steps=max(args.steps, 100))
    t_start = time.time()
    with use_mesh(mesh):
        run = train_loop(cfg, model, opt, data, step_fn,
                         range(start_step, args.steps), device=dev,
                         ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                         log_every=args.log_every, log_file=args.log_file,
                         last_step=args.steps - 1,
                         log=lambda m: print(m, flush=True))
    losses = run["losses"]
    wall = time.time() - t_start
    print(done_line(losses, wall), flush=True)
    if args.log_file:
        with open(args.log_file + ".json", "w") as f:
            json.dump({"arch": args.arch, "preset": args.preset,
                       "steps": len(losses), "wall_s": wall,
                       "loss_first5": float(np.mean(losses[:5])),
                       "loss_last5": float(np.mean(losses[-5:])),
                       "losses": losses}, f)
    if own_group:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
