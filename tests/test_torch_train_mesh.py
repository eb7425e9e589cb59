"""The launcher on the 1x1 mesh (``repro_torch.launch.train``) and
``checkpointing.elastic_reshard`` on it, on the CPU over a one-rank gloo
group: the rule engine's specs validate, the placed state equals the state
it came from, the steps under the mesh give the meshless losses, and the
updated parameters and moments, bit for bit; the kernel wrappers refuse
DTensor operands.
"""
from collections import OrderedDict
from dataclasses import replace

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.checkpointing import elastic_reshard, store
from repro_torch.configs import ARCHS, smoke_config
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import memcrypt as mc
from repro_torch.launch import mesh as pmesh
from repro_torch.launch import sharding as sh
from repro_torch.launch import train
from repro_torch.launch.activations import use_mesh
from repro_torch.launch.steps import build_train_step
from repro_torch.layers import moe_ep

STEPS = 2


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the smoke models' ops are small, and on a
    loaded machine (the tests run in several workers) a thread pool's
    barriers cost more than the ops."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def smoke_mesh():
    assert not dist.is_initialized()
    mesh = pmesh.make_smoke_mesh("cpu")
    yield mesh
    dist.destroy_process_group()


def _run(cfg, mesh):
    """STEPS launcher steps from seed 0, on ``mesh`` (placed through the
    rule engine) or without one; (losses, parameters, AdamW state)."""
    model, opt = train.init_model(cfg, "cpu", 0)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=16,
                                  global_batch=4))
    step_fn = build_train_step(cfg, peak_lr=1e-3, warmup=1, total_steps=10)
    if mesh is not None:
        pspecs, ospecs = train.mesh_specs(cfg, mesh, model, opt)
        opt = train.place_state(model, opt, mesh, pspecs, ospecs)
    with use_mesh(mesh):
        run = train.train_loop(cfg, model, opt, data, step_fn,
                               range(STEPS), device="cpu",
                               log=lambda m: None)
    return run["losses"], OrderedDict(model.named_parameters()), run["opt"]


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "olmoe-1b-7b"])
def test_launcher_on_the_1x1_mesh_equals_the_meshless_run(arch,
                                                          smoke_mesh):
    # two microbatches a step (olmoe's own 4 would double the test's time)
    cfg = replace(smoke_config(ARCHS[arch]), grad_accum=2)
    losses0, params0, opt0 = _run(cfg, None)
    moe_ep.reset_collectives()
    losses1, params1, opt1 = _run(cfg, smoke_mesh)
    assert losses1 == losses0
    assert all(np.isfinite(losses1))
    for name, p in params0.items():
        assert type(params1[name]) is torch.nn.Parameter
        assert torch.equal(params1[name], p), name
        assert torch.equal(opt1.mu[name], opt0.mu[name]), name
        assert torch.equal(opt1.nu[name], opt0.nu[name]), name
    assert int(opt1.step) == int(opt0.step) == STEPS
    if cfg.family == "moe":
        # every MoE layer's model-axis body reduced y and aux in each
        # microbatch's forward
        assert moe_ep.collectives["all_reduce"] == \
            2 * cfg.n_layers * STEPS * cfg.grad_accum


def test_mesh_specs_validate_and_place_state_keeps_every_bit(smoke_mesh):
    cfg = smoke_config(ARCHS["qwen1.5-0.5b"])
    model, opt = train.init_model(cfg, "cpu", 3)
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    pspecs, ospecs = train.mesh_specs(cfg, smoke_mesh, model, opt)
    assert list(pspecs) == list(before)
    assert pspecs["tok"] == sh.P("model", None)
    assert ospecs.step == sh.P() and ospecs.mu is pspecs
    placed = train.place_state(model, opt, smoke_mesh, pspecs, ospecs)
    for k, p in model.named_parameters():
        assert torch.equal(p, before[k]) and p.requires_grad
        assert type(p.data) is torch.Tensor
    assert type(placed.step) is torch.Tensor
    assert all(torch.equal(placed.mu[k], opt.mu[k]) for k in opt.mu)
    with pytest.raises(NotImplementedError, match="f2"):
        train.place_state(model, opt, pmesh.make_abstract_mesh(
            (2, 2), ("data", "model")), pspecs, ospecs)


def test_elastic_reshard_on_the_1x1_mesh(smoke_mesh, tmp_path):
    """A checkpoint restored and re-placed on the 1x1 mesh: every leaf a
    DTensor whose ``full_tensor()`` and local tensor equal the restored
    leaf."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    cfg = smoke_config(ARCHS["olmoe-1b-7b"])
    model, opt = train.init_model(cfg, "cpu", 1)
    store.save(str(tmp_path), 2, train.train_state(model, opt))
    like = train.train_state(*train.init_model(cfg, "cpu", 2))
    restored, step = store.restore(str(tmp_path), like)
    pspecs, ospecs = train.mesh_specs(cfg, smoke_mesh, model, opt)
    placed = elastic_reshard(restored, (sh.named(smoke_mesh, pspecs),
                                        sh.named(smoke_mesh, ospecs)))
    flat_r, flat_p = store._flatten(restored), store._flatten(placed)
    assert step == 2 and len(flat_r) == len(flat_p) > 0
    for (path, want), (_, got) in zip(flat_r, flat_p):
        assert isinstance(got, DTensor), path
        assert torch.equal(got.full_tensor(), want), path
        assert torch.equal(got.to_local(), want), path
    w = placed[0]["layers.0.moe.w_gate"]
    assert w.placements == (Replicate(), Shard(0))      # experts on model
    with pytest.raises(ValueError, match="leaves"):
        elastic_reshard(restored, sh.named(smoke_mesh, pspecs))


def test_kernel_wrappers_refuse_dtensor_operands(smoke_mesh):
    from torch.distributed.tensor import Replicate, distribute_tensor
    rep = (Replicate(), Replicate())
    q = distribute_tensor(torch.randn(1, 2, 4, 32), smoke_mesh, rep)
    with pytest.raises(TypeError, match="DTensor"):
        fa.flash_attention(q, q, q)
    words = distribute_tensor(torch.arange(8, dtype=torch.int32),
                              smoke_mesh, rep)
    with pytest.raises(TypeError, match="DTensor"):
        mc.memcrypt(words, key0=1, key1=2)
    assert torch.equal(mc.memcrypt(words.to_local(), key0=1, key1=2),
                       mc.memcrypt(torch.arange(8, dtype=torch.int32),
                                   key0=1, key1=2))


def test_launcher_cli_runs_on_the_mesh_and_destroys_its_group(capsys):
    assert not dist.is_initialized()
    train.main(["--device", "cpu", "--preset", "smoke", "--steps", "2",
                "--batch", "2", "--seq", "16", "--log-every", "1"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].endswith("devices=1 (cpu)")
    assert out[-1].startswith("done: 2 steps in ")
    assert not dist.is_initialized()
