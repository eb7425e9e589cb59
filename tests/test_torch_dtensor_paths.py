"""The model code's DTensor branches (what the dry run traces) compute the
same function as the plain path, and the plain path is unchanged.

On the 1x1 ("data", "model") mesh in a one-rank gloo group every shard
is the whole tensor, so each family's prefill, decode step, loss and
gradients with DTensor parameters, batch and caches — through the
per-shard attention, the sharded SwiGLU and out projection, the
vocab-parallel embedding and loss, the per-shard Mamba scans, the MoE
bodies under ``local_map`` and the caches the rules lay out — must equal
the plain run's.  The plain path's own changes (the Mamba steps made
module functions, the static-shape expert count) are held bit for bit
against the code they replaced."""
import copy
import dataclasses

import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import ARCHS, smoke_config
from repro_torch.kernels import is_dtensor
from repro_torch.launch import sharding as sh
from repro_torch.launch.activations import use_mesh
from repro_torch.launch.mesh import make_smoke_mesh
from repro_torch.launch.steps import build_train_step
from repro_torch.models import registry
from repro_torch.optim import init_state

FAMILIES = ["qwen1.5-0.5b", "gemma3-1b", "olmoe-1b-7b", "falcon-mamba-7b",
            "zamba2-1.2b", "seamless-m4t-medium", "qwen2-vl-7b"]
# one arch per distinct training path: dense, MoE, Mamba, vlm (M-RoPE,
# the vision splice, sequence-parallel attention)
TRAINED = ["qwen1.5-0.5b", "olmoe-1b-7b", "falcon-mamba-7b", "qwen2-vl-7b"]
TOL = dict(rtol=1e-5, atol=1e-5)


def _config(arch: str, layers: int):
    """The smoke config cut to ``layers`` layers (zamba2: one group)."""
    return dataclasses.replace(smoke_config(ARCHS[arch]), n_layers=layers)


@pytest.fixture(scope="module")
def mesh():
    assert not dist.is_initialized()
    m = make_smoke_mesh("cpu")
    yield m
    dist.destroy_process_group()


def _dtensor(mesh, t, spec):
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(t.detach().clone(), mesh,
                              sh.spec_placements(mesh, spec),
                              run_check=False)


def _placed(cfg, mesh, model):
    """A copy of ``model`` with every parameter a DTensor of its values,
    placed by the rule engine."""
    placed = copy.deepcopy(model)
    specs = sh.param_spec_tree(cfg, mesh, placed)
    for name, p in list(placed.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        mod = placed.get_submodule(owner) if owner else placed
        mod._parameters[leaf] = torch.nn.Parameter(
            _dtensor(mesh, p, specs[name]), requires_grad=False)
    return placed


def _batch(cfg, b: int, s: int, train: bool):
    g = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab, (b, s), generator=g,
                                     dtype=torch.int32)}
    if train:
        batch["labels"] = torch.randint(0, cfg.vocab, (b, s), generator=g,
                                        dtype=torch.int32)
    if cfg.family == "vlm":
        batch["vision_embeds"] = torch.randn(b, cfg.n_patches, cfg.d_model,
                                             generator=g)
        if train:
            batch["positions"] = torch.arange(s, dtype=torch.int32)[
                None, None].expand(3, b, s).contiguous()
    if cfg.family == "encdec":
        batch["frames"] = torch.randn(b, s // cfg.frames_ratio, cfg.d_model,
                                      generator=g)
    return batch


def _full(x):
    return x.full_tensor() if is_dtensor(x) else x


def _leaves(tree):
    from torch.utils._pytree import tree_leaves
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


@pytest.mark.parametrize("arch", FAMILIES)
def test_dtensor_serving_equals_the_plain_run(mesh, arch):
    from torch.distributed.tensor.experimental import implicit_replication
    cfg = _config(arch, 2)
    model = registry.init_params(cfg, torch.Generator().manual_seed(0),
                                 "cpu")
    b, s = 2, 16
    batch = _batch(cfg, b, s, train=False)
    logits, cache = registry.prefill(cfg, model, batch, cap=s + 1,
                                     cache_dtype=torch.float32)
    step, _ = registry.decode_step(cfg, model, cache, batch["tokens"][:, :1],
                                   s)
    placed = _placed(cfg, mesh, model)
    specs = sh.batch_spec_tree(cfg, mesh, batch)
    dbatch = {k: _dtensor(mesh, v, specs[k]) for k, v in batch.items()}
    with use_mesh(mesh), implicit_replication(), torch.no_grad():
        dlogits, dcache = registry.prefill(cfg, placed, dbatch, cap=s + 1,
                                           cache_dtype=torch.float32)
        assert all(is_dtensor(t) for t in _leaves(dcache))
        dstep, _ = registry.decode_step(cfg, placed, dcache,
                                        dbatch["tokens"][:, :1], s)
    torch.testing.assert_close(_full(dlogits), logits, **TOL)
    for got, want in zip(_leaves(dcache), _leaves(cache)):
        torch.testing.assert_close(_full(got), want, **TOL)
    torch.testing.assert_close(_full(dstep), step, **TOL)


@pytest.mark.parametrize("arch", TRAINED)
def test_dtensor_train_step_equals_the_plain_run(mesh, arch):
    from torch.distributed.tensor.experimental import implicit_replication
    cfg = _config(arch, 1)
    model = registry.init_params(cfg, torch.Generator().manual_seed(0),
                                 "cpu")
    placed = _placed(cfg, mesh, model)
    batch = _batch(cfg, 4, 16 if cfg.family == "vlm" else 8, train=True)
    step = build_train_step(cfg, grad_accum=2)
    opt, metrics = step(model, init_state(model), batch)
    specs = sh.batch_spec_tree(cfg, mesh, batch)
    dbatch = {k: _dtensor(mesh, v, specs[k]) for k, v in batch.items()}
    pspecs = sh.param_spec_tree(cfg, mesh, placed)
    dopt = init_state(model)
    dopt = type(dopt)(
        _dtensor(mesh, dopt.step, sh.P()),
        {k: _dtensor(mesh, v, pspecs[k]) for k, v in dopt.mu.items()},
        {k: _dtensor(mesh, v, pspecs[k]) for k, v in dopt.nu.items()})
    with use_mesh(mesh), implicit_replication():
        dopt, dmetrics = step(placed, dopt, dbatch)
    torch.testing.assert_close(_full(dmetrics["loss"]), metrics["loss"],
                               **TOL)
    for (name, p), (_, q) in zip(model.named_parameters(),
                                 placed.named_parameters()):
        torch.testing.assert_close(_full(q.detach()), p.detach(), **TOL,
                                   msg=name)
    for k in opt.mu:
        torch.testing.assert_close(_full(dopt.mu[k]), opt.mu[k], **TOL)


def test_mamba_steps_are_the_loops_they_replaced():
    """The Mamba scan bodies, now module functions, run the loops the
    closures ran, bit for bit."""
    from repro_torch.layers import mamba as M
    g = torch.Generator().manual_seed(5)
    b, t, di, n = 2, 5, 8, 4
    a = -torch.rand(di, n, generator=g)
    h = torch.zeros(b, di, n)
    dt, xi = torch.rand(b, t, di, generator=g), torch.randn(b, t, di,
                                                            generator=g)
    bm, cm = torch.randn(b, t, n, generator=g), torch.randn(b, t, n,
                                                            generator=g)

    def step(h, dt_t, xi_t, b_t, c_t):          # the closure, as it was
        da_t = torch.exp(dt_t[..., None] * a)
        dbx_t = (dt_t * xi_t)[..., None] * b_t[:, None, :]
        h = da_t * h + dbx_t
        return h, torch.einsum("bdn,bn->bd", h, c_t)

    want = M._ssm_scan(h, step, dt, xi, bm, cm)
    got = M._ssm_scan(h, M._mamba1_step(a), dt, xi, bm, cm)
    assert all(torch.equal(x, y) for x, y in zip(got, want))


def test_expert_count_is_bincount():
    from repro_torch.layers.moe import load_balance_loss
    g = torch.Generator().manual_seed(2)
    e = 8
    probs = torch.softmax(torch.randn(64, e, generator=g), -1)
    idx = torch.randint(0, e, (64, 2), generator=g)
    t, k = idx.shape
    frac_tok = torch.bincount(idx.reshape(-1), minlength=e) \
        .to(torch.float32) / (t * k)
    want = e * torch.sum(frac_tok * probs.mean(dim=0).to(torch.float32))
    assert torch.equal(load_balance_loss(probs, idx, e), want)
