"""The port's activation constraints (``repro_torch.launch.activations``)
against the reference's: `_resolve` on abstract meshes, `constrain` as the
identity without an ambient mesh and for plain tensors under one, a
DTensor redistributed under one, and the layers' constrain calls leaving
their outputs unchanged.

Reference defect 1 (ROADMAP) is not ported: on jax 0.9 the reference's
``constrain`` raises "can only refer to Auto axes" under a
``jax.make_mesh`` mesh (``test_activations_launch.py::test_constrain_*``);
the port's ``constrain`` keeps the documented behaviour, which the tests
below hold.
"""
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.launch import activations as ref_act
from repro.launch import mesh as ref_mesh
from repro_torch.configs import ARCHS, smoke_config
from repro_torch.launch import activations as act
from repro_torch.launch import mesh as pmesh
from repro_torch.models import registry

MESHES = [((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data", "model")),
          ((1, 1), ("data", "model")), ((4,), ("model",)), ((8, 3), ("data", "model"))]
WANTS = [None, "model", "data", "pod", "nonexistent", act.BATCH,
         ("data", "model"), ("nonexistent",), ("pod", "model")]
DIMS = [1, 2, 3, 7, 8, 16, 24, 32, 48, 512, 4096]


@pytest.mark.parametrize("shape,axes", MESHES,
                         ids=["pod", "multipod", "1x1", "model4", "8x3"])
def test_resolve_matches_the_reference(shape, axes):
    rmesh = ref_mesh.make_abstract_mesh(shape, axes)
    mesh = pmesh.make_abstract_mesh(shape, axes)
    for want in WANTS:
        for dim in DIMS:
            assert act._resolve(mesh, dim, want) == \
                ref_act._resolve(rmesh, dim, want), (want, dim)
    assert act.BATCH == ref_act.BATCH and act.MODEL == ref_act.MODEL


def test_constrain_is_the_identity_without_a_mesh():
    x = torch.ones((8, 4))
    assert act.current_mesh() is None
    assert act.constrain(x, act.BATCH, act.MODEL) is x
    assert act.constrain(x) is x


def test_use_mesh_sets_and_restores_the_ambient_mesh():
    mesh = pmesh.make_abstract_mesh((16, 16), ("data", "model"))
    inner = pmesh.make_abstract_mesh((2, 16, 16), ("pod", "data", "model"))
    with act.use_mesh(mesh):
        assert act.current_mesh() is mesh
        with act.use_mesh(inner):
            assert act.current_mesh() is inner
        assert act.current_mesh() is mesh
        # a plain tensor passes through unchanged: no SPMD partitioner
        x = torch.ones((32, 4))
        assert act.constrain(x, act.BATCH, act.MODEL) is x
        # a dim that divides no axis, and axes the mesh lacks
        assert act.constrain(torch.ones((7, 4)), ("nonexistent",),
                             act.MODEL).shape == (7, 4)
    assert act.current_mesh() is None
    with act.use_mesh(pmesh.make_abstract_mesh((), ())):
        assert act.current_mesh() is None


@pytest.fixture
def smoke_mesh():
    assert not dist.is_initialized()
    mesh = pmesh.make_smoke_mesh("cpu")
    yield mesh
    dist.destroy_process_group()


def test_constrain_redistributes_a_dtensor(smoke_mesh):
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    x = torch.arange(32.0).reshape(8, 4)
    d = distribute_tensor(x, smoke_mesh, (Replicate(), Replicate()))
    with act.use_mesh(smoke_mesh):
        out = act.constrain(d, act.BATCH, None)
        assert out.placements == (Shard(0), Replicate())
        out = act.constrain(d, act.BATCH, act.MODEL)
        assert out.placements == (Shard(0), Shard(1))
        assert torch.equal(out.full_tensor(), x)
        assert act.constrain(d, ("nonexistent",)) is d


@pytest.mark.parametrize("arch", ["qwen3-4b", "olmoe-1b-7b",
                                  "falcon-mamba-7b", "zamba2-1.2b"])
def test_layers_are_unchanged_under_a_1x1_mesh(arch, smoke_mesh):
    """Prefill and one decode step with the layers' constrain calls under
    the 1x1 gloo mesh equal the same steps without a mesh bit for bit
    (olmoe's MoE layers take the mesh body)."""
    cfg = smoke_config(ARCHS[arch])
    params = registry.init_params(cfg, torch.Generator().manual_seed(0),
                                  "cpu")
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        3, cfg.vocab - 1, (2, 8)).astype(np.int32))
    runs = []
    for mesh in (None, smoke_mesh):
        with act.use_mesh(mesh):
            lg0, cache = registry.prefill(cfg, params, {"tokens": toks},
                                          cache_dtype=torch.float32, cap=12)
            lg1, _ = registry.decode_step(cfg, params, cache,
                                          lg0[:, -1:].argmax(-1).int(), 8)
        runs.append((lg0, lg1))
    for a, b in zip(*runs):
        assert torch.equal(a, b)
