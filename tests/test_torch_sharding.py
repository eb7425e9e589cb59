"""Parity of the port's rule engine (``repro_torch.launch.sharding``) with
the reference's, on the production meshes as abstract meshes, plus the
placements `named` gives on a 1x1 gloo mesh.

The port's parameters and caches are per layer where the reference stacks
them: the port spec of a leaf must equal the reference spec of the leaf it
came from with the leading stacked dims dropped (the dims the layer index
selects).
"""
import functools
import re

import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as JP

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import SHAPES as REF_SHAPES
from repro.launch import mesh as ref_mesh
from repro.launch import sharding as ref_sh
from repro.models import registry as ref_registry
from repro_torch.configs import ARCHS, SHAPES
from repro_torch.convert import reference_path
from repro_torch.kernels.permcheck import ENTRY_TILE
from repro_torch.launch import mesh as pmesh
from repro_torch.launch import sharding as sh
from repro_torch.models import registry

import jax

MESHES = {"pod": ((16, 16), ("data", "model")),
          "multipod": ((2, 16, 16), ("pod", "data", "model"))}
ARCH_IDS = list(ARCHS)


def meshes(kind):
    shape, axes = MESHES[kind]
    return (ref_mesh.make_abstract_mesh(shape, axes),
            pmesh.make_abstract_mesh(shape, axes))


@functools.lru_cache(maxsize=None)
def ref_param_shapes(arch):
    return ref_registry.param_shapes(REF_ARCHS[arch])


@functools.lru_cache(maxsize=None)
def port_param_shapes(arch):
    return registry.param_shapes(ARCHS[arch])


def _lookup(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def _keystr(path) -> str:
    return "".join(f"[{k!r}]" for k in path)


@pytest.mark.parametrize("kind", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_equal_the_reference_without_stacked_dims(arch, kind):
    """Every port parameter's spec is the reference's spec of its stacked
    leaf with the stacked dims dropped, every reference leaf is some port
    parameter's, and every assignment divides."""
    rmesh, mesh = meshes(kind)
    cfg = ARCHS[arch]
    ref_shapes = ref_param_shapes(arch)
    ref_eng = ref_sh.RuleEngine(REF_ARCHS[arch], rmesh)
    model = port_param_shapes(arch)
    specs = sh.param_spec_tree(cfg, mesh, model)
    assert list(specs) == [n for n, _ in model.named_parameters()]
    seen = set()
    for name, p in model.named_parameters():
        path, index = reference_path(name)
        key = _keystr(path)
        assert sh.key_string(name) == key
        leaf = _lookup(ref_shapes, path)
        stacked = len(index)
        assert tuple(leaf.shape[stacked:]) == tuple(p.shape), name
        ref_spec = tuple(ref_eng.param_spec(key, tuple(leaf.shape)))
        assert tuple(specs[name]) == ref_spec[stacked:], (name, ref_spec)
        seen.add(key)
    flat = jax.tree_util.tree_flatten_with_path(ref_shapes)[0]
    assert seen == {jax.tree_util.keystr(kp) for kp, _ in flat}
    assert sh.validate_specs(model, specs, mesh) == []


def _port_batch(batch: dict) -> dict:
    return {k: torch.empty(v.shape, device="meta") for k, v in batch.items()
            if k != "cache"}


@pytest.mark.parametrize("kind", list(MESHES))
@pytest.mark.parametrize("shape_name", list(SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_and_cache_specs_equal_the_reference(arch, shape_name, kind):
    """For every supported (arch, shape): the batch specs equal the
    reference's; a decode shape's per-layer cache specs equal the
    reference's stacked ones without the stacked dims; every assignment
    divides."""
    rcfg, cfg = REF_ARCHS[arch], ARCHS[arch]
    shape = REF_SHAPES[shape_name]
    ok, _ = ref_registry.supports_shape(rcfg, shape)
    if not ok:
        pytest.skip("shape unsupported for this arch")
    rmesh, mesh = meshes(kind)
    ref_batch = ref_registry.input_specs(rcfg, shape)
    batch = _port_batch(ref_batch)
    if shape.kind == "decode":
        ref_bspecs = ref_sh.batch_spec_tree(rcfg, rmesh,
                                            {"tokens": ref_batch["tokens"]})
        bspecs = sh.batch_spec_tree(cfg, mesh, {"tokens": batch["tokens"]})
        cache = registry.cache_shapes(cfg, SHAPES[shape_name].global_batch,
                                      SHAPES[shape_name].seq_len)
        cspecs = sh.cache_spec_tree(cfg, mesh, cache)
        ref_cspecs = ref_sh.cache_spec_tree(rcfg, rmesh, ref_batch["cache"])
        ref_by_path = {
            jax.tree_util.keystr(kp): tuple(s) for kp, s in
            jax.tree_util.tree_flatten_with_path(
                ref_cspecs, is_leaf=lambda x: isinstance(x, JP))[0]}
        port = sh._flatten(cspecs)
        assert port
        for path, spec in port:
            ref_path = re.sub(r"\[\d+\]", "", path)
            stacked = len(re.findall(r"\[\d+\]", path))
            assert tuple(spec) == ref_by_path[ref_path][stacked:], path
        assert sh.validate_specs(cache, cspecs, mesh) == []
        assert sh.validate_specs({"tokens": batch["tokens"]}, bspecs,
                                 mesh) == []
    else:
        ref_bspecs = ref_sh.batch_spec_tree(rcfg, rmesh, ref_batch)
        bspecs = sh.batch_spec_tree(cfg, mesh, batch)
        assert sh.validate_specs(batch, bspecs, mesh) == []
    assert {k: tuple(v) for k, v in bspecs.items()} == \
        {k: tuple(v) for k, v in ref_bspecs.items()}


def test_rule_engine_examples_match_the_reference_tests():
    """The reference's hand-written rule examples (tests/test_sharding.py)
    on the stacked shapes the engine reads, and per layer through the tree
    functions."""
    pod = pmesh.make_abstract_mesh(*MESHES["pod"])
    multipod = pmesh.make_abstract_mesh(*MESHES["multipod"])
    eng = sh.RuleEngine(ARCHS["qwen3-4b"], pod)
    spec = eng.param_spec(sh.key_string("layers.0.mlp.w_gate"),
                          (36, 2560, 9728))
    assert spec == sh.P(None, "data", "model")      # FSDP + TP
    eng_g = sh.RuleEngine(ARCHS["gemma3-1b"], pod)
    assert eng_g.param_spec("['units']['attn']['wq']",
                            (26, 1152, 4, 288))[-2] is None
    assert eng.kv_cache_spec((36, 128, 8, 32768, 128)) == \
        sh.P(None, "data", None, "model", None)     # 8 kv heads on 16
    eng_m = sh.RuleEngine(ARCHS["olmoe-1b-7b"], pod)
    assert eng_m.param_spec(sh.key_string("layers.0.moe.w_gate"),
                            (16, 64, 2048, 1024))[1] == "model"
    # per layer: the stacked dims dropped
    specs = sh.param_spec_tree(ARCHS["qwen3-4b"], pod,
                               port_param_shapes("qwen3-4b"))
    assert specs["layers.0.mlp.w_gate"] == sh.P("data", "model")
    cache = registry.cache_shapes(ARCHS["glm4-9b"], 128, 32768)
    assert sh.cache_spec_tree(ARCHS["glm4-9b"], pod, cache)[0].k == \
        sh.P("data", None, "model", None)           # 2 kv heads on 16
    eng_q = sh.RuleEngine(ARCHS["qwen1.5-0.5b"], multipod)
    assert eng_q.batch_spec("tokens", (256, 4096))[0] == ("pod", "data")
    assert eng_q.batch_spec("pos", ()) == sh.P()


def test_permtable_shard_plumbing():
    """As tests/test_egress.py holds the reference's."""
    mesh = pmesh.make_abstract_mesh((16, 16), ("data", "model"))
    per = sh.permtable_shard_entries(mesh, 1 << 20)   # 1M entries / 16 ways
    assert per == 65536 and per % ENTRY_TILE == 0
    with pytest.raises(ValueError):
        sh.permtable_shard_entries(mesh, 1 << 21)     # 128K/shard > ceiling
    specs = sh.permtable_specs(mesh)
    assert specs["starts"] == sh.P("model")
    assert specs["perms"] == sh.P("model", None)
    assert specs["tile_min"] == sh.P("model")
    rmesh = ref_mesh.make_abstract_mesh((16, 16), ("data", "model"))
    for total in (1, 1000, 1 << 14, 1 << 20):
        assert sh.permtable_shard_entries(mesh, total) == \
            ref_sh.permtable_shard_entries(rmesh, total)
    assert {k: tuple(v) for k, v in specs.items()} == \
        {k: tuple(v) for k, v in ref_sh.permtable_specs(rmesh).items()}
    one_axis = pmesh.make_abstract_mesh((4,), ("data",))
    assert sh.permtable_specs(one_axis)["starts"] == sh.P(None)


@pytest.fixture
def smoke_mesh():
    """The 1x1 mesh on the CPU (a one-rank gloo group, destroyed after)."""
    assert not dist.is_initialized()
    mesh = pmesh.make_smoke_mesh("cpu")
    yield mesh
    dist.destroy_process_group()


def test_named_placements_on_a_1x1_gloo_mesh(smoke_mesh):
    from torch.distributed.tensor import Replicate, Shard
    mesh = smoke_mesh
    assert pmesh.mesh_shape(mesh) == {"data": 1, "model": 1}
    assert pmesh.data_axes(mesh) == ("data",)
    tree = {"a": sh.P(None), "b": {"c": sh.P("data", None)},
            "d": sh.P(None, "model"), "e": sh.P(("data", "model"))}
    named = sh.named(mesh, tree)
    assert isinstance(named["b"]["c"], sh.NamedSharding)
    assert named["a"].placements == (Replicate(), Replicate())
    assert named["b"]["c"].placements == (Shard(0), Replicate())
    assert named["d"].placements == (Replicate(), Shard(1))
    assert named["e"].placements == (Shard(0), Shard(0))
    assert all(s.mesh is mesh for s in (named["a"], named["d"]))
    with pytest.raises(ValueError, match="order"):
        sh.named(mesh, sh.P(("model", "data")))
    with pytest.raises(ValueError, match="lacks"):
        sh.named(mesh, sh.P("pod"))
    # the launcher's specs on the mesh: every placement a Shard or Replicate
    cfg = ARCHS["qwen1.5-0.5b"]
    specs = sh.param_spec_tree(cfg, mesh, port_param_shapes("qwen1.5-0.5b"))
    placed = sh.named(mesh, specs)
    assert placed["tok"].placements == (Replicate(), Shard(0))
    assert sh.validate_specs(port_param_shapes("qwen1.5-0.5b"), specs,
                             mesh) == []


def test_meshes_raise_without_their_process_group(monkeypatch):
    """The production meshes need 256/512 ranks; the smoke mesh makes no
    CPU group when the card is asked for and there is none."""
    assert not dist.is_initialized()
    for multi_pod, n in ((False, 256), (True, 512)):
        with pytest.raises(ValueError, match=f"{n} ranks"):
            pmesh.make_production_mesh(multi_pod=multi_pod, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        pmesh.make_smoke_mesh()
    assert not dist.is_initialized()
    assert pmesh.data_axes(pmesh.make_abstract_mesh(*MESHES["multipod"])) \
        == ("pod", "data")
