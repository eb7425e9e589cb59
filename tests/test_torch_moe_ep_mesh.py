"""The port's expert-parallel MoE (``repro_torch.layers.moe_ep``) on meshes
against the reference's ``shard_map`` bodies.

The reference runs once, in one subprocess, on a mesh of four forced CPU
devices (``--xla_force_host_platform_device_count=4``): both expert axes,
with non-binding capacity (factor 8) and binding capacity (factor 1, where
the drop order is position-in-shard), on a 2x2 ("data", "model") mesh and
on a (2, 1, 2) ("pod", "data", "model") mesh.  The port runs the same
cases in four spawned processes over gloo (`torch_mesh_worker`); every
rank's output must match within 1e-6, ``aux`` included (the reference
computes it per data shard).  On a 1x1 gloo mesh in this process the port
must equal its meshless body bit for bit and match the reference's own 1x1
test (``tests/test_moe_ep.py``).
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_mesh_worker as worker
from repro.layers.moe import init_moe
from repro.layers.moe import moe_ffn as ref_moe_ffn
from repro.layers.moe_ep import moe_ffn_ep as ref_moe_ffn_ep
from repro_torch.launch import mesh as pmesh
from repro_torch.launch.activations import use_mesh
from repro_torch.layers import moe_ep

REPO = Path(__file__).resolve().parents[1]
TOL = 1e-6
D, F_EVEN, F_ODD, E, B, S = 32, 48, 49, 8, 2, 8

REF_SCRIPT = r"""
import sys
import jax
import numpy as np
from repro.layers.moe_ep import moe_ffn_ep
sys.path.insert(0, sys.argv[3])
from torch_mesh_worker import CASES, TOP_K

assert len(jax.devices()) == 4, jax.devices()
inputs = dict(np.load(sys.argv[1]))
out = {}
for case, shape, axes, mode, cf, key in CASES:
    p = {"router": inputs["router"],
         **{f"w_{part}": inputs[f"{key}_{part}"]
            for part in ("gate", "up", "down")}}
    with jax.make_mesh(shape, axes):
        y, aux = jax.jit(lambda p, x: moe_ffn_ep(
            p, x, top_k=TOP_K, capacity_factor=cf, expert_axis=mode))(
                p, inputs["x"])
    out[case + "_y"] = np.asarray(y)
    out[case + "_aux"] = np.asarray(aux)
    if key == "odd":
        y0, _ = moe_ffn_ep(p, inputs["x"], top_k=TOP_K, capacity_factor=cf)
        out[case + "_meshless_y"] = np.asarray(y0)
np.savez(sys.argv[2], **out)
"""


def _inputs():
    rng = np.random.default_rng(20)
    f32 = lambda *shape, scale: (rng.standard_normal(shape) * scale) \
        .astype(np.float32)
    out = {"router": f32(D, E, scale=1 / np.sqrt(D)),
           "x": f32(B, S, D, scale=1.0)}
    for key, f in (("w", F_EVEN), ("odd", F_ODD)):
        out[f"{key}_gate"] = f32(E, D, f, scale=1 / np.sqrt(D))
        out[f"{key}_up"] = f32(E, D, f, scale=1 / np.sqrt(D))
        out[f"{key}_down"] = f32(E, f, D, scale=1 / np.sqrt(f))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(inputs, the reference's results, each port rank's results): the
    reference subprocess and the four ranks run at the same time."""
    tmp = tmp_path_factory.mktemp("moe_ep_mesh")
    inputs = _inputs()
    in_path = str(tmp / "inputs.npz")
    np.savez(in_path, **inputs)
    ref_path = str(tmp / "reference.npz")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    ref = subprocess.Popen(
        [sys.executable, "-c", REF_SCRIPT, in_path, ref_path,
         str(REPO / "tests")], env=env, cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        ranks = worker.spawn_ranks(tmp, in_path, timeout=180)
        log, _ = ref.communicate(timeout=240)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.communicate()
    assert ref.returncode == 0, log[-3000:]
    return inputs, dict(np.load(ref_path)), ranks


@pytest.mark.parametrize("case", [c[0] for c in worker.CASES
                                  if c[5] == "w"])
def test_every_rank_matches_the_forced_4_device_reference(runs, case):
    _, ref, ranks = runs
    for r, got in enumerate(ranks):
        np.testing.assert_allclose(got[f"{case}_y"], ref[f"{case}_y"],
                                   rtol=0, atol=TOL, err_msg=f"rank {r}")
        np.testing.assert_allclose(got[f"{case}_aux"], ref[f"{case}_aux"],
                                   rtol=0, atol=TOL, err_msg=f"rank {r}")


def test_aux_is_the_reference_per_shard_value_not_the_meshless_one(runs):
    """The load-balance loss is computed per data shard: on the mesh it
    differs from the meshless value, in the port as in the reference."""
    inputs, ref, ranks = runs
    p = worker.moe_params(inputs, "w")
    _, aux0 = moe_ep.moe_ffn_ep(p, torch.from_numpy(inputs["x"]),
                                top_k=worker.TOP_K, capacity_factor=8.0)
    for mode in ("model", "data"):
        got = float(ranks[0][f"2x2-{mode}-cf8_aux"])
        assert abs(got - float(ref[f"2x2-{mode}-cf8_aux"])) <= TOL
        assert abs(got - float(aux0)) > 1e-3


def test_binding_capacity_drops_slots(runs):
    """Factor 1 drops (token, k) slots: the output differs from factor 8's,
    in the port and the reference alike."""
    _, ref, ranks = runs
    for mode in ("model", "data"):
        a, b = ranks[0][f"2x2-{mode}-cf1_y"], ranks[0][f"2x2-{mode}-cf8_y"]
        assert np.abs(a - b).max() > 1e-3
        assert np.abs(ref[f"2x2-{mode}-cf1_y"] - ref[f"2x2-{mode}-cf8_y"]) \
            .max() > 1e-3


def test_collectives_each_mode_calls(runs):
    """Model axis: all_reduce of y and of aux, the gather over data and
    the broadcast of aux; data axis: four all_to_alls, the all_reduce
    after w_down and two pmeans of aux, and the gather."""
    _, _, ranks = runs
    kinds = sorted(moe_ep.collectives)
    want = {"model": {"all_reduce": 2, "all_gather": 1, "broadcast": 1,
                      "all_to_all": 0},
            "data": {"all_reduce": 3, "all_gather": 1, "broadcast": 0,
                     "all_to_all": 4}}
    for r in ranks:
        for mesh in ("2x2", "pod"):
            for mode, counts in want.items():
                got = dict(zip(kinds, r[f"{mesh}-{mode}-cf8_collectives"]))
                assert got == counts, (mesh, mode)


def test_unsplit_ffn_is_not_summed_over_the_model_axis(runs):
    """ROADMAP defect 9: with an FFN width the model axis does not divide,
    the reference still sums the replicated expert outputs over "model"
    (twice the meshless output on 2 columns); the port sums only the
    slices of a split FFN and matches the meshless output."""
    _, ref, ranks = runs
    case = "2x2-data-oddffn"
    y0 = ref[f"{case}_meshless_y"]
    np.testing.assert_allclose(ref[f"{case}_y"], 2 * y0, rtol=1e-5,
                               atol=1e-5)
    for got in ranks:
        np.testing.assert_allclose(got[f"{case}_y"], y0, rtol=0, atol=TOL)


def test_elastic_reshard_on_a_2x2_gloo_mesh(runs):
    """A checkpoint restored on every rank and re-placed on the 2x2 mesh:
    every leaf a DTensor with the spec's placements, its local shard the
    rank's block and ``full_tensor()`` the restored tree; the launcher's
    placement raises NotImplementedError on that mesh."""
    _, _, ranks = runs
    for r in ranks:
        assert r["reshard_ok"].all(), r["reshard_ok"]
        assert "f2" in str(r["place_state_raised"])


@pytest.fixture
def smoke_mesh():
    assert not dist.is_initialized()
    mesh = pmesh.make_smoke_mesh("cpu")
    yield mesh
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def ref_setup():
    """tests/test_moe_ep.py's parameters and input."""
    p = init_moe(32, 48, 8, jnp.float32, jax.random.key(0))
    x = jax.random.normal(jax.random.key(1), (2, 24, 32))
    return p, x


def _port(p):
    from types import SimpleNamespace
    return SimpleNamespace(**{k: torch.from_numpy(np.asarray(v).copy())
                              for k, v in p.items()})


@pytest.mark.parametrize("mode,top_k", [("model", 2), ("data", 1)])
def test_1x1_mesh_equals_meshless_and_the_reference(smoke_mesh, ref_setup,
                                                    mode, top_k):
    p, x = ref_setup
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    with mesh:
        want, want_aux = jax.jit(lambda p, x: ref_moe_ffn_ep(
            p, x, top_k=top_k, capacity_factor=8.0, expert_axis=mode))(p, x)
    ref_einsum, _ = ref_moe_ffn(p, x, top_k=top_k, capacity_factor=8.0)
    tp, tx = _port(p), torch.from_numpy(np.asarray(x).copy())
    y0, aux0 = moe_ep.moe_ffn_ep(tp, tx, top_k=top_k, capacity_factor=8.0,
                                 expert_axis=mode)
    moe_ep.reset_collectives()
    with use_mesh(smoke_mesh):
        y1, aux1 = moe_ep.moe_ffn_ep(tp, tx, top_k=top_k,
                                     capacity_factor=8.0, expert_axis=mode)
    assert moe_ep.collectives["all_reduce"] >= 1
    assert torch.equal(y1, y0) and torch.equal(aux1, aux0)
    np.testing.assert_allclose(y1.numpy(), np.asarray(want), rtol=0,
                               atol=TOL)
    np.testing.assert_allclose(float(aux1), float(want_aux), rtol=0,
                               atol=TOL)
    np.testing.assert_allclose(y1.numpy(), np.asarray(ref_einsum),
                               rtol=2e-5, atol=2e-5)


def test_1x1_mesh_gradients_equal_meshless(smoke_mesh, ref_setup):
    """Autograd through the mesh body's collectives: on one rank the
    gradients equal the meshless body's bit for bit."""
    p, x = ref_setup
    grads = []
    for mesh in (None, smoke_mesh):
        tp = _port(p)
        for t in vars(tp).values():
            t.requires_grad_(True)
        with use_mesh(mesh):
            y, aux = moe_ep.moe_ffn_ep(
                tp, torch.from_numpy(np.asarray(x).copy()), top_k=2,
                capacity_factor=8.0)
        (y.square().sum() + 0.01 * aux).backward()
        grads.append({k: t.grad for k, t in vars(tp).items()})
    for k in grads[0]:
        assert torch.equal(grads[0][k], grads[1][k]), k
