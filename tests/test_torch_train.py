"""Port parity: the training slice against the JAX package at smoke widths.

* every family's loss (`registry.loss_fn`) and every gradient leaf against
  ``jax.value_and_grad`` of the reference's ``loss_fn`` on the same
  parameters (`convert.params_from_numpy` in, `convert.params_to_numpy`
  out) and the same numpy batch: loss within 2e-5, each gradient leaf
  within 1e-4 of its largest entry (f32; the summation orders differ);
* `train_step` over 3 steps against the reference's jitted step, with
  ``grad_accum`` 1 and 2 (M-RoPE positions split on dim 1): metrics at
  2e-5, moments at 1e-4 of each leaf's largest entry, each parameter's
  total step at 1e-3 of its norm; and equal gradients under the remat
  policies none, full and dots;
* `registry.param_shapes` against the reference's ``jax.eval_shape``
  tree, parameters and AdamW state crossing both ways;
* the launcher on the CPU with JAX blocked: it prints ``DECREASED`` and
  ``--resume`` continues from LATEST."""
import json
import subprocess
import sys
from dataclasses import replace
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as jopt
from repro.configs import ARCHS as JARCHS
from repro.configs import smoke_config as jsmoke
from repro.launch import steps as jsteps
from repro.models import registry as jreg
from repro_torch import convert, optim
from repro_torch.configs import ARCHS, smoke_config
from repro_torch.launch import steps
from repro_torch.models import registry

REPO = Path(__file__).resolve().parents[1]
TOL = 2e-5       # losses and metrics, f32
GRAD_TOL = 1e-4  # a leaf against its largest entry: f32 sums of B x S terms
#                  (a scan's gradient through the whole sequence) in another
#                  order, compounded over 3 AdamW steps in the step test
STEP_TOL = 1e-3  # a parameter's 3 AdamW steps, by norm (see the step test)
CASES = {"qwen1.5-0.5b": 2, "qwen3-4b": 2, "gemma3-1b": 6,
         "qwen2-vl-7b": 2, "olmoe-1b-7b": 2, "falcon-mamba-7b": 2,
         "zamba2-1.2b": 5, "seamless-m4t-medium": 2}


def _model(arch, seed=1, **over):
    n = CASES[arch]
    jcfg = replace(jsmoke(JARCHS[arch]), n_layers=n, **over)
    cfg = replace(smoke_config(ARCHS[arch]), n_layers=n, **over)
    jp = jreg.init_params(jcfg, jax.random.key(seed))
    model = convert.params_from_numpy(cfg, jax.tree.map(np.asarray, jp),
                                      device="cpu")
    return jcfg, cfg, jp, model


def _batch(cfg, rng, b=2, s=24):
    """A numpy batch with the family's extra inputs."""
    batch = {"tokens": rng.integers(3, cfg.vocab - 1, (b, s)),
             "labels": rng.integers(3, cfg.vocab - 1, (b, s))}
    batch = {k: v.astype(np.int32) for k, v in batch.items()}
    if cfg.family == "vlm":
        batch["vision_embeds"] = rng.normal(
            size=(b, cfg.n_patches, cfg.d_model)).astype(np.float32)
        batch["positions"] = np.stack(
            [np.broadcast_to(np.arange(s, dtype=np.int32) + 3 * i, (b, s))
             for i in range(3)])
    if cfg.family == "encdec":
        batch["frames"] = rng.normal(size=(b, 8, cfg.d_model)) \
            .astype(np.float32)
    return batch


def _both(batch):
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(np.array(v)) for k, v in batch.items()})


def _paths(tree):
    return {tuple(k.key for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def assert_grad_trees_close(port: dict, ref, tol=GRAD_TOL, skip=()):
    """Same leaves; each (but ``skip``) within ``tol`` of its largest
    reference entry."""
    port, ref = _paths(port), _paths(ref)
    assert port.keys() == ref.keys()
    for k, r in ref.items():
        if k in skip:
            continue
        assert port[k].shape == r.shape, k
        scale = max(float(np.abs(r).max()), 1e-30)
        err = float(np.abs(port[k] - r).max()) / scale
        assert err <= tol, (k, err)


@pytest.mark.parametrize("arch", sorted(CASES))
def test_loss_and_gradients_match_reference(arch):
    jcfg, cfg, jp, model = _model(arch)
    model.requires_grad_(True)
    jb, tb = _both(_batch(cfg, np.random.default_rng(len(arch))))
    (jloss, jm), jg = jax.value_and_grad(
        lambda p: jreg.loss_fn(jcfg, p, jb), has_aux=True)(jp)
    loss, metrics = registry.loss_fn(cfg, model, tb)
    loss.backward()
    assert metrics.keys() == jm.keys()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=TOL,
                               atol=TOL)
    for k in jm:
        np.testing.assert_allclose(float(metrics[k].detach()), float(jm[k]),
                                   rtol=TOL, atol=TOL)
    assert_grad_trees_close(convert.params_to_numpy(cfg, model, grads=True),
                            jg)


@pytest.mark.parametrize("arch,k", [("qwen1.5-0.5b", 1), ("qwen1.5-0.5b", 2),
                                    ("qwen2-vl-7b", 2)])
def test_train_step_matches_reference(arch, k):
    jcfg, cfg, jp, model = _model(arch, seed=2)
    kw = dict(peak_lr=1e-3, warmup=2, total_steps=10, grad_accum=k)
    jstep = jax.jit(jsteps.build_train_step(jcfg, **kw))
    jp0 = jp
    step = steps.build_train_step(cfg, **kw)
    jopt_state = jopt.init_state(jp)
    opt_state = optim.init_state(model)
    rng = np.random.default_rng(k)
    for _ in range(3):
        jb, tb = _both(_batch(cfg, rng, b=4, s=16))
        jp, jopt_state, jm = jstep(jp, jopt_state, jb)
        opt_state, m = step(model, opt_state, tb)
        for name in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(m[name]), float(jm[name]),
                                       rtol=TOL, atol=1e-7)
    assert int(opt_state.step) == 3
    state = convert.adamw_state_to_numpy(opt_state)
    assert_grad_trees_close(state.mu, jopt_state.mu)
    assert_grad_trees_close(state.nu, jopt_state.nu)
    # A parameter's steps: AdamW divides by sqrt(nu) + eps, so where a
    # gradient entry is near eps and below the f32 noise floor the two
    # packages' steps differ by up to lr there.  Each leaf's total step is
    # held to 1e-3 of its norm.
    port = _paths(convert.params_to_numpy(cfg, model))
    start, ref = _paths(jax.tree.map(np.asarray, jp0)), _paths(jp)
    assert port.keys() == ref.keys()
    for k, r in ref.items():
        step_ref, step_port = r - start[k], port[k] - start[k]
        err = np.linalg.norm(step_port - step_ref) / max(
            np.linalg.norm(step_ref), 1e-30)
        assert err <= STEP_TOL, (k, err)


def test_grad_accum_falls_back_on_a_batch_it_does_not_divide():
    grads = []
    for k in (1, 2):
        _, cfg, _, model = _model("qwen1.5-0.5b", seed=3)
        _, tb = _both(_batch(cfg, np.random.default_rng(0), b=3, s=8))
        steps.build_train_step(cfg, grad_accum=k)(
            model, optim.init_state(model), tb)
        grads.append(convert.params_to_numpy(cfg, model, grads=True))
    for key, g in _paths(grads[0]).items():
        np.testing.assert_array_equal(_paths(grads[1])[key], g)


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "olmoe-1b-7b",
                                  "zamba2-1.2b", "seamless-m4t-medium"])
def test_remat_policies_give_equal_gradients(arch):
    """Checkpointing only changes what the backward recomputes: the
    gradients under none, full and dots are equal (to 1e-6 of each leaf's
    largest entry: the recompute repeats the same CPU kernels)."""
    _, cfg, _, base = _model(arch, seed=4)
    _, tb = _both(_batch(cfg, np.random.default_rng(1)))
    grads = {}
    for policy in ("none", "full", "dots"):
        model = convert.params_from_numpy(
            replace(cfg, remat=policy),
            convert.params_to_numpy(cfg, base), device="cpu")
        model.requires_grad_(True)
        loss, _ = registry.loss_fn(replace(cfg, remat=policy), model, tb)
        loss.backward()
        grads[policy] = convert.params_to_numpy(cfg, model, grads=True)
    for policy in ("full", "dots"):
        assert_grad_trees_close(grads[policy], grads["none"], 1e-6)


# ---------------------------------------------------------------------------
# shapes and state crossing between the packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "gemma3-1b", "olmoe-1b-7b",
                                  "llama4-maverick-400b-a17b",
                                  "falcon-mamba-7b", "zamba2-1.2b",
                                  "seamless-m4t-medium", "qwen2-vl-7b"])
def test_param_shapes_match_reference_eval_shape(arch):
    """Full configs: the meta model allocates nothing, yet every parameter
    lands on a reference leaf of the same stacked shape and dtype."""
    cfg, jcfg = ARCHS[arch], JARCHS[arch]
    model = registry.param_shapes(cfg)
    ref = {path: leaf for path, leaf in
           ((tuple(k.key for k in p), l) for p, l in
            jax.tree_util.tree_flatten_with_path(jreg.param_shapes(jcfg))[0])}
    seen = {}
    for name, p in model.named_parameters():
        assert p.device.type == "meta"
        path, index = convert.reference_path(name)
        assert path in ref, name
        assert tuple(p.shape) == ref[path].shape[len(index):], name
        assert str(p.dtype).removeprefix("torch.") == str(ref[path].dtype)
        seen.setdefault(path, set()).add(index)
    assert seen.keys() == ref.keys()
    for path, idx in seen.items():
        assert len(idx) == int(np.prod(ref[path].shape[:len(next(
            iter(idx)))])), path


@pytest.mark.parametrize("arch", sorted(CASES) + ["llama4-maverick-400b-a17b"])
def test_params_to_numpy_inverts_params_from_numpy(arch):
    if arch == "llama4-maverick-400b-a17b":
        jcfg, cfg = jsmoke(JARCHS[arch]), smoke_config(ARCHS[arch])
        jp = jreg.init_params(jcfg, jax.random.key(5))
        model = convert.params_from_numpy(cfg, jax.tree.map(np.asarray, jp),
                                          device="cpu")
    else:
        _, cfg, jp, model = _model(arch, seed=5)
    back = _paths(convert.params_to_numpy(cfg, model))
    ref = _paths(jax.tree.map(np.asarray, jp))
    assert back.keys() == ref.keys()
    for k, r in ref.items():
        np.testing.assert_array_equal(back[k], r)
    with pytest.raises(ValueError, match="no gradient"):
        convert.params_to_numpy(cfg, model, grads=True)


@pytest.mark.parametrize("mdt", ["float32", "bfloat16"])
def test_adamw_state_crosses_both_ways(mdt):
    jcfg, cfg, jp, model = _model("olmoe-1b-7b", seed=6,
                                  moment_dtype=mdt)
    rng = np.random.default_rng(2)
    jstate = jopt.AdamWState(
        step=jnp.asarray(7, jnp.int32),
        mu=jax.tree.map(lambda p: jnp.asarray(
            rng.normal(size=p.shape), jnp.dtype(mdt)), jp),
        nu=jax.tree.map(lambda p: jnp.asarray(
            rng.random(size=p.shape), jnp.dtype(mdt)), jp))
    state = convert.adamw_state_from_numpy(cfg, jstate, device="cpu")
    names = [n for n, _ in model.named_parameters()]
    assert int(state.step) == 7 and list(state.mu) == names
    assert all(t.dtype == getattr(torch, mdt) for t in state.nu.values())
    back = convert.adamw_state_to_numpy(state)
    assert int(back.step) == 7
    for port, ref in ((back.mu, jstate.mu), (back.nu, jstate.nu)):
        port, ref = _paths(port), _paths(ref)
        assert port.keys() == ref.keys()
        for k, r in ref.items():
            np.testing.assert_array_equal(port[k], np.asarray(r, np.float32))


def test_opt_state_shapes_on_meta():
    cfg = ARCHS["qwen1.5-0.5b"]
    state = steps.opt_state_shapes(cfg)
    assert state.step.device.type == "meta"
    n = sum(t.numel() for t in state.mu.values())
    assert n == sum(p.numel() for p in registry.param_shapes(cfg)
                    .parameters())
    assert {t.dtype for t in state.nu.values()} == {torch.float32}


# ---------------------------------------------------------------------------
# the launcher, as a user runs it, with JAX blocked
# ---------------------------------------------------------------------------

BLOCK_JAX = ("import runpy, sys\n"
             "for name in ('jax', 'jaxlib', 'repro'):\n"
             "    sys.modules[name] = None\n"
             "sys.argv = ['train', *sys.argv[1:]]\n"
             "runpy.run_module('repro_torch.launch.train', "
             "run_name='__main__')\n")


def _launch(*args):
    proc = subprocess.run(
        [sys.executable, "-c", BLOCK_JAX, "--device", "cpu", "--preset",
         "smoke", "--batch", "4", "--seq", "64", "--log-every", "4", *args],
        cwd=REPO, env={"PYTHONPATH": str(REPO / "src"),
                       "PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "2"},
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return proc.stdout.splitlines()


def test_launcher_decreases_loss_with_jax_blocked(tmp_path):
    log = tmp_path / "train.log"
    lines = _launch("--steps", "12", "--log-file", str(log))
    assert lines[0].startswith("arch=qwen1.5-0.5b preset=smoke params=")
    assert [l.split()[1] for l in lines[1:-1]] == ["0", "4", "8", "11"]
    assert lines[-1].startswith("done: 12 steps in ")
    assert lines[-1].endswith("(DECREASED)")
    rec = json.loads((tmp_path / "train.log.json").read_text())
    assert rec["steps"] == 12 and rec["loss_last5"] < rec["loss_first5"]
    assert log.read_text().splitlines() == lines[1:-1]


def test_launcher_resumes_from_latest(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    _launch("--steps", "8", "--ckpt-dir", ckpt, "--ckpt-every", "4")
    assert (tmp_path / "ckpt" / "LATEST").read_text() == "8"
    lines = _launch("--steps", "12", "--ckpt-dir", ckpt, "--ckpt-every",
                    "4", "--resume")
    assert lines[1] == "resumed from step 8"
    assert [l.split()[1] for l in lines[2:-1]] == ["8", "11"]
    assert lines[-1].startswith("done: 4 steps in ")
    assert (tmp_path / "ckpt" / "LATEST").read_text() == "12"
