"""Port parity: checkpointing (`repro_torch.checkpointing.store`) and the
fault-tolerant runtime (`repro_torch.runtime.fault_tolerance`) against the
JAX package.

The store tests of ``tests/test_runtime.py`` run on tensor trees; a
checkpoint saved by either package restores in the other bit for bit (the
same manifest, leaf paths and files); `ResilientLoop`, `FailureDetector` and
`StragglerMonitor` give the reference's reports and flags."""
import json
import os
from collections import OrderedDict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpointing import store as jstore
from repro.runtime import fault_tolerance as jft
from repro_torch.checkpointing import store
from repro_torch.runtime import fault_tolerance as tft
from repro_torch.runtime import ResilientLoop, StragglerMonitor


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"w": torch.randn(16, 8, generator=g),
            "opt": {"mu": torch.zeros(16, 8),
                    "step": torch.tensor(3, dtype=torch.int32),
                    "bits": torch.arange(6, dtype=torch.uint8)},
            "hist": [torch.ones(2, dtype=torch.int32), (1.5, 7)],
            "skip": None}


def _flat(tree):
    return [x for _, x in store._flatten(tree)]


def _assert_trees_equal(a, b):
    fa, fb = store._flatten(a), store._flatten(b)
    assert [p for p, _ in fa] == [p for p, _ in fb]
    for (_, x), (_, y) in zip(fa, fb):
        assert type(x) is type(y)
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and x.device == y.device
            assert torch.equal(x, y)
        else:
            assert x == y


# ---------------------------------------------------------------------------
# checkpoint store (tests/test_runtime.py)
# ---------------------------------------------------------------------------

def test_save_restore_roundtrip(tmp_path):
    t = _tree()
    store.save(str(tmp_path), 7, t)
    assert store.latest_step(str(tmp_path)) == 7
    restored, step = store.restore(str(tmp_path), _tree(seed=1))
    assert step == 7
    _assert_trees_equal(restored, t)
    assert restored["skip"] is None and isinstance(restored["hist"][1], tuple)


def test_latest_points_to_newest(tmp_path):
    t = _tree()
    store.save(str(tmp_path), 1, t)
    store.save(str(tmp_path), 2, t)
    assert store.latest_step(str(tmp_path)) == 2
    assert store.latest_step(str(tmp_path / "missing")) is None


def test_crash_mid_write_falls_back(tmp_path):
    """A checkpoint is visible only after LATEST flips: a torn step_N dir
    without the pointer update must not be restored."""
    t = _tree()
    store.save(str(tmp_path), 1, t)
    os.makedirs(tmp_path / "step_2")
    (tmp_path / "step_2" / "leaf_0.npy").write_bytes(b"garbage")
    restored, step = store.restore(str(tmp_path), t)
    assert step == 1
    _assert_trees_equal(restored, t)


def test_restore_structure_mismatch_raises(tmp_path):
    store.save(str(tmp_path), 1, _tree())
    with pytest.raises(ValueError, match="structure"):
        store.restore(str(tmp_path), {"only": torch.zeros(2)})
    bad = _tree()
    bad["w"] = torch.zeros(4, 4)
    with pytest.raises(ValueError, match="shape"):
        store.restore(str(tmp_path), bad)
    with pytest.raises(FileNotFoundError):
        store.restore(str(tmp_path / "none"), _tree())


def test_async_save_joinable_and_isolated_from_later_writes(tmp_path):
    t = _tree()
    want = t["w"].clone()
    h = store.save(str(tmp_path), 5, t, blocking=False)
    t["w"].add_(1.0)            # an in-place update after save returns
    h.join()
    assert store.latest_step(str(tmp_path)) == 5
    restored, _ = store.restore(str(tmp_path), t)
    assert torch.equal(restored["w"], want)


def test_state_dict_and_numpy_leaves(tmp_path):
    """A module's flat ``state_dict`` (an OrderedDict, insertion order) and
    numpy leaves; each restored leaf takes the dtype of ``like``'s."""
    sd = torch.nn.Linear(4, 3).state_dict()
    assert isinstance(sd, OrderedDict)
    store.save(str(tmp_path), 1, sd)
    got, _ = store.restore(str(tmp_path), torch.nn.Linear(4, 3).state_dict())
    _assert_trees_equal(got, sd)
    assert list(got) == ["weight", "bias"]
    arrs = {"a": np.arange(5, dtype=np.uint32), "b": 2.5}
    store.save(str(tmp_path), 2, arrs)
    got, _ = store.restore(str(tmp_path), {"a": np.zeros(5, np.int64),
                                           "b": 0.0})
    assert got["a"].dtype == np.int64 and got["a"].tolist() == [0, 1, 2, 3, 4]
    assert got["b"] == 2.5
    with pytest.raises(TypeError):
        store.save(str(tmp_path), 3,
                   {"x": torch.zeros(2, dtype=torch.bfloat16)})


# ---------------------------------------------------------------------------
# checkpoints cross between the packages
# ---------------------------------------------------------------------------

def _jax_tree(t):
    """The JAX twin of a tensor tree: dicts, lists and tuples kept (the
    trees hold no 64-bit tensors, which JAX would narrow to 32 bits)."""
    def conv(x):
        if isinstance(x, torch.Tensor):
            return jnp.asarray(x.numpy())
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(conv(v) for v in x)
        return x
    return conv(t)


def _manifest(d, step):
    with open(os.path.join(d, f"step_{step}", "manifest.json")) as f:
        return json.load(f)


def test_checkpoints_cross_between_packages(tmp_path):
    t = _tree(seed=4)
    jt = _jax_tree(t)
    jd, td = str(tmp_path / "jax"), str(tmp_path / "port")
    jstore.save(jd, 3, jt)
    store.save(td, 3, t)
    assert _manifest(jd, 3) == _manifest(td, 3)
    for i in range(len(_flat(t))):
        a = np.load(os.path.join(jd, "step_3", f"leaf_{i}.npy"))
        b = np.load(os.path.join(td, "step_3", f"leaf_{i}.npy"))
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    # a JAX checkpoint restores in the port, a port checkpoint in JAX
    got, step = store.restore(jd, _tree(seed=9))
    assert step == 3
    _assert_trees_equal(got, t)
    jgot, _ = jstore.restore(td, _jax_tree(_tree(seed=9)))
    for a, b in zip(jax.tree.leaves(jgot), _flat(t)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # a flat state_dict too
    sd = torch.nn.Linear(5, 2).state_dict()
    store.save(td, 4, sd)
    jsd, _ = jstore.restore(td, OrderedDict(
        (k, jnp.zeros(v.shape)) for k, v in sd.items()))
    for k in sd:
        np.testing.assert_array_equal(np.asarray(jsd[k]), sd[k].numpy())


# ---------------------------------------------------------------------------
# resilient loop, failure detector, straggler monitor
# ---------------------------------------------------------------------------

def _make_step(fail_at: set):
    """A step whose loss is a pure function of the step and the state (as
    the reference's data pipeline is), failing once at each of
    ``fail_at``."""
    def step_fn(state, step):
        if step in fail_at:
            fail_at.discard(step)
            raise RuntimeError("simulated node failure")
        tokens = np.random.default_rng(step).integers(0, 97, (4, 16))
        loss = float(tokens.mean()) + float(state["x"])
        return {"x": state["x"] + 1}, loss
    return step_fn


def test_resilient_loop_recovers_and_replays_exactly(tmp_path):
    runs = {}
    for name, mod in (("jax", jft), ("port", tft)):
        for tag, fails in (("clean", set()), ("failed", {7, 13})):
            loop = mod.ResilientLoop(str(tmp_path / name / tag),
                                     ckpt_every=5, async_ckpt=False)
            runs[name, tag] = loop.run({"x": 0}, _make_step(set(fails)), 20)
    (_, clean), (fstate, failed) = runs["port", "clean"], runs["port",
                                                              "failed"]
    assert failed.failures_recovered == 2 and fstate["x"] == 20
    assert failed.losses[-1] == clean.losses[-1]
    assert set(np.round(clean.losses, 9)) <= set(np.round(failed.losses, 9))
    assert [f[0] for f in failed.failures] == [7, 13]
    for tag in ("clean", "failed"):
        assert runs["port", tag][0] == runs["jax", tag][0]
        assert vars(runs["port", tag][1]) == vars(runs["jax", tag][1])


def test_resilient_loop_async_checkpoints_and_slow_steps(tmp_path):
    """Async checkpoints join before a restore; a fake clock flags exactly
    the steps that outlast the heartbeat timeout."""
    reports = []
    for name, mod in (("jax", jft), ("port", tft)):
        t = {"now": 0.0}
        fail_at = {14}

        def step_fn(state, step, t=t, fail_at=fail_at):
            t["now"] += 5.0 if step in (3, 8) else 1.0
            if step in fail_at:
                fail_at.discard(step)
                raise RuntimeError("late failure")
            return {"x": state["x"] + 1}, float(step)

        loop = mod.ResilientLoop(str(tmp_path / name), ckpt_every=4,
                                 async_ckpt=True, clock=lambda t=t: t["now"],
                                 heartbeat_timeout=2.0)
        state, rep = loop.run({"x": 0}, step_fn, 16)
        reports.append((state, vars(rep)))
    assert reports[0] == reports[1]
    assert reports[1][1]["slow_steps"] == [3, 8]


def test_resilient_loop_gives_up_after_max_restarts(tmp_path):
    def always_fail(state, step):
        raise RuntimeError("dead node")

    loop = ResilientLoop(str(tmp_path), ckpt_every=5, max_restarts=2,
                         async_ckpt=False)
    with pytest.raises(RuntimeError):
        loop.run({"x": 0}, always_fail, 10)


def test_failure_detector_matches():
    logs = []
    for mod in (jft, tft):
        t = {"now": 0.0}
        fd = mod.FailureDetector(timeout=3.0, clock=lambda t=t: t["now"])
        log = []
        for step in range(12):
            t["now"] = float(step)
            for h in range(4):
                if h != step % 5:
                    fd.beat(h)
            if step == 6:
                fd.forget(2)
            log.append((fd.dead(), [fd.alive(h) for h in range(5)],
                        fd.last_beat(3)))
        with pytest.raises(ValueError):
            mod.FailureDetector(timeout=0)
        logs.append(log)
    assert logs[0] == logs[1]


def test_straggler_monitor_flags_slow_host():
    mon = StragglerMonitor(n_hosts=4, threshold=1.5)
    for step in range(10):
        slow = mon.record(step, np.asarray([1.0, 1.0, 1.0, 3.0]))
    assert slow == [3]
    assert (9, 3) in mon.flagged


def test_straggler_monitor_matches_and_has_no_false_positives():
    rng = np.random.default_rng(0)
    times = 1.0 + 0.05 * rng.random((20, 8))
    times[12:, 5] *= 2.5
    mons = [jft.StragglerMonitor(n_hosts=8, threshold=1.5),
            StragglerMonitor(n_hosts=8, threshold=1.5)]
    for step, row in enumerate(times):
        flags = [m.record(step, row) for m in mons]
        assert flags[0] == flags[1]
        if step < 12:
            assert flags[1] == []
    assert mons[0].flagged == mons[1].flagged and mons[1].flagged
    np.testing.assert_array_equal(mons[0].ewma, mons[1].ewma)
