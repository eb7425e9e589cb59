"""Port parity: the Mamba1 and Mamba2 blocks (`repro_torch.layers.mamba`)
against the JAX package's `repro.layers.mamba` on the same weights: a
prompt from an empty state, then single teacher-forced steps from the
returned cache, f32 at 2e-5.  The outputs and every cache field (the conv
histories and the f32 SSM state) are compared after the prompt and after
each step; so is the port's causal conv, and a prompt run in one call
against the same prompt run in two halves."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.layers import mamba as jm
from repro_torch.layers import mamba as tm
from repro_torch.layers.common import param

TOL = 2e-5
D = 32


def _load(jp, module):
    for name, arr in jp.items():
        setattr(module, name, param(torch.from_numpy(np.array(arr))))
    return module


def _mamba1(seed):
    jp = jax.tree.map(np.asarray, jm.init_mamba1(
        D, d_state=8, expand=2, conv_w=4, key=jax.random.key(seed)))
    return jp, _load(jp, tm.init_mamba1(D, d_state=8, device="meta"))


def _mamba2(seed, n_groups):
    jp = jax.tree.map(np.asarray, jm.init_mamba2(
        D, d_state=16, expand=2, head_dim=16, n_groups=n_groups,
        key=jax.random.key(seed)))
    # non-trivial decays and norm scales (the reference zero-inits them)
    rng = np.random.default_rng(seed)
    jp["a_log"] = rng.normal(size=jp["a_log"].shape).astype(np.float32)
    jp["norm_scale"] = 0.1 * rng.normal(size=jp["norm_scale"].shape) \
        .astype(np.float32)
    return jp, _load(jp, tm.init_mamba2(D, d_state=16, head_dim=16,
                                        n_groups=n_groups, device="meta"))


def close(port, ref):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref),
                               rtol=TOL, atol=TOL)


def close_cache(port, ref):
    assert type(port).__name__ == type(ref).__name__
    for f in ref._fields:
        close(getattr(port, f), getattr(ref, f))
    assert port.ssm.dtype == torch.float32


def _run(jfn, tfn, jp, p, seed, b=2, s=11, steps=4):
    x = np.random.default_rng(seed).normal(size=(b, s + steps, D)) \
        .astype(np.float32)
    jy, jc = jfn(jp, jnp.asarray(x[:, :s]), None)
    ty, tc = tfn(p, torch.from_numpy(x[:, :s]), None)
    close(ty, jy)
    close_cache(tc, jc)
    for t in range(s, s + steps):              # teacher-forced steps
        jy, jc = jfn(jp, jnp.asarray(x[:, t:t + 1]), jc)
        ty, tc = tfn(p, torch.from_numpy(x[:, t:t + 1]), tc)
        close(ty, jy)
        close_cache(tc, jc)
    return x, ty, tc


@pytest.mark.parametrize("seed", [0, 1])
def test_mamba1_prompt_then_steps(seed):
    jp, p = _mamba1(seed)
    _run(jm.mamba1, tm.mamba1, jp, p, seed + 10)


@pytest.mark.parametrize("n_groups", [1, 2])
def test_mamba2_prompt_then_steps(n_groups):
    jp, p = _mamba2(3, n_groups)
    _run(lambda q, x, c: jm.mamba2(q, x, c, head_dim=16, n_groups=n_groups),
         lambda q, x, c: tm.mamba2(q, x, c, head_dim=16, n_groups=n_groups),
         jp, p, 20 + n_groups)


def test_a_prompt_in_two_halves_equals_one_call():
    """The cache carries everything: the prompt split at any point gives
    the same outputs and final state."""
    jp, p = _mamba2(4, 1)
    x = torch.from_numpy(np.random.default_rng(5).normal(size=(2, 12, D))
                         .astype(np.float32))
    y, c = tm.mamba2(p, x, None, head_dim=16)
    y1, c1 = tm.mamba2(p, x[:, :5], None, head_dim=16)
    y2, c2 = tm.mamba2(p, x[:, 5:], c1, head_dim=16)
    torch.testing.assert_close(torch.cat([y1, y2], 1), y, rtol=TOL,
                               atol=TOL)
    for f in c._fields:
        torch.testing.assert_close(getattr(c2, f), getattr(c, f), rtol=TOL,
                                   atol=TOL)


def test_causal_conv_matches_reference():
    rng = np.random.default_rng(6)
    w, b = rng.normal(size=(4, 10)), rng.normal(size=10)
    x, st = rng.normal(size=(2, 7, 10)), rng.normal(size=(2, 3, 10))
    jy, js = jm._causal_conv(*(jnp.asarray(a, jnp.float32)
                               for a in (w, b, x, st)))
    ty, ts = tm._causal_conv(*(torch.from_numpy(a.astype(np.float32))
                               for a in (w, b, x, st)))
    close(ty, jy)
    close(ts, js)


# ---------------------------------------------------------------------------
# The fused Mamba2 decode step (`kernels.mamba2_decode`): its plain version
# against the layer's S = 1 path, and the layer's dispatch to it
# ---------------------------------------------------------------------------

from repro_torch import tracing  # noqa: E402
from repro_torch.kernels import mamba2_decode as tmd  # noqa: E402

# (d_model, d_state, head_dim): zamba2's and granite's state and head
# widths (64 x 64 and 128 x 64) at two and four heads; a head_dim of 5,
# so that 3 sequences' d_inner is no multiple of 4
FUSED_SHAPES = {"zamba2-like": (64, 64, 64), "granite-like": (128, 128, 64),
                "smoke": (32, 16, 16), "ragged": (5, 16, 5)}


def _mixer(shape, n_groups, seed):
    """A Mamba2 mixer with every parameter drawn (the conv biases, decays,
    dt biases, skips and norm scales too, which init leaves constant)."""
    d, n, dh = shape
    g = torch.Generator().manual_seed(seed)
    p = tm.init_mamba2(d, d_state=n, head_dim=dh, n_groups=n_groups,
                       generator=g)
    for name in ("conv_x_b", "conv_b_b", "conv_c_b", "a_log", "dt_bias",
                 "d_skip", "norm_scale"):
        t = getattr(p, name)
        setattr(p, name, param(0.5 * torch.randn(t.shape, generator=g)))
    return p


def _projections(p, x):
    """The five input projections of one step, as `mamba2` takes them."""
    return tuple((x @ w)[:, 0] for w in (p.w_z, p.w_x, p.w_b, p.w_c,
                                         p.w_dt))


def _equal_caches(a, b):
    assert type(a) is type(b)
    for f in a._fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def _old_path(monkeypatch):
    """Turn the layer's dispatch to the fused step off: every call takes
    the layer's own code."""
    monkeypatch.setattr(tm, "_fused_step", lambda *args: False)


@pytest.mark.parametrize("n_groups", [1, 2])
@pytest.mark.parametrize("shape", list(FUSED_SHAPES))
def test_mamba2_decode_plain_equals_the_s1_path(shape, n_groups,
                                                monkeypatch):
    """After a prompt, five steps: the plain version of the fused step
    (from the step's projections, then ``w_out``) gives the layer's own
    S = 1 output and all four cache tensors bit for bit, out of place and
    in place."""
    _old_path(monkeypatch)
    dh = FUSED_SHAPES[shape][2]
    p = _mixer(FUSED_SHAPES[shape], n_groups, 30 + n_groups)
    x = torch.randn((3, 9, FUSED_SHAPES[shape][0]),
                    generator=torch.Generator().manual_seed(31))
    kw = dict(head_dim=dh, n_groups=n_groups, eps=1e-5)
    _, cache = tm.mamba2(p, x[:, :4], None, **kw)
    fused = tm.Mamba2Cache(*(t.clone() for t in cache))
    inplace = tm.Mamba2Cache(*(t.clone() for t in cache))
    for t in range(4, 9):
        want, cache = tm.mamba2(p, x[:, t:t + 1], cache, **kw)
        proj = _projections(p, x[:, t:t + 1])
        y, fused = tmd.mamba2_decode_plain(p, *proj, fused, eps=1e-5)
        y2, got = tmd.mamba2_decode_plain(p, *proj, inplace, eps=1e-5,
                                          in_place=True)
        assert got is inplace
        assert torch.equal(y, y2)
        assert torch.equal((y @ p.w_out)[:, None], want)
        _equal_caches(fused, cache)
        _equal_caches(inplace, cache)


@pytest.fixture
def fused_on_cpu(monkeypatch):
    """A list of the layer's calls that reach the kernel wrapper (which
    runs its plain version on the CPU)."""
    calls = []

    def spy(*args, **kw):
        calls.append(args[1].shape)
        return tmd.mamba2_decode(*args, **kw)
    monkeypatch.setattr(tm, "mamba2_decode", spy)
    return calls


def test_the_fused_step_takes_decode_steps_and_nothing_else(fused_on_cpu,
                                                            monkeypatch):
    """S = 1 goes through the fused step, with outputs and caches equal to
    the old path's; S > 1, the cost recorder and a d_state the kernel does
    not take stay on the old path, and a head_dim of 5 takes it; each
    fused step counts one ``mamba2.fused_steps`` while counters are
    on."""
    from repro_torch.launch.hlo_analysis import CostRecorder
    p = _mixer(FUSED_SHAPES["smoke"], 1, 40)
    x = torch.randn((2, 7, 32), generator=torch.Generator().manual_seed(41))
    _, cache = tm.mamba2(p, x[:, :4], None, head_dim=16)
    assert fused_on_cpu == []                        # S > 1: the old path
    tracing.enable(spans=False, counters=True)
    try:
        y, c = tm.mamba2(p, x[:, 4:5], cache, head_dim=16)
        y2, c2 = tm.mamba2(p, x[:, 5:6], c, head_dim=16)
        counted = tracing.take_counters()
    finally:
        tracing.disable()
    assert counted == {"mamba2.fused_steps": 2}
    assert len(fused_on_cpu) == 2
    with CostRecorder():
        tm.mamba2(p, x[:, 6:7], c2, head_dim=16)
    assert len(fused_on_cpu) == 2                    # the recorder: old path
    r = _mixer(FUSED_SHAPES["ragged"], 1, 47)        # any head_dim: taken
    tm.mamba2(r, torch.randn((3, 1, 5)), None, head_dim=5)
    assert fused_on_cpu[-1] == (3, 10)
    q = _mixer((32, 12, 16), 1, 42)                  # d_state 12: not taken
    tm.mamba2(q, x[:, :1], None, head_dim=16)
    assert len(fused_on_cpu) == 3
    _old_path(monkeypatch)
    want, wc = tm.mamba2(p, x[:, 4:5], cache, head_dim=16)
    assert torch.equal(y, want)
    _equal_caches(c, wc)


def test_the_fused_step_leaves_dtensors_on_the_old_path():
    """A DTensor input (a mesh's) is never the fused step's, whatever the
    device; the same step as a plain tensor is."""
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, distribute_tensor

    from repro_torch.launch import mesh as pmesh
    p = _mixer(FUSED_SHAPES["smoke"], 1, 43)
    x = torch.randn((2, 1, 32), generator=torch.Generator().manual_seed(44))
    cache = tm.init_mamba2_cache(2, 64, 16, 4, 16, 16, 4, torch.float32)
    assert not dist.is_initialized()
    mesh = pmesh.make_smoke_mesh("cpu")
    try:
        assert tm._fused_step(p, x, cache)
        dx = distribute_tensor(x, mesh, (Replicate(), Replicate()))
        assert not tm._fused_step(p, dx, cache)
        dc = tm.Mamba2Cache(*(distribute_tensor(t, mesh, (Replicate(),
                                                          Replicate()))
                              for t in cache))
        assert not tm._fused_step(p, x, dc)
    finally:
        dist.destroy_process_group()


def test_an_eager_step_leaves_its_cache_and_in_place_writes_it(
        fused_on_cpu, monkeypatch):
    """The fused step's functional contract: the eager call returns fresh
    tensors and leaves the cache it was given as it was; ``in_place``
    writes the given cache, which then equals the eager call's, and
    returns it (the old path alike)."""
    p = _mixer(FUSED_SHAPES["granite-like"], 1, 45)
    x = torch.randn((2, 6, 128), generator=torch.Generator().manual_seed(46))
    _, cache = tm.mamba2(p, x[:, :5], None, head_dim=64)
    for fused in (True, False):
        if not fused:
            _old_path(monkeypatch)
        kept = tm.Mamba2Cache(*(t.clone() for t in cache))
        y, new = tm.mamba2(p, x[:, 5:], cache, head_dim=64)
        _equal_caches(cache, kept)
        assert all(a.data_ptr() != b.data_ptr()
                   for a, b in zip(new, cache))
        y2, same = tm.mamba2(p, x[:, 5:], kept, head_dim=64, in_place=True)
        assert same is kept
        assert torch.equal(y, y2)
        _equal_caches(kept, new)
    assert len(fused_on_cpu) == 2


@pytest.mark.parametrize("d_state, conv_w, taken", [
    (128, 4, True), (64, 4, True), (16, 4, True), (256, 4, True),
    (512, 2, True), (4, 8, True), (12, 4, False), (48, 4, False),
    (384, 4, False), (1024, 4, False), (2, 4, False), (128, 1, False),
    (128, 9, False)])
def test_the_kernel_covers_shapes_by_state_width_and_conv(
        d_state, conv_w, taken):
    assert tmd.covers(d_state, conv_w) is taken
