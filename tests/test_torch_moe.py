"""Port parity: the MoE layers (`repro_torch.layers.moe` and `.moe_ep`)
against the JAX package's `repro.layers.moe` and `.moe_ep` on the same
weights and inputs, f32 at 2e-5.  The router's choice (`gate_idx`), the
capacity positions and the slot table must match exactly — with capacity
binding (the default factor 1.25, where colliding slots are dropped in
flat (t * K) order) and lifted (factor E) — including inputs whose router
probabilities tie, where the lower expert index comes first."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.layers import moe as jmoe
from repro.layers import moe_ep as jep
from repro_torch.layers import moe as tmoe
from repro_torch.layers import moe_ep as tep
from repro_torch.layers.common import param

TOL = 2e-5
D, F, E = 32, 48, 8


def _weights(seed: int, e: int = E):
    """Reference MoE weights (numpy) and the same weights in a port `MoE`."""
    jp = jax.tree.map(np.asarray, jmoe.init_moe(D, F, e, jnp.float32,
                                                jax.random.key(seed)))
    p = tmoe.init_moe(D, F, e, torch.float32, None, "meta")
    for name, arr in jp.items():
        setattr(p, name, param(torch.from_numpy(np.array(arr))))
    return jp, p


def _x(seed: int, b: int = 2, s: int = 24):
    return np.random.default_rng(seed).normal(size=(b, s, D)) \
        .astype(np.float32)


def close(port, ref, tol=TOL):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("top_k", [1, 2, 4])
@pytest.mark.parametrize("factor", [1.25, float(E)])
@pytest.mark.parametrize("impl", ["einsum", "ep"])
def test_moe_ffn_matches_reference(impl, factor, top_k):
    jp, p = _weights(0)
    x = _x(1)
    jfn, tfn = ((jmoe.moe_ffn, tmoe.moe_ffn) if impl == "einsum"
                else (jep.moe_ffn_ep, tep.moe_ffn_ep))
    jy, jaux = jfn(jp, jnp.asarray(x), top_k=top_k, capacity_factor=factor)
    ty, taux = tfn(p, torch.from_numpy(x), top_k=top_k,
                   capacity_factor=factor)
    close(ty, jy)
    close(taux, jaux)


def test_binding_capacity_drops_slots():
    """At t = 3 decode tokens with K = 2 over 8 experts the capacity is 1,
    so slots that pick one expert collide and all but the first are
    dropped: the binding and lifted outputs differ, and each matches the
    reference."""
    jp, p = _weights(2)
    x = _x(3, b=3, s=1)
    t = 3
    assert tmoe.capacity(t, 1.25, 2, E) == 1
    xt = torch.from_numpy(x.reshape(t, D))
    _, gate_idx, _ = tep._route(xt, p.router, 2)
    _, valid = tep._positions(gate_idx, E, 1)
    assert not bool(valid.all())
    yb, _ = tep.moe_ffn_ep(p, torch.from_numpy(x), top_k=2)
    yl, _ = tep.moe_ffn_ep(p, torch.from_numpy(x), top_k=2,
                           capacity_factor=float(E))
    assert not torch.allclose(yb, yl)
    for factor, y in ((1.25, yb), (float(E), yl)):
        close(y, jep.moe_ffn_ep(jp, jnp.asarray(x), top_k=2,
                                capacity_factor=factor)[0])
        close(y, jmoe.moe_ffn(jp, jnp.asarray(x), top_k=2,
                              capacity_factor=factor)[0])


def _tied_router(e: int = E):
    """A router whose columns repeat in pairs: every token's probabilities
    tie between experts 2i and 2i+1."""
    r = np.random.default_rng(4).normal(size=(D, e // 2)).astype(np.float32)
    return np.repeat(r, 2, axis=1)


@pytest.mark.parametrize("tied", [False, True])
@pytest.mark.parametrize("top_k", [1, 2, 3])
def test_gate_idx_positions_and_slot_table_exact(tied, top_k):
    jp, p = _weights(5)
    if tied:
        jp["router"] = _tied_router()
        p.router = param(torch.from_numpy(jp["router"].copy()))
    x = _x(6, b=2, s=12)
    t = 24
    xt = x.reshape(t, D)
    jv, jidx, jaux = jep._route(jnp.asarray(xt), jnp.asarray(jp["router"]),
                                top_k)
    tv, tidx, taux = tep._route(torch.from_numpy(xt), p.router, top_k)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    close(tv, jv)
    close(taux, jaux)
    if tied:
        probs = torch.softmax(torch.from_numpy(xt) @ p.router, dim=-1)
        assert bool((probs[:, 0::2] == probs[:, 1::2]).all())
    for factor in (1.25, float(E)):
        cap = tmoe.capacity(t, factor, top_k, E)
        jpos, jvalid = jep._positions(jidx, E, cap)
        tpos, tvalid = tep._positions(tidx, E, cap)
        np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
        np.testing.assert_array_equal(tvalid.numpy(), np.asarray(jvalid))
        jtab = jep._scatter_token_idx(jidx, jpos, jvalid, E, cap, t)
        ttab = tep._scatter_token_idx(tidx, tpos, tvalid, E, cap, t)
        np.testing.assert_array_equal(ttab.numpy(), np.asarray(jtab))


def test_positions_and_slot_table_examples():
    """tests/test_moe_ep.py's hand-made cases, through the port."""
    gate_idx = torch.tensor([[0, 1], [0, 1], [0, 2], [0, 0]])
    pos, valid = tep._positions(gate_idx, n_experts=4, cap=3)
    assert pos[0, 0] == 0 and pos[1, 0] == 1 and pos[2, 0] == 2
    assert not valid[3, 0] and not valid[3, 1]
    assert valid[0, 1] and pos[0, 1] == 0
    gate_idx = torch.tensor([[0], [2], [0], [1]])
    pos, valid = tep._positions(gate_idx, n_experts=3, cap=2)
    table = tep._scatter_token_idx(gate_idx, pos, valid, 3, 2, t=4)
    assert table.tolist() == [[0, 2], [3, 4], [1, 4]]


def test_top_k_puts_the_lower_index_first_on_ties():
    probs = torch.tensor([[0.1, 0.3, 0.3, 0.3], [0.25, 0.25, 0.25, 0.25]])
    vals, idx = tmoe.top_k_lowest_index_first(probs, 3)
    jv, jidx = jax.lax.top_k(jnp.asarray(probs.numpy()), 3)
    assert idx.tolist() == [[1, 2, 3], [0, 1, 2]] == np.asarray(jidx).tolist()
    close(vals, jv)


def test_ep_matches_einsum_with_lifted_capacity():
    """tests/test_moe_ep.py's oracle, on the port alone: with capacity
    lifted both dispatches compute the same function."""
    _, p = _weights(7)
    x = torch.from_numpy(_x(8))
    for top_k in (1, 2, 4):
        ye, ae = tmoe.moe_ffn(p, x, top_k=top_k, capacity_factor=float(E))
        yp, ap = tep.moe_ffn_ep(p, x, top_k=top_k, capacity_factor=float(E))
        torch.testing.assert_close(yp, ye, rtol=TOL, atol=TOL)
        torch.testing.assert_close(ap, ae, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="expert_axis"):
        tep.moe_ffn_ep(p, x, top_k=2, expert_axis="pod")
