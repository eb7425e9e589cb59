"""Port parity: the GAPBS workloads (`repro_torch.workloads.graphs`,
`gapbs`) against the JAX package — the RMAT graphs, the five SDM trace
generators and `egress_batches` as identical arrays; `bfs`,
`connected_components` and `triangle_count` exact; `pagerank` within 1e-6
(its per-vertex sums run in another order)."""
import numpy as np
import pytest
import torch

from repro.workloads import gapbs as jg
from repro.workloads import graphs as jgr
from repro_torch.workloads import gapbs as tg
from repro_torch.workloads import graphs as tgr

SCALE = 10


@pytest.fixture(scope="module")
def graphs():
    return (jgr.make_graph(scale=SCALE, avg_degree=12, seed=7),
            tgr.make_graph(scale=SCALE, avg_degree=12, seed=7))


def test_graphs_match(graphs):
    jgraph, tgraph = graphs
    np.testing.assert_array_equal(jgraph.offsets, tgraph.offsets)
    np.testing.assert_array_equal(jgraph.neighbors, tgraph.neighbors)
    assert tgraph.neighbors.dtype == jgraph.neighbors.dtype
    np.testing.assert_array_equal(jgr.rmat_edges(8, 4, seed=3),
                                  tgr.rmat_edges(8, 4, seed=3))
    edges = np.random.default_rng(0).integers(0, 50, (300, 2))
    for sym in (True, False):
        a, b = jgr.to_csr(edges, 50, symmetrize=sym), \
            tgr.to_csr(edges, 50, symmetrize=sym)
        np.testing.assert_array_equal(a.offsets, b.offsets)
        np.testing.assert_array_equal(a.neighbors, b.neighbors)


@pytest.mark.parametrize("kernel", list(jg.TRACES))
def test_traces_and_egress_batches_match(graphs, kernel):
    jgraph, tgraph = graphs
    assert list(tg.TRACES) == list(jg.TRACES) and tg.KERNELS == jg.KERNELS
    for cap, seed in ((20_000, 0), (3_000, 5)):
        jt = jg.TRACES[kernel](jgraph, cap=cap, seed=seed)
        tt = tg.TRACES[kernel](tgraph, cap=cap, seed=seed)
        np.testing.assert_array_equal(jt.pages, tt.pages)
        np.testing.assert_array_equal(jt.is_write, tt.is_write)
        assert (jt.n_instructions, jt.local_refs) == \
            (tt.n_instructions, tt.local_refs)
        for kw in (dict(), dict(page_offset=4096, page_span=1024)):
            je, jw = jg.egress_batches(jt, hwpid=7, batch=128, n_steps=5,
                                       **kw)
            te, tw = tg.egress_batches(tt, hwpid=7, batch=128, n_steps=5,
                                       **kw)
            np.testing.assert_array_equal(je, te)
            np.testing.assert_array_equal(jw, tw)
            assert te.dtype == je.dtype == np.int32
    lay_j, lay_t = jg.SDMLayout.for_graph(jgraph), tg.SDMLayout.for_graph(
        tgraph)
    assert vars(lay_j) == vars(lay_t)
    with pytest.raises(ValueError):
        tg.egress_batches(tg.Trace(np.empty(0, np.int64), np.empty(0, bool),
                                   0, 0), hwpid=1, batch=4, n_steps=1)


def test_bfs_cc_and_triangles_exact(graphs):
    jgraph, tgraph = graphs
    for src in (0, 5, 77):
        np.testing.assert_array_equal(jg.bfs(jgraph, src), tg.bfs(tgraph, src))
    for iters in (1, 3, 50):
        want = np.asarray(jg.connected_components(jgraph, iters))
        got = tg.connected_components(tgraph, iters, device="cpu")
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(want, got.numpy())
    assert jg.triangle_count(jgraph, max_edges=5000) == \
        tg.triangle_count(tgraph, max_edges=5000)


def test_pagerank_within_1e6(graphs):
    jgraph, tgraph = graphs
    for iters in (1, 10):
        want = np.asarray(jg.pagerank(jgraph, iters))
        got = tg.pagerank(tgraph, iters, device="cpu")
        assert got.dtype == torch.float32 and got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
        assert abs(float(got.sum()) - 1.0) < 1e-4
