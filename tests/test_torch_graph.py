"""The port's Pregel graphs (``spark_tpu_torch/graph``) against the JAX
package's on the cases of tests/test_graph.py and on a random graph
(numpy-seeded), on the CPU.

Tolerances:

- PageRank: bit for bit with the reference. Both merge the float32
  messages by adding them in edge order (``index_add_`` here,
  ``segment_sum`` there). XLA fuses the reference's update into one
  multiply-add on the CPU, and the port computes it as one (in float64,
  rounded once to float32; with plain float32 operations the ranks
  drift up to 4 ulps from the reference's in 20 supersteps). With the
  merge that the card takes (``seg_fsum``: each vertex's sum rounded
  once), within ``20 * (max in-degree + 2) * 2^-24`` relative of the
  CPU's ranks (a sum of d messages rounds at most (d + 2) * 2^-24
  apart, the update included, and an error carries on through the 20
  supersteps);
- connected components, SSSP (a custom ``pregel`` with a ``min``
  merge), ``max`` merges and triangle counts: equal.
"""

import numpy as np
import pytest
import torch

from spark_tpu.graph import Graph as RGraph
from spark_tpu_torch.graph import Graph as PGraph
from spark_tpu_torch.physical import kernels as PK

from test_torch_threads import one_torch_thread  # noqa: F401


def _graphs(*args, **kw):
    return PGraph(*args, device="cpu", **kw), RGraph(*args, **kw)


def _bits(a):
    return np.asarray(a).view(np.int32 if np.asarray(a).dtype == np.float32
                               else np.int64)


def _random_graph(n=300, m=2400, seed=7):
    rng = np.random.default_rng(seed)
    ids = rng.permutation(np.arange(n) * 3 + 5)
    # a skewed destination distribution: a few hubs of high in-degree
    dst = ids[np.minimum(rng.zipf(1.6, m) - 1, n - 1)]
    src = ids[rng.integers(0, n, m)]
    w = rng.integers(1, 50, m).astype(np.float32)
    return ids, src, dst, w


def test_pagerank_star():
    # hub 0 pointed at by 1..4: hub rank must dominate
    g, r = _graphs(vertex_ids=[0, 1, 2, 3, 4],
                   edge_src=[1, 2, 3, 4], edge_dst=[0, 0, 0, 0])
    pr = g.pagerank(num_iters=30)
    assert pr.dtype == torch.float32 and pr.device.type == "cpu"
    np.testing.assert_array_equal(_bits(pr.numpy()),
                                  _bits(r.pagerank(num_iters=30)))
    pr = pr.numpy()
    assert pr[0] > pr[1] and np.allclose(pr[1:], pr[1])
    assert pr[1] == pytest.approx(0.15)
    assert pr[0] == pytest.approx(0.15 + 0.85 * 4 * 0.15, rel=1e-5)


def test_pagerank_cycle_uniform():
    n = 8
    g, r = _graphs(vertex_ids=list(range(n)), edge_src=list(range(n)),
                   edge_dst=[(i + 1) % n for i in range(n)])
    pr = g.pagerank(num_iters=50).numpy()
    np.testing.assert_array_equal(_bits(pr), _bits(r.pagerank(num_iters=50)))
    assert np.allclose(pr, 1.0, atol=1e-4)


def test_pagerank_random_graph_bit_for_bit():
    ids, src, dst, _ = _random_graph()
    g, r = _graphs(ids, src, dst)
    got = g.pagerank(num_iters=20).numpy()
    np.testing.assert_array_equal(_bits(got),
                                  _bits(r.pagerank(num_iters=20)))
    np.testing.assert_array_equal(g.in_degree.numpy(),
                                  np.asarray(r.in_degree))
    np.testing.assert_array_equal(g.out_degree.numpy(),
                                  np.asarray(r.out_degree))


def test_pagerank_with_the_cards_merge(monkeypatch):
    """``seg_fsum``'s plain version (the card's merge: each sum rounded
    once) against the CPU's row-order adds: within the stated bound."""
    ids, src, dst, _ = _random_graph()
    g = PGraph(ids, src, dst, device="cpu")
    cpu = g.pagerank(num_iters=20).double()
    monkeypatch.setattr(PK, "_fsum_on", lambda t: True)
    card = g.pagerank(num_iters=20).double()
    bound = 20 * (g.in_degree.double() + 2) * 2.0 ** -24 * cpu
    assert bool(((card - cpu).abs() <= bound).all())
    assert not torch.equal(card, cpu)  # the merges do round differently


def test_connected_components():
    # two components {10,11,12} (chain) and {20,21}; singleton {30}
    g, r = _graphs(vertex_ids=[10, 11, 12, 20, 21, 30],
                   edge_src=[10, 11, 20], edge_dst=[11, 12, 21])
    labels = g.connected_components()
    np.testing.assert_array_equal(labels, r.connected_components())
    by_id = dict(zip(g.vertex_ids.tolist(), labels.tolist()))
    assert by_id[10] == by_id[11] == by_id[12] == 10
    assert by_id[20] == by_id[21] == 20
    assert by_id[30] == 30
    np.testing.assert_array_equal(g.connected_components(num_iters=1),
                                  r.connected_components(num_iters=1))


def test_connected_components_random():
    rng = np.random.default_rng(5)
    # 3 random blobs connected internally by random spanning chains
    ids, src, dst = [], [], []
    for b in range(3):
        nodes = list(range(b * 100, b * 100 + 30))
        ids.extend(nodes)
        perm = rng.permutation(nodes)
        src.extend(perm[:-1])
        dst.extend(perm[1:])
    g, r = _graphs(ids, src, dst)
    labels = g.connected_components()
    np.testing.assert_array_equal(labels, r.connected_components())
    by_id = dict(zip(g.vertex_ids.tolist(), labels.tolist()))
    for b in range(3):
        assert {by_id[v] for v in range(b * 100, b * 100 + 30)} == {b * 100}


def test_custom_pregel_shortest_path():
    """The one API difference: ``message`` and ``update`` take and
    return torch tensors (jax arrays in the reference)."""
    import jax.numpy as jnp

    args = dict(vertex_ids=[0, 1, 2, 3], edge_src=[0, 0, 1, 2],
                edge_dst=[1, 2, 3, 3], edge_attr=[1.0, 4.0, 1.0, 1.0])
    g, r = _graphs(**args)
    inf = 1e18
    out = g.pregel(torch.tensor([0.0, inf, inf, inf], dtype=torch.float64),
                   lambda d, w: d + w, torch.minimum, num_iters=4,
                   merge="min", default_msg=inf)
    want = r.pregel(jnp.asarray([0.0, inf, inf, inf]), lambda d, w: d + w,
                    jnp.minimum, num_iters=4, merge="min", default_msg=inf)
    assert out.tolist() == np.asarray(want).tolist() == [0.0, 1.0, 4.0, 2.0]


def test_custom_pregel_on_a_random_graph():
    """SSSP by ``min`` and the widest incoming weight by ``max``."""
    import jax.numpy as jnp

    ids, src, dst, w = _random_graph(seed=11)
    g, r = _graphs(ids, src, dst, edge_attr=w)
    inf = np.float32(3e38)
    init = np.full(len(ids), inf, np.float32)
    init[np.searchsorted(g.vertex_ids, ids[0])] = 0.0
    got = g.pregel(torch.from_numpy(init), lambda d, e: d + e,
                   torch.minimum, num_iters=12, merge="min",
                   default_msg=float(inf))
    want = r.pregel(jnp.asarray(init), lambda d, e: d + e, jnp.minimum,
                    num_iters=12, merge="min", default_msg=float(inf))
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    got = g.pregel(torch.zeros(len(ids)), lambda s, e: s + e,
                   lambda s, m: m, num_iters=1, merge="max",
                   default_msg=-1.0)
    want = r.pregel(jnp.zeros(len(ids), jnp.float32), lambda s, e: s + e,
                    lambda s, m: m, num_iters=1, merge="max",
                    default_msg=-1.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_triangle_count():
    # triangle 0-1-2 plus a dangling edge 2-3
    g, r = _graphs(vertex_ids=[0, 1, 2, 3], edge_src=[0, 1, 2, 2],
                   edge_dst=[1, 2, 0, 3])
    assert g.triangle_count() == r.triangle_count() == 1
    ids, src, dst, _ = _random_graph(n=120, m=900, seed=4)
    g, r = _graphs(ids, src, dst)
    assert g.triangle_count() == r.triangle_count() > 10


def test_graph_checks_and_device():
    with pytest.raises(ValueError, match="duplicate vertex ids"):
        PGraph([1, 1, 2], [1], [2], device="cpu")
    with pytest.raises(ValueError, match="unknown vertex ids"):
        PGraph([1, 2], [1], [3], device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            PGraph([1, 2], [1], [2])
