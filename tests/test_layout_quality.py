"""Quality pins for the accelerator spring layouts.

``spring_device`` (dense) and its tiled band-scale variant are NOT bit-identical
to networkx's Fruchterman-Reingold, but they must produce layouts with
comparable NEIGHBORHOOD structure — SAFE's whole default metric
(shortpath_weighted_layout, reference safe_io.py:302-331) is built on the
layout placing graph-adjacent nodes nearby. A silent regression in the force
math would previously have shipped invisibly (only determinism was tested).
"""

import networkx as nx
import numpy as np
import pytest

from safepy_tpu.io.layout import (_spring_dense, spring_layout_device,
                                  spring_layout_device_tiled)


def _geometric(n=700, k=6, seed=2):
    rng = np.random.default_rng(seed)
    coords = rng.uniform(-1, 1, (n, 2))
    from scipy.spatial import cKDTree
    _, nn = cKDTree(coords).query(coords, k=k)
    pairs = sorted({(min(i, int(j)), max(i, int(j)))
                    for i in range(n) for j in nn[i, 1:]})
    return np.asarray(pairs, np.int64)


def _preservation(coords, edges, n, L=15):
    """Fraction of graph edges whose endpoints are mutual layout-space
    L-nearest neighbors on at least one side — the neighborhood-structure
    statistic the SAFE metric depends on."""
    from scipy.spatial import cKDTree
    coords = np.asarray(coords, np.float64)
    _, nn = cKDTree(coords).query(coords, k=L + 1)
    nbr = [set(map(int, row[1:])) for row in nn]
    hits = sum(1 for u, v in edges if int(v) in nbr[u] or int(u) in nbr[v])
    return hits / max(1, len(edges))


@pytest.fixture(scope="module")
def problem():
    n = 700
    edges = _geometric(n)
    g = nx.Graph()
    g.add_nodes_from(range(n))
    g.add_edges_from(edges)
    # modern nx spring_layout auto-selects the ENERGY minimizer at >= 500
    # nodes; method="force" is the classic FR iteration our force engines
    # implement — pin each engine against its own nx counterpart
    pos_e = nx.spring_layout(g, k=0.2, iterations=100, seed=4)
    ref_energy = _preservation(np.array([pos_e[i] for i in range(n)]),
                               edges, n)
    pos_f = nx.spring_layout(g, k=0.2, iterations=100, seed=4,
                             method="force")
    ref_force = _preservation(np.array([pos_f[i] for i in range(n)]),
                              edges, n)
    return n, edges, g, ref_energy, ref_force


def test_spring_device_auto_matches_nx_quality(problem):
    """spring_device 'auto' (energy engine at this size) must land within 10%%
    of nx spring_layout's neighborhood preservation — a force-math or
    optimizer regression collapses this toward the ~0.1 of a random layout."""
    n, edges, g, ref_energy, _ = problem
    pos = spring_layout_device(g, seed=4)
    got = _preservation(np.array([pos[i] for i in range(n)]), edges, n)
    assert got >= 0.9 * ref_energy, (got, ref_energy)


def test_dense_force_engine_quality(problem):
    n, edges, g, _, ref_force = problem
    pos = spring_layout_device(g, seed=4, method="force")
    got = _preservation(np.array([pos[i] for i in range(n)]), edges, n)
    assert got >= 0.9 * ref_force, (got, ref_force)


def test_tiled_spring_quality(problem):
    n, edges, g, _, ref_force = problem
    coords = spring_layout_device_tiled(n, edges, seed=4, repulsors=128)
    got = _preservation(coords, edges, n)
    assert got >= 0.85 * ref_force, (got, ref_force)


def test_energy_sampled_matches_exact():
    """The sampled-repulsor energy gradient (band-scale mode) must not
    degrade the layout vs the exact all-pairs gradient."""
    from safepy_tpu.io.layout import spring_layout_energy_device

    n = 900
    edges = _geometric(n, seed=7)
    exact = spring_layout_energy_device(n, edges, k=0.2, iterations=1000, seed=5)
    sampled = spring_layout_energy_device(n, edges, k=0.2, iterations=1000,
                                       seed=5, exact_max_nodes=100,
                                       repulsors=256)
    p_exact = _preservation(exact, edges, n)
    p_sampled = _preservation(sampled, edges, n)
    assert p_sampled >= 0.9 * p_exact, (p_sampled, p_exact)


def test_tiled_matches_dense_statistically():
    """Tiled (sampled-repulsor) engine vs the exact dense engine on the same
    graph: equivalent neighborhood preservation, not a degraded one."""
    n = 900
    edges = _geometric(n, seed=7)
    dense = _spring_dense(n, edges, k=0.2, iterations=100, seed=5)
    tiled = spring_layout_device_tiled(n, edges, seed=5, repulsors=128)
    p_dense = _preservation(dense, edges, n)
    p_tiled = _preservation(tiled, edges, n)
    assert p_tiled >= 0.85 * p_dense, (p_tiled, p_dense)


def test_tiled_deterministic():
    n = 300
    edges = _geometric(n, seed=9)
    a = spring_layout_device_tiled(n, edges, seed=3)
    b = spring_layout_device_tiled(n, edges, seed=3)
    np.testing.assert_array_equal(a, b)
    c = spring_layout_device_tiled(n, edges, seed=4)
    assert not np.array_equal(a, c)


def test_dense_auto_switches_to_tiled(monkeypatch):
    """spring_layout_device must route big graphs to the tiled engine."""
    from safepy_tpu.io import layout as mod

    monkeypatch.setattr(mod, "DENSE_LAYOUT_MAX_NODES", 100)
    n = 200
    edges = _geometric(n, seed=11)
    g = nx.Graph()
    g.add_nodes_from(range(n))
    g.add_edges_from(edges)
    called = {}
    orig = mod.spring_layout_device_tiled

    def spy(*args, **kw):
        called["yes"] = True
        return orig(*args, **kw)

    monkeypatch.setattr(mod, "spring_layout_device_tiled", spy)
    pos = mod.spring_layout_device(g, seed=1)
    assert called.get("yes") and len(pos) == n
