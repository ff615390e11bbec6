"""Multi-device parity on the virtual 8-device CPU mesh: every sharded pipeline
must agree with its single-device counterpart."""

import jax
import jax.numpy as jnp
import networkx as nx
import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.csgraph as csgraph

from safepy_tpu.ops.apsp import apsp
from safepy_tpu.ops.neighborhoods import dense_initial_distances
from safepy_tpu.ops.permutation import run_permutations
from safepy_tpu.ops.score import compute_neighborhood_score
from safepy_tpu.parallel import (apsp_sharded, hypergeom_counts_sharded,
                                 make_mesh, run_permutations_sharded)


@pytest.fixture(scope="module")
def mesh8():
    assert len(jax.devices()) == 8, "conftest must provide 8 virtual devices"
    return make_mesh({"perm": 8})


@pytest.fixture(scope="module")
def mesh_data():
    return make_mesh({"data": 8})


def test_mesh_construction():
    m = make_mesh({"a": 2, "b": 4})
    assert m.shape == {"a": 2, "b": 4}
    with pytest.raises(ValueError):
        make_mesh({"a": 3})


def test_sharded_permutations_match_counts(rng, mesh8):
    n, a = 48, 3
    nbr = (rng.random((n, n)) < 0.2).astype(float)
    np.fill_diagonal(nbr, 1.0)
    n2a = rng.normal(size=(n, a))
    n2a[rng.random((n, a)) < 0.2] = np.nan
    valid = np.flatnonzero(np.sum(~np.isnan(n2a), axis=1))
    obs = compute_neighborhood_score(nbr, n2a, "sum")

    key = jax.random.PRNGKey(0)
    cn, cp, total = run_permutations_sharded(
        nbr, n2a, valid, obs, key, mesh=mesh8, num_permutations=160,
        score_type="sum")
    assert total == 160
    cn, cp = np.asarray(cn), np.asarray(cp)
    assert cn.shape == obs.shape
    assert (cn + cp >= total).all()
    assert cn.max() <= total and cp.max() <= total

    # statistical agreement with the single-device engine (independent keys)
    cn1, cp1 = run_permutations(nbr, n2a, valid, obs, jax.random.PRNGKey(1),
                                score_type="sum", num_permutations=160)
    p_sharded = cp / total
    p_single = np.asarray(cp1) / 160
    # same nulls: two independent 160-draw estimates differ by sigma ~ 0.056;
    # max over 144 cells stays within ~4.5 sigma
    assert np.nanmax(np.abs(p_sharded - p_single)) < 0.25


def test_sharded_permutations_round_up(rng, mesh8):
    n = 24
    nbr = np.eye(n)
    n2a = rng.normal(size=(n, 1))
    valid = np.arange(n)
    obs = compute_neighborhood_score(nbr, n2a, "sum")
    cn, cp, total = run_permutations_sharded(
        nbr, n2a, valid, obs, jax.random.PRNGKey(0), mesh=mesh8,
        num_permutations=100)
    assert total == 104  # ceil(100/8)*8, like the reference's worker rounding


def test_apsp_sharded_matches_oracle(rng, mesh_data):
    n = 100
    g = nx.gnp_random_graph(n, 0.06, seed=int(rng.integers(1 << 30)))
    edges = np.array(g.edges(), dtype=np.int64).reshape(-1, 2)
    w = rng.uniform(0.1, 2.0, size=len(edges))
    d0 = dense_initial_distances(n, edges, w)

    got = np.asarray(apsp_sharded(d0, mesh_data, block=16))
    m = sp.coo_matrix((w, (edges[:, 0], edges[:, 1])), shape=(n, n))
    want = csgraph.shortest_path(m, directed=False)
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_apsp_sharded_disconnected(mesh_data):
    edges = np.array([[0, 1], [2, 3]])
    d0 = dense_initial_distances(5, edges, None)
    got = np.asarray(apsp_sharded(d0, mesh_data, block=8))
    assert np.isinf(got[0, 2]) and got[0, 1] == 1.0 and np.isinf(got[4, 0])


def test_hypergeom_counts_sharded(rng):
    mesh = make_mesh({"attr": 8})
    n, a = 40, 16
    nbr = (rng.random((n, n)) < 0.3).astype(float)
    n2a = (rng.random((n, a)) < 0.2).astype(float)
    n2a[rng.random((n, a)) < 0.1] = np.nan

    counts, nsize = hypergeom_counts_sharded(nbr, n2a, mesh=mesh)
    want_counts = nbr @ np.nan_to_num(n2a)
    want_nsize = nbr @ np.any(~np.isnan(n2a), axis=1).astype(float)
    np.testing.assert_allclose(np.asarray(counts), want_counts, atol=1e-5)
    np.testing.assert_allclose(np.asarray(nsize), want_nsize, atol=1e-5)


def test_apsp_sharded_2d_matches_oracle():
    """2-D block-sharded FW vs scipy Dijkstra on the 8-device mesh."""
    import numpy as np
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import shortest_path

    from safepy_tpu.ops.neighborhoods import dense_initial_distances
    from safepy_tpu.parallel import apsp_sharded_2d, make_mesh

    rng = np.random.default_rng(6)
    n = 96
    coords = rng.uniform(0, 1, (n, 2))
    edges, weights = [], []
    for i in range(n):
        for j in range(i + 1, n):
            d = np.hypot(*(coords[i] - coords[j]))
            if d < 0.2:
                edges.append((i, j))
                weights.append(d)
    edges, weights = np.array(edges), np.array(weights)
    d0 = dense_initial_distances(n, edges, weights, dtype=np.float32)
    ref = shortest_path(
        coo_matrix((weights, tuple(edges.T)), shape=(n, n)).maximum(
            coo_matrix((weights, tuple(edges.T)), shape=(n, n)).T),
        method="D", directed=False)

    for axes in ({"row": 2, "col": 4}, {"row": 4, "col": 2}):
        mesh = make_mesh(axes)
        out = np.asarray(apsp_sharded_2d(d0, mesh, block=16))
        finite = np.isfinite(ref)
        np.testing.assert_allclose(out[finite], ref[finite],
                                   rtol=1e-5, atol=1e-6)
        assert np.isinf(out[~finite]).all()
