"""APSP kernels vs the scipy.sparse.csgraph / NetworkX oracles."""

import jax.numpy as jnp
import networkx as nx
import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.csgraph as csgraph

from safepy_tpu.ops.apsp import apsp, min_plus_product, _apsp_jax, _min_plus_jax
from safepy_tpu.ops.neighborhoods import dense_initial_distances


def _random_weighted_graph(rng, n, p=0.05, weighted=True):
    g = nx.gnp_random_graph(n, p, seed=int(rng.integers(1 << 30)))
    edges = np.array(g.edges(), dtype=np.int64).reshape(-1, 2)
    weights = rng.uniform(0.1, 2.0, size=len(edges)) if weighted else None
    return edges, weights


def _oracle(n, edges, weights):
    w = np.ones(len(edges)) if weights is None else weights
    if len(edges) == 0:
        return np.where(np.eye(n, dtype=bool), 0.0, np.inf)
    m = sp.coo_matrix((w, (edges[:, 0], edges[:, 1])), shape=(n, n))
    return csgraph.shortest_path(m, directed=False)


@pytest.mark.parametrize("weighted", [True, False])
def test_apsp_jax_vs_scipy(rng, weighted):
    n = 120
    edges, weights = _random_weighted_graph(rng, n, weighted=weighted)
    d0 = dense_initial_distances(n, edges, weights, dtype=np.float64)
    got = np.asarray(apsp(d0, method="jax"))
    want = _oracle(n, edges, weights)
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_apsp_disconnected(rng):
    # two components; cross-component distances must stay inf
    edges = np.array([[0, 1], [1, 2], [3, 4]])
    d0 = dense_initial_distances(5, edges, None, dtype=np.float64)
    got = np.asarray(apsp(d0, method="jax"))
    assert np.isinf(got[0, 3]) and np.isinf(got[4, 2])
    assert got[0, 2] == 2.0
    np.testing.assert_array_equal(np.diag(got), 0.0)


def test_min_plus_jax(rng):
    a = rng.uniform(0, 5, size=(17, 23))
    b = rng.uniform(0, 5, size=(23, 9))
    got = np.asarray(_min_plus_jax(jnp.asarray(a), jnp.asarray(b)))
    want = np.min(a[:, :, None] + b[None, :, :], axis=1)
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("n,block", [(150, 64), (97, 32)])
def test_apsp_blocked_fw_interpret(rng, n, block):
    """Blocked FW with the Triton-route kernel in the Pallas interpreter:
    exact against scipy, and bit-identical to the jnp tile relax (sizes not
    multiples of the tile exercise the +inf padding)."""
    from safepy_tpu.ops.apsp import apsp_blocked_fw

    edges, weights = _random_weighted_graph(rng, n, p=0.04)
    d0 = dense_initial_distances(n, edges, weights)
    got = np.asarray(apsp_blocked_fw(jnp.asarray(d0), block=block,
                                     impl="interpret"))
    want = _oracle(n, edges, weights)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    ref = np.asarray(apsp_blocked_fw(jnp.asarray(d0), block=block,
                                     impl="jnp"))
    np.testing.assert_array_equal(got, ref)


def test_min_plus_product_dispatch(rng):
    a = rng.uniform(0, 5, size=(9, 12))
    b = rng.uniform(0, 5, size=(12, 7))
    got = np.asarray(min_plus_product(a, b))
    want = np.min(a[:, :, None] + b[None, :, :], axis=1)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    with pytest.raises(ValueError):
        apsp(np.zeros((4, 4)), method="bogus")


def test_apsp_blocked_fw_symmetric_bit_identical(rng):
    """symmetric=True (upper triangle + mirror transpose) is bit-identical to
    the classic kernel on symmetric inputs — both pivot panels are the raw
    panel relaxed once against the bitwise-symmetric closed diagonal, so
    q == p.T exactly (ops/minplus.relax_upper)."""
    from safepy_tpu.ops.apsp import apsp_blocked_fw

    n = 150
    edges, weights = _random_weighted_graph(rng, n, p=0.04)
    d0 = dense_initial_distances(n, edges, weights)
    classic = np.asarray(apsp_blocked_fw(jnp.asarray(d0), block=64,
                                         symmetric=False, impl="interpret"))
    sym = np.asarray(apsp_blocked_fw(jnp.asarray(d0), block=64,
                                     symmetric=True, impl="interpret"))
    np.testing.assert_array_equal(sym, classic)
