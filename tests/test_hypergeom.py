"""Parity of the device hypergeometric survival function against the SciPy oracle.

The reference calls ``scipy.stats.hypergeom.sf(k - 1, M, K, n)`` elementwise
(safepy/safe.py:596); BASELINE.json pins <=1e-6 p-value deviation.
"""

import numpy as np
import pytest
from scipy import stats

from safepy_tpu.ops.hypergeom import hypergeom_sf, tail_iterations


def _oracle(k, M, K, n):
    return stats.hypergeom.sf(k - 1, M, K, n)


def test_small_grid_exact():
    M = 50
    ks, Ks, ns = np.meshgrid(np.arange(0, 20), np.arange(0, 50, 7), np.arange(1, 50, 11),
                             indexing="ij")
    got = np.asarray(hypergeom_sf(ks, M, Ks, ns))
    want = _oracle(ks, M, Ks, ns)
    np.testing.assert_allclose(got, want, atol=1e-9, rtol=1e-9)


def test_costanzo_scale_random(rng):
    M = 3971
    A = 60
    N = 50
    K = rng.integers(0, M, size=(1, A))
    n = rng.integers(0, 1200, size=(N, 1))
    # counts: anywhere from 0 to min(K, n), including out-of-support extremes
    k = rng.integers(0, 1201, size=(N, A))
    k = np.minimum(k, np.minimum(K, n))
    got = np.asarray(hypergeom_sf(k, M, np.broadcast_to(K, (N, A)),
                                  np.broadcast_to(n, (N, A))))
    want = _oracle(k, M, K, n)
    np.testing.assert_allclose(got, want, atol=1e-6)
    # log-space parity where p is representable: the NES consumes -log10(p)
    pos = (want > 1e-280) & (got > 0)
    np.testing.assert_allclose(np.log10(got[pos]), np.log10(want[pos]), atol=1e-5)


def test_edge_cases():
    M = 100
    # k at/below support lower bound -> 1; above upper bound -> 0
    assert float(hypergeom_sf(0, M, 10, 5)) == 1.0
    assert float(hypergeom_sf(6, M, 10, 5)) == 0.0
    assert float(hypergeom_sf(11, M, 10, 50)) == 0.0
    # full-draw corner: n = M forces X = K
    np.testing.assert_allclose(float(hypergeom_sf(10, M, 10, M)), 1.0)
    # k = upper bound
    want = _oracle(np.array([5]), M, np.array([10]), np.array([5]))
    np.testing.assert_allclose(np.asarray(hypergeom_sf(5, M, 10, 5)), want, atol=1e-12)


def test_tail_iterations_bound():
    assert tail_iterations(4000, 4000) >= 300
    assert tail_iterations(4000, 16) <= 100
