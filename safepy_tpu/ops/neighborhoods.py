"""Neighborhood indicator matrices for the three node-distance metrics.

Reference semantics (safepy/safe.py:369-430):

  * ``euclidean`` — pairwise layout distances, neighborhood = ``dist < r`` (strict),
    with r = ``neighborhood_radius * (max(x) - min(x))``.
  * ``shortpath_weighted_layout`` (default) — Dijkstra over edge attribute 'length'
    with ``cutoff = r`` (same relative radius): neighborhood = ``dist <= r``
    (NetworkX cutoff keeps paths with length <= cutoff).
  * ``shortpath`` — unweighted hop distance with absolute cutoff
    ``r = neighborhood_radius``: neighborhood = ``hops <= r``.

The diagonal stays 1 (a node is in its own neighborhood): self-distance is 0 under
every metric, matching the reference's commented-out ``fill_diagonal`` (safe.py:419).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


@jax.jit
def euclidean_distance_matrix(coords):
    """Dense pairwise Euclidean distances of an (N, 2) coordinate array.

    The Gram product runs at HIGHEST precision: an f32 matmul may otherwise
    run in TF32 (~3 digits) on the GPU and move pairs across the radius."""
    coords = jnp.asarray(coords)
    sq = jnp.sum(coords * coords, axis=1)
    d2 = sq[:, None] + sq[None, :] - 2.0 * jnp.dot(
        coords, coords.T, precision=jax.lax.Precision.HIGHEST)
    d2 = jnp.maximum(d2, 0.0)
    d = jnp.sqrt(d2)
    # exact zero diagonal despite float cancellation
    n = coords.shape[0]
    return d * (1.0 - jnp.eye(n, dtype=d.dtype))


def neighborhoods_from_distances(dist, radius, *, strict: bool):
    """Indicator matrix: dist < r (euclidean) or dist <= r (shortest-path)."""
    dist = jnp.asarray(dist)
    r = jnp.asarray(radius, dist.dtype)
    ind = (dist < r) if strict else (dist <= r)
    return ind.astype(jnp.float32)


def inclusive_radius(nr: float) -> np.float32:
    """The f32 threshold for `dist <= nr` on f32 FW distances: one relative ulp
    of slack so f64-exact boundary paths (NetworkX keeps length <= cutoff,
    reference safe.py:406) don't fall out to f32 rounding."""
    return np.float32(nr) * np.float32(1 + 1e-6)


@functools.partial(jax.jit, static_argnames=("strict",))
def threshold_and_stats(dist, radius, *, strict: bool):
    """(indicator f32, mean size, std size) — the single source of truth for the
    neighborhood threshold, shared by the staged facade and the fused pipeline.
    The two scalars feed the reference's mean +/- std log line (safe.py:428)
    without downloading the N x N matrix."""
    nbr = neighborhoods_from_distances(dist, radius, strict=strict)
    sizes = jnp.sum(nbr, axis=1)
    return nbr, jnp.mean(sizes), jnp.std(sizes)


@functools.partial(jax.jit, static_argnames=("num_nodes",))
def _initial_distances_jit(u, v, w, *, num_nodes: int):
    i = jnp.arange(num_nodes)
    d = jnp.where(i[:, None] == i[None, :], 0.0, jnp.inf).astype(jnp.float32)
    d = d.at[u, v].min(w)
    return d.at[v, u].min(w)


def initial_distances_device(num_nodes: int, edges, weights=None):
    """Device-resident dense (N, N) FW initialization from an undirected edge
    list — the device counterpart of :func:`dense_initial_distances`.

    Only the O(E) edge arrays cross the host->device link; the N x N matrix is
    materialized on device (building it host-side costs a first-touch page
    fault per 4 KiB — measured ~15 s for 1.6 GB in this sandboxed runtime —
    plus the full matrix upload).
    """
    edges = np.asarray(edges)
    if edges.size == 0:
        n = num_nodes
        return jnp.where(jnp.arange(n)[:, None] == jnp.arange(n)[None, :],
                         0.0, jnp.inf).astype(jnp.float32)
    u = jnp.asarray(edges[:, 0], jnp.int32)
    v = jnp.asarray(edges[:, 1], jnp.int32)
    w = (jnp.ones(len(edges), jnp.float32) if weights is None
         else jnp.asarray(np.asarray(weights, dtype=np.float32)))
    return _initial_distances_jit(u, v, w, num_nodes=num_nodes)


def dense_initial_distances(num_nodes: int, edges, weights=None, dtype=np.float32) -> np.ndarray:
    """Host-side dense (N, N) FW initialization from an undirected edge list.

    inf off-edge, 0 diagonal, weight (or 1.0) on edges; symmetric. Parallel edges
    keep the minimum weight.
    """
    d = np.empty((num_nodes, num_nodes), dtype=dtype)
    # slice assignment, NOT d.fill()/np.full: both scalar-fill paths run at
    # ~100 MB/s in this NumPy build (measured 15-20 s for 1.6 GB at 20k nodes)
    # while the vectorized assignment streams at memory bandwidth (~0.5 s)
    d[:] = np.inf
    np.fill_diagonal(d, 0.0)
    edges = np.asarray(edges)
    if edges.size:
        u, v = edges[:, 0].astype(np.intp), edges[:, 1].astype(np.intp)
        # w MUST match d's dtype exactly: a dtype-mismatched ufunc.at takes the
        # buffered per-element path (measured ~18 s for 184k f64-into-f32
        # updates vs 0.04 s matched)
        w = (np.ones(len(u), dtype=dtype) if weights is None
             else np.asarray(weights, dtype=dtype))
        # min-reduce duplicates
        np.minimum.at(d, (u, v), w)
        np.minimum.at(d, (v, u), w)
    return d
