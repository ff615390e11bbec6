"""All-pairs shortest paths as dense min-plus linear algebra.

The reference computes neighborhoods with N sequential NetworkX Dijkstra runs
(safepy/safe.py:406-410) — an interpreted host hot loop. Here the graph is a dense
(N, N) distance-initialized matrix (inf off-edge, 0 diagonal, edge length on-edge) and
APSP is tropical-semiring matrix algebra on the device:

  * :func:`apsp` — public entry: panel-blocked Floyd-Warshall
    (:func:`apsp_blocked_fw`) whose tile relaxations run through
    ``ops/minplus.py``, or the textbook one-pivot-per-step FW as a small oracle.
  * :func:`min_plus_product` — one min-plus matrix product.

Semantics notes (parity with the reference):
  * unreachable pairs stay ``+inf`` — thresholding a full distance matrix at radius r
    is then equivalent to the reference's Dijkstra-with-cutoff reachability test
    (``cutoff=nr`` keeps paths with length <= nr, see safe.py:406-410);
  * the diagonal is 0, so every node lands in its own neighborhood — matching the
    reference's deliberately-commented-out ``fill_diagonal(..., 0)`` (safe.py:419-420).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from safepy_tpu.ops import minplus


def pad_distances(dist, block: int):
    """Pad an (N, N) distance matrix to a multiple of ``block``.

    Padding nodes are unreachable (inf rows/cols) with 0 self-distance, which keeps
    the tropical semiring identity structure intact.
    """
    n = dist.shape[0]
    m = (-n) % block
    if m == 0:
        return dist
    np_ = n + m
    out = jnp.full((np_, np_), jnp.inf, dist.dtype)
    out = out.at[:n, :n].set(dist)
    pad_idx = jnp.arange(n, np_)
    return out.at[pad_idx, pad_idx].set(0.0)


@jax.jit
def _apsp_jax(dist):
    """Textbook Floyd-Warshall, one pivot per step — a small-size oracle."""
    n = dist.shape[0]

    def body(k, d):
        col = jax.lax.dynamic_slice(d, (0, k), (n, 1))
        row = jax.lax.dynamic_slice(d, (k, 0), (1, n))
        return jnp.minimum(d, col + row)

    return jax.lax.fori_loop(0, n, body, dist)


@jax.jit
def _min_plus_jax(a, b):
    init = jnp.full((a.shape[0], b.shape[1]), jnp.inf, a.dtype)
    return minplus.relax_jnp(init, a, b)


def min_plus_product(a, b):
    """(a (x) b)[i, j] = min_k a[i, k] + b[k, j]."""
    return _min_plus_jax(jnp.asarray(a), jnp.asarray(b))


@functools.partial(jax.jit, static_argnames=("block", "symmetric", "impl"))
def apsp_blocked_fw(dist, *, block: int = 128, symmetric: bool = False,
                    impl: str = "jnp"):
    """All-pairs shortest paths via panel-blocked Floyd-Warshall.

    Per pivot round kb: (1) close the (T, T) diagonal tile, (2) relax the
    pivot row panel P = D[kb] and column panel Q = D[:, kb] against it (valid
    because the diagonal is closed), (3) relax the FULL matrix against
    Q (x) P. Relaxation is idempotent in the tropical semiring, so phase 3
    revisits the pivot panels harmlessly — one O(N^3) pass in all.

    ``symmetric=True`` (callers must guarantee a symmetric ``dist`` —
    undirected graphs) relaxes only each round's upper triangle and mirrors
    the lower (:func:`minplus.relax_upper`) — bit-identical, ~2x less work.
    """
    dist = jnp.asarray(dist, jnp.float32)
    n = dist.shape[0]
    d = pad_distances(dist, block)
    npad = d.shape[0]
    nb = npad // block

    def round_body(kb, d):
        start = kb * block
        p = jax.lax.dynamic_slice(d, (start, 0), (block, npad))
        diag = jax.lax.dynamic_slice(p, (0, start), (block, block))
        diag = minplus.close_tile(diag, impl=impl)
        p = minplus.relax(p, diag, p, impl=impl)
        q = jax.lax.dynamic_slice(d, (0, start), (npad, block))
        q = minplus.relax(q, q, diag, impl=impl)
        if symmetric:
            return minplus.relax_upper(d, q, p, block=block, band_tiles=nb,
                                       impl=impl)
        return minplus.relax(d, q, p, impl=impl)

    d = jax.lax.fori_loop(0, nb, round_body, d)
    return d[:n, :n]


def apsp(dist, *, method: str = "fw", impl: str | None = None,
         block: int = 128, symmetric: bool = False):
    """All-pairs shortest path distances of a dense initialized distance matrix.

    Args:
      dist: (N, N) array — 0 diagonal, edge weight where an edge exists, inf
        elsewhere. 'fw' computes in f32; 'jax' in the input dtype.
      method: 'fw' (blocked Floyd-Warshall) or 'jax' (textbook FW oracle).
      impl: min-plus implementation (``ops/minplus.resolve``; default: the
        platform's).
      block: FW tile size.
      symmetric: the caller guarantees ``dist`` is symmetric (undirected
        graph); FW then relaxes only upper triangles and mirrors
        (bit-identical, ~2x less work).

    Returns:
      (N, N) shortest-path distances, inf where unreachable.
    """
    dist = jnp.asarray(dist)
    if method == "jax":
        return _apsp_jax(dist)
    if method == "fw":
        return apsp_blocked_fw(dist, block=block, symmetric=symmetric,
                               impl=minplus.resolve(impl))
    raise ValueError(f"unknown apsp method: {method!r}")
