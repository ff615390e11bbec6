"""Network layouts and layout-derived edge lengths.

Reference semantics (safepy/safe_io.py:288-333):

  * ``spring_embedded`` -> ``nx.spring_layout(G, k=0.2, iterations=100, seed=seed)``;
    ``kamada_kawai`` -> ``nx.kamada_kawai_layout(G)``. Coordinates land in the 'x'
    and 'y' node attributes. NetworkX stays the engine for these so that seeded
    layouts agree with the reference bit-for-bit.
  * ``spring_device`` (new) — the same Fruchterman-Reingold iteration scheme executed as
    dense JAX ops on the accelerator, for networks where the host layout becomes the
    bottleneck. Matches nx's dense implementation scheme (seeded uniform init,
    k=0.2, 100 iterations, linearly cooling temperature) but is NOT bit-identical.
  * edge lengths = Euclidean distance between endpoint layout coordinates, stored in
    the 'length' edge attribute (the weights used by shortpath_weighted_layout).
"""

from __future__ import annotations

import logging

import networkx as nx
import numpy as np


def apply_network_layout(G, layout: str = "kamada_kawai", seed=None, verbose: bool = True):
    """Compute node coordinates and store them as 'x'/'y' node attributes."""

    if layout == "kamada_kawai":
        if verbose:
            logging.info("Applying the Kamada-Kawai network layout... (may take several minutes)")
        pos = nx.kamada_kawai_layout(G)
    elif layout == "spring_embedded":
        if verbose:
            logging.info("Applying the spring-embedded network layout... (may take several minutes)")
        pos = nx.spring_layout(G, k=0.2, iterations=100, seed=seed)
    elif layout == "spring_device":
        if verbose:
            logging.info("Applying the device spring-embedded network layout...")
        pos = spring_layout_device(G, k=0.2, iterations=100, seed=seed)
    else:
        raise ValueError(f"unknown layout: {layout!r}")

    for n in G:
        G.nodes[n]["x"] = pos[n][0]
        G.nodes[n]["y"] = pos[n][1]

    return G


# above this many nodes the dense (N, N) force matrix stops paying (40 GB at
# 100k) and spring_layout_device switches to the tiled engine below
DENSE_LAYOUT_MAX_NODES = 8192


def spring_layout_device(G, k: float = 0.2, iterations: int = 100, seed=None,
                      method: str = "auto"):
    """Accelerator spring layout, mirroring networkx's method selection.

    ``method='auto'`` follows modern nx ``spring_layout``: classic
    Fruchterman-Reingold force iteration below 500 nodes, the integrated-
    energy minimizer at and above it (nx switched because the energy form
    untangles far better — see :func:`spring_layout_energy_device`). 'force'
    and 'energy' select explicitly. The force path runs dense (N, N) up to
    ``DENSE_LAYOUT_MAX_NODES`` and the tiled sampled-repulsor variant above;
    the energy path is exact to 4096 nodes and sampled beyond. All scale to
    band-storage networks (100k+ nodes) in seconds on device — the step the
    reference runs as host networkx in minutes-to-hours (safe_io.py:302).

    nx's ``iterations`` counts L-BFGS steps for the energy method; the Adam
    optimizer here takes smaller steps, so the energy path runs
    ``10 x iterations`` — at the default 100 that lands within the quality
    pin of nx's result (tests/test_layout_quality.py).
    """
    nodes = list(G)
    n = len(nodes)
    index = {u: i for i, u in enumerate(nodes)}
    edges = np.asarray([(index[u], index[v]) for u, v in G.edges()],
                       np.int64).reshape(-1, 2)
    if method == "auto":
        method = "force" if n < 500 else "energy"
    if method == "energy":
        out = spring_layout_energy_device(n, edges, k=k,
                                       iterations=10 * iterations, seed=seed)
    elif n > DENSE_LAYOUT_MAX_NODES:
        out = spring_layout_device_tiled(n, edges, k=k, iterations=iterations,
                                      seed=seed)
    else:
        out = _spring_dense(n, edges, k=k, iterations=iterations, seed=seed)
    return {u: out[index[u]] for u in nodes}


def _spring_dense(n, edges, *, k, iterations, seed):
    import jax
    import jax.numpy as jnp

    adj = np.zeros((n, n), np.float32)
    adj[edges[:, 0], edges[:, 1]] = 1.0
    adj[edges[:, 1], edges[:, 0]] = 1.0

    rng = np.random.default_rng(seed)
    pos0 = rng.uniform(0.0, 1.0, (n, 2)).astype(np.float32)

    t0 = 0.1
    dt = t0 / (iterations + 1)

    @jax.jit
    def run(pos, a):
        def body(i, pos):
            delta = pos[:, None, :] - pos[None, :, :]
            dist = jnp.sqrt(jnp.sum(delta * delta, axis=-1))
            dist = jnp.maximum(dist, 0.01)
            force = (k * k / (dist * dist)) - a * dist / k
            disp = jnp.sum(delta * force[..., None], axis=1)
            # nx's movement rule: every node moves exactly the temperature t
            # along its net-force direction (tiny forces get a 0.1 floor so
            # they still jitter) — networkx _fruchterman_reingold
            length = jnp.sqrt(jnp.sum(disp * disp, axis=-1))
            length = jnp.where(length < 0.01, 0.1, length)
            t = t0 - i * dt
            return pos + disp * (t / length)[:, None]

        return jax.lax.fori_loop(0, iterations, body, pos)

    return np.asarray(run(jnp.asarray(pos0), jnp.asarray(adj)))


def spring_layout_device_tiled(n, edges, *, k: float = 0.2,
                            iterations: int = 100, seed=None,
                            repulsors: int = 512):
    """O(N * M)-per-iteration Fruchterman-Reingold for band-storage-scale
    networks: exact attraction over the O(E) edge list (scatter-add), and an
    UNBIASED minibatch estimate of the O(N^2) repulsion — each iteration
    samples ``repulsors`` nodes and scales their summed k^2/d^2 push by
    N/repulsors. Same cooling schedule and force laws as the dense engine, so
    the two converge to layouts with equivalent neighborhood structure (the
    quality pin in tests/test_layout_quality.py asserts this).

    Args:
      n: node count; edges: (E, 2) int array (0..n-1 node ids).
    Returns (n, 2) f32 coordinates.
    """
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    pos0 = rng.uniform(0.0, 1.0, (n, 2)).astype(np.float32)
    key0 = jax.random.PRNGKey(int(rng.integers(2 ** 31 - 1)))
    u = jnp.asarray(edges[:, 0], jnp.int32)
    v = jnp.asarray(edges[:, 1], jnp.int32)

    t0 = 0.1
    dt = t0 / (iterations + 1)
    m = int(min(repulsors, n))
    scale = n / m

    @jax.jit
    def run(pos, key):
        def body(i, carry):
            pos, key = carry
            key, sub = jax.random.split(key)
            # repulsion against a fresh node minibatch (unbiased estimator)
            idx = jax.random.randint(sub, (m,), 0, n)
            reps = jnp.take(pos, idx, axis=0)                    # (m, 2)
            delta = pos[:, None, :] - reps[None, :, :]           # (n, m, 2)
            d2 = jnp.maximum(jnp.sum(delta * delta, axis=-1), 0.01 ** 2)
            disp = scale * k * k * jnp.sum(delta / d2[..., None], axis=1)
            # exact attraction over the edge list: d^2/k along each edge
            de = jnp.take(pos, u, axis=0) - jnp.take(pos, v, axis=0)
            dist_e = jnp.sqrt(jnp.maximum(jnp.sum(de * de, axis=-1),
                                          0.01 ** 2))
            pull = de * (dist_e / k)[:, None]
            disp = disp.at[u].add(-pull).at[v].add(pull)
            # same movement rule as the dense engine (nx's: move exactly t)
            length = jnp.sqrt(jnp.sum(disp * disp, axis=-1))
            length = jnp.where(length < 0.01, 0.1, length)
            t = t0 - i * dt
            pos = pos + disp * (t / length)[:, None]
            return pos, key

        pos, _ = jax.lax.fori_loop(0, iterations, body, (pos, key))
        return pos

    return np.asarray(run(jnp.asarray(pos0), key0))


def spring_layout_energy_device(n, edges, *, k: float | None = None,
                             iterations: int = 500, seed=None,
                             repulsors: int = 2048, gravity: float = 1.0,
                             weights=None, exact_max_nodes: int = 4096):
    """Energy-based spring layout on the accelerator (modern networkx
    semantics: ``spring_layout`` minimizes the integrated Fruchterman-Reingold
    energy for graphs >= 500 nodes — networkx _energy_fruchterman_reingold,
    arXiv:2412.20317 — which untangles far better than force iteration).

    cost = sum_edges w * d^3 / (3k)  -  k^2 * sum_pairs log d  + gravity term
    grad_i = 2 * sum_j (A_ij d_ij / k - k^2 / d_ij^2) (x_i - x_j) + gravity

    nx minimizes with host L-BFGS over dense O(N^2) batches; here the
    gradient is evaluated on device and optimized with Adam under a cosine
    step decay — exact over all pairs up to ``exact_max_nodes``, and with an
    unbiased ``repulsors``-sample estimate of the repulsive sum above it
    (attraction stays exact over the O(E) edge list), so a 100k-node network
    lays out in seconds where host nx needs minutes-to-hours.

    Returns (n, 2) f32 coordinates (same frame as nx: unit square + gravity
    toward (0.5, 0.5) per connected component).
    """
    import jax
    import jax.numpy as jnp

    if k is None:
        k = float(np.sqrt(1.0 / max(1, n)))
    rng = np.random.default_rng(seed)
    pos0 = rng.uniform(0.0, 1.0, (n, 2)).astype(np.float32)
    key0 = jax.random.PRNGKey(int(rng.integers(2 ** 31 - 1)))

    edges = np.asarray(edges, np.int64).reshape(-1, 2)
    w = (np.ones(len(edges), np.float32) if weights is None
         else np.asarray(weights, np.float32))
    # symmetrized half-weight per direction matches nx's (A + A.T) / 2
    u = jnp.asarray(edges[:, 0], jnp.int32)
    v = jnp.asarray(edges[:, 1], jnp.int32)
    we = jnp.asarray(w, jnp.float32)

    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components
    g = coo_matrix((np.ones(len(edges)), (edges[:, 0], edges[:, 1])),
                   shape=(n, n))
    ncomp, labels = connected_components(g, directed=False)
    labels_dev = jnp.asarray(labels, jnp.int32)
    bincount = jnp.asarray(np.bincount(labels, minlength=ncomp), jnp.float32)

    exact = n <= exact_max_nodes
    m = n if exact else int(min(repulsors, n))
    scale = n / m

    def grad_fn(pos, key):
        # repulsion: -2 k^2 sum_j delta / d^2  (exact or sampled-unbiased)
        if exact:
            reps = pos
        else:
            idx = jax.random.randint(key, (m,), 0, n)
            reps = jnp.take(pos, idx, axis=0)
        delta = pos[:, None, :] - reps[None, :, :]
        d2 = jnp.maximum(jnp.sum(delta * delta, axis=-1), 1e-10)
        grad = -2.0 * scale * k * k * jnp.sum(delta / d2[..., None], axis=1)
        # attraction: 2 sum_edges w d / k * delta, exact over the edge list
        de = jnp.take(pos, u, axis=0) - jnp.take(pos, v, axis=0)
        dist_e = jnp.sqrt(jnp.maximum(jnp.sum(de * de, axis=-1), 1e-10))
        pull = de * (2.0 * we * dist_e / k)[:, None]
        grad = grad.at[u].add(pull).at[v].add(-pull)
        # gravity toward (0.5, 0.5) per connected component centroid
        centers = jnp.zeros((ncomp, 2), jnp.float32).at[labels_dev].add(pos)
        delta0 = centers / bincount[:, None] - 0.5
        return grad + gravity * jnp.take(delta0, labels_dev, axis=0)

    # Adam with cosine step decay — the step is in layout units (frame ~ 1)
    lr0 = 0.05
    b1, b2, eps = 0.9, 0.999, 1e-8

    @jax.jit
    def run(pos, key):
        mom = jnp.zeros_like(pos)
        vel = jnp.zeros_like(pos)

        def body(i, carry):
            pos, mom, vel, key = carry
            key, sub = jax.random.split(key)
            gr = grad_fn(pos, sub)
            mom = b1 * mom + (1 - b1) * gr
            vel = b2 * vel + (1 - b2) * gr * gr
            ti = (i + 1).astype(jnp.float32)
            mhat = mom / (1 - b1 ** ti)
            vhat = vel / (1 - b2 ** ti)
            lr = lr0 * 0.5 * (1 + jnp.cos(jnp.pi * i / iterations))
            pos = pos - lr * mhat / (jnp.sqrt(vhat) + eps)
            return pos, mom, vel, key

        pos, _, _, _ = jax.lax.fori_loop(0, iterations, body,
                                         (pos, mom, vel, key))
        return pos

    return np.asarray(run(jnp.asarray(pos0), key0))


def calculate_edge_lengths(G, verbose: bool = True):
    """Layout distance x edge weight -> 'length' edge attribute (f64 host math).

    The reference multiplies a dense N x N pdist by ``nx.adjacency_matrix`` —
    which carries the 'weight' edge attribute, 1 where absent — and keeps the
    non-NaN entries (safe_io.py:318-331). Endpoint-indexed math here is
    equivalent and O(E): length(u, v) = euclidean(u, v) * weight(u, v).
    """
    if verbose:
        logging.info("Calculating edge lengths...")

    xs = dict(G.nodes.data("x"))
    ys = dict(G.nodes.data("y"))
    lengths = {}
    for u, v, data in G.edges(data=True):
        dist = float(np.hypot(xs[u] - xs[v], ys[u] - ys[v]))
        lengths[(u, v)] = dist * float(data.get("weight", 1))
    nx.set_edge_attributes(G, lengths, "length")
    return G
