"""Banded radius-bounded FW: exact within the radius, pinned vs scipy Dijkstra."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from scipy.sparse import coo_matrix
from scipy.sparse.csgraph import shortest_path

from safepy_tpu.ops import apsp_banded as ab
from safepy_tpu.ops.apsp import pad_distances
from safepy_tpu.ops.neighborhoods import dense_initial_distances, inclusive_radius


def _geometric_graph(n, k, seed):
    rng = np.random.default_rng(seed)
    coords = rng.uniform(-1, 1, (n, 2))
    from scipy.spatial import cKDTree
    _, nn = cKDTree(coords).query(coords, k=k)
    edges = sorted({(min(i, int(j)), max(i, int(j)))
                    for i in range(n) for j in nn[i, 1:]})
    edges = np.array(edges)
    w = np.hypot(coords[edges[:, 0], 0] - coords[edges[:, 1], 0],
                 coords[edges[:, 0], 1] - coords[edges[:, 1], 1])
    return coords, edges, w


def _oracle(n, edges, w):
    A = coo_matrix((w, tuple(edges.T)), shape=(n, n))
    return shortest_path(A.maximum(A.T), method="D", directed=False)


@pytest.mark.parametrize("seed", [0, 3])
def test_banded_matches_oracle_within_radius(seed):
    n, block = 600, 64
    coords, edges, w = _geometric_graph(n, 7, seed)
    nr = 0.1 * (coords[:, 0].max() - coords[:, 0].min())

    order, band = ab.banded_order(coords, nr)
    assert band < n  # the ordering finds real locality on a geometric graph

    inv = np.empty(n, dtype=np.int64)
    inv[order] = np.arange(n)
    d0 = dense_initial_distances(n, inv[edges], w, dtype=np.float32)
    window = ab.window_width(n, band, block)
    d = pad_distances(jnp.asarray(d0), block)
    out = np.asarray(ab.apsp_banded_fw(d, window=window, block=block))[:n, :n]
    dist = out[inv][:, inv]  # back to original node frame

    ref = _oracle(n, edges, w)
    r = float(inclusive_radius(nr))

    # the thresholded indicator is exact EVERYWHERE
    np.testing.assert_array_equal(dist <= r, ref <= r)
    # within the radius the distances themselves are exact (f32 tolerance)
    inside = ref <= nr
    np.testing.assert_allclose(dist[inside], ref[inside], rtol=1e-5, atol=1e-6)
    # outside, the banded result only ever over-estimates
    outside = ~inside & np.isfinite(ref)
    assert (dist[outside] >= ref[outside] * (1 - 1e-5)).all()


def test_band_certificate():
    coords, _, _ = _geometric_graph(400, 6, 1)
    nr = 0.3
    order, band = ab.banded_order(coords, nr)
    rank = np.empty(len(order), dtype=np.int64)
    rank[order] = np.arange(len(order))
    from scipy.spatial import cKDTree
    pairs = cKDTree(coords).query_pairs(nr, output_type="ndarray")
    separations = np.abs(rank[pairs[:, 0]] - rank[pairs[:, 1]])
    assert separations.max() == band  # the certificate is tight and correct


def test_window_width_caps_at_matrix():
    assert ab.window_width(512, 1000, 128) == 512  # capped at npad
    assert ab.window_width(4096, 200, 128) == 640  # 2*200+128=528 -> next block


def test_facade_banded_matches_full(tmp_path):
    """apsp_mode='auto' (banded) and 'full' produce identical neighborhoods,
    statistics, and radius-masked distances through the whole facade."""
    import pandas as pd
    from safepy_tpu import SAFE

    rng = np.random.default_rng(2)
    coords, edges, w = _geometric_graph(300, 6, 2)
    net = tmp_path / "net.txt"
    with open(net, "w") as f:
        for a, b in edges:
            f.write(f"g{a}\tg{b}\t1.0\n")
    attrs = pd.DataFrame({"q": rng.normal(size=300)},
                         index=[f"g{i}" for i in range(300)])

    def run(mode):
        sf = SAFE(verbose=False)
        sf.apsp_mode = mode
        sf.random_seed = 5
        sf.load_network(network_file=str(net), node_key_attribute="key")
        sf.load_attributes(attribute_file=attrs)
        sf.run_pipeline(num_permutations=60)
        return sf

    full = run("full")
    banded = run("auto")
    np.testing.assert_array_equal(full.neighborhoods, banded.neighborhoods)
    np.testing.assert_array_equal(full.pvalues_pos, banded.pvalues_pos)
    r = float(inclusive_radius(
        full.neighborhood_radius
        * (np.max([full.graph.nodes[i]["x"] for i in full.graph])
           - np.min([full.graph.nodes[i]["x"] for i in full.graph]))))
    inside = full.node_distances <= r
    # inside the radius the banded distances are the exact ones
    np.testing.assert_allclose(banded.node_distances[inside],
                               full.node_distances[inside],
                               rtol=1e-6, atol=1e-6)
    # outside they are masked to inf (the reference's Dijkstra-cutoff semantics)
    assert np.isinf(banded.node_distances[~inside]).all()

    # the staged path takes the same plan
    banded_staged = SAFE(verbose=False)
    banded_staged.random_seed = 5
    banded_staged.load_network(network_file=str(net), node_key_attribute="key")
    banded_staged.define_neighborhoods()
    np.testing.assert_array_equal(banded_staged.neighborhoods,
                                  full.neighborhoods)


@pytest.mark.parametrize("seed,n,block", [(0, 420, 32), (1, 333, 64)])
def test_banded_symmetric_kernel_bit_identical(seed, n, block):
    """The window FW with the Triton-route kernel (Pallas interpreter) is
    BIT-identical to the jnp tile relax, and both are bit-identical to
    relaxing every in-band tile without the mirror: both pivot panels are
    the raw panel relaxed once against the bitwise-symmetric closed
    diagonal, so q == p.T exactly and the mirrored products are the same
    f32 sums."""
    from safepy_tpu.ops import minplus

    coords, edges, w = _geometric_graph(n, 6, seed)
    nr = 0.15 * (coords[:, 0].max() - coords[:, 0].min())
    order, band = ab.banded_order(coords, nr * (1 + 1e-5))
    inv = np.empty(n, dtype=np.int64)
    inv[order] = np.arange(n)
    d0 = dense_initial_distances(n, inv[edges], w, dtype=np.float32)
    window = ab.window_width(n, band, block)
    d = pad_distances(jnp.asarray(d0), block)
    jnp_out = np.asarray(ab.apsp_banded_fw(d, window=window, block=block,
                                           impl="jnp"))
    kernel = np.asarray(ab.apsp_banded_fw(d, window=window, block=block,
                                          impl="interpret"))
    np.testing.assert_array_equal(kernel, jnp_out)

    # whole in-band window relax, no mirror
    npad = d.shape[0]
    half = (window - block) // 2
    band_tiles = half // block + 3
    tiles = np.arange(window) // block
    keep = np.abs(tiles[:, None] - tiles[None, :]) <= band_tiles

    def round_body(kb, dd):
        start = kb * block
        lo = jnp.clip(start - half, 0, npad - window)
        p = jax.lax.dynamic_slice(dd, (start, lo), (block, window))
        diag = minplus.close_tile(
            jax.lax.dynamic_slice(dd, (start, start), (block, block)),
            impl="jnp")
        p = minplus.relax_jnp(p, diag, p)
        q = jax.lax.dynamic_slice(dd, (lo, start), (window, block))
        q = minplus.relax_jnp(q, q, diag)
        win = jax.lax.dynamic_slice(dd, (lo, lo), (window, window))
        win = jnp.where(keep, minplus.relax_jnp(win, q, p), win)
        return jax.lax.dynamic_update_slice(dd, win, (lo, lo))

    whole = np.asarray(jax.lax.fori_loop(0, npad // block, round_body, d))
    np.testing.assert_array_equal(jnp_out, whole)


def test_window_bound_path_certifies(seed=3):
    """The O(n log n) window bound (banded_order's large-n fast path) is a
    VALID certificate: >= the measured max rank separation of every actual
    radius pair, and close to it on isotropic layouts."""
    rng = np.random.default_rng(seed)
    coords = rng.uniform(-1, 1, (3000, 2))
    nr = 0.11
    order, band = ab.banded_order(coords, nr, exact_below=0)  # force bound
    rank = np.empty(len(order), dtype=np.int64)
    rank[order] = np.arange(len(order))
    from scipy.spatial import cKDTree
    pairs = cKDTree(coords).query_pairs(nr, output_type="ndarray")
    measured = int(np.abs(rank[pairs[:, 0]] - rank[pairs[:, 1]]).max())
    assert band >= measured  # certificate holds
    assert band <= int(1.25 * measured) + 8  # and is not uselessly loose
    # exact path still returns the measured width on the same input
    _, band_exact = ab.banded_order(coords, nr, exact_below=10**9)
    assert band_exact <= band


def test_window_bound_inconclusive_falls_back_to_exact():
    """A cross (dense vertical + horizontal strips) defeats BOTH axis
    windows (> n/8 each), so the fast path must fall back to the exact pair
    measurement, where Hilbert/x/y compete on measured widths."""
    rng = np.random.default_rng(0)
    m = 1000
    vert = np.stack([rng.normal(0, 1e-3, m), rng.uniform(-1, 1, m)], 1)
    horz = np.stack([rng.uniform(-1, 1, m), rng.normal(0, 1e-3, m)], 1)
    coords = np.concatenate([vert, horz])
    nr = 0.05
    order, band = ab.banded_order(coords, nr, exact_below=100)
    rank = np.empty(len(order), dtype=np.int64)
    rank[order] = np.arange(len(order))
    from scipy.spatial import cKDTree
    pairs = cKDTree(coords).query_pairs(nr, output_type="ndarray")
    assert int(np.abs(rank[pairs[:, 0]] - rank[pairs[:, 1]]).max()) == band
