"""Band-STORAGE FW (O(N*W) memory): exactness within the radius, banded ops."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from scipy.sparse import coo_matrix
from scipy.sparse.csgraph import shortest_path

from safepy_tpu.ops import apsp_banded as ab
from safepy_tpu.ops import apsp_bandstore as bs
from safepy_tpu.ops.neighborhoods import dense_initial_distances, inclusive_radius


def _geometric_graph(n, k, seed, long_edges=0):
    """k-NN geometric graph; optional random LONG edges (weight = Euclidean
    endpoint distance, the shortpath_weighted_layout contract) to exercise the
    out-of-band edge drop."""
    rng = np.random.default_rng(seed)
    coords = rng.uniform(-1, 1, (n, 2))
    from scipy.spatial import cKDTree
    _, nn = cKDTree(coords).query(coords, k=k)
    pairs = {(min(i, int(j)), max(i, int(j)))
             for i in range(n) for j in nn[i, 1:]}
    for _ in range(long_edges):
        a, b = rng.integers(0, n, 2)
        if a != b:
            pairs.add((min(a, b), max(a, b)))
    edges = np.array(sorted(pairs))
    w = np.hypot(coords[edges[:, 0], 0] - coords[edges[:, 1], 0],
                 coords[edges[:, 0], 1] - coords[edges[:, 1], 1])
    return coords, edges, w


def _oracle(n, edges, w):
    A = coo_matrix((w, tuple(edges.T)), shape=(n, n))
    return shortest_path(A.maximum(A.T), method="D", directed=False)


def _banded_setup(n, k, seed, block, long_edges=0):
    coords, edges, w = _geometric_graph(n, k, seed, long_edges)
    nr = 0.1 * (coords[:, 0].max() - coords[:, 0].min())
    order, band = ab.banded_order(coords, nr * (1 + 1e-5))
    rank = np.empty(n, dtype=np.int64)
    rank[order] = np.arange(n)
    return coords, edges, w, nr, rank, band


def test_pack_unpack_roundtrip():
    rng = np.random.default_rng(0)
    n, band, block = 150, 40, 64
    dense = rng.uniform(1, 9, (n, n)).astype(np.float32)
    s = bs.pack_band(dense, band, block)
    back = bs.unpack_band(s, n, band, block)
    bt, _, _ = bs.band_params(n, band, block)
    tile_sep = np.abs(np.arange(n)[:, None] // block
                      - np.arange(n)[None, :] // block)
    in_band = tile_sep <= bt
    np.testing.assert_array_equal(back[in_band], dense[in_band])
    assert np.isinf(back[~in_band]).all()


def test_band_init_matches_dense_init():
    n, block = 300, 64
    _, edges, w, nr, rank, band = _banded_setup(n, 6, 0, block)
    pe = rank[edges]
    s = bs.band_init_from_edges(jnp.asarray(pe[:, 0], jnp.int32),
                                jnp.asarray(pe[:, 1], jnp.int32),
                                jnp.asarray(w, jnp.float32),
                                n=n, band=band, block=block)
    dense = dense_initial_distances(n, pe, w, dtype=np.float32)
    expect = bs.pack_band(dense, band, block)
    np.testing.assert_array_equal(np.asarray(s), np.asarray(expect))


@pytest.mark.parametrize("seed,long_edges", [(0, 0), (3, 25)])
def test_bandstore_fw_matches_oracle_within_radius(seed, long_edges):
    n, block = 600, 64
    coords, edges, w, nr, rank, band = _banded_setup(n, 7, seed, block,
                                                     long_edges)
    assert band < n
    pe = rank[edges]
    s = bs.band_init_from_edges(jnp.asarray(pe[:, 0], jnp.int32),
                                jnp.asarray(pe[:, 1], jnp.int32),
                                jnp.asarray(w, jnp.float32),
                                n=n, band=band, block=block)
    bt, _, _ = bs.band_params(n, band, block)
    out = bs.apsp_band_fw(s, bt=bt, block=block)
    dense = bs.unpack_band(out, n, band, block)
    dist = dense[rank][:, rank]  # back to the original node frame

    ref = _oracle(n, edges, w)
    r = float(inclusive_radius(nr))

    got_ind = dist <= r
    np.testing.assert_array_equal(got_ind, ref <= r)
    inside = ref <= nr
    np.testing.assert_allclose(dist[inside], ref[inside], rtol=1e-5, atol=1e-6)
    # everywhere else: genuine-path upper bounds (or inf out of band)
    outside = ~inside & np.isfinite(ref) & np.isfinite(dist)
    assert (dist[outside] >= ref[outside] * (1 - 1e-5)).all()


@pytest.mark.parametrize("n,block", [(384, 64), (333, 32)])
def test_bandstore_fw_pallas_interpret(n, block):
    """The Triton-route kernel (Pallas interpreter) relaxes the skewed wedge
    to the same bits as the jnp tile relax, over a whole band FW."""
    _, edges, w, nr, rank, band = _banded_setup(n, 6, 1, block)
    pe = rank[edges]
    s = bs.band_init_from_edges(jnp.asarray(pe[:, 0], jnp.int32),
                                jnp.asarray(pe[:, 1], jnp.int32),
                                jnp.asarray(w, jnp.float32),
                                n=n, band=band, block=block)
    bt, _, _ = bs.band_params(n, band, block)
    want = np.asarray(bs.apsp_band_fw(s, bt=bt, block=block, impl="jnp"))
    got = np.asarray(bs.apsp_band_fw(s, bt=bt, block=block,
                                     impl="interpret"))
    np.testing.assert_array_equal(got, want)


def _thresholded_band(n, k, seed, block):
    coords, edges, w, nr, rank, band = _banded_setup(n, k, seed, block)
    pe = rank[edges]
    s = bs.band_init_from_edges(jnp.asarray(pe[:, 0], jnp.int32),
                                jnp.asarray(pe[:, 1], jnp.int32),
                                jnp.asarray(w, jnp.float32),
                                n=n, band=band, block=block)
    bt, _, _ = bs.band_params(n, band, block)
    out = bs.apsp_band_fw(s, bt=bt, block=block)
    r = inclusive_radius(nr)
    s_ind = bs.band_threshold(out, r)
    dense_ind = (bs.unpack_band(out, n, band, block) <= float(r))
    return s_ind, dense_ind, rank, band, bt


def test_band_threshold_and_row_stats():
    n, block = 500, 64
    s_ind, dense_ind, rank, band, bt = _thresholded_band(n, 6, 2, block)
    sizes, mean, std = bs.band_row_stats(s_ind, n=n, bt=bt, block=block)
    want = dense_ind.sum(axis=1)
    np.testing.assert_array_equal(np.asarray(sizes), want)
    assert np.isclose(float(mean), want.mean())
    assert np.isclose(float(std), want.std())


def test_band_matmul_matches_dense():
    n, block, a_dim = 500, 64, 3
    s_ind, dense_ind, rank, band, bt = _thresholded_band(n, 6, 4, block)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(n, a_dim)).astype(np.float32)
    npad = -(-n // block) * block
    xp = np.zeros((npad, a_dim), np.float32)
    xp[:n] = x
    got = np.asarray(bs.band_matmul(s_ind, jnp.asarray(xp), bt=bt,
                                    block=block))[:n]
    want = dense_ind.astype(np.float32) @ x
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_compact_band_and_batch_matmul():
    """Column compaction + batched slab contraction == dense valid-column GEMM."""
    n, block, a_dim, c_dim = 500, 64, 2, 3
    s_ind, dense_ind, rank, band, bt = _thresholded_band(n, 6, 5, block)
    rng = np.random.default_rng(1)
    valid = rng.random(n) < 0.7  # permuted-frame validity mask
    v = int(valid.sum())

    compact, starts, w_c = bs.compact_band_columns(s_ind, valid, bt=bt,
                                                   block=block)
    vals = rng.normal(size=(c_dim, v, a_dim)).astype(np.float32)
    v_pad = v + w_c  # slack so starts[i] + w_c never overruns
    x_batch = np.zeros((c_dim, v_pad, a_dim), np.float32)
    x_batch[:, :v] = vals
    got = np.asarray(bs.band_matmul_batch(compact, jnp.asarray(x_batch),
                                          starts, bt=bt, block=block))[:, :n]

    dense_valid = dense_ind[:, valid].astype(np.float32)  # (n, V)
    want = np.einsum("nv,cva->cna", dense_valid, vals)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)


def test_euclidean_band_indicator_matches_distances():
    """The int8-direct euclidean indicator (the f32 band never materializes —
    the ~1M-point scatter ceiling lever) == thresholding the distance band,
    bitwise, including pad rows/cols and the exact-zero diagonal."""
    n, block = 450, 64
    rng = np.random.default_rng(3)
    coords = rng.uniform(-1, 1, (n, 2)).astype(np.float32)
    rank = np.argsort(coords[:, 0], kind="stable").argsort()
    cp = jnp.asarray(coords[np.argsort(rank)])
    for band, r in ((96, 0.11), (160, 0.2)):
        raw = bs.euclidean_band_distances(cp, n=n, band=band, block=block)
        want = np.asarray(raw < np.float32(r)).astype(np.int8)
        got = np.asarray(bs.euclidean_band_indicator(
            cp, np.float32(r), n=n, band=band, block=block))
        np.testing.assert_array_equal(got, want)


def test_apply_compaction_chunked_bit_identical():
    """Chunked compaction sorts (the giant-band memory lever — the stable
    sort's s32 iota tiebreaker can be full-array-sized) == single-shot, bitwise,
    including the backed-up overlapping last chunk."""
    n, block = 500, 64
    s_ind, dense_ind, rank, band, bt = _thresholded_band(n, 6, 5, block)
    rng = np.random.default_rng(2)
    valid = rng.random(n) < 0.6
    _, w_c = bs.compaction_plan(valid, n=n, bt=bt, block=block)
    one = bs.apply_compaction(s_ind, valid, w_c, bt=bt, block=block,
                              chunk_blocks=0)
    nbg = s_ind.shape[0] // block
    for cb in (1, 3, nbg, nbg + 7):  # 3 does not divide nbg -> overlap path
        got = bs.apply_compaction(s_ind, valid, w_c, bt=bt, block=block,
                                  chunk_blocks=cb)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(one))


# ---------------------------------------------------------------------------
# Sparse Bellman-Ford relaxation (apsp_band_bf)
# ---------------------------------------------------------------------------

def _bf_setup(n, k, seed, block, long_edges=0):
    coords, edges, w, nr, rank, band = _banded_setup(n, k, seed, block,
                                                     long_edges)
    pe = rank[edges]
    s0 = bs.band_init_from_edges(jnp.asarray(pe[:, 0], jnp.int32),
                                 jnp.asarray(pe[:, 1], jnp.int32),
                                 jnp.asarray(w, jnp.float32),
                                 n=n, band=band, block=block)
    bt, _, _ = bs.band_params(n, band, block)
    nbr, dlt, wgt, s_slots = bs.band_bf_slots(pe[:, 0], pe[:, 1], w,
                                              n=n, band=band, block=block)
    r = inclusive_radius(nr)
    return s0, (jnp.asarray(nbr), jnp.asarray(dlt), jnp.asarray(wgt)), \
        s_slots, bt, band, r


@pytest.mark.parametrize("seed,long_edges,stripe",
                         [(0, 0, 1024), (1, 5, 192), (2, 0, 64)])
def test_band_bf_matches_fw(seed, long_edges, stripe):
    """Sparse BF relaxation reaches the FW fixpoint: thresholded indicator
    bit-identical, within-radius distances equal to f32 association noise
    (reference semantics: safe.py:406-410 Dijkstra cutoff)."""
    n, block = 420, 64
    s0, slots, s_slots, bt, band, r = _bf_setup(n, 6, seed, block, long_edges)
    fw = bs.apsp_band_fw(s0, bt=bt, block=block)
    bf, conv, iters = bs.apsp_band_bf(s0, *slots, np.float32(r), bt=bt,
                                      block=block, max_iters=64,
                                      stripe=stripe)
    assert bool(conv)
    assert int(iters) < 64
    ind_fw = np.asarray(bs.band_threshold(fw, r))
    ind_bf = np.asarray(bs.band_threshold(bf, r))
    np.testing.assert_array_equal(ind_bf, ind_fw)
    fw_d = np.asarray(fw)
    bf_d = np.asarray(bf)
    inside = (fw_d <= float(r)) & np.isfinite(fw_d)
    np.testing.assert_allclose(bf_d[inside], fw_d[inside], rtol=1e-6,
                               atol=1e-7)
    # BF clamps beyond-radius entries to +inf (documented contract)
    assert np.isinf(bf_d[~inside]).all()


def test_band_bf_hop_metric():
    """Hop-count networks (reference safe.py:408-410): BF converges in
    ~radius rounds and matches FW bitwise."""
    n, block = 300, 64
    rng = np.random.default_rng(4)
    coords, edges, w_geo = _geometric_graph(n, 5, 4)
    w = np.ones(len(edges), np.float32)
    r = 2.0
    order, band = ab.graph_banded_order(n, edges, w, r * (1 + 1e-5))
    rank = np.empty(n, dtype=np.int64)
    rank[order] = np.arange(n)
    pe = rank[edges]
    s0 = bs.band_init_from_edges(jnp.asarray(pe[:, 0], jnp.int32),
                                 jnp.asarray(pe[:, 1], jnp.int32),
                                 jnp.asarray(w), n=n, band=band, block=block)
    bt, _, _ = bs.band_params(n, band, block)
    fw = bs.apsp_band_fw(s0, bt=bt, block=block)
    nbr, dlt, wgt, _ = bs.band_bf_slots(pe[:, 0], pe[:, 1], w, n=n,
                                        band=band, block=block)
    clamp = np.float32(r * (1 + 1e-6))
    bf, conv, iters = bs.apsp_band_bf(s0, jnp.asarray(nbr), jnp.asarray(dlt),
                                      jnp.asarray(wgt), clamp, bt=bt,
                                      block=block, max_iters=32)
    assert bool(conv)
    assert int(iters) <= int(r) + 1  # hop metric: exactly r relax rounds
    np.testing.assert_array_equal(np.asarray(bs.band_threshold(bf, clamp)),
                                  np.asarray(bs.band_threshold(fw, clamp)))


def test_band_bf_unconverged_fw_finisher():
    """max_iters too small -> converged False; FW from the partial BF state
    (admissible upper bounds) still reaches the exact fixpoint — the facade's
    fall-back contract."""
    n, block = 420, 64
    s0, slots, s_slots, bt, band, r = _bf_setup(n, 6, 3, block)
    fw = bs.apsp_band_fw(s0, bt=bt, block=block)
    bf, conv, _ = bs.apsp_band_bf(s0, *slots, np.float32(r), bt=bt,
                                  block=block, max_iters=1)
    assert not bool(conv)
    finished = bs.apsp_band_fw(bf, bt=bt, block=block)
    np.testing.assert_array_equal(np.asarray(bs.band_threshold(finished, r)),
                                  np.asarray(bs.band_threshold(fw, r)))


def test_bf_max_iters_budget():
    """The budget scales with the FW/BF cost ratio and stays in [floor, cap]."""
    small = bs.bf_max_iters(1000, 100, 12)
    big = bs.bf_max_iters(100_000, 2000, 16)
    assert 16 <= small <= 512
    assert 16 <= big <= 512
    assert big >= small  # wider bands make FW relatively more expensive


@pytest.mark.parametrize("seed,radius_frac", [(1, 0.1), (2, 0.18)])
def test_band_fw_symmetric_kernel_interpret(seed, radius_frac):
    """The symmetric window relax (upper wedge + mirror transpose, Triton
    kernel in the Pallas interpreter) reaches the same fixpoint as the
    whole-window relax: indicator bit-identical, within-radius distances
    equal to f32 association noise (the mirror swaps which operand saw the
    phase-2-relaxed pivot row, so bitwise equality is not expected
    mid-matrix)."""
    n, block = 420, 32  # small block -> bt 2-4, exercises the wedge logic
    rng = np.random.default_rng(seed)
    coords = rng.uniform(-1, 1, (n, 2))
    from scipy.spatial import cKDTree
    _, nn = cKDTree(coords).query(coords, k=6)
    pairs = {(min(i, int(j)), max(i, int(j)))
             for i in range(n) for j in nn[i, 1:]}
    edges = np.array(sorted(pairs))
    w = np.hypot(*(coords[edges[:, 0]] - coords[edges[:, 1]]).T)
    nr = radius_frac * (coords[:, 0].max() - coords[:, 0].min())
    order, band = ab.banded_order(coords, nr * (1 + 1e-5))
    rank = np.empty(n, np.int64)
    rank[order] = np.arange(n)
    pe = rank[edges]
    s0 = bs.band_init_from_edges(jnp.asarray(pe[:, 0], jnp.int32),
                                 jnp.asarray(pe[:, 1], jnp.int32),
                                 jnp.asarray(w, jnp.float32),
                                 n=n, band=band, block=block)
    bt, _, _ = bs.band_params(n, band, block)
    assert bt >= 2
    r = inclusive_radius(nr)
    want = np.asarray(bs.apsp_band_fw_whole(s0, bt=bt, block=block))
    sym = np.asarray(bs.apsp_band_fw(s0, bt=bt, block=block,
                                     impl="interpret"))
    np.testing.assert_array_equal(
        np.asarray(bs.band_threshold(jnp.asarray(sym), r)),
        np.asarray(bs.band_threshold(jnp.asarray(want), r)))
    inside = (want <= float(r)) & np.isfinite(want)
    np.testing.assert_allclose(sym[inside], want[inside], rtol=1e-6,
                               atol=1e-7)
    # within-radius entries are ulp-symmetric (beyond-radius upper bounds
    # may differ across the diagonal — they are junk both ways)
    dense = bs.unpack_band(sym, n, band, block)
    ins = (dense <= float(r)) & np.isfinite(dense)
    sym_pairs = ins & ins.T
    np.testing.assert_allclose(dense[sym_pairs], dense.T[sym_pairs],
                               rtol=1e-6, atol=1e-7)
