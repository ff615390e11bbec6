"""Row-sharded band-storage FW == the single-device band engine (8-dev mesh)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from safepy_tpu.ops import apsp_banded as ab
from safepy_tpu.ops import apsp_bandstore as bs
from safepy_tpu.parallel import band_sharded as bsh

from tests.test_apsp_bandstore import _geometric_graph, _oracle


def _mesh(ndev, axis="data"):
    devs = jax.devices()[:ndev]
    return Mesh(np.array(devs), (axis,))


def _setup(n, k, seed, block=64):
    coords, edges, w = _geometric_graph(n, k, seed)
    nr = 0.1 * (coords[:, 0].max() - coords[:, 0].min())
    order, band = ab.banded_order(coords, nr * (1 + 1e-5))
    rank = np.empty(n, dtype=np.int64)
    rank[order] = np.arange(n)
    pe = rank[edges]
    s = bs.band_init_from_edges(jnp.asarray(pe[:, 0], jnp.int32),
                                jnp.asarray(pe[:, 1], jnp.int32),
                                jnp.asarray(w, jnp.float32),
                                n=n, band=band, block=block)
    return coords, edges, w, nr, rank, band, s


@pytest.mark.parametrize("ndev", [2, 8])
def test_band_fw_sharded_matches_single(ndev):
    n, block = 900, 64
    coords, edges, w, nr, rank, band, s = _setup(n, 7, 0, block)
    bt = band // block + 1

    want = np.asarray(bs.apsp_band_fw_whole(s, bt=bt, block=block))

    mesh = _mesh(ndev)
    _, nb, width, g_pad, local_rows = bsh.sharded_band_geometry(
        n, band, ndev, block)
    pad_rows = g_pad * block - s.shape[0]
    s_pad = jnp.pad(s, ((0, pad_rows), (0, 0)), constant_values=np.inf)
    got = np.asarray(bsh.apsp_band_fw_sharded(
        s_pad, mesh=mesh, n=n, band=band, block=block))

    finite = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got[:want.shape[0]]), finite)
    np.testing.assert_array_equal(got[:want.shape[0]][finite], want[finite])
    assert np.isinf(got[want.shape[0]:]).all()


def _plan(n, k, seed):
    """(u, v, w, rank, band, nr) in the permuted frame — the facade's plan."""
    coords, edges, w = _geometric_graph(n, k, seed)
    nr = 0.1 * (coords[:, 0].max() - coords[:, 0].min())
    order, band = ab.banded_order(coords, nr * (1 + 1e-5))
    rank = np.empty(n, dtype=np.int64)
    rank[order] = np.arange(n)
    pe = rank[edges]
    return (jnp.asarray(pe[:, 0], jnp.int32), jnp.asarray(pe[:, 1], jnp.int32),
            jnp.asarray(w, jnp.float32), rank, band, nr)


@pytest.mark.slow
def test_sharded_permutation_pipeline_bit_identical():
    """Same key + replicated operands => the sharded null must reproduce the
    single-device band pipeline's counts BIT-identically (not a tolerance)."""
    import jax.random as jrandom
    from safepy_tpu import pipeline as pipe
    from safepy_tpu.ops.neighborhoods import inclusive_radius

    n, block, ndev = 700, 64, 4
    u, v, w, rank, band, nr = _plan(n, 6, 1)
    bt = band // block + 1
    rng = np.random.default_rng(0)
    vals = rng.normal(size=(n, 2)).astype(np.float32)
    vals[rng.random(n) < 0.3] = np.nan
    vals_perm = vals[np.argsort(rank)]
    valid = np.any(~np.isnan(vals_perm), axis=1)
    starts, w_c = bs.compaction_plan(valid, n=n, bt=bt, block=block)
    key = jrandom.PRNGKey(11)
    radius = inclusive_radius(nr)
    args = (u, v, w, jnp.asarray(vals_perm), jnp.asarray(vals_perm[valid]),
            jnp.asarray(valid), jnp.asarray(starts, jnp.int32),
            jnp.asarray(rank, jnp.int32), key, radius)
    kw = dict(n=n, band=band, block=block, score_type="sum",
              num_permutations=50, batch_size=25, w_c=w_c)

    single = pipe.fused_permutation_pipeline_band(*args, **kw)
    sharded = bsh.fused_permutation_pipeline_band_sharded(
        *args, mesh=_mesh(ndev), **kw)

    for i, name in ((2, "obs"), (3, "counts_neg"), (4, "counts_pos")):
        np.testing.assert_array_equal(np.asarray(sharded[i]),
                                      np.asarray(single[i]), err_msg=name)
    assert np.isclose(float(sharded[5]), float(single[5]))  # mean size
    assert np.isclose(float(sharded[6]), float(single[6]))  # std

    # keep_distances=False: per-device analog of the single-chip HBM knob —
    # every non-distance output stays bit-identical, dist is a placeholder
    nodist = bsh.fused_permutation_pipeline_band_sharded(
        *args, mesh=_mesh(ndev), keep_distances=False, **kw)
    assert nodist[0].shape[0] == 0
    np.testing.assert_array_equal(np.asarray(nodist[1]),
                                  np.asarray(sharded[1]))
    for i in (2, 3, 4):
        np.testing.assert_array_equal(np.asarray(nodist[i]),
                                      np.asarray(sharded[i]))

    # packed=True: each shard's indicator BIT-packed (uint8, 8 cells/byte)
    # — obs/counts still bit-identical, the band unpacks to the int8 one
    packed = bsh.fused_permutation_pipeline_band_sharded(
        *args, mesh=_mesh(ndev), keep_distances=False, packed=True, **kw)
    assert packed[1].dtype == jnp.uint8
    np.testing.assert_array_equal(
        bs.unpack_band_bits_host(np.asarray(packed[1])),
        np.asarray(sharded[1]))
    for i in (2, 3, 4):
        np.testing.assert_array_equal(np.asarray(packed[i]),
                                      np.asarray(sharded[i]))


@pytest.mark.slow
def test_sharded_hypergeom_pipeline_matches_single():
    from safepy_tpu import pipeline as pipe
    from safepy_tpu.ops import hypergeom as hyper
    from safepy_tpu.ops.neighborhoods import inclusive_radius

    n, block, ndev = 600, 64, 8
    u, v, w, rank, band, nr = _plan(n, 6, 2)
    rng = np.random.default_rng(1)
    vals = (rng.random((n, 4)) < 0.07).astype(np.float32)
    vals[rng.random((n, 4)) < 0.1] = np.nan
    vals_perm = vals[np.argsort(rank)]
    finite = ~np.isnan(vals_perm)
    nan0 = np.where(finite, vals_perm, 0.0).astype(np.float32)
    nnn = np.any(finite, axis=1).astype(np.float32)
    K = nan0.sum(axis=0).astype(np.float32)
    M = int(nnn.sum())
    k_max = int(max(1, K.max()))
    iters = hyper.tail_iterations(M, min(k_max, M))
    lgt = jnp.asarray(hyper.lgamma_table(M))
    radius = inclusive_radius(nr)
    args = (u, v, w, jnp.asarray(nan0), jnp.asarray(nnn), jnp.asarray(K),
            lgt, M, radius, np.float64(0.05), jnp.asarray(rank, jnp.int32))
    kw = dict(n=n, band=band, block=block, iterations=iters)

    single = pipe.fused_hypergeom_pipeline_band(*args, **kw)
    sharded = bsh.fused_hypergeom_pipeline_band_sharded(
        *args, mesh=_mesh(ndev), **kw)

    np.testing.assert_allclose(np.asarray(sharded[2]), np.asarray(single[2]),
                               rtol=1e-6, atol=1e-6)  # logsf
    np.testing.assert_array_equal(np.asarray(sharded[3]),
                                  np.asarray(single[3]))  # nes_binary
    np.testing.assert_array_equal(np.asarray(sharded[4]),
                                  np.asarray(single[4]))  # enriched counts


def test_facade_band_mesh_matches_single():
    """SAFE.run_pipeline with a 'data' mesh routes to the sharded band engine
    and reproduces the single-device band run bit-for-bit (same seed)."""
    import pandas as pd
    from safepy_tpu import SAFE

    n = 600
    coords, edges, w = _geometric_graph(n, 6, 4)
    import networkx as nx
    from safepy_tpu.io.layout import calculate_edge_lengths
    g = nx.Graph()
    g.add_nodes_from(range(n))
    g.add_edges_from(edges)
    for i in range(n):
        g.nodes[i]["label"] = g.nodes[i]["key"] = f"g{i}"
        g.nodes[i]["x"] = float(coords[i, 0])
        g.nodes[i]["y"] = float(coords[i, 1])
    calculate_edge_lengths(g, verbose=False)

    rng = np.random.default_rng(3)
    vals = rng.normal(size=(n, 1))
    vals[rng.random(n) < 0.3, 0] = np.nan
    attrs = pd.DataFrame(vals, index=[f"g{i}" for i in range(n)],
                         columns=["q"])

    def run(mesh):
        sf = SAFE(verbose=False)
        sf.apsp_mode = "band"
        sf.random_seed = 9
        sf.mesh = mesh
        sf.load_network(network_file=g, node_key_attribute="key")
        sf.load_attributes(attribute_file=attrs)
        sf.run_pipeline(num_permutations=80)
        return sf

    single = run(None)
    sharded = run(_mesh(8))
    np.testing.assert_array_equal(sharded.neighborhoods, single.neighborhoods)
    # scores agree to f32 reassociation noise (different XLA programs may
    # vectorize the slab contraction differently); near-tie permutation counts
    # can flip by an ulp, so allow a few counts of drift
    np.testing.assert_allclose(sharded.ns, single.ns, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(np.isnan(sharded.pvalues_pos),
                                  np.isnan(single.pvalues_pos))
    diff = np.abs(np.nan_to_num(sharded.pvalues_pos)
                  - np.nan_to_num(single.pvalues_pos)) * 80
    assert diff.max() <= 4, diff.max()


def test_band_fw_sharded_matches_oracle():
    """End-to-end: sharded band FW thresholded == scipy Dijkstra indicator."""
    from safepy_tpu.ops.neighborhoods import inclusive_radius

    n, block, ndev = 700, 64, 4
    coords, edges, w, nr, rank, band, s = _setup(n, 6, 3, block)
    mesh = _mesh(ndev)
    _, nb, width, g_pad, local_rows = bsh.sharded_band_geometry(
        n, band, ndev, block)
    s_pad = jnp.pad(s, ((0, g_pad * block - s.shape[0]), (0, 0)),
                    constant_values=np.inf)
    out = bsh.apsp_band_fw_sharded(s_pad, mesh=mesh, n=n, band=band,
                                   block=block)
    bt = band // block + 1
    dense = bs.unpack_band(np.asarray(out)[:(nb + 2 * bt) * block], n, band,
                           block)
    dist = dense[rank][:, rank]
    ref = _oracle(n, edges, w)
    r = float(inclusive_radius(nr))
    np.testing.assert_array_equal(dist <= r, ref <= r)


@pytest.mark.slow
def test_sharded_zscore_pipeline_bit_identical():
    """The z-score variant rides the same stacked contraction — pin it
    bit-identical to the single-device band engine too."""
    import jax.random as jrandom
    from safepy_tpu import pipeline as pipe
    from safepy_tpu.ops.neighborhoods import inclusive_radius

    n, block, ndev = 600, 64, 4
    u, v, w, rank, band, nr = _plan(n, 6, 5)
    bt = band // block + 1
    rng = np.random.default_rng(2)
    vals = rng.normal(size=(n, 1)).astype(np.float32)
    vals[rng.random(n) < 0.25, 0] = np.nan
    vals_perm = vals[np.argsort(rank)]
    valid = np.any(~np.isnan(vals_perm), axis=1)
    starts, w_c = bs.compaction_plan(valid, n=n, bt=bt, block=block)
    args = (u, v, w, jnp.asarray(vals_perm), jnp.asarray(vals_perm[valid]),
            jnp.asarray(valid), jnp.asarray(starts, jnp.int32),
            jnp.asarray(rank, jnp.int32), jrandom.PRNGKey(3),
            inclusive_radius(nr))
    kw = dict(n=n, band=band, block=block, score_type="z-score",
              num_permutations=40, batch_size=20, w_c=w_c)

    single = pipe.fused_permutation_pipeline_band(*args, **kw)
    sharded = bsh.fused_permutation_pipeline_band_sharded(
        *args, mesh=_mesh(ndev), **kw)
    np.testing.assert_array_equal(np.asarray(sharded[2]),
                                  np.asarray(single[2]))  # obs (NaNs equal)
    np.testing.assert_array_equal(np.asarray(sharded[3]),
                                  np.asarray(single[3]))
    np.testing.assert_array_equal(np.asarray(sharded[4]),
                                  np.asarray(single[4]))


@pytest.mark.slow
def test_sharded_table_hypergeom_bit_identical():
    """Sharded class-table engine == single-device class-table engine,
    bit-for-bit: integer census counts and a replicated f64 table leave no
    room for drift (ops/enrich_band.hypergeom_band_table vs
    parallel/band_sharded.hypergeom_band_table_sharded)."""
    from safepy_tpu import pipeline as pipe
    from safepy_tpu.ops.enrich_band import hypergeom_band_table
    from safepy_tpu.ops.neighborhoods import inclusive_radius

    n, ndev = 600, 8
    u, v, w, rank, band, nr = _plan(n, 6, 7)
    rng = np.random.default_rng(5)
    vals = (rng.random((n, 9)) < 0.08).astype(np.float32)
    vals[rng.random((n, 9)) < 0.1] = np.nan
    vals_perm = vals[np.argsort(rank)]
    finite = ~np.isnan(vals_perm)
    nan0 = np.where(finite, vals_perm, 0.0).astype(np.float32)
    nnn = np.any(finite, axis=1).astype(np.float32)
    M = int(nnn.sum())
    radius = inclusive_radius(nr)

    # single-device: band front + table driver (block 128 = driver default)
    _, s_ind, _, _, _ = pipe.band_neighborhoods(u, v, w, radius, n=n,
                                                band=band)
    bt = band // 128 + 1
    single = hypergeom_band_table(s_ind, nan0, nnn, M, np.float64(0.05),
                                  bt=bt, rank_np=rank, chunk_cols=4)

    mesh = _mesh(ndev)
    _, ind_g, _, _, _ = bsh.band_neighborhoods_sharded(
        u, v, w, radius, mesh=mesh, n=n, band=band)
    sharded = bsh.hypergeom_band_table_sharded(
        ind_g, nan0, nnn, M, np.float64(0.05), mesh=mesh, n=n, band=band,
        rank_np=rank, chunk_cols=4)

    assert single is not None and sharded is not None
    for i, name in ((0, "logsf"), (1, "bin")):
        np.testing.assert_array_equal(np.asarray(sharded[i]),
                                      np.asarray(single[i]), err_msg=name)
    np.testing.assert_array_equal(sharded[2], single[2])

    # packed front: BIT-packed per-shard indicator feeds the same table
    # driver (dtype-keyed census) bit-identically
    _, ind_p, _, _, _ = bsh.band_neighborhoods_sharded(
        u, v, w, radius, mesh=mesh, n=n, band=band, packed=True)
    assert ind_p.dtype == jnp.uint8
    packed = bsh.hypergeom_band_table_sharded(
        ind_p, nan0, nnn, M, np.float64(0.05), mesh=mesh, n=n, band=band,
        rank_np=rank, chunk_cols=4)
    for i, name in ((0, "logsf"), (1, "bin")):
        np.testing.assert_array_equal(np.asarray(packed[i]),
                                      np.asarray(single[i]), err_msg=name)


@pytest.mark.slow
def test_facade_band_mesh_table_matches_single():
    """Facade: a binary band-scale run under a 'data' mesh routes through the
    sharded table engine and reproduces the single-device run bit-for-bit."""
    import pandas as pd
    from safepy_tpu import SAFE

    n = 600
    coords, edges, w = _geometric_graph(n, 6, 8)
    import networkx as nx
    from safepy_tpu.io.layout import calculate_edge_lengths
    g = nx.Graph()
    g.add_nodes_from(range(n))
    g.add_edges_from(edges)
    for i in range(n):
        g.nodes[i]["label"] = g.nodes[i]["key"] = f"g{i}"
        g.nodes[i]["x"] = float(coords[i, 0])
        g.nodes[i]["y"] = float(coords[i, 1])
    calculate_edge_lengths(g, verbose=False)

    rng = np.random.default_rng(6)
    vals = (rng.random((n, 7)) < 0.1).astype(float)
    vals[rng.random((n, 7)) < 0.1] = np.nan
    attrs = pd.DataFrame(vals, index=[f"g{i}" for i in range(n)],
                         columns=[f"go{j}" for j in range(7)])

    def run(mesh):
        sf = SAFE(verbose=False)
        sf.apsp_mode = "band"
        sf.random_seed = 9
        sf.mesh = mesh
        sf.load_network(network_file=g, node_key_attribute="key")
        sf.load_attributes(attribute_file=attrs)
        sf.run_pipeline()
        return sf

    single = run(None)
    sharded = run(_mesh(8))
    np.testing.assert_array_equal(sharded.neighborhoods, single.neighborhoods)
    np.testing.assert_array_equal(np.asarray(sharded.nes),
                                  np.asarray(single.nes))
    np.testing.assert_array_equal(sharded.nes_binary, single.nes_binary)
    np.testing.assert_array_equal(
        sharded.attributes["num_neighborhoods_enriched"].values,
        single.attributes["num_neighborhoods_enriched"].values)


@pytest.mark.slow
def test_sharded_euclid_band_bit_identical():
    """Row-sharded euclidean band pipeline == the single-device euclid band
    pipeline, bit-for-bit (same key, replicated operands)."""
    import jax.random as jrandom
    from safepy_tpu import pipeline as pipe

    n, block, ndev = 640, 64, 4
    rng = np.random.default_rng(4)
    coords = rng.uniform(-1, 1, (n, 2))
    nr = 0.12 * (coords[:, 0].max() - coords[:, 0].min())
    order, band = ab.banded_order(coords, nr)
    rank = np.empty(n, dtype=np.int64)
    rank[order] = np.arange(n)
    bt = band // block + 1
    vals = rng.normal(size=(n, 2)).astype(np.float32)
    vals[rng.random(n) < 0.3] = np.nan
    vals_perm = vals[order]
    valid = np.any(~np.isnan(vals_perm), axis=1)
    starts, w_c = bs.compaction_plan(valid, n=n, bt=bt, block=block)
    args = (jnp.asarray(coords[order], jnp.float32), jnp.asarray(vals_perm),
            jnp.asarray(vals_perm[valid]), jnp.asarray(valid),
            jnp.asarray(starts, jnp.int32), jnp.asarray(rank, jnp.int32),
            jrandom.PRNGKey(13), np.float32(nr))
    kw = dict(n=n, band=band, block=block, score_type="sum",
              num_permutations=60, batch_size=30, w_c=w_c)

    single = pipe.fused_permutation_pipeline_band_euclid(*args, **kw)
    sharded = bsh.fused_permutation_pipeline_band_euclid_sharded(
        *args, mesh=_mesh(ndev), **kw)

    for i, name in ((2, "obs"), (3, "counts_neg"), (4, "counts_pos")):
        np.testing.assert_array_equal(np.asarray(sharded[i]),
                                      np.asarray(single[i]), err_msg=name)
    assert np.isclose(float(sharded[5]), float(single[5]))
    assert np.isclose(float(sharded[6]), float(single[6]))
    # the sharded band (trimmed of its device-padding rows) matches too
    g_rows = single[1].shape[0]
    np.testing.assert_array_equal(np.asarray(sharded[1])[:g_rows],
                                  np.asarray(single[1]))

    # keep_distances=False rides the int8-DIRECT per-shard indicator
    # (_euclid_band_ind_local): bit-identical statistics, placeholder dist
    nodist = bsh.fused_permutation_pipeline_band_euclid_sharded(
        *args, mesh=_mesh(ndev), keep_distances=False, **kw)
    assert nodist[0].shape[0] == 0
    np.testing.assert_array_equal(np.asarray(nodist[1]),
                                  np.asarray(sharded[1]))
    for i in (2, 3, 4):
        np.testing.assert_array_equal(np.asarray(nodist[i]),
                                      np.asarray(sharded[i]))

    # packed=True: per-shard BIT-packed indicator, identical statistics
    packed = bsh.fused_permutation_pipeline_band_euclid_sharded(
        *args, mesh=_mesh(ndev), keep_distances=False, packed=True, **kw)
    assert packed[1].dtype == jnp.uint8
    np.testing.assert_array_equal(
        bs.unpack_band_bits_host(np.asarray(packed[1])),
        np.asarray(sharded[1]))
    for i in (2, 3, 4):
        np.testing.assert_array_equal(np.asarray(packed[i]),
                                      np.asarray(sharded[i]))


def test_facade_euclid_band_mesh(tmp_path):
    """Facade: the scatter/euclidean workflow under a 'data' mesh no longer
    falls back to the dense matrix — it routes the sharded euclid band
    pipeline and matches the single-device band run."""
    import pandas as pd
    from safepy_tpu import SAFE

    n = 640
    rng = np.random.default_rng(15)
    coords = rng.uniform(-1, 1, (n, 2))
    import networkx as nx
    g = nx.Graph()
    g.add_nodes_from(range(n))
    for i in range(n):
        g.nodes[i]["label"] = g.nodes[i]["key"] = f"c{i}"
        g.nodes[i]["x"] = float(coords[i, 0])
        g.nodes[i]["y"] = float(coords[i, 1])
    vals = rng.normal(size=(n, 1))
    vals[rng.random(n) < 0.3, 0] = np.nan
    attrs = pd.DataFrame(vals, index=[f"c{i}" for i in range(n)],
                         columns=["q"])

    def run(mesh):
        sf = SAFE(verbose=False)
        sf.apsp_mode = "band"
        sf.random_seed = 17
        sf.mesh = mesh
        sf.neighborhood_radius = 0.12
        sf.load_network(network_file=g, node_key_attribute="key")
        sf.load_attributes(attribute_file=attrs)
        sf.run_pipeline(node_distance_metric="euclidean",
                        num_permutations=80)
        return sf

    single = run(None)
    sharded = run(_mesh(8))
    from safepy_tpu.ops.apsp_bandstore import BandedMatrix
    assert isinstance(sharded._neighborhoods_dev, BandedMatrix)
    np.testing.assert_array_equal(sharded.neighborhoods, single.neighborhoods)
    # scores agree to f32 reassociation noise (different XLA programs may
    # vectorize the slab contraction differently); near-tie permutation
    # counts can flip by an ulp
    np.testing.assert_allclose(sharded.ns, single.ns, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(np.isnan(sharded.pvalues_pos),
                                  np.isnan(single.pvalues_pos))
    diff = np.abs(np.nan_to_num(sharded.pvalues_pos)
                  - np.nan_to_num(single.pvalues_pos)) * 80
    assert diff.max() <= 4, diff.max()
