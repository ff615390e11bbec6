"""Bit-packed indicator bands (ops/apsp_bandstore.is_packed_bits).

A uint8 band stores 8 indicator cells per byte (LSB-first); every banded
consumer branches on the dtype, so packed and plain runs must be
bit-identical end to end. The pack is the 8x memory/download lever past the
~1M-point int8 euclidean ceiling (reference safe.py:389-399 serves that
metric from a dense host pdist).
"""

import numpy as np
import pandas as pd
import pytest

import jax.numpy as jnp

from safepy_tpu.ops import apsp_bandstore as bst


@pytest.fixture(scope="module")
def band_setup():
    rng = np.random.default_rng(3)
    n, band = 700, 60
    coords = rng.uniform(-1, 1, (n, 2)).astype(np.float32)
    rank = np.argsort(np.argsort(coords[:, 0]))
    cp = coords[np.argsort(rank)]
    plain = bst.euclidean_band_indicator(jnp.asarray(cp), np.float32(0.08),
                                         n=n, band=band)
    packed = bst.euclidean_band_indicator(jnp.asarray(cp), np.float32(0.08),
                                          n=n, band=band, packed=True)
    return n, band, rank, plain, packed, rng


def test_pack_roundtrip(band_setup):
    n, band, rank, plain, packed, rng = band_setup
    assert packed.dtype == jnp.uint8
    assert packed.shape == (plain.shape[0], plain.shape[1] // 8)
    np.testing.assert_array_equal(np.asarray(bst.unpack_band_bits(packed)),
                                  np.asarray(plain))
    np.testing.assert_array_equal(bst.unpack_band_bits_host(np.asarray(packed)),
                                  np.asarray(plain))
    np.testing.assert_array_equal(np.asarray(bst.pack_band_bits(plain)),
                                  np.asarray(packed))


def test_row_stats_match(band_setup):
    n, band, rank, plain, packed, _ = band_setup
    bt = band // 128 + 1
    s1, m1, d1 = bst.band_row_stats(plain, n=n, bt=bt)
    s2, m2, d2 = bst.band_row_stats(packed, n=n, bt=bt)
    np.testing.assert_array_equal(np.asarray(s1), np.asarray(s2))
    assert float(m1) == float(m2) and float(d1) == float(d2)


def test_band_matmul_match(band_setup):
    n, band, rank, plain, packed, rng = band_setup
    bt = band // 128 + 1
    x = rng.normal(size=(768, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        np.asarray(bst.band_matmul(plain, jnp.asarray(x), bt=bt)),
        np.asarray(bst.band_matmul(packed, jnp.asarray(x), bt=bt)))


def test_compaction_packed_in_packed_out(band_setup):
    n, band, rank, plain, packed, rng = band_setup
    bt = band // 128 + 1
    valid = rng.random(n) < 0.66
    starts, w_c = bst.compaction_plan(valid, n=n, bt=bt)
    c_plain = bst.apply_compaction(plain, jnp.asarray(valid), w_c, bt=bt)
    c_packed = bst.apply_compaction(packed, jnp.asarray(valid), w_c, bt=bt)
    assert c_packed.dtype == jnp.uint8
    np.testing.assert_array_equal(
        bst.unpack_band_bits_host(np.asarray(c_packed)), np.asarray(c_plain))
    # chunked sort path bit-identical for packed inputs too
    c_chunk = bst.apply_compaction(packed, jnp.asarray(valid), w_c, bt=bt,
                                   chunk_blocks=2)
    np.testing.assert_array_equal(np.asarray(c_chunk), np.asarray(c_packed))
    # batched contraction against the packed compaction
    xb = rng.normal(size=(2, int(valid.sum()) + w_c, 2)).astype(np.float32)
    np.testing.assert_array_equal(
        np.asarray(bst.band_matmul_batch(c_plain, jnp.asarray(xb),
                                         jnp.asarray(starts, jnp.int32),
                                         bt=bt)),
        np.asarray(bst.band_matmul_batch(c_packed, jnp.asarray(xb),
                                         jnp.asarray(starts, jnp.int32),
                                         bt=bt)))


def test_band_count_batch_matches_unfused(band_setup):
    """The fused per-chunk counter (band_count_batch) is bit-identical to
    band_matmul_batch + count_scan's tie-inclusive comparisons, packed and
    plain alike."""
    n, band, rank, plain, packed, rng = band_setup
    bt = band // 128 + 1
    valid = rng.random(n) < 0.66
    starts, w_c = bst.compaction_plan(valid, n=n, bt=bt)
    starts = jnp.asarray(starts, jnp.int32)
    c_plain = bst.apply_compaction(plain, jnp.asarray(valid), w_c, bt=bt)
    c_packed = bst.apply_compaction(packed, jnp.asarray(valid), w_c, bt=bt)
    V = int(valid.sum())
    C, A = 5, 2
    xb = rng.normal(size=(C, V + w_c, A)).astype(np.float32)
    npad = plain.shape[0] - 2 * bt * 128
    obs = rng.normal(size=(npad, A)).astype(np.float32)
    live = np.array([True, True, True, False, False])

    scores = np.asarray(bst.band_matmul_batch(c_plain, jnp.asarray(xb),
                                              starts, bt=bt))
    lv = live[:, None, None]
    cn_ref = np.sum(np.where(lv & (scores <= obs[None]), 1, 0), axis=0)
    cp_ref = np.sum(np.where(lv & (scores >= obs[None]), 1, 0), axis=0)
    for compact in (c_plain, c_packed):
        cn, cp = bst.band_count_batch(compact, jnp.asarray(xb), starts,
                                      jnp.asarray(obs), jnp.asarray(live),
                                      bt=bt)
        np.testing.assert_array_equal(np.asarray(cn), cn_ref)
        np.testing.assert_array_equal(np.asarray(cp), cp_ref)


def test_banded_matrix_accessors(band_setup):
    n, band, rank, plain, packed, _ = band_setup
    b1 = bst.BandedMatrix(plain, rank, n, band, fill=0.0)
    b2 = bst.BandedMatrix(packed, rank, n, band, fill=0.0)
    np.testing.assert_array_equal(b1.to_dense(), b2.to_dense())
    assert (b1.to_sparse() != b2.to_sparse()).nnz == 0


def _scatter_safe(bits, tmp_path=None):
    import networkx as nx
    from safepy_tpu import SAFE

    rng = np.random.default_rng(11)
    n = 600
    coords = rng.uniform(-1, 1, (n, 2))
    g = nx.Graph()
    g.add_nodes_from(range(n))
    for i in range(n):
        g.nodes[i]["label"] = g.nodes[i]["key"] = f"c{i}"
        g.nodes[i]["x"] = float(coords[i, 0])
        g.nodes[i]["y"] = float(coords[i, 1])
    vals = rng.normal(size=(n, 2))
    vals[rng.random((n, 2)) < 0.3] = np.nan
    attrs = pd.DataFrame(vals, index=[f"c{i}" for i in range(n)],
                         columns=["q0", "q1"])
    sf = SAFE(verbose=False)
    sf.random_seed = 23
    sf.apsp_mode = "band"
    sf.keep_node_distances = False
    sf.band_indicator_bits = bits
    sf.neighborhood_radius = 0.12
    sf.load_network(network_file=g, node_key_attribute="key")
    sf.load_attributes(attribute_file=attrs)
    sf.run_pipeline(node_distance_metric="euclidean", num_permutations=100)
    return sf


@pytest.mark.slow
def test_facade_euclid_packed_matches_plain():
    """The fused euclidean pipeline with band_indicator_bits=True is
    bit-identical to the int8 run (same seed => same permutations => same
    counts), and the stored band really is packed."""
    sf_plain = _scatter_safe(False)
    sf_packed = _scatter_safe(True)
    assert sf_packed._neighborhoods_dev.data.dtype == jnp.uint8
    assert sf_plain._neighborhoods_dev.data.dtype == jnp.int8
    np.testing.assert_array_equal(sf_packed.ns, sf_plain.ns)
    np.testing.assert_array_equal(np.asarray(sf_packed.nes),
                                  np.asarray(sf_plain.nes))
    np.testing.assert_array_equal(
        sf_packed.neighborhoods_sparse().toarray(),
        sf_plain.neighborhoods_sparse().toarray())


@pytest.mark.slow
def test_facade_staged_consumers_on_packed_band():
    """define_neighborhoods with a packed band feeds the STAGED paths
    (randomization + binary hypergeometric) bit-identically to int8."""
    import networkx as nx
    from safepy_tpu import SAFE

    rng = np.random.default_rng(7)
    n = 500
    coords = rng.uniform(-1, 1, (n, 2))
    g = nx.Graph()
    g.add_nodes_from(range(n))
    for i in range(n):
        g.nodes[i]["label"] = g.nodes[i]["key"] = f"c{i}"
        g.nodes[i]["x"] = float(coords[i, 0])
        g.nodes[i]["y"] = float(coords[i, 1])
    binary = (rng.random((n, 4)) < 0.1).astype(float)
    attrs = pd.DataFrame(binary, index=[f"c{i}" for i in range(n)],
                         columns=[f"b{i}" for i in range(4)])

    results = {}
    for bits in (False, True):
        sf = SAFE(verbose=False)
        sf.random_seed = 5
        sf.apsp_mode = "band"
        sf.keep_node_distances = False
        sf.band_indicator_bits = bits
        sf.neighborhood_radius = 0.15
        sf.load_network(network_file=g, node_key_attribute="key")
        sf.load_attributes(attribute_file=attrs)
        sf.define_neighborhoods(node_distance_metric="euclidean")
        sf.compute_pvalues()
        results[bits] = (sf._neighborhoods_dev.data.dtype,
                         np.asarray(sf.nes), np.asarray(sf.nes_binary))
    assert results[True][0] == jnp.uint8
    np.testing.assert_array_equal(results[True][1], results[False][1])
    np.testing.assert_array_equal(results[True][2], results[False][2])


def _graph_safe(bits, *, split_bytes=None, binary=False, keep=False,
                relax="auto"):
    import networkx as nx
    from safepy_tpu import SAFE

    rng = np.random.default_rng(29)
    n = 500
    coords = rng.uniform(-1, 1, (n, 2))
    g = nx.Graph()
    for i in range(n):
        g.add_node(i, x=float(coords[i, 0]), y=float(coords[i, 1]),
                   label=f"g{i}", key=f"g{i}")
    d = np.sqrt(((coords[:, None] - coords[None]) ** 2).sum(-1))
    for i in range(n):
        for j in np.argsort(d[i])[1:7]:
            g.add_edge(i, int(j))
    from safepy_tpu.io.layout import calculate_edge_lengths
    calculate_edge_lengths(g, verbose=False)
    if binary:
        vals = (rng.random((n, 3)) < 0.12).astype(float)
    else:
        vals = rng.normal(size=(n, 2))
        vals[rng.random((n, 2)) < 0.25] = np.nan
    attrs = pd.DataFrame(vals, index=[f"g{i}" for i in range(n)],
                         columns=[f"a{i}" for i in range(vals.shape[1])])
    sf = SAFE(verbose=False)
    sf.random_seed = 41
    sf.apsp_mode = "band"
    sf.band_relax = relax
    sf.keep_node_distances = keep
    sf.band_indicator_bits = bits
    if split_bytes is not None:
        sf.band_split_min_bytes = split_bytes
    sf.load_network(network_file=g, node_key_attribute="key")
    sf.load_attributes(attribute_file=attrs)
    sf.run_pipeline(num_permutations=100)
    return sf


@pytest.mark.slow
def test_graph_band_packed_matches_plain():
    """The graph-metric fused band pipeline (FW front) with packed bits is
    bit-identical to the int8 run, fused and split-front alike."""
    sf_plain = _graph_safe(False)
    sf_packed = _graph_safe(True)
    assert sf_packed._neighborhoods_dev.data.dtype == jnp.uint8
    np.testing.assert_array_equal(sf_packed.ns, sf_plain.ns)
    np.testing.assert_array_equal(np.asarray(sf_packed.nes),
                                  np.asarray(sf_plain.nes))
    # split-front dispatches (band_relax_threshold packed=True) agree too
    sf_split = _graph_safe(True, split_bytes=1)
    np.testing.assert_array_equal(np.asarray(sf_split.nes),
                                  np.asarray(sf_packed.nes))
    assert sf_split._neighborhoods_dev.data.dtype == jnp.uint8


@pytest.mark.slow
def test_graph_band_packed_binary_table_engine():
    """Binary annotations through the class-table engine consume the packed
    band bit-identically (census band_matmul is dtype-keyed)."""
    sf_plain = _graph_safe(False, binary=True)
    sf_packed = _graph_safe(True, binary=True)
    assert sf_packed._hypergeom_engine_used == sf_plain._hypergeom_engine_used
    np.testing.assert_array_equal(np.asarray(sf_packed.nes),
                                  np.asarray(sf_plain.nes))
    np.testing.assert_array_equal(np.asarray(sf_packed.nes_binary),
                                  np.asarray(sf_plain.nes_binary))


def test_checkpoint_roundtrip_packed(tmp_path, monkeypatch):
    """Band sessions save/load the packed band with its dtype preserved."""
    from safepy_tpu import checkpoint

    sf = _scatter_safe(True)
    # at test scale the dense guard would fit; force the band-session path
    # the real >100k-point runs take
    monkeypatch.setattr(bst.BandedMatrix, "DENSE_MAX_BYTES", 1000)
    path = str(tmp_path / "packed_session")
    checkpoint.save_session(sf, path)
    sf2 = checkpoint.load_session(path)
    assert sf2._neighborhoods_dev.data.dtype == jnp.uint8
    np.testing.assert_array_equal(
        sf2.neighborhoods_sparse().toarray(),
        sf.neighborhoods_sparse().toarray())
    np.testing.assert_array_equal(np.asarray(sf2.nes), np.asarray(sf.nes))
