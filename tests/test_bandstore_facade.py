"""Facade over the band-STORAGE engine == the dense engine (apsp_mode='band').

The band-storage paths are auto-selected above SAFE.band_storage_min_nodes;
these tests force them at test scale and pin every output against the dense
('full') engine through the public facade.
"""

import numpy as np
import pandas as pd
import pytest

from safepy_tpu import SAFE
from safepy_tpu.ops.neighborhoods import inclusive_radius


def _write_net(tmp_path, n=500, k=6, seed=2):
    rng = np.random.default_rng(seed)
    coords = rng.uniform(-1, 1, (n, 2))
    from scipy.spatial import cKDTree
    _, nn = cKDTree(coords).query(coords, k=k)
    pairs = sorted({(min(i, int(j)), max(i, int(j)))
                    for i in range(n) for j in nn[i, 1:]})
    net = tmp_path / "net.txt"
    with open(net, "w") as f:
        for a, b in pairs:
            f.write(f"g{a}\tg{b}\t1.0\n")
    return str(net), n


def _run(net, attrs, mode, *, seed=7, staged=False, hypergeom_engine="auto",
         band_relax="auto", logsf_store=None, **kwargs):
    sf = SAFE(verbose=False)
    sf.apsp_mode = mode
    sf.hypergeom_engine = hypergeom_engine
    sf.band_relax = band_relax
    if logsf_store is not None:
        sf.logsf_store = logsf_store
    sf.random_seed = seed
    sf.load_network(network_file=net, node_key_attribute="key")
    sf.load_attributes(attribute_file=attrs)
    if staged:
        nbr_kwargs = {k: kwargs.pop(k) for k in
                      ("node_distance_metric", "neighborhood_radius")
                      if k in kwargs}
        sf.define_neighborhoods(**nbr_kwargs)
        sf.compute_pvalues(**kwargs)
    else:
        sf.run_pipeline(**kwargs)
    return sf


@pytest.fixture(scope="module")
def net(tmp_path_factory):
    return _write_net(tmp_path_factory.mktemp("bandnet"))


def _binary_attrs(n, a=5, seed=0):
    rng = np.random.default_rng(seed)
    vals = (rng.random((n, a)) < 0.08).astype(float)
    vals[rng.random((n, a)) < 0.1] = np.nan
    return pd.DataFrame(vals, index=[f"g{i}" for i in range(n)],
                        columns=[f"go{j}" for j in range(a)])


def _quant_attrs(n, seed=0):
    rng = np.random.default_rng(seed)
    vals = rng.normal(size=(n, 1))
    vals[rng.random(n) < 0.3, 0] = np.nan
    return pd.DataFrame(vals, index=[f"g{i}" for i in range(n)],
                        columns=["quant"])


def _assert_distances_match(banded, full):
    x = [full.graph.nodes[i]["x"] for i in full.graph]
    r = float(inclusive_radius(
        full.neighborhood_radius * (np.max(x) - np.min(x))))
    inside = full.node_distances <= r
    np.testing.assert_allclose(banded.node_distances[inside],
                               full.node_distances[inside],
                               rtol=1e-6, atol=1e-6)
    assert np.isinf(banded.node_distances[~inside]).all()


def test_band_hypergeom_matches_full(net):
    path, n = net
    attrs = _binary_attrs(n)
    full = _run(path, attrs, "full")
    banded = _run(path, attrs, "band")

    np.testing.assert_array_equal(banded.neighborhoods, full.neighborhoods)
    _assert_distances_match(banded, full)
    assert np.nanmax(np.abs(banded.pvalues_pos - full.pvalues_pos)) <= 1e-6
    np.testing.assert_array_equal(banded.nes_binary, full.nes_binary)
    np.testing.assert_array_equal(
        banded.attributes["num_neighborhoods_enriched"].values,
        full.attributes["num_neighborhoods_enriched"].values)


def test_band_hypergeom_fdr_device_logspace(net):
    """multiple_testing=True at band scale runs BH ON DEVICE in log space
    from the f32 log-survival (never downloading and host-exp'ing the full
    f64 (N, A) matrix). Pinned against the
    statsmodels-semantics BH oracle applied to the UNADJUSTED band p-values
    (reference safe.py:599-605) and against the dense engine."""
    from tests.test_fdr import _bh_oracle

    path, n = net
    attrs = _binary_attrs(n)
    raw = _run(path, attrs, "band")          # unadjusted p-values
    banded = _run(path, attrs, "band", multiple_testing=True)
    full = _run(path, attrs, "full", multiple_testing=True)

    # the result stays device-resident until read: no eager (N, A) download
    assert banded._logsf_dev is not None and banded._pvalues_pos_np is None

    want = np.apply_along_axis(_bh_oracle, 1, raw.pvalues_pos)
    np.testing.assert_allclose(banded.pvalues_pos, want, rtol=1e-5,
                               atol=1e-12)
    assert np.nanmax(np.abs(banded.pvalues_pos - full.pvalues_pos)) <= 1e-6
    np.testing.assert_array_equal(banded.nes_binary, full.nes_binary)
    np.testing.assert_array_equal(
        banded.attributes["num_neighborhoods_enriched"].values,
        (want < banded.enrichment_threshold).sum(axis=0))
    # NES derives from the ADJUSTED log p
    with np.errstate(divide="ignore"):
        np.testing.assert_allclose(banded.nes, -np.log10(want), rtol=1e-5,
                                   atol=1e-6)


def test_band_logsf_host_streams_bit_equal(net):
    """logsf_out='host' (the census-memory lever): every
    chunk's columns stream to host numpy buffers, nothing (N, A)-sized
    stays on device — and the results are BIT-EQUAL to the device-resident
    path, through the public surface."""
    path, n = net
    attrs = _binary_attrs(n)
    dev = _run(path, attrs, "band")
    sf = SAFE(verbose=False)
    sf.apsp_mode = "band"
    sf.logsf_store = "host"
    sf.random_seed = 7
    sf.load_network(network_file=path, node_key_attribute="key")
    sf.load_attributes(attribute_file=attrs)
    sf.run_pipeline()

    assert sf._hypergeom_engine_used == "table-band"
    assert sf._hbm_plan_last["logsf_out"] == "host"
    assert sf._logsf_dev is None and sf._logsf_np is not None
    assert sf._nes_binary_dev is None and sf._nes_binary_i8_np is not None

    np.testing.assert_array_equal(sf._logsf_np, np.asarray(dev._logsf_dev))
    np.testing.assert_array_equal(sf.nes_binary, dev.nes_binary)
    np.testing.assert_array_equal(sf.nes, dev.nes)  # same f64/f32 contract
    np.testing.assert_array_equal(sf.pvalues_pos, dev.pvalues_pos)
    np.testing.assert_array_equal(
        sf.attributes["num_neighborhoods_enriched"].values,
        dev.attributes["num_neighborhoods_enriched"].values)
    # column accessors ride the host buffers
    for j in (0, attrs.shape[1] - 1):
        np.testing.assert_array_equal(sf._nes_column(j), dev._nes_column(j))
        np.testing.assert_array_equal(sf._nes_binary_column(j),
                                      dev._nes_binary_column(j))


def test_band_logsf_f16_staging_exact_counts(net):
    """logsf_out='f16' halves the device whale; the indicator and enriched
    counts are decided in f64 PRE-rounding so they stay exact — only the
    stored log-p carries f16 rounding (~2^-11 relative)."""
    path, n = net
    attrs = _binary_attrs(n)
    dev = _run(path, attrs, "band")
    f16 = _run(path, attrs, "band", logsf_store="f16")
    assert f16._logsf_dev.dtype == np.float16
    np.testing.assert_array_equal(f16.nes_binary, dev.nes_binary)
    np.testing.assert_array_equal(
        f16.attributes["num_neighborhoods_enriched"].values,
        dev.attributes["num_neighborhoods_enriched"].values)
    ok = np.isfinite(dev.pvalues_pos) & (dev.pvalues_pos > 0)
    np.testing.assert_allclose(np.log(f16.pvalues_pos[ok]),
                               np.log(dev.pvalues_pos[ok]),
                               rtol=1e-3, atol=6e-3)


def test_band_logsf_host_with_fdr(net):
    """logsf_out='host' + multiple_testing: BH runs on the host twin
    (ops/fdr.fdr_bh_logsf_np) and matches the device log-space path."""
    path, n = net
    attrs = _binary_attrs(n)
    dev = _run(path, attrs, "band", multiple_testing=True)
    host = _run(path, attrs, "band", logsf_store="host",
                multiple_testing=True)
    assert host._logsf_dev is None and host._logsf_np is not None
    np.testing.assert_allclose(host.pvalues_pos, dev.pvalues_pos,
                               rtol=1e-12, atol=0)
    np.testing.assert_array_equal(host.nes_binary, dev.nes_binary)


def test_band_bt_bucket_results_identical(net):
    """bt bucketing (compile-cache reuse across radius sweeps) only WIDENS the certified band — every public output is
    identical with bucketing on (default 4) vs off."""
    path, n = net
    attrs = _binary_attrs(n)
    sf_on = _run(path, attrs, "band")
    sf_off = SAFE(verbose=False)
    sf_off.apsp_mode = "band"
    sf_off.band_bt_bucket = 0
    sf_off.random_seed = 7
    sf_off.load_network(network_file=path, node_key_attribute="key")
    sf_off.load_attributes(attribute_file=attrs)
    sf_off.run_pipeline()

    bt_on = sf_on._neighborhoods_dev.bt
    bt_off = sf_off._neighborhoods_dev.bt
    assert bt_on % 4 == 0 and bt_on >= bt_off
    np.testing.assert_array_equal(sf_on.neighborhoods, sf_off.neighborhoods)
    np.testing.assert_array_equal(np.asarray(sf_on._logsf_dev),
                                  np.asarray(sf_off._logsf_dev))
    np.testing.assert_array_equal(sf_on.nes_binary, sf_off.nes_binary)
    # distances agree on the CERTIFIED band; the wider bucketed band may
    # additionally resolve pairs beyond the radius (both report inf/exact
    # inside it)
    inside = np.isfinite(sf_off.node_distances)
    np.testing.assert_allclose(sf_on.node_distances[inside],
                               sf_off.node_distances[inside], rtol=1e-6)


@pytest.mark.slow
def test_band_permutation_matches_full_statistically(net):
    path, n = net
    attrs = _quant_attrs(n)
    full = _run(path, attrs, "full", num_permutations=300)
    banded = _run(path, attrs, "band", num_permutations=300)

    np.testing.assert_array_equal(banded.neighborhoods, full.neighborhoods)
    # observed scores are deterministic — must match exactly
    np.testing.assert_allclose(banded.ns, full.ns, rtol=1e-6, atol=1e-6)
    # the null uses independent keyed draws in a different row order: compare
    # per-cell counts within a 6-sigma binomial envelope
    p = np.clip(full.pvalues_pos, 1 / 300, 1 - 1 / 300)
    sigma = np.sqrt(300 * p * (1 - p))
    diff = np.abs(banded.pvalues_pos - full.pvalues_pos) * 300
    ok = np.isnan(diff) | (diff <= 6 * sigma + 1)
    assert ok.all()
    # NaN masking (invalid observed scores) must agree exactly
    np.testing.assert_array_equal(np.isnan(banded.pvalues_pos),
                                  np.isnan(full.pvalues_pos))


def test_band_staged_matches_band_fused(net):
    path, n = net
    attrs = _binary_attrs(n, seed=3)
    fused = _run(path, attrs, "band")
    staged = _run(path, attrs, "band", staged=True)

    np.testing.assert_array_equal(staged.neighborhoods, fused.neighborhoods)
    np.testing.assert_array_equal(np.asarray(staged.nes),
                                  np.asarray(fused.nes))
    np.testing.assert_array_equal(staged.nes_binary, fused.nes_binary)


@pytest.mark.slow
def test_band_staged_permutation_runs(net):
    path, n = net
    attrs = _quant_attrs(n, seed=5)
    sf = _run(path, attrs, "band", staged=True, num_permutations=120)
    dense = _run(path, attrs, "full", staged=True, num_permutations=120)
    np.testing.assert_allclose(sf.ns, dense.ns, rtol=1e-6, atol=1e-6)
    counts = (np.nan_to_num(sf.pvalues_neg) + np.nan_to_num(sf.pvalues_pos))
    assert (counts * 120 >= 120 - 1e-6).all()  # ties count on both sides


def test_band_zscore_obs_matches_dense(net):
    path, n = net
    attrs = _quant_attrs(n, seed=8)
    full = _run(path, attrs, "full", staged=True,
                neighborhood_score_type="z-score", num_permutations=60)
    banded = _run(path, attrs, "band", staged=True,
                  neighborhood_score_type="z-score", num_permutations=60)
    np.testing.assert_allclose(banded.ns, full.ns, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(np.isnan(banded.ns), np.isnan(full.ns))


def test_band_sparse_accessors(net):
    path, n = net
    attrs = _binary_attrs(n, seed=4)
    banded = _run(path, attrs, "band")
    sp = banded.neighborhoods_sparse()
    np.testing.assert_array_equal(sp.toarray(), banded.neighborhoods)
    spd = banded.node_distances_sparse()
    d = banded.node_distances
    got = spd.toarray()
    finite = np.isfinite(d) & (d > 0)
    np.testing.assert_allclose(got[finite], d[finite], rtol=1e-6)


def test_band_session_pickles(net, tmp_path):
    path, n = net
    attrs = _binary_attrs(n, seed=6)
    banded = _run(path, attrs, "band")
    out = tmp_path / "session.p"
    banded.save(output_file=str(out))
    import pickle
    with open(out, "rb") as fh:
        back = pickle.load(fh)
    np.testing.assert_array_equal(back.neighborhoods, banded.neighborhoods)
    np.testing.assert_allclose(np.asarray(back.nes), np.asarray(banded.nes),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.slow
def test_band_hypergeom_attr_chunked_matches_unchunked(net):
    """lax.map attribute chunking of the banded survival tail is results-
    invariant (it only bounds the f64 intermediates' peak HBM)."""
    import jax.numpy as jnp
    from safepy_tpu.ops import hypergeom as hyper
    from safepy_tpu import pipeline as pipe
    from safepy_tpu.ops import apsp_banded as ab

    path, n = net
    attrs = _binary_attrs(n, a=11, seed=9)
    vals = attrs.values.astype(np.float32)

    sf = _run(path, attrs, "band")
    plan = next(v for v in sf._bandstore_cache.values() if v is not None)
    rank, band = plan["rank"], plan["band"]
    nan0, nnn, K = SAFE._hypergeom_host_operands(vals, np.argsort(rank))
    M = int(nnn.sum())
    k_max = int(max(1, K.max()))
    iters = hyper.tail_iterations(M, min(k_max, M))
    lgt = jnp.asarray(hyper.lgamma_table(M))
    from safepy_tpu.ops.neighborhoods import inclusive_radius
    x = [sf.graph.nodes[i]["x"] for i in sf.graph]
    radius = inclusive_radius(sf.neighborhood_radius
                              * (np.max(x) - np.min(x)))
    args = (plan["u"], plan["v"], plan["w"], jnp.asarray(nan0),
            jnp.asarray(nnn), jnp.asarray(K), lgt, M,
            radius, np.float64(0.05), plan["rank_dev"])
    kw = dict(n=n, band=band, iterations=iters)

    plain = pipe.fused_hypergeom_pipeline_band(*args, **kw)
    chunked = pipe.fused_hypergeom_pipeline_band(*args, attr_chunk=4, **kw)
    np.testing.assert_array_equal(np.asarray(chunked[2]),
                                  np.asarray(plain[2]))   # logsf
    np.testing.assert_array_equal(np.asarray(chunked[3]),
                                  np.asarray(plain[3]))   # nes_binary
    np.testing.assert_array_equal(np.asarray(chunked[4]),
                                  np.asarray(plain[4]))   # counts


def test_band_euclidean_matches_dense(net):
    """Banded euclidean neighborhoods (strict <) == the dense metric through
    the staged facade, including enrichment downstream."""
    path, n = net
    attrs = _binary_attrs(n, seed=12)
    full = _run(path, attrs, "full", staged=True,
                node_distance_metric="euclidean")
    banded = _run(path, attrs, "band", staged=True,
                  node_distance_metric="euclidean")
    np.testing.assert_array_equal(banded.neighborhoods, full.neighborhoods)
    assert np.nanmax(np.abs(banded.pvalues_pos - full.pvalues_pos)) <= 1e-6
    np.testing.assert_array_equal(banded.nes_binary, full.nes_binary)
    # distances: exact within the radius, inf beyond (banded semantics)
    x = [full.graph.nodes[i]["x"] for i in full.graph]
    r = float(np.float32(full.neighborhood_radius
                         * (np.max(x) - np.min(x))))
    inside = full.node_distances < r
    # pin the band's distances against TRUE f64 pairwise distances: the dense
    # engine's Gram-matrix formula loses ~2e-5 to cancellation on near pairs,
    # while the band's direct coordinate differences are f32-exact
    xy = np.array([[full.graph.nodes[i]["x"], full.graph.nodes[i]["y"]]
                   for i in full.graph])
    true_d = np.hypot(xy[:, 0][:, None] - xy[:, 0][None, :],
                      xy[:, 1][:, None] - xy[:, 1][None, :])
    np.testing.assert_allclose(banded.node_distances[inside], true_d[inside],
                               rtol=1e-6, atol=1e-6)
    assert np.isinf(banded.node_distances[~inside & ~np.eye(n, dtype=bool)
                                          & (full.node_distances >= r)]).all()


def test_band_checkpoint_roundtrip(net, tmp_path):
    """save_session/load_session checkpoint the band itself when the dense
    matrices are guarded, and the reloaded session keeps computing."""
    from safepy_tpu import checkpoint as ckpt
    from safepy_tpu.ops.apsp_bandstore import BandedMatrix

    path, n = net
    attrs = _binary_attrs(n, seed=13)
    sf = _run(path, attrs, "band")
    bm = sf._neighborhoods_dev
    assert isinstance(bm, BandedMatrix)
    old_max = BandedMatrix.DENSE_MAX_BYTES
    BandedMatrix.DENSE_MAX_BYTES = 10  # force the huge-N branch at test scale
    try:
        ckpt.save_session(sf, str(tmp_path / "sess"))
        back = ckpt.load_session(str(tmp_path / "sess"), graph=sf.graph,
                                 verbose=False)
    finally:
        BandedMatrix.DENSE_MAX_BYTES = old_max
    np.testing.assert_array_equal(back.neighborhoods, sf.neighborhoods)
    np.testing.assert_allclose(np.asarray(back.nes), np.asarray(sf.nes),
                               rtol=1e-6, atol=1e-6)
    # graph-independent stages still run on the restored band
    back.define_top_attributes(attribute_enrichment_min_size=2)


def test_forced_band_not_pinned_by_auto_rejection(net):
    """An 'auto' run that rejected the band plan (band too wide to pay) must
    not pin a later apsp_mode='band' run to the dense engine via the plan
    cache — the forced flag is part of the cache key."""
    path, n = net
    sf = SAFE(verbose=False)
    sf.random_seed = 7
    sf.load_network(network_file=path, node_key_attribute="key")
    sf.band_storage_min_nodes = 100
    sf.neighborhood_radius = 2.0  # whole graph within radius -> band ~ n
    coords, edges, lengths, _ = sf._graph_to_arrays_cached()
    x = coords[:, 0]
    nr = sf.neighborhood_radius * (np.max(x) - np.min(x))
    sf.apsp_mode = "auto"
    assert sf._band_storage_plan(coords, edges, lengths, n, nr) is None
    sf.apsp_mode = "band"
    assert sf._band_storage_plan(coords, edges, lengths, n, nr) is not None


@pytest.mark.slow
def test_band_hypergeom_hostchunks_matches_unchunked(net):
    """The host-driven K-sorted chunk driver (huge-N GO path) reproduces the
    single-dispatch banded hypergeometric results exactly."""
    path, n = net
    attrs = _binary_attrs(n, a=13, seed=14)
    plain = _run(path, attrs, "band", hypergeom_engine="loop")

    sf = SAFE(verbose=False)
    sf.apsp_mode = "band"
    sf.random_seed = 7
    # force the host-chunk driver at test scale (and keep the f64 tail loop:
    # the class-table engine would otherwise intercept binary annotations)
    sf.hypergeom_engine = "loop"
    sf._hypergeom_attr_chunk = lambda n_, a_, budget_elems=0: 4
    sf.load_network(network_file=path, node_key_attribute="key")
    sf.load_attributes(attribute_file=attrs)
    sf.run_pipeline()

    np.testing.assert_array_equal(np.asarray(sf.nes_binary),
                                  np.asarray(plain.nes_binary))
    np.testing.assert_array_equal(
        sf.attributes["num_neighborhoods_enriched"].values,
        plain.attributes["num_neighborhoods_enriched"].values)
    # identical tails modulo the per-chunk iteration bucket (both bounds are
    # sufficient, so the sums agree to f64 truncation)
    np.testing.assert_allclose(np.asarray(sf.nes), np.asarray(plain.nes),
                               rtol=1e-9, atol=1e-9)
    np.testing.assert_array_equal(sf.neighborhoods, plain.neighborhoods)


def test_band_session_full_downstream(net, tmp_path):
    """A band-engine session supports the entire downstream API: top
    attributes, domains, trimming, TSV reports, and both plot families."""
    import matplotlib
    matplotlib.use("Agg")
    path, n = net
    attrs = _binary_attrs(n, a=8, seed=21)
    sf = _run(path, attrs, "band")
    sf.define_top_attributes(attribute_enrichment_min_size=3)
    if int(sf.attributes["top"].sum()) >= 2:
        sf.define_domains(attribute_distance_threshold=0.9)
        sf.trim_domains(attribute_enrichment_min_size=2)
        assert sf.domains is not None
        fig, axes = sf.plot_composite_network(color_seed=0)
        assert len(axes) >= 2
    sf.print_output_files(output_dir=str(tmp_path) + "/")
    import os
    assert os.path.exists(tmp_path / "attribute_properties_annotation.txt")
    assert os.path.exists(tmp_path / "node_properties_annotation.txt")
    fig2 = sf.plot_sample_attributes(attributes=1, show_raw_data=True,
                                     save_fig=str(tmp_path / "attr.png"))
    assert (tmp_path / "attr.png").exists()


@pytest.mark.slow
def test_band_euclid_fused_matches_staged(net):
    """run_pipeline's fused euclidean band route == the staged path
    bit-for-bit (same key -> same compaction -> same permutations)."""
    path, n = net
    attrs = _quant_attrs(n, seed=22)
    staged = _run(path, attrs, "band", staged=True,
                  node_distance_metric="euclidean", num_permutations=90)
    fused = _run(path, attrs, "band",
                 node_distance_metric="euclidean", num_permutations=90)
    np.testing.assert_array_equal(fused.neighborhoods, staged.neighborhoods)
    np.testing.assert_array_equal(np.asarray(fused.ns),
                                  np.asarray(staged.ns))
    np.testing.assert_array_equal(
        np.nan_to_num(fused.pvalues_pos, nan=-1),
        np.nan_to_num(staged.pvalues_pos, nan=-1))


@pytest.mark.slow
def test_band_relax_bf_matches_fw(net):
    """The sparse Bellman-Ford relax engine (default at band scale) and the
    forced FW engine produce identical facade results on both statistics
    paths; the engine that ran is recorded in _band_relax_used."""
    path, n = net
    attrs = _binary_attrs(n, seed=11)
    bf = _run(path, attrs, "band", band_relax="bf")
    fw = _run(path, attrs, "band", band_relax="fw")
    assert bf._band_relax_used == "bf"
    assert fw._band_relax_used == "fw"
    np.testing.assert_array_equal(bf.neighborhoods, fw.neighborhoods)
    np.testing.assert_array_equal(bf.nes_binary, fw.nes_binary)
    np.testing.assert_allclose(np.asarray(bf.nes), np.asarray(fw.nes),
                               rtol=1e-6, atol=1e-6)

    quant = _quant_attrs(n, seed=12)
    bf_q = _run(path, quant, "band", band_relax="bf", num_permutations=100)
    fw_q = _run(path, quant, "band", band_relax="fw", num_permutations=100)
    assert bf_q._band_relax_used == "bf"
    # same indicator + same keyed draws => bit-identical permutation counts
    np.testing.assert_array_equal(bf_q.pvalues_pos, fw_q.pvalues_pos)
    np.testing.assert_allclose(bf_q.ns, fw_q.ns, rtol=1e-6, atol=1e-6)


def test_band_relax_unconverged_falls_back_to_fw(net, monkeypatch):
    """A BF run that hits its iteration budget re-dispatches FW transparently:
    results match the forced-FW run and the record says 'bf->fw'."""
    from safepy_tpu.ops import apsp_bandstore as bst

    monkeypatch.setattr(bst, "bf_max_iters",
                        lambda *a, **k: 1)  # force non-convergence
    path, n = net
    attrs = _binary_attrs(n, seed=13)
    fb = _run(path, attrs, "band", band_relax="bf")
    assert fb._band_relax_used == "bf->fw"
    fw = _run(path, attrs, "band", band_relax="fw")
    np.testing.assert_array_equal(fb.neighborhoods, fw.neighborhoods)
    np.testing.assert_array_equal(fb.nes_binary, fw.nes_binary)


@pytest.mark.slow
def test_band_gemm_downstream_matches_dense_scipy(net, tmp_path):
    """The FLAGSHIP configuration (band APSP + class-table hypergeometric +
    GEMM jaccard clustering + device aggregates) lands the same domains,
    assignments, and TSV reports as the all-host reference formulation
    (dense APSP + f64 loop + scipy linkage) on a shared run — the
    small-scale pin of the full downstream chain (reference
    safe.py:1380-1425 example flow)."""
    import matplotlib
    matplotlib.use("Agg")
    path, n = net
    attrs = _binary_attrs(n, a=10, seed=33)

    ref = _run(path, attrs, "full", hypergeom_engine="loop")
    ref.cluster_engine = "scipy"
    ref.define_top_attributes(attribute_enrichment_min_size=3)
    fast = _run(path, attrs, "band", hypergeom_engine="auto")
    fast.cluster_engine = "gemm"
    fast.define_top_attributes(attribute_enrichment_min_size=3)

    np.testing.assert_array_equal(fast.attributes["top"].values,
                                  ref.attributes["top"].values)
    if int(ref.attributes["top"].sum()) < 2:
        pytest.skip("fixture produced <2 top attributes")

    ref.define_domains(attribute_distance_threshold=0.9)
    ref.trim_domains(attribute_enrichment_min_size=2)
    fast.define_domains(attribute_distance_threshold=0.9)
    fast.trim_domains(attribute_enrichment_min_size=2)

    np.testing.assert_array_equal(fast.attributes["domain"].values,
                                  ref.attributes["domain"].values)
    pd.testing.assert_frame_equal(fast.node2domain, ref.node2domain)
    pd.testing.assert_frame_equal(fast.domains, ref.domains)

    (tmp_path / "ref").mkdir()
    (tmp_path / "fast").mkdir()
    ref.print_output_files(output_dir=str(tmp_path / "ref") + "/")
    fast.print_output_files(output_dir=str(tmp_path / "fast") + "/")
    for stem in ("node_properties_annotation.txt",
                 "attribute_properties_annotation.txt",
                 "domain_properties_annotation.txt"):
        t1 = pd.read_csv(tmp_path / "ref" / stem, sep="\t")
        t2 = pd.read_csv(tmp_path / "fast" / stem, sep="\t")
        # the class-table engine carries NES in f32 (within the 1e-6 parity
        # budget of the f64 loop), so numeric columns compare with tolerance
        pd.testing.assert_frame_equal(t2, t1, rtol=1e-5, atol=1e-6)


def test_column_accessors_match_full_matrices(net):
    """_nes_column / _nes_binary_column (the per-attribute plot panels' data
    path) slice the device arrays: values must equal the materialized
    matrices without having populated the host caches first."""
    path, n = net
    attrs = _binary_attrs(n, a=6, seed=11)
    sf = _run(path, attrs, "band")
    assert sf._nes_np is None and sf._nes_binary_i8_np is None
    col2 = sf._nes_column(2)
    bin2 = sf._nes_binary_column(2)
    # accessors must not have forced the (N, A) host materialization
    assert sf._nes_np is None and sf._nes_binary_i8_np is None
    np.testing.assert_array_equal(col2, np.asarray(sf.nes)[:, 2])
    np.testing.assert_array_equal(bin2, np.asarray(sf.nes_binary)[:, 2]
                                  .astype(bin2.dtype))


@pytest.mark.slow
def test_keep_node_distances_false_drops_distances_only(net):
    """keep_node_distances=False removes the f32 distance band from the
    fused band pipelines (the single biggest HBM object at scale — 9.3 GB
    at 299,520 nodes / 125-neighborhoods); every statistic is unchanged and
    node_distances is None for the run."""
    path, n = net
    qattrs = _quant_attrs(n, seed=12)
    ref = _run(path, qattrs, "band", num_permutations=150)

    sf = SAFE(verbose=False)
    sf.apsp_mode = "band"
    sf.random_seed = 7
    sf.keep_node_distances = False
    sf.load_network(network_file=path, node_key_attribute="key")
    sf.load_attributes(attribute_file=qattrs)
    sf.run_pipeline(num_permutations=150)
    assert sf._node_distances_dev is None and sf.node_distances is None
    np.testing.assert_array_equal(sf.neighborhoods, ref.neighborhoods)
    np.testing.assert_allclose(sf.ns, ref.ns, rtol=1e-6, atol=1e-6)
    # same seed, same engine: the null and NES are bit-identical
    np.testing.assert_array_equal(np.asarray(sf.nes), np.asarray(ref.nes))

    # binary (hypergeometric) band path honors the knob too
    battrs = _binary_attrs(n, seed=13)
    bref = _run(path, battrs, "band", hypergeom_engine="loop")
    sfb = SAFE(verbose=False)
    sfb.apsp_mode = "band"
    sfb.hypergeom_engine = "loop"
    sfb.random_seed = 7
    sfb.keep_node_distances = False
    sfb.load_network(network_file=path, node_key_attribute="key")
    sfb.load_attributes(attribute_file=battrs)
    sfb.run_pipeline()
    assert sfb._node_distances_dev is None and sfb.node_distances is None
    np.testing.assert_array_equal(sfb.nes_binary, bref.nes_binary)

    # euclidean band path: keep=False rides the int8-DIRECT indicator
    # (ops/apsp_bandstore.euclidean_band_indicator — the f32 band never
    # materializes); every statistic must match the keep=True run
    eref = SAFE(verbose=False)
    eref.apsp_mode = "band"
    eref.random_seed = 7
    eref.load_network(network_file=path, node_key_attribute="key")
    eref.load_attributes(attribute_file=qattrs)
    eref.run_pipeline(node_distance_metric="euclidean", num_permutations=60)
    sfe = SAFE(verbose=False)
    sfe.apsp_mode = "band"
    sfe.random_seed = 7
    sfe.keep_node_distances = False
    sfe.load_network(network_file=path, node_key_attribute="key")
    sfe.load_attributes(attribute_file=qattrs)
    sfe.run_pipeline(node_distance_metric="euclidean", num_permutations=60)
    assert sfe._node_distances_dev is None and sfe.node_distances is None
    np.testing.assert_array_equal(sfe.neighborhoods, eref.neighborhoods)
    np.testing.assert_array_equal(np.asarray(sfe.nes), np.asarray(eref.nes))

    # staged define_neighborhoods honors the knob on the euclid band path too
    sfs = SAFE(verbose=False)
    sfs.apsp_mode = "band"
    sfs.random_seed = 7  # same seed -> same layout -> same band plan
    sfs.keep_node_distances = False
    sfs.load_network(network_file=path, node_key_attribute="key")
    sfs.define_neighborhoods(node_distance_metric="euclidean")
    assert sfs._node_distances_dev is None and sfs.node_distances is None
    np.testing.assert_array_equal(sfs.neighborhoods, eref.neighborhoods)


@pytest.mark.slow
def test_band_split_front_matches_fused(net):
    """The giant-band SPLIT dispatch path (init -> donated relax -> tail,
    gated by band_split_min_bytes — exists because the fused program
    double-buffers the FW band, pipeline.band_relax_threshold) is
    results-identical to the fused pipeline."""
    path, n = net
    qattrs = _quant_attrs(n, seed=14)
    fused = _run(path, qattrs, "band", num_permutations=120)

    sf = SAFE(verbose=False)
    sf.apsp_mode = "band"
    sf.random_seed = 7
    sf.band_split_min_bytes = 0  # force the split at test scale
    sf.load_network(network_file=path, node_key_attribute="key")
    sf.load_attributes(attribute_file=qattrs)
    sf.run_pipeline(num_permutations=120)
    np.testing.assert_array_equal(sf.neighborhoods, fused.neighborhoods)
    np.testing.assert_array_equal(np.asarray(sf.node_distances),
                                  np.asarray(fused.node_distances))
    np.testing.assert_allclose(sf.ns, fused.ns, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(np.asarray(sf.nes), np.asarray(fused.nes))

    # staged define_neighborhoods rides the same split front; with
    # keep_node_distances=False it must leave node_distances None
    sf2 = SAFE(verbose=False)
    sf2.apsp_mode = "band"
    sf2.random_seed = 7
    sf2.band_split_min_bytes = 0
    sf2.keep_node_distances = False
    sf2.load_network(network_file=path, node_key_attribute="key")
    sf2.load_attributes(attribute_file=qattrs)
    sf2.define_neighborhoods()
    assert sf2.node_distances is None
    np.testing.assert_array_equal(sf2.neighborhoods, fused.neighborhoods)


def test_band_hypergeom_defers_nes_and_releases_upload(net):
    """GO-HBM-diet contract (the 199,680 x 4,373 OOM fix): the band table
    engine stores ONLY logsf + int8 indicator on device (NES derives lazily,
    -logsf/ln10, bitwise-consistent between the full matrix and the column
    slice), and the f32 annotation upload is released once the int8
    operands exist — a repeat run re-uploads and reproduces everything."""
    path, n = net
    attrs = _binary_attrs(n, a=7, seed=31)

    sf = SAFE(verbose=False)
    sf.apsp_mode = "band"
    sf.random_seed = 7
    sf.annotation_release_min_bytes = 1  # force the release at test scale
    sf.load_network(network_file=path, node_key_attribute="key")
    sf.load_attributes(attribute_file=attrs)
    sf.run_pipeline()
    assert sf._hypergeom_engine_used == "table-band"
    assert sf._n2a_dev is None          # upload released after operand build
    assert sf._nes_dev is None and sf._nes_from_logsf
    logsf = np.asarray(sf._logsf_dev, np.float64)

    # column slice BEFORE materializing the full matrix: must agree bitwise
    col3 = sf._nes_column(3)
    nes = np.asarray(sf.nes)            # materializes via _nes_device()
    assert sf._nes_dev is not None
    np.testing.assert_array_equal(col3, nes[:, 3])
    want = (-logsf / np.log(10.0)).astype(np.float32)
    np.testing.assert_array_equal(nes.astype(np.float32), want)

    # the released upload comes back lazily and a repeat run matches
    ref = _run(path, attrs, "band")
    np.testing.assert_array_equal(np.asarray(sf.nes_binary),
                                  np.asarray(ref.nes_binary))
    sf.run_pipeline()
    np.testing.assert_array_equal(np.asarray(sf.nes), np.asarray(ref.nes))
    np.testing.assert_array_equal(np.asarray(sf.nes_binary),
                                  np.asarray(ref.nes_binary))


def test_band_operand_cache_survives_runs_and_invalidates(net):
    """Cross-run int8 operand cache: a repeat run_pipeline must HIT
    `SAFE._band_operands_cache` (no re-derivation — at GO scale a miss costs
    a 3.49 GB re-upload per steady run), reloading attributes must
    invalidate it, and results stay correct either way."""
    path, n = net
    attrs = _binary_attrs(n, a=7, seed=33)

    sf = SAFE(verbose=False)
    sf.apsp_mode = "band"
    sf.random_seed = 7
    sf.annotation_release_min_bytes = 1  # exercise the release interplay
    sf.load_network(network_file=path, node_key_attribute="key")
    sf.load_attributes(attribute_file=attrs)
    sf.run_pipeline()
    assert sf._hypergeom_engine_used.startswith("table")
    cache1 = sf._band_operands_cache
    assert cache1 is not None
    nes1 = np.asarray(sf.nes_binary).copy()

    # repeat run: same cache entry object (hit), identical results
    sf.run_pipeline()
    assert sf._band_operands_cache is cache1
    assert cache1[1][0] is sf._band_operands_cache[1][0]  # same device array
    np.testing.assert_array_equal(np.asarray(sf.nes_binary), nes1)

    # reloading attributes bumps the serial and invalidates the cache
    attrs2 = _binary_attrs(n, a=7, seed=34)
    sf.load_attributes(attribute_file=attrs2)
    assert sf._band_operands_cache is None
    sf.run_pipeline()
    cache2 = sf._band_operands_cache
    assert cache2 is not None and cache2[0] != cache1[0]

    # fresh-object oracle for the new annotations
    ref = _run(path, attrs2, "band")
    np.testing.assert_array_equal(np.asarray(sf.nes_binary),
                                  np.asarray(ref.nes_binary))
