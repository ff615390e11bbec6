"""Matmul precision knob: 'default' (the backend's fast f32 path — TF32 on an
NVIDIA GPU) agrees statistically with 'highest' (exact f32) on the
permutation null."""

import networkx as nx
import numpy as np
import pandas as pd
import pytest

from safepy_tpu import SAFE


def test_precision_modes_agree(tmp_path, rng):
    n = 80
    g = nx.connected_watts_strogatz_graph(n, 6, 0.3, seed=12)
    path = tmp_path / "net.txt"
    with open(path, "w") as f:
        for u, v in g.edges():
            f.write(f"g{u}\tg{v}\t1.0\n")

    vals = rng.normal(size=(n, 1))
    results = {}
    for precision in ("highest", "default"):
        sf = SAFE(verbose=False)
        sf.random_seed = 9
        sf.matmul_precision = precision
        sf.load_network(network_file=str(path), node_key_attribute="key")
        sf.load_attributes(attribute_file=pd.DataFrame(
            vals, index=[f"g{i}" for i in range(n)], columns=["q"]))
        sf.run_pipeline(num_permutations=200)
        results[precision] = sf.pvalues_pos.copy()

    # same seed, same permutations; only matmul rounding differs -> p-values
    # shift by at most a few counts at exact ties
    diff = np.abs(results["highest"] - results["default"])
    assert np.nanmax(diff) <= 5 / 200.0
    # and the bulk is identical
    assert np.mean(diff == 0) > 0.9


def _geometric_net(tmp_path, rng, n):
    """A geometric network every engine (dense window / band-storage) serves."""
    import networkx as nx

    coords = rng.uniform(-1, 1, (n, 2))
    g = nx.Graph()
    g.add_nodes_from(range(n))
    from scipy.spatial import cKDTree
    _, nn = cKDTree(coords).query(coords, k=6)
    for i in range(n):
        for j in nn[i, 1:]:
            g.add_edge(i, int(j))
    for i in range(n):
        g.nodes[i]["label"] = g.nodes[i]["key"] = f"g{i}"
        g.nodes[i]["x"] = float(coords[i, 0])
        g.nodes[i]["y"] = float(coords[i, 1])
    from safepy_tpu.io.layout import calculate_edge_lengths
    calculate_edge_lengths(g, verbose=False)
    return g


def _zscore_oracle(nbr, vals):
    """f64 host z-score, the reference formula (safe_extras.py:19-31)."""
    mask = np.isfinite(vals)
    B = np.where(mask, vals, 0.0)
    A64 = np.asarray(nbr, np.float64)
    N = A64 @ mask.astype(np.float64)
    sN = np.where(N > 0, N, 1)
    M = (A64 @ B) / sN
    EXX = (A64 @ (B * B)) / sN
    std = np.sqrt(np.maximum(EXX - M * M, 0))
    return np.where((std > 0) & (N >= 3), M / np.where(std > 0, std, 1),
                    np.nan)


def test_zscore_centered_conditioning_dense_and_band(tmp_path, rng):
    """Mean-offset data (the E[X^2]-E[X]^2 killer): both the dense and the
    band-storage z-score engines stay at the f32 GEMM floor (~2e-6) vs the
    f64 oracle, and their null p-values agree to a couple of tie counts.
    Pre-shift the dense path measured 1.8e-5 on this data class."""
    n = 500
    g = _geometric_net(tmp_path, rng, n)
    vals = rng.normal(loc=3.0, scale=0.4, size=(n, 2))
    vals[rng.random((n, 2)) < 0.3] = np.nan
    attrs = pd.DataFrame(vals, index=[f"g{i}" for i in range(n)],
                         columns=["q0", "q1"])

    scores, pvals = {}, {}
    for mode in ("dense", "band"):
        sf = SAFE(verbose=False)
        sf.random_seed = 11
        if mode == "band":
            sf.apsp_mode = "band"
            sf.band_storage_min_nodes = 100
        sf.load_network(network_file=g, node_key_attribute="key")
        sf.load_attributes(attribute_file=attrs)
        sf.run_pipeline(neighborhood_score_type="z-score",
                        num_permutations=200)
        scores[mode] = np.asarray(sf.ns, np.float64)
        pvals[mode] = sf.pvalues_pos.copy()
        oracle = _zscore_oracle(np.asarray(sf.neighborhoods), vals)
        fin = np.isfinite(oracle)
        np.testing.assert_array_equal(fin, np.isfinite(scores[mode]))
        np.testing.assert_allclose(scores[mode][fin], oracle[fin],
                                   rtol=2e-6, atol=2e-6, err_msg=mode)

    # the engines sample INDEPENDENT keyed permutations: compare per-cell
    # counts within a 6-sigma binomial envelope (the established band-vs-dense
    # null idiom, test_bandstore_facade.py)
    p = np.clip(pvals["dense"], 1 / 200, 1 - 1 / 200)
    sigma = np.sqrt(200 * p * (1 - p))
    diff = np.abs(pvals["band"] - pvals["dense"]) * 200
    assert np.nanmax(diff - 6 * sigma) <= 0
    np.testing.assert_array_equal(np.isnan(pvals["band"]),
                                  np.isnan(pvals["dense"]))


def test_zscore_null_tie_counts_stable_across_precisions(tmp_path, rng):
    """The centered z-score null's tie counts must not be
    an artifact of matmul precision — 'highest' vs 'default' p-values agree
    except at a few exact ties."""
    n = 120
    g = _geometric_net(tmp_path, rng, n)
    vals = rng.normal(loc=3.0, scale=0.4, size=(n, 1))
    vals[rng.random(n) < 0.2, 0] = np.nan
    attrs = pd.DataFrame(vals, index=[f"g{i}" for i in range(n)],
                         columns=["q"])

    results = {}
    for precision in ("highest", "default"):
        sf = SAFE(verbose=False)
        sf.random_seed = 23
        sf.matmul_precision = precision
        sf.load_network(network_file=g, node_key_attribute="key")
        sf.load_attributes(attribute_file=attrs)
        sf.run_pipeline(neighborhood_score_type="z-score",
                        num_permutations=200)
        results[precision] = sf.pvalues_pos.copy()

    # z-scores are continuous, so bf16 ('default') rounding may flip
    # comparisons where a permuted score lands within its noise of obs —
    # unlike the integer-valued sum scores, bit-identity is not required;
    # stability means every p-value moves by at most a few counts and the
    # bulk by <= 1. (On the CPU test mesh the precisions coincide and the
    # diff is exactly zero; the bound bites on a GPU's TF32 path.)
    np.testing.assert_array_equal(np.isnan(results["highest"]),
                                  np.isnan(results["default"]))
    diff = np.abs(results["highest"] - results["default"])
    fin = np.isfinite(diff)
    assert fin.any()
    assert np.nanmax(diff[fin]) <= 5 / 200.0
    assert np.mean(diff[fin] <= 1 / 200.0) > 0.9
