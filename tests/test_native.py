"""Native C++ edge-list parser: identical graphs to the pandas engine."""

import gzip

import networkx as nx
import numpy as np
import pytest

from safepy_tpu import native
from safepy_tpu.io.network import load_network_from_txt

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="g++ toolchain unavailable")


def _graphs_identical(g1, g2):
    assert list(g1.nodes) == list(g2.nodes)
    assert set(g1.edges) == set(g2.edges)
    for n in g1:
        assert g1.nodes[n]["label"] == g2.nodes[n]["label"]
        assert g1.nodes[n].get("key") == g2.nodes[n].get("key")


def test_3col_parity(tmp_path):
    path = str(tmp_path / "net.txt")
    with open(path, "w") as f:
        f.write("b\ta\t1.0\n")      # node order: b, a, c — first-appearance
        f.write("a\tc\t2.0\n")
        f.write("c\tb\t0.5\n")
    g_native = load_network_from_txt(path, seed=1, verbose=False, engine="native")
    g_python = load_network_from_txt(path, seed=1, verbose=False, engine="python")
    _graphs_identical(g_native, g_python)
    # seeded layout on identical node order -> identical coordinates
    for n in g_native:
        assert g_native.nodes[n]["x"] == g_python.nodes[n]["x"]


def test_5col_parity_gz(tmp_path):
    path = str(tmp_path / "net.txt.gz")
    with gzip.open(path, "wt") as f:
        f.write("geneB\tORFB\tgeneA\tORFA\t1.5\n")
        f.write("geneA\tORFA\tgeneC\tORFC\t2.0\n")
    g_native = load_network_from_txt(path, node_key_attribute="label_orf",
                                     seed=0, verbose=False, engine="native")
    g_python = load_network_from_txt(path, node_key_attribute="label_orf",
                                     seed=0, verbose=False, engine="python")
    assert list(g_native.nodes) == list(g_python.nodes)
    for n in g_native:
        assert g_native.nodes[n]["label"] == g_python.nodes[n]["label"]
        assert g_native.nodes[n]["label_orf"] == g_python.nodes[n]["label_orf"]


def test_parse_edgelist_arrays(tmp_path):
    path = str(tmp_path / "net.txt")
    with open(path, "w") as f:
        f.write("x\ty\t3.25\ny\tz\t1.0\n")
    labels, keys, edges, weights = native.parse_edgelist(path, 3)
    assert labels == ["x", "y", "z"]
    assert keys == ["x", "y", "z"]
    np.testing.assert_array_equal(edges, [[0, 1], [1, 2]])
    np.testing.assert_allclose(weights, [3.25, 1.0])


def test_column_mismatch_error(tmp_path):
    path = str(tmp_path / "bad.txt")
    with open(path, "w") as f:
        f.write("a\tb\n")
    with pytest.raises(ValueError, match="expected 3 columns"):
        native.parse_edgelist(path, 3)


def test_large_roundtrip_speed(tmp_path, rng):
    """Sanity at scale: 100k edges parse correctly (and quickly)."""
    import time
    path = str(tmp_path / "big.txt")
    e = rng.integers(0, 20000, (100000, 2))
    with open(path, "w") as f:
        for u, v in e:
            f.write(f"n{u}\tn{v}\t1.0\n")
    t0 = time.time()
    labels, keys, edges, weights = native.parse_edgelist(path, 3)
    native_s = time.time() - t0
    assert len(weights) == 100000
    assert len(labels) == len(set(labels))
    # generous bound: ~0.1 s alone, but the suite runs several workers on
    # few host cores
    assert native_s < 20.0
