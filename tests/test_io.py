"""Loader tests: every network/attribute format the reference supports,
exercised on synthetic fixtures (including a constructed .mat and .cys)."""

import gzip
import os
import pickle
import zipfile

import networkx as nx
import numpy as np
import pandas as pd
import pytest
import scipy.io as spio

from safepy_tpu.io import (apply_network_layout, calculate_edge_lengths,
                           load_network_from_cys, load_network_from_gpickle,
                           load_network_from_mat, load_network_from_scatter,
                           load_network_from_txt, read_attributes)
from safepy_tpu.io.graph_arrays import chop_and_filter, graph_to_arrays


def _write_3col(path, edges):
    with open(path, "w") as f:
        for u, v in edges:
            f.write(f"g{u}\tg{v}\t1.0\n")


def test_txt_3col(tmp_path):
    path = str(tmp_path / "net.txt")
    _write_3col(path, [(0, 1), (1, 2), (2, 0), (2, 3)])
    g = load_network_from_txt(path, seed=1, verbose=False)
    assert g.number_of_nodes() == 4
    assert g.number_of_edges() == 4
    assert all("x" in g.nodes[n] for n in g)
    assert all("length" in d for _, _, d in g.edges(data=True))
    assert g.nodes[0]["label"] == "g0"
    assert g.nodes[0]["key"] == "g0"


def test_txt_5col_and_gz(tmp_path):
    path = str(tmp_path / "net.txt.gz")
    with gzip.open(path, "wt") as f:
        for u, v in [(0, 1), (1, 2)]:
            f.write(f"label{u}\tORF{u}\tlabel{v}\tORF{v}\t2.5\n")
    g = load_network_from_txt(path, node_key_attribute="label_orf", seed=0,
                              verbose=False)
    assert g.number_of_nodes() == 3
    assert g.nodes[0]["label"] == "label0"
    assert g.nodes[0]["label_orf"] == "ORF0"


def test_tsv_with_header(tmp_path):
    path = str(tmp_path / "net.tsv")
    with open(path, "w") as f:
        f.write("source\ttarget\tweight\n")
        f.write("a\tb\t1.0\na\tc\t1.0\n")
    g = load_network_from_txt(path, seed=0, verbose=False)
    assert g.number_of_nodes() == 3


def test_gpickle_roundtrip(tmp_path):
    g = nx.path_graph(5)
    for n in g:
        g.nodes[n]["x"] = float(n)
        g.nodes[n]["y"] = 0.0
        g.nodes[n]["label"] = f"n{n}"
        g.nodes[n]["key"] = f"n{n}"
    path = str(tmp_path / "g.gpickle")
    with open(path, "wb") as f:
        pickle.dump(g, f)
    g2 = load_network_from_gpickle(path)
    assert nx.utils.graphs_equal(g, g2)


def test_mat_loader(tmp_path):
    """Construct a legacy MATLAB SAFE session and load it."""
    n = 5
    adjacency = np.zeros((n, n))
    for u, v in [(0, 1), (1, 2), (2, 3), (3, 4), (4, 0)]:
        adjacency[u, v] = adjacency[v, u] = 1
    layout = {
        "edges": adjacency,
        "label": np.array([f"gene{i}" for i in range(n)], dtype=object),
        "label_orf": np.array([f"ORF{i}" for i in range(n)], dtype=object),
        "x": np.arange(n, dtype=float),
        "y": np.arange(n, dtype=float) * 2,
    }
    path = str(tmp_path / "session.mat")
    spio.savemat(path, {"layout": layout})
    g = load_network_from_mat(path, verbose=False)
    assert g.number_of_nodes() == n
    assert g.number_of_edges() == 5
    assert g.nodes[0]["key"] == "ORF0"
    assert g.nodes[2]["x"] == 2.0
    assert all("length" in d for _, _, d in g.edges(data=True))


def _make_cys(path):
    """Minimal Cytoscape bundle: XGMML view + network XML + attrs cytable."""
    view = """<?xml version="1.0"?>
<graph xmlns:cy="http://www.cytoscape.org">
  <node label="geneA" cy:nodeId="101"><graphics x="0.0" y="0.0"/></node>
  <node label="geneB" cy:nodeId="102"><graphics x="1.0" y="0.0"/></node>
  <node label="geneC" cy:nodeId="103"><graphics x="0.0" y="1.0"/></node>
</graph>"""
    net = """<?xml version="1.0"?>
<graph>
  <edge source="101" target="102"/>
  <edge source="102" target="103"/>
</graph>"""
    cytable = ("SUID,shared name,label_orf\n"
               "SUID,shared name,label_orf\n"
               "101,geneA,ORFA\n102,geneB,ORFB\n103,geneC,ORFC\n")
    with zipfile.ZipFile(path, "w") as zf:
        zf.writestr("session/views/view1.xgmml", view)
        zf.writestr("session/networks/net1.xgmml", net)
        zf.writestr("session/tables/net1/SHARED_ATTRSdef node.cytable", cytable)


def test_cys_loader(tmp_path):
    path = str(tmp_path / "session.cys")
    _make_cys(path)
    g = load_network_from_cys(path, verbose=False)
    assert g.number_of_nodes() == 3
    assert g.number_of_edges() == 2
    # relabeled to 0..N-1 with coordinates and table attributes
    assert set(g.nodes) == {0, 1, 2}
    labels = nx.get_node_attributes(g, "label")
    assert set(labels.values()) == {"geneA", "geneB", "geneC"}
    orfs = nx.get_node_attributes(g, "label_orf")
    assert set(orfs.values()) == {"ORFA", "ORFB", "ORFC"}


def test_scatter_loader(tmp_path):
    path = str(tmp_path / "emb.scatter")
    with open(path, "w") as f:
        f.write("key\tx\ty\tlabel\n")
        for i in range(4):
            f.write(f"k{i}\t{i}.0\t{i}.5\tlab{i}\n")
    g = load_network_from_scatter(path, verbose=False)
    assert g.number_of_nodes() == 4
    assert g.number_of_edges() == 0
    assert g.nodes[1]["x"] == 1.0


def test_read_attributes_txt_and_dedup(tmp_path):
    path = str(tmp_path / "attrs.txt")
    with open(path, "w") as f:
        f.write("gene\ta1\ta2\n")
        f.write("g0\t1.0\t0.0\n")
        f.write("g1\t2.0\t1.0\n")
        f.write("g1\t4.0\t3.0\n")  # duplicate label -> averaged
        f.write("gX\t9.0\t9.0\n")  # not in network
    attrs, order, values = read_attributes(
        attribute_file=path, node_label_order=["g0", "g1", "g2"], verbose=False)
    assert attrs.shape[0] == 2
    np.testing.assert_allclose(values[0], [1.0, 0.0])
    np.testing.assert_allclose(values[1], [3.0, 2.0])  # averaged
    assert np.isnan(values[2]).all()  # unmatched network node


def test_read_attributes_preserves_source_float_dtype(tmp_path):
    # The txt loader downcasts to float32; read_attributes must hand that
    # dtype through (re-expanding to f64 measured 109 s of conversion writes
    # at GO scale). Non-float sources (e.g. the .mat loader's unsigned ints)
    # still promote to f64, and an explicitly-f64 DataFrame stays f64.
    path = str(tmp_path / "attrs.txt")
    with open(path, "w") as f:
        f.write("gene\ta1\na\t1.5\nb\t2.5\n")
    _, _, vals = read_attributes(attribute_file=path,
                                 node_label_order=["a", "b"], verbose=False)
    assert vals.dtype == np.float32
    np.testing.assert_allclose(vals[:, 0], [1.5, 2.5])

    df64 = pd.DataFrame({"a": [1.0, 2.0]}, index=["x", "y"])
    _, _, vals64 = read_attributes(attribute_file=df64,
                                   node_label_order=["x", "y"], verbose=False)
    assert vals64.dtype == np.float64

    dfint = pd.DataFrame({"a": np.array([1, 0], dtype=np.int64)},
                         index=["x", "y"])
    _, _, valsi = read_attributes(attribute_file=dfint,
                                  node_label_order=["x", "y"], verbose=False)
    assert valsi.dtype == np.float64


def test_read_attributes_dataframe_and_mask(rng):
    df = pd.DataFrame({"a": [1.0, 2.0, 3.0]}, index=["x", "y", "y"])
    attrs, order, values = read_attributes(
        attribute_file=df, node_label_order=["x", "y", "y"], verbose=False,
        mask_duplicates=True, rng=rng)
    # one of the duplicated 'y' rows survives
    assert np.isnan(values).sum() == 1


def test_read_attributes_mat(tmp_path):
    go = {
        "term2orf": np.array([[1, 0, 1], [0, 1, 0]]),  # terms x orfs
        "orfs": np.array(["o1", "o2", "o3"], dtype=object),
        "term_ids": np.array(["GO:1", "GO:2"], dtype=object),
        "term_names": np.array(["term one", "term two"], dtype=object),
    }
    path = str(tmp_path / "go.mat")
    spio.savemat(path, {"go": go})
    attrs, order, values = read_attributes(
        attribute_file=path, node_label_order=["o1", "o3"], verbose=False)
    assert list(attrs["name"]) == ["term one", "term two"]
    np.testing.assert_allclose(values, [[1, 0], [1, 0]])


def test_layouts_deterministic():
    g = nx.path_graph(8)
    g1 = apply_network_layout(nx.path_graph(8), "spring_embedded", seed=5,
                              verbose=False)
    g2 = apply_network_layout(nx.path_graph(8), "spring_embedded", seed=5,
                              verbose=False)
    assert all(g1.nodes[n]["x"] == g2.nodes[n]["x"] for n in g1)

    g3 = apply_network_layout(nx.path_graph(8), "spring_device", seed=5,
                              verbose=False)
    assert all(np.isfinite(g3.nodes[n]["x"]) for n in g3)


def test_edge_lengths_match_coords():
    g = nx.Graph([(0, 1), (1, 2)])
    coords = {0: (0.0, 0.0), 1: (3.0, 4.0), 2: (3.0, 8.0)}
    for n, (x, y) in coords.items():
        g.nodes[n]["x"] = x
        g.nodes[n]["y"] = y
    calculate_edge_lengths(g, verbose=False)
    assert g.edges[0, 1]["length"] == 5.0
    assert g.edges[1, 2]["length"] == 4.0


def test_graph_to_arrays():
    g = nx.Graph([(0, 1)])
    g.nodes[0].update(x=0.0, y=0.0)
    g.nodes[1].update(x=1.0, y=1.0)
    calculate_edge_lengths(g, verbose=False)
    coords, edges, lengths, weights = graph_to_arrays(g)
    assert coords.shape == (2, 2)
    assert edges.shape == (1, 2)
    np.testing.assert_allclose(lengths, [np.sqrt(2)])
    np.testing.assert_allclose(weights, [1.0])


def test_weighted_graph_parity():
    """Edge 'weight' attributes scale lengths (reference safe_io.py:324-328) and
    drive the plain shortpath metric (reference safe.py:409)."""
    g = nx.Graph()
    g.add_edge(0, 1, weight=2.0)
    g.add_edge(1, 2, weight=0.5)
    coords = {0: (0.0, 0.0), 1: (3.0, 4.0), 2: (6.0, 8.0)}
    for n, (x, y) in coords.items():
        g.nodes[n]["x"] = x
        g.nodes[n]["y"] = y
    calculate_edge_lengths(g, verbose=False)
    assert g.edges[0, 1]["length"] == 10.0   # 5 * 2
    assert g.edges[1, 2]["length"] == 2.5    # 5 * 0.5
    _, _, lengths, weights = graph_to_arrays(g)
    np.testing.assert_allclose(sorted(weights), [0.5, 2.0])


def test_chop_and_filter():
    s = pd.Series(["regulation of DNA repair", "DNA repair", "repair of the DNA"])
    label = chop_and_filter(s)
    assert "DNA" in label and "repair" in label and "of" not in label.split(", ")


def test_spring_device_layout_quality():
    """The accelerator FR layout must place graph neighbors closer than
    non-neighbors on average (same qualitative property as nx spring)."""
    from safepy_tpu.io.layout import spring_layout_device
    g = nx.connected_watts_strogatz_graph(40, 4, 0.1, seed=3)
    pos = spring_layout_device(g, seed=0)
    coords = np.array([pos[i] for i in range(40)])
    d = np.linalg.norm(coords[:, None] - coords[None, :], axis=-1)
    adj = nx.to_numpy_array(g) > 0
    off = ~adj & ~np.eye(40, dtype=bool)
    assert d[adj].mean() < 0.7 * d[off].mean()


def test_facade_layout_algorithm_config(tmp_path):
    """layoutAlgorithm from the INI selects the txt-loader layout engine."""
    from safepy_tpu import SAFE
    net = tmp_path / "net.txt"
    with open(net, "w") as f:
        for u, v in nx.path_graph(12).edges():
            f.write(f"g{u}\tg{v}\t1.0\n")
    ini = tmp_path / "cfg.ini"
    ini.write_text(f"[Input files]\nnetworkfile = {net}\n"
                   "layoutAlgorithm = spring_device\n"
                   "[Analysis parameters]\nrandomSeed = 3\n")
    sf = SAFE(path_to_ini_file=str(ini), verbose=False)
    assert sf.layout_algorithm == "spring_device"
    sf.load_network(node_key_attribute="key")
    assert all(np.isfinite(sf.graph.nodes[n]["x"]) for n in sf.graph)
