"""Example 4 — SAFE on networks far beyond the reference's reach.

The reference holds three dense (N, N) matrices on the host (distances,
neighborhoods, and the pdist of safe_io.py:318-331), which caps practical
network size around a few tens of thousands of nodes. safepy_tpu's
band-STORAGE engine (ops/apsp_bandstore.py) keeps every N x N object as a
radius-certified band of width W ~ sqrt(N * neighborhood_size), so one
device runs ~100k-node networks and a 'data' mesh scales further
(parallel/band_sharded.py).

Nothing about the API changes: the facade auto-selects the engine above
``SAFE.band_storage_min_nodes`` (32,768 by default). This example forces it at
demo scale with ``apsp_mode='band'`` so it runs anywhere, and prints the
accessors that replace the (guarded) dense matrices at huge N.
"""

import numpy as np
import pandas as pd
import networkx as nx

from safepy_tpu import SAFE
from safepy_tpu.io.layout import calculate_edge_lengths


def build_network(n=3000, k=8, seed=0):
    """k-nearest-neighbor geometric graph with embedded layout coordinates —
    scale `n` up to ~100k on a GPU (radius ~ sqrt(125 / (pi * n)) keeps
    neighborhoods local; chip_smoke.py runs 49,920 nodes)."""
    rng = np.random.default_rng(seed)
    coords = rng.uniform(-1, 1, (n, 2))
    from scipy.spatial import cKDTree
    _, nn = cKDTree(coords).query(coords, k=k)
    src = np.repeat(np.arange(n), k - 1)
    dst = nn[:, 1:].ravel()
    edges = np.unique(np.stack([np.minimum(src, dst),
                                np.maximum(src, dst)], 1), axis=0)
    g = nx.Graph()
    g.add_nodes_from(range(n))
    g.add_edges_from(edges)
    for i in range(n):
        g.nodes[i]["label"] = g.nodes[i]["key"] = f"gene{i}"
        g.nodes[i]["x"] = float(coords[i, 0])
        g.nodes[i]["y"] = float(coords[i, 1])
    calculate_edge_lengths(g, verbose=False)
    return g


def main():
    n = 3000
    g = build_network(n)

    rng = np.random.default_rng(1)
    vals = rng.normal(size=(n, 1))
    vals[rng.random(n) < 0.3, 0] = np.nan
    attrs = pd.DataFrame(vals, index=[f"gene{i}" for i in range(n)],
                         columns=["fitness defect"])

    sf = SAFE(verbose=False)
    sf.apsp_mode = "band"      # auto above sf.band_storage_min_nodes (32768)
    sf.random_seed = 17
    # sf.mesh = make_mesh({"data": 4})  # row-shard the band over 4 GPUs
    sf.load_network(network_file=g, node_key_attribute="key")
    sf.load_attributes(attribute_file=attrs)
    sf.run_pipeline(num_permutations=500)   # one fused device dispatch

    print(f"enriched neighborhoods: {int((sf.nes_binary > 0).sum())}")
    # at huge N the dense matrices are guarded; use the sparse accessors:
    nbr = sf.neighborhoods_sparse()
    print(f"neighborhood indicator: {nbr.shape}, {nbr.nnz} non-zeros")
    dist = sf.node_distances_sparse()
    print(f"within-radius distances: {dist.nnz} pairs")

    sf.define_top_attributes(attribute_enrichment_min_size=5)
    print(f"top attributes: {int(sf.attributes['top'].sum())}")

    # Domain clustering also scales: above ~96 top attributes the jaccard
    # linkage input comes from one device intersection GEMM (bit-identical
    # to scipy's pdist, which alone takes HOURS at 100k x 4,373 — see
    # docs/DESIGN.md "The domain stage on the device"); force with
    # sf.cluster_engine = 'gemm'.
    if int(sf.attributes["top"].sum()) >= 2:
        sf.define_domains()
        sf.trim_domains()
        print(f"domains: {len(sf.domains) - 1}")


if __name__ == "__main__":
    main()
