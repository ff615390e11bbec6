"""Benchmark: Example_1-equivalent end-to-end SAFE on Costanzo scale.

Synthetic stand-in for the Costanzo-2016 run (the real safe-data bundle is not
vendored): 3,971 nodes / 28,202 edges with embedded layout coordinates, one
quantitative attribute, shortpath_weighted_layout neighborhoods (blocked
Floyd-Warshall APSP) and a 1,000-permutation empirical null — the exact
pipeline shape of the reference's default workflow (safepy/safe_default.ini +
tests/test_enrichments.py TestEnrichmentPermutations). A second part runs the
band-storage engine at 49,920 nodes x 2,048 GO-like terms.

Runs on a GPU only, in one process, and refuses anything else. Prints the
card's name and power limit, then ONE JSON line with the device as JAX reports
it and steady-state times taken with ``block_until_ready``:

    python bench.py [--nodes N --attributes A --binary --permutations P]

The data generators here (``knn_network``, ``network_graph``,
``go_annotations``, ``quantitative_attribute``) are shared with
chip_smoke.py.
"""

import json
import os
import sys
import time

import numpy as np

N_NODES = 3971
N_EDGES = 28202
BAND_NODES = 49920
BAND_ATTRS = 2048
# Costanzo GO-BP matrix (BASELINE.md): 795,886 NaNs of 3,971 x 4,373 cells
GO_NAN_FRACTION = 795886 / (3971 * 4373)


def knn_network(seed=0, n=N_NODES, k=16, edge_budget=N_EDGES):
    """Synthetic geometric network without networkx: k-nearest-neighbor
    edges over uniform coordinates in [-1, 1]^2, optionally capped at an
    edge budget. Returns (coords (n, 2) f64, edges (E, 2) int64 with
    u < v, lengths (E,) f64 — the Euclidean endpoint distances, the
    shortpath_weighted_layout contract)."""
    from scipy.spatial import cKDTree

    rng = np.random.default_rng(seed)
    coords = rng.uniform(-1, 1, (n, 2))
    _, nn = cKDTree(coords).query(coords, k=k)
    edges = {}
    for i in range(n):
        for j in nn[i, 1:]:
            edges.setdefault((min(i, int(j)), max(i, int(j))), None)
            if edge_budget and len(edges) >= edge_budget:
                break
        if edge_budget and len(edges) >= edge_budget:
            break
    edges = np.array(list(edges), dtype=np.int64).reshape(-1, 2)
    lengths = np.hypot(*(coords[edges[:, 0]] - coords[edges[:, 1]]).T)
    return coords, edges, lengths


def build_network(seed=0, n=N_NODES, k=16, edge_budget=N_EDGES,
                  prefix="gene"):
    """:func:`knn_network` as the networkx graph ``SAFE.load_network``
    takes. Returns (graph, coords)."""
    coords, edges, lengths = knn_network(seed, n, k, edge_budget)
    return network_graph(coords, edges, lengths, prefix), coords


def network_graph(coords, edges, lengths, prefix):
    """networkx graph of :func:`knn_network` arrays, with the node attributes
    every loader in the framework expects and 'length' edge attributes."""
    import networkx as nx

    n = len(coords)
    g = nx.Graph()
    for i in range(n):
        g.add_node(i, label=f"{prefix}{i}", key=f"{prefix}{i}",
                   x=float(coords[i, 0]), y=float(coords[i, 1]))
    g.add_edges_from((int(u), int(v), {"length": float(d)})
                     for (u, v), d in zip(edges, lengths))
    return g


def go_annotations(rng, n, a, nan_fraction):
    """Binary GO-like (n, a) term matrix: heavy-tailed term sizes from 5 to
    3% of the nodes (log-uniform; ~0.9% positives at Costanzo scale, as the
    real GO-BP matrix), ``nan_fraction`` of the cells NaN."""
    sizes = np.exp(rng.uniform(np.log(5), np.log(0.03 * n), a))
    vals = (rng.random((n, a)) < (sizes / n)[None, :]).astype(np.float32)
    vals[rng.random((n, a)) < nan_fraction] = np.nan
    return vals


def quantitative_attribute(rng, n, nan_fraction):
    """One normal quantitative attribute with ``nan_fraction`` NaN."""
    vals = rng.normal(size=(n, 1))
    vals[rng.random(n) < nan_fraction, 0] = np.nan
    return vals


def sync(sf):
    """Wait until every device array the SAFE session holds is computed."""
    import jax
    jax.block_until_ready([v for v in vars(sf).values()
                           if isinstance(v, jax.Array)])


def timed(fn, *args, **kwargs):
    """(result, seconds) of one call, finished with block_until_ready."""
    import jax
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args, **kwargs))
    return out, time.perf_counter() - t0


def _pipeline_wall(sf, attr_df, **kwargs):
    t0 = time.perf_counter()
    sf.load_attributes(attribute_file=attr_df)
    sf.run_pipeline(**kwargs)
    sync(sf)
    return time.perf_counter() - t0


def main(argv=None):
    import argparse

    parser = argparse.ArgumentParser(description="safepy_tpu benchmarks")
    parser.add_argument("--nodes", type=int, default=N_NODES,
                        help="network size (default: Costanzo scale)")
    parser.add_argument("--attributes", type=int, default=1,
                        help="number of attributes (binary GO-style with "
                             "--binary)")
    parser.add_argument("--binary", action="store_true",
                        help="binary annotations -> hypergeometric engine")
    parser.add_argument("--permutations", type=int, default=1000)
    parser.add_argument("--radius", type=float, default=None,
                        help="neighborhood radius override (fraction of the "
                             "x-extent); scale runs hold the mean neighborhood "
                             "size constant with radius ~ sqrt(125/(pi*N))")
    args = parser.parse_args(argv)

    import pandas as pd
    from safepy_tpu import SAFE
    from safepy_tpu.profiling import card_line, device_summary, require_gpu

    devices = require_gpu()
    print(card_line(), flush=True)
    device = device_summary(devices)

    if (args.nodes != N_NODES or args.attributes != 1 or args.binary
            or args.radius is not None):
        detail = _custom_bench(args)
    else:
        g, _coords = build_network()
        rng = np.random.default_rng(1)
        attr_df = pd.DataFrame(quantitative_attribute(rng, N_NODES, 0.33),
                               index=[f"gene{i}" for i in range(N_NODES)],
                               columns=["synthetic quantitative attribute"])
        sf = SAFE(verbose=False)
        sf.random_seed = 1885
        sf.load_network(network_file=g, node_key_attribute="key")
        first = _pipeline_wall(sf, attr_df,
                               num_permutations=args.permutations)
        walls = [_pipeline_wall(sf, attr_df,
                                num_permutations=args.permutations)
                 for _ in range(3)]
        detail = {"nodes": N_NODES, "edges": g.number_of_edges(),
                  "num_permutations": args.permutations,
                  "first_run_s": first, "steady_walls_s": walls,
                  "e2e_steady_min_s": min(walls)}
        detail.update(_apsp_and_null(sf, args.permutations))
        if os.environ.get("SAFEPY_BENCH_BAND", "1") != "0":
            detail["band_scale"] = _band_scale_bench(BAND_NODES, BAND_ATTRS)

    print(json.dumps({"device": device, "detail": detail}))
    return 0


def _apsp_and_null(sf, permutations):
    """Isolated steady APSP (the production banded path and the dense
    kernel) and permutation-null times of a loaded Example_1 session."""
    import jax
    from safepy_tpu.io.graph_arrays import graph_to_arrays
    from safepy_tpu.ops import permutation as perm_ops
    from safepy_tpu.ops.apsp import apsp
    from safepy_tpu.ops.apsp_banded import apsp_banded_unpermuted
    from safepy_tpu.ops.neighborhoods import (inclusive_radius,
                                              initial_distances_device)
    from safepy_tpu.ops.score import compute_neighborhood_score

    out = {}
    coords, edges, lengths, _w = graph_to_arrays(sf.graph)
    d0 = initial_distances_device(sf.graph.number_of_nodes(), edges, lengths)
    timed(apsp, d0, symmetric=True)
    out["apsp_dense_steady_s"] = timed(apsp, d0, symmetric=True)[1]
    plan = next((p for p in sf._banded_cache.values() if p is not None),
                None)
    if plan is not None:
        init, rank_dev, window = plan
        radius = inclusive_radius(sf.neighborhood_radius
                                  * np.ptp(coords[:, 0]))
        timed(apsp_banded_unpermuted, init, rank_dev, radius, window=window)
        out["apsp_banded_steady_s"] = timed(
            apsp_banded_unpermuted, init, rank_dev, radius,
            window=window)[1]
        out["window"] = int(window)

    nbr = sf._neighborhoods_device()
    n2a = sf._node2attribute_device()
    valid = np.flatnonzero(np.any(~np.isnan(np.asarray(sf.node2attribute)),
                                  axis=1))
    obs = compute_neighborhood_score(nbr, n2a, "sum", "highest")
    key = jax.random.PRNGKey(0)

    def null():
        return perm_ops.run_permutations(nbr, n2a, valid, obs, key,
                                         score_type="sum",
                                         num_permutations=permutations)

    timed(null)
    out["null_steady_s"] = timed(null)[1]
    return out


def _band_scale_bench(n, a, perms=1000):
    """The band-storage engine at scale: GO-binary pipeline (band FW +
    census + class-table lookup) and the quantitative permutation null."""
    import pandas as pd
    from safepy_tpu import SAFE

    rng = np.random.default_rng(2)
    g, _coords = build_network(n=n, k=9, edge_budget=None, prefix="n")
    attrs = pd.DataFrame(go_annotations(rng, n, a, 0.05),
                         index=[f"n{i}" for i in range(n)],
                         columns=[f"go{j}" for j in range(a)])
    sf = SAFE(verbose=False)
    sf.apsp_mode = "band"
    sf.keep_node_distances = False
    sf.random_seed = 17
    sf.neighborhood_radius = float(np.sqrt(125.0 / (np.pi * n)))
    sf.load_network(network_file=g, node_key_attribute="key")
    out = {"nodes": n, "attributes": a,
           "go_first_s": _pipeline_wall(sf, attrs),
           "go_steady_s": _pipeline_wall(sf, attrs),
           "engine": sf._hypergeom_engine_used,
           "band": int(sf._neighborhoods_dev.band)}
    qattrs = pd.DataFrame(quantitative_attribute(rng, n, 0.3),
                          index=[f"n{i}" for i in range(n)], columns=["q"])
    _pipeline_wall(sf, qattrs, num_permutations=perms)
    out["null_e2e_steady_s"] = _pipeline_wall(sf, qattrs,
                                              num_permutations=perms)
    return out


def _custom_bench(args):
    """Non-default scales: --nodes/--attributes/--binary/--permutations."""
    import pandas as pd
    from safepy_tpu import SAFE

    rng = np.random.default_rng(0)
    n = args.nodes
    g, _coords = build_network(n=n, k=9, edge_budget=None, prefix="n")
    if args.binary:
        vals = (rng.random((n, args.attributes)) < 0.05).astype(float)
    else:
        vals = rng.normal(size=(n, args.attributes))
    attr = pd.DataFrame(vals, index=[f"n{i}" for i in range(n)],
                        columns=[f"a{i}" for i in range(args.attributes)])
    sf = SAFE(verbose=False)
    sf.random_seed = 1885
    if args.radius is not None:
        sf.neighborhood_radius = args.radius
    sf.load_network(network_file=g, node_key_attribute="key")
    first = _pipeline_wall(sf, attr, num_permutations=args.permutations)
    steady = _pipeline_wall(sf, attr, num_permutations=args.permutations)
    engine = ("band_storage"
              if any(v is not None for v in sf._bandstore_cache.values())
              else "banded_window"
              if any(v is not None for v in sf._banded_cache.values())
              else "dense")
    return {"nodes": n, "edges": g.number_of_edges(),
            "attributes": args.attributes, "binary": args.binary,
            "num_permutations": args.permutations, "first_run_s": first,
            "e2e_steady_s": steady, "engine": engine}


if __name__ == "__main__":
    sys.exit(main())
