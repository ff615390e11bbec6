"""Measure the reference implementation's wall-clock on the benchmark network.

Runs /root/reference's safepy (imported via tests/reference_compat.py — statsmodels
stub + pandas-3 groupby shim) on the exact network + attribute table bench.py uses:
3,971 nodes / 28,202 edges, one quantitative attribute, default
shortpath_weighted_layout neighborhoods (N host Dijkstras, reference safe.py:406-410)
and a 1,000-permutation empirical null (reference safe_extras.py:36-70).

Writes tools/reference_wall.json: the measured — not inferred — wall-clock of
the reference on the same inputs.

Usage:  python tools/measure_reference.py  [--permutations 1000]
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the reference is host-only; keep JAX (imported transitively by bench
# helpers) on the CPU
os.environ.setdefault("JAX_PLATFORMS", "cpu")

sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--permutations", type=int, default=1000)
    args = parser.parse_args(argv)

    import numpy as np
    import pandas as pd

    import bench
    import reference_compat

    ref = reference_compat.load_reference()
    if ref is None:
        print("reference not available at /root/reference", file=sys.stderr)
        return 1

    graph, _coords = bench.build_network()
    rng = np.random.default_rng(1)
    vals = rng.normal(size=(bench.N_NODES, 1))
    vals[rng.random(bench.N_NODES) < 0.33, 0] = np.nan
    attr_df = pd.DataFrame(vals, index=[f"gene{i}" for i in range(bench.N_NODES)],
                           columns=["synthetic quantitative attribute"])

    # the reference cannot take an in-memory graph (its os.path.exists assert runs
    # before the Graph type check, safe.py:264) — hand it a gpickle
    with tempfile.TemporaryDirectory() as tmp:
        net_file = os.path.join(tmp, "bench_net.gpickle")
        with open(net_file, "wb") as f:
            pickle.dump(graph, f)

        sf = ref.SAFE()
        sf.random_seed = 1885
        sf.load_network(network_file=net_file, node_key_attribute="key")
        sf.load_attributes(attribute_file=attr_df)

        t0 = time.time()
        sf.define_neighborhoods()
        t_neighborhoods = time.time() - t0

        t0 = time.time()
        sf.compute_pvalues(num_permutations=args.permutations)
        t_pvalues = time.time() - t0

    result = {
        "reference_wall_s": round(t_neighborhoods + t_pvalues, 3),
        "define_neighborhoods_s": round(t_neighborhoods, 3),
        "compute_pvalues_s": round(t_pvalues, 3),
        "num_permutations": args.permutations,
        "nodes": bench.N_NODES,
        "edges": graph.number_of_edges(),
        "mean_neighborhood_size": float(np.asarray(sf.neighborhoods).sum(1).mean()),
        "enriched_neighborhoods": int(sf.nes_binary.sum()),
        "host": "this container's CPU (the reference is host-only NumPy/NetworkX)",
        "measured_by": "tools/measure_reference.py",
    }
    out = os.path.join(REPO, "tools", "reference_wall.json")
    with open(out, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
