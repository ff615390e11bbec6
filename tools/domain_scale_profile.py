"""Profile the host-side domain pipeline at band-storage scale.

The domain stage (safepy_tpu/domains.py; reference safe.py:610-745) runs on
host over the (N, A) enrichment outputs. At dense scale it is negligible; at
band-storage scale (99,840 nodes x 4,373 GO terms) two costs grow super-
linearly and are measured here BEFORE optimizing:

  1. define_top_attributes: per-top-attribute induced-subgraph component
     counts — csr double-slice `adj[idx][:, idx]` per attribute;
  2. define_domains: scipy linkage computes the jaccard pdist internally over
     the (A_top, N) binary matrix — A_top^2/2 pairs x N elements each.

Sampling strategy: the per-attribute loop is timed on `--sample-attrs`
attributes and extrapolated linearly; the pdist is timed on a
`--sample-pdist`-row subset and extrapolated quadratically (both stages are
embarrassingly uniform). Runs entirely on the host CPU.

Usage: python tools/domain_scale_profile.py [--nodes 99840] [--attrs 4373]
"""

from __future__ import annotations

import argparse
import time

import numpy as np


def synth_inputs(n, a, seed=0, avg_deg=6, enriched_mean=250):
    """Band-GO-shaped synthetic outputs: ring-lattice + shortcut graph and a
    clustered sparse binary enrichment matrix (attributes enrich contiguous
    node stretches, as real neighborhoods do)."""
    rng = np.random.default_rng(seed)
    # ring lattice degree-4 plus n shortcuts ~ avg degree 6
    u = np.arange(n, dtype=np.int64)
    edges = [np.stack([u, (u + 1) % n], 1), np.stack([u, (u + 2) % n], 1)]
    edges.append(rng.integers(0, n, size=(n * (avg_deg - 4) // 2, 2)))
    edges = np.concatenate(edges, 0)
    edges = edges[edges[:, 0] != edges[:, 1]]

    sizes = np.maximum(12, rng.lognormal(np.log(enriched_mean), 0.8,
                                         size=a)).astype(np.int64)
    sizes = np.minimum(sizes, n // 4)
    nes_binary = np.zeros((n, a), dtype=np.int8)
    starts = rng.integers(0, n, size=a)
    for j in range(a):
        # two contiguous stretches -> most attrs unimodal, some not
        s0 = starts[j]
        span = np.arange(s0, s0 + sizes[j]) % n
        nes_binary[span, j] = 1
        if j % 7 == 0:  # a second far-away component for ~14% of attrs
            s1 = (s0 + n // 2) % n
            span1 = np.arange(s1, s1 + max(12, sizes[j] // 4)) % n
            nes_binary[span1, j] = 1
    return edges, nes_binary


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nodes", type=int, default=99840)
    ap.add_argument("--attrs", type=int, default=4373)
    ap.add_argument("--sample-attrs", type=int, default=200)
    ap.add_argument("--sample-pdist", type=int, default=384)
    args = ap.parse_args()
    n, a = args.nodes, args.attrs

    t0 = time.perf_counter()
    edges, nes_binary = synth_inputs(n, a)
    print(f"synth: {n} nodes, {len(edges)} edges, {a} attrs, "
          f"density {nes_binary.mean():.4f}  [{time.perf_counter()-t0:.1f}s]")

    import scipy.sparse as sp
    import scipy.sparse.csgraph as csgraph

    rows = np.concatenate([edges[:, 0], edges[:, 1]])
    cols = np.concatenate([edges[:, 1], edges[:, 0]])
    t0 = time.perf_counter()
    adj = sp.csr_matrix((np.ones(len(rows), np.float64), (rows, cols)),
                        shape=(n, n))
    t_adj = time.perf_counter() - t0
    print(f"adjacency build: {t_adj:.2f}s")

    # --- stage 1: per-attribute induced-subgraph components (current impl) ---
    k = min(args.sample_attrs, a)
    t0 = time.perf_counter()
    for j in range(k):
        idx = np.flatnonzero(nes_binary[:, j] > 0)
        sub = adj[idx][:, idx]
        csgraph.connected_components(sub, directed=False)
    t_loop = time.perf_counter() - t0
    print(f"components loop: {t_loop:.2f}s for {k} attrs -> "
          f"extrapolated {t_loop * a / k:.1f}s for {a}")

    # --- stage 1 alternative: edge-mask + components on filtered edges ---
    eu, ev = edges[:, 0], edges[:, 1]
    t0 = time.perf_counter()
    for j in range(k):
        col = nes_binary[:, j]
        m = (col[eu] > 0) & (col[ev] > 0)
        fu, fv = eu[m], ev[m]
        nodes = np.flatnonzero(col > 0)
        remap = np.full(n, -1, np.int64)
        remap[nodes] = np.arange(len(nodes))
        subm = sp.csr_matrix((np.ones(len(fu), np.int8),
                              (remap[fu], remap[fv])),
                             shape=(len(nodes), len(nodes)))
        csgraph.connected_components(subm, directed=False)
    t_mask = time.perf_counter() - t0
    print(f"edge-mask loop:  {t_mask:.2f}s for {k} attrs -> "
          f"extrapolated {t_mask * a / k:.1f}s for {a}")

    # --- stage 2: jaccard pdist (what linkage computes internally) ---
    from scipy.spatial.distance import pdist
    m = min(args.sample_pdist, a)
    sub = nes_binary[:, :m].T.astype(np.float64)  # linkage input dtype
    t0 = time.perf_counter()
    pdist(sub, metric="jaccard")
    t_pd = time.perf_counter() - t0
    scale = (a / m) ** 2
    print(f"jaccard pdist: {t_pd:.2f}s for {m} rows -> "
          f"extrapolated {t_pd * scale:.1f}s for {a} top attrs")

    # bool-dtype variant (scipy fast path)
    subb = nes_binary[:, :m].T.astype(bool)
    t0 = time.perf_counter()
    pdist(subb, metric="jaccard")
    t_pdb = time.perf_counter() - t0
    print(f"jaccard pdist (bool): {t_pdb:.2f}s for {m} rows -> "
          f"extrapolated {t_pdb * scale:.1f}s for {a}")

    # --- stage 2 alternative: GEMM counts -> jaccard (host BLAS stand-in) ---
    t0 = time.perf_counter()
    f32 = nes_binary[:, :m].astype(np.float32)
    inter = f32.T @ f32
    card = np.diag(inter)
    union = card[:, None] + card[None, :] - inter
    with np.errstate(invalid="ignore"):
        1.0 - inter / union
    t_gemm = time.perf_counter() - t0
    print(f"jaccard via GEMM (host f32): {t_gemm:.2f}s for {m} rows -> "
          f"extrapolated {t_gemm * scale:.1f}s for {a} "
          f"({2 * a * a * n / 1e9:.0f} GFLOP)")

    # --- stage 3: domain count stack (define_domains counts + max_nes) ---
    doms = np.sort(np.random.default_rng(1).integers(1, 40, size=a))
    t0 = time.perf_counter()
    np.stack([nes_binary[:, doms == d].sum(axis=1)
              for d in np.unique(doms)], axis=1)
    t_counts = time.perf_counter() - t0
    print(f"domain count stack: {t_counts:.2f}s ({len(np.unique(doms))} domains)")


if __name__ == "__main__":
    main()
