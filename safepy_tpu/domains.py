"""Attribute -> domain assignment: top-attribute filtering, clustering, trimming.

Host-side stage (inputs are tiny after enrichment): reference semantics from
safepy/safe.py:610-745.

  * top attributes: >= `min_size` enriched neighborhoods AND exactly one connected
    component in the enriched-neighborhood subnetwork ('connectivity' unimodality);
  * domains: average-linkage hierarchical clustering of the top attributes' binary
    enrichment columns under the configured distance (default jaccard), cut at
    ``max(Z[:, 2]) * attribute_distance_threshold``;
  * node -> domain: a node belongs to the domain holding the most attributes it is
    significantly enriched for (groupby-sum of nes_binary, argmax; 0 when none);
  * trimming: drop domains that are primary for fewer than `min_size` nodes,
    renumber densely, and label each domain with the 5 most frequent words of its
    member attributes' names.
"""

from __future__ import annotations

import logging

import numpy as np
import pandas as pd
from scipy.cluster.hierarchy import fcluster, linkage

from safepy_tpu.io.graph_arrays import chop_and_filter


def define_top_attributes(attributes, nes_binary, graph, graph_euclidean=None,
                          *, unimodality_metric="connectivity",
                          min_size=10, verbose=True):
    """Mark 'top' attributes in-place in the attributes DataFrame."""

    logging.info("Criteria for top attributes:")
    logging.info("- minimum number of enriched neighborhoods: %d" % min_size)
    logging.info("- region-specific distribution of enriched neighborhoods as "
                 "defined by: %s" % unimodality_metric)

    attributes["top"] = False
    attributes.loc[attributes["num_neighborhoods_enriched"] >= min_size, "top"] = True

    if unimodality_metric == "connectivity":
        attributes["num_connected_components"] = 0
        attributes["size_connected_components"] = None
        attributes["size_connected_components"] = (
            attributes["size_connected_components"].astype(object))
        attributes["num_large_connected_components"] = 0

        # Edgeless (scatter) networks: use the euclidean pseudo-network.
        G = graph_euclidean if graph_euclidean is not None else graph
        # One sparse adjacency build, then per-attribute induced-subgraph
        # component counts via scipy csgraph — ~100x the per-attribute
        # nx.connected_components walk on Costanzo-scale output.
        import scipy.sparse as _sp
        import scipy.sparse.csgraph as _csgraph
        nodes = list(G)
        node_pos = {u: i for i, u in enumerate(nodes)}
        n = len(nodes)
        rows = [node_pos[u] for u, v in G.edges()]
        cols = [node_pos[v] for u, v in G.edges()]
        adj = _sp.csr_matrix(
            (np.ones(2 * len(rows)), (rows + cols, cols + rows)), shape=(n, n))

        # nes_binary may arrive as a scipy CSC matrix (the facade's sparse
        # download at band scale, ops/domains_device.indicator_csc) —
        # its per-column indices ARE the enriched node ids
        sparse_input = _sp.issparse(nes_binary)
        for attribute in attributes.index.values[attributes["top"]]:
            if sparse_input:
                idx = nes_binary.indices[
                    nes_binary.indptr[attribute]:nes_binary.indptr[attribute + 1]]
            else:
                idx = np.flatnonzero(nes_binary[:, attribute] > 0)
            if len(idx) == 0:
                attributes.loc[attribute, "num_connected_components"] = 0
                attributes.at[attribute, "size_connected_components"] = np.array([])
                continue
            sub = adj[idx][:, idx]
            ncomp, labels_arr = _csgraph.connected_components(sub, directed=False)
            sizes = np.sort(np.bincount(labels_arr))[::-1]
            attributes.loc[attribute, "num_connected_components"] = int(ncomp)
            attributes.at[attribute, "size_connected_components"] = sizes
            attributes.loc[attribute, "num_large_connected_components"] = int(
                np.sum(sizes >= min_size))

        attributes.loc[attributes["num_connected_components"] > 1, "top"] = False

    if verbose:
        logging.info("Number of top attributes: %d" % int(np.sum(attributes["top"])))
    return attributes


#: engage the GEMM jaccard + device aggregates above this many top
#: attributes ('auto'); below it the scipy pdist is microseconds and one
#: device dispatch would dominate
CLUSTER_ENGINE_MIN_TOP = 96


def define_domains(attributes, nes, nes_binary,
                   *, distance_metric="jaccard", distance_threshold=0.75,
                   verbose=True, cluster_engine="auto", intersections=None,
                   nes_binary_dev=None, nes_dev=None):
    """Cluster top attributes into domains and assign every node a primary domain.

    Returns (attributes, node2domain): attributes gains a 'domain' column;
    node2domain has one column per domain id (count of enriched member attributes)
    plus 'primary_domain' and 'primary_nes'.

    ``cluster_engine``: 'scipy' feeds the binary columns to scipy linkage
    directly (which computes the jaccard pdist internally — extrapolated to
    hours at the 99,840 x 4,373 GO band scale, tools/domain_scale_profile.py);
    'gemm' builds the identical condensed distances from one device
    intersection-count GEMM + exact host f64 division (bit-identical linkage
    input, see ops/domains_device.py) and computes the node->domain
    aggregates on device too; 'auto' picks 'gemm' for the jaccard metric
    above CLUSTER_ENGINE_MIN_TOP top attributes. ``intersections`` optionally
    supplies a precomputed full (A, A) count matrix (the facade caches it
    across re-clusterings at different thresholds); ``nes_binary_dev`` /
    ``nes_dev`` optionally hand over device-resident copies so the (N, A)
    matrices never cross to the host. ``nes`` / ``nes_binary`` may also be
    zero-arg CALLABLES returning the host matrix: the gemm path never touches
    the host copies, so the facade hands lazy accessors over — at the
    99,840 x 4,373 band scale the eager f64 NES download alone costs minutes
    of transfer + host conversion that the device path never needs.
    """
    get_nes = nes if callable(nes) else (lambda: nes)
    get_binary = nes_binary if callable(nes_binary) else (lambda: nes_binary)
    top_mask = attributes["top"].values.astype(bool)
    if top_mask.sum() < 2:
        raise ValueError("define_domains requires at least 2 top attributes "
                         f"(got {int(top_mask.sum())}).")

    use_gemm = (cluster_engine == "gemm"
                or (cluster_engine == "auto" and distance_metric == "jaccard"
                    and int(top_mask.sum()) >= CLUSTER_ENGINE_MIN_TOP))
    if use_gemm and distance_metric != "jaccard":
        raise ValueError("cluster_engine='gemm' serves the jaccard metric "
                         f"only (got {distance_metric!r})")

    if use_gemm:
        from safepy_tpu.ops import domains_device as _dd
        if intersections is None:
            intersections = _dd.enrichment_intersections(
                get_binary() if nes_binary_dev is None else nes_binary_dev)
        top_idx = np.flatnonzero(top_mask)
        condensed = _dd.jaccard_condensed_from_counts(
            intersections[np.ix_(top_idx, top_idx)])
        Z = linkage(condensed, method="average")
    else:
        nes = get_nes()
        nes_binary = get_binary()
        m = nes_binary[:, top_mask].T
        Z = linkage(m, method="average", metric=distance_metric)
    max_d = np.max(Z[:, 2] * distance_threshold)
    domains = fcluster(Z, max_d, criterion="distance")

    attributes["domain"] = 0
    attributes.loc[top_mask, "domain"] = domains

    domain_of_attr = attributes["domain"].values
    unique_domains = np.sort(np.unique(domain_of_attr))

    if use_gemm:
        from safepy_tpu.ops import domains_device as _dd
        # map raw domain ids -> positions in unique_domains for the segment ops
        dom_pos = np.searchsorted(unique_domains, domain_of_attr)
        counts, max_nes_mat = _dd.domain_aggregates(
            get_binary() if nes_binary_dev is None else nes_binary_dev,
            get_nes() if nes_dev is None else nes_dev,
            dom_pos, len(unique_domains))
        counts = counts.astype(np.float64)  # reference dtype (f64 groupby-sum)
        max_nes = {d: max_nes_mat[:, i] for i, d in enumerate(unique_domains)}
    else:
        # counts[node, d] = number of domain-d attributes the node is enriched for
        counts = np.stack([nes_binary[:, domain_of_attr == d].sum(axis=1)
                           for d in unique_domains], axis=1).astype(np.float64)
        # max NES within each domain per node, for the primary domain
        with np.errstate(invalid="ignore"):
            max_nes = {d: np.nanmax(np.where(np.isnan(nes[:, domain_of_attr == d]),
                                             -np.inf,
                                             nes[:, domain_of_attr == d]),
                                    axis=1, initial=-np.inf)
                       for d in unique_domains}
    node2domain = pd.DataFrame(counts, columns=unique_domains)

    nonzero = [d for d in unique_domains if d != 0]
    t = node2domain[nonzero]
    t_max = t.max(axis=1)
    t_idxmax = t.idxmax(axis=1)
    t_idxmax[t_max == 0] = 0

    # when every attribute clustered (no domain-0 attributes exist), nodes with
    # no significant enrichment still get primary_domain 0 with NES 0
    if 0 not in max_nes:
        max_nes[0] = np.zeros(counts.shape[0])
    node2domain["primary_domain"] = t_idxmax
    node2domain["primary_nes"] = [max_nes[d][i] for i, d in enumerate(t_idxmax.values)]

    if verbose:
        num_domains = len(np.unique(domains))
        per_domain = (attributes.loc[attributes["domain"] > 0]
                      .groupby("domain")["id"].count())
        logging.info("Number of domains: %d (containing %d-%d attributes)"
                     % (num_domains, per_domain.min(), per_domain.max()))
    return attributes, node2domain


def trim_domains(attributes, node2domain, *, min_size=10, verbose=True):
    """Drop small domains, renumber densely, and label the survivors.

    Returns (attributes, node2domain, domains_df).
    """
    unique_domains = np.sort(attributes["domain"].unique())
    domain_counts = np.zeros(int(unique_domains.max()) + 1, dtype=int)
    t = node2domain.groupby("primary_domain")["primary_domain"].count()
    domain_counts[t.index.values.astype(int)] = t.values
    to_remove = np.flatnonzero(domain_counts < min_size)

    attributes.loc[attributes["domain"].isin(to_remove), "domain"] = 0
    idx = node2domain["primary_domain"].isin(to_remove)
    node2domain.loc[idx, ["primary_domain", "primary_nes"]] = 0

    a = np.sort(attributes["domain"].unique())
    if 0 not in a:  # all attributes clustered; nodes may still carry domain 0
        a = np.concatenate([[0], a])
    renumber = dict(zip(a, np.arange(len(a))))
    attributes["domain"] = [renumber[k] for k in attributes["domain"]]
    node2domain["primary_domain"] = [renumber[k] for k in node2domain["primary_domain"]]

    # Renumber the per-domain count columns too: fold trimmed domains' counts
    # into domain 0 (where their attributes went) and rename the survivors.
    # The reference leaves these columns under the ORIGINAL cluster ids, so its
    # node report misindexes them once a middle domain is trimmed (safe.py:1294
    # indexes renumbered domains['id'] into original-id columns) — fixed here,
    # divergence documented in PARITY.md.
    count_cols = [c for c in node2domain.columns
                  if c not in ("primary_domain", "primary_nes")]
    folded = [c for c in count_cols if c in to_remove and c != 0]
    if folded:
        if 0 not in node2domain.columns:
            node2domain.insert(0, 0, 0)
        node2domain[0] = node2domain[0] + node2domain[folded].sum(axis=1)
        node2domain.drop(columns=folded, inplace=True)
    node2domain.rename(columns=renumber, inplace=True)

    domains = np.sort(attributes["domain"].unique())
    domain_labels = attributes.groupby("domain")["name"].apply(chop_and_filter)
    domains_df = pd.DataFrame(data={"id": domains, "label": domain_labels})
    domains_df.set_index("id", drop=False)

    if verbose:
        logging.info("Removed %d domains because they were the top choice for "
                     "less than %d neighborhoods." % (len(to_remove), min_size))
    return attributes, node2domain, domains_df
