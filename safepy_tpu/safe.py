"""The SAFE facade: reference-compatible API over the JAX device core.

Same public surface as the reference ``SAFE`` class (safepy/safe.py:37-1306) —
method names, kwargs, instance attributes, INI config, logging lines — but every
pipeline stage between "graph + attributes in" and "NES matrices out" dispatches to
jit-compiled JAX/Pallas functions:

  * ``define_neighborhoods`` — blocked min-plus Floyd-Warshall on the device
    (ops/minplus.py) instead of N host Dijkstras (reference hot loop,
    safe.py:406-410);
  * ``compute_pvalues_by_hypergeom`` — GEMMs for the census plus a vectorized
    log-space hypergeometric survival function (reference: scipy elementwise,
    safe.py:596);
  * ``compute_pvalues_by_randomization`` — batched keyed permutations scored as GEMM
    streams with on-chip count reduction, replacing the multiprocessing pool
    (reference: safe.py:501-519, safe_extras.py:36-70).

Domain assignment, clustering, plotting and reports stay host-side (tiny inputs).
"""

from __future__ import annotations

import importlib
import logging
import os
import pickle
from pathlib import Path

import jax
import jax.numpy as jnp
import networkx as nx
import numpy as np
import pandas as pd

from safepy_tpu import config as _config
from safepy_tpu import domains as _domains
from safepy_tpu import hbm as _hbm
from safepy_tpu.io import attributes as _attr_io
from safepy_tpu.io import graph_arrays as _ga
from safepy_tpu.io import network as _net_io
from safepy_tpu.ops.apsp import apsp as _apsp_run
from safepy_tpu.ops import fdr as _fdr
from safepy_tpu.ops import hypergeom as _hyper
from safepy_tpu.ops import neighborhoods as _nbr
from safepy_tpu.ops import permutation as _perm
from safepy_tpu.ops import score as _score
from safepy_tpu.ops.apsp_bandstore import BandedMatrix as _BandedMatrix


@jax.jit
def _to_int8(x):
    """Module-level jit (stable cache key) for the int8 indicator download."""
    return x.astype(jnp.int8)


@jax.jit
def _take_column(a, j):
    """One column of a device matrix with the index TRACED: every column
    shares one compiled program per matrix shape (a static `a[:, j]` slice
    would trigger a remote compile per distinct j)."""
    return jax.lax.dynamic_slice_in_dim(a, j, 1, axis=1)[:, 0]


@jax.jit
def _nes_from_logsf_jit(logsf32):
    """NES from the stored f32 log-survival (reference safe.py:602-604):
    f64 divide + f32 round, matching the band engines' deferred-NES
    contract (SAFE._nes_device)."""
    return (-logsf32.astype(jnp.float64)
            / np.log(10.0)).astype(jnp.float32)


class SAFE:
    """An instance of SAFE analysis: all data, parameters, and pipeline methods."""

    def __init__(self, path_to_ini_file="", path_to_safe_data=None, verbose=True):
        self.verbose = verbose

        self.default_config = None

        self.path_to_safe_data = path_to_safe_data
        self.path_to_network_file = None
        self.view_name = None
        self.path_to_attribute_file = None

        self.graph = None
        self.graph_euclidean = None
        # device-resident FW initializations, keyed by distance metric; valid as
        # long as the loaded graph is unchanged (cleared by load_network)
        self._d0_cache = {}
        # 'auto' = radius-bounded banded FW when the geometric certificate holds
        # (ops/apsp_banded.py); 'full' = always the exact full-matrix kernel
        self.apsp_mode = "auto"
        self._banded_cache = {}
        # band-STORAGE engine (ops/apsp_bandstore.py): O(N*W) memory instead of
        # dense O(N^2). 'auto' switches to it above this node count;
        # apsp_mode='band' forces it. The value predates the GPU port and is
        # kept until the band/dense crossover is measured on the GPU
        # (ROADMAP.md, Design).
        self.band_storage_min_nodes = 16384
        self._bandstore_cache = {}
        # band relaxation engine: 'auto' (= FW: sparse Bellman-Ford
        # converges in ~path-hop rounds but is gather-bound, see
        # docs/DESIGN.md), or force 'bf' / 'fw' explicitly
        self.band_relax = "auto"
        self._band_relax_used = None
        # min-plus tile relaxation of every Floyd-Warshall engine
        # (ops/minplus.resolve): None = the platform's ('triton' on a GPU,
        # 'jnp' on the CPU); 'interpret' runs the GPU kernel in the Pallas
        # interpreter (tests, CPU rehearsals)
        self.minplus_impl = None
        # False drops the f32 distance band from the fused band pipelines
        # (node_distances then unavailable for the run): peak device memory
        # falls by the full f32 band — 9.3 GB at 299,520 nodes /
        # 125-neighborhoods
        self.keep_node_distances = True
        # Above this band-store size the FW front runs SPLIT (init ->
        # donated relax -> tail dispatches): inside one fused program XLA
        # double-buffers the FW loop's band (pipeline.band_relax_threshold),
        # so giant bands pay ~2x HBM fused but ~1x split. ~1 s of extra
        # dispatch overhead, irrelevant at the scales the gate admits.
        self.band_split_min_bytes = 3 * 10 ** 9
        # Shape-bucket the band store's tile half-width: bt (= band//128+1)
        # is rounded UP to a multiple of this, so a radius sweep over the
        # same network re-uses the compiled FW/census programs whenever two
        # radii land in the same bucket — every distinct (rows, bt) pair is
        # a fresh compile otherwise. Results are identical: the banded-order
        # certificate is a LOWER bound on the window, and a wider window
        # only adds relaxation lattice points beyond the certified band.
        # The steady-state tax is QUADRATIC in the widening (FW work ~
        # bt^2), so set 0/None (disable) for a pinned production radius
        # that will be re-run many times.
        self.band_bt_bucket = 4
        # BIT-packed indicator bands (uint8, 8 cells/byte — ops/
        # apsp_bandstore.is_packed_bits): 'auto' packs the single-device
        # banded indicator (euclidean-direct AND graph FW-thresholded) once
        # the int8 band would cross band_bits_min_bytes — an 8x memory and
        # download lever; every consumer branches on the dtype and unpacks
        # per tile inside its contraction loop. True/False force it either way.
        self.band_indicator_bits = "auto"
        self.band_bits_min_bytes = 4 * 10 ** 9
        # Release the cached f32 (N, A) annotation upload once the band
        # binary engines hold the int8 operands (it is re-uploaded lazily on
        # the next access): at 199,680 x 4,373 it pins 3.49 GB alongside the
        # 5.16 GB FW band. Crossing this byte threshold triggers the
        # release; float('inf') disables it.
        self.annotation_release_min_bytes = 2 * 10 ** 9
        # Residency of the (N, A) f32 log-survival result at band GO scale
        # (6.1 GB at 349,440 x 4,373): 'auto' consults the pre-dispatch plan
        # (safepy_tpu/hbm.py) and picks device f32 -> device f16 (indicator
        # and counts stay f64-exact; stored log-p loses ~2^-11) -> host
        # streaming (bit-equal, one host download per run). 'device'/'f16'/
        # 'host' force a mode; the guard still refuses plans that cannot fit.
        self.logsf_store = "auto"
        # device byte budget for the pre-dispatch guard; None = ask the
        # device (hbm.device_hbm_budget: the allocator's bytes_limit). The
        # guard raises a clean ValueError BEFORE dispatch instead of letting
        # an OOM fail a fused program midway.
        self.hbm_budget_bytes = None
        self._hbm_plan_last = None  # observability: the last admitted plan
        self._graph_arrays = None  # cached graph_to_arrays output
        self.node_key_attribute = "label_orf"

        self.attributes = None
        self.nodes = None
        self.node2attribute = None
        self._n2a_dev = None  # cached f32 device copy of node2attribute
        # int8 band-engine operands, cached ACROSS pipeline runs (keyed on
        # the annotation serial + banded order): with the f32 upload
        # released at GO scale, re-deriving them from a 3.49 GB re-upload
        # every steady run costs a full re-upload for nothing
        self._band_operands_cache = None
        self._attr_serial = 0
        self._num_other_cache = None  # cached non-binary-value census
        self.num_nodes_per_attribute = None
        self.attribute_sign = "both"

        self.node_distance_metric = "shortpath_weighted_layout"
        self.neighborhood_radius_type = None
        self.neighborhood_radius = None

        self.background = "attribute_file"
        self.num_permutations = 1000
        self.multiple_testing = False
        self.neighborhood_score_type = "sum"
        self.enrichment_type = "auto"
        # hypergeometric survival engine: 'auto' = class-table engine
        # (ops/hypergeom_table.py) for binary annotations within budget,
        # per-cell f64 tail loop otherwise; 'table' / 'loop' force one
        self.hypergeom_engine = "auto"
        self.enrichment_threshold = 0.05
        self.enrichment_max_log10 = 16
        self.attribute_enrichment_min_size = 10
        self.random_seed = None
        # 'highest' = exact f32 score matmuls (tie parity); 'default' = the
        # backend's fast f32 path for large-N permutation nulls (TF32 tensor
        # cores on an NVIDIA GPU: ~3 significant digits)
        self.matmul_precision = "highest"
        # a jax.sharding.Mesh enables multi-device execution: APSP
        # row-sharded over a 'data' axis, permutation batches over a 'perm'
        # axis (counts psum-reduced). None = single-device.
        self.mesh = None

        self._neighborhoods_np = None
        self._neighborhoods_dev = None
        self._node_distances_np = None
        self._node_distances_dev = None

        self.ns = None
        self.pvalues_neg = None
        self._pvalues_pos_np = None
        self._logsf_dev = None
        self._logsf_np = None  # pickled f32 log-survival (see pvalues_pos)
        self._nes_np = None
        self._nes_dev = None
        self._nes_from_logsf = False  # derive NES from _logsf_dev on access
        self.nes_threshold = None
        self._nes_binary_np = None
        self._nes_binary_dev = None
        self._nes_binary_i8_np = None  # cached int8 download (see _nes_binary_small)
        self._nes_binary_csc = None  # cached sparse view (_nes_binary_for_top)
        # run stamps: node2domain is only reusable (e.g. by the composite
        # plot's mixture counts) while it derives from the CURRENT indicator
        self._enrichment_serial = 0
        self._node2domain_serial = None
        # (indicator_dev, counts) decided on device, awaiting _update_binary_enrichment
        self._nes_binary_pending = None

        self.attribute_unimodality_metric = "connectivity"
        self.attribute_distance_metric = "jaccard"
        self.attribute_distance_threshold = 0.75
        # 'auto' | 'gemm' | 'scipy' — how define_domains builds the jaccard
        # linkage input (ops/domains_device.py; 'auto' = GEMM above
        # domains.CLUSTER_ENGINE_MIN_TOP top attributes)
        self.cluster_engine = "auto"
        # full (A, A) intersection-count matrix, reused across re-clusterings
        self._domains_inter_cache = None

        self.domains = None
        self.node2domain = None

        # observability: which hypergeometric engine actually served the last
        # compute (benchmarks and scale tools report it; see hypergeom_engine)
        self._hypergeom_engine_used = None

        self.output_dir = ""

        self.read_config(path_to_ini_file, path_to_safe_data=self.path_to_safe_data)
        self.validate_config()

    # ------------------------------------------------------------------ config

    def read_config(self, path_to_ini_file, path_to_safe_data=None):
        cfg, defaults = _config.read_config(path_to_ini_file, path_to_safe_data)
        self.default_config = defaults
        for field in ("path_to_safe_data", "path_to_network_file",
                      "path_to_attribute_file", "attribute_sign", "background",
                      "layout_algorithm",
                      "node_distance_metric", "neighborhood_radius_type",
                      "neighborhood_radius", "random_seed",
                      "attribute_unimodality_metric", "attribute_distance_metric",
                      "attribute_distance_threshold", "output_dir"):
            setattr(self, field, getattr(cfg, field))

    def validate_config(self):
        _config.validate_config(self, self.default_config)

    def save(self, output_file="", **kwargs):
        if not output_file:
            output_file = os.path.join(os.getcwd(), "safe_output.p")
        with open(output_file, "wb") as handle:
            pickle.dump(self, handle)

    # ------------------------------------------------------------------ network

    def load_network(self, **kwargs):
        """Load the network from a source file, applying a layout if needed.

        Keyword args: network_file, view_name, node_key_attribute — each overrides
        the corresponding config setting (reference: safe.py:244-324).
        """
        if "network_file" in kwargs:
            nf = kwargs.pop("network_file")
            if self.path_to_safe_data is None or isinstance(nf, nx.Graph):
                self.path_to_network_file = nf
            else:
                self.path_to_network_file = os.path.join(self.path_to_safe_data, nf)

        if "view_name" in kwargs:
            self.view_name = kwargs["view_name"]
        if "node_key_attribute" in kwargs:
            self.node_key_attribute = kwargs["node_key_attribute"]

        self.validate_config()

        if isinstance(self.path_to_network_file, nx.Graph):
            self.graph = self.path_to_network_file
        else:
            assert os.path.exists(self.path_to_network_file), self.path_to_network_file
            ext = Path(self.path_to_network_file).suffixes[0]
            if self.verbose:
                logging.info("Loading network from %s" % self.path_to_network_file)

            if ext == ".mat":
                self.graph = _net_io.load_network_from_mat(
                    self.path_to_network_file, verbose=self.verbose)
            elif ext == ".gpickle":
                self.graph = _net_io.load_network_from_gpickle(
                    self.path_to_network_file, verbose=self.verbose)
            elif ext in (".txt", ".tsv"):
                self.graph = _net_io.load_network_from_txt(
                    self.path_to_network_file,
                    layout=getattr(self, "layout_algorithm", "spring_embedded"),
                    node_key_attribute=self.node_key_attribute,
                    seed=self.random_seed, verbose=self.verbose)
            elif ext == ".cys":
                self.graph = _net_io.load_network_from_cys(
                    self.path_to_network_file, view_name=self.view_name,
                    verbose=self.verbose)
            elif ext == ".scatter":
                self.graph = _net_io.load_network_from_scatter(
                    self.path_to_network_file,
                    node_key_attribute=self.node_key_attribute,
                    verbose=self.verbose)
                self._build_graph_euclidean()
            else:
                raise ValueError(f"unsupported network file extension: {ext}")

        key_list = nx.get_node_attributes(self.graph, self.node_key_attribute)
        if not key_list:
            raise Exception(
                "The specified node key attribute (%s) does not exist in this "
                "network. These attributes exist instead: %s. Set "
                "node_key_attribute to one of these options."
                % (self.node_key_attribute,
                   ", ".join(map(str, self.graph.nodes[0].keys()))))

        self._d0_cache = {}
        self._banded_cache = {}
        self._bandstore_cache = {}
        self._graph_arrays = None
        nx.set_node_attributes(self.graph, key_list, name="key")
        label_list = nx.get_node_attributes(self.graph, "label")
        self.nodes = pd.DataFrame(data={"id": list(label_list.keys()),
                                        "key": list(key_list.values()),
                                        "label": list(label_list.values())})

    def _build_graph_euclidean(self):
        """Pseudo-network connecting nodes within the neighborhood radius —
        used for unimodality checks on edgeless scatter inputs (safe.py:302-309).

        Above dense scale the same strict-< adjacency comes from a KD-tree
        radius query instead of the O(N^2) distance matrix."""
        coords = _ga.get_node_coordinates(self.graph)
        nr = self.neighborhood_radius * (coords.ravel().max() - coords.ravel().min())
        n = len(coords)
        if n > 20000:
            from scipy.spatial import cKDTree
            pairs = cKDTree(coords).query_pairs(nr, output_type="ndarray")
            d = np.hypot(coords[pairs[:, 0], 0] - coords[pairs[:, 1], 0],
                         coords[pairs[:, 0], 1] - coords[pairs[:, 1], 1])
            g = nx.Graph()
            g.add_nodes_from(range(n))
            g.add_edges_from(pairs[d < nr])
            self.graph_euclidean = g
        else:
            dist = np.asarray(_nbr.euclidean_distance_matrix(coords))
            adjacency = (dist < nr).astype(float)
            self.graph_euclidean = nx.from_numpy_array(adjacency)

    def save_network(self, **kwargs):
        output_file = kwargs.get(
            "output_file",
            os.path.join(os.getcwd(), str(self.path_to_network_file) + ".gpickle"))
        with open(output_file, "wb") as f:
            pickle.dump(self.graph, f)

    # ---------------------------------------------------------------- attributes

    def load_attributes(self, **kwargs):
        """Load and align node attributes (reference: safe.py:334-367)."""
        if "attribute_file" in kwargs:
            af = kwargs.pop("attribute_file")
            if self.path_to_safe_data is None or isinstance(af, pd.DataFrame):
                self.path_to_attribute_file = af
            elif isinstance(af, str):
                self.path_to_attribute_file = os.path.join(self.path_to_safe_data, af)
            else:
                raise ValueError(type(af))
        if isinstance(self.path_to_attribute_file, str):
            assert os.path.exists(self.path_to_attribute_file), self.path_to_attribute_file

        self.validate_config()

        node_label_order = list(
            nx.get_node_attributes(self.graph, self.node_key_attribute).values())

        if self.verbose and isinstance(self.path_to_attribute_file, str):
            logging.info("Loading attributes from %s" % self.path_to_attribute_file)

        self.attributes, _, self.node2attribute = _attr_io.read_attributes(
            attribute_file=self.path_to_attribute_file,
            node_label_order=node_label_order,
            verbose=self.verbose, **kwargs)
        self._n2a_dev = None
        self._num_other_cache = None
        self._band_operands_cache = None
        self._attr_serial += 1

        from safepy_tpu import debug as _debug
        _debug.validate_attributes(self.node2attribute,
                                   self.graph.number_of_nodes(),
                                   warn=self.verbose)

    # ------------------------------------------------------------- neighborhoods

    def define_neighborhoods(self, **kwargs):
        """Dense neighborhood indicator via device APSP (reference: safe.py:369-430).

        The indicator and distance matrices stay device-resident; the
        ``neighborhoods`` / ``node_distances`` attributes materialize NumPy copies
        lazily on first access (device->host transfers of the N x N matrices
        are unnecessary for the rest of the device pipeline).
        """
    
        for k in ("node_distance_metric", "neighborhood_radius_type",
                  "neighborhood_radius"):
            if k in kwargs:
                setattr(self, k, kwargs[k])

        self.validate_config()

        num_nodes = self.graph.number_of_nodes()
        coords, edges, lengths, edge_weights = self._graph_to_arrays_cached()

        if self.node_distance_metric == "euclidean":
            x = coords[:, 0]
            nr = self.neighborhood_radius * (np.max(x) - np.min(x))
            # the staged front runs single-device either way (run_pipeline is
            # the sharded euclid path); the plan stays valid under a mesh
            eb_plan = self._euclidean_band_plan(coords, num_nodes, nr)
            if eb_plan is not None:
                from safepy_tpu import pipeline as _pipe
                rank, band = eb_plan["rank"], eb_plan["band"]
                keep = bool(self.keep_node_distances)
                dist_band, s_ind, mean, std = \
                    _pipe.euclidean_band_neighborhoods(
                        jnp.asarray(coords[np.argsort(rank)], jnp.float32),
                        np.float32(nr), n=num_nodes, band=band,
                        keep_distances=keep,
                        packed=(not keep
                                and self._band_bits_selected(num_nodes,
                                                             band)))
                dist_dev = (
                    _BandedMatrix(dist_band, rank, num_nodes, band,
                                  fill=np.inf)
                    if dist_band.shape[0] else None)  # keep_node_distances
                nbr_dev = _BandedMatrix(s_ind, rank, num_nodes, band,
                                        fill=0.0)
            else:
                dist_dev = _nbr.euclidean_distance_matrix(
                    jnp.asarray(coords, jnp.float32))
                nbr_dev, mean, std = _nbr.threshold_and_stats(
                    dist_dev, np.float32(nr), strict=True)
        else:
            if self.node_distance_metric == "shortpath_weighted_layout":
                x = coords[:, 0]
                nr = self.neighborhood_radius * (np.max(x) - np.min(x))
                if lengths is None:
                    raise ValueError(
                        "shortpath_weighted_layout requires edge 'length' attributes "
                        "(computed by calculate_edge_lengths at network load)")
                weights = lengths
            else:
                # 'shortpath': absolute radius over edge 'weight' attributes
                # (1 where absent) — NetworkX Dijkstra's default weight key
                # (reference safe.py:409-410)
                nr = self.neighborhood_radius
                weights = edge_weights

            mesh_shape = {} if self.mesh is None else self.mesh.shape
            on_2d_mesh = "row" in mesh_shape and "col" in mesh_shape
            on_data_mesh = "data" in mesh_shape or on_2d_mesh
            bs_plan = None if self.mesh is not None else \
                self._band_storage_plan(coords, edges, weights, num_nodes, nr)
            if bs_plan is not None:
                dist_band, s_ind, mean, std = self._band_front_dispatch(
                    bs_plan, _nbr.inclusive_radius(nr), num_nodes)
                dist_dev = (
                    _BandedMatrix(dist_band, bs_plan["rank"], num_nodes,
                                  bs_plan["band"], fill=np.inf)
                    if dist_band.shape[0] else None)  # keep_node_distances
                nbr_dev = _BandedMatrix(s_ind, bs_plan["rank"], num_nodes,
                                        bs_plan["band"], fill=0.0)
                self._neighborhoods_dev = nbr_dev
                self._neighborhoods_np = None
                self._node_distances_dev = dist_dev
                self._node_distances_np = None
                if self.verbose:
                    logging.info("Node distance metric: %s (band storage)"
                                 % self.node_distance_metric)
                    logging.info(
                        "Number of nodes per neighborhood (mean +/- std): "
                        "%.2f +/- %.2f" % (float(mean), float(std)))
                return
            plan = None if on_data_mesh else self._banded_plan(
                coords, edges, weights, num_nodes, nr)
            if plan is not None:
                from safepy_tpu.ops.apsp_banded import apsp_banded_unpermuted
                d0p, rank_dev, window = plan
                dist_dev = apsp_banded_unpermuted(
                    d0p, rank_dev, _nbr.inclusive_radius(nr), window=window,
                    impl=self.minplus_impl)
            else:
                d0_dev = self._d0_cache.get(self.node_distance_metric)
                if d0_dev is None:
                    d0_dev = _nbr.initial_distances_device(num_nodes, edges,
                                                           weights)
                    self._d0_cache[self.node_distance_metric] = d0_dev
                if on_2d_mesh:
                    from safepy_tpu.parallel import apsp_sharded_2d
                    dist_dev = apsp_sharded_2d(d0_dev, self.mesh,
                                               impl=self.minplus_impl)
                elif on_data_mesh:
                    from safepy_tpu.parallel import apsp_sharded
                    dist_dev = apsp_sharded(d0_dev, self.mesh, axis="data",
                                            impl=self.minplus_impl)
                else:
                    # undirected graph -> symmetric d0: mirror-halved FW
                    dist_dev = _apsp_run(d0_dev, symmetric=True,
                                         impl=self.minplus_impl)
            nbr_dev, mean, std = _nbr.threshold_and_stats(
                dist_dev, _nbr.inclusive_radius(nr), strict=False)

        self._neighborhoods_dev = nbr_dev
        self._neighborhoods_np = None
        self._node_distances_dev = dist_dev
        self._node_distances_np = None

        if self.verbose:
            logging.info("Node distance metric: %s" % self.node_distance_metric)
            logging.info("Neighborhood definition: %.2f x %s"
                         % (self.neighborhood_radius, self.neighborhood_radius_type))
            logging.info("Number of nodes per neighborhood (mean +/- std): "
                         "%.2f +/- %.2f" % (float(mean), float(std)))

    # --- lazy NumPy views over the device-resident matrices -------------------

    @property
    def neighborhoods(self):
        if self._neighborhoods_np is None and self._neighborhoods_dev is not None:
            dev = self._neighborhoods_dev
            if isinstance(dev, _BandedMatrix):
                # band-storage scale: dense materialization is guarded; use
                # neighborhoods_sparse() / the pipeline outputs at huge N
                self._neighborhoods_np = dev.to_dense().astype(int)
            else:
                self._neighborhoods_np = np.asarray(_to_int8(dev)).astype(int)
        return self._neighborhoods_np

    def neighborhoods_sparse(self):
        """scipy CSR of the neighborhood indicator — the O(nnz) accessor for
        band-storage scale networks where the dense (N, N) matrix is guarded."""
        dev = self._neighborhoods_dev
        if isinstance(dev, _BandedMatrix):
            return dev.to_sparse()
        from scipy.sparse import csr_matrix
        return csr_matrix(np.asarray(self.neighborhoods))

    @neighborhoods.setter
    def neighborhoods(self, value):
        self._neighborhoods_np = value
        self._neighborhoods_dev = None

    @property
    def node_distances(self):
        if self._node_distances_np is None and self._node_distances_dev is not None:
            dev = self._node_distances_dev
            if isinstance(dev, _BandedMatrix):
                self._node_distances_np = dev.to_dense().astype(np.float64)
            else:
                self._node_distances_np = np.asarray(dev, dtype=np.float64)
        return self._node_distances_np

    def node_distances_sparse(self):
        """scipy CSR of the within-radius distances (band-storage accessor)."""
        dev = self._node_distances_dev
        if isinstance(dev, _BandedMatrix):
            return dev.to_sparse()
        from scipy.sparse import csr_matrix
        d = np.asarray(self.node_distances)
        return csr_matrix(np.where(np.isfinite(d), d, 0.0))

    @node_distances.setter
    def node_distances(self, value):
        self._node_distances_np = value
        self._node_distances_dev = None

    @property
    def nes(self):
        if self._nes_np is None:
            if self._nes_device() is not None:
                self._nes_np = np.asarray(self._nes_dev, dtype=np.float64)
            elif self._nes_from_logsf and self._logsf_np is not None:
                # host-streamed log-survival (logsf_out='host'): same f64
                # divide + f32 round as _nes_from_logsf_jit, so the host and
                # device storage modes agree bitwise
                with np.errstate(invalid="ignore"):
                    self._nes_np = (
                        -self._logsf_np.astype(np.float64) / np.log(10.0)
                    ).astype(np.float32).astype(np.float64)
        return self._nes_np

    @nes.setter
    def nes(self, value):
        self._nes_np = value
        self._nes_dev = None
        self._nes_from_logsf = False

    @property
    def pvalues_pos(self):
        if self._pvalues_pos_np is None:
            # GO-scale fused path defers the log-survival download + host exp
            # until p-values are actually consumed (NES/domain workflows never
            # touch them). _logsf_np is the pickled f32 form (f32->f64 is
            # exact, so the exp is bit-identical either way).
            log_sf = None
            if self._logsf_np is not None:
                log_sf = self._logsf_np.astype(np.float64)
            elif self._logsf_dev is not None:
                log_sf = np.asarray(self._logsf_dev, dtype=np.float64)
            if log_sf is not None:
                with np.errstate(over="ignore"):
                    self._pvalues_pos_np = np.exp(log_sf)
        return self._pvalues_pos_np

    @pvalues_pos.setter
    def pvalues_pos(self, value):
        self._pvalues_pos_np = value
        self._logsf_dev = None
        self._logsf_np = None

    @property
    def nes_binary(self):
        if self._nes_binary_np is None:
            small = self._nes_binary_i8_np
            if small is None and self._nes_binary_dev is not None:
                small = np.asarray(self._nes_binary_dev)
                self._nes_binary_i8_np = small
            if small is not None:
                self._nes_binary_np = small.astype(float)
        return self._nes_binary_np

    @nes_binary.setter
    def nes_binary(self, value):
        self._nes_binary_np = value
        self._nes_binary_dev = None
        self._nes_binary_i8_np = None
        self._nes_binary_csc = None
        self._domains_inter_cache = None
        self._enrichment_serial = getattr(self, "_enrichment_serial", 0) + 1

    def _graph_to_arrays_cached(self):
        """graph_to_arrays walks the whole NetworkX graph in Python (~0.25 s
        at 20k nodes); the result only changes when the graph does, so it is
        cached alongside the d0 cache (cleared by load_network)."""
        if self._graph_arrays is None:
            self._graph_arrays = _ga.graph_to_arrays(self.graph)
        return self._graph_arrays

    def _banded_plan(self, coords, edges, lengths, num_nodes, nr):
        """(d0_permuted_dev, rank_dev, window) or None — certified banded-FW
        plan for shortpath_weighted_layout (ops/apsp_banded.py). The geometric
        certificate requires edge lengths to BE the Euclidean endpoint
        distances (unit edge weights); anything else falls back to the full
        kernel. Cached per radius; cleared with the graph."""
        if (self.apsp_mode != "auto"
                or self.node_distance_metric != "shortpath_weighted_layout"
                or lengths is None or len(edges) == 0):
            return None
        key = float(np.float32(nr))
        if key in self._banded_cache:
            return self._banded_cache[key]

        from safepy_tpu.ops import apsp_banded as _banded

        plan = None
        euclid = np.hypot(coords[edges[:, 0], 0] - coords[edges[:, 1], 0],
                          coords[edges[:, 0], 1] - coords[edges[:, 1], 1])
        if np.allclose(lengths, euclid, rtol=1e-7, atol=1e-12):
            order, band = _banded.banded_order(coords, nr * (1 + 1e-5))
            window = _banded.window_width(num_nodes, band)
            npad = -(-num_nodes // 128) * 128
            if window <= 0.75 * npad:  # below this the gather overhead wins
                rank = np.empty(num_nodes, dtype=np.int64)
                rank[order] = np.arange(num_nodes)
                # O(E) edge arrays only; the dense init materializes INSIDE the
                # fused program (no persistent N x N copy in HBM between runs)
                permuted = rank[edges]
                init = (jnp.asarray(permuted[:, 0], jnp.int32),
                        jnp.asarray(permuted[:, 1], jnp.int32),
                        jnp.asarray(np.asarray(lengths, np.float32)))
                plan = (init, jnp.asarray(rank, jnp.int32), window)
        self._banded_cache[key] = plan
        return plan

    @staticmethod
    def _hypergeom_host_operands(n2a, order):
        """(nan0_perm f32, nodes_not_nan_perm f32, K f64->f32) for the banded
        hypergeometric core — computed on the host so the NaN-carrying matrix
        never occupies device HBM."""
        finite = ~np.isnan(n2a)
        nan0 = np.where(finite, n2a, 0.0).astype(np.float32)
        # f64 accumulation: exact for binary counts at any N, and safe for
        # forced-hypergeometric non-binary values now that node2attribute
        # may be stored f32 (io/attributes.py keeps the source float dtype)
        K = nan0.sum(axis=0, dtype=np.float64).astype(np.float32)
        nnn = np.any(finite, axis=1).astype(np.float32)
        return nan0[order], nnn[order], K

    @staticmethod
    def _hypergeom_attr_chunk(n, num_attrs, budget_elems=2 ** 24):
        """Attribute chunk for the banded survival tail: the tail's f64
        intermediates are (N, A)-shaped and ~8-10 of them are live inside one
        chunk (gathers, broadcasts, while-loop carry), so cap a chunk at
        ~128 MB of f64 (2^24 elements); None = unchunked."""
        if n * num_attrs <= budget_elems:
            return None
        return int(max(64, budget_elems // max(1, n)))

    def _euclidean_band_plan(self, coords, num_nodes, nr):
        """Band plan for the EUCLIDEAN metric (no edge-length contract — the
        band certificate is the measured index separation of the radius pairs
        themselves). dict(rank, band) or None."""
        forced = self.apsp_mode == "band"
        if not forced and (self.apsp_mode != "auto"
                           or num_nodes < int(self.band_storage_min_nodes)):
            return None
        # the forced flag is part of plan construction: an 'auto' run that
        # rejected the band must not pin apsp_mode='band' reruns to None
        key = ("euclid", float(np.float32(nr)), forced)
        if key in self._bandstore_cache:
            return self._bandstore_cache[key]

        from safepy_tpu.ops import apsp_banded as _banded
        from safepy_tpu.ops import apsp_bandstore as _bst

        plan = None
        order, band = _banded.banded_order(coords, nr)
        band = self._bucket_band(band)
        if forced or (_bst.band_nbytes(num_nodes, band)
                      <= 0.5 * 4 * num_nodes * num_nodes):
            rank = np.empty(num_nodes, dtype=np.int64)
            rank[order] = np.arange(num_nodes)
            plan = dict(rank=rank, band=int(band))
        self._bandstore_cache[key] = plan
        return plan

    def _band_storage_plan(self, coords, edges, weights, num_nodes, nr):
        """Band-STORAGE plan (ops/apsp_bandstore.py) or None.

        Selected when the dense (N, N) matrices would not fit one chip
        (``apsp_mode='auto'`` above ``band_storage_min_nodes``) or when forced
        with ``apsp_mode='band'``. Two certificates, tried in order:

          * geometric (edge lengths ARE the Euclidean endpoint distances —
            the default `shortpath_weighted_layout` contract): spatial-sort
            band measured over the radius pairs (ops/apsp_banded.banded_order);
          * landmark (ANY metric, incl. 'shortpath' hop counts, reference
            safe.py:408-410): order by per-component peripheral-source
            distance; the triangle inequality bounds every within-radius
            pair's rank separation (ops/apsp_banded.graph_banded_order).

        Returns dict(u, v, w, rank, rank_dev, band)."""
        forced = self.apsp_mode == "band"
        if not forced and (self.apsp_mode != "auto"
                           or num_nodes < int(self.band_storage_min_nodes)):
            return None
        if (self.node_distance_metric not in ("shortpath_weighted_layout",
                                              "shortpath")
                or weights is None or len(edges) == 0):
            return None
        # forced flag in the key: a cached 'auto' rejection (None) must not
        # shadow a later apsp_mode='band' run (and vice versa)
        key = (float(np.float32(nr)), forced, self.node_distance_metric)
        if key in self._bandstore_cache:
            return self._bandstore_cache[key]

        from safepy_tpu.ops import apsp_banded as _banded
        from safepy_tpu.ops import apsp_bandstore as _bst

        plan = None
        order = None
        if (self.node_distance_metric == "shortpath_weighted_layout"
                and coords is not None):
            euclid = np.hypot(coords[edges[:, 0], 0] - coords[edges[:, 1], 0],
                              coords[edges[:, 0], 1] - coords[edges[:, 1], 1])
            if np.allclose(weights, euclid, rtol=1e-7, atol=1e-12):
                order, band = _banded.banded_order(coords, nr * (1 + 1e-5))
        if order is None:
            order, band = _banded.graph_banded_order(num_nodes, edges,
                                                     weights, nr * (1 + 1e-5))
        band = self._bucket_band(band)
        # the band must genuinely beat dense storage (unless forced)
        if forced or (_bst.band_nbytes(num_nodes, band)
                      <= 0.5 * 4 * num_nodes * num_nodes):
            rank = np.empty(num_nodes, dtype=np.int64)
            rank[order] = np.arange(num_nodes)
            permuted = rank[edges]
            plan = dict(
                u=jnp.asarray(permuted[:, 0], jnp.int32),
                v=jnp.asarray(permuted[:, 1], jnp.int32),
                w=jnp.asarray(np.asarray(weights, np.float32)),
                rank=rank,
                rank_dev=jnp.asarray(rank, jnp.int32),
                band=int(band))
            # host edge copies for the lazily-built sparse-BF relax slots
            # (_band_bf_args; only materialized when band_relax='bf')
            plan["edges_perm"] = permuted
            plan["weights_np"] = np.asarray(weights, np.float32)
        self._bandstore_cache[key] = plan
        return plan

    def _band_bf_args(self, plan):
        """(bf_slots, bf_max_iters) kwargs for the band pipelines, honoring
        ``band_relax``. Empty dict = FW, the production engine: sparse BF
        converges in ~path-hop rounds (ops/apsp_bandstore.apsp_band_bf) but
        each round is a gather-bound pass over the band, so 'auto' resolves
        to FW (docs/DESIGN.md). Slot operands build lazily on first 'bf' use;
        the iteration budget caps BF's worst (non-converging, fall-back) case
        at ~2x FW."""
        if self.band_relax != "bf":
            return {}
        if "bf_nbr" not in plan:
            from safepy_tpu.ops import apsp_bandstore as _bst
            slots = _bst.band_bf_slots(
                plan["edges_perm"][:, 0], plan["edges_perm"][:, 1],
                plan["weights_np"], n=int(len(plan["rank"])),
                band=int(plan["band"]))
            if slots is None:
                return {}
            nbr, dlt, wgt, s_slots = slots
            plan.update(bf_nbr=jnp.asarray(nbr), bf_dlt=jnp.asarray(dlt),
                        bf_wgt=jnp.asarray(wgt),
                        bf_max_iters=_bst.bf_max_iters(
                            int(len(plan["rank"])), int(plan["band"]),
                            s_slots))
        return dict(bf_slots=(plan["bf_nbr"], plan["bf_dlt"],
                              plan["bf_wgt"]),
                    bf_max_iters=int(plan["bf_max_iters"]))

    def _band_front_dispatch(self, plan, radius, num_nodes):
        """band_neighborhoods with the selected relax engine; re-dispatches
        with FW when sparse BF hits its iteration budget unconverged (the
        band then holds upper bounds, not final distances). Records the
        engine that actually ran in ``_band_relax_used``."""
        from safepy_tpu import pipeline as _pipe

        pk = self._band_bits_selected(num_nodes, plan["band"])
        bf = self._band_bf_args(plan)
        if bf:
            out = _pipe.band_neighborhoods(
                plan["u"], plan["v"], plan["w"], radius, n=num_nodes,
                band=plan["band"], packed=pk, impl=self.minplus_impl, **bf)
            if bool(np.asarray(out[4])):
                self._band_relax_used = "bf"
                dist_band, s_ind, mean, std = out[:4]
                if not self.keep_node_distances:
                    dist_band = jnp.zeros((0, 1), jnp.float32)
                return dist_band, s_ind, mean, std
            self._band_relax_used = "bf->fw"
            logging.info("band BF relax hit its iteration budget; "
                         "re-dispatching Floyd-Warshall")
        else:
            self._band_relax_used = "fw"
        if self._band_split_selected(num_nodes, plan["band"]):
            s = _pipe.band_init(plan["u"], plan["v"], plan["w"], n=num_nodes,
                                band=plan["band"])
            out = _pipe.band_relax_threshold(
                s, radius, n=num_nodes, bt=plan["band"] // 128 + 1, packed=pk,
                impl=self.minplus_impl)
            del s  # donated; aliased by the returned distance band
        else:
            out = _pipe.band_neighborhoods(
                plan["u"], plan["v"], plan["w"], radius, n=num_nodes,
                band=plan["band"], packed=pk, impl=self.minplus_impl)[:4]
        dist_band, s_ind, mean, std = out
        if not self.keep_node_distances:
            # drop the only reference: the device frees the f32 band before
            # any downstream dispatch runs
            dist_band = jnp.zeros((0, 1), jnp.float32)
        return dist_band, s_ind, mean, std

    def _bucket_band(self, band: int, block: int = 128) -> int:
        """Round ``band`` up so bt (= band//block + 1) lands on the
        ``band_bt_bucket`` lattice (compile-cache reuse across radius
        sweeps; see the attribute comment). The certified band only
        widens, so results are identical (test-pinned).

        Every band in a bucket maps to the bucket's CANONICAL (maximum)
        band, not just the same bt: ``band`` itself is a static argname of
        the jitted band pipelines, so two same-bt radii with different raw
        bands would still compile two programs."""
        bucket = int(self.band_bt_bucket or 0)
        if bucket <= 1:
            return int(band)
        bt = band // block + 1
        bt_b = -(-bt // bucket) * bucket
        return bt_b * block - 1

    def _band_go_hbm_guard(self, num_nodes, band, n_attrs):
        """Pre-dispatch memory plan for the single-device band GO (binary
        table) pipeline: raises a clean ValueError with the plan when nothing
        fits — never hands XLA an allocation that would OOM midway through a
        fused program. This PRE-PREP check models the class table with an
        estimate; the authoritative (residency, lookup group) selection
        happens inside hypergeom_band_table once the true table geometry is
        known (hbm.census_select)."""
        from safepy_tpu import hbm as _hbm
        plan = _hbm.band_go_hbm_plan(
            num_nodes, band, n_attrs,
            packed=self._band_bits_selected(num_nodes, band),
            split_front=self._band_split_selected(num_nodes, band),
            keep_distances=bool(self.keep_node_distances),
            logsf_out=self.logsf_store,
            prep_chunked=self._prep_chunked_selected(),
            budget=self.hbm_budget_bytes)
        self._hbm_plan_last = plan
        if not plan["fits"]:
            raise ValueError(
                "refusing to dispatch a band GO pipeline that does not fit "
                "the device: "
                + _hbm.explain(plan)
                + ". Levers: keep_node_distances=False, "
                  "band_indicator_bits=True, logsf_store='f16'/'host', or "
                  "set SAFE.mesh for the row-sharded engine.")
        return plan

    def _kept_band_bytes(self):
        """Bytes of a device-resident f32 distance band the census selection
        must count as caller-owned residents (keep_node_distances=True)."""
        bm = self._node_distances_dev
        try:
            return int(bm.data.nbytes) if bm is not None else 0
        except AttributeError:
            return 0

    def _record_census_select(self, sel):
        """Merge the census engine's authoritative (logsf_out, lookup_group)
        decision into the observability plan (``SAFE._hbm_plan_last``)."""
        if not sel:
            return
        if isinstance(self._hbm_plan_last, dict):
            self._hbm_plan_last = dict(self._hbm_plan_last,
                                       census_final=sel,
                                       logsf_out=sel["logsf_out"],
                                       lookup_group=sel["lookup_group"],
                                       census_peak=sel["census_peak"])
        if self.verbose and (sel["logsf_out"] != "device"
                             or sel["lookup_group"] != 8):
            logging.info("HBM plan: log-survival residency %s, lookup "
                         "group %d (census peak %.2f GB of %.2f GB "
                         "admitted)", sel["logsf_out"], sel["lookup_group"],
                         sel["census_peak"] / 1e9, sel["admit"] / 1e9)

    def _band_go_shard_guard(self, num_nodes, band, n_attrs):
        """Per-shard HBM plan assertion for the ROW-SHARDED band GO engine —
        the sharded twin of :meth:`_band_go_hbm_guard`, called BEFORE the
        operand prep."""
        from safepy_tpu import hbm as _hbm
        splan = _hbm.band_go_shard_hbm_plan(
            num_nodes, band, n_attrs, int(self.mesh.shape["data"]),
            packed=self._band_bits_selected(num_nodes, band),
            budget=self.hbm_budget_bytes)
        self._hbm_plan_last = splan
        if not splan["fits"]:
            raise ValueError(
                "refusing to dispatch a sharded band GO pipeline that does "
                "not fit per shard: " + _hbm.explain(splan)
                + ". Add devices to the 'data' mesh axis or lower the "
                  "radius.")
        return splan

    def _band_bits_selected(self, num_nodes, band):
        """Bit-pack the indicator band? (euclidean keep_node_distances=False
        paths; dtype-keyed downstream — see ops/apsp_bandstore)."""
        mode = self.band_indicator_bits
        if mode == "auto":
            from safepy_tpu.ops.apsp_bandstore import band_nbytes
            return (band_nbytes(num_nodes, band, itemsize=1)
                    >= float(self.band_bits_min_bytes))
        return bool(mode)

    def _band_split_selected(self, num_nodes, band):
        """Split the band front into init -> donated-relax (-> tail)
        dispatches when the f32 band store crosses band_split_min_bytes —
        the fused program double-buffers the FW loop's band (see
        pipeline.band_relax_threshold)."""
        from safepy_tpu.ops.apsp_bandstore import band_nbytes
        return band_nbytes(num_nodes, band) >= float(self.band_split_min_bytes)

    def _node2attribute_device(self):
        """(N, A) f32 device copy of node2attribute (NaNs preserved), uploaded
        once per load — repeat pipeline runs skip the 100+ MB transfer. Binary
        annotations and f32-representable values are exact; the enrichment
        kernels compute in f32/f64 on device either way."""
        if self._n2a_dev is None:
            self._n2a_dev = jnp.asarray(
                np.asarray(self.node2attribute, dtype=np.float32))
        return self._n2a_dev

    def _band_hyper_operands_cached(self, order):
        """(nan0_perm_int8, nnn_perm, K, binary_ok, M) for the band binary
        engines — computed ON DEVICE from the annotation upload (host
        isnan/where/fancy-gather cost minutes at GO scale here) and cached
        ACROSS pipeline runs: once the f32 (N, A) upload is released at GO
        scale, re-deriving per run would re-upload 3.49 GB every steady
        run. Keyed on the annotation serial + banded order."""
        import hashlib
        # collision-resistant digest: Python's 64-bit hash() could
        # (astronomically rarely) collide two different banded orders of the
        # same length and silently serve wrongly-permuted operands
        key = (self._attr_serial, order.shape[0],
               hashlib.sha1(order.tobytes()).digest())
        c = self._band_operands_cache
        if c is not None and c[0] == key:
            return c[1]
        if self._prep_chunked_selected():
            # GO-scale prep: column-chunked uploads. The full-device jit
            # peaks at ~10 (N, A)-cells (XLA materializes the f32 nan0 for
            # its two consumers) — chunked peaks at ~2 cells + one f32
            # chunk and never stages the full f32 upload
            from safepy_tpu.ops.enrich_band import (
                band_hyper_operands_chunked)
            nan0, nnn, K, binary_ok = band_hyper_operands_chunked(
                self.node2attribute, order)
        else:
            from safepy_tpu.ops.enrich_band import band_hyper_operands_device
            nan0, nnn, K, binary_ok = band_hyper_operands_device(
                self._node2attribute_device(), jnp.asarray(order, jnp.int32))
        binary_ok = bool(np.asarray(binary_ok))
        M = int(np.asarray(jnp.sum(nnn)))
        if not binary_ok:
            # the int8 cast of non-binary values is lossy and never consumed:
            # cache only the census scalars, free the (N, A) device buffer
            nan0 = None
        out = (nan0, nnn, K, binary_ok, M)
        self._band_operands_cache = (key, out)
        if binary_ok:
            # the int8 operands carry everything the table engine needs:
            # drop the f32 upload before the band FW so the relax never
            # shares the device with it (199,680 x 4,373: 3.49 GB back)
            self._maybe_release_annotation_upload()
        return out

    def _maybe_release_annotation_upload(self):
        """Drop the cached f32 (N, A) annotation upload when it crosses
        ``annotation_release_min_bytes`` — the band binary engines carry
        everything forward in the int8 operands, and at GO band scale the
        f32 copy otherwise shares the device with the FW band. Lazy
        re-upload on the
        next :meth:`_node2attribute_device` call."""
        if (self._n2a_dev is not None
                and self._n2a_dev.nbytes
                >= float(self.annotation_release_min_bytes)):
            self._n2a_dev = None

    def _prep_chunked_selected(self):
        """Build the band binary operands / binary detection from column-
        chunked uploads? True when the full f32 (N, A) upload would cross
        ``annotation_release_min_bytes`` and is not already device-resident
        — the chunked paths never stage it (see
        ops/enrich_band.band_hyper_operands_chunked)."""
        n2a = self.node2attribute
        return (self._n2a_dev is None and n2a is not None
                and 4 * n2a.size >= float(self.annotation_release_min_bytes))

    def _num_other_values(self):
        """Count of finite non-0/1 annotation values (the reference's binary
        detection, safe.py:454-456) — computed ON DEVICE from the cached
        annotation upload and cached: the host isnan/isin pass costs tens of
        seconds per call at 100k x 4,373 in this runtime. At GO band scale
        the count comes from column-chunked uploads instead (the full f32
        staging plus its eager bool temps is itself an HBM event at
        399,360 x 4,373)."""
        if self._num_other_cache is None:
            if self._prep_chunked_selected():
                from safepy_tpu.ops.enrich_band import (
                    count_other_values_chunked)
                self._num_other_cache = count_other_values_chunked(
                    self.node2attribute)
            else:
                v = self._node2attribute_device()
                self._num_other_cache = int(np.asarray(jnp.sum(
                    jnp.isfinite(v) & (v != 0.0) & (v != 1.0),
                    dtype=jnp.int32)))
        return self._num_other_cache

    def _neighborhoods_device(self):
        """(N, N) f32 device array of the indicator, uploading if necessary."""
        if isinstance(self._neighborhoods_dev, _BandedMatrix):
            raise RuntimeError(
                "neighborhoods are band-stored (O(N*W)); the dense device "
                "matrix does not exist at this scale — use the banded compute "
                "paths (they are selected automatically)")
        if self._neighborhoods_dev is None:
            if self._neighborhoods_np is None:
                raise RuntimeError("define_neighborhoods has not been run")
            self._neighborhoods_dev = jnp.asarray(self._neighborhoods_np,
                                                  jnp.float32)
        return self._neighborhoods_dev

    def __getstate__(self):
        """Pickle support (SAFE.save): materialize NumPy, drop device arrays.

        Band-stored matrices are pickled AS bands (their dense forms may be
        guarded or plain impossible at scale); they re-materialize lazily
        after unpickling."""
        bm_nbr = isinstance(self._neighborhoods_dev, _BandedMatrix)
        bm_dist = isinstance(self._node_distances_dev, _BandedMatrix)
        if not bm_nbr:
            _ = self.neighborhoods, self.node_distances  # force lazy downloads
        # lazy statistics: pickle the COMPACT forms (f32 log-survival, int8
        # indicator) and let the properties rematerialize f64 on demand — the
        # f64 forms are 3.5 GB each at the 99,840 x 4,373 band scale
        _ = self.nes
        if self._pvalues_pos_np is None and self._logsf_dev is not None:
            self._logsf_np = np.asarray(self._logsf_dev)
        if self._nes_binary_pending is not None:
            self._update_binary_enrichment()
        if self._nes_binary_np is None and self._nes_binary_dev is not None:
            self._nes_binary_i8_np = np.asarray(self._nes_binary_dev)
        state = dict(self.__dict__)
        state["_neighborhoods_dev"] = (
            self._neighborhoods_dev.to_host() if bm_nbr else None)
        state["_node_distances_dev"] = (
            self._node_distances_dev.to_host() if bm_dist else None)
        state["_logsf_dev"] = None
        state["_nes_dev"] = None
        state["_nes_binary_dev"] = None
        state["_n2a_dev"] = None
        state["_band_operands_cache"] = None
        state["_nes_binary_pending"] = None
        state["_domains_inter_cache"] = None  # derived; up to 76 MB at GO scale
        state["_nes_binary_csc"] = None  # derived sparse view, rebuilds on demand
        state["_d0_cache"] = {}
        state["_banded_cache"] = {}
        state["_bandstore_cache"] = {}
        state["_graph_arrays"] = None
        state["mesh"] = None  # Mesh holds live Device objects; not picklable
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        # attributes added after a session was saved default like __init__
        self.__dict__.setdefault("cluster_engine", "auto")
        self.__dict__.setdefault("_domains_inter_cache", None)
        self.__dict__.setdefault("_nes_binary_i8_np", None)
        self.__dict__.setdefault("_nes_binary_csc", None)
        self.__dict__.setdefault("_logsf_np", None)
        self.__dict__.setdefault("_nes_from_logsf", False)
        self.__dict__.setdefault("annotation_release_min_bytes", 2 * 10 ** 9)
        self.__dict__.setdefault("logsf_store", "auto")
        self.__dict__.setdefault("band_bt_bucket", 4)
        self.__dict__.setdefault("hbm_budget_bytes", None)
        self.__dict__.setdefault("_hbm_plan_last", None)
        self.__dict__.setdefault("_band_operands_cache", None)
        self.__dict__.setdefault("_attr_serial", 0)
        self.__dict__.setdefault("_enrichment_serial", 0)
        self.__dict__.setdefault("_node2domain_serial", None)

    # ------------------------------------------------------------------ p-values

    def compute_pvalues(self, **kwargs):
        """Dispatch to the hypergeometric or permutation enrichment engine
        (reference: safe.py:432-472)."""
        if "how" in kwargs:
            self.enrichment_type = kwargs["how"]
        if "neighborhood_score_type" in kwargs:
            self.neighborhood_score_type = kwargs["neighborhood_score_type"]
        if "multiple_testing" in kwargs:
            self.multiple_testing = kwargs["multiple_testing"]
        if "background" in kwargs:
            self.background = kwargs["background"]

        self.validate_config()

        if self.background == "network":
            logging.info("Setting all null attribute values to 0. Using the network "
                         "as background for enrichment.")
            if not self.node2attribute.flags.writeable:
                # read_attributes hands out a read-only no-copy view; this is
                # the one consumer that mutates it (reference: safe.py:449-451)
                self.node2attribute = self.node2attribute.copy()
            self.node2attribute[np.isnan(self.node2attribute)] = 0
            self._n2a_dev = None
            self._num_other_cache = None
            self._band_operands_cache = None
            self._attr_serial += 1

        num_vals = self.node2attribute.shape[0]
        num_nans = np.sum(np.isnan(self.node2attribute), axis=0)
        if np.any(num_nans / num_vals > 0.5):
            logging.warning(
                "WARNING: more than 50%% of nodes in the network are set to NaN and "
                "will be ignored for calculating enrichment.\n"
                "Consider setting sf.background = 'network'.")

        num_other_values = self._num_other_values()

        if (self.enrichment_type == "hypergeometric"
                or (self.enrichment_type == "auto" and num_other_values == 0)):
            self.compute_pvalues_by_hypergeom(**kwargs)
        else:
            self.compute_pvalues_by_randomization(**kwargs)

        self._update_binary_enrichment()

    def compute_pvalues_by_hypergeom(self, **kwargs):
        """One-sided hypergeometric enrichment (reference: safe.py:556-608).

        Census matmuls run as device GEMMs; the survival function's tail sum runs on
        device with host-side f64 finalization (see ops/hypergeom.py).
        """
        if kwargs:
            if "verbose" in kwargs:
                self.verbose = kwargs["verbose"]
            if self.verbose:
                logging.warning("Overwriting global settings:")
                for k in kwargs:
                    logging.warning("\t%s=%s" % (k, str(kwargs[k])))

        self.validate_config()

        if self.verbose:
            logging.info("Using the hypergeometric test to calculate enrichment...")

        n2a = self.node2attribute

        if isinstance(self._neighborhoods_dev, _BandedMatrix):
            return self._hypergeom_bandstore(self._neighborhoods_dev, n2a)

        if self.mesh is not None and "attr" in self.mesh.shape:
            # attribute-column parallelism over the mesh (the reference's CLI
            # pool, safe.py:1335-1355): census AND sf tail inside the shard_map
            # workers, gather only the f32 (N, A) results
            from safepy_tpu.parallel import hypergeom_enrichment_sharded
            nes32, log_sf32, nes_binary8, counts_dev = \
                hypergeom_enrichment_sharded(
                    self._neighborhoods_device(), n2a, mesh=self.mesh,
                    enrichment_threshold=self.enrichment_threshold,
                    node2attribute_device=self._node2attribute_device())
            self._hypergeom_engine_used = "loop-dense-attr-sharded"
            # significance decided on device in f64 before the f32 rounding;
            # only the (A,) counts cross to the host here
            return self._store_hypergeom_results(nes32, log_sf32, nes_binary8,
                                                 counts_dev)

        nodes_not_nan = np.any(~np.isnan(n2a), axis=1)
        n = int(np.sum(nodes_not_nan))

        N_in_group = np.nansum(n2a, axis=0, dtype=np.float64)  # totals (A,)

        nbr = self._neighborhoods_device()
        kw = dict(precision=jax.lax.Precision.HIGHEST,
                  preferred_element_type=jnp.float32)
        neighborhood_size = np.asarray(
            jnp.dot(nbr, jnp.asarray(nodes_not_nan, jnp.float32), **kw))  # (N,)
        n2a_dev = self._node2attribute_device()
        counts = jnp.dot(
            nbr, jnp.where(jnp.isfinite(n2a_dev), n2a_dev, 0.0),
            **kw)  # (N, A), stays on device for the sf tail sum

        # tail length is bounded by min(K, n): use max annotated total AND max
        # neighborhood size to size the static loop
        k_max = int(max(1, np.nanmax(N_in_group))) if N_in_group.size else 1
        iters = _hyper.tail_iterations(
            n, int(min(k_max, max(1, neighborhood_size.max(initial=1)))))
        self._hypergeom_engine_used = "loop-dense-staged"
        self.pvalues_pos, nes = _hyper.hypergeom_sf_and_nes(
            counts, n, N_in_group[None, :], neighborhood_size[:, None],
            iterations=iters)

        if self.multiple_testing:
            if self.verbose:
                logging.info("Running FDR-adjustment of p-values...")
            self.pvalues_pos = np.asarray(_fdr.fdr_bh(self.pvalues_pos))
            with np.errstate(divide="ignore"):
                self.nes = -np.log10(self.pvalues_pos)
        else:
            # full-precision NES straight from the log-space tail sum
            self.nes = nes

    def _dense_table_kwargs(self, K_np, M, num_other,
                            budget_cells=3 * 10 ** 8):
        """kwargs routing the dense fused pipeline onto the class-table
        survival engine (ops/hypergeom_table.py), or {} for the f64 tail
        loop. In-jit eligibility: binary annotations and a within-budget
        table whose row axis covers every possible neighborhood size
        (n <= M), so the pipeline stays a single dispatch."""
        if self.hypergeom_engine not in ("auto", "table") or num_other != 0:
            return {}
        from safepy_tpu.ops import hypergeom_table as htab
        k_dist, colc = np.unique(np.asarray(K_np, np.float64),
                                 return_inverse=True)
        r, s_max = htab.table_geometry(k_dist, M, M)
        c = 1
        while c < max(1, len(k_dist)):
            c *= 2
        if s_max * c * r > budget_cells:
            return {}
        k_pad = np.zeros(c, np.float64)
        k_pad[:len(k_dist)] = k_dist
        return dict(table_K_dist=jnp.asarray(k_pad),
                    table_colc=jnp.asarray(colc, jnp.int32),
                    table_spec=(r, s_max, c))

    def _hypergeom_bandstore(self, bm, n2a):
        """Staged hypergeometric enrichment over band-stored neighborhoods
        (ops/enrich_band.py): census + survival tail against the skewed band,
        row results un-permuted on device. The class-table engine
        (ops/hypergeom_table.py) serves binary annotations; the per-cell f64
        tail loop is the fallback."""
        from safepy_tpu.ops.enrich_band import hypergeom_core_band_jit

        order = np.argsort(bm.rank)  # permuted position -> original node

        table_out = None
        if self.hypergeom_engine in ("auto", "table"):
            from safepy_tpu.ops.enrich_band import hypergeom_band_table
            # guard BEFORE the operand prep (see _run_pipeline_bandstore)
            self._band_go_hbm_guard(bm.n, bm.band, n2a.shape[1])
            nan0_d, nnn_d, K_d, binary_ok, M = \
                self._band_hyper_operands_cached(order)
            if binary_ok:
                sel = {}
                table_out = hypergeom_band_table(
                    bm.data, nan0_d, nnn_d, M,
                    np.float64(self.enrichment_threshold), bt=bm.bt,
                    block=bm.block, rank_np=bm.rank,
                    precision=self.matmul_precision,
                    logsf_out=self.logsf_store, lookup_group="auto",
                    budget=self.hbm_budget_bytes,
                    extra_resident_bytes=self._kept_band_bytes(),
                    select_out=sel, K_np=np.asarray(K_d))
                self._record_census_select(sel)
        if table_out is not None:
            self._hypergeom_engine_used = "table-band-staged"
            log_sf32, nes_binary8, counts = table_out
            return self._store_hypergeom_results(None, log_sf32, nes_binary8,
                                                 counts)
        if self.hypergeom_engine == "table":
            raise ValueError(
                "hypergeom_engine='table' requires binary 0/1 annotations "
                "with an in-budget class table")

        nan0_perm, nnn_perm, K = self._hypergeom_host_operands(n2a, order)
        M = int(nnn_perm.sum())
        k_max = int(max(1, K.max())) if K.size else 1
        iters = _hyper.tail_iterations(M, min(k_max, M))
        lgt = jnp.asarray(_hyper.lgamma_table(M))
        rank_dev = jnp.asarray(bm.rank, jnp.int32)

        attr_chunk = self._hypergeom_attr_chunk(bm.n, n2a.shape[1])
        self._hypergeom_engine_used = ("hostchunks-band-staged"
                                       if attr_chunk is not None
                                       else "loop-band-staged")
        if attr_chunk is not None:
            from safepy_tpu.ops.enrich_band import hypergeom_band_hostchunks
            log_sf32, nes_binary8, counts = hypergeom_band_hostchunks(
                bm.data, nan0_perm, nnn_perm, lgt, M,
                np.float64(self.enrichment_threshold), bt=bm.bt,
                block=bm.block, rank_np=bm.rank, attr_chunk=attr_chunk)
        else:
            log_sf32, nes_binary8 = hypergeom_core_band_jit(
                bm.data, jnp.asarray(nan0_perm), jnp.asarray(nnn_perm),
                jnp.asarray(K), lgt, M,
                np.float64(self.enrichment_threshold),
                iterations=iters, bt=bm.bt, block=bm.block, rank=rank_dev)
            counts = np.asarray(jnp.sum(nes_binary8, axis=0, dtype=jnp.int32))
        self._store_hypergeom_results(None, log_sf32, nes_binary8, counts)

    def _release_device_results(self):
        """Drop the PREVIOUS run's device-resident matrices before computing
        new ones. At band-storage scale the stale band (GBs) and the stale
        (N, A) result triple would otherwise stay alive until reassignment at
        the END of the new run, doubling the peak of a steady rerun."""
        self._neighborhoods_dev = self._node_distances_dev = None
        self._neighborhoods_np = self._node_distances_np = None
        self._nes_dev = self._logsf_dev = self._nes_binary_dev = None
        self._nes_from_logsf = False
        self._logsf_np = None
        self._nes_binary_pending = None
        self._nes_binary_i8_np = None
        self._nes_binary_csc = None
        self._domains_inter_cache = None

    def _store_hypergeom_results(self, nes32, log_sf32, nes_binary8, counts):
        """Shared hypergeometric result storage: FDR adjustment when asked,
        lazy device-resident NES/log-sf/indicator otherwise. ``nes32=None``
        (the band engines: a second resident (N, A) f32 buffer would double
        the output footprint) defers NES to the first access —
        see :meth:`_nes_device`.

        FDR (reference safe.py:599-605) runs ON DEVICE in log space
        (ops/fdr.fdr_bh_logsf: BH is monotone under log, so no exp is ever
        taken): the adjusted log-p
        simply REPLACES the stored log-survival, and every lazy consumer
        (pvalues_pos, NES, indicator columns) derives from it unchanged.
        The former host path downloaded + exp'd the full (N, A) f64 matrix
        — minutes at 199,680 x 4,373."""
        host_mode = isinstance(log_sf32, np.ndarray)
        if self.multiple_testing:
            if self.verbose:
                logging.info("Running FDR-adjustment of p-values...")
            if host_mode:  # logsf_out='host': the matrix stays off-chip
                log_sf32, nes_binary8, counts = _fdr.fdr_bh_logsf_np(
                    log_sf32, np.log(self.enrichment_threshold))
            else:
                log_sf32, nes_binary8, counts = _fdr.fdr_bh_logsf(
                    log_sf32, np.log(self.enrichment_threshold),
                    row_chunk=self._fdr_row_chunk(log_sf32.shape))
            nes32 = None  # NES re-derives from the ADJUSTED log p
        self._pvalues_pos_np = None
        self._nes_np = None
        if host_mode:
            self._logsf_np = log_sf32
            self._logsf_dev = None
            self._nes_dev = None
        else:
            self._logsf_np = None
            self._logsf_dev = log_sf32
            self._nes_dev = nes32
        self._nes_from_logsf = nes32 is None
        self._nes_binary_pending = (nes_binary8, np.asarray(counts))

    @staticmethod
    def _fdr_row_chunk(shape, budget_bytes=2 * 10 ** 9):
        """Row-chunk size keeping one BH dispatch's f64 sort internals
        (~4 copies of the chunk) under ~budget_bytes; None = unchunked."""
        n, a = shape
        if n * a * 8 * 4 <= budget_bytes:
            return None
        return max(128, int(budget_bytes // (a * 8 * 4)) // 128 * 128)

    def _nes_device(self):
        """The device-resident NES matrix, materializing it from the stored
        log-survival when a band hypergeometric engine deferred it
        (NES == -logsf/ln10 elementwise, reference safe.py:602-604; the f64
        division of the f32-rounded logsf is within 1-2 ulp of the engines'
        pre-rounding f64 value). Cached: one dispatch on first access."""
        if (self._nes_dev is None and self._nes_from_logsf
                and self._logsf_dev is not None):
            self._nes_dev = _nes_from_logsf_jit(self._logsf_dev)
        return self._nes_dev

    def _randomization_bandstore(self, bm):
        """Staged permutation null over band-stored neighborhoods: banded
        observed scores, valid-column compaction, banded count scan."""
        from safepy_tpu.ops import apsp_bandstore as _bst
        from safepy_tpu.ops.enrich_band import (band_score_jit,
                                                run_permutations_band)

        n2a = self.node2attribute
        order = np.argsort(bm.rank)
        vals_perm = np.asarray(n2a, np.float32)[order]
        vals_perm_dev = jnp.asarray(vals_perm)

        obs_perm = band_score_jit(bm.data, vals_perm_dev, bt=bm.bt,
                                  block=bm.block,
                                  score_type=self.neighborhood_score_type,
                                  precision=self.matmul_precision)
        rank_dev = jnp.asarray(bm.rank, jnp.int32)
        obs = np.asarray(jnp.take(obs_perm, rank_dev, axis=0))
        self.ns = obs

        valid_perm = np.any(~np.isnan(vals_perm), axis=1)
        V, A = int(valid_perm.sum()), n2a.shape[1]
        starts, w_c = _bst.compaction_plan(valid_perm, n=bm.n, bt=bm.bt,
                                           block=bm.block)
        compact = _bst.apply_compaction(bm.data, jnp.asarray(valid_perm), w_c,
                                        bt=bm.bt, block=bm.block)
        vals_valid = jnp.asarray(vals_perm[valid_perm])
        mask_valid = jnp.isfinite(vals_valid).astype(jnp.float32)
        vv = jnp.where(mask_valid > 0, vals_valid, 0.0)

        seed = self.random_seed
        if seed is None:
            seed = int(np.random.default_rng().integers(2 ** 31 - 1))
        key = jax.random.PRNGKey(seed)
        batch = _perm.default_batch_size(V, A, int(self.num_permutations))
        counts_neg, counts_pos = run_permutations_band(
            compact, jnp.asarray(starts, jnp.int32), vv, mask_valid, obs_perm,
            key, score_type=self.neighborhood_score_type,
            num_permutations=int(self.num_permutations), batch_size=batch,
            bt=bm.bt, block=bm.block, precision=self.matmul_precision)
        counts_neg = jnp.take(counts_neg, rank_dev, axis=0)
        counts_pos = jnp.take(counts_pos, rank_dev, axis=0)
        self._finalize_randomization(counts_neg, counts_pos, obs)

    def _finalize_randomization(self, counts_neg, counts_pos, obs):
        """counts -> p-values -> NES, reference semantics (safe.py:528-554):
        NaN-mask where obs is NaN, optional FDR, p-floor at 1/P, sign select."""
        counts_neg = np.asarray(counts_neg, dtype=np.float64)
        counts_pos = np.asarray(counts_pos, dtype=np.float64)
        idx = np.isnan(obs)
        counts_neg[idx] = np.nan
        counts_pos[idx] = np.nan

        self.pvalues_neg = counts_neg / self.num_permutations
        self.pvalues_pos = counts_pos / self.num_permutations

        if self.multiple_testing:
            logging.info("Running FDR-adjustment of p-values...")
            self.pvalues_neg = np.asarray(_fdr.fdr_bh(self.pvalues_neg))
            self.pvalues_pos = np.asarray(_fdr.fdr_bh(self.pvalues_pos))

        # p = 0 floored to 1/num_permutations before the log (safe.py:545-547)
        nes_pos = -np.log10(np.where(self.pvalues_pos == 0,
                                     1 / self.num_permutations, self.pvalues_pos))
        nes_neg = -np.log10(np.where(self.pvalues_neg == 0,
                                     1 / self.num_permutations, self.pvalues_neg))

        if self.attribute_sign == "highest":
            self.nes = nes_pos
        elif self.attribute_sign == "lowest":
            self.nes = nes_neg
        else:
            self.nes = nes_pos - nes_neg

    def _update_binary_enrichment(self, nes_binary_dev=None, enriched_counts=None):
        """nes_binary + per-attribute enriched counts (safe.py:468-472).

        The device paths hand over the int8 indicator WITHOUT downloading it
        (lazy, like nes) plus the (A,) counts reduced on device — the (N, A)
        indicator only crosses to the host if something actually reads it.
        """
        if nes_binary_dev is None and self._nes_binary_pending is not None:
            nes_binary_dev, enriched_counts = self._nes_binary_pending
            self._nes_binary_pending = None
        if nes_binary_dev is not None:
            if isinstance(nes_binary_dev, np.ndarray):
                # host-streamed indicator (logsf_out='host'): already the
                # compact int8 form every downstream consumer reads
                self._nes_binary_dev = None
                self._nes_binary_i8_np = nes_binary_dev
            else:
                self._nes_binary_dev = nes_binary_dev
                self._nes_binary_i8_np = None
            self._nes_binary_np = None
            self._nes_binary_csc = None
            self._enrichment_serial += 1
        else:
            idx = ~np.isnan(self.nes)
            nes_binary = np.zeros(self.nes.shape)
            nes_binary[idx] = (np.abs(self.nes[idx])
                               > -np.log10(self.enrichment_threshold))
            self.nes_binary = nes_binary
        if enriched_counts is None:
            enriched_counts = np.sum(self.nes_binary, axis=0)
        self.attributes["num_neighborhoods_enriched"] = np.asarray(enriched_counts)

    def compute_pvalues_by_randomization(self, **kwargs):
        """Two-sided empirical permutation null (reference: safe.py:474-554).

        The reference's multiprocessing pool becomes a batched on-device GEMM
        stream; the `processes` kwarg is accepted for API compatibility but the
        batching is automatic.
        """
        if kwargs:
            logging.warning("Current settings (possibly overwriting global ones):")
            for k in kwargs:
                logging.warning("\t%s=%s" % (k, str(kwargs[k])))

        logging.info("Using randomization to calculate enrichment...")

        if "num_permutations" in kwargs:
            self.num_permutations = kwargs["num_permutations"]
        if "processes" in kwargs and int(kwargs["processes"]) > 1:
            logging.info("processes=%s requested: the device engine batches "
                         "permutations on device; ignoring." % kwargs["processes"])

        self.validate_config()

        if isinstance(self._neighborhoods_dev, _BandedMatrix):
            return self._randomization_bandstore(self._neighborhoods_dev)

        n2a = self.node2attribute
        n2a_dev = self._node2attribute_device()
        nbr_dev = self._neighborhoods_device()
        obs_dev = _score.compute_neighborhood_score(
            nbr_dev, n2a_dev, self.neighborhood_score_type,
            self.matmul_precision)
        obs = np.asarray(obs_dev)
        self.ns = obs

        valid_rows = np.flatnonzero(np.sum(~np.isnan(n2a), axis=1))
        if len(valid_rows) == n2a.shape[0]:
            valid_rows = None  # every row valid: skip the (N, V) column gather

        seed = self.random_seed
        if seed is None:
            seed = int(np.random.default_rng().integers(2 ** 31 - 1))
        key = jax.random.PRNGKey(seed)

        if self.mesh is not None and "perm" in self.mesh.shape:
            from safepy_tpu.parallel import run_permutations_sharded
            counts_neg, counts_pos, total = run_permutations_sharded(
                nbr_dev, n2a_dev, valid_rows, obs_dev, key, mesh=self.mesh,
                score_type=self.neighborhood_score_type,
                num_permutations=int(self.num_permutations))
            # rounded up to a multiple of the mesh axis, like the reference
            # rounds to its worker count (safe.py:503-504)
            self.num_permutations = total
        else:
            counts_neg, counts_pos = _perm.run_permutations(
                nbr_dev, n2a_dev, valid_rows, obs_dev, key,
                score_type=self.neighborhood_score_type,
                num_permutations=int(self.num_permutations),
                precision=self.matmul_precision)
        self._finalize_randomization(counts_neg, counts_pos, obs)

    # ------------------------------------------------------------- fused pipeline

    def run_pipeline(self, **kwargs):
        """Neighborhoods + enrichment in ONE device dispatch.

        Equivalent to ``define_neighborhoods(); compute_pvalues(**kwargs)`` but
        fused into a single compiled program — one dispatch instead of one
        per stage (see safepy_tpu/pipeline.py). Falls back to the stage methods for the
        euclidean metric or non-default backgrounds.
        """
        from safepy_tpu import pipeline as _pipe

        for k in ("node_distance_metric", "neighborhood_radius_type",
                  "neighborhood_radius"):
            if k in kwargs:
                setattr(self, k, kwargs.pop(k))
        if "how" in kwargs:
            self.enrichment_type = kwargs.pop("how")
        if "neighborhood_score_type" in kwargs:
            self.neighborhood_score_type = kwargs.pop("neighborhood_score_type")
        if "multiple_testing" in kwargs:
            self.multiple_testing = kwargs.pop("multiple_testing")
        if "num_permutations" in kwargs:
            self.num_permutations = kwargs.pop("num_permutations")
        if "background" in kwargs:
            self.background = kwargs.pop("background")
        self.validate_config()

        mesh_shape0 = {} if self.mesh is None else self.mesh.shape
        data_mesh_1d = "data" in mesh_shape0 and len(mesh_shape0) == 1
        if (self.node_distance_metric == "euclidean"
                or self.background == "network"):
            if (self.node_distance_metric == "euclidean"
                    and self.background != "network"
                    and (self.mesh is None or data_mesh_1d)):
                n2a = self.node2attribute
                num_other = self._num_other_values()
                binary = (self.enrichment_type == "hypergeometric"
                          or (self.enrichment_type == "auto"
                              and num_other == 0))
                if not binary:
                    coords = self._graph_to_arrays_cached()[0]
                    num_nodes = self.graph.number_of_nodes()
                    x = coords[:, 0]
                    nr = self.neighborhood_radius * (np.max(x) - np.min(x))
                    eb = self._euclidean_band_plan(coords, num_nodes, nr)
                    if eb is not None:
                        return self._run_pipeline_band_euclid(eb, coords, nr)
            self.define_neighborhoods()
            self.compute_pvalues()
            return

        num_nodes = self.graph.number_of_nodes()
        coords, edges, lengths, edge_weights = self._graph_to_arrays_cached()
        if self.node_distance_metric == "shortpath_weighted_layout":
            x = coords[:, 0]
            nr = self.neighborhood_radius * (np.max(x) - np.min(x))
            if lengths is None:
                # same guard as the staged path: a user-supplied graph that never
                # went through calculate_edge_lengths must not silently fall back
                # to unit weights (hop counts against a layout-scale radius)
                raise ValueError(
                    "shortpath_weighted_layout requires edge 'length' attributes "
                    "(computed by calculate_edge_lengths at network load)")
            weights = lengths
        else:
            nr = self.neighborhood_radius
            weights = edge_weights
        mesh_shape = {} if self.mesh is None else self.mesh.shape
        on_data_mesh = ("data" in mesh_shape
                        or ("row" in mesh_shape and "col" in mesh_shape))
        band_mesh_ok = self.mesh is None or (
            "data" in mesh_shape and len(mesh_shape) == 1)
        bs_plan = self._band_storage_plan(
            coords, edges, weights, num_nodes, nr) if band_mesh_ok else None
        if bs_plan is not None:
            return self._run_pipeline_bandstore(bs_plan, nr)
        plan = None if on_data_mesh else self._banded_plan(
            coords, edges, weights, num_nodes, nr)
        if plan is not None:
            d0, inv_rank, window = plan
        else:
            inv_rank, window = None, None
            d0 = self._d0_cache.get(self.node_distance_metric)
            if d0 is None:
                d0 = _nbr.initial_distances_device(num_nodes, edges, weights)
                self._d0_cache[self.node_distance_metric] = d0
        radius = _nbr.inclusive_radius(nr)

        n2a = self.node2attribute
        num_other = self._num_other_values()
        binary = (self.enrichment_type == "hypergeometric"
                  or (self.enrichment_type == "auto" and num_other == 0))

        if binary:
            nodes_not_nan = np.any(~np.isnan(n2a), axis=1)
            M = int(nodes_not_nan.sum())
            K_np = np.nansum(n2a, axis=0, dtype=np.float64)
            k_max = int(max(1, np.nanmax(K_np))) if K_np.size else 1
            iters = _hyper.tail_iterations(M, min(k_max, M))
            lgt = jnp.asarray(_hyper.lgamma_table(M))
            table_kw = self._dense_table_kwargs(K_np, M, num_other)
            self._hypergeom_engine_used = ("table-dense-fused" if table_kw
                                           else "loop-dense-fused")
            (dist, nbr, nes32, log_sf32, nesbin8, counts_dev, mean, std) = \
                _pipe.fused_hypergeom_pipeline(
                    d0, self._node2attribute_device(), lgt, M, radius,
                    np.float64(self.enrichment_threshold), iterations=iters,
                    mesh=self.mesh, window=window, inv_rank=inv_rank,
                    impl=self.minplus_impl, **table_kw)
            # p-values, NES, and the indicator materialize lazily from the
            # device arrays (significance decided on device in f64 BEFORE the
            # f32 rounding); only the (A,) counts cross to the host. FDR runs
            # on device in log space inside the store.
            self._store_hypergeom_results(nes32, log_sf32, nesbin8,
                                          counts_dev)
        else:
            valid_rows = np.flatnonzero(np.sum(~np.isnan(n2a), axis=1))
            V, A = len(valid_rows), n2a.shape[1]
            if V == n2a.shape[0]:
                valid_rows = None  # every row valid: skip the column gather
            seed = self.random_seed
            if seed is None:
                seed = int(np.random.default_rng().integers(2 ** 31 - 1))
            key = jax.random.PRNGKey(seed)
            per_device = int(self.num_permutations)
            if self.mesh is not None:
                # batch rounds up to a device multiple, like the reference's
                # worker-count rounding (safe.py:503-504)
                ndev = int(np.prod([self.mesh.shape[a]
                                    for a in self.mesh.axis_names]))
                per_device = -(-per_device // ndev)
                self.num_permutations = per_device * ndev
            batch = _perm.default_batch_size(V, A, per_device)
            (dist, nbr, obs, counts_neg, counts_pos, mean, std) = \
                _pipe.fused_permutation_pipeline(
                    d0, self._node2attribute_device(),
                    None if valid_rows is None
                    else jnp.asarray(valid_rows, jnp.int32), key, radius,
                    score_type=self.neighborhood_score_type,
                    num_permutations=per_device,
                    batch_size=batch, precision=self.matmul_precision,
                    mesh=self.mesh, window=window, inv_rank=inv_rank,
                    impl=self.minplus_impl)
            obs = np.asarray(obs)
            self.ns = obs
            self._finalize_randomization(counts_neg, counts_pos, obs)

        self._neighborhoods_dev = nbr
        self._neighborhoods_np = None
        self._node_distances_dev = dist
        self._node_distances_np = None

        if self.verbose:
            logging.info("Node distance metric: %s" % self.node_distance_metric)
            logging.info("Neighborhood definition: %.2f x %s"
                         % (self.neighborhood_radius, self.neighborhood_radius_type))
            logging.info("Number of nodes per neighborhood (mean +/- std): "
                         "%.2f +/- %.2f" % (float(mean), float(std)))

        self._update_binary_enrichment()

    def _run_pipeline_band_euclid(self, plan, coords, nr):
        """run_pipeline for the euclidean metric at band-storage scale: banded
        direct coordinate distances + permutation null, ONE fused dispatch
        (the scatter/UMAP flagship; no graph algorithm at all)."""
        from safepy_tpu import pipeline as _pipe
        from safepy_tpu.ops import apsp_bandstore as _bst

        self._release_device_results()

        num_nodes = self.graph.number_of_nodes()
        rank, band = plan["rank"], plan["band"]
        order = np.argsort(rank)
        bt = band // 128 + 1

        n2a = self.node2attribute
        vals_perm = np.asarray(n2a, np.float32)[order]
        valid_perm = np.any(~np.isnan(vals_perm), axis=1)
        V, A = int(valid_perm.sum()), n2a.shape[1]
        starts, w_c = _bst.compaction_plan(valid_perm, n=num_nodes, bt=bt,
                                           block=128)
        seed = self.random_seed
        if seed is None:
            seed = int(np.random.default_rng().integers(2 ** 31 - 1))
        key = jax.random.PRNGKey(seed)
        batch = _perm.default_batch_size(V, A, int(self.num_permutations))

        euclid_args = (jnp.asarray(coords[order], jnp.float32),
                       jnp.asarray(vals_perm),
                       jnp.asarray(vals_perm[valid_perm]),
                       jnp.asarray(valid_perm), jnp.asarray(starts, jnp.int32),
                       jnp.asarray(rank, jnp.int32), key, np.float32(nr))
        euclid_kw = dict(n=num_nodes, band=band,
                         score_type=self.neighborhood_score_type,
                         num_permutations=int(self.num_permutations),
                         batch_size=batch, w_c=w_c,
                         precision=self.matmul_precision)
        if self.mesh is not None:
            # row-sharded euclidean band pipeline over the 'data' axis —
            # the scatter/UMAP workflow's multi-chip path
            from safepy_tpu.parallel.band_sharded import (
                fused_permutation_pipeline_band_euclid_sharded)
            keep = bool(self.keep_node_distances)
            (dist_band, s_ind, obs_dev, counts_neg, counts_pos, mean, std) = \
                fused_permutation_pipeline_band_euclid_sharded(
                    *euclid_args, mesh=self.mesh, keep_distances=keep,
                    packed=(not keep
                            and self._band_bits_selected(num_nodes, band)),
                    **euclid_kw)
        else:
            keep = bool(self.keep_node_distances)
            (dist_band, s_ind, obs_dev, counts_neg, counts_pos, mean, std) = \
                _pipe.fused_permutation_pipeline_band_euclid(
                    *euclid_args, keep_distances=keep,
                    packed=(not keep
                            and self._band_bits_selected(num_nodes, band)),
                    **euclid_kw)
        obs = np.asarray(obs_dev)
        self.ns = obs
        self._finalize_randomization(counts_neg, counts_pos, obs)

        g_rows = (-(-num_nodes // 128) + 2 * bt) * 128
        if s_ind.shape[0] != g_rows:  # sharded outputs carry extra pad rows
            s_ind = s_ind[:g_rows]
            if dist_band.shape[0]:
                dist_band = dist_band[:g_rows]
        self._neighborhoods_dev = _BandedMatrix(s_ind, rank, num_nodes, band,
                                                fill=0.0)
        self._neighborhoods_np = None
        self._node_distances_dev = (
            _BandedMatrix(dist_band, rank, num_nodes, band, fill=np.inf)
            if dist_band.shape[0] else None)  # keep_node_distances=False
        self._node_distances_np = None

        if self.verbose:
            logging.info("Node distance metric: %s (band storage)"
                         % self.node_distance_metric)
            logging.info("Number of nodes per neighborhood (mean +/- std): "
                         "%.2f +/- %.2f" % (float(mean), float(std)))
        self._update_binary_enrichment()

    def _run_pipeline_bandstore(self, plan, nr):
        """run_pipeline over the band-STORAGE engine: one fused dispatch, all
        matrices O(N*W) (see ops/apsp_bandstore.py, ops/enrich_band.py)."""
        from safepy_tpu import pipeline as _pipe
        from safepy_tpu.ops import apsp_bandstore as _bst

        self._release_device_results()

        num_nodes = self.graph.number_of_nodes()
        radius = _nbr.inclusive_radius(nr)
        band, rank, rank_dev = plan["band"], plan["rank"], plan["rank_dev"]
        order = np.argsort(rank)  # permuted position -> original node

        n2a = self.node2attribute
        num_other = self._num_other_values()
        binary = (self.enrichment_type == "hypergeometric"
                  or (self.enrichment_type == "auto" and num_other == 0))

        if binary:
            table_out = band_done = None
            nan0_perm = nnn_perm = K = M = None
            shard_group = 8
            if self.hypergeom_engine in ("auto", "table"):
                # HBM guard BEFORE the operand prep — not just before the FW
                # front: the prep itself materializes (N, A)-sized device
                # buffers, and an over-budget point must refuse cleanly
                # instead of OOMing inside the prep
                if self.mesh is None:
                    self._band_go_hbm_guard(num_nodes, band, n2a.shape[1])
                else:
                    splan = self._band_go_shard_guard(
                        num_nodes, band, n2a.shape[1])
                    shard_group = splan.get("lookup_group") or 8
                # class-table survival engine (binary annotations): device-
                # built int8 operands, cached across runs (the host
                # equivalents cost minutes per run at GO scale in this
                # runtime's degraded host memory path)
                nan0_perm, nnn_perm, K, binary_ok, M = \
                    self._band_hyper_operands_cached(order)
                _hbm.record_peak("prep")
                if not binary_ok:
                    # forced hypergeometric on non-0/1 values: the table's
                    # integer-count precondition fails; use the f64 loop
                    nan0_perm = nnn_perm = K = M = None
                if nan0_perm is not None and self.mesh is None:
                    from safepy_tpu.ops.enrich_band import (
                        hypergeom_band_table)
                    band_done = self._band_front_dispatch(
                        plan, radius, num_nodes)
                    dist_band, s_ind, mean, std = band_done
                    _hbm.record_peak("relax")
                    sel = {}
                    table_out = hypergeom_band_table(
                        s_ind, nan0_perm, nnn_perm, M,
                        np.float64(self.enrichment_threshold),
                        bt=band // 128 + 1, rank_np=rank,
                        precision=self.matmul_precision,
                        logsf_out=self.logsf_store, lookup_group="auto",
                        budget=self.hbm_budget_bytes,
                        extra_resident_bytes=(int(dist_band.nbytes)
                                              if dist_band.shape[0] else 0),
                        select_out=sel, K_np=np.asarray(K))
                    self._record_census_select(sel)
                    _hbm.record_peak("census")
            if table_out is None and self.mesh is None:
                # fallback engines take host operands (their column chunking
                # and iteration bounds are host-driven)
                nan0_perm, nnn_perm, K = self._hypergeom_host_operands(
                    n2a, order)
                M = int(nnn_perm.sum())
            if K is not None:
                K_host = np.asarray(K)
                k_max = int(max(1, K_host.max())) if K_host.size else 1
                iters = _hyper.tail_iterations(M, min(k_max, M))
            attr_chunk = self._hypergeom_attr_chunk(num_nodes, n2a.shape[1])
            if table_out is not None:
                self._hypergeom_engine_used = "table-band"
                nes32 = None  # deferred: see _nes_device()
                log_sf32, nesbin8, counts_dev = table_out
            elif self.mesh is None and attr_chunk is not None:
                self._hypergeom_engine_used = "hostchunks-band"
                lgt = jnp.asarray(_hyper.lgamma_table(M))
                # host-driven K-sorted chunk dispatches: the emulated-f64
                # survival tail dominates at this scale, and one fused
                # dispatch would run long enough to trip the worker watchdog
                from safepy_tpu.ops.enrich_band import (
                    hypergeom_band_hostchunks)
                if band_done is None:
                    band_done = self._band_front_dispatch(
                        plan, radius, num_nodes)
                dist_band, s_ind, mean, std = band_done
                nes32 = None  # deferred: see _nes_device()
                log_sf32, nesbin8, counts_dev = \
                    hypergeom_band_hostchunks(
                        s_ind, nan0_perm, nnn_perm, lgt, M,
                        np.float64(self.enrichment_threshold),
                        bt=band // 128 + 1, rank_np=rank,
                        attr_chunk=attr_chunk)
            elif self.mesh is not None:
                table_out = None
                if nan0_perm is not None and self.hypergeom_engine in (
                        "auto", "table"):
                    # sharded class-table engine: sharded band FW front, then
                    # one short sharded census+table+lookup dispatch per
                    # column chunk — no per-device program runs near
                    # remote-watchdog horizons even at GO scale
                    from safepy_tpu.parallel.band_sharded import (
                        band_neighborhoods_sharded,
                        hypergeom_band_table_sharded)
                    # per-shard HBM plan already asserted pre-prep by
                    # _band_go_shard_guard (facade-native mesh_band_go plan)
                    (dist_band, s_ind, _sizes, mean, std) = \
                        band_neighborhoods_sharded(
                            plan["u"], plan["v"], plan["w"], radius,
                            mesh=self.mesh, n=num_nodes, band=band,
                            packed=self._band_bits_selected(num_nodes, band),
                            impl=self.minplus_impl)
                    table_out = hypergeom_band_table_sharded(
                        s_ind, nan0_perm, nnn_perm, M,
                        np.float64(self.enrichment_threshold),
                        mesh=self.mesh, n=num_nodes, band=band,
                        rank_np=rank, precision=self.matmul_precision,
                        K_np=np.asarray(K), lookup_group=shard_group)
                if table_out is not None:
                    self._hypergeom_engine_used = "table-band-sharded"
                    nes32 = None  # deferred: see _nes_device()
                    log_sf32, nesbin8, counts_dev = table_out
                else:
                    self._hypergeom_engine_used = "loop-band-sharded"
                    if nan0_perm is None:  # engine='loop': no operands yet
                        nan0_perm, nnn_perm, K = \
                            self._hypergeom_host_operands(n2a, order)
                        M = int(nnn_perm.sum())
                        k_max = int(max(1, K.max())) if K.size else 1
                        iters = _hyper.tail_iterations(M, min(k_max, M))
                    from safepy_tpu.parallel.band_sharded import (
                        fused_hypergeom_pipeline_band_sharded)
                    lgt = jnp.asarray(_hyper.lgamma_table(M))
                    nes32 = None  # deferred: see _nes_device()
                    (dist_band, s_ind, log_sf32, nesbin8, counts_dev,
                     mean, std) = fused_hypergeom_pipeline_band_sharded(
                        plan["u"], plan["v"], plan["w"],
                        jnp.asarray(nan0_perm), jnp.asarray(nnn_perm),
                        jnp.asarray(K), lgt, M, radius,
                        np.float64(self.enrichment_threshold), rank_dev,
                        mesh=self.mesh, n=num_nodes, band=band,
                        iterations=iters, impl=self.minplus_impl)
            else:
                self._hypergeom_engine_used = "loop-band"
                lgt = jnp.asarray(_hyper.lgamma_table(M))
                hb_args = (plan["u"], plan["v"], plan["w"],
                           jnp.asarray(nan0_perm), jnp.asarray(nnn_perm),
                           jnp.asarray(K), lgt, M, radius,
                           np.float64(self.enrichment_threshold), rank_dev)
                hb_kw = dict(n=num_nodes, band=band, iterations=iters,
                             keep_distances=bool(self.keep_node_distances),
                             packed=self._band_bits_selected(num_nodes, band),
                             impl=self.minplus_impl)
                bf = self._band_bf_args(plan)
                out = _pipe.fused_hypergeom_pipeline_band(
                    *hb_args, **hb_kw, **bf)
                if bf and not bool(np.asarray(out[7])):
                    self._band_relax_used = "bf->fw"
                    logging.info("band BF relax hit its iteration budget; "
                                 "re-dispatching Floyd-Warshall")
                    out = _pipe.fused_hypergeom_pipeline_band(
                        *hb_args, **hb_kw)
                else:
                    self._band_relax_used = "bf" if bf else "fw"
                nes32 = None  # deferred: see _nes_device()
                (dist_band, s_ind, log_sf32, nesbin8, counts_dev, mean,
                 std) = out[:7]
            self._store_hypergeom_results(nes32, log_sf32, nesbin8,
                                          counts_dev)
        else:
            vals_perm = np.asarray(n2a, np.float32)[order]
            valid_perm = np.any(~np.isnan(vals_perm), axis=1)
            V, A = int(valid_perm.sum()), n2a.shape[1]
            bt = band // 128 + 1
            starts, w_c = _bst.compaction_plan(valid_perm, n=num_nodes, bt=bt,
                                               block=128)
            seed = self.random_seed
            if seed is None:
                seed = int(np.random.default_rng().integers(2 ** 31 - 1))
            key = jax.random.PRNGKey(seed)
            batch = _perm.default_batch_size(V, A, int(self.num_permutations))
            band_args = (plan["u"], plan["v"], plan["w"],
                         jnp.asarray(vals_perm),
                         jnp.asarray(vals_perm[valid_perm]),
                         jnp.asarray(valid_perm),
                         jnp.asarray(starts, jnp.int32), rank_dev, key, radius)
            band_kw = dict(n=num_nodes, band=band,
                           score_type=self.neighborhood_score_type,
                           num_permutations=int(self.num_permutations),
                           batch_size=batch, w_c=w_c,
                           precision=self.matmul_precision,
                           impl=self.minplus_impl)
            if self.mesh is None:
                band_kw["keep_distances"] = bool(self.keep_node_distances)
                band_kw["packed"] = self._band_bits_selected(num_nodes, band)
            if self.mesh is not None:
                from safepy_tpu.parallel.band_sharded import (
                    fused_permutation_pipeline_band_sharded)
                (dist_band, s_ind, obs_dev, counts_neg, counts_pos, mean,
                 std) = fused_permutation_pipeline_band_sharded(
                    *band_args, mesh=self.mesh,
                    keep_distances=bool(self.keep_node_distances),
                    packed=self._band_bits_selected(num_nodes, band),
                    **band_kw)
                self._band_relax_used = "fw"  # sharded engine relaxes via FW
            else:
                bf = self._band_bf_args(plan)
                if not bf and self._band_split_selected(num_nodes, band):
                    # giant-band regime: init -> donated relax -> tail
                    # dispatches hold ONE band instead of the fused
                    # program's double-buffered two (band_relax_threshold)
                    self._band_relax_used = "fw"
                    s = _pipe.band_init(plan["u"], plan["v"], plan["w"],
                                        n=num_nodes, band=band)
                    dist_band, s_ind, mean, std = _pipe.band_relax_threshold(
                        s, band_args[9], n=num_nodes, bt=band // 128 + 1,
                        packed=band_kw["packed"], impl=self.minplus_impl)
                    del s  # donated; aliased by dist_band
                    if not self.keep_node_distances:
                        # free the f32 band BEFORE the tail dispatch
                        dist_band = jnp.zeros((0, 1), jnp.float32)
                    obs_dev, counts_neg, counts_pos = _pipe.band_perm_tail(
                        s_ind, *band_args[3:9], bt=band // 128 + 1,
                        score_type=self.neighborhood_score_type,
                        num_permutations=int(self.num_permutations),
                        batch_size=batch, w_c=w_c,
                        precision=self.matmul_precision)
                else:
                    out = _pipe.fused_permutation_pipeline_band(
                        *band_args, **band_kw, **bf)
                    if bf and not bool(np.asarray(out[7])):
                        self._band_relax_used = "bf->fw"
                        logging.info("band BF relax hit its iteration "
                                     "budget; re-dispatching Floyd-Warshall")
                        out = _pipe.fused_permutation_pipeline_band(
                            *band_args, **band_kw)
                    else:
                        self._band_relax_used = "bf" if bf else "fw"
                    (dist_band, s_ind, obs_dev, counts_neg, counts_pos, mean,
                     std) = out[:7]
            obs = np.asarray(obs_dev)
            self.ns = obs
            self._finalize_randomization(counts_neg, counts_pos, obs)

        bt = band // 128 + 1
        g_rows = (-(-num_nodes // 128) + 2 * bt) * 128
        if s_ind.shape[0] != g_rows:  # sharded outputs carry extra pad rows
            s_ind = s_ind[:g_rows]
            if dist_band.shape[0]:
                dist_band = dist_band[:g_rows]
        self._neighborhoods_dev = _BandedMatrix(s_ind, rank, num_nodes, band,
                                                fill=0.0)
        self._neighborhoods_np = None
        self._node_distances_dev = (
            _BandedMatrix(dist_band, rank, num_nodes, band, fill=np.inf)
            if dist_band.shape[0] else None)  # keep_node_distances=False
        self._node_distances_np = None

        if self.verbose:
            logging.info("Node distance metric: %s (band storage)"
                         % self.node_distance_metric)
            logging.info("Neighborhood definition: %.2f x %s"
                         % (self.neighborhood_radius,
                            self.neighborhood_radius_type))
            logging.info("Number of nodes per neighborhood (mean +/- std): "
                         "%.2f +/- %.2f" % (float(mean), float(std)))

        self._update_binary_enrichment()

    # -------------------------------------------------------------------- domains

    def _nes_binary_small(self):
        """The binary indicator without the public property's f64
        materialization (reference dtype, safe.py:469 — but 3.5 GB of host
        writes at the 99,840 x 4,373 band scale). Domain/report consumers
        only compare and sum, so the int8 download suffices."""
        if self._nes_binary_np is not None:
            return self._nes_binary_np
        if self._nes_binary_pending is not None:
            self._update_binary_enrichment()
        if self._nes_binary_dev is not None and self._nes_binary_i8_np is None:
            # one int8 host download (437 MB at GO band scale), shared
            # by the domain, report, and plotting consumers
            self._nes_binary_i8_np = np.asarray(self._nes_binary_dev)
        if self._nes_binary_i8_np is not None:
            return self._nes_binary_i8_np
        return self.nes_binary

    def _nes_column(self, j):
        """ONE NES column in f64 without materializing the (N, A) host
        matrix: the f64 property download + conversion costs minutes at the
        99,840 x 4,373 band scale, while a single device-sliced column ships
        N floats to the host. Per-attribute plot panels
        (plotting.plot_sample_attributes) read through this."""
        if self._nes_np is not None:
            return np.asarray(self._nes_np[:, j], dtype=np.float64)
        if self._nes_from_logsf and self._logsf_np is not None:
            # host-streamed log-survival: column math on host, same
            # f64-divide + f32-round contract as the device branches
            col = self._logsf_np[:, j].astype(np.float64)
            return (-col / np.log(10.0)).astype(np.float32).astype(np.float64)
        if self._nes_dev is None and self._nes_from_logsf \
                and self._logsf_dev is not None:
            # deferred-NES band engines: one logsf column, derived host-side
            # with the SAME f64-divide + f32-round as _nes_device() so the
            # column and full-matrix paths agree bitwise
            j = int(j)
            if not 0 <= j < self._logsf_dev.shape[1]:
                raise IndexError(f"attribute index {j} out of range "
                                 f"[0, {self._logsf_dev.shape[1]})")
            col = np.asarray(_take_column(self._logsf_dev, j),
                             dtype=np.float64)
            return (-col / np.log(10.0)).astype(np.float32).astype(np.float64)
        if self._nes_dev is not None:
            j = int(j)
            if not 0 <= j < self._nes_dev.shape[1]:
                # dynamic_slice CLAMPS; match the host branch's IndexError
                raise IndexError(f"attribute index {j} out of range "
                                 f"[0, {self._nes_dev.shape[1]})")
            return np.asarray(_take_column(self._nes_dev, j),
                              dtype=np.float64)
        return np.asarray(self.nes[:, j], dtype=np.float64)

    def _nes_binary_column(self, j):
        """One significance-indicator column; device-sliced like
        :meth:`_nes_column` (the dense int8 indicator download is 437 MB at
        GO band scale)."""
        if self._nes_binary_np is not None:
            return np.asarray(self._nes_binary_np[:, j])
        if self._nes_binary_i8_np is not None:
            return np.asarray(self._nes_binary_i8_np[:, j])
        if self._nes_binary_pending is not None:
            self._update_binary_enrichment()
        if self._nes_binary_dev is not None:
            j = int(j)
            if not 0 <= j < self._nes_binary_dev.shape[1]:
                raise IndexError(f"attribute index {j} out of range "
                                 f"[0, {self._nes_binary_dev.shape[1]})")
            return np.asarray(_take_column(self._nes_binary_dev, j))
        return np.asarray(self.nes_binary[:, j])

    def _nes_binary_for_top(self):
        """Indicator view for define_top_attributes: when the indicator is
        device-resident and large, hand over a sparse CSC built from a
        nonzero-index download (~6 MB vs a 437 MB dense int8 transfer
        at GO band scale, ops/domains_device.indicator_csc)."""
        if self._nes_binary_pending is not None:
            self._update_binary_enrichment()
        if (self._nes_binary_np is None and self._nes_binary_i8_np is None
                and self._nes_binary_dev is not None
                and "num_neighborhoods_enriched" in self.attributes):
            if self._nes_binary_csc is not None:
                return self._nes_binary_csc
            n, a = self._nes_binary_dev.shape
            counts = np.asarray(
                self.attributes["num_neighborhoods_enriched"], np.int64)
            nnz = int(counts.sum())
            if (n * a > 3e7 and 4 * nnz < n * a
                    and n * a < np.iinfo(np.int32).max):
                from safepy_tpu.ops import domains_device as _dd
                self._nes_binary_csc = _dd.indicator_csc(
                    self._nes_binary_dev, counts)
                return self._nes_binary_csc
        return self._nes_binary_small()

    def define_top_attributes(self, **kwargs):
        if "attribute_unimodality_metric" in kwargs:
            self.attribute_unimodality_metric = kwargs["attribute_unimodality_metric"]
        if "attribute_enrichment_min_size" in kwargs:
            self.attribute_enrichment_min_size = kwargs["attribute_enrichment_min_size"]
        self.validate_config()
        self.attributes = _domains.define_top_attributes(
            self.attributes, self._nes_binary_for_top(), self.graph,
            self.graph_euclidean,
            unimodality_metric=self.attribute_unimodality_metric,
            min_size=self.attribute_enrichment_min_size, verbose=self.verbose)

    def define_domains(self, **kwargs):
        if "attribute_distance_threshold" in kwargs:
            self.attribute_distance_threshold = kwargs["attribute_distance_threshold"]
        self.validate_config()
        # The intersection-count GEMM (ops/domains_device.py) is independent
        # of the clustering threshold — cache it across re-clusterings, feed
        # it the device-resident indicator when one exists (no (N, A)
        # download), and clear it with the enrichment results.
        if self._domains_inter_cache is None and self._nes_binary_dev is not None:
            from safepy_tpu.ops import domains_device as _dd
            ntop = int(np.sum(self.attributes["top"].values)) \
                if "top" in self.attributes else 0
            if (self.attribute_distance_metric == "jaccard"
                    and ntop >= _domains.CLUSTER_ENGINE_MIN_TOP):
                self._domains_inter_cache = _dd.enrichment_intersections(
                    self._nes_binary_dev)
        # lazy host accessors: the gemm path works on the device copies and
        # must not pay the (N, A) host download + f64 host conversion
        self.attributes, self.node2domain = _domains.define_domains(
            self.attributes, (lambda: self.nes), self._nes_binary_small,
            distance_metric=self.attribute_distance_metric,
            distance_threshold=self.attribute_distance_threshold,
            verbose=self.verbose, cluster_engine=self.cluster_engine,
            intersections=self._domains_inter_cache,
            nes_binary_dev=self._nes_binary_dev, nes_dev=self._nes_device())
        # stamp AFTER the call: resolving a pending device indicator inside
        # bumps the serial, and node2domain derives from the resolved state
        self._node2domain_serial = self._enrichment_serial

    def trim_domains(self, **kwargs):
        self.attributes, self.node2domain, self.domains = _domains.trim_domains(
            self.attributes, self.node2domain,
            min_size=self.attribute_enrichment_min_size, verbose=self.verbose)

    # ------------------------------------------------------------------- plotting

    def plot_network(self, **kwargs):
        from safepy_tpu import plotting
        return plotting.plot_safe_network(self, **kwargs)

    def plot_composite_network(self, **kwargs):
        from safepy_tpu import plotting
        return plotting.plot_composite_network(self, **kwargs)

    def plot_composite_network_contours(self, **kwargs):
        from safepy_tpu import plotting
        return plotting.plot_composite_network_contours(self, **kwargs)

    def plot_sample_attributes(self, **kwargs):
        from safepy_tpu import plotting
        return plotting.plot_sample_attributes(self, **kwargs)

    # --------------------------------------------------------------------- output

    def print_output_files(self, **kwargs):
        from safepy_tpu import output
        output.print_output_files(self, **kwargs)


def run_safe_batch(attribute_file):
    """One worker of the batch CLI: full pipeline on one attribute chunk
    (reference: safe.py:1309-1318)."""
    sf = SAFE()
    sf.load_network()
    sf.define_neighborhoods()
    sf.load_attributes(attribute_file=attribute_file)
    sf.compute_pvalues(num_permutations=1000)
    return sf.nes


# Reference-namespace compatibility: safepy's `safe` module star-imports its io,
# extras, and colormap helpers (safepy/safe.py:32-34), so user code reaches them
# as `safe.<name>`. Mirror that surface here; the matplotlib-backed helpers
# load on first access, so a run without plots does not need matplotlib.
from safepy_tpu.io import (calculate_edge_lengths,  # noqa: E402,F401
                           apply_network_layout, chop_and_filter,
                           get_node_coordinates, load_mat,
                           load_network_from_cys, load_network_from_gpickle,
                           load_network_from_mat, load_network_from_scatter,
                           load_network_from_txt, read_attributes)
from safepy_tpu.ops.score import compute_neighborhood_score  # noqa: E402,F401

_PLOT_HELPERS = {
    "MidpointRangeNormalize": "safepy_tpu.colormaps",
    "get_colors": "safepy_tpu.colormaps",
    "mark_nodes": "safepy_tpu.plotting",
    "plot_network": "safepy_tpu.plotting",
    "plot_network_contour": "safepy_tpu.plotting",
    "plot_costanzo2016_network_annotations": "safepy_tpu.plotting",
}


def __getattr__(name):
    if name in _PLOT_HELPERS:
        return getattr(importlib.import_module(_PLOT_HELPERS[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def run_permutations(arg_tuple, **kwargs):
    """Reference-signature permutation worker (safe_extras.py:36-70): takes the
    pool-argument tuple ``(neighborhoods, node2attribute, score_type,
    num_permutations, random_seed)`` and returns the two-sided count stacks.
    The device engine replaces the NumPy loop; the RNG stream is keyed, not the
    compounding in-place shuffle (distributional parity, see ops/permutation.py).
    """
    (neighborhood2node, node2attribute, neighborhood_score_type,
     num_permutations, random_seed) = arg_tuple
    node2attribute = np.asarray(node2attribute, dtype=np.float64)
    obs = compute_neighborhood_score(
        jnp.asarray(neighborhood2node, jnp.float32), node2attribute,
        neighborhood_score_type)
    valid_rows = np.flatnonzero(np.sum(~np.isnan(node2attribute), axis=1))
    if len(valid_rows) == node2attribute.shape[0]:
        valid_rows = None
    if random_seed is None:
        random_seed = int(np.random.default_rng().integers(2 ** 31 - 1))
    counts_neg, counts_pos = _perm.run_permutations(
        jnp.asarray(neighborhood2node, jnp.float32), node2attribute,
        valid_rows, obs, jax.random.PRNGKey(int(random_seed)),
        score_type=neighborhood_score_type,
        num_permutations=int(num_permutations))
    return np.asarray(counts_neg, np.float64), np.asarray(counts_pos, np.float64)
