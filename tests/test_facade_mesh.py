"""Multi-chip execution through the facade: SAFE.mesh shards APSP and the
permutation null, and results agree with single-device runs."""

import networkx as nx
import numpy as np
import pandas as pd
import pytest

from safepy_tpu import SAFE
from safepy_tpu.parallel import make_mesh


@pytest.fixture(scope="module")
def network(tmp_path_factory):
    g = nx.connected_watts_strogatz_graph(64, 6, 0.3, seed=21)
    path = tmp_path_factory.mktemp("mesh") / "net.txt"
    with open(path, "w") as f:
        for u, v in g.edges():
            f.write(f"g{u}\tg{v}\t1.0\n")
    return str(path)


def _run(network, mesh, perms=160):
    sf = SAFE(verbose=False)
    sf.random_seed = 31
    sf.mesh = mesh
    sf.load_network(network_file=network, node_key_attribute="key")
    sf.define_neighborhoods()
    n = sf.graph.number_of_nodes()
    rng = np.random.default_rng(4)
    df = pd.DataFrame(rng.normal(size=(n, 1)),
                      index=[f"g{i}" for i in range(n)], columns=["q"])
    sf.load_attributes(attribute_file=df)
    sf.compute_pvalues(num_permutations=perms)
    return sf


@pytest.mark.slow
def test_mesh_neighborhoods_match_single(network):
    single = _run(network, None)
    meshed = _run(network, make_mesh({"data": 4, "perm": 2}))
    np.testing.assert_array_equal(single.neighborhoods, meshed.neighborhoods)


def test_mesh_null_statistics_agree(network):
    single = _run(network, None)
    meshed = _run(network, make_mesh({"perm": 8}))
    assert meshed.num_permutations == 160  # divisible: no round-up
    # independent keyed nulls: p-values agree within binomial noise
    diff = np.abs(single.pvalues_pos - meshed.pvalues_pos)
    assert np.nanmax(diff) < 0.25


def test_mesh_round_up(network):
    meshed = _run(network, make_mesh({"perm": 8}), perms=100)
    assert meshed.num_permutations == 104  # ceil(100/8)*8
    p_sum = meshed.pvalues_neg + meshed.pvalues_pos
    finite = ~np.isnan(p_sum)
    assert (p_sum[finite] >= 1.0 - 1e-9).all()


def test_run_pipeline_with_mesh(network):
    sf = SAFE(verbose=False)
    sf.random_seed = 31
    sf.mesh = make_mesh({"perm": 8})
    sf.load_network(network_file=network, node_key_attribute="key")
    n = sf.graph.number_of_nodes()
    rng = np.random.default_rng(4)
    df = pd.DataFrame(rng.normal(size=(n, 1)),
                      index=[f"g{i}" for i in range(n)], columns=["q"])
    sf.load_attributes(attribute_file=df)
    sf.run_pipeline(num_permutations=80)  # falls back to sharded stage path
    assert sf.nes is not None


def test_mesh_session_pickles(network, tmp_path):
    """SAFE.save must work with a mesh set (Device objects aren't picklable)."""
    import pickle
    sf = _run(network, make_mesh({"perm": 8}), perms=16)
    out = tmp_path / "mesh_session.p"
    sf.save(output_file=str(out))
    with open(out, "rb") as f:
        sf2 = pickle.load(f)
    assert sf2.mesh is None
    np.testing.assert_array_equal(sf2.neighborhoods, sf.neighborhoods)


def _binary_frame(n, rng):
    vals = np.zeros((n, 6))
    vals[: n // 2, :3] = (rng.random((n // 2, 3)) < 0.7)
    vals[n // 2:, 3:] = (rng.random((n - n // 2, 3)) < 0.7)
    return pd.DataFrame(vals, index=[f"g{i}" for i in range(n)],
                        columns=[f"a{i}" for i in range(6)])


def _run_binary(network, mesh, **pv_kwargs):
    sf = SAFE(verbose=False)
    sf.random_seed = 31
    sf.mesh = mesh
    sf.load_network(network_file=network, node_key_attribute="key")
    sf.define_neighborhoods()
    sf.load_attributes(attribute_file=_binary_frame(
        sf.graph.number_of_nodes(), np.random.default_rng(9)))
    sf.compute_pvalues(**pv_kwargs)
    return sf


def test_mesh_hypergeom_engine(network):
    """The staged facade reaches the column-sharded hypergeometric engine
    (census + sf tail inside the shard_map workers) and matches single-device."""
    single = _run_binary(network, None)
    meshed = _run_binary(network, make_mesh({"data": 2, "attr": 4}))
    # the mesh path stores log-sf in f32 (device finalization); the staged
    # single path finalizes in host f64 -> ~2e-8 relative, inside the 1e-6 budget
    assert np.nanmax(np.abs(single.pvalues_pos - meshed.pvalues_pos)) <= 1e-6
    np.testing.assert_array_equal(single.nes_binary, meshed.nes_binary)
    np.testing.assert_allclose(single.nes, meshed.nes, rtol=1e-5, atol=1e-6)


def test_mesh_hypergeom_engine_fdr(network):
    single = _run_binary(network, None, multiple_testing=True)
    meshed = _run_binary(network, make_mesh({"attr": 8}), multiple_testing=True)
    assert np.nanmax(np.abs(single.pvalues_pos - meshed.pvalues_pos)) <= 1e-6
    np.testing.assert_array_equal(single.nes_binary, meshed.nes_binary)


@pytest.mark.slow
def test_run_pipeline_mesh_fused_hypergeom(network):
    """run_pipeline composes the mesh with the FUSED program (sharded FW +
    sharded sf tail in one dispatch) instead of falling back to stages."""
    def _pipeline(mesh):
        sf = SAFE(verbose=False)
        sf.random_seed = 31
        sf.mesh = mesh
        sf.load_network(network_file=network, node_key_attribute="key")
        sf.load_attributes(attribute_file=_binary_frame(
            sf.graph.number_of_nodes(), np.random.default_rng(9)))
        sf.run_pipeline()
        return sf

    single = _pipeline(None)
    meshed = _pipeline(make_mesh({"data": 2, "attr": 4}))
    np.testing.assert_array_equal(single.neighborhoods, meshed.neighborhoods)
    np.testing.assert_array_equal(single.nes_binary, meshed.nes_binary)
    assert np.nanmax(np.abs(single.pvalues_pos - meshed.pvalues_pos)) <= 1e-9


def test_run_pipeline_mesh_fused_permutation_exact_replay(network):
    """Bit-exact correctness pin for the sharded null (not a tolerance): the
    psum-reduced sharded counts must equal the same per-device keys replayed
    through scan_counts on a single device (the reference's host sum over
    worker results, safe.py:516-519, as an identity)."""
    import jax
    import jax.numpy as jnp

    from safepy_tpu.ops import permutation as perm_ops
    from safepy_tpu.ops import score as score_ops

    mesh = make_mesh({"perm": 8})
    sf = SAFE(verbose=False)
    sf.random_seed = 31
    sf.mesh = mesh
    sf.load_network(network_file=network, node_key_attribute="key")
    n = sf.graph.number_of_nodes()
    rng = np.random.default_rng(4)
    df = pd.DataFrame(rng.normal(size=(n, 1)),
                      index=[f"g{i}" for i in range(n)], columns=["q"])
    sf.load_attributes(attribute_file=df)
    sf.run_pipeline(num_permutations=80)
    assert sf.num_permutations == 80
    sharded_pos = np.rint(sf.pvalues_pos * sf.num_permutations)
    sharded_neg = np.rint(sf.pvalues_neg * sf.num_permutations)

    # replay: same key split, same per-device count and batch size, one device
    n2a = sf.node2attribute
    valid = np.flatnonzero(np.sum(~np.isnan(n2a), axis=1))
    nbr = jnp.asarray(sf.neighborhoods, jnp.float32)
    obs = score_ops.compute_neighborhood_score(nbr, n2a, "sum", "highest")
    nbr_valid, vals, mask = perm_ops.prepare_valid(nbr, n2a, valid)
    per_dev = 80 // 8
    batch = perm_ops.default_batch_size(len(valid), n2a.shape[1], per_dev)
    keys = jax.random.split(jax.random.PRNGKey(31), 8)
    total_neg = np.zeros(obs.shape, np.int64)
    total_pos = np.zeros(obs.shape, np.int64)
    for device in range(8):
        cn, cp = perm_ops.scan_counts(nbr_valid, vals, mask, obs, keys[device],
                                      score_type="sum", num_permutations=per_dev,
                                      batch_size=batch)
        total_neg += np.asarray(cn, np.int64)
        total_pos += np.asarray(cp, np.int64)

    finite = ~np.isnan(sf.ns)
    np.testing.assert_array_equal(sharded_pos[finite], total_pos[finite])
    np.testing.assert_array_equal(sharded_neg[finite], total_neg[finite])


def test_mesh_2d_apsp_through_facade(network):
    """A (row, col) mesh routes APSP through the 2-D block-sharded kernel in
    both the staged and fused paths, matching single-device results."""
    single = _run(network, None)
    meshed = _run(network, make_mesh({"row": 2, "col": 4}))
    np.testing.assert_array_equal(single.neighborhoods, meshed.neighborhoods)

    sf = SAFE(verbose=False)
    sf.random_seed = 31
    sf.mesh = make_mesh({"row": 2, "col": 4})
    sf.load_network(network_file=network, node_key_attribute="key")
    n = sf.graph.number_of_nodes()
    rng = np.random.default_rng(4)
    df = pd.DataFrame(rng.normal(size=(n, 1)),
                      index=[f"g{i}" for i in range(n)], columns=["q"])
    sf.load_attributes(attribute_file=df)
    sf.run_pipeline(num_permutations=80)
    np.testing.assert_array_equal(single.neighborhoods, sf.neighborhoods)


@pytest.mark.slow
def test_mesh_band_go_full_width_through_facade(tmp_path):
    """The FULL GO width (4,373 attributes) through the
    facade on the 8-device mesh — `sf.mesh = make_mesh({'data': 8});
    sf.run_pipeline()` just works: the per-shard HBM plan is asserted
    pre-dispatch (facade-native tools/mesh_band_go.py), the engine is
    'table-band-sharded', the (n, A) results are genuinely ROW-SHARDED
    (not replicated), and sampled rows match an exact scipy oracle."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import dijkstra
    from scipy.stats import hypergeom
    from safepy_tpu.ops.neighborhoods import inclusive_radius

    n, a = 2560, 4373
    rng = np.random.default_rng(2)
    coords = rng.uniform(-1, 1, (n, 2))
    from scipy.spatial import cKDTree
    _, nn = cKDTree(coords).query(coords, k=7)
    g = nx.Graph()
    g.add_nodes_from(range(n))
    g.add_edges_from({(min(i, int(j)), max(i, int(j)))
                      for i in range(n) for j in nn[i, 1:]})
    for i in range(n):
        g.nodes[i]["label"] = g.nodes[i]["key"] = f"n{i}"
        g.nodes[i]["x"], g.nodes[i]["y"] = map(float, coords[i])
    from safepy_tpu.io.layout import calculate_edge_lengths
    calculate_edge_lengths(g, verbose=False)

    sizes = np.exp(rng.uniform(np.log(5), np.log(0.03 * n), a))
    vals = (rng.random((n, a)) < (sizes / n)[None, :]).astype(np.float32)
    vals[rng.random((n, a)) < 0.05] = np.nan
    attrs = pd.DataFrame(vals, index=[f"n{i}" for i in range(n)],
                         columns=[f"go{j}" for j in range(a)])

    sf = SAFE(verbose=False)
    sf.apsp_mode = "band"
    sf.band_storage_min_nodes = 100
    sf.keep_node_distances = False
    sf.random_seed = 17
    sf.neighborhood_radius = float(np.sqrt(8.0 / (np.pi * n)))
    sf.mesh = make_mesh({"data": 8})
    sf.load_network(network_file=g, node_key_attribute="key")
    sf.load_attributes(attribute_file=attrs)
    sf.run_pipeline()

    assert sf._hypergeom_engine_used == "table-band-sharded"
    plan = sf._hbm_plan_last
    assert plan["sharded"] and plan["fits"] and plan["ndev"] == 8
    # the results must be row-sharded, not replicated (per-shard HBM plan)
    from jax.sharding import PartitionSpec as P
    assert sf._logsf_dev.sharding.spec == P("data", None)
    shard_rows = sf._logsf_dev.addressable_shards[0].data.shape[0]
    assert shard_rows <= -(-n // 8) + 8

    # exact scipy oracle over ALL 4,373 attributes on sampled rows
    edges = np.array(g.edges())
    w = np.hypot(coords[edges[:, 0], 0] - coords[edges[:, 1], 0],
                 coords[edges[:, 0], 1] - coords[edges[:, 1], 1])
    gsp = coo_matrix((np.concatenate([w, w]),
                      (np.concatenate([edges[:, 0], edges[:, 1]]),
                       np.concatenate([edges[:, 1], edges[:, 0]]))),
                     shape=(n, n)).tocsr()
    r = float(inclusive_radius(
        sf.neighborhood_radius * (coords[:, 0].max() - coords[:, 0].min())))
    sources = rng.choice(n, 6, replace=False)
    d_ref = dijkstra(gsp, indices=sources, limit=r * 1.001)
    nan0 = np.where(np.isnan(vals), 0.0, vals)
    K = nan0.sum(0)
    M = int((~np.isnan(vals)).any(1).sum())
    got_p = np.asarray(sf.pvalues_pos[sources])
    for row, s in enumerate(sources):
        members = np.flatnonzero(d_ref[row] <= r)
        k = nan0[members].sum(0)
        want = hypergeom.sf(k - 1, M, K.astype(int), len(members))
        assert float(np.abs(got_p[row] - want).max()) < 1e-6
