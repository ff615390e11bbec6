"""The device core needs none of the host-side packages, and the facade
needs matplotlib only to plot (the machine that runs the card may lack
them); Euclidean distances do not depend on the matmul precision default."""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np


def _run(code):
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300,
                       env={**__import__("os").environ, "JAX_PLATFORMS": "cpu"})
    assert r.returncode == 0, r.stderr[-3000:]
    return r.stdout


def test_device_core_imports_without_host_packages():
    out = _run(
        "import sys\n"
        "for m in ('networkx', 'pandas', 'matplotlib'):\n"
        "    sys.modules[m] = None\n"
        "import safepy_tpu, safepy_tpu.ops, safepy_tpu.pipeline\n"
        "import safepy_tpu.parallel, safepy_tpu.hbm, safepy_tpu.ops.minplus\n"
        "import safepy_tpu.parallel.band_sharded\n"
        "print('ok')\n")
    assert out.strip() == "ok"


def test_facade_runs_without_matplotlib():
    out = _run(
        "import sys\n"
        "sys.modules['matplotlib'] = None\n"
        "import numpy as np, networkx as nx, pandas as pd\n"
        "from safepy_tpu import SAFE\n"
        "import safepy_tpu.safe as s\n"
        "g = nx.cycle_graph(40)\n"
        "for i in g: g.nodes[i].update(label=f'g{i}', key=f'g{i}',\n"
        "    x=float(np.cos(i / 6.4)), y=float(np.sin(i / 6.4)))\n"
        "from safepy_tpu.io.layout import calculate_edge_lengths\n"
        "calculate_edge_lengths(g, verbose=False)\n"
        "sf = SAFE(verbose=False); sf.random_seed = 1\n"
        "sf.load_network(network_file=g, node_key_attribute='key')\n"
        "sf.load_attributes(attribute_file=pd.DataFrame(\n"
        "    {'q': np.random.default_rng(0).normal(size=40)},\n"
        "    index=[f'g{i}' for i in range(40)]))\n"
        "sf.run_pipeline(num_permutations=20)\n"
        "assert sf.nes.shape == (40, 1)\n"
        "try:\n"
        "    s.get_colors\n"
        "except ImportError:\n"
        "    print('ok')\n")
    assert out.strip() == "ok"


def test_euclidean_distances_ignore_tf32_default():
    from safepy_tpu.ops.neighborhoods import euclidean_distance_matrix

    rng = np.random.default_rng(0)
    coords = jnp.asarray(rng.uniform(-1, 1, (64, 2)).astype(np.float32))
    base = np.asarray(euclidean_distance_matrix(coords))
    with jax.default_matmul_precision("tensorfloat32"):
        jaxpr = jax.make_jaxpr(euclidean_distance_matrix.__wrapped__)(coords)
        tf32 = np.asarray(euclidean_distance_matrix(coords))
    dots = [e for e in jaxpr.eqns if e.primitive.name == "dot_general"]
    assert dots
    for e in dots:
        assert e.params["precision"] == (jax.lax.Precision.HIGHEST,) * 2
    np.testing.assert_array_equal(tf32, base)
    ref = np.sqrt(((np.asarray(coords, np.float64)[:, None]
                    - np.asarray(coords, np.float64)[None]) ** 2).sum(-1))
    # f32 Gram-form cancellation near zero distance bounds the agreement
    np.testing.assert_allclose(base, ref, atol=1e-5)
