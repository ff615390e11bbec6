"""Persistent XLA compile cache (safepy_tpu/__init__.py wiring).

JAX_COMPILATION_CACHE_DIR is honoured as given; without it the cache lives
at one fixed path in the checkout, and a CPU-only process keeps none. The
round trip itself is pinned on the CPU backend: process A compiles a FUSED
BAND PIPELINE program into a fresh cache dir, process B re-runs the
identical program and must be served from the persistent cache (counted via
the /jax/compilation_cache/cache_hits monitoring event, which every backend
bumps).

Reference analog: none — the reference recompiles nothing (eager numpy);
this protects the compiled design's cold-start story.
"""

import json
import os
import subprocess
import sys

import pytest

_DRIVER = r"""
import json, os, sys
import jax, jax.monitoring
import numpy as np

hits = {"n": 0}
def _listener(event, **kw):
    if event == "/jax/compilation_cache/cache_hits":
        hits["n"] += 1
jax.monitoring.register_event_listener(_listener)

import safepy_tpu  # noqa: E402  (wires the cache dir from the env)
import jax.numpy as jnp
from safepy_tpu import pipeline
from safepy_tpu.ops import hypergeom as hyper

# tiny fused band program: same entry point run_pipeline dispatches at GO
# scale (pipeline.fused_hypergeom_pipeline_band), ring graph so the banded
# order is trivial
n, band = 200, 16
u = jnp.arange(n, dtype=jnp.int32)
v = (u + 1) % n
w = jnp.ones(n, jnp.float32)
rng = np.random.default_rng(0)
nan0 = (rng.random((n, 4)) < 0.3).astype(np.float32)
K = nan0.sum(0)
rank = jnp.arange(n, dtype=jnp.int32)
iters = hyper.tail_iterations(n, int(K.max()))
out = pipeline.fused_hypergeom_pipeline_band(
    u, v, w, jnp.asarray(nan0), jnp.ones(n, jnp.float32), jnp.asarray(K),
    jnp.asarray(hyper.lgamma_table(n)), n, 2.5, np.float64(0.05), rank,
    iterations=iters, n=n, band=band, keep_distances=False)
logsf = np.asarray(out[2])
assert logsf.shape == (n, 4), logsf.shape
print(json.dumps({"hits": hits["n"],
                  "cache_dir": jax.config.jax_compilation_cache_dir,
                  "entries": len([f for f in os.listdir(
                      jax.config.jax_compilation_cache_dir)
                      if not f.startswith(".")])}))
"""


def _run(cache_dir):
    env = dict(
        os.environ,
        JAX_PLATFORMS="cpu",
        JAX_COMPILATION_CACHE_DIR=str(cache_dir),
        XLA_FLAGS="--xla_force_host_platform_device_count=1",
    )
    r = subprocess.run([sys.executable, "-c", _DRIVER], env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.mark.slow
def test_fused_band_program_round_trips_through_persistent_cache(tmp_path):
    cache = tmp_path / "xla-cache"
    a = _run(cache)
    assert a["cache_dir"] == str(cache)
    # process A compiled everything: entries written, no hits
    assert a["entries"] > 0
    assert a["hits"] == 0
    b = _run(cache)
    # process B must reuse the persisted executables — at minimum the fused
    # band pipeline program — and write no new entries for them
    assert b["hits"] >= 1, (a, b)
    assert b["entries"] == a["entries"], (a, b)


_SWEEP_DRIVER = r"""
import json, os, sys
import jax, jax.monitoring
import numpy as np

hits = {"n": 0}
def _listener(event, **kw):
    if event == "/jax/compilation_cache/cache_hits":
        hits["n"] += 1
jax.monitoring.register_event_listener(_listener)

import safepy_tpu  # noqa: E402  (wires the cache dir from the env)
import networkx as nx
import pandas as pd
from safepy_tpu import SAFE

target = float(sys.argv[1])
n = 4000
rng = np.random.default_rng(5)
coords = rng.uniform(-1, 1, (n, 2))
g = nx.Graph(); g.add_nodes_from(range(n))
for i in range(n):
    g.nodes[i]["label"] = g.nodes[i]["key"] = f"c{i}"
    g.nodes[i]["x"] = float(coords[i, 0]); g.nodes[i]["y"] = float(coords[i, 1])
vals = rng.normal(size=(n, 1)); vals[rng.random(n) < 0.3, 0] = np.nan
attrs = pd.DataFrame(vals, index=[f"c{i}" for i in range(n)], columns=["q"])
sf = SAFE(verbose=False)
sf.random_seed = 17
sf.apsp_mode = "band"; sf.band_storage_min_nodes = 100
sf.keep_node_distances = False; sf.band_indicator_bits = True
sf.neighborhood_radius = float(np.sqrt(target / (np.pi * n)))
sf.load_network(network_file=g, node_key_attribute="key")
sf.load_attributes(attribute_file=attrs)
sf.run_pipeline(node_distance_metric="euclidean", num_permutations=100)
cd = jax.config.jax_compilation_cache_dir
print(json.dumps({"hits": hits["n"], "band": int(sf._neighborhoods_dev.band),
                  "entries": len([f for f in os.listdir(cd)
                                  if not f.startswith(".")])}))
"""


@pytest.mark.slow
def test_bucketed_radius_sweep_reuses_cache_across_processes(tmp_path):
    """Two radii whose certified bands land in the same bt bucket must map
    to ONE canonical band (safe.py _bucket_band) and the second process
    must be served from the persistent cache — `band` is a static argname
    of the band pipelines, so without canonicalization the same-bucket
    radii would compile two programs."""
    env_base = dict(
        os.environ, JAX_PLATFORMS="cpu",
        JAX_COMPILATION_CACHE_DIR=str(tmp_path / "xla-cache"),
        XLA_FLAGS="--xla_force_host_platform_device_count=1")

    def run(target):
        r = subprocess.run([sys.executable, "-c", _SWEEP_DRIVER, str(target)],
                           env=env_base, capture_output=True, text=True,
                           timeout=600)
        assert r.returncode == 0, r.stderr[-2000:]
        return json.loads(r.stdout.strip().splitlines()[-1])

    a = run(125.0)
    b = run(110.0)  # fresh radius, same bt bucket
    assert b["band"] == a["band"], (a, b)  # ONE canonical band
    assert b["hits"] >= 1, (a, b)
    # every program of the second radius is served — no new entries
    assert b["entries"] == a["entries"], (a, b)


_CONFIG = ("import safepy_tpu, jax, json; print(json.dumps(["
           "jax.config.jax_compilation_cache_dir, "
           "jax.config.jax_persistent_cache_min_compile_time_secs, "
           "jax.config.jax_persistent_cache_min_entry_size_bytes]))")


def _config(env):
    r = subprocess.run([sys.executable, "-c", _CONFIG], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def _env(**kw):
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_COMPILATION_CACHE_DIR", "JAX_PLATFORMS")}
    env.update(kw)
    return env


def test_explicit_cache_dir_wins_on_cpu(tmp_path):
    # JAX_COMPILATION_CACHE_DIR is used as given on any platform; without
    # it a CPU-only process (the test suite) keeps no cache
    d = str(tmp_path / "c")
    assert _config(_env(JAX_PLATFORMS="cpu",
                        JAX_COMPILATION_CACHE_DIR=d))[0] == d
    assert _config(_env(JAX_PLATFORMS="cpu"))[0] is None


@pytest.mark.parametrize("platforms", [None, "cuda", "cuda,cpu"])
def test_env_cache_dir_is_the_only_dir(tmp_path, platforms):
    d = str(tmp_path / "env-cache")
    kw = {} if platforms is None else {"JAX_PLATFORMS": platforms}
    assert _config(_env(JAX_COMPILATION_CACHE_DIR=d, **kw)) == [d, 0.0, 0]


@pytest.mark.parametrize("platforms", [None, "cuda"])
def test_default_cache_dir_is_fixed_in_checkout(platforms):
    import safepy_tpu

    kw = {} if platforms is None else {"JAX_PLATFORMS": platforms}
    checkout = os.path.dirname(os.path.dirname(os.path.abspath(
        safepy_tpu.__file__)))
    got = _config(_env(**kw))
    assert got == [os.path.join(checkout, ".jax_cache"), 0.0, 0]
    # the same path in every process: nothing in it depends on the run
    assert _config(_env(**kw))[0] == got[0]
