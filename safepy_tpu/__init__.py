"""safepy_tpu — Spatial Analysis of Functional Enrichment (SAFE) in JAX.

A ground-up JAX/XLA/Pallas re-design of the capabilities of baryshnikova-lab/safepy
(reference layout: safepy/safe.py, safepy/safe_io.py, safepy/safe_extras.py): given a
biological network and a matrix of node attributes, SAFE

  1. defines a local neighborhood around every node (all-pairs shortest paths as
     blocked min-plus Floyd-Warshall, with a Pallas kernel for NVIDIA GPUs —
     `safepy_tpu.ops.apsp`, `safepy_tpu.ops.minplus`),
  2. runs a statistical enrichment test of every attribute in every neighborhood
     (hypergeometric survival function / batched permutation null as GEMMs —
     `safepy_tpu.ops.hypergeom`, `safepy_tpu.ops.permutation`),
  3. clusters co-enriched attributes into domains (`safepy_tpu.domains`),
  4. renders the functional landscape (`safepy_tpu.plotting`).

SAFE has no neural networks — the "models" this framework ships are the compiled
end-to-end analysis programs at three altitudes: the stateful `SAFE` session (the
eager interface), the fused jit programs in `safepy_tpu.pipeline` (graph +
attributes in, enrichment out, one dispatch), and their mesh-sharded multi-device
compositions in `safepy_tpu.parallel`.

Architecture (three tiers, replacing the reference's god-class internals):

  * device core (`safepy_tpu.ops`, `safepy_tpu.parallel`) — pure functions on arrays,
    jit-compiled for the GPU (or the CPU); multi-device scaling via
    `jax.sharding.Mesh` + `shard_map`.
  * host graph/data layer (`safepy_tpu.io`) — file loaders, layouts, attribute alignment.
  * facade (`safepy_tpu.safe.SAFE`) — API-compatible with the reference `SAFE` class
    (same method names, kwargs, instance attributes, INI config).

Precision policy: SAFE statistics are pinned to <=1e-6 p-value parity with SciPy
oracles. The package enables JAX x64 on import (opt out with SAFEPY_TPU_X64=0 in the
environment *before* importing) so host<->device round trips keep f64 semantics; the
hot kernels pick their own compute dtypes explicitly (f32, bf16 on exact 0/1
operands, f64 only where statistical parity requires it).
"""

import os as _os

import jax as _jax

if _os.environ.get("SAFEPY_TPU_X64", "1") != "0":
    _jax.config.update("jax_enable_x64", True)

# Persistent compilation cache. JAX reads JAX_COMPILATION_CACHE_DIR itself;
# when it is unset the cache lives at one fixed path in the checkout (the
# path is part of what a later process must find). A CPU-only process
# (JAX_PLATFORMS=cpu, as the test suite runs) keeps none unless asked.
if (not _jax.config.jax_compilation_cache_dir
        and _os.environ.get("JAX_PLATFORMS", "").strip().lower() != "cpu"):
    _jax.config.update(
        "jax_compilation_cache_dir",
        _os.path.join(_os.path.dirname(_os.path.dirname(
            _os.path.abspath(__file__))), ".jax_cache"))
# cache every program, however quick to compile or small: a process that
# runs the pipeline once compiles dozens of short chunk programs
_jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
_jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)

__version__ = "0.1.0"

__all__ = ["SAFE", "ops", "safe_io", "__version__"]


def __getattr__(name):
    # Lazy top-level imports keep `import safepy_tpu.ops.x` cheap and cycle-free.
    import importlib

    if name == "SAFE":
        return importlib.import_module("safepy_tpu.safe").SAFE
    if name == "ops":
        return importlib.import_module("safepy_tpu.ops")
    if name == "safe_io":
        return importlib.import_module("safepy_tpu.io")
    raise AttributeError(f"module 'safepy_tpu' has no attribute {name!r}")
