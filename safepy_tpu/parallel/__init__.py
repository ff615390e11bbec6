"""Multi-device scaling: device meshes, sharded pipelines, collectives.

The reference parallelizes with host multiprocessing pools — permutation batches
split over workers with host-side count summation (safepy/safe.py:501-519) and
attribute columns split over a CLI pool (safe.py:1335-1355). Here both axes are
jax.sharding meshes:

  * :mod:`safepy_tpu.parallel.mesh` — mesh construction helpers;
  * :mod:`safepy_tpu.parallel.permutation_sharded` — permutation batch sharded over
    the mesh, counts psum-reduced;
  * :mod:`safepy_tpu.parallel.apsp_sharded` — row-sharded blocked Floyd-Warshall:
    pivot panels broadcast with pmin, the O(N^3 / n_devices) phase-3 relaxation
    local per device;
  * :mod:`safepy_tpu.parallel.apsp_sharded_2d` — the 2-D block-sharded variant
    (distance matrix tiled over a (row, col) mesh, per-round comms shrunk to
    T*N/C + N*T/R + T^2);
  * :mod:`safepy_tpu.parallel.hypergeom_sharded` — attribute columns sharded for the
    census matmuls + survival-function tail (no inter-device traffic at all).
"""

from safepy_tpu.parallel.mesh import make_mesh
from safepy_tpu.parallel.permutation_sharded import run_permutations_sharded
from safepy_tpu.parallel.apsp_sharded import apsp_sharded
from safepy_tpu.parallel.apsp_sharded_2d import apsp_sharded_2d
from safepy_tpu.parallel.hypergeom_sharded import (
    hypergeom_counts_sharded, hypergeom_enrichment_sharded)

__all__ = [
    "make_mesh",
    "run_permutations_sharded",
    "apsp_sharded",
    "apsp_sharded_2d",
    "hypergeom_counts_sharded",
    "hypergeom_enrichment_sharded",
]
