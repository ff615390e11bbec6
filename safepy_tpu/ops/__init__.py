"""Device core: pure JAX/Pallas functions on arrays.

Everything between "dense adjacency + attribute matrix in" and "NES / p-value
matrices out" lives here, jit-compiled for the GPU (or the CPU):

  * :mod:`safepy_tpu.ops.apsp` — all-pairs shortest paths (blocked min-plus
    Floyd-Warshall; tile relaxations through :mod:`safepy_tpu.ops.minplus`,
    a Triton-route Pallas kernel on the GPU, plain jnp on the CPU).
  * :mod:`safepy_tpu.ops.neighborhoods` — neighborhood indicator matrices for the
    three node-distance metrics of the reference (safepy/safe.py:369-430).
  * :mod:`safepy_tpu.ops.score` — neighborhood scores (sum / z-score) with explicit
    NaN masks (reference: safepy/safe_extras.py:6-33).
  * :mod:`safepy_tpu.ops.hypergeom` — vectorized log-space hypergeometric survival
    function (reference: scipy hypergeom.sf at safepy/safe.py:596).
  * :mod:`safepy_tpu.ops.permutation` — batched keyed permutation null with on-chip
    two-sided count reduction (reference: safepy/safe_extras.py:36-70).
  * :mod:`safepy_tpu.ops.fdr` — vectorized Benjamini-Hochberg correction
    (reference: statsmodels fdrcorrection at safepy/safe.py:599-605).
"""

from safepy_tpu.ops.apsp import apsp, min_plus_product
from safepy_tpu.ops.neighborhoods import (
    euclidean_distance_matrix,
    neighborhoods_from_distances,
)
from safepy_tpu.ops.score import compute_neighborhood_score
from safepy_tpu.ops.hypergeom import hypergeom_sf, hypergeom_neglog10_sf
from safepy_tpu.ops.permutation import run_permutations
from safepy_tpu.ops.fdr import fdr_bh

__all__ = [
    "apsp",
    "min_plus_product",
    "euclidean_distance_matrix",
    "neighborhoods_from_distances",
    "compute_neighborhood_score",
    "hypergeom_sf",
    "hypergeom_neglog10_sf",
    "run_permutations",
    "fdr_bh",
]
