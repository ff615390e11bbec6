"""Permutation null sharded over the device mesh.

Device-mesh replacement for the reference's multiprocessing pool
(safepy/safe.py:501-519): the permutation batch is split evenly over ALL mesh
axes (rounded up, exactly like the reference rounds to a multiple of the worker
count, safe.py:503-504), every device runs an independent keyed slice of the
null, and the two-sided count stacks are psum-reduced instead of
pickled back to the host.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P


@functools.partial(
    jax.jit,
    static_argnames=("mesh", "axes", "score_type", "per_dev", "batch_size",
                     "precision"))
def _sharded_counts(nbr_valid, vals, mask, obs, keys, *, mesh, axes,
                    score_type, per_dev, batch_size, precision):
    from safepy_tpu.ops.permutation import scan_counts

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(), P(), P(), P(), P(axes)),
        out_specs=(P(), P()),
    )
    def worker(nbr_valid, vals, mask, obs, key_slice):
        cn, cp = scan_counts(nbr_valid, vals, mask, obs, key_slice[0],
                             score_type=score_type, num_permutations=per_dev,
                             batch_size=batch_size, precision=precision)
        return jax.lax.psum(cn, axes), jax.lax.psum(cp, axes)

    return worker(nbr_valid, vals, mask, obs, keys)


def run_permutations_sharded(neighborhoods, node2attribute, valid_rows, obs, key,
                             *, mesh: Mesh, axes=None,
                             score_type: str = "sum",
                             num_permutations: int = 1000,
                             batch_size: int | None = None,
                             precision: str = "highest"):
    """Sharded two-sided permutation counts.

    The batch splits over `axes` (default: every axis of the mesh, so a 2-axis
    facade mesh still uses all devices). Returns
    ``(counts_neg, counts_pos, total_permutations)`` — the total is
    ``num_permutations`` rounded up to a multiple of the device count; divide
    the counts by it.
    """
    from safepy_tpu.ops.permutation import default_batch_size, prepare_valid

    if axes is None:
        axes = tuple(mesh.axis_names)
    elif isinstance(axes, str):
        axes = (axes,)
    ndev = 1
    for a in axes:
        ndev *= mesh.shape[a]
    per_dev = -(-num_permutations // ndev)
    total = per_dev * ndev

    obs = jnp.asarray(obs, jnp.float32)
    nbr_valid, vals, mask = prepare_valid(neighborhoods, node2attribute, valid_rows)
    V, A = vals.shape
    if batch_size is None:
        batch_size = default_batch_size(V, A, per_dev)

    keys = jax.random.split(key, ndev)  # (ndev, key), one slice per device

    counts_neg, counts_pos = _sharded_counts(
        nbr_valid, vals, mask, obs, keys, mesh=mesh, axes=axes,
        score_type=score_type, per_dev=per_dev, batch_size=batch_size,
        precision=precision)
    return counts_neg, counts_pos, total
