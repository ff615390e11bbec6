"""Row-sharded blocked Floyd-Warshall over a device mesh.

Scales APSP past single-chip HBM the way ring attention scales sequence length: the
(N, N) distance matrix is row-block sharded over the mesh axis, and each pivot
round broadcasts only the closed pivot row panel:

  per round kb:
    1. the device owning pivot rows extracts the (T, N) panel; a ``pmin`` over the
       mesh axis broadcasts it (non-owners contribute +inf);
    2. every device closes the (T, T) diagonal tile and relaxes the panel against
       it (replicated O(N T^2) work — a T*ndev/N fraction of the local phase-3);
    3. every device relaxes its LOCAL row slab: Q_local = slab[:, kb-block],
       slab = min(slab, Q_local (x) panel) — the O(N^3 / ndev) bulk, through
       ops/minplus.py.

  Comms per round: one (T, N) pmin — N^2 floats total per full pass.

Reference analog: none — the reference's APSP is a serial host loop
(safepy/safe.py:406-410); this is the scale-out path BASELINE.json's 20k-node
target requires.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from safepy_tpu.ops import minplus
from safepy_tpu.ops.apsp import pad_distances


@functools.partial(jax.jit, static_argnames=("mesh", "axis", "block", "impl"))
def _apsp_sharded_impl(d_padded, *, mesh, axis, block, impl):
    npad = d_padded.shape[0]
    ndev = mesh.shape[axis]
    rows_per_dev = npad // ndev
    nb = npad // block

    # check_vma=False: pallas_call outputs inside shard_map lack the
    # varying-mesh-axes annotation jax would otherwise demand
    @functools.partial(jax.shard_map, mesh=mesh, check_vma=False,
                       in_specs=P(axis, None), out_specs=P(axis, None))
    def worker(slab):  # (rows_per_dev, npad)
        my = jax.lax.axis_index(axis)

        def round_body(kb, slab):
            start = kb * block
            owner = start // rows_per_dev
            local_start = jnp.clip(start - owner * rows_per_dev,
                                   0, rows_per_dev - block)

            p_loc = jax.lax.dynamic_slice(slab, (local_start, 0), (block, npad))
            p = jnp.where(my == owner, p_loc, jnp.inf)
            p = jax.lax.pmin(p, axis)  # broadcast the pivot row panel

            diag = jax.lax.dynamic_slice(p, (0, start), (block, block))
            diag = minplus.close_tile(diag, impl=impl)
            p = minplus.relax(p, diag, p, impl=impl)

            q = jax.lax.dynamic_slice(slab, (0, start), (rows_per_dev, block))
            q = minplus.relax(q, q, diag, impl=impl)

            return minplus.relax(slab, q, p, impl=impl)

        return jax.lax.fori_loop(0, nb, round_body, slab)

    return worker(d_padded)


def apsp_sharded(dist, mesh: Mesh, *, axis: str = "data", block: int = 128,
                 impl: str | None = None):
    """All-pairs shortest paths with the distance matrix row-sharded over `mesh`."""
    dist = jnp.asarray(dist, jnp.float32)
    n = dist.shape[0]
    ndev = mesh.shape[axis]
    # pad so that block tiles never straddle a shard boundary
    unit = block * ndev
    d = pad_distances(dist, unit)
    out = _apsp_sharded_impl(d, mesh=mesh, axis=axis, block=block,
                             impl=minplus.resolve(impl))
    return out[:n, :n]
