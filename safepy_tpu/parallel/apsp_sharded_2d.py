"""2-D block-sharded Floyd-Warshall: the (N, N) distance matrix tiled over a
(row, col) device mesh.

The 1-D row-sharded kernel (apsp_sharded.py) already scales HBM linearly with
the device count; this variant additionally shrinks the per-round broadcast
from a (T, N) panel to (T, N/C) + (N/R, T) + the (T, T) diagonal — the SURVEY
§5 "shard the N x N matrix 2-D over the mesh" analog of ring attention's 2-D
layouts. Per pivot round:

  1. the pivot ROW panel, restricted to each device's column slice, is owned by
     one mesh row — a ``pmin`` over the 'row' axis broadcasts it down each mesh
     column (non-owners contribute +inf);
  2. the (T, T) diagonal tile is then replicated with a second ``pmin`` over
     the 'col' axis, closed locally, and both panels are relaxed against it;
  3. the pivot COLUMN panel is broadcast with a ``pmin`` over the 'col' axis;
  4. every device relaxes its LOCAL (N/R, N/C) block: the O(N^3 / (R*C)) bulk.

Comms per round: T*N/C + N*T/R + T^2 floats — vs T*N for the 1-D kernel.

Reference analog: none (the reference's APSP is a serial host loop,
safepy/safe.py:406-410).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from safepy_tpu.ops import minplus
from safepy_tpu.ops.apsp import pad_distances


@functools.partial(jax.jit, static_argnames=("mesh", "row_axis", "col_axis",
                                             "block", "impl"))
def _apsp_sharded_2d_impl(d_padded, *, mesh, row_axis, col_axis, block,
                          impl):
    npad = d_padded.shape[0]
    n_row = mesh.shape[row_axis]
    n_col = mesh.shape[col_axis]
    rows_per_dev = npad // n_row
    cols_per_dev = npad // n_col
    nb = npad // block

    @functools.partial(jax.shard_map, mesh=mesh, check_vma=False,
                       in_specs=P(row_axis, col_axis),
                       out_specs=P(row_axis, col_axis))
    def worker(blockmat):  # (rows_per_dev, cols_per_dev)
        my_row = jax.lax.axis_index(row_axis)
        my_col = jax.lax.axis_index(col_axis)

        def round_body(kb, blockmat):
            start = kb * block
            row_owner = start // rows_per_dev
            col_owner = start // cols_per_dev
            local_row = jnp.clip(start - row_owner * rows_per_dev,
                                 0, rows_per_dev - block)
            local_col = jnp.clip(start - col_owner * cols_per_dev,
                                 0, cols_per_dev - block)

            # 1. pivot row panel for MY column slice, broadcast down mesh rows
            p_loc = jax.lax.dynamic_slice(blockmat, (local_row, 0),
                                          (block, cols_per_dev))
            p = jnp.where(my_row == row_owner, p_loc, jnp.inf)
            p = jax.lax.pmin(p, row_axis)

            # 2. the diagonal tile sits in the column-owner's slice of p;
            #    replicate it across mesh columns and close it
            diag_loc = jax.lax.dynamic_slice(p, (0, local_col), (block, block))
            diag = jnp.where(my_col == col_owner, diag_loc, jnp.inf)
            diag = jax.lax.pmin(diag, col_axis)
            diag = minplus.close_tile(diag, impl=impl)
            p = minplus.relax(p, diag, p, impl=impl)

            # 3. pivot column panel for MY row slice, broadcast across columns
            q_loc = jax.lax.dynamic_slice(blockmat, (0, local_col),
                                          (rows_per_dev, block))
            q = jnp.where(my_col == col_owner, q_loc, jnp.inf)
            q = jax.lax.pmin(q, col_axis)
            q = minplus.relax(q, q, diag, impl=impl)

            # 4. local O(N^3 / (R*C)) relaxation
            return minplus.relax(blockmat, q, p, impl=impl)

        return jax.lax.fori_loop(0, nb, round_body, blockmat)

    return worker(d_padded)


def apsp_sharded_2d(dist, mesh: Mesh, *, row_axis: str = "row",
                    col_axis: str = "col", block: int = 128,
                    impl: str | None = None):
    """All-pairs shortest paths with the distance matrix 2-D block-sharded."""
    dist = jnp.asarray(dist, jnp.float32)
    n = dist.shape[0]
    # tiles must never straddle a shard boundary on either axis
    unit = _lcm(block * mesh.shape[row_axis], block * mesh.shape[col_axis])
    d = pad_distances(dist, unit)
    out = _apsp_sharded_2d_impl(d, mesh=mesh, row_axis=row_axis,
                                col_axis=col_axis, block=block,
                                impl=minplus.resolve(impl))
    return out[:n, :n]


def _gcd(a, b):
    while b:
        a, b = b, a % b
    return a


def _lcm(a, b):
    return a * b // _gcd(a, b)
