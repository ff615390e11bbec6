"""Row-sharded band-STORAGE Floyd-Warshall + banded enrichment over a mesh.

Composes the two scaling ideas: `ops/apsp_bandstore.py` removes the dense
O(N^2) matrix (one device reaches ~100k nodes), and this module row-block shards
the skewed band over a mesh axis so both HBM *and* compute scale with the
device count — the path to many-hundred-thousand-node networks.

Per pivot round kb:

  1. the device owning ghosted block-row Kg = kb + bt extracts its (T, W)
     pivot slab; one ``pmin`` over the mesh axis broadcasts it (non-owners
     contribute +inf) — the ONLY collective, W*T floats per round;
  2. every device closes the diagonal tile (static slab column — the skew's
     payoff) and relaxes the pivot slab against it (replicated tiny work);
  3. ONLY devices whose rows intersect the pivot window [Kg-bt, Kg+bt] run the
     window relax (``lax.cond`` — a real branch), each for its
     owned subset of the 2*bt+1 window rows. Per-device phase-3 work is
     O((N/ndev) * W^2): compute scales, not just memory.

The downstream enrichment runs INSIDE the same shard_map (scores, census,
survival tail, permutation counts all contract local band rows against
replicated (N, A) operands — zero additional collectives), so the dense
(N, A)-sized arrays are the largest thing any chip ever holds.

Reference analog: none — the reference's APSP is a serial host loop
(safepy/safe.py:406-410) and its pools copy full matrices to every worker
(safe.py:510-519); here the band is partitioned, not copied.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from safepy_tpu.ops import minplus

_INF = float("inf")


def sharded_band_geometry(n: int, band: int, ndev: int, block: int = 128):
    """(bt, nb, width, g_pad, local_rows): ghosted block-row count padded to a
    device multiple (extra all-inf ghost rows at the bottom are harmless).
    bt/nb/width come from the single source of truth, band_params — the shard
    frames must stay bit-aligned with the unsharded engine's."""
    from safepy_tpu.ops.apsp_bandstore import band_params

    bt, nb, width = band_params(n, band, block)
    g = nb + 2 * bt
    g_pad = -(-g // ndev) * ndev
    return bt, nb, width, g_pad, g_pad // ndev


def band_init_local(u, v, w, my, *, n: int, bt: int, local_rows: int,
                    width: int, block: int = 128):
    """Device-local slab of the skewed FW initialization.

    u, v: permuted edge endpoints (replicated, O(E)); ``my`` the device's mesh
    index. Each device scatters only the edges whose source row it owns; the
    rest land in a scrap cell. Ghost/pad rows stay +inf."""
    s = jnp.full((local_rows * block, width), _INF, jnp.float32)

    row0 = my * local_rows * block  # first owned GHOSTED element row

    def place(rows_g, cols, vals):
        local = rows_g - row0
        keep = (local >= 0) & (local < local_rows * block) & (cols >= 0) \
            & (cols < width)
        r = jnp.where(keep, local, 0)
        c = jnp.where(keep, cols, 0)
        return r, c, jnp.where(keep, vals, jnp.inf)

    # diagonal
    i = jnp.arange(n, dtype=jnp.int32)
    r, c, vals = place(bt * block + i, (i % block) + bt * block,
                       jnp.zeros(n, jnp.float32))
    s = s.at[r, c].min(vals)

    uu = jnp.concatenate([u, v])
    vv = jnp.concatenate([v, u])
    ww = jnp.concatenate([w, w]).astype(jnp.float32)
    cols = vv - (uu // block - bt) * block
    r, c, vals = place(bt * block + uu, cols, ww)
    return s.at[r, c].min(vals)


def _band_fw_rounds(slab, my, axis, *, nb: int, bt: int, local_rows: int,
                    block: int, impl: str):
    """The pivot loop over a device-local slab (called inside shard_map)."""
    width = slab.shape[1]

    lrows = local_rows * block

    z = jnp.int32(0)

    def round_body(kb, slab):
        kg = jnp.asarray(kb, jnp.int32) + bt
        owner = kg // local_rows
        local_start = jnp.clip(kg * block - owner * lrows, 0,
                               lrows - block).astype(jnp.int32)

        p_loc = jax.lax.dynamic_slice(slab, (local_start, z), (block, width))
        p = jnp.where(my == owner, p_loc, jnp.inf)
        p = jax.lax.pmin(p, axis)

        diag = p[:, bt * block:(bt + 1) * block]
        diag = minplus.close_tile(diag, impl=impl)
        p = jax.lax.dynamic_update_slice(p, diag, (0, bt * block))
        p = minplus.relax(p, diag, p, impl=impl)

        cur = jax.lax.dynamic_slice(slab, (local_start, z), (block, width))
        upd = jnp.where(my == owner, p, cur)
        slab = jax.lax.dynamic_update_slice(slab, upd, (local_start, z))

        p_ext = jnp.pad(p, ((0, 0), (bt * block, bt * block)),
                        constant_values=_INF)

        def window_relax(slab):
            def row_body(o, slab):
                o = jnp.asarray(o, jnp.int32)
                g = kg - bt + o
                li = g * block - jnp.asarray(my, jnp.int32) * lrows
                in_range = (li >= 0) & (li < lrows)
                li_c = jnp.clip(li, 0, lrows - block).astype(jnp.int32)
                c = jax.lax.dynamic_slice(slab, (li_c, z), (block, width))
                q = jax.lax.dynamic_slice(c, (z, (2 * bt - o) * block),
                                          (block, block))
                pslice = jax.lax.dynamic_slice(p_ext, (z, o * block),
                                               (block, width))
                c2 = minplus.relax(c, q, pslice, impl=impl)
                upd = jnp.where(in_range, c2, c)
                return jax.lax.dynamic_update_slice(slab, upd, (li_c, z))

            return jax.lax.fori_loop(0, 2 * bt + 1, row_body, slab)

        participates = (kg + bt >= my * local_rows) & \
            (kg - bt < (my + 1) * local_rows)
        return jax.lax.cond(participates, window_relax, lambda s: s, slab)

    return jax.lax.fori_loop(0, nb, round_body, slab)


@functools.partial(jax.jit, static_argnames=("mesh", "axis", "n", "band",
                                             "block", "impl"))
def apsp_band_fw_sharded(s_ghosted, *, mesh: Mesh, axis: str = "data",
                         n: int, band: int, block: int = 128,
                         impl: str | None = None):
    """Band-storage FW with the ghosted skewed array row-sharded over `mesh`.

    ``s_ghosted``: ((g_pad)*block, W) from :func:`sharded_band_geometry`
    padding (extra bottom ghost rows +inf). Returns the same global frame.
    """
    impl = minplus.resolve(impl)
    ndev = mesh.shape[axis]
    bt, nb, width, g_pad, local_rows = sharded_band_geometry(
        n, band, ndev, block)
    assert s_ghosted.shape == (g_pad * block, width), (
        s_ghosted.shape, (g_pad * block, width))

    @functools.partial(jax.shard_map, mesh=mesh, check_vma=False,
                       in_specs=P(axis, None), out_specs=P(axis, None))
    def worker(slab):
        my = jax.lax.axis_index(axis)
        return _band_fw_rounds(slab, my, axis, nb=nb, bt=bt,
                               local_rows=local_rows, block=block,
                               impl=impl)

    return worker(s_ghosted)


# ---------------------------------------------------------------------------
# Local banded contractions (called inside the shard_map workers)
# ---------------------------------------------------------------------------

def _band_matmul_local(s_local, xg, my, *, bt: int, local_rows: int,
                       block: int, precision: str):
    """(local band rows) @ x: the shard's slice of ops/apsp_bandstore.band_matmul.

    xg: ghost-padded replicated operand ((npad + 2*bt*b) rows, A); the slab of
    local block-row i starts at global ghosted element (my*local_rows + i - bt)
    * b in xg, clamped — ghost rows carry all-zero indicators, so a clamped
    slab is harmless."""
    from safepy_tpu.ops.apsp_bandstore import is_packed_bits, unpack_bits_tile
    from safepy_tpu.ops.score import dot_kwargs
    kw = dot_kwargs(precision)
    packed = is_packed_bits(s_local)
    width = s_local.shape[1] * (8 if packed else 1)
    a_dim = xg.shape[1]
    z = jnp.int32(0)

    def blk(i, out):
        i = jnp.asarray(i, jnp.int32)
        rows = jax.lax.dynamic_slice(s_local, (i * block, z),
                                     (block, s_local.shape[1]))
        if packed:
            rows = unpack_bits_tile(rows)
        rows = rows.astype(jnp.float32)
        start = jnp.clip((my * local_rows + i - bt) * block, 0,
                         xg.shape[0] - width).astype(jnp.int32)
        slab = jax.lax.dynamic_slice(xg, (start, z), (width, a_dim))
        return jax.lax.dynamic_update_slice(out, jnp.dot(rows, slab, **kw),
                                            (i * block, z))

    out = jnp.zeros((local_rows * block, a_dim), jnp.float32)
    return jax.lax.fori_loop(0, local_rows, blk, out)


def _band_matmul_batch_local(s_local, x_batch, starts, my, *, bt: int,
                             local_rows: int, nb: int, block: int,
                             precision: str):
    """Batched compacted-slab contraction for the shard's rows.

    starts: (nb,) replicated valid-rank slab starts; local block-row i maps to
    global REAL block I = my*local_rows + i - bt (clamped; ghost rows are
    all-zero)."""
    from safepy_tpu.ops.apsp_bandstore import is_packed_bits, unpack_bits_tile
    from safepy_tpu.ops.score import dot_kwargs
    kw = dot_kwargs(precision)
    packed = is_packed_bits(s_local)
    w_c = s_local.shape[1] * (8 if packed else 1)
    c_dim, _, a_dim = x_batch.shape
    z = jnp.int32(0)

    def blk(i, out):
        i = jnp.asarray(i, jnp.int32)
        rows = jax.lax.dynamic_slice(s_local, (i * block, z),
                                     (block, s_local.shape[1]))
        if packed:
            rows = unpack_bits_tile(rows)
        rows = rows.astype(jnp.float32)
        gi = jnp.clip(my * local_rows + i - bt, 0, nb - 1)
        slab = jax.lax.dynamic_slice(x_batch, (z, starts[gi], z),
                                     (c_dim, w_c, a_dim))
        prod = jnp.einsum("nv,cva->cna", rows, slab, **kw)
        return jax.lax.dynamic_update_slice(out, prod, (z, i * block, z))

    out = jnp.zeros((c_dim, local_rows * block, a_dim), jnp.float32)
    return jax.lax.fori_loop(0, local_rows, blk, out)


def _band_score_local(s_local, xg_val, xg_mask, my, *, bt, local_rows, block,
                      score_type, precision):
    """Observed scores for the shard's rows (sum / z-score)."""
    from safepy_tpu.ops.score import zscore_from_contractions

    if score_type == "sum":
        return _band_matmul_local(s_local, xg_val, my, bt=bt,
                                  local_rows=local_rows, block=block,
                                  precision=precision)
    if score_type != "z-score":
        raise ValueError(f"unknown neighborhood_score_type: {score_type!r}")
    from safepy_tpu.ops.score import zscore_shift

    # xg_val/xg_mask are replicated full-column operands, so the centering
    # shift (ops.score.zscore_shift) needs no collective
    c = zscore_shift(xg_val, xg_mask)
    xv = xg_val - xg_mask * c
    stacked = jnp.concatenate([xv, xg_mask, xv * xv], axis=1)
    out = _band_matmul_local(s_local, stacked, my, bt=bt,
                             local_rows=local_rows, block=block,
                             precision=precision)
    AB, N, EXX_sum = jnp.split(out, 3, axis=1)
    return zscore_from_contractions(AB, N, EXX_sum, shift=c)


def _scan_counts_local(compact, starts, vals, mask, obs_local, key, my, *,
                       score_type, num_permutations, batch_size, bt,
                       local_rows, nb, block, precision):
    """Permutation counts for the shard's rows. Every device draws the SAME
    permutations (replicated key + operands) and contracts only its band rows
    — compute scales with the row shard, no collective needed."""
    from safepy_tpu.ops.permutation import (count_scan,
                                            permuted_operands_sorted,
                                            uses_sort_path)
    from safepy_tpu.ops.score import zscore_from_contractions

    from safepy_tpu.ops.apsp_bandstore import is_packed_bits

    V, A = vals.shape
    w_c = compact.shape[1] * (8 if is_packed_bits(compact) else 1)
    v_pad = V + w_c
    sort_path = uses_sort_path(A)
    zscore = score_type == "z-score"
    shift = None
    if zscore:
        from safepy_tpu.ops.score import zscore_shift
        shift = zscore_shift(vals, mask)
        vals = vals - mask * shift

    def chunk_scores(chunk_key):
        if sort_path:
            # sum path: the padded operand comes straight out of the ONE
            # sort (max-key zero slack rows), no post-sort full-size copy
            Bp, NBp = permuted_operands_sorted(
                vals, mask, chunk_key, batch_size, zscore,
                pad_to=None if zscore else v_pad)
        else:
            perm_keys = jax.random.split(chunk_key, batch_size)
            perm_idx = jax.vmap(
                lambda k: jax.random.permutation(k, V))(perm_keys)
            Bp = jnp.take(vals, perm_idx, axis=0)
            NBp = jnp.take(mask, perm_idx, axis=0) if zscore else None
            if not zscore:
                Bp = jnp.pad(Bp, ((0, 0), (0, v_pad - V), (0, 0)))
        mm = functools.partial(_band_matmul_batch_local, compact, starts=starts,
                               my=my, bt=bt, local_rows=local_rows, nb=nb,
                               block=block, precision=precision)
        if not zscore:
            return mm(Bp)
        stacked = jnp.concatenate([Bp, NBp, Bp * Bp], axis=-1)
        out = mm(jnp.pad(stacked, ((0, 0), (0, v_pad - V), (0, 0))))
        AB, Np, EXX_sum = jnp.split(out, 3, axis=-1)
        return zscore_from_contractions(AB, Np, EXX_sum, shift=shift)

    return count_scan(chunk_scores, obs_local, key,
                      num_permutations=num_permutations,
                      batch_size=batch_size)


def _euclid_blk_builder(coords_g, my, *, n: int, bt: int, nb: int,
                        local_rows: int, width: int, block: int):
    """blk_d(j) -> one (block, width) slab of device-local banded Euclidean
    distances — the shard's slice of
    ops/apsp_bandstore.euclidean_band_distances (explicit +inf pad masking,
    exact-0 diagonal; out-of-range slab rows of edge shards are +inf)."""
    z = jnp.int32(0)

    def blk_d(j):
        i = my * local_rows + j - bt      # real block index of this slab row
        valid = (i >= 0) & (i < nb)
        i_c = jnp.clip(i, 0, nb - 1)
        rows = jax.lax.dynamic_slice(coords_g, ((i_c + bt) * block, z),
                                     (block, 2))
        slab = jax.lax.dynamic_slice(coords_g, (i_c * block, z), (width, 2))
        diff = rows[:, None, :] - slab[None, :, :]
        d = jnp.sqrt(jnp.maximum(jnp.sum(diff * diff, axis=-1), 0.0))
        row_g = i_c * block + jnp.arange(block, dtype=jnp.int32)
        col_g = (i_c - bt) * block + jnp.arange(width, dtype=jnp.int32)
        pad = ((row_g[:, None] >= n) | (col_g[None, :] < 0)
               | (col_g[None, :] >= n))
        d = jnp.where(pad, jnp.inf, d)
        r_idx = jnp.arange(block)
        d = d.at[r_idx, r_idx + bt * block].set(
            jnp.where(row_g < n, 0.0, jnp.inf))
        return jnp.where(valid, d, jnp.inf)

    return blk_d


def _euclid_band_local(coords_g, my, *, n: int, bt: int, nb: int,
                       local_rows: int, width: int, block: int):
    """Device-local slab of banded Euclidean distances — the shard's slice of
    ops/apsp_bandstore.euclidean_band_distances (explicit +inf pad masking,
    exact-0 diagonal)."""
    blk_d = _euclid_blk_builder(coords_g, my, n=n, bt=bt, nb=nb,
                                local_rows=local_rows, width=width,
                                block=block)
    lrows = local_rows * block
    out = jnp.full((lrows, width), _INF, jnp.float32)
    z = jnp.int32(0)

    def blk(j, out):
        j = jnp.asarray(j, jnp.int32)
        return jax.lax.dynamic_update_slice(out, blk_d(j), (j * block, z))

    return jax.lax.fori_loop(0, local_rows, blk, out)


def _euclid_band_ind_local(coords_g, radius, my, *, n: int, bt: int, nb: int,
                           local_rows: int, width: int, block: int,
                           packed: bool = False):
    """Device-local strict ``dist < radius`` int8 indicator computed DIRECTLY
    (the shard's slice of ops/apsp_bandstore.euclidean_band_indicator): the
    f32 distance slab never materializes — ~1/4 the per-device peak HBM
    (~1/32 with ``packed=True``, which packs each block-row to uint8 bits)."""
    from safepy_tpu.ops.apsp_bandstore import pack_bits_tile

    blk_d = _euclid_blk_builder(coords_g, my, n=n, bt=bt, nb=nb,
                                local_rows=local_rows, width=width,
                                block=block)
    r = jnp.asarray(radius, jnp.float32)
    lrows = local_rows * block
    out = jnp.zeros((lrows, width // 8 if packed else width),
                    jnp.uint8 if packed else jnp.int8)
    z = jnp.int32(0)

    def blk(j, out):
        j = jnp.asarray(j, jnp.int32)
        ind = (blk_d(j) < r).astype(jnp.int8)
        if packed:
            ind = pack_bits_tile(ind)
        return jax.lax.dynamic_update_slice(out, ind, (j * block, z))

    return jax.lax.fori_loop(0, local_rows, blk, out)


# ---------------------------------------------------------------------------
# Fused sharded band pipelines
# ---------------------------------------------------------------------------

def _ghost_pad_cols(x, bt: int, block: int, npad: int):
    """Replicated (n, A) operand -> ghost-padded (npad + 2*bt*b, A) f32."""
    x = jnp.asarray(x, jnp.float32)
    return jnp.pad(x, ((bt * block, npad - x.shape[0] + bt * block), (0, 0)))


@functools.partial(jax.jit, static_argnames=(
    "mesh", "axis", "n", "band", "block", "score_type", "num_permutations",
    "batch_size", "w_c", "precision", "impl", "keep_distances",
    "packed"))
def fused_permutation_pipeline_band_sharded(
        u, v, w, vals, vals_valid, valid, starts, rank, key, radius, *,
        mesh: Mesh, axis: str = "data", n: int, band: int, block: int = 128,
        score_type: str = "sum", num_permutations: int = 1000,
        batch_size: int = 1000, w_c: int, precision: str = "highest",
        impl: str | None = None, keep_distances: bool = True,
        packed: bool = False):
    """Row-sharded band pipeline: init, FW, threshold, scores, null — one
    dispatch, every band-shaped array partitioned over `axis`.

    Same frames as pipeline.fused_permutation_pipeline_band; the returned
    (n, A) matrices are in the ORIGINAL node frame, the band matrices stay in
    the global ghost-padded permuted frame (sharded).

    ``keep_distances=False`` drops the masked f32 distance slab from the
    worker outputs (the per-device analog of the single-chip knob — XLA then
    frees each shard's relaxed FW slab right after thresholding); the first
    return is a (0, width) placeholder."""
    from safepy_tpu.ops.apsp_bandstore import (apply_compaction,
                                               band_row_sizes, band_threshold)

    impl = minplus.resolve(impl)
    ndev = mesh.shape[axis]
    bt, nb, width, g_pad, local_rows = sharded_band_geometry(
        n, band, ndev, block)
    npad = nb * block

    mask_valid = jnp.isfinite(jnp.asarray(vals_valid, jnp.float32)) \
        .astype(jnp.float32)
    vv = jnp.where(mask_valid > 0, jnp.asarray(vals_valid, jnp.float32), 0.0)
    finite = jnp.isfinite(jnp.asarray(vals, jnp.float32))
    xg_val = _ghost_pad_cols(jnp.where(finite, jnp.asarray(vals, jnp.float32),
                                       0.0), bt, block, npad)
    xg_mask = _ghost_pad_cols(finite.astype(jnp.float32), bt, block, npad)

    dist_spec = (P(axis, None),) if keep_distances else ()

    @functools.partial(
        jax.shard_map, mesh=mesh, check_vma=False,
        in_specs=(P(), P(), P(), P(), P(), P(), P(), P(), P()),
        out_specs=dist_spec + (P(axis, None), P(axis),
                               P(axis, None), P(axis, None), P(axis, None)))
    def worker(u, v, w, xg_val, xg_mask, valid, starts, vv_mask, key):
        vv_, mask_ = vv_mask
        my = jax.lax.axis_index(axis)
        slab = band_init_local(u, v, w, my, n=n, bt=bt,
                               local_rows=local_rows, width=width,
                               block=block)
        slab = _band_fw_rounds(slab, my, axis, nb=nb, bt=bt,
                               local_rows=local_rows, block=block,
                               impl=impl)
        # packed=True stores the shard's indicator BIT-packed (8 cells/byte;
        # ops/apsp_bandstore.is_packed_bits) — dtype-keyed consumers below
        ind = band_threshold(slab, radius, packed=packed, block=block)
        sizes_local = band_row_sizes(ind)
        obs_local = _band_score_local(ind, xg_val, xg_mask, my, bt=bt,
                                      local_rows=local_rows, block=block,
                                      score_type=score_type,
                                      precision=precision)
        compact = apply_compaction(ind, valid, w_c, bt=bt, block=block,
                                   row_block_offset=my * local_rows)
        cn, cp = _scan_counts_local(
            compact, starts, vv_, mask_, obs_local, key, my,
            score_type=score_type, num_permutations=num_permutations,
            batch_size=batch_size, bt=bt, local_rows=local_rows, nb=nb,
            block=block, precision=precision)
        if not keep_distances:
            return ind, sizes_local, obs_local, cn, cp
        dist_local = jnp.where(slab <= jnp.asarray(radius, slab.dtype), slab,
                               jnp.inf)
        return dist_local, ind, sizes_local, obs_local, cn, cp

    out = worker(u, v, w, xg_val, xg_mask, jnp.asarray(valid), starts,
                 (vv, mask_valid), key)
    if keep_distances:
        dist_g, ind_g, sizes_g, obs_g, cn_g, cp_g = out
    else:
        ind_g, sizes_g, obs_g, cn_g, cp_g = out
        dist_g = jnp.zeros((0, width), jnp.float32)

    sizes = jax.lax.dynamic_slice_in_dim(sizes_g, bt * block, npad, 0)[:n]
    mean, std = jnp.mean(sizes), jnp.std(sizes)
    real = lambda x: jax.lax.dynamic_slice_in_dim(x, bt * block, npad, 0)
    take = functools.partial(jnp.take, indices=rank, axis=0)
    return (dist_g, ind_g, take(real(obs_g)), take(real(cn_g)),
            take(real(cp_g)), mean, std)


@functools.partial(jax.jit, static_argnames=(
    "mesh", "axis", "n", "band", "block", "iterations", "precision",
    "impl"))
def fused_hypergeom_pipeline_band_sharded(
        u, v, w, nan0, nodes_not_nan, K, lgt, M, radius,
        enrichment_threshold, rank, *,
        mesh: Mesh, axis: str = "data", n: int, band: int, block: int = 128,
        iterations: int, precision: str = "highest",
        impl: str | None = None):
    """Row-sharded band pipeline, hypergeometric engine: census + survival
    tail per shard, no collectives after the FW's pivot pmin. Operands are
    host-precomputed like fused_hypergeom_pipeline_band's; like it, NES is
    not returned — the facade derives -logsf/ln10 lazily."""
    from safepy_tpu.ops.hypergeom import _sf_parts, finalize_logsf_device

    impl = minplus.resolve(impl)
    ndev = mesh.shape[axis]
    bt, nb, width, g_pad, local_rows = sharded_band_geometry(
        n, band, ndev, block)
    npad = nb * block

    nan0 = jnp.asarray(nan0, jnp.float32)
    nodes_not_nan = jnp.asarray(nodes_not_nan, jnp.float32)
    stacked_g = _ghost_pad_cols(
        jnp.concatenate([nodes_not_nan[:, None], nan0], axis=1),
        bt, block, npad)

    @functools.partial(
        jax.shard_map, mesh=mesh, check_vma=False,
        in_specs=(P(), P(), P(), P(), P(), P()),
        out_specs=(P(axis, None), P(axis, None), P(axis),
                   P(axis, None), P(axis, None)))
    def worker(u, v, w, stacked_g, K, lgt):
        my = jax.lax.axis_index(axis)
        slab = band_init_local(u, v, w, my, n=n, bt=bt,
                               local_rows=local_rows, width=width,
                               block=block)
        slab = _band_fw_rounds(slab, my, axis, nb=nb, bt=bt,
                               local_rows=local_rows, block=block,
                               impl=impl)
        dist_local = jnp.where(slab <= jnp.asarray(radius, slab.dtype), slab,
                               jnp.inf)
        ind = (slab <= jnp.asarray(radius, slab.dtype)).astype(jnp.int8)
        sizes_local = jnp.sum(ind, axis=1, dtype=jnp.float32)
        prod = _band_matmul_local(ind, stacked_g, my, bt=bt,
                                  local_rows=local_rows, block=block,
                                  precision=precision)
        nsize = prod[:, 0]
        counts = prod[:, 1:]
        k64 = counts.astype(jnp.float64)
        K64 = jnp.broadcast_to(K.astype(jnp.float64)[None, :], counts.shape)
        n64 = jnp.broadcast_to(nsize.astype(jnp.float64)[:, None],
                               counts.shape)
        parts = _sf_parts(k64, M, K64, n64, lgt, iterations)
        _nes, log_sf32, nes_binary = finalize_logsf_device(
            parts, enrichment_threshold)
        return dist_local, ind, sizes_local, log_sf32, nes_binary

    dist_g, ind_g, sizes_g, logsf_g, bin_g = worker(
        u, v, w, stacked_g, K, lgt)

    sizes = jax.lax.dynamic_slice_in_dim(sizes_g, bt * block, npad, 0)[:n]
    mean, std = jnp.mean(sizes), jnp.std(sizes)
    real = lambda x: jax.lax.dynamic_slice_in_dim(x, bt * block, npad, 0)
    enriched_counts = jnp.sum(real(bin_g)[:n], axis=0, dtype=jnp.int32)
    take = functools.partial(jnp.take, indices=rank, axis=0)
    return (dist_g, ind_g, take(real(logsf_g)),
            take(real(bin_g)), enriched_counts, mean, std)


# ---------------------------------------------------------------------------
# Sharded band front halves + the sharded class-table hypergeometric driver
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("mesh", "axis", "n", "band",
                                             "block", "impl", "packed"))
def band_neighborhoods_sharded(u, v, w, radius, *, mesh: Mesh,
                               axis: str = "data", n: int, band: int,
                               block: int = 128, impl: str | None = None,
                               packed: bool = False):
    """Row-sharded band FW front half: (dist_g, ind_g, sizes_g, mean, std).

    The band matrices stay sharded over `axis` in the global ghost-padded
    permuted frame; downstream drivers keep operating on them shard-wise
    (``packed=True`` stores each shard's indicator BIT-packed — dtype-keyed,
    see ops/apsp_bandstore.is_packed_bits)."""
    from safepy_tpu.ops.apsp_bandstore import band_row_sizes, band_threshold

    impl = minplus.resolve(impl)
    ndev = mesh.shape[axis]
    bt, nb, width, g_pad, local_rows = sharded_band_geometry(
        n, band, ndev, block)
    npad = nb * block

    @functools.partial(
        jax.shard_map, mesh=mesh, check_vma=False,
        in_specs=(P(), P(), P()),
        out_specs=(P(axis, None), P(axis, None), P(axis)))
    def worker(u, v, w):
        my = jax.lax.axis_index(axis)
        slab = band_init_local(u, v, w, my, n=n, bt=bt,
                               local_rows=local_rows, width=width,
                               block=block)
        slab = _band_fw_rounds(slab, my, axis, nb=nb, bt=bt,
                               local_rows=local_rows, block=block,
                               impl=impl)
        dist_local = jnp.where(slab <= jnp.asarray(radius, slab.dtype), slab,
                               jnp.inf)
        ind = band_threshold(slab, radius, packed=packed, block=block)
        sizes_local = band_row_sizes(ind)
        return dist_local, ind, sizes_local

    dist_g, ind_g, sizes_g = worker(u, v, w)
    sizes = jax.lax.dynamic_slice_in_dim(sizes_g, bt * block, npad, 0)[:n]
    return dist_g, ind_g, sizes_g, jnp.mean(sizes), jnp.std(sizes)


@functools.partial(jax.jit, static_argnames=("mesh", "axis", "n", "band",
                                             "block", "precision"))
def band_matmul_sharded(ind_g, x, *, mesh: Mesh, axis: str = "data", n: int,
                        band: int, block: int = 128,
                        precision: str = "highest"):
    """(sharded banded indicator) @ x for a replicated (n, A) operand —
    returns the ghosted global product, rows sharded over `axis`."""
    ndev = mesh.shape[axis]
    bt, nb, width, g_pad, local_rows = sharded_band_geometry(
        n, band, ndev, block)
    npad = nb * block
    xg = _ghost_pad_cols(x, bt, block, npad)

    @functools.partial(jax.shard_map, mesh=mesh, check_vma=False,
                       in_specs=(P(axis, None), P()),
                       out_specs=P(axis, None))
    def worker(ind_local, xg):
        my = jax.lax.axis_index(axis)
        return _band_matmul_local(ind_local, xg, my, bt=bt,
                                  local_rows=local_rows, block=block,
                                  precision=precision)

    return worker(ind_g, xg)


@functools.partial(jax.jit, static_argnames=(
    "mesh", "axis", "R", "S_max", "C", "n", "band", "block", "precision",
    "lookup_group"))
def _band_table_chunk_sharded(ind_g, cols, nsize_g, K_dist, colc, M,
                              log_thr64, rank, *, mesh: Mesh, axis: str,
                              R: int, S_max: int, C: int, n: int, band: int,
                              block: int, precision: str,
                              lookup_group: int = 8):
    """One K-sorted column chunk of the sharded class-table engine: local
    banded census + replicated table build + local lookup; outputs
    un-permuted to the ORIGINAL node frame (resharded by the row gather).
    ``cols`` may be int8 (cast to f32 per shard inside the worker); the
    unused NES output is dead-code-eliminated."""
    from safepy_tpu.ops import hypergeom_table as htab

    ndev = mesh.shape[axis]
    bt, nb, width, g_pad, local_rows = sharded_band_geometry(
        n, band, ndev, block)
    npad = nb * block
    cols_g = _ghost_pad_cols(cols, bt, block, npad)

    @functools.partial(
        jax.shard_map, mesh=mesh, check_vma=False,
        in_specs=(P(axis, None), P(), P(axis), P(), P()),
        out_specs=(P(axis, None),) * 2)
    def worker(ind_local, cols_g, nsize_local, K_dist, colc):
        my = jax.lax.axis_index(axis)
        counts = _band_matmul_local(ind_local, cols_g.astype(jnp.float32),
                                    my, bt=bt,
                                    local_rows=local_rows, block=block,
                                    precision=precision)
        table = htab.build_logsf_table(K_dist, M, log_thr64, R=R,
                                       S_max=S_max, C=C)
        _nes, logsf, nbin = htab.table_lookup(
            table, counts, nsize_local, colc,
            jnp.asarray(log_thr64, jnp.float32), S_max=S_max, R=R, C=C,
            lookup_group=lookup_group)
        return logsf, nbin

    logsf_g, bin_g = worker(ind_g, cols_g, nsize_g, K_dist, colc)
    real = lambda x: jax.lax.dynamic_slice_in_dim(x, bt * block, npad, 0)
    take = functools.partial(jnp.take, indices=rank, axis=0)
    return take(real(logsf_g)), take(real(bin_g))


def hypergeom_band_table_sharded(ind_g, nan0_np,
                                 nodes_not_nan_np, M, enrichment_threshold, *,
                                 mesh: Mesh, axis: str = "data", n: int,
                                 band: int, block: int = 128, rank_np,
                                 precision: str = "highest",
                                 chunk_cols: int = 1024, K_np=None,
                                 lookup_group: int = 8):
    """Sharded counterpart of ops/enrich_band.hypergeom_band_table.

    Multi-dispatch: nsize (one sharded banded matvec + a scalar download for
    the table row bound), then one sharded census+table+lookup dispatch per
    K-sorted column chunk — each step short, so no per-device fused program
    ever runs near remote-worker watchdog horizons (this retires the old
    "prefer mesh=None at GO scale" warning). Returns (logsf, bin, counts_np)
    in ORIGINAL column order / node frame, or None if the plan is ineligible
    (caller falls back to the f64 tail loop). ``nan0_np`` may be f32 or int8
    (exact for the binary annotations this engine requires); NES derives
    lazily from logsf in the facade — see
    ops/enrich_band.hypergeom_band_table."""
    from safepy_tpu.ops import hypergeom_table as htab

    nan0_dev = jnp.asarray(nan0_np)
    if K_np is None:
        # column-chunked exact sums: the eager astype(f32) this replaces
        # materializes a full 4 B/cell copy of the int8 annotations (see
        # ops/enrich_band._column_sums_chunked)
        from safepy_tpu.ops.enrich_band import _column_sums_chunked
        K_np = _column_sums_chunked(nan0_dev)
    else:
        K_np = np.asarray(K_np)
    nsize_g = band_matmul_sharded(
        ind_g, jnp.asarray(nodes_not_nan_np)[:, None], mesh=mesh, axis=axis,
        n=n, band=band, block=block, precision=precision)[:, 0]
    n_max = float(jnp.max(nsize_g))
    plan = htab.plan(K_np, n_max, int(M), chunk_cols=chunk_cols)
    if plan is None:
        return None

    log_thr64 = float(np.log(enrichment_threshold))
    rank_dev = jnp.asarray(rank_np, jnp.int32)
    n_attrs = nan0_dev.shape[1]

    # natural-order chunks stream into preallocated donated outputs (see
    # ops/enrich_band.hypergeom_band_table: transient pieces+concat tripled
    # the output footprint and thrashed the allocator at 100k x 4,373).
    # The outputs are EXPLICITLY row-sharded: GSPMD's default for the
    # eager-gathered chunk results is full replication (measured on the
    # virtual mesh), which would put the whole 7.6 GB result pair on every
    # shard — exactly what the per-shard HBM plan forbids.
    row_sharded = jax.NamedSharding(mesh, P(axis, None))
    alloc = jax.jit(
        lambda: (jnp.zeros((n, n_attrs), jnp.float32),
                 jnp.zeros((n, n_attrs), jnp.int8)),
        out_shardings=(row_sharded, row_sharded))
    place = jax.jit(
        lambda lo, bi, lc, bc, s: (
            jax.lax.dynamic_update_slice(lo, lc, (jnp.int32(0), s)),
            jax.lax.dynamic_update_slice(bi, bc, (jnp.int32(0), s))),
        donate_argnums=(0, 1), out_shardings=(row_sharded, row_sharded))
    logsf, nbin = alloc()
    counts = []
    for ch in plan["chunks"]:
        start, width_c = ch["start"], ch["width"]
        cols = jax.lax.dynamic_slice_in_dim(nan0_dev, start, width_c, 1)
        logsf_c, bin_c = _band_table_chunk_sharded(
            ind_g, cols, nsize_g, jnp.asarray(ch["K_dist"]),
            jnp.asarray(ch["colc"], jnp.int32), M, log_thr64, rank_dev,
            mesh=mesh, axis=axis, R=ch["R"], S_max=ch["S_max"], C=ch["C"],
            n=n, band=band, block=block, precision=precision,
            lookup_group=int(lookup_group))
        del cols
        # unified tail chunks re-window backwards; trim the recomputed
        # overlap columns from the counts (placement overwrites in place)
        counts.append(np.asarray(
            jnp.sum(bin_c, axis=0, dtype=jnp.int32))[ch.get("overlap", 0):])
        logsf, nbin = place(logsf, nbin, logsf_c, bin_c,
                            jnp.asarray(start, jnp.int32))
        # free the chunk outputs as soon as the queued placement consumes
        # them (the last chunk's would otherwise survive until return)
        del logsf_c, bin_c
    return logsf, nbin, np.concatenate(counts)


@functools.partial(jax.jit, static_argnames=(
    "mesh", "axis", "n", "band", "block", "score_type", "num_permutations",
    "batch_size", "w_c", "precision", "keep_distances", "packed"))
def fused_permutation_pipeline_band_euclid_sharded(
        coords_perm, vals, vals_valid, valid, starts, rank, key, radius, *,
        mesh: Mesh, axis: str = "data", n: int, band: int, block: int = 128,
        score_type: str = "sum", num_permutations: int = 1000,
        batch_size: int = 1000, w_c: int, precision: str = "highest",
        keep_distances: bool = True, packed: bool = False):
    """Row-sharded euclidean band pipeline (scatter/UMAP flagship): banded
    direct coordinate distances per shard (strict ``dist < r``, reference
    safe.py:389-399) + the sharded permutation null — the euclidean metric's
    mesh path (previously single-chip only).

    ``keep_distances=False`` builds each shard's int8 indicator DIRECTLY
    (_euclid_band_ind_local — the f32 slab never exists, ~1/4 the per-device
    peak); ``packed=True`` stores it BIT-packed (1/32); the first return is a
    (0, width) placeholder."""
    from safepy_tpu.ops.apsp_bandstore import apply_compaction, band_row_sizes

    ndev = mesh.shape[axis]
    bt, nb, width, g_pad, local_rows = sharded_band_geometry(
        n, band, ndev, block)
    npad = nb * block

    coords_g = jnp.zeros((npad + 2 * bt * block, 2), jnp.float32)
    coords_g = jax.lax.dynamic_update_slice(
        coords_g, jnp.asarray(coords_perm, jnp.float32), (bt * block, 0))
    mask_valid = jnp.isfinite(jnp.asarray(vals_valid, jnp.float32)) \
        .astype(jnp.float32)
    vv = jnp.where(mask_valid > 0, jnp.asarray(vals_valid, jnp.float32), 0.0)
    finite = jnp.isfinite(jnp.asarray(vals, jnp.float32))
    xg_val = _ghost_pad_cols(jnp.where(finite, jnp.asarray(vals, jnp.float32),
                                       0.0), bt, block, npad)
    xg_mask = _ghost_pad_cols(finite.astype(jnp.float32), bt, block, npad)

    dist_spec = (P(axis, None),) if keep_distances else ()

    @functools.partial(
        jax.shard_map, mesh=mesh, check_vma=False,
        in_specs=(P(), P(), P(), P(), P(), P(), P()),
        out_specs=dist_spec + (P(axis, None), P(axis),
                               P(axis, None), P(axis, None), P(axis, None)))
    def worker(coords_g, xg_val, xg_mask, valid, starts, vv_mask, key):
        vv_, mask_ = vv_mask
        my = jax.lax.axis_index(axis)
        if keep_distances:
            raw = _euclid_band_local(coords_g, my, n=n, bt=bt, nb=nb,
                                     local_rows=local_rows, width=width,
                                     block=block)
            r = jnp.asarray(radius, raw.dtype)
            dist_local = jnp.where(raw < r, raw, jnp.inf)
            ind = (raw < r).astype(jnp.int8)
        else:
            ind = _euclid_band_ind_local(coords_g, radius, my, n=n, bt=bt,
                                         nb=nb, local_rows=local_rows,
                                         width=width, block=block,
                                         packed=packed)
        sizes_local = band_row_sizes(ind)
        obs_local = _band_score_local(ind, xg_val, xg_mask, my, bt=bt,
                                      local_rows=local_rows, block=block,
                                      score_type=score_type,
                                      precision=precision)
        compact = apply_compaction(ind, valid, w_c, bt=bt, block=block,
                                   row_block_offset=my * local_rows)
        cn, cp = _scan_counts_local(
            compact, starts, vv_, mask_, obs_local, key, my,
            score_type=score_type, num_permutations=num_permutations,
            batch_size=batch_size, bt=bt, local_rows=local_rows, nb=nb,
            block=block, precision=precision)
        if not keep_distances:
            return ind, sizes_local, obs_local, cn, cp
        return dist_local, ind, sizes_local, obs_local, cn, cp

    out = worker(coords_g, xg_val, xg_mask, jnp.asarray(valid), starts,
                 (vv, mask_valid), key)
    if keep_distances:
        dist_g, ind_g, sizes_g, obs_g, cn_g, cp_g = out
    else:
        ind_g, sizes_g, obs_g, cn_g, cp_g = out
        dist_g = jnp.zeros((0, width), jnp.float32)

    sizes = jax.lax.dynamic_slice_in_dim(sizes_g, bt * block, npad, 0)[:n]
    mean, std = jnp.mean(sizes), jnp.std(sizes)
    real = lambda x: jax.lax.dynamic_slice_in_dim(x, bt * block, npad, 0)
    take = functools.partial(jnp.take, indices=rank, axis=0)
    return (dist_g, ind_g, take(real(obs_g)), take(real(cn_g)),
            take(real(cp_g)), mean, std)
