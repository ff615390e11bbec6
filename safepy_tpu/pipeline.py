"""Fused single-dispatch pipelines: graph in, enrichment out, one jit call.

The stage-based facade issues one device dispatch per pipeline stage, each
with its own host round trip. These fused programs run APSP -> threshold ->
scores -> null in ONE compiled computation, returning the device-resident
matrices plus the scalar stats:

  * :func:`fused_permutation_pipeline` — shortest-path neighborhoods + two-sided
    permutation null (the Example_1 / default workflow);
  * :func:`fused_hypergeom_pipeline` — shortest-path neighborhoods + the census
    matmuls and survival-function tail parts for binary annotation matrices.

Both accept an optional ``mesh`` and then compose the multi-device shards into the
SAME single dispatch: the Floyd-Warshall rounds row-sharded over the 'data' axis
(pivot panels pmin-broadcast), the permutation batch sharded over every
mesh axis with psum count reduction, and the hypergeometric tail column-sharded
over an 'attr' axis — the reference's two pool parallelisms (safepy/safe.py:501-519
and 1335-1355) as collectives inside one program instead of process boundaries.

``SAFE.run_pipeline`` drives these and then populates the same instance
attributes the stage methods produce.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from safepy_tpu.ops import minplus
from safepy_tpu.ops.apsp import apsp_blocked_fw, pad_distances
from safepy_tpu.ops.hypergeom import _sf_parts, finalize_logsf_device
from safepy_tpu.ops.neighborhoods import threshold_and_stats
from safepy_tpu.ops.permutation import prepare_valid, scan_counts
from safepy_tpu.ops.score import compute_neighborhood_score

_DOT_KW = dict(precision=jax.lax.Precision.HIGHEST,
               preferred_element_type=jnp.float32)


def _apsp_inline(d0, block, mesh=None, data_axis="data", window=None,
                 inv_rank=None, radius=None, impl=None):
    """FW distances inside a fused program: radius-bounded banded FW when the
    caller certified a band (see ops/apsp_banded.py), 2-D block-sharded over a
    (row, col) mesh, row-sharded over `data_axis`, dense blocked FW otherwise.
    Tile relaxations run through ops/minplus.py (``impl``: see
    minplus.resolve)."""
    impl = minplus.resolve(impl)
    sharded = mesh is not None and (
        data_axis in mesh.shape
        or ("row" in mesh.shape and "col" in mesh.shape))
    if window is not None and not sharded:
        from safepy_tpu.ops.apsp_banded import apsp_banded_unpermuted

        dist = apsp_banded_unpermuted(d0, inv_rank, radius, window=window,
                                      block=block, impl=impl)
        # materialize the un-permuted matrix ONCE: without the barrier XLA can
        # sink the gather+transpose chain into downstream consumers (e.g. the
        # permutation-count scan) and re-evaluate it per chunk
        return jax.lax.optimization_barrier(dist)
    if mesh is not None and "row" in mesh.shape and "col" in mesh.shape:
        from safepy_tpu.parallel.apsp_sharded_2d import _apsp_sharded_2d_impl
        from safepy_tpu.parallel.apsp_sharded_2d import _lcm

        n = d0.shape[0]
        unit = _lcm(block * mesh.shape["row"], block * mesh.shape["col"])
        d = pad_distances(d0, unit)
        out = _apsp_sharded_2d_impl(d, mesh=mesh, row_axis="row",
                                    col_axis="col", block=block,
                                    impl=impl)
        return out[:n, :n]
    if mesh is not None and data_axis in mesh.shape:
        from safepy_tpu.parallel.apsp_sharded import _apsp_sharded_impl

        n = d0.shape[0]
        d = pad_distances(d0, block * mesh.shape[data_axis])
        out = _apsp_sharded_impl(d, mesh=mesh, axis=data_axis, block=block,
                                 impl=impl)
        return out[:n, :n]
    # the facade only reaches here with undirected-graph distances
    return apsp_blocked_fw(d0, block=block, symmetric=True, impl=impl)


def _sharded_null(nbr_valid, vals, mask, obs, key, mesh, *, score_type,
                  per_device, batch_size, precision):
    """Permutation counts sharded over every mesh axis, psum-reduced."""
    axes = tuple(mesh.axis_names)
    ndev = 1
    for a in axes:
        ndev *= mesh.shape[a]
    keys = jax.random.split(key, ndev)

    @functools.partial(jax.shard_map, mesh=mesh,
                       in_specs=(P(), P(), P(), P(), P(axes)),
                       out_specs=(P(), P()))
    def worker(nbr_valid, vals, mask, obs, key_slice):
        cn, cp = scan_counts(nbr_valid, vals, mask, obs, key_slice[0],
                             score_type=score_type, num_permutations=per_device,
                             batch_size=batch_size, precision=precision)
        return jax.lax.psum(cn, axes), jax.lax.psum(cp, axes)

    return worker(nbr_valid, vals, mask, obs, keys)


@functools.partial(jax.jit, static_argnames=(
    "score_type", "num_permutations", "batch_size", "strict", "block",
    "precision", "mesh", "window", "impl"))
def fused_permutation_pipeline(d0, vals, valid_rows, key, radius, *,
                               score_type: str = "sum",
                               num_permutations: int = 1000,
                               batch_size: int = 1000,
                               strict: bool = False, block: int = 128,
                               precision: str = "highest", mesh=None,
                               window=None, inv_rank=None, impl=None):
    """APSP + neighborhoods + observed scores + permutation counts, one dispatch.

    With a mesh, ``num_permutations`` is the PER-DEVICE count (the facade rounds
    the total up to a device multiple, like the reference rounds to its worker
    count, safe.py:503-504). With a `window`, `d0` is in the banded order and
    `inv_rank` maps back to the node frame. Returns (dist, nbr, obs,
    counts_neg, counts_pos, mean_size, std_size); the matrices stay on device.
    """
    dist = _apsp_inline(d0, block, mesh, window=window, inv_rank=inv_rank,
                        radius=radius, impl=impl)
    nbr, mean, std = threshold_and_stats(dist, radius, strict=strict)
    obs = compute_neighborhood_score(nbr, vals, score_type, precision)
    nbr_valid, v, m = prepare_valid(nbr, vals, valid_rows)
    if mesh is None:
        counts_neg, counts_pos = scan_counts(
            nbr_valid, v, m, obs, key, score_type=score_type,
            num_permutations=num_permutations, batch_size=batch_size,
            precision=precision)
    else:
        counts_neg, counts_pos = _sharded_null(
            nbr_valid, v, m, obs, key, mesh, score_type=score_type,
            per_device=num_permutations, batch_size=batch_size,
            precision=precision)
    return dist, nbr, obs, counts_neg, counts_pos, mean, std


def _hypergeom_tail(nbr, vals, lgt, M, enrichment_threshold, *, iterations,
                    mesh=None, attr_axis="attr", table_K_dist=None,
                    table_colc=None, table_spec=None):
    """Census matmuls + survival tail + device finalization; columns sharded over
    `attr_axis` when the mesh has one (reference CLI column parallelism,
    safe.py:1335-1355, with zero inter-device traffic).

    With ``table_spec = (R, S_max, C)`` (plus the matching ``table_K_dist`` /
    ``table_colc`` operands) the survival values come from the class-table
    engine (ops/hypergeom_table.py) instead of the per-cell f64 tail loop —
    the binary-annotation fast path that keeps the whole pipeline a single
    dispatch (the table's row axis covers every possible neighborhood size)."""
    finite = jnp.isfinite(vals)
    nan0 = jnp.where(finite, vals, 0.0).astype(jnp.float32)
    nodes_not_nan = jnp.any(finite, axis=1).astype(jnp.float32)

    def tail(nbr, nan0_cols, nodes_not_nan, lgt, colc):
        nsize = jnp.dot(nbr, nodes_not_nan, **_DOT_KW)
        counts = jnp.dot(nbr, nan0_cols, **_DOT_KW)
        if table_spec is not None:
            from safepy_tpu.ops import hypergeom_table as htab
            r, s_max, c = table_spec
            log_thr64 = jnp.log(jnp.asarray(enrichment_threshold,
                                            jnp.float64))
            table = htab.build_logsf_table(table_K_dist, M, log_thr64,
                                           R=r, S_max=s_max, C=c)
            return htab.table_lookup(table, counts, nsize, colc,
                                     log_thr64.astype(jnp.float32),
                                     S_max=s_max, R=r, C=c)
        K = jnp.sum(nan0_cols, axis=0)
        k64 = counts.astype(jnp.float64)
        K64 = jnp.broadcast_to(K.astype(jnp.float64)[None, :], counts.shape)
        n64 = jnp.broadcast_to(nsize.astype(jnp.float64)[:, None], counts.shape)
        parts = _sf_parts(k64, M, K64, n64, lgt, iterations)
        return finalize_logsf_device(parts, enrichment_threshold)

    if table_colc is None:
        table_colc = jnp.zeros((nan0.shape[1],), jnp.int32)
    if mesh is None or attr_axis not in mesh.shape:
        return tail(nbr, nan0, nodes_not_nan, lgt, table_colc)

    num_attrs = nan0.shape[1]
    pad = (-num_attrs) % mesh.shape[attr_axis]
    if pad:
        nan0 = jnp.pad(nan0, ((0, 0), (0, pad)))
        table_colc = jnp.pad(table_colc, ((0, pad),))

    worker = jax.shard_map(
        tail, mesh=mesh,
        in_specs=(P(), P(None, attr_axis), P(), P(), P(attr_axis)),
        out_specs=(P(None, attr_axis),) * 3)
    nes32, log_sf32, nes_binary = worker(nbr, nan0, nodes_not_nan, lgt,
                                         table_colc)
    return (nes32[:, :num_attrs], log_sf32[:, :num_attrs],
            nes_binary[:, :num_attrs])


@functools.partial(jax.jit, static_argnames=("iterations", "strict", "block",
                                             "mesh", "window", "table_spec",
                                             "impl"))
def fused_hypergeom_pipeline(d0, vals, lgt, M, radius, enrichment_threshold, *,
                             iterations: int, strict: bool = False,
                             block: int = 128, mesh=None,
                             window=None, inv_rank=None, table_K_dist=None,
                             table_colc=None, table_spec=None, impl=None):
    """APSP + neighborhoods + hypergeometric enrichment, one dispatch.

    vals: (N, A) with NaNs. Returns (dist, nbr, nes_f32, log_sf_f32,
    nes_binary_int8, mean_size, std_size). p-values come from host-side
    ``exp(float64(log_sf))`` — see ops/hypergeom.finalize_logsf_device for the
    precision recipe; the N x N matrices stay on device and the downloads are
    two f32 (N, A) matrices plus an int8 indicator.
    """
    dist = _apsp_inline(d0, block, mesh, window=window, inv_rank=inv_rank,
                        radius=radius, impl=impl)
    nbr, mean, std = threshold_and_stats(dist, radius, strict=strict)
    nes32, log_sf32, nes_binary = _hypergeom_tail(
        nbr, vals, lgt, M, enrichment_threshold, iterations=iterations,
        mesh=mesh, table_K_dist=table_K_dist, table_colc=table_colc,
        table_spec=table_spec)
    # per-attribute enriched counts reduced ON DEVICE: workflows that only need
    # the counts (GO-scale batch) skip the (N, A) indicator download entirely
    enriched_counts = jnp.sum(nes_binary, axis=0, dtype=jnp.int32)
    return dist, nbr, nes32, log_sf32, nes_binary, enriched_counts, mean, std


# ---------------------------------------------------------------------------
# Band-STORAGE pipelines: O(N*W) memory end to end (huge networks)
# ---------------------------------------------------------------------------

def _band_front(u, v, w, radius, *, n, band, block, bf_slots=None,
                bf_max_iters=0, packed=False, impl=None):
    """Shared front half: init -> band relax -> radius mask -> indicator/stats.

    The relaxation engine is FW (ops/apsp_bandstore.apsp_band_fw) unless
    ``bf_slots = (nbr, dlt, wgt)`` is given, in which case the sparse
    Bellman-Ford engine runs with ``bf_max_iters`` as its budget. Returns an
    extra ``converged`` scalar (constant True on the FW path); callers MUST
    re-dispatch with FW when it comes back False — the band then holds upper
    bounds, not final distances. ``packed=True`` emits the BIT-packed uint8
    indicator (ops/apsp_bandstore.is_packed_bits).
    """
    from safepy_tpu.ops import apsp_bandstore as bst

    bt = band // block + 1
    s = bst.band_init_from_edges(u, v, w, n=n, band=band, block=block)
    if bf_slots is not None:
        nbr, dlt, wgt = bf_slots
        s, converged, _ = bst.apsp_band_bf(
            s, nbr, dlt, wgt, jnp.asarray(radius, s.dtype), bt=bt,
            block=block, max_iters=bf_max_iters)
    else:
        s = bst.apsp_band_fw(s, bt=bt, block=block, impl=impl)
        converged = jnp.bool_(True)
    # beyond-radius entries are upper bounds, not exact — mask them to inf
    # exactly as the reference's Dijkstra cutoff never yields them (safe.py:406)
    dist_band = jnp.where(s <= jnp.asarray(radius, s.dtype), s, jnp.inf)
    s_ind = bst.band_threshold(s, radius, packed=packed, block=block)
    _, mean, std = bst.band_row_stats(s_ind, n=n, bt=bt, block=block)
    return dist_band, s_ind, mean, std, bt, converged


@functools.partial(jax.jit, static_argnames=("n", "band", "block",
                                             "keep_distances", "packed"))
def euclidean_band_neighborhoods(coords_perm, radius, *, n: int, band: int,
                                 block: int = 128, keep_distances: bool = True,
                                 packed: bool = False):
    """Banded euclidean neighborhoods (strict ``dist < r``, reference
    safe.py:389-399) for scatter/UMAP inputs at band-storage scale:
    (dist_band, s_ind, mean_size, std_size) in the permuted frame.

    ``keep_distances=False`` computes the int8 indicator DIRECTLY
    (ops/apsp_bandstore.euclidean_band_indicator): the f32 distance band
    never materializes, so peak memory is ~1/4 of the keep path.
    ``packed=True`` (requires keep_distances=False) stores it BIT-packed
    (uint8, 8 cells/byte — ops/apsp_bandstore.is_packed_bits): 1/32 of the
    f32 band, the lever past ~1M points."""
    from safepy_tpu.ops import apsp_bandstore as bst

    bt = band // block + 1
    if keep_distances:
        raw = bst.euclidean_band_distances(coords_perm, n=n, band=band,
                                           block=block)
        r = jnp.asarray(radius, raw.dtype)
        dist_band = jnp.where(raw < r, raw, jnp.inf)
        s_ind = (raw < r).astype(jnp.int8)
    else:
        s_ind = bst.euclidean_band_indicator(coords_perm, radius, n=n,
                                             band=band, block=block,
                                             packed=packed)
        dist_band = jnp.zeros((0, s_ind.shape[1]), jnp.float32)
    _, mean, std = bst.band_row_stats(s_ind, n=n, bt=bt, block=block)
    return dist_band, s_ind, mean, std


@functools.partial(jax.jit, static_argnames=("n", "band", "block",
                                             "bf_max_iters", "packed", "impl"))
def band_neighborhoods(u, v, w, radius, *, n: int, band: int, block: int = 128,
                       bf_slots=None, bf_max_iters: int = 0,
                       packed: bool = False, impl=None):
    """Band-storage neighborhoods alone (the staged define_neighborhoods path):
    (dist_band, s_ind, mean_size, std_size, converged) in the permuted frame.
    ``converged`` is constant True on the FW path (``bf_slots=None``); on the
    BF path a False means the caller must re-dispatch with FW."""
    out = _band_front(u, v, w, radius, n=n, band=band, block=block,
                      bf_slots=bf_slots, bf_max_iters=bf_max_iters,
                      packed=packed, impl=impl)
    return out[:4] + (out[5],)


@functools.partial(jax.jit, static_argnames=("n", "band", "block"))
def band_init(u, v, w, *, n: int, band: int, block: int = 128):
    """Banded FW initialization alone — the first dispatch of the SPLIT band
    front (see band_relax_threshold)."""
    from safepy_tpu.ops import apsp_bandstore as bst

    return bst.band_init_from_edges(u, v, w, n=n, band=band, block=block)


@functools.partial(jax.jit, donate_argnums=(0,),
                   static_argnames=("n", "bt", "block", "packed", "impl"))
def band_relax_threshold(s, radius, *, n: int, bt: int, block: int = 128,
                         packed: bool = False, impl=None):
    """FW relax + radius mask + indicator/stats over a DONATED band.

    The split front exists for device memory, not speed: inside the fused
    program XLA assigns separate buffers to the FW while-loop's parameter and
    result (compile-only memory_analysis measures temp ~= 2x the band
    store). At a jit boundary the donated
    init band aliases the returned MASKED distance band (same shape/dtype —
    donation only pairs buffers an output can reuse, so this function
    ALWAYS returns the distances; a caller that doesn't want them drops the
    reference after dispatch, which frees the device buffer before the tail
    runs); peak memory during relaxation is ONE band plus the int8
    indicator. The facade gates the split on band size
    (SAFE.band_split_min_bytes); the extra dispatches cost ~1 s against the
    tens-of-GB regime they unlock."""
    from safepy_tpu.ops import apsp_bandstore as bst

    s = bst.apsp_band_fw(s, bt=bt, block=block, impl=impl)
    s_ind = bst.band_threshold(s, radius, packed=packed, block=block)
    _, mean, std = bst.band_row_stats(s_ind, n=n, bt=bt, block=block)
    dist_band = jnp.where(s <= jnp.asarray(radius, s.dtype), s, jnp.inf)
    return dist_band, s_ind, mean, std


@functools.partial(jax.jit, static_argnames=(
    "bt", "block", "score_type", "num_permutations", "batch_size", "w_c",
    "precision"))
def band_perm_tail(s_ind, vals, vals_valid, valid, starts, rank, key, *,
                   bt: int, block: int = 128, score_type: str = "sum",
                   num_permutations: int = 1000, batch_size: int = 1000,
                   w_c: int, precision: str = "highest"):
    """Standalone jit of the banded permutation tail — the third dispatch of
    the split front path (obs, counts_neg, counts_pos in the ORIGINAL
    frame)."""
    return _band_perm_tail(s_ind, vals, vals_valid, valid, starts, rank, key,
                           bt=bt, block=block, score_type=score_type,
                           num_permutations=num_permutations,
                           batch_size=batch_size, w_c=w_c,
                           precision=precision)


def _band_perm_tail(s_ind, vals, vals_valid, valid, starts, rank, key, *,
                    bt, block, score_type, num_permutations, batch_size, w_c,
                    precision):
    """Observed scores + compaction + permutation counts over a banded
    indicator, with the (n, A) outputs un-permuted to the original frame —
    shared by the shortest-path and euclidean band pipelines."""
    from safepy_tpu.ops import apsp_bandstore as bst
    from safepy_tpu.ops.enrich_band import band_score, scan_counts_band

    obs = band_score(s_ind, vals, bt=bt, block=block, score_type=score_type,
                     precision=precision)
    compact = bst.apply_compaction(s_ind, valid, w_c, bt=bt, block=block)
    mask_valid = jnp.isfinite(vals_valid).astype(jnp.float32)
    vv = jnp.where(mask_valid > 0, jnp.asarray(vals_valid, jnp.float32), 0.0)
    counts_neg, counts_pos = scan_counts_band(
        compact, starts, vv, mask_valid, obs, key, score_type=score_type,
        num_permutations=num_permutations, batch_size=batch_size, bt=bt,
        block=block, precision=precision)
    take = functools.partial(jnp.take, indices=rank, axis=0)
    return take(obs), take(counts_neg), take(counts_pos)


@functools.partial(jax.jit, static_argnames=(
    "n", "band", "block", "score_type", "num_permutations", "batch_size",
    "w_c", "precision", "bf_max_iters", "keep_distances", "packed", "impl"))
def fused_permutation_pipeline_band(u, v, w, vals, vals_valid, valid, starts,
                                    rank, key, radius, *, n: int, band: int,
                                    block: int = 128, score_type: str = "sum",
                                    num_permutations: int = 1000,
                                    batch_size: int = 1000, w_c: int,
                                    precision: str = "highest",
                                    bf_slots=None, bf_max_iters: int = 0,
                                    keep_distances: bool = True,
                                    packed: bool = False, impl=None):
    """Band-storage APSP + threshold + scores + permutation null, one dispatch.

    All row inputs are in the PERMUTED (banded-order) frame: u/v/w the edge
    arrays, ``vals`` the (n, A) attribute matrix, ``vals_valid`` its (V, A)
    valid rows, ``valid`` the (n,) validity bitmap, ``starts``/``w_c`` from
    ops/apsp_bandstore.compaction_plan. ``rank`` maps original node i to its
    permuted position, so the returned (n, A) matrices are already back in the
    ORIGINAL frame; the band matrices stay permuted (their frame is part of
    the BandedMatrix wrapper). The trailing ``converged`` output is constant
    True on the FW path (``bf_slots=None``); on the sparse-BF path a False
    means every other output is garbage and the caller must re-dispatch FW.

    ``keep_distances=False`` replaces the returned f32 distance band with an
    empty placeholder: XLA then dead-code-eliminates the masked distance
    array and frees the relaxed band right after thresholding, cutting peak
    memory by the f32 band (9.3 GB at 299,520 nodes / 125-node
    neighborhoods). The facade's
    ``SAFE.keep_node_distances`` drives it; ``node_distances`` is then
    unavailable for the run.
    """
    dist_band, s_ind, mean, std, bt, converged = _band_front(
        u, v, w, radius, n=n, band=band, block=block, bf_slots=bf_slots,
        bf_max_iters=bf_max_iters, packed=packed, impl=impl)
    obs, counts_neg, counts_pos = _band_perm_tail(
        s_ind, vals, vals_valid, valid, starts, rank, key, bt=bt, block=block,
        score_type=score_type, num_permutations=num_permutations,
        batch_size=batch_size, w_c=w_c, precision=precision)
    if not keep_distances:
        dist_band = jnp.zeros((0, s_ind.shape[1]), jnp.float32)
    return (dist_band, s_ind, obs, counts_neg, counts_pos, mean, std,
            converged)


@functools.partial(jax.jit, static_argnames=(
    "n", "band", "block", "score_type", "num_permutations", "batch_size",
    "w_c", "precision", "keep_distances", "packed"))
def fused_permutation_pipeline_band_euclid(
        coords_perm, vals, vals_valid, valid, starts, rank, key, radius, *,
        n: int, band: int, block: int = 128, score_type: str = "sum",
        num_permutations: int = 1000, batch_size: int = 1000, w_c: int,
        precision: str = "highest", keep_distances: bool = True,
        packed: bool = False):
    """Euclidean band neighborhoods + permutation null, one dispatch — the
    scatter/UMAP flagship at band-storage scale (no graph algorithm at all;
    strict ``dist < r``, reference safe.py:389-399)."""
    from safepy_tpu.ops import apsp_bandstore as bst

    bt = band // block + 1
    if keep_distances:
        raw = bst.euclidean_band_distances(coords_perm, n=n, band=band,
                                           block=block)
        r = jnp.asarray(radius, raw.dtype)
        dist_band = jnp.where(raw < r, raw, jnp.inf)
        s_ind = (raw < r).astype(jnp.int8)
    else:
        # the f32 band never materializes — the int8 (or bit-packed uint8,
        # packed=True) indicator is built directly: ~1/4 (~1/32) the peak
        # HBM (see euclidean_band_neighborhoods)
        s_ind = bst.euclidean_band_indicator(coords_perm, radius, n=n,
                                             band=band, block=block,
                                             packed=packed)
        dist_band = jnp.zeros((0, s_ind.shape[1]), jnp.float32)
    _, mean, std = bst.band_row_stats(s_ind, n=n, bt=bt, block=block)
    obs, counts_neg, counts_pos = _band_perm_tail(
        s_ind, vals, vals_valid, valid, starts, rank, key, bt=bt, block=block,
        score_type=score_type, num_permutations=num_permutations,
        batch_size=batch_size, w_c=w_c, precision=precision)
    return dist_band, s_ind, obs, counts_neg, counts_pos, mean, std


@functools.partial(jax.jit, static_argnames=("n", "band", "block",
                                             "iterations", "attr_chunk",
                                             "bf_max_iters",
                                             "keep_distances", "packed",
                                             "impl"))
def fused_hypergeom_pipeline_band(u, v, w, nan0, nodes_not_nan, K, lgt, M,
                                  radius, enrichment_threshold, rank, *,
                                  n: int, band: int, block: int = 128,
                                  iterations: int,
                                  attr_chunk: int | None = None,
                                  bf_slots=None, bf_max_iters: int = 0,
                                  keep_distances: bool = True,
                                  packed: bool = False, impl=None):
    """Band-storage APSP + hypergeometric enrichment, one dispatch.

    Operands are HOST-precomputed (nan0 = NaN->0 annotations, nodes_not_nan,
    per-attribute totals K — all in the PERMUTED frame): the NaN-carrying
    matrix and its derived masks never reach the device, and the row
    un-permute happens inside the (chunked) tail, so at GO scale on a
    100k-node network peak memory stays within one device. Returns (dist_band,
    s_ind, log_sf32, nes_binary_int8, enriched_counts, mean, std) with the
    (n, A) matrices in the ORIGINAL frame; NES derives lazily from logsf in
    the facade (a second resident (n, A) f32 buffer would double the output
    footprint).
    """
    from safepy_tpu.ops.enrich_band import hypergeom_core_band

    dist_band, s_ind, mean, std, bt, converged = _band_front(
        u, v, w, radius, n=n, band=band, block=block, bf_slots=bf_slots,
        bf_max_iters=bf_max_iters, packed=packed, impl=impl)

    log_sf32, nes_binary = hypergeom_core_band(
        s_ind, nan0, nodes_not_nan, K, lgt, M, enrichment_threshold,
        iterations=iterations, bt=bt, block=block, attr_chunk=attr_chunk,
        rank=rank)
    enriched_counts = jnp.sum(nes_binary, axis=0, dtype=jnp.int32)
    if not keep_distances:  # see fused_permutation_pipeline_band
        dist_band = jnp.zeros((0, s_ind.shape[1]), jnp.float32)
    return (dist_band, s_ind, log_sf32, nes_binary,
            enriched_counts, mean, std, converged)
