"""Enrichment statistics over band-storage neighborhoods — never densified.

The dense enrichment kernels contract an (N, N) indicator against (N, A)
attributes (reference safe.py:587-594, safe_extras.py:15). At band-storage
scale (ops/apsp_bandstore.py) the indicator only exists as the skewed radius
band, so every contraction becomes a block-row slab product:

  * :func:`band_score` — observed neighborhood scores (sum / z-score,
    reference safe_extras.py:6-33) via ONE banded pass (the z-score's three
    contractions ride a single stacked matmul);
  * :func:`scan_counts_band` — the two-sided permutation null
    (safe_extras.py:36-70): permuted operands come from the same keyed
    stable-sort (or index gather) as the dense engine, contracted against the
    valid-column-compacted band;
  * :func:`hypergeom_tail_band` — census + survival tail + device
    finalization (safe.py:556-608) with the census matmuls banded.

Everything here lives in the PERMUTED (banded-order) node frame; callers
un-permute the (N, A) row outputs with one row gather.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from safepy_tpu.ops.apsp_bandstore import (band_count_batch, band_matmul,
                                           band_matmul_batch)
from safepy_tpu.ops.hypergeom import _sf_parts, finalize_logsf_device
from safepy_tpu.ops.permutation import (count_scan,
                                        permuted_operands_sorted,
                                        uses_sort_path)
from safepy_tpu.ops.score import zscore_from_contractions, zscore_shift


def _pad_rows_to(x, rows: int):
    if x.shape[0] == rows:
        return x
    return jnp.pad(x, ((0, rows - x.shape[0]),) + ((0, 0),) * (x.ndim - 1))


def band_score(s_ind, vals, *, bt: int, block: int = 128,
               score_type: str = "sum", precision: str = "highest"):
    """Observed neighborhood scores from the banded indicator.

    vals: (n, A) attribute values with NaNs, rows in the PERMUTED frame.
    Returns (npad, A) f32 scores (permuted frame; rows past n are pad junk).
    """
    npad = s_ind.shape[0] - 2 * bt * block
    vals = jnp.asarray(vals, jnp.float32)
    mask = jnp.isfinite(vals)
    B = _pad_rows_to(jnp.where(mask, vals, 0.0), npad)

    if score_type == "sum":
        return band_matmul(s_ind, B, bt=bt, block=block, precision=precision)
    if score_type != "z-score":
        raise ValueError(f"unknown neighborhood_score_type: {score_type!r}")

    NB = _pad_rows_to(mask.astype(jnp.float32), npad)
    c = zscore_shift(B, NB)  # pad rows are (0, 0): no effect on the mean
    Bs = B - NB * c
    stacked = jnp.concatenate([Bs, NB, Bs * Bs], axis=1)
    out = band_matmul(s_ind, stacked, bt=bt, block=block, precision=precision)
    AB, N, EXX_sum = jnp.split(out, 3, axis=1)
    return zscore_from_contractions(AB, N, EXX_sum, shift=c)


def scan_counts_band(compact, starts, vals, mask, obs, key, *,
                     score_type: str, num_permutations: int, batch_size: int,
                     bt: int, block: int = 128, precision: str = "highest"):
    """Two-sided permutation counts against the compacted band.

    Args:
      compact: ((nb+2bt)*b, w_c) valid-column-compacted indicator
        (ops/apsp_bandstore.compact_band_columns).
      starts: (nb,) int32 slab starts (valid-rank frame).
      vals, mask: (V, A) f32 NaN->0 values / finite masks of the VALID rows,
        in permuted order (the rows the reference permutes, safe_extras.py:50).
      obs: (npad, A) observed scores in the permuted frame.

    Returns int32 (npad, A) counts_neg / counts_pos.
    """
    from safepy_tpu.ops.apsp_bandstore import is_packed_bits

    V, A = vals.shape
    w_c = compact.shape[1] * (8 if is_packed_bits(compact) else 1)
    v_pad = V + w_c  # slack so starts[i] + w_c never overruns
    sort_path = uses_sort_path(A)
    zscore = score_type == "z-score"
    shift = None
    if zscore:
        # center before permuting (ops.score.zscore_shift: exact, commutes
        # with the row permutation, kills the variance cancellation)
        shift = zscore_shift(vals, mask)
        vals = vals - mask * shift

    def permuted(chunk_key, pad_to=None):
        if sort_path:
            # pad_to sorts the slack rows in as max-key zeros — the padded
            # operand comes out of the ONE sort, no post-sort full-size copy
            return permuted_operands_sorted(vals, mask, chunk_key,
                                            batch_size, zscore, pad_to=pad_to)
        perm_keys = jax.random.split(chunk_key, batch_size)
        perm_idx = jax.vmap(lambda k: jax.random.permutation(k, V))(perm_keys)
        Bp = jnp.take(vals, perm_idx, axis=0)
        NBp = jnp.take(mask, perm_idx, axis=0) if zscore else None
        if pad_to is not None:
            Bp = jnp.pad(Bp, ((0, 0), (0, pad_to - V), (0, 0)))
            if zscore:
                NBp = jnp.pad(NBp, ((0, 0), (0, pad_to - V), (0, 0)))
        return Bp, NBp

    def chunk_scores(chunk_key):
        Bp, NBp = permuted(chunk_key)
        stacked = jnp.concatenate([Bp, NBp, Bp * Bp], axis=-1)
        stacked = jnp.pad(stacked, ((0, 0), (0, v_pad - V), (0, 0)))
        out = band_matmul_batch(compact, stacked, starts, bt=bt, block=block,
                                precision=precision)
        AB, Np, EXX_sum = jnp.split(out, 3, axis=-1)
        return zscore_from_contractions(AB, Np, EXX_sum, shift=shift)

    def chunk_counts(chunk_key, live):
        # sum scores: FUSED per-block contraction + comparison — the
        # (C, npad, A) chunk-score array never materializes
        # (ops/apsp_bandstore.band_count_batch, bit-identical by test)
        Bp, _ = permuted(chunk_key, pad_to=v_pad)
        return band_count_batch(compact, Bp, starts, obs, live, bt=bt,
                                block=block, precision=precision)

    return count_scan(chunk_scores if zscore else None, obs, key,
                      num_permutations=num_permutations,
                      batch_size=batch_size,
                      chunk_counts=None if zscore else chunk_counts)


def hypergeom_core_band(s_ind, nan0, nodes_not_nan, K, lgt, M,
                        enrichment_threshold, *, iterations: int, bt: int,
                        block: int = 128, precision: str = "highest",
                        attr_chunk: int | None = None, rank=None):
    """Hypergeometric census + survival tail over the banded indicator, from
    PRE-zeroed operands (the NaN-carrying matrix never reaches the device —
    at GO scale on a 100k-node network it and its derived copies are the
    difference between fitting HBM and not).

    nan0: (n, A) f32 NaN->0 annotations, rows in the PERMUTED frame;
    nodes_not_nan: (n,) f32; K: (A,) per-attribute totals.
    ``rank`` (optional, (n,) int32): un-permute the row outputs to the
    ORIGINAL frame *inside* the computation — at chunked scale this happens
    per chunk, so no second full-size copy of the outputs ever exists.
    ``attr_chunk``: process attributes in chunks of this size (a fori loop
    with dynamic slices — stacking chunks for lax.map would duplicate the
    (N, A) matrix) so only one chunk's f64 tail intermediates are live.

    Returns (logsf32, bin8) — NES is elementwise-derivable (-logsf/ln10)
    and a second (n, A) f32 buffer would double the output footprint; the
    facade derives it lazily on access.
    """
    npad = s_ind.shape[0] - 2 * bt * block
    nan0 = jnp.asarray(nan0, jnp.float32)
    nodes_not_nan = jnp.asarray(nodes_not_nan, jnp.float32)
    A = nan0.shape[1]
    out_rows = npad if rank is None else rank.shape[0]

    def gather(x):
        return x if rank is None else jnp.take(x, rank, axis=0)

    def tail(counts, nsize, K_c):
        k64 = counts.astype(jnp.float64)
        K64 = jnp.broadcast_to(K_c.astype(jnp.float64)[None, :], counts.shape)
        n64 = jnp.broadcast_to(nsize.astype(jnp.float64)[:, None],
                               counts.shape)
        parts = _sf_parts(k64, M, K64, n64, lgt, iterations)
        _nes, logsf, nbin = finalize_logsf_device(parts,
                                                  enrichment_threshold)
        return logsf, nbin

    if attr_chunk is None or attr_chunk >= A:
        stacked = _pad_rows_to(
            jnp.concatenate([nodes_not_nan[:, None], nan0], axis=1), npad)
        prod = band_matmul(s_ind, stacked, bt=bt, block=block,
                           precision=precision)
        logsf, nbin = tail(prod[:, 1:], prod[:, 0], K)
        return gather(logsf), gather(nbin)

    nsize = band_matmul(s_ind, _pad_rows_to(nodes_not_nan[:, None], npad),
                        bt=bt, block=block, precision=precision)[:, 0]
    nc = -(-A // attr_chunk)
    nan0_r = _pad_rows_to(nan0, npad)

    # the last chunk CLAMPS its start to A - attr_chunk instead of padding
    # columns: a few columns are recomputed identically, and the (N, A)
    # matrix is never copied just to round A up
    z = jnp.int32(0)
    logsf_b = jnp.zeros((out_rows, A), jnp.float32)
    bin_b = jnp.zeros((out_rows, A), jnp.int8)

    def one(ci, bufs):
        ci = jnp.asarray(ci, jnp.int32)
        logsf_b, bin_b = bufs
        start = jnp.minimum(ci * attr_chunk, A - attr_chunk)
        nan0_c = jax.lax.dynamic_slice(nan0_r, (z, start),
                                       (npad, attr_chunk))
        K_c = jax.lax.dynamic_slice(K, (start,), (attr_chunk,))
        counts = band_matmul(s_ind, nan0_c, bt=bt, block=block,
                             precision=precision)
        logsf_c, bin_c = tail(counts, nsize, K_c)
        return (jax.lax.dynamic_update_slice(logsf_b, gather(logsf_c),
                                             (z, start)),
                jax.lax.dynamic_update_slice(bin_b, gather(bin_c),
                                             (z, start)))

    return jax.lax.fori_loop(0, nc, one, (logsf_b, bin_b))


def hypergeom_tail_band(s_ind, vals, lgt, M, enrichment_threshold, *,
                        iterations: int, bt: int, block: int = 128,
                        precision: str = "highest",
                        attr_chunk: int | None = None, rank=None):
    """Census + survival tail from the raw NaN-carrying annotation matrix
    (reference safe.py:556-608 semantics); delegates to
    :func:`hypergeom_core_band` after masking. Prefer the core directly with
    host-precomputed operands at huge N."""
    vals = jnp.asarray(vals, jnp.float32)
    finite = jnp.isfinite(vals)
    nan0 = jnp.where(finite, vals, 0.0)
    nodes_not_nan = jnp.any(finite, axis=1).astype(jnp.float32)
    K = jnp.sum(nan0, axis=0)
    return hypergeom_core_band(s_ind, nan0, nodes_not_nan, K, lgt, M,
                               enrichment_threshold, iterations=iterations,
                               bt=bt, block=block, precision=precision,
                               attr_chunk=attr_chunk, rank=rank)


def _iteration_bucket(iters: int) -> int:
    """Round the static tail-iteration bound up to a power of two so the
    host-chunked driver compiles at most ~7 distinct programs."""
    b = 64
    while b < iters:
        b *= 2
    return b


def hypergeom_band_hostchunks(s_ind, nan0_np, nodes_not_nan_np, lgt, M,
                              enrichment_threshold, *, bt: int,
                              block: int = 128, rank_np, attr_chunk: int,
                              precision: str = "highest"):
    """GO-scale hypergeometric tail as HOST-driven chunk dispatches.

    The survival tail runs in emulated f64 and dominates at huge N x A — a
    single fused dispatch over 100k x 4,373 runs long enough to trip the
    remote worker watchdog. This driver instead:

      * sorts attribute columns by their annotation total K, so each chunk's
        static iteration bound (sigma ~ sqrt(K_max)/2) fits ITS terms — on
        real GO data most terms are small and get ~4x shorter tails;
      * dispatches one jit per chunk (minutes-short steps, ~7 compiled
        variants thanks to power-of-two iteration buckets), with the
        row-unpermute fused into each chunk;
      * reassembles on device: concat + the transpose/row-gather/transpose
        column permutation (row gathers move contiguous rows).

    Returns (logsf_dev, bin_dev, counts_np) with columns in the ORIGINAL
    attribute order and rows in the ORIGINAL node frame (NES derives
    lazily from logsf in the facade — see hypergeom_band_table).
    """
    import numpy as np
    from safepy_tpu.ops.hypergeom import tail_iterations

    n_attrs = nan0_np.shape[1]
    K_np = nan0_np.sum(axis=0)
    order_a = np.argsort(K_np, kind="stable")
    inv_a = np.argsort(order_a, kind="stable")

    nan0_dev = jnp.asarray(nan0_np[:, order_a])
    nnn_dev = jnp.asarray(nodes_not_nan_np)
    rank_dev = jnp.asarray(rank_np, jnp.int32)
    K_sorted = K_np[order_a]

    attr_chunk = min(attr_chunk, n_attrs)
    nc = -(-n_attrs // attr_chunk)
    logsf_pieces, bin_pieces, counts = [], [], []
    for ci in range(nc):
        start = min(ci * attr_chunk, n_attrs - attr_chunk)
        overlap = ci * attr_chunk - start  # last chunk clamps; drop the rerun
        cols = jax.lax.dynamic_slice_in_dim(nan0_dev, start, attr_chunk, 1)
        K_c = K_sorted[start:start + attr_chunk]
        k_max = int(max(1.0, float(K_c.max()))) if K_c.size else 1
        iters = _iteration_bucket(tail_iterations(M, min(k_max, M)))
        logsf_c, bin_c = hypergeom_core_band_jit(
            s_ind, cols, nnn_dev, jnp.asarray(K_c, jnp.float32), lgt, M,
            enrichment_threshold, iterations=iters, bt=bt, block=block,
            precision=precision, rank=rank_dev)
        if overlap:
            logsf_c = logsf_c[:, overlap:]
            bin_c = bin_c[:, overlap:]
        logsf_pieces.append(logsf_c)
        bin_pieces.append(bin_c)
        counts.append(np.asarray(jnp.sum(bin_c, axis=0, dtype=jnp.int32)))

    # assembly allocates (n, A)-sized outputs: drop every reference that is
    # no longer needed FIRST (the sorted annotation matrix alone is the size
    # of one output), and consume each piece list as its tensor assembles
    del nan0_dev, cols
    inv_dev = jnp.asarray(inv_a, jnp.int32)

    def assemble(pieces):
        sorted_cols = jnp.concatenate(pieces, axis=1)
        pieces.clear()
        # column permutation via transpose + ROW gather + transpose (a row
        # gather moves contiguous rows, a column gather scattered words)
        return jnp.take(sorted_cols.T, inv_dev, axis=0).T

    logsf = assemble(logsf_pieces)
    nbin = assemble(bin_pieces)
    counts_np = np.concatenate(counts)[inv_a]
    return logsf, nbin, counts_np


@jax.jit
def band_hyper_operands_device(n2a_dev, order):
    """(nan0_perm, nodes_not_nan_perm, K, binary_ok) built ON DEVICE.

    The host equivalents (isnan / where / astype / row fancy-gather over the
    (N, A) matrix) cost minutes per run at 100k x 4,373 in this runtime's
    degraded host memory path — on device they are microseconds against the
    facade's cached annotation upload. ``order`` maps permuted position ->
    original row (argsort of rank)."""
    finite = jnp.isfinite(n2a_dev)
    nan0 = jnp.where(finite, n2a_dev, 0.0)
    K = jnp.sum(nan0, axis=0)
    nnn = jnp.any(finite, axis=1).astype(jnp.float32)
    binary_ok = jnp.all((n2a_dev == 0.0) | (n2a_dev == 1.0) | ~finite)
    # int8 storage: callers only consume nan0_perm when binary_ok, so the
    # cast is exact — 1/4 the resident HBM of the f32 copy at GO scale
    # (199,680 x 4,373: 0.87 GB vs 3.49 GB); census chunks cast their
    # column slice back to f32 inside the dispatch
    return (jnp.take(nan0.astype(jnp.int8), order, axis=0),
            jnp.take(nnn, order), K, binary_ok)


@functools.partial(jax.jit, donate_argnums=(0, 1))
def _prep_chunk_step(buf, nnn_any, x, col0):
    """One column chunk of :func:`band_hyper_operands_chunked`: write the
    chunk's int8 nan0 columns into the donated (N, A) buffer and fold the
    chunk into the row-validity / K / binary-ok accumulators."""
    finite = jnp.isfinite(x)
    nan0 = jnp.where(finite, x, 0.0)
    buf = jax.lax.dynamic_update_slice(
        buf, nan0.astype(jnp.int8), (jnp.int32(0), col0))
    nnn_any = nnn_any | jnp.any(finite, axis=1)
    # column sums of integer-valued f32 are exact below 2^24 rows
    K_c = jnp.sum(nan0, axis=0)
    ok_c = jnp.all((x == 0.0) | (x == 1.0) | ~finite)
    return buf, nnn_any, K_c, ok_c


@jax.jit
def _prep_permute(buf, nnn_any, order):
    return (jnp.take(buf, order, axis=0),
            jnp.take(nnn_any.astype(jnp.float32), order))


def band_hyper_operands_chunked(n2a_np, order, chunk_cols: int = 512):
    """:func:`band_hyper_operands_device` built from COLUMN-CHUNKED host
    uploads — the GO-scale prep path.

    The full-device variant's jit peak is ~10 (N, A)-cells of HBM (the f32
    upload + the f32 nan0, which XLA materializes for its two consumers, +
    the int8 nan0 + the row-gather output). This variant
    peaks at ~2 cells (the donated int8 accumulator + the gather output)
    plus one f32 chunk: each (N, chunk) f32 column chunk is uploaded,
    folded into the int8 buffer by :func:`_prep_chunk_step` (donated — XLA
    updates in place), and freed; the row permutation runs once at the
    end. Results are bit-identical to the full-device path (test-pinned).
    """
    import numpy as np
    n, a = n2a_np.shape
    buf = jnp.zeros((n, a), jnp.int8)
    nnn_any = jnp.zeros((n,), bool)
    K_parts, ok = [], True
    for j in range(0, a, chunk_cols):
        x = jnp.asarray(np.asarray(n2a_np[:, j:j + chunk_cols], np.float32))
        buf, nnn_any, K_c, ok_c = _prep_chunk_step(
            buf, nnn_any, x, jnp.int32(j))
        K_parts.append(np.asarray(K_c))
        ok = ok and bool(ok_c)
    nan0_perm, nnn_perm = _prep_permute(buf, nnn_any,
                                        jnp.asarray(order, jnp.int32))
    return nan0_perm, nnn_perm, jnp.asarray(np.concatenate(K_parts)), ok


def count_other_values_chunked(n2a_np, chunk_cols: int = 512):
    """Count of finite non-0/1 values (the reference's binary detection,
    safe.py:454-456) from column-chunked uploads — never stages the full
    f32 (N, A) on device for one scalar (at 399,360 x 4,373 the full
    upload is 6.98 GB; a chunk is ~0.8 GB)."""
    import numpy as np
    n, a = n2a_np.shape
    total = 0
    for j in range(0, a, chunk_cols):
        x = jnp.asarray(np.asarray(n2a_np[:, j:j + chunk_cols], np.float32))
        total += int(np.asarray(_count_other_chunk(x)))
    return total


def _column_sums_chunked(nan0_dev, chunk_cols: int = 1024):
    """Exact per-attribute annotated totals (column sums of 0/1 values,
    exact in f32 below 2^24 rows) in COLUMN CHUNKS — one (n, chunk) f32
    transient at a time instead of a full f32 copy of the (n, A) int8
    matrix (the eager ``astype(f32)`` this replaces costs 4 B/cell at the
    moment the census outputs are about to be allocated)."""
    import numpy as np
    a = nan0_dev.shape[1]
    return np.concatenate([
        np.asarray(jnp.sum(nan0_dev[:, j:j + chunk_cols], axis=0,
                           dtype=jnp.float32))
        for j in range(0, a, chunk_cols)])


@jax.jit
def _count_other_chunk(x):
    # one chunk's count is < 2^31 for any realistic (rows, 512) chunk
    return jnp.sum(jnp.isfinite(x) & (x != 0.0) & (x != 1.0),
                   dtype=jnp.int32)


def hypergeom_band_table(s_ind, nan0_np, nodes_not_nan_np, M,
                         enrichment_threshold, *, bt: int, block: int = 128,
                         rank_np, precision: str = "highest",
                         chunk_cols: int = 512, nsize_dev=None, plan=None,
                         logsf_out: str = "device", K_np=None,
                         lookup_group: int | str = 8,
                         budget: int | None = None,
                         extra_resident_bytes: int = 0,
                         select_out: dict | None = None):
    """GO-scale hypergeometric enrichment via the class-table engine
    (ops/hypergeom_table.py) — the production path for binary annotations.

    Replaces the per-cell f64 tail of :func:`hypergeom_band_hostchunks`
    with one f64 recurrence per distinct
    (K, neighborhood-size) class plus one table gather per cell. Column
    chunks are K-sorted so each chunk's scan length hugs its largest class.

    Returns (logsf, bin, counts_np) with columns in the ORIGINAL attribute
    order and rows in the ORIGINAL node frame, or None when the plan is
    ineligible (caller falls back to the loop engine). NES is NOT
    materialized: it is elementwise-derivable (-logsf/ln10) and a second
    (n, A) f32 buffer doubles the output footprint — the facade derives it
    lazily on access.

    ``logsf_out`` controls the RESIDENCY of the (n, A) outputs — the f32
    log-survival whale (6.1 GB at 349,440 x 4,373) is the largest census
    resident:

      * ``'device'`` — f32 logsf + int8 indicator on device (the default);
      * ``'f16'``    — logsf stored f16 on device (half the whale; the
        indicator and counts are decided in f64 PRE-rounding, so they stay
        exact — only the stored log-p loses ~2^-11 relative);
      * ``'host'``   — each chunk's f32 logsf/indicator columns stream to
        host numpy buffers (bit-equal to 'device'); nothing (n, A)-sized
        stays on device. Costs one (n, A) host download per run.
      * ``'auto'``   — the AUTHORITATIVE selection: once the chunk plan
        exists the true class-table bytes are known, so (mode, group) is
        chosen here by hbm.census_select against ``budget`` — the facade's
        pre-prep guard only estimated the table. Raises a clean ValueError
        (before any (n, A) allocation) if nothing fits.

    ``lookup_group``: the slot-loop unroll depth (int), or 'auto' to let
    census_select pick it — XLA keeps ``group`` (n, chunk) f32 gather
    outputs live per lookup step, a term of the census peak.

    ``extra_resident_bytes``: caller-owned device residents the selection
    must account for (e.g. a kept f32 distance band).

    ``select_out``: optional dict, filled with the census_select decision
    for observability (the facade merges it into ``SAFE._hbm_plan_last``).

    ``nan0_np`` may be f32 or int8 (exact for the binary annotations this
    engine requires), host or device; int8 is preferred at scale.

    ``K_np``: the per-attribute annotated totals if the caller already has
    them (the facade's operand cache does) — recomputing here would
    materialize a full f32 copy of the int8 annotations as an eager
    astype (4 B/cell: 6.98 GB at 399,360 x 4,373) right when the device is
    fullest; the fallback sums in column chunks instead.
    """
    import numpy as np
    from safepy_tpu.ops import hypergeom_table as htab

    nan0_dev = jnp.asarray(nan0_np)
    if K_np is None:
        K_np = _column_sums_chunked(nan0_dev)
    else:
        K_np = np.asarray(K_np)
    if nsize_dev is None:
        nnn_dev = jnp.asarray(nodes_not_nan_np)
        nsize_dev = band_matmul(
            s_ind, _pad_rows_to(nnn_dev[:, None],
                                s_ind.shape[0] - 2 * bt * block),
            bt=bt, block=block, precision=precision)[:, 0]
    n_max = float(jnp.max(nsize_dev))  # scalar download
    if plan is None:
        plan = htab.plan(K_np, n_max, int(M), chunk_cols=chunk_cols)
    if plan is None:
        return None
    if logsf_out not in ("device", "f16", "host", "auto"):
        raise ValueError(f"unknown logsf_out: {logsf_out!r}")

    if logsf_out == "auto" or lookup_group == "auto":
        from safepy_tpu import hbm as _hbm_mod
        table_bytes = 4 * max(ch["R"] * ch["S_max"] * ch["C"]
                              for ch in plan["chunks"])
        sel = _hbm_mod.census_select(
            n=len(rank_np), n_attrs=nan0_dev.shape[1],
            rows=s_ind.shape[0],
            chunk_w=max(ch["width"] for ch in plan["chunks"]),
            ind_bytes=s_ind.nbytes, ann_bytes=nan0_dev.nbytes,
            table_bytes=table_bytes, extra_resident=extra_resident_bytes,
            budget=budget,
            modes=(("device", "f16", "host") if logsf_out == "auto"
                   else (logsf_out,)),
            groups=(_hbm_mod.LOOKUP_GROUPS if lookup_group == "auto"
                    else (int(lookup_group),)))
        if select_out is not None:
            select_out.update(sel)
        if not sel["fits"]:
            # refuse BEFORE allocating the (n, A) outputs — a fatal OOM
            # poisons the process backend (CLAUDE.md)
            raise ValueError(
                "census phase does not fit the device HBM budget: peak "
                f"{sel['census_peak'] / 1e9:.2f} GB vs admitted "
                f"{sel['admit'] / 1e9:.2f} GB of "
                f"{sel['budget'] / 1e9:.2f} GB (logsf_out="
                f"{logsf_out!r}, lookup_group={lookup_group!r})")
        logsf_out = sel["logsf_out"]
        lookup_group = sel["lookup_group"]

    log_thr64 = float(np.log(enrichment_threshold))
    rank_dev = jnp.asarray(rank_np, jnp.int32)
    npad = s_ind.shape[0] - 2 * bt * block
    n, n_attrs = len(rank_np), nan0_dev.shape[1]

    # chunks stream into preallocated outputs with DONATED buffers ('host':
    # numpy buffers, no device preallocation at all): the only (n, A)-sized
    # device arrays alive are the outputs (if device-resident) plus the
    # (int8) annotation matrix — at 100k x 4,373 a transient second copy
    # is GBs
    host = logsf_out == "host"
    if host:
        logsf = np.empty((n, n_attrs), np.float32)
        nbin = np.empty((n, n_attrs), np.int8)
    else:
        logsf = jnp.zeros((n, n_attrs),
                          jnp.float16 if logsf_out == "f16" else jnp.float32)
        nbin = jnp.zeros((n, n_attrs), jnp.int8)
    from safepy_tpu import hbm as _hbm
    _hbm.record_peak("census:alloc")
    counts = []
    for ch in plan["chunks"]:
        start, width = ch["start"], ch["width"]
        cols = jax.lax.dynamic_slice_in_dim(nan0_dev, start, width, 1)
        logsf_c, bin_c = _band_table_chunk(
            s_ind, cols, nsize_dev, jnp.asarray(ch["K_dist"]),
            jnp.asarray(ch["colc"], jnp.int32), M, log_thr64, rank_dev,
            R=ch["R"], S_max=ch["S_max"], C=ch["C"], bt=bt, block=block,
            npad=npad, precision=precision, lookup_group=int(lookup_group))
        del cols
        # a unified tail chunk re-windows backwards: its leading `overlap`
        # columns recompute the previous chunk's values identically (the
        # placement below just overwrites them) but must not double-count
        counts.append(np.asarray(
            jnp.sum(bin_c, axis=0, dtype=jnp.int32))[ch.get("overlap", 0):])
        if host:
            logsf[:, start:start + width] = np.asarray(logsf_c)
            nbin[:, start:start + width] = np.asarray(bin_c)
        else:
            logsf, nbin = _place_chunk(logsf, nbin, logsf_c, bin_c, start)
        # drop the chunk outputs' Python refs NOW — they free as soon as
        # the queued placement consumes them, instead of overlapping the
        # next chunk's compute (and the last chunk's outputs would
        # otherwise survive until return)
        del logsf_c, bin_c
        # sync=False: the counts download above already ordered the stream;
        # an extra drain here would hide any dispatch-overlap the production
        # loop actually has
        _hbm.record_peak(f"census:chunk@{start}", sync=False)
    return logsf, nbin, np.concatenate(counts)


@functools.partial(jax.jit, donate_argnums=(0, 1))
def _place_chunk(logsf, nbin, logsf_c, bin_c, start):
    """Write one chunk's columns into the (donated) output buffers; the
    chunk's f32 logsf casts to the output's dtype in-jit (f16 staging)."""
    z = jnp.int32(0)
    s = jnp.asarray(start, jnp.int32)
    return (jax.lax.dynamic_update_slice(logsf, logsf_c.astype(logsf.dtype),
                                         (z, s)),
            jax.lax.dynamic_update_slice(nbin, bin_c, (z, s)))


@functools.partial(jax.jit, static_argnames=("R", "S_max", "C", "bt", "block",
                                             "npad", "precision",
                                             "lookup_group"))
def _band_table_chunk(s_ind, cols, nsize, K_dist, colc, M, log_thr64, rank, *,
                      R: int, S_max: int, C: int, bt: int, block: int,
                      npad: int, precision: str, lookup_group: int = 8):
    """One K-sorted column chunk: banded census + table build + lookup +
    row un-permute, fused into a single dispatch. ``cols`` may be int8 (the
    f32 cast is a fused transient inside this jit, never a resident buffer).
    The unused NES output of table_lookup is dead-code-eliminated.
    ``lookup_group`` bounds the slot-loop's live gather outputs (the census
    planner's HBM lever — results bit-identical across groups)."""
    import numpy as np
    from safepy_tpu.ops import hypergeom_table as htab

    counts = band_matmul(s_ind, _pad_rows_to(cols.astype(jnp.float32), npad),
                         bt=bt, block=block, precision=precision)
    table = htab.build_logsf_table(K_dist, M, log_thr64, R=R, S_max=S_max,
                                   C=C)
    _nes, logsf, nbin = htab.table_lookup(
        table, counts, nsize, colc,
        jnp.asarray(log_thr64).astype(jnp.float32),
        S_max=S_max, R=R, C=C, lookup_group=lookup_group)
    take = functools.partial(jnp.take, indices=rank, axis=0)
    return take(logsf), take(nbin)


# jitted single-dispatch wrappers for the STAGED facade paths (the fused
# pipelines in safepy_tpu/pipeline.py trace the raw functions directly)
band_score_jit = functools.partial(
    jax.jit, static_argnames=("bt", "block", "score_type", "precision"))(
        band_score)
run_permutations_band = functools.partial(
    jax.jit, static_argnames=("score_type", "num_permutations", "batch_size",
                              "bt", "block", "precision"))(scan_counts_band)
hypergeom_tail_band_jit = functools.partial(
    jax.jit, static_argnames=("iterations", "bt", "block", "precision",
                              "attr_chunk"))(hypergeom_tail_band)
hypergeom_core_band_jit = functools.partial(
    jax.jit, static_argnames=("iterations", "bt", "block", "precision",
                              "attr_chunk"))(hypergeom_core_band)
