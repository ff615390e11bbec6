"""Class-table hypergeometric survival engine for binary annotations.

The reference computes ``hypergeom.sf(k-1, M, K, n)`` for every (neighborhood,
attribute) cell (safepy/safe.py:596); ``ops/hypergeom.py`` vectorizes that as a
per-cell f64 tail recurrence. At GO scale (100k neighborhoods x 4,373 terms =
4.4e8 cells) the f64 tail loop dominates the whole pipeline — yet for BINARY
annotations every operand is a small integer,
and the cells collapse onto a tiny set of distinct classes:

    sf(k; M, K, n)  depends only on  (k, K, n)  with M fixed,

so the full survival surface is a table over (distinct K) x (neighborhood size
n = 0..n_max) x (count k = 0..support), typically 1e7-1e8 entries versus 4.4e8
cells x ~10^2 tail iterations. The engine:

  1. builds the table with ONE downward f64 recurrence per class —
     ``T(t) = 1 + rho(t) * T(t+1)`` where ``rho(t) = pmf(t+1)/pmf(t)`` is an
     exact small-integer ratio, anchored at ``log pmf(hi)`` from a gather-free
     Stirling series (arithmetic instead of lgamma-table gathers, which are
     far slower than f64 divides and logs);
  2. resolves every cell with ONE 1D table gather (the gather is the cost,
     so the binary-significance bit rides the same f32 value via a one-ulp
     threshold nudge instead of a second gather).

Precision: the table is f64 end to end (recurrence error ~1e-10, Stirling
anchor ~5e-9 absolute in log p) and rounds once to f32 on store — the same
rounding the existing device finalization applies (ops/hypergeom.py:193-226),
comfortably inside the 1e-6 p-value parity budget. The significance decision
is made on the f64 value BEFORE rounding and encoded by nudging stored values
off the threshold by <= 1 ulp, so enriched-pair counts are exact.

Applicability: binary 0/1 annotations only (integer counts); quantitative
inputs and over-budget tables fall back to ``ops/hypergeom._sf_parts``.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

_LN_2PI = float(np.log(2.0 * np.pi))
_RENORM = 1e250
_LN_RENORM = float(np.log(_RENORM))
# stored f32 for impossible slots (k > support); reads as deeply enriched but
# no real count ever lands there (k <= min(K, n) always)
_SENTINEL = np.float32(-1e30)


def log_factorial(x):
    """ln(x!) = lgamma(x + 1) for integer-valued f64 x >= 0, gather-free.

    Stirling series at z = x + 1 shifted to z >= 17 (error of the truncated
    series < 1e-14 there); the shift divides out Gamma's recurrence with one
    log of an exactly-accumulated product. Device f64 add/mul/log keep
    ~1e-12; the dominant error is f64 rounding of (z-0.5)*ln z, ~eps*|result|.
    """
    x = jnp.asarray(x, jnp.float64)
    z = x + 1.0
    shift = z < 17.0
    prod = jnp.ones_like(z)
    for i in range(16):
        prod = prod * jnp.where(shift, z + i, 1.0)
    zb = jnp.where(shift, z + 16.0, z)
    zi2 = 1.0 / (zb * zb)
    series = (1.0 / 12.0 + zi2 * (-1.0 / 360.0 + zi2 *
                                  (1.0 / 1260.0 - zi2 / 1680.0))) / zb
    lg = (zb - 0.5) * jnp.log(zb) - zb + 0.5 * _LN_2PI + series
    return lg - jnp.log(prod)


def table_geometry(K_values, n_max: int, M: int):
    """Host-side geometry of one table: (R, S_max) for a chunk of distinct K.

    R rows cover raw neighborhood sizes 0..n_max (power-of-two padded so jit
    signatures stay bounded); S_max slots cover counts 0..min(K_max, n_max)+1
    (the +1 slot absorbs the clip of impossible k).
    """
    r = 128
    while r < int(n_max) + 1:
        r *= 2
    k_max = int(max(1, np.max(K_values))) if len(K_values) else 1
    # power-of-two S_max: every distinct (R, S_max, C) triple is a separate
    # compiled program, and each compile costs seconds — the
    # padded slots are sentinel-filled and never looked up (k <= true support)
    s_max = 64
    while s_max < int(min(k_max, n_max) + 2):
        s_max *= 2
    return r, s_max


def table_cells(K_np, n_max: int, M: int, chunk: int) -> int:
    """Total table cells the chunked engine would build (budget check)."""
    K_sorted = np.sort(np.unique(np.asarray(K_np)))
    total = 0
    for s in range(0, len(K_sorted), chunk):
        kc = K_sorted[s:s + chunk]
        r, s_max = table_geometry(kc, n_max, M)
        total += r * s_max * len(kc)
    return total


@functools.partial(jax.jit, static_argnames=("R", "S_max", "C"))
def build_logsf_table(K_dist, M, log_thr, *, R: int, S_max: int, C: int):
    """(S_max, C, R) f32 table of log sf(k; M, K, n) values, threshold-nudged.

    Slot ``s`` holds k = S_max - 1 - s for class (c, n): column class
    ``K = K_dist[c]``, neighborhood size ``n`` = raw row index. One downward
    scan over k computes every class in parallel:

      T(hi) = 1;  T(t) = 1 + rho(t) * T(t+1);  sf(t) = pmf(t) * T(t)

    with pmf carried in log space (exact ratio logs) and T renormalized
    against overflow (T(lo) = 1/pmf(lo) can exceed f64 range for
    extreme-overlap classes). Values are stored f32 but the significance
    comparison happens on the f64 value first; stored values are nudged by
    <= 1 ulp so that ``stored < log_thr32`` reproduces the f64 decision.
    """
    f64 = jnp.float64
    K = jnp.asarray(K_dist, f64)[:, None]                      # (C, 1)
    n = jnp.arange(R, dtype=f64)[None, :]                      # (1, R)
    M64 = jnp.asarray(M, f64)
    lo = jnp.maximum(0.0, n + K - M64)
    hi = jnp.minimum(K, n)

    # anchor: log pmf(hi) = log [C(K,hi) C(M-K,n-hi) / C(M,n)]
    F = log_factorial
    anchor = (F(K) - F(hi) - F(K - hi)
              + F(M64 - K) - F(n - hi) - F(M64 - K - n + hi)
              - (F(M64) - F(n) - F(M64 - n)))

    log_thr64 = jnp.asarray(log_thr, f64)
    thr32 = log_thr64.astype(jnp.float32)
    # one ulp below the f32 threshold: the largest f32 strictly less than it
    thr_lo32 = jnp.nextafter(thr32, jnp.float32(-np.inf))

    shape = (C, R)
    init = (jnp.zeros(shape, f64),                 # log_pmf (live below hi)
            jnp.ones(shape, f64),                  # T mantissa
            jnp.zeros(shape, jnp.int32))           # T renorm exponent

    def step(carry, t):
        log_pmf, tm, te = carry
        t64 = t.astype(f64)
        at_hi = t64 == hi
        below = t64 < hi

        num = (K - t64) * (n - t64)
        den = (t64 + 1.0) * (M64 - K - n + t64 + 1.0)
        rho = num / jnp.where(den == 0.0, 1.0, den)
        safe_rho = jnp.where(rho > 0.0, rho, 1.0)

        log_pmf = jnp.where(at_hi, anchor,
                            jnp.where(below, log_pmf - jnp.log(safe_rho),
                                      log_pmf))
        tm = jnp.where(at_hi, 1.0, jnp.where(below, 1.0 + rho * tm, tm))
        te = jnp.where(at_hi, 0, te)
        over = tm > _RENORM
        tm = jnp.where(over, tm / _RENORM, tm)
        te = te + over.astype(jnp.int32)

        log_sf = jnp.minimum(
            log_pmf + jnp.log(tm) + te.astype(f64) * _LN_RENORM, 0.0)
        val32 = log_sf.astype(jnp.float32)
        sig = log_sf < log_thr64          # the f64 significance decision
        stored = jnp.where(sig, jnp.minimum(val32, thr_lo32),
                           jnp.maximum(val32, thr32))
        stored = jnp.where(t64 <= lo, jnp.float32(0.0),
                           jnp.where(t64 > hi, _SENTINEL, stored))
        return (log_pmf, tm, te), stored

    ts = jnp.arange(S_max - 1, -1, -1, dtype=jnp.int32)
    _, table = jax.lax.scan(step, init, ts)
    return table                                              # (S_max, C, R)


# slot-loop engine selection: per-cell 1-D gathers are slow, so above this
# many cells the slot loop — S_max bandwidth-bound (N, A) select-accumulate
# sweeps — is the faster resolve as long as S_max stays moderate. The
# crossover keeps the value it had before the GPU port; not yet re-measured
# on the GPU (ROADMAP.md).
LOOKUP_LOOP_MIN_CELLS = 2 ** 22
LOOKUP_LOOP_MAX_SMAX = 1024


def table_lookup(table, counts, nsize, colc, log_thr32, *, S_max: int,
                 R: int, C: int, lookup_group: int = 8):
    """Resolve (N, A) cells against the class table.

    counts: (N, A) f32 integer-valued census; nsize: (N,) f32 integer-valued
    neighborhood sizes; colc: (A,) int32 class index of each column.
    Returns (nes32, logsf32, bin8). Traceable (no jit boundary of its own) so
    fused pipelines can inline it.

    Two exact engines behind one signature, chosen at trace time from the
    static shapes: small surfaces use ONE per-cell 1-D gather; large surfaces
    (>= LOOKUP_LOOP_MIN_CELLS) use the slot loop, which replaces serialized
    gathers with S_max bandwidth-bound masked sweeps.

    ``lookup_group``: the slot loop's unroll depth — XLA keeps up to this
    many (N, A) f32 gather outputs LIVE per fori step, so at HBM-bound GO
    scale the census planner (safepy_tpu/hbm.census_select) dials it down
    (8 -> 4 -> 2 -> 1) to trade accumulator round-trips for peak memory.
    Results are bit-identical across groups (tests/test_hypergeom_table.py).
    """
    k = jnp.clip(jnp.round(counts).astype(jnp.int32), 0, S_max - 1)
    n_i = jnp.clip(jnp.round(nsize).astype(jnp.int32), 0, R - 1)
    cells = int(np.prod(counts.shape))
    if cells >= LOOKUP_LOOP_MIN_CELLS and S_max <= LOOKUP_LOOP_MAX_SMAX:
        logsf = _lookup_slot_loop(table, k, n_i, colc, S_max=S_max,
                                  group=int(lookup_group))
    else:
        idx = ((S_max - 1 - k) * (C * R)
               + colc.astype(jnp.int32)[None, :] * R
               + n_i[:, None])
        logsf = jnp.take(table.reshape(-1), idx, mode="clip")
    thr = jnp.asarray(log_thr32, jnp.float32)
    nbin = (logsf < thr).astype(jnp.int8)
    nes = -logsf / jnp.float32(np.log(10.0))
    return nes, logsf, nbin


def _lookup_slot_loop(table, k, n_i, colc, *, S_max: int, group: int = 8):
    """Exact gather-free resolve: one masked sweep per OCCURRING count value.

    For each count value ``kk`` (table slot ``s = S_max - 1 - kk``) the class
    axis is expanded to columns with a tiny row gather + transpose, the row
    axis with ONE (N, A) row gather (row gathers ride the DMA engines —
    lane/element gathers serialize), and cells matching the count select the
    value:

        acc += where(k == kk, table[S_max - 1 - kk][colc].T[n_i], 0)

    Exactly one sweep matches each cell. The loop runs ASCENDING in kk with a
    DYNAMIC upper bound max(k): S_max is padded to a power of two for jit
    signature reuse, but real counts are bounded by the largest neighborhood
    — at GO band scale S_max = 256 vs max(k) ~ 150, so the dynamic bound
    drops ~40% of the sweeps for free. ``group`` sweeps unroll per fori_loop
    step so the accumulator round-trips HBM once per group rather than once
    per sweep; sweeps past max(k) inside the last group match no cell (k is
    pre-clipped to S_max - 1, the slot index clamps at 0) and add zeros.
    """
    colc = colc.astype(jnp.int32)
    steps = (jnp.max(k) + group) // group          # dynamic: covers [0, max k]

    def body(step, acc):
        for g in range(group):
            kk = step * group + g
            s = S_max - 1 - jnp.minimum(kk, S_max - 1)
            w = jnp.take(jax.lax.dynamic_index_in_dim(
                table, s, axis=0, keepdims=False), colc, axis=0)  # (A, R)
            x = jnp.take(w.T, n_i, axis=0)                        # (N, A)
            acc = acc + jnp.where(k == kk, x, jnp.float32(0.0))
        return acc

    init = jnp.zeros(k.shape, jnp.float32)
    return jax.lax.fori_loop(0, steps, body, init)


def plan(K_np, n_max: int, M: int, *, chunk_cols: int = 512,
         budget_cells: int = 12 * 10 ** 8,
         chunk_budget_cells: int = 4 * 10 ** 8):
    """Host-side plan for the chunked table engine, or None if ineligible.

    Eligibility: integer K (binary annotations), integer n_max, and the table
    within budget. ``budget_cells`` bounds the summed f64 build WORK across
    chunks (always far cheaper than the per-cell tail loop it replaces);
    ``chunk_budget_cells`` bounds any single chunk's LIVE table (~1.6 GB
    f32), the actual memory constraint — chunks are transient, built,
    gathered from, and freed one at a time.

    Chunks run in NATURAL column order: each chunk's results land in a
    contiguous output slice (no pieces to concatenate, no column un-sort) —
    at 100k x 4,373 the sorted-pieces assembly transiently tripled the
    output footprint).

    Chunk signatures are UNIFIED when budgets allow: every distinct
    (R, S_max, C, width) tuple is a separately compiled program, so the
    tail chunk is re-windowed to
    end at ``n_attrs`` with full ``chunk_cols`` width (its leading
    ``overlap`` columns recompute the previous chunk's values identically —
    drivers overwrite in place and trim the overlap from per-chunk counts)
    and every chunk's geometry is lifted to the plan maximum. One program
    then serves the whole run.
    """
    K_np = np.asarray(K_np, np.float64)
    if K_np.size == 0 or not np.all(K_np == np.floor(K_np)):
        return None
    if n_max != int(n_max):
        return None
    n_max = int(n_max)

    n_attrs = len(K_np)
    chunks = []
    total = 0
    for s in range(0, n_attrs, chunk_cols):
        kc = K_np[s:s + chunk_cols]
        k_dist, colc = np.unique(kc, return_inverse=True)
        r, s_max = table_geometry(k_dist, n_max, M)
        c = 1
        while c < len(k_dist):
            c *= 2
        k_dist_padded = np.zeros(c, np.float64)
        k_dist_padded[:len(k_dist)] = k_dist
        cells = r * s_max * c
        if cells > chunk_budget_cells:
            return None
        total += cells
        chunks.append(dict(start=s, width=len(kc), overlap=0,
                           K_dist=k_dist_padded,
                           colc=colc.astype(np.int32), R=r, S_max=s_max, C=c))
    if total > budget_cells:
        return None
    chunks, total = _unify_chunk_signatures(
        chunks, total, K_np, n_max, M, chunk_cols,
        budget_cells, chunk_budget_cells)
    return dict(chunks=chunks, total_cells=total, n_max=n_max, M=int(M))


def _unify_chunk_signatures(chunks, total, K_np, n_max, M, chunk_cols,
                            budget_cells, chunk_budget_cells):
    """Collapse the plan to ONE (R, S_max, C, width) jit signature.

    Returns the (possibly rewritten) chunk list and its total build cells;
    leaves the plan untouched when unification would breach a budget (the
    maxima of R/S_max/C can come from different chunks) or when there is
    only one chunk.
    """
    if len(chunks) < 2:
        return chunks, total
    n_attrs = len(K_np)
    last = chunks[-1]
    if last["width"] < chunk_cols:
        s = n_attrs - chunk_cols
        kc = K_np[s:]
        k_dist, colc = np.unique(kc, return_inverse=True)
        r, s_max = table_geometry(k_dist, n_max, M)
        c = 1
        while c < len(k_dist):
            c *= 2
        k_dist_padded = np.zeros(c, np.float64)
        k_dist_padded[:len(k_dist)] = k_dist
        last = dict(start=s, width=chunk_cols, overlap=last["start"] - s,
                    K_dist=k_dist_padded, colc=colc.astype(np.int32),
                    R=r, S_max=s_max, C=c)
    r_u = max(ch["R"] for ch in chunks[:-1] + [last])
    s_u = max(ch["S_max"] for ch in chunks[:-1] + [last])
    c_u = max(ch["C"] for ch in chunks[:-1] + [last])
    cells_u = r_u * s_u * c_u
    # chunk_budget_cells is the live-HBM bound — strict; the total is a
    # WORK bound (~1 s per 1.2e9 cells), so allow the unified plan up to 2x
    # the already-accepted work: one saved remote compile pays for minutes
    if cells_u > chunk_budget_cells or cells_u * len(chunks) > 2 * total:
        return chunks, total
    unified = []
    for ch in chunks[:-1] + [last]:
        k_dist_padded = np.zeros(c_u, np.float64)
        k_dist_padded[:len(ch["K_dist"])] = ch["K_dist"]
        unified.append(dict(ch, K_dist=k_dist_padded,
                            R=r_u, S_max=s_u, C=c_u))
    return unified, cells_u * len(unified)
