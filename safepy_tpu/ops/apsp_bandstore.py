"""Band-STORAGE Floyd-Warshall: O(N*W) memory APSP for huge networks.

``ops/apsp_banded.py`` reduces the Floyd-Warshall *work* to O(N*W^2) by
relaxing only a W-wide window around each pivot, but it still materializes the
dense (N, N) matrix, which caps that path on one device. This module
removes the O(N^2) storage as well: the same radius certificate (every node of
a <= r shortest path lies within Euclidean r — hence within index separation B
in the banded order — of BOTH endpoints; see ops/apsp_banded.py) implies that
*every* matrix entry Floyd-Warshall ever needs for a <= r result lives within B
of the diagonal:

  * final pairs (u, v):   dist <= r  =>  sep(u, v) <= B;
  * subpath pairs (u, w): any intermediate w of the u-v path is itself the
    endpoint of a <= r subpath, so sep(u, w) <= B and sep(w, v) <= B;
  * edges longer than r can never lie on a <= r path and are dropped.

So the distance matrix is held in **block-row-aligned skewed storage**: with
tile size b and tile half-band bt = B//b + 1, row i (block I = i//b) stores the
contiguous column slab [(I-bt)*b, (I+bt+1)*b) — an (N_ghost, W) array with
W = (2*bt+1)*b, plus bt ghost block-rows of +inf on each side so pivot windows
never branch at the edges. Memory O(N*W) instead of O(N^2): a 100k-node network
with W ~ 6k holds 2.6 GB instead of 40 GB.

Per pivot block K the standard 3-phase blocked FW round (see
ops/apsp.apsp_blocked_fw) maps onto the skew:

  1. close the (b, b) diagonal tile — the pivot row's slab center, a STATIC
     column offset bt*b (the skew's first payoff);
  2. relax the pivot row P = S[K-row] against the closed diagonal (P's center
     becomes the closed diagonal, so phase 3 can use RAW column tiles: the
     composition Q_raw (x) closed (x) P_raw is covered by Q_raw (x) P_relaxed,
     and the column-panel update itself is phase 3's center-column update);
  3. relax the (W, W) window of block-rows [K-bt, K+bt]: in window coordinates
     (o = row offset, j = slab column tile) the three tiles of
     ``C = min(C, Q (x) P)`` sit at C = V[o, j], Q = V[o, 2bt - o] (the D[I, K]
     tile), P = P_ext[o + j] (the pivot slab inf-extended by bt tiles each
     side) — all affine in the grid indices, so the min-plus kernel
     (ops/minplus.relax_skew) needs no scalar prefetch.

Entries are exact for every pair whose true distance is <= the certified
radius and genuine-path upper bounds everywhere else, so thresholding the band
at the radius reproduces the reference's Dijkstra-cutoff neighborhoods
(safepy/safe.py:406-410) exactly — the companion helpers (`band_threshold`,
`band_row_sizes`, `band_matmul*`, `compact_band_columns`) then run the whole
downstream SAFE pipeline (census, scores, permutation null — safe.py:587-594,
safe_extras.py:15) against the band without ever densifying.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from safepy_tpu.ops import minplus

_INF = float("inf")


# ---------------------------------------------------------------------------
# Geometry of the storage
# ---------------------------------------------------------------------------

def band_params(n: int, band: int, block: int = 128):
    """(bt, nb, W): tile half-band, real block-row count, slab width.

    ``band`` is the certified element half-width B (ops/apsp_banded.banded_order);
    bt = B//b + 1 tiles guarantees every element pair with sep <= B lands in a
    stored tile (tile sep <= (B + b - 1)//b <= B//b + 1).
    """
    bt = band // block + 1
    nb = -(-n // block)
    w = (2 * bt + 1) * block
    return bt, nb, w


def band_nbytes(n: int, band: int, block: int = 128, itemsize: int = 4) -> int:
    """HBM footprint of the skewed storage (ghost rows included)."""
    bt, nb, w = band_params(n, band, block)
    return (nb + 2 * bt) * block * w * itemsize


def pack_band(dense, band: int, block: int = 128):
    """Dense (n, n) matrix (banded order) -> skewed storage. Test helper."""
    dense = np.asarray(dense)
    n = dense.shape[0]
    bt, nb, w = band_params(n, band, block)
    s = np.full(((nb + 2 * bt) * block, w), _INF, dtype=np.float32)
    for i_blk in range(nb):
        lo = (i_blk - bt) * block
        r0, r1 = i_blk * block, min((i_blk + 1) * block, n)
        for c in range(w):
            j = lo + c
            if 0 <= j < n:
                s[bt * block + r0: bt * block + r1, c] = dense[r0:r1, j]
    return jnp.asarray(s)


# ---------------------------------------------------------------------------
# Bit-packed indicator storage
#
# A 0/1 indicator band stores 8 columns per byte: uint8, LSB-first (bit j of
# byte c is column 8*c + j — numpy's bitorder='little'). Packedness is keyed
# on DTYPE: uint8 means packed bits, int8 means plain 0/1 — every banded
# consumer (band_matmul*, band_row_stats, apply_compaction, BandedMatrix)
# branches on it, so no caller threads an extra flag. The pack is an 8x lever
# on the two largest tail buffers (the indicator band and its valid-column
# compaction) AND on host downloads; consumers unpack per (block, W) tile
# inside their contraction loops, where the transient is tile-sized.
# ---------------------------------------------------------------------------

def is_packed_bits(x) -> bool:
    """True when ``x`` is a bit-packed indicator band (dtype-keyed)."""
    return x.dtype == jnp.uint8


def unpack_bits_tile(packed):
    """(r, w8) uint8 -> (r, 8*w8) bool, LSB-first. Tile-sized transient."""
    weights = jnp.asarray([1, 2, 4, 8, 16, 32, 64, 128], jnp.uint8)
    bits = (packed[:, :, None] & weights) != 0
    return bits.reshape(packed.shape[0], packed.shape[1] * 8)


def pack_bits_tile(ind):
    """(r, w) 0/1 values -> (r, w//8) uint8, LSB-first (w divisible by 8)."""
    r, w = ind.shape
    weights = jnp.asarray([1, 2, 4, 8, 16, 32, 64, 128], jnp.int32)
    bits = (ind.reshape(r, w // 8, 8) != 0).astype(jnp.int32)
    return jnp.sum(bits * weights, axis=-1).astype(jnp.uint8)


@jax.jit
def pack_band_bits(s_ind):
    """Whole-band pack (transient ~4 B/cell — fine at test scale; giant-band
    producers pack per block inside their loops instead)."""
    return pack_bits_tile(jnp.asarray(s_ind))


@jax.jit
def unpack_band_bits(packed):
    """Whole-band unpack to int8 (for small-scale consumers and tests)."""
    return unpack_bits_tile(jnp.asarray(packed)).astype(jnp.int8)


def unpack_band_bits_host(packed):
    """NumPy unpack (LSB-first) — the host side after a packed download."""
    packed = np.asarray(packed)
    return np.unpackbits(packed, axis=1, bitorder="little")


def unpack_band(s, n: int, band: int, block: int = 128, fill=_INF):
    """Skewed storage -> dense (n, n) with ``fill`` outside the stored band."""
    s = np.asarray(s)
    if s.dtype == np.uint8:  # bit-packed indicator (see is_packed_bits)
        s = unpack_band_bits_host(s)
    bt, nb, w = band_params(n, band, block)
    dense = np.full((n, n), fill, dtype=s.dtype)
    for i_blk in range(nb):
        lo = (i_blk - bt) * block
        c0 = max(0, -lo)
        c1 = min(w, n - lo)
        r0, r1 = i_blk * block, min((i_blk + 1) * block, n)
        dense[r0:r1, lo + c0:lo + c1] = \
            s[bt * block + r0: bt * block + r1, c0:c1]
    return dense


class BandedMatrix:
    """A device-resident skewed band plus its frame metadata — the facade's
    stand-in for the dense (N, N) neighborhood / distance matrices at
    band-storage scale.

    ``data`` rows are in the PERMUTED (banded-order) frame; ``rank`` maps
    original node i to its permuted position. ``fill`` is the implicit value
    outside the band (+inf for distances, 0 for indicators).
    """

    # dense materialization guard: ~2 GB of f32 (n ~ 22k)
    DENSE_MAX_BYTES = 2_000_000_000

    def __init__(self, data, rank, n: int, band: int, block: int = 128,
                 fill=_INF):
        self.data = data
        self.rank = np.asarray(rank)
        self.n = int(n)
        self.band = int(band)
        self.block = int(block)
        self.fill = fill

    @property
    def bt(self) -> int:
        return self.band // self.block + 1

    @property
    def shape(self):
        return (self.n, self.n)

    def dense_ok(self) -> bool:
        return 4 * self.n * self.n <= self.DENSE_MAX_BYTES

    def to_dense(self):
        """Dense (n, n) NumPy matrix in the ORIGINAL node frame (guarded)."""
        if not self.dense_ok():
            raise MemoryError(
                f"dense materialization of a {self.n}x{self.n} matrix "
                f"(~{4 * self.n * self.n / 1e9:.1f} GB) is disabled at "
                "band-storage scale; use to_sparse() / the banded pipeline "
                "outputs instead")
        dense = unpack_band(self.data, self.n, self.band, self.block,
                            fill=self.fill)
        return dense[self.rank][:, self.rank]

    def to_sparse(self):
        """scipy.sparse.csr_matrix of the finite / nonzero entries, original
        frame. O(nnz) host memory; the band is downloaded once (a
        bit-packed indicator band at 1 bit/cell)."""
        from scipy.sparse import coo_matrix

        s = np.asarray(self.data)
        if s.dtype == np.uint8:  # bit-packed indicator
            s = unpack_band_bits_host(s)
        bt, nb, w = band_params(self.n, self.band, self.block)
        real = s[bt * self.block:(bt + nb) * self.block]
        gi, c = np.nonzero(np.isfinite(real) if np.isinf(self.fill)
                           else real != 0)
        keep = gi < self.n
        gi, c = gi[keep], c[keep]
        gj = (gi // self.block - bt) * self.block + c
        keep = (gj >= 0) & (gj < self.n)
        gi, gj, c = gi[keep], gj[keep], c[keep]
        vals = real[gi, c]
        order = np.argsort(self.rank)  # permuted position -> original node
        return coo_matrix((vals, (order[gi], order[gj])),
                          shape=(self.n, self.n)).tocsr()

    def to_host(self):
        """Same wrapper with the band downloaded to NumPy (for pickling)."""
        out = BandedMatrix(np.asarray(self.data), self.rank, self.n,
                           self.band, self.block, self.fill)
        return out


@functools.partial(jax.jit, static_argnames=("n", "band", "block"))
def band_init_from_edges(u, v, w, *, n: int, band: int, block: int = 128):
    """Skewed-storage FW initialization from permuted edge arrays.

    u, v: int32 node ranks (banded order); w: f32 edge lengths. Only O(E) data
    crosses the host->device link. Edges whose tile separation exceeds the band
    are dropped — by the radius certificate they cannot lie on a <= r path
    (their Euclidean length alone exceeds what the band admits).
    """
    bt, nb, width = band_params(n, band, block)
    s = jnp.full(((nb + 2 * bt) * block, width), _INF, jnp.float32)

    # diagonal: row g = bt*b + i, skew column (i % b) + bt*b
    i = jnp.arange(n, dtype=jnp.int32)
    s = s.at[bt * block + i, (i % block) + bt * block].set(0.0)

    u = jnp.asarray(u, jnp.int32)
    v = jnp.asarray(v, jnp.int32)
    w = jnp.asarray(w, jnp.float32)
    uu = jnp.concatenate([u, v])
    vv = jnp.concatenate([v, u])
    ww = jnp.concatenate([w, w])
    col = vv - (uu // block - bt) * block  # skew column of (uu, vv)
    keep = (col >= 0) & (col < width)
    # min-reduce duplicates; dropped edges scatter into a scrap cell
    g = jnp.where(keep, bt * block + uu, 0)
    c = jnp.where(keep, col, 0)
    ww = jnp.where(keep, ww, jnp.inf)
    return s.at[g, c].min(ww)


# ---------------------------------------------------------------------------
# Band-storage blocked Floyd-Warshall
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("bt", "block", "impl"))
def apsp_band_fw(s, *, bt: int, block: int = 128, impl: str | None = None):
    """Blocked Floyd-Warshall over skewed band storage (see module docstring).

    ``s``: ((nb + 2*bt)*b, (2*bt+1)*b) f32 from :func:`band_init_from_edges` /
    :func:`pack_band`, holding a symmetric matrix (undirected graphs —
    reference safe.py:403-410). Returns the same frame with in-band entries
    exact for every pair whose true distance is within the certified radius.
    Each pivot window relaxes only its upper wedge and mirrors the lower
    (:func:`minplus.relax_skew`) — ~1.9x less min-plus work than the whole
    window; the mirror swaps which operand saw the phase-2-relaxed pivot row,
    so entries agree with the whole-window relax to f32 association noise.
    """
    impl = minplus.resolve(impl)
    width = s.shape[1]
    nb = s.shape[0] // block - 2 * bt

    def round_body(kb, s):
        kg = kb + bt
        p = jax.lax.dynamic_slice(s, (kg * block, 0), (block, width))
        diag = jax.lax.dynamic_slice(p, (0, bt * block), (block, block))
        diag = minplus.close_tile(diag, impl=impl)
        p = jax.lax.dynamic_update_slice(p, diag, (0, bt * block))
        p = minplus.relax(p, diag, p, impl=impl)
        s = jax.lax.dynamic_update_slice(s, p, (kg * block, 0))

        p_ext = jnp.pad(p, ((0, 0), (bt * block, bt * block)),
                        constant_values=_INF)
        win = jax.lax.dynamic_slice(s, ((kg - bt) * block, 0), (width, width))
        win = minplus.relax_skew(win, p_ext, bt=bt, block=block, impl=impl)
        return jax.lax.dynamic_update_slice(s, win, ((kg - bt) * block, 0))

    return jax.lax.fori_loop(0, nb, round_body, s)


@functools.partial(jax.jit, static_argnames=("bt", "block"))
def apsp_band_fw_whole(s, *, bt: int, block: int = 128):
    """Whole-window (non-mirrored) band FW in plain jnp: every in-band tile
    of every pivot window is relaxed — the reference the row-sharded band
    engine (parallel/band_sharded.py) matches bit for bit."""
    width = s.shape[1]
    nb = s.shape[0] // block - 2 * bt
    nt = 2 * bt + 1

    def round_body(kb, s):
        kg = kb + bt
        p = jax.lax.dynamic_slice(s, (kg * block, 0), (block, width))
        diag = jax.lax.dynamic_slice(p, (0, bt * block), (block, block))
        diag = minplus.close_tile(diag, impl="jnp")
        p = jax.lax.dynamic_update_slice(p, diag, (0, bt * block))
        p = minplus.relax_jnp(p, diag, p)
        s = jax.lax.dynamic_update_slice(s, p, (kg * block, 0))
        p_ext = jnp.pad(p, ((0, 0), (bt * block, bt * block)),
                        constant_values=_INF)

        def row_body(o, s):
            row = (kg - bt + o) * block
            c = jax.lax.dynamic_slice(s, (row, 0), (block, width))
            q = jax.lax.dynamic_slice(c, (0, (2 * bt - o) * block),
                                      (block, block))
            pw = jax.lax.dynamic_slice(p_ext, (0, o * block), (block, width))
            return jax.lax.dynamic_update_slice(
                s, minplus.relax_jnp(c, q, pw), (row, 0))

        return jax.lax.fori_loop(0, nt, row_body, s)

    return jax.lax.fori_loop(0, nb, round_body, s)


# ---------------------------------------------------------------------------
# Sparse Bellman-Ford band relaxation (the low-hop alternative to FW)
# ---------------------------------------------------------------------------

def band_bf_slots(u, v, w, *, n: int, band: int, block: int = 128):
    """Host-side per-node neighbor slots for :func:`apsp_band_bf`.

    u, v: int node ranks in the banded order; w: edge lengths (one entry per
    undirected edge — both directions are generated here). Out-of-band edges
    are dropped exactly as in :func:`band_init_from_edges`. Returns
    ``(nbr, dlt, wgt, S)``: ``nbr[i, s]`` the s-th neighbor of permuted row i
    (0-padded), ``dlt[i, s] = i//block - nbr//block`` the block skew offset
    (int8), ``wgt[i, s]`` the edge length (+inf padding), with ``S`` the max
    directed degree. Returns None when the skew offset would overflow int8
    (band >= ~16k elements — FW territory anyway).
    """
    bt, nb, width = band_params(n, band, block)
    if bt + 1 > 127:
        return None
    u = np.asarray(u, np.int64)
    v = np.asarray(v, np.int64)
    w = np.asarray(w, np.float32)
    uu = np.concatenate([u, v])
    vv = np.concatenate([v, u])
    ww = np.concatenate([w, w])
    col = vv - (uu // block - bt) * block
    keep = (col >= 0) & (col < width)
    uu, vv, ww = uu[keep], vv[keep], ww[keep]

    order = np.argsort(uu, kind="stable")
    uu, vv, ww = uu[order], vv[order], ww[order]
    idx = np.arange(len(uu), dtype=np.int64)
    first = np.r_[True, uu[1:] != uu[:-1]] if len(uu) else np.zeros(0, bool)
    group_start = np.maximum.accumulate(np.where(first, idx, 0))
    slot = idx - group_start
    S = int(slot.max()) + 1 if len(slot) else 1

    npad = nb * block
    nbr = np.zeros((npad, S), np.int32)
    dlt = np.zeros((npad, S), np.int8)
    wgt = np.full((npad, S), np.inf, np.float32)
    nbr[uu, slot] = vv.astype(np.int32)
    dlt[uu, slot] = (uu // block - vv // block).astype(np.int8)
    wgt[uu, slot] = ww
    return nbr, dlt, wgt, S


@functools.partial(jax.jit, static_argnames=("bt", "block", "max_iters",
                                             "group", "stripe"))
def apsp_band_bf(s, nbr, dlt, wgt, clamp, *, bt: int, block: int = 128,
                 max_iters: int = 512, group: int = 4, stripe: int = 1024):
    """Sparse Bellman-Ford relaxation over the skewed band storage.

    Floyd-Warshall does O(N*W^2) min-plus work regardless of the graph; for
    the radius-bounded problem a <= r shortest path has only L edges (L ~ 10
    on geometric kNN networks, L = r exactly on hop-metric networks,
    safe.py:408-410), so L rounds of the classic edge relaxation

        D[i, :] = min(D[i, :], w(i, m) + D[m, :])     for every neighbor m

    reach the same fixpoint in O(L * S * N * W) HBM traffic — each neighbor
    row is ONE contiguous slice of the flat band (a DMA-friendly slab
    gather; the skew offset ``dlt`` realigns columns, straddled lanes are
    masked +inf, which is EXACT: they are out-of-band for the neighbor row).
    Entries that exceed ``clamp`` (the inclusive radius) reset to +inf each
    round — sound because every prefix of a <= r shortest path is itself
    <= r, and it bounds convergence by L rather than the graph diameter.

    The round runs in column STRIPES written back in place (``stripe`` lanes
    at a time, clamped starts — overlap lanes recompute identically under
    min): peak HBM stays at the band + a few (npad, stripe) temps instead of
    ``group`` full-width gather buffers, and later stripes relax against
    already-updated earlier stripes (Gauss-Seidel — converges no slower,
    same fixpoint).

    Returns ``(s, converged, iters)``. ``converged`` False (max_iters hit)
    means the band holds upper bounds, not final distances — callers MUST
    fall back (e.g. finish with :func:`apsp_band_fw`, which is exact from any
    admissible upper-bound state). Unlike FW, beyond-radius in-band entries
    finish as +inf, matching the reference's Dijkstra-cutoff output shape
    (safe.py:406-410) even before the pipeline's radius mask.
    """
    width = s.shape[1]
    npad = s.shape[0] - 2 * bt * block
    S = nbr.shape[1]
    P = min(stripe, width)
    nstripes = -(-width // P)
    clamp = jnp.asarray(clamp, s.dtype)

    base = ((bt * block + nbr.astype(jnp.int32)) * width
            + dlt.astype(jnp.int32) * block)                  # (npad, S)
    shift = dlt.astype(jnp.int32) * block
    lane_lo = jnp.maximum(0, -shift)                          # (npad, S)
    lane_hi = jnp.minimum(width, width - shift)
    lane_p = jax.lax.broadcasted_iota(jnp.int32, (npad, P), 1)

    nsteps = -(-S // group)

    def body(carry):
        s, it, _ = carry

        def do_stripe(sp, carry):
            s, changed = carry
            c0 = jnp.minimum(sp * P, width - P)
            flat = s.reshape(-1)
            cur = jax.lax.dynamic_slice(s, (bt * block, c0), (npad, P))
            lane = lane_p + c0

            def step(k, acc):
                for g_i in range(group):
                    sl = jnp.minimum(k * group + g_i, S - 1)
                    st = jax.lax.dynamic_index_in_dim(base, sl, 1,
                                                      keepdims=False) + c0
                    ww = jax.lax.dynamic_index_in_dim(wgt, sl, 1,
                                                      keepdims=False)
                    l0 = jax.lax.dynamic_index_in_dim(lane_lo, sl, 1,
                                                      keepdims=False)
                    l1 = jax.lax.dynamic_index_in_dim(lane_hi, sl, 1,
                                                      keepdims=False)
                    g = jax.vmap(lambda p: jax.lax.dynamic_slice(
                        flat, (p,), (P,)))(st)
                    ok = (lane >= l0[:, None]) & (lane < l1[:, None])
                    acc = jnp.minimum(acc, jnp.where(ok, g, jnp.inf)
                                      + ww[:, None])
                return acc

            acc = jax.lax.fori_loop(0, nsteps, step, cur)
            acc = jnp.where(acc > clamp, jnp.inf, acc)
            changed = jnp.logical_or(changed, jnp.any(acc < cur))
            s = jax.lax.dynamic_update_slice(s, acc, (bt * block, c0))
            return s, changed

        s, changed = jax.lax.fori_loop(0, nstripes, do_stripe,
                                       (s, jnp.bool_(False)))
        return s, it + 1, changed

    def cond(carry):
        _, it, changed = carry
        return jnp.logical_and(changed, it < max_iters)

    s, iters, changed = jax.lax.while_loop(
        cond, body, (s, jnp.int32(0), jnp.bool_(True)))
    return s, jnp.logical_not(changed), iters


#: relative cost of one byte a BF round moves and one FW min-plus op; the
#: value predates the GPU port and is not yet re-measured on it (ROADMAP.md)
BF_BYTE_PER_FW_OP = 0.95


def bf_max_iters(n: int, band: int, S: int, block: int = 128,
                 floor: int = 16, cap: int = 512) -> int:
    """Iteration budget at which BF has spent ~one FW's worth of time.

    FW runs ~in-band (2bt+1)^2 tiles x 2*block^3 min-plus ops per round; one
    BF round moves ~2 reads + 1 write of S gathered (npad, W) slabs. With
    :data:`BF_BYTE_PER_FW_OP` the cost of a moved BF byte relative to a FW
    op, capping BF's rounds at their ratio bounds the worst
    (non-converging, fall-back-to-FW) case at ~2x FW while leaving
    geometric/hop networks (L ~ 10-20) far below the cap.
    """
    bt, nb, width = band_params(n, band, block)
    fw_ops = 0.75 * (2 * bt + 1) ** 2 * nb * 2 * block ** 3
    iter_bytes = 3 * S * nb * block * width * 4
    return int(np.clip(fw_ops / max(BF_BYTE_PER_FW_OP * iter_bytes, 1e-12),
                       floor, cap))


# ---------------------------------------------------------------------------
# Downstream consumers: threshold, sizes, matmuls — all without densifying
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("n", "band", "block"))
def euclidean_band_distances(coords_perm, *, n: int, band: int,
                             block: int = 128):
    """Banded pairwise Euclidean distances in the skewed storage frame.

    The euclidean metric (reference safe.py:389-399) needs no graph algorithm
    — per block-row the distances to its certified slab are computed directly
    from the coordinates, O(N*W) work and memory, which takes the scatter /
    UMAP annotation workflow (safe_io.py:271-285) to 100k+ points. Pairs
    beyond the band are +inf (they are beyond the radius by the band
    certificate); ghost/pad cells are masked to +inf explicitly (see the
    inline comment — sentinel coordinates would put two pads at distance 0).
    """
    cg, blk_d, bt, nb, width = _euclid_block_setup(coords_perm, n=n,
                                                   band=band, block=block)
    out = jnp.full(((nb + 2 * bt) * block, width), _INF, jnp.float32)
    z = jnp.int32(0)

    def blk(i, out):
        i = jnp.asarray(i, jnp.int32)
        return jax.lax.dynamic_update_slice(out, blk_d(i),
                                            ((i + bt) * block, z))

    return jax.lax.fori_loop(0, nb, blk, out)


def _euclid_block_setup(coords_perm, *, n: int, band: int, block: int):
    """Shared per-block-row distance computation for the euclidean band
    variants: returns (ghosted coords, blk_d(i) -> (block, width) f32
    distances with pad/diagonal handling, bt, nb, width)."""
    bt, nb, width = band_params(n, band, block)
    npad = nb * block

    coords_perm = jnp.asarray(coords_perm, jnp.float32)
    cg = jnp.zeros((npad + 2 * bt * block, 2), jnp.float32)
    cg = jax.lax.dynamic_update_slice(cg, coords_perm, (bt * block, 0))
    z = jnp.int32(0)

    def blk_d(i):
        rows = jax.lax.dynamic_slice(cg, ((i + bt) * block, z), (block, 2))
        slab = jax.lax.dynamic_slice(cg, (i * block, z), (width, 2))
        diff = rows[:, None, :] - slab[None, :, :]
        d = jnp.sqrt(jnp.maximum(jnp.sum(diff * diff, axis=-1), 0.0))
        # ghost/pad cells are masked to +inf EXPLICITLY (not via sentinel
        # coordinates — two pads would sit at distance 0 of each other); the
        # real diagonal is then re-set to an exact 0 despite float cancellation
        # (the diagonal cell of row r is slab position bt*block + r)
        row_g = i * block + jnp.arange(block, dtype=jnp.int32)
        col_g = (i - bt) * block + jnp.arange(width, dtype=jnp.int32)
        pad = ((row_g[:, None] >= n) | (col_g[None, :] < 0)
               | (col_g[None, :] >= n))
        d = jnp.where(pad, jnp.inf, d)
        r_idx = jnp.arange(block)
        return d.at[r_idx, r_idx + bt * block].set(
            jnp.where(row_g < n, 0.0, jnp.inf))

    return cg, blk_d, bt, nb, width


@functools.partial(jax.jit, static_argnames=("n", "band", "block", "packed"))
def euclidean_band_indicator(coords_perm, radius, *, n: int, band: int,
                             block: int = 128, packed: bool = False):
    """Strict ``dist < radius`` int8 indicator band computed DIRECTLY.

    Bit-identical to ``euclidean_band_distances(...) < radius`` (pinned in
    tests), but the loop carry is the 1-byte indicator instead of the 4-byte
    distance band — the f32 band never exists, so the euclidean pipelines
    with ``keep_distances=False`` peak at ~1/4 the device memory (reference
    safe.py:389-399 serves this metric from a dense host pdist).

    ``packed=True`` packs each block-row's indicator to uint8 bits as it is
    built (LSB-first; see is_packed_bits) — 1 bit/cell instead of 1 byte, the
    8x lever past the ~1M-point int8 ceiling.
    """
    cg, blk_d, bt, nb, width = _euclid_block_setup(coords_perm, n=n,
                                                   band=band, block=block)
    r = jnp.asarray(radius, jnp.float32)
    out = jnp.zeros(((nb + 2 * bt) * block, width // 8 if packed else width),
                    jnp.uint8 if packed else jnp.int8)
    z = jnp.int32(0)

    def blk(i, out):
        i = jnp.asarray(i, jnp.int32)
        ind = (blk_d(i) < r).astype(jnp.int8)
        if packed:
            ind = pack_bits_tile(ind)
        return jax.lax.dynamic_update_slice(out, ind, ((i + bt) * block, z))

    return jax.lax.fori_loop(0, nb, blk, out)


@functools.partial(jax.jit, static_argnames=("packed", "chunk_blocks",
                                             "block"))
def band_threshold(s, radius, *, packed: bool = False,
                   chunk_blocks: int = 256, block: int = 128):
    """<= radius indicator in the same skewed frame (int8 0/1 — the band is
    the dominant HBM object at scale, and every consumer casts per-block
    inside its contraction loop).

    Exact: in-band entries for true-distance <= radius pairs are exact, other
    entries are genuine-path upper bounds (> radius), and out-of-band pairs are
    beyond the radius by the certificate.

    ``packed=True`` emits the BIT-packed uint8 band (is_packed_bits) in
    row chunks of ``chunk_blocks`` blocks, so the transient is chunk-sized
    and the stored indicator is 1/32 of the f32 distance band.
    """
    if not packed:
        return (s <= jnp.asarray(radius, s.dtype)).astype(jnp.int8)

    r = jnp.asarray(radius, s.dtype)
    rows, width = s.shape
    nbg = rows // block
    cb = min(int(chunk_blocks), nbg)
    nsteps = -(-nbg // cb)
    out = jnp.zeros((rows, width // 8), jnp.uint8)

    def body(i, out):
        # the last chunk backs up to stay in range; overlapped rows repack
        # to the identical bytes before the overwrite
        blk0 = jnp.asarray(jnp.minimum(i * cb, nbg - cb) * block, jnp.int32)
        chunk = jax.lax.dynamic_slice(s, (blk0, jnp.int32(0)),
                                      (cb * block, width))
        return jax.lax.dynamic_update_slice(
            out, pack_bits_tile((chunk <= r).astype(jnp.int8)),
            (blk0, jnp.int32(0)))

    return jax.lax.fori_loop(0, nsteps, body, out)


def band_row_sizes(s_ind):
    """f32 per-row sums of a (possibly BIT-packed) indicator band."""
    if is_packed_bits(s_ind):
        # per-bit popcount over the packed bytes: 8 masked reductions read
        # the same total bytes as one unpacked pass but never materialize
        # the 8x unpacked band
        return sum(jnp.sum((s_ind & jnp.uint8(1 << k)) != 0, axis=1,
                           dtype=jnp.float32) for k in range(8))
    return jnp.sum(s_ind, axis=1, dtype=jnp.float32)


def band_row_stats(s_ind, *, n: int, bt: int, block: int = 128):
    """(sizes, mean, std) of neighborhood sizes from the banded indicator.

    Rows are padded/ghosted; only the n real rows count. Returns sizes in the
    PERMUTED frame (callers un-permute with inv_rank when they need per-node
    values; the mean/std are order-invariant)."""
    real = jax.lax.dynamic_slice_in_dim(s_ind, bt * block,
                                        s_ind.shape[0] - 2 * bt * block, 0)
    sizes = band_row_sizes(real)[:n]
    return sizes, jnp.mean(sizes), jnp.std(sizes)


def _ghost_pad_rows(x, pad_rows: int):
    return jnp.pad(x, ((pad_rows, pad_rows),) + ((0, 0),) * (x.ndim - 1))


@functools.partial(jax.jit, static_argnames=("bt", "block", "precision"))
def band_matmul(s_ind, x, *, bt: int, block: int = 128,
                precision: str = "highest"):
    """(banded indicator) @ x without densifying: block-row slab contractions.

    s_ind: skewed storage ((nb+2bt)*b, W); x: (npad, A) in the SAME permuted
    row frame (npad = nb*b, zero-padded). Returns (npad, A).

    Per block-row I the stored slab covers exactly rows [(I-bt)*b, (I+bt+1)*b)
    of x, so the product is nb GEMMs of (b, W) x (W, A) — O(N*W*A) work,
    the banded analog of the reference's census/score GEMMs (safe.py:593,
    safe_extras.py:15).
    """
    from safepy_tpu.ops.score import dot_kwargs
    kw = dot_kwargs(precision)
    packed = is_packed_bits(s_ind)
    width = s_ind.shape[1] * (8 if packed else 1)
    nb = s_ind.shape[0] // block - 2 * bt
    xg = _ghost_pad_rows(jnp.asarray(x, jnp.float32), bt * block)

    def blk(i, out):
        rows = jax.lax.dynamic_slice(s_ind, ((i + bt) * block, 0),
                                     (block, s_ind.shape[1]))
        if packed:
            rows = unpack_bits_tile(rows)
        rows = rows.astype(jnp.float32)
        slab = jax.lax.dynamic_slice(xg, (i * block, 0), (width, x.shape[1]))
        return jax.lax.dynamic_update_slice(out, jnp.dot(rows, slab, **kw),
                                            (i * block, 0))

    out = jnp.zeros((nb * block, x.shape[1]), jnp.float32)
    return jax.lax.fori_loop(0, nb, blk, out)


@functools.partial(jax.jit, static_argnames=("bt", "block", "precision"))
def band_matmul_batch(s_rows, x_batch, starts, *, bt: int, block: int = 128,
                      precision: str = "highest"):
    """Batched banded product against per-block-row slabs at dynamic offsets.

    s_rows: ((nb+2bt)*b, W) banded indicator (possibly column-COMPACTED — see
    :func:`compact_band_columns`); x_batch: (C, V_pad, A) value rows;
    starts: (nb,) int32 slab start row of each block-row inside x_batch.
    Returns (C, npad, A) — the permutation-chunk score contraction of
    ops/permutation.py restricted to the band.
    """
    from safepy_tpu.ops.score import dot_kwargs
    kw = dot_kwargs(precision)
    packed = is_packed_bits(s_rows)
    width = s_rows.shape[1] * (8 if packed else 1)
    nb = s_rows.shape[0] // block - 2 * bt
    c_dim, v_pad, a_dim = x_batch.shape

    def blk(i, out):
        i = jnp.asarray(i, jnp.int32)
        z = jnp.int32(0)
        rows = jax.lax.dynamic_slice(s_rows, ((i + bt) * block, z),
                                     (block, s_rows.shape[1]))
        if packed:
            rows = unpack_bits_tile(rows)
        rows = rows.astype(jnp.float32)
        slab = jax.lax.dynamic_slice(x_batch, (z, starts[i], z),
                                     (c_dim, width, a_dim))
        prod = jnp.einsum("nv,cva->cna", rows, slab, **kw)
        return jax.lax.dynamic_update_slice(out, prod, (z, i * block, z))

    out = jnp.zeros((c_dim, nb * block, a_dim), jnp.float32)
    return jax.lax.fori_loop(0, nb, blk, out)


@functools.partial(jax.jit, static_argnames=("bt", "block", "precision"))
def band_count_batch(s_rows, x_batch, starts, obs, live, *, bt: int,
                     block: int = 128, precision: str = "highest"):
    """Two-sided tie-inclusive counts of ONE permutation chunk against the
    banded (compacted, possibly bit-packed) indicator — the fused form of
    ``band_matmul_batch`` + the comparisons in ops/permutation.count_scan
    (reference safe_extras.py:64-66).

    The (C, npad, A) chunk-score array never materializes: per block-row the
    (C, b, A) products are compared against the observed block immediately,
    so the permutation tail's largest temp drops from C*npad*A f32 to
    block-sized — several GB at million-node scale. Bit-identical to the
    unfused path (same f32 products, same tie comparisons; pinned in tests).

    obs: (npad, A) observed scores (permuted frame); live: (C,) bool chunk
    liveness. Returns int32 (npad, A) counts_neg / counts_pos of this chunk.
    """
    from safepy_tpu.ops.score import dot_kwargs
    kw = dot_kwargs(precision)
    packed = is_packed_bits(s_rows)
    width = s_rows.shape[1] * (8 if packed else 1)
    nb = s_rows.shape[0] // block - 2 * bt
    c_dim, v_pad, a_dim = x_batch.shape
    lv = live[:, None, None]

    def blk(i, carry):
        cn, cp = carry
        i = jnp.asarray(i, jnp.int32)
        z = jnp.int32(0)
        rows = jax.lax.dynamic_slice(s_rows, ((i + bt) * block, z),
                                     (block, s_rows.shape[1]))
        if packed:
            rows = unpack_bits_tile(rows)
        rows = rows.astype(jnp.float32)
        slab = jax.lax.dynamic_slice(x_batch, (z, starts[i], z),
                                     (c_dim, width, a_dim))
        prod = jnp.einsum("nv,cva->cna", rows, slab, **kw)
        ob = jax.lax.dynamic_slice(obs, (i * block, z), (block, a_dim))[None]
        cn_b = jnp.sum(jnp.where(lv & (prod <= ob), 1, 0), axis=0,
                       dtype=jnp.int32)
        cp_b = jnp.sum(jnp.where(lv & (prod >= ob), 1, 0), axis=0,
                       dtype=jnp.int32)
        cn = jax.lax.dynamic_update_slice(cn, cn_b, (i * block, z))
        cp = jax.lax.dynamic_update_slice(cp, cp_b, (i * block, z))
        return cn, cp

    zeros = jnp.zeros((nb * block, a_dim), jnp.int32)
    # inherit the permuted values' varying-manual-axes so the fori carry's
    # type matches the body under shard_map (see count_scan's zeros trick)
    zeros = zeros + (x_batch.ravel()[0] * 0).astype(jnp.int32)
    return jax.lax.fori_loop(0, nb, blk, (zeros, zeros))


def compaction_plan(valid, *, n: int, bt: int, block: int = 128):
    """Host half of the valid-column compaction (see compact_band_columns).

    ``valid`` is host data (the NaN row census): the slab starts and the
    static compacted width are computable before any jit. Returns
    (starts (nb,) int64, w_c).
    """
    valid = np.asarray(valid).astype(bool)
    nb = -(-n // block)
    width = (2 * bt + 1) * block

    cum = np.concatenate([[0], np.cumsum(valid)])
    lo = (np.arange(nb) - bt) * block
    hi = np.clip(lo + width, 0, n)
    lo_c = np.clip(lo, 0, n)
    starts = cum[lo_c]
    counts = cum[hi] - cum[lo_c]
    w_c = int(-(-max(1, counts.max()) // block) * block)
    w_c = min(w_c, width)
    return np.asarray(starts, np.int64), w_c


# Block-rows per compaction-sort chunk. A STABLE variadic sort may be lowered
# with an s32 iota tiebreaker operand the full size of the sorted array —
# 4 bytes/cell against the 1-byte indicator, 10.7 GB at 349,440 nodes /
# 125-node neighborhoods.
# Chunking the row-independent sort over block-row slices shrinks the iota
# and the key/masked temporaries to chunk size with bit-identical results;
# bands at or under the chunk take the original single-sort path untouched.
# The effective chunk also adapts to the slab WIDTH (giant bands at
# million-node scale are ~3x wider than the 350k tuning shape), capping the
# chunk at COMPACTION_CHUNK_CELLS so the sort temporaries stay flat.
COMPACTION_CHUNK_BLOCKS = 256
COMPACTION_CHUNK_CELLS = 256 * 128 * 8192


def _compaction_chunk_blocks(chunk_blocks: int, width: int,
                             block: int) -> int:
    if not chunk_blocks:
        return 0
    return max(32, min(int(chunk_blocks),
                       COMPACTION_CHUNK_CELLS // (width * block)))


@functools.partial(jax.jit, static_argnames=("w_c", "bt", "block",
                                             "chunk_blocks"))
def apply_compaction(s_ind, valid, w_c: int, *, bt: int, block: int = 128,
                     row_block_offset=0,
                     chunk_blocks: int = COMPACTION_CHUNK_BLOCKS):
    """Device half of the compaction: stable lane-sorts (jit-compatible).

    ``valid``: (n,) bool device/host array in the permuted order. The per-slab
    invalid-last sort keys are built ON DEVICE from it (an (N_ghost, W) key
    array would rival the band itself in HBM; the bitmap is O(N)). Indicator
    entries of INVALID columns must not contribute at all — they are zeroed
    before the sort so the compacted tail is exact zeros, not the invalid
    columns' values shuffled right.

    ``row_block_offset`` (traced ok): global ghosted block-row index of
    s_ind's first row — the mesh-sharded workers pass their shard origin so
    each slab sees the right slice of the global validity staircase.

    ``chunk_blocks``: sort at most this many block-rows per dispatch (see
    COMPACTION_CHUNK_BLOCKS); 0 disables chunking. Each row's sort is
    independent and the keys depend only on the row's block, so chunked and
    single-shot results are bit-identical (pinned in test_bandstore).
    """
    packed = is_packed_bits(s_ind)  # packed in => packed out (dtype-keyed)
    width = s_ind.shape[1] * (8 if packed else 1)
    nbg = s_ind.shape[0] // block  # ghosted block-rows in THIS shard
    valid = jnp.asarray(valid)

    # absolute column of slab cell (Ig, c) is (Ig - 2*bt)*b + c; out-of-range
    # clips into the False padding of the extended bitmap (both ends)
    pad = 2 * bt * block
    ext_len = valid.shape[0] + 2 * pad
    valid_ext = jnp.zeros(ext_len, bool).at[pad:pad + valid.shape[0]].set(valid)
    off = jnp.asarray(row_block_offset, jnp.int32)

    def keys_for(blk0, nblk):
        # int8 keys AND int8 sort values: the materialized arrays scale with
        # the sorted slice, so dtype is a 4x lever on the compaction's peak
        # memory (the indicator is 0/1; only the final w_c-wide compacted
        # slice returns to f32 for the GEMM)
        cols = ((off + blk0 + jnp.arange(nblk, dtype=jnp.int32)[:, None]
                 - 2 * bt) * block
                + jnp.arange(width, dtype=jnp.int32)[None, :]) + pad
        cols = jnp.clip(cols, 0, ext_len - 1)
        keys_blk = (~valid_ext[cols]).astype(jnp.int8)       # (nblk, W)
        return jnp.broadcast_to(keys_blk[:, None, :],
                                (nblk, block, width)).reshape(nblk * block,
                                                              width)

    def sort_rows(rows_i8, keys):
        masked = rows_i8 * (1 - keys)
        comp = jax.lax.sort((keys, masked), dimension=-1,
                            num_keys=1, is_stable=True)[1][:, :w_c]
        # packed input => packed output: the sort itself runs on the
        # tile/chunk-sized int8 transient, but the stored compaction keeps
        # the 1-bit density (w_c is block-padded, hence divisible by 8)
        return pack_bits_tile(comp) if packed else comp

    s_i8 = jnp.asarray(s_ind) if packed else jnp.asarray(s_ind).astype(jnp.int8)

    def chunk_rows(blk0, nblk):
        rows = jax.lax.dynamic_slice(
            s_i8, (jnp.asarray(blk0 * block, jnp.int32), jnp.int32(0)),
            (nblk * block, s_i8.shape[1]))
        if packed:
            rows = unpack_bits_tile(rows).astype(jnp.int8)
        return rows

    cb = _compaction_chunk_blocks(chunk_blocks, width, block)
    if not cb or nbg <= cb:
        return sort_rows(chunk_rows(jnp.int32(0), nbg), keys_for(0, nbg))

    nsteps = -(-nbg // cb)

    def body(i, out):
        # the last chunk backs up to stay in range; overlapped rows re-sort
        # to the identical result before the overwrite
        blk0 = jnp.minimum(i * cb, nbg - cb)
        return jax.lax.dynamic_update_slice(
            out, sort_rows(chunk_rows(blk0, cb), keys_for(blk0, cb)),
            (blk0 * block, 0))

    out = jnp.zeros((nbg * block, w_c // 8 if packed else w_c),
                    jnp.uint8 if packed else jnp.int8)
    return jax.lax.fori_loop(0, nsteps, body, out)


def compact_band_columns(s_ind, valid, *, bt: int, block: int = 128):
    """Restrict the banded indicator to valid COLUMNS, keeping bandedness.

    The permutation null contracts against only the rows of node2attribute
    with >= 1 finite value (reference safe_extras.py:50-58 permutes exactly
    those). A dense column gather would destroy the band; instead each
    block-row's slab is stably lane-sorted by its columns' validity (invalid
    last) — every row in a block shares the slab, hence the same sort order,
    so compacted columns stay aligned, and globally they form the monotone
    'staircase' of valid-column ranks.

    Args:
      s_ind: skewed banded indicator ((nb+2bt)*b, W).
      valid: (n,) bool/0-1 host array marking valid columns in the SAME
        permuted order.

    Returns (compact, starts, w_c):
      compact: ((nb+2bt)*b, w_c) — column c of block-row I is the indicator of
        the (starts[I] + c)-th valid node overall;
      starts: (nb,) int32 — rank of the first valid column of each slab;
      w_c: static compacted width (tile-padded max valid count per slab).
    """
    n = np.asarray(valid).shape[0]
    starts, w_c = compaction_plan(valid, n=n, bt=bt, block=block)
    return (apply_compaction(s_ind, np.asarray(valid).astype(bool), w_c,
                             bt=bt, block=block),
            jnp.asarray(starts, jnp.int32), w_c)
