"""Min-plus tile relaxation for every Floyd-Warshall engine, and the one
place that decides how it runs.

All blocked FW variants in the package (dense, radius-bounded window, band
store, row- and 2-D-sharded, row-sharded band store) spend their time in one
operation over a pivot depth of one storage tile (``block``, 128 by default)::

    C = min(C, A (x) B),    (A (x) B)[i, j] = min_k A[i, k] + B[k, j].

(min, +) has no tensor-core or BLAS form, so it runs on the card's plain
fp32 units. Implementations, named by ``impl``:

  * ``"triton"`` — a Pallas kernel on the Triton route. One program owns a
    (bm, bn) output tile and keeps it in registers while it walks the pivot
    depth one k at a time, loading A's column k and B's row k (L1-cached)
    and folding ``a[:, k] + b[k, :]`` into the tile; no candidate reaches
    device memory. Measured on an H100 it beats the plain jnp version 5-17x
    over whole FWs (PERF.md, "Kernels on the H100").
  * ``"interpret"`` — the same kernel in the Pallas interpreter. Only a
    caller that asks for it gets it (tests, CPU rehearsal of chip_smoke.py).
  * ``"jnp"`` — plain jax.numpy: a loop over k-chunks of a fused
    broadcast-min. The CPU path and the oracle the kernel is held to.

Each candidate is one f32 add and ``min`` is exact and order-free, so every
implementation returns the same bits.

The structured relaxations (upper triangle plus mirror for symmetric
matrices, the band store's skewed wedge) are written once here; ``impl``
changes only how a tile is relaxed, never which tiles are.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

_INF = float("inf")

IMPLS = ("triton", "interpret", "jnp")

#: Kernel tiling (rows, cols, warps) of the Triton relax kernel — the
#: fastest over the FW engines in an H100 sweep (tools/minplus_bench.py).
TILES = (64, 64, 8)
#: k-chunk of the jnp implementation's fused broadcast-min.
JNP_CHUNK = 8
#: warps of the single-program diagonal-closure kernel.
CLOSE_WARPS = 8


def resolve(impl: str | None = None, platform: str | None = None) -> str:
    """The min-plus implementation to run: ``impl`` when given, else the
    platform's. 'gpu' gets the Triton kernel, 'cpu' the jnp reference; any
    other platform raises rather than fall back to code written for neither.

    The platform defaults to that of ``jax.default_device`` when one is set
    (part of every jit cache key), else the default backend's, so a program
    placed on the CPU inside a GPU process still gets the CPU's impl.
    """
    if impl is not None:
        if impl not in IMPLS:
            raise ValueError(f"unknown min-plus impl {impl!r}; one of {IMPLS}")
        return impl
    if platform is None:
        dev = jax.config.jax_default_device
        if dev is None:
            platform = jax.default_backend()
        else:
            platform = dev if isinstance(dev, str) else dev.platform
    if platform == "gpu":
        return "triton"
    if platform == "cpu":
        return "jnp"
    raise RuntimeError(
        f"no min-plus implementation for platform {platform!r} "
        "(supported: gpu, cpu)")


# ---------------------------------------------------------------------------
# jnp implementation
# ---------------------------------------------------------------------------

def relax_jnp(c, a, b, *, chunk: int | None = None):
    """min(c, a (x) b) in plain jax.numpy, ``chunk`` pivots per step
    (default :data:`JNP_CHUNK`)."""
    k_dim = a.shape[1]
    kc = math.gcd(k_dim, chunk or JNP_CHUNK)
    if kc == k_dim:
        return jnp.minimum(c, jnp.min(a[:, :, None] + b[None, :, :], axis=1))

    def body(i, acc):
        a_c = jax.lax.dynamic_slice_in_dim(a, i * kc, kc, 1)
        b_c = jax.lax.dynamic_slice_in_dim(b, i * kc, kc, 0)
        return jnp.minimum(acc, jnp.min(a_c[:, :, None] + b_c[None, :, :],
                                        axis=1))

    return jax.lax.fori_loop(0, k_dim // kc, body, c)


def _close_jnp(t):
    """In-tile Floyd-Warshall closure of a square tile, one pivot per step."""
    n = t.shape[0]

    def body(k, t):
        col = jax.lax.dynamic_slice(t, (0, k), (n, 1))
        row = jax.lax.dynamic_slice(t, (k, 0), (1, n))
        return jnp.minimum(t, col + row)

    return jax.lax.fori_loop(0, n, body, t)


# ---------------------------------------------------------------------------
# Triton kernels
# ---------------------------------------------------------------------------

def _relax_kernel(a_ref, b_ref, c_ref, o_ref, *, mask):
    """o = min(c, a (x) b) for one (bm, bn) tile; a is (bm, K), b (K, bn).

    With a ``mask`` of the program ids, a masked-off program writes nothing
    (the caller aliases C to the output, so its tile keeps C's values)."""

    def compute():
        def body(k, acc):
            return jnp.minimum(acc, a_ref[:, pl.ds(k, 1)]
                               + b_ref[pl.ds(k, 1), :])

        o_ref[...] = jax.lax.fori_loop(jnp.int32(0),
                                       jnp.int32(a_ref.shape[1]), body,
                                       c_ref[...])

    if mask is None:
        compute()
    else:
        pl.when(mask(pl.program_id(0), pl.program_id(1)))(compute)


def _relax_call(c, a, b, *, grid, c_map, a_map, b_map, mask, interpret,
                tiles):
    """One pallas_call of :func:`_relax_kernel` (maps in kernel-tile units)."""
    bm, bn, warps = tiles
    k_dim = a.shape[1]
    return pl.pallas_call(
        functools.partial(_relax_kernel, mask=mask),
        backend="triton",
        grid=grid,
        in_specs=[pl.BlockSpec((bm, k_dim), a_map),
                  pl.BlockSpec((k_dim, bn), b_map),
                  pl.BlockSpec((bm, bn), c_map)],
        out_specs=pl.BlockSpec((bm, bn), c_map),
        out_shape=jax.ShapeDtypeStruct(c.shape, jnp.float32),
        input_output_aliases={2: 0} if mask is not None else {},
        compiler_params=pl_triton.CompilerParams(num_warps=warps,
                                                 num_stages=2),
        interpret=interpret,
    )(a, b, c)


def _kernel_tiles(block: int, tiles):
    """Kernel tiles (default :data:`TILES`) clipped to the storage tile,
    which they must divide."""
    bm, bn, warps = tiles or TILES
    bm, bn = min(bm, block), min(bn, block)
    if block % bm or block % bn:
        raise ValueError(f"kernel tile {bm}x{bn} does not divide block {block}")
    return bm, bn, warps


def _close_kernel(t_ref, o_ref, *, interpret: bool):
    """Floyd-Warshall closure of one tile in one program.

    The tile stays in registers; pivot k's row and column are read back from
    the output buffer, where each step leaves the next pivot's row and column
    (a masked store) between two block barriers. The interpreter runs the
    whole tile at once and needs no barrier (it has none)."""
    n = t_ref.shape[0]
    barrier = (lambda: None) if interpret else pl_triton.debug_barrier
    row_id = jax.lax.broadcasted_iota(jnp.int32, (n, n), 0)
    col_id = jax.lax.broadcasted_iota(jnp.int32, (n, n), 1)
    t = t_ref[...]
    o_ref[...] = t
    barrier()

    def body(k, t):
        t = jnp.minimum(t, o_ref[:, pl.ds(k, 1)] + o_ref[pl.ds(k, 1), :])
        barrier()  # every read of pivot k is done
        pl_triton.store(o_ref, t, mask=(row_id == k + 1) | (col_id == k + 1))
        barrier()  # pivot k + 1 is in place
        return t

    o_ref[...] = jax.lax.fori_loop(jnp.int32(0), jnp.int32(n), body, t)


# ---------------------------------------------------------------------------
# Public relaxations
# ---------------------------------------------------------------------------

def relax(c, a, b, *, impl: str, tiles=None):
    """min(c, a (x) b) over whole storage tiles.

    c: (M, N); a: (M, K); b: (K, N), f32, with M and N multiples of the
    kernel tile (any multiple of the 128 storage tile is)."""
    if impl == "jnp":
        return relax_jnp(c, a, b)
    m, n = c.shape
    bm, bn, warps = _kernel_tiles(math.gcd(m, n), tiles)
    return _relax_call(
        c, a, b, grid=(m // bm, n // bn),
        c_map=lambda i, j: (i, j), a_map=lambda i, j: (i, j * 0),
        b_map=lambda i, j: (i * 0, j), mask=None,
        interpret=impl == "interpret", tiles=(bm, bn, warps))


def close_tile(t, *, impl: str):
    """Floyd-Warshall closure of one square (block, block) tile."""
    if impl == "jnp":
        return _close_jnp(t)
    n = t.shape[0]
    return pl.pallas_call(
        functools.partial(_close_kernel, interpret=impl == "interpret"),
        backend="triton", grid=(1,),
        in_specs=[pl.BlockSpec((n, n), lambda i: (i, i))],
        out_specs=pl.BlockSpec((n, n), lambda i: (i, i)),
        out_shape=jax.ShapeDtypeStruct(t.shape, jnp.float32),
        compiler_params=pl_triton.CompilerParams(num_warps=CLOSE_WARPS,
                                                 num_stages=1),
        interpret=impl == "interpret",
    )(t)


def _tile_ids(n: int, block: int):
    ids = jnp.arange(n, dtype=jnp.int32) // block
    return ids[:, None], ids[None, :]


def mirror_lower(d, *, block: int, band_tiles: int):
    """Overwrite in-band tiles below the diagonal with the transpose of their
    upper mirror (square ``d``)."""
    ti, tj = _tile_ids(d.shape[0], block)
    lower = (ti > tj) & (ti - tj <= band_tiles)
    return jnp.where(lower, d.T, d)


def relax_upper(d, q, p, *, block: int, band_tiles: int, impl: str,
                tiles=None):
    """Symmetric min(D, Q (x) P) over tiles within ``band_tiles`` of the
    diagonal; tiles further out pass through.

    For the symmetric matrices undirected graphs produce, ``q == p.T``
    bitwise (both are the raw pivot panel relaxed once against the
    bitwise-symmetric closed diagonal), so the update of a lower tile is
    exactly the transpose of its mirror's: only tiles (I, J) with
    0 <= J - I <= band_tiles are relaxed, then mirrored (~2x less work,
    bit-identical to relaxing all in-band tiles)."""
    w = d.shape[0]
    if impl == "jnp":
        ti, tj = _tile_ids(w, block)
        upper = (tj >= ti) & (tj - ti <= band_tiles)
        out = jnp.where(upper, relax_jnp(d, q, p), d)
    else:
        bm, bn, warps = _kernel_tiles(block, tiles)
        rm, rn = block // bm, block // bn

        def mask(i, j):
            big_i, big_j = i // rm, j // rn
            return (big_j >= big_i) & (big_j - big_i <= band_tiles)

        out = _relax_call(
            d, q, p, grid=(w // bm, w // bn),
            c_map=lambda i, j: (i, j), a_map=lambda i, j: (i, j * 0),
            b_map=lambda i, j: (i * 0, j), mask=mask,
            interpret=impl == "interpret", tiles=(bm, bn, warps))
    return mirror_lower(out, block=block, band_tiles=band_tiles)


def relax_skew(win, p_ext, *, bt: int, block: int, impl: str, tiles=None):
    """Symmetric min(C, Q (x) P) over the band store's (W, W) skewed pivot
    window (see ops/apsp_bandstore.py for the frame).

    Window tile (o, j) holds D[K-bt+o, K-2bt+o+j], its Q tile is window tile
    (o, 2bt-o) (= D[I, K]) and its P tile is ``p_ext`` tile o+j (the pivot
    row padded with bt +inf tiles each side). The upper wedge j >= bt is
    relaxed, except tiles with o+j > 3bt, whose P tile is +inf; the lower
    in-band tiles (j < bt <= o+j) become the transpose of their mirror
    (o+j-bt, 2bt-j); lower tiles out of band pass through.

    Q is gathered into its own (W, block) strip first: the wedge includes the
    Q tiles of rows o <= bt, and a kernel that relaxed them in place while
    other programs read them would race."""
    nt = 2 * bt + 1
    tiles4 = win.reshape(nt, block, nt, block).transpose(0, 2, 1, 3)
    o_idx = jnp.arange(nt)
    q = tiles4[o_idx, 2 * bt - o_idx].reshape(nt * block, block)
    if impl == "jnp":
        def row_body(o, acc):
            c = jax.lax.dynamic_slice(acc, (o * block, bt * block),
                                      (block, (bt + 1) * block))
            qo = jax.lax.dynamic_slice(q, (o * block, 0), (block, block))
            p = jax.lax.dynamic_slice(p_ext, (0, (o + bt) * block),
                                      (block, (bt + 1) * block))
            return jax.lax.dynamic_update_slice(acc, relax_jnp(c, qo, p),
                                                (o * block, bt * block))

        out = jax.lax.fori_loop(0, nt, row_body, win)
    else:
        bm, bn, warps = _kernel_tiles(block, tiles)
        rm, rn = block // bm, block // bn

        def mask(i, s):
            return i // rm + s // rn <= 2 * bt

        out = _relax_call(
            win, q, p_ext, grid=(nt * rm, (bt + 1) * rn),
            c_map=lambda i, s: (i, s + bt * rn),
            a_map=lambda i, s: (i, s * 0),
            b_map=lambda i, s: (i * 0, s + (i // rm + bt) * rn),
            mask=mask, interpret=impl == "interpret",
            tiles=(bm, bn, warps))
    return _mirror_skew(out, bt=bt, block=block)


def _mirror_skew(win, *, bt: int, block: int):
    nt = 2 * bt + 1
    t = win.reshape(nt, block, nt, block).transpose(0, 2, 1, 3)
    o = jnp.arange(nt)[:, None]
    j = jnp.arange(bt)[None, :]
    src = t[jnp.clip(o + j - bt, 0, nt - 1), 2 * bt - j].swapaxes(-1, -2)
    lower = jnp.where((o + j >= bt)[:, :, None, None], src, t[:, :bt])
    t = jnp.concatenate([lower, t[:, bt:]], axis=1)
    return t.transpose(0, 2, 1, 3).reshape(nt * block, nt * block)
