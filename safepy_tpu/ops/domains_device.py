"""Device kernels for the attribute->domain stage at band-storage scale.

The reference clusters top attributes with average-linkage over the jaccard
distance of their binary enrichment columns (safe.py:672-674: ``m =
self.nes_binary[:, self.attributes['top']].T`` -> ``linkage(m, 'average',
'jaccard')``). scipy's linkage computes the pdist internally: A_top^2/2 pairs
x N elements each — hours at the 4,373-term GO scale the band engine serves
(tools/domain_scale_profile.py measures it on the host).

Binary jaccard only needs pairwise INTERSECTION counts, and intersections of
0/1 columns are one GEMM: ``inter = B^T B``. The division happens on HOST in f64 from the exact integer counts,
reproducing scipy's double-precision jaccard bit-for-bit — so
``linkage(condensed, 'average')`` returns the identical dendrogram and the
clustering is provably unchanged (pinned in tests/test_domains_device.py).

bf16 is exact here: 0/1 inputs are exactly representable, every product is
0/1, and the GEMM accumulates into f32 where integer sums stay exact below
2^24 (N < 16.7M).

The same GEMM trick serves the node->domain count matrix (reference
safe.py:683-695: groupby-sum of nes_binary columns by domain =
``B @ onehot(domain)``), and a transposed segment-max serves the per-domain
NES maxima — both consume the facade's device-resident indicator without
downloading the (N, A) matrix to the host.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


@jax.jit
def _intersections_device(b):
    """(A, A) int32 pairwise intersection counts of 0/1 columns of b (N, A)."""
    bb = b.astype(jnp.bfloat16)
    inter = jax.lax.dot_general(bb, bb, (((0,), (0,)), ((), ())),
                                preferred_element_type=jnp.float32)
    return inter.astype(jnp.int32)


def enrichment_intersections(nes_binary) -> np.ndarray:
    """Host int32 (A, A) intersection-count matrix from a (N, A) 0/1 array
    (numpy of any dtype, or a device int8 array — the facade hands over its
    cached indicator so the (N, A) matrix never crosses to the host)."""
    b = nes_binary if isinstance(nes_binary, jax.Array) else \
        jnp.asarray(np.asarray(nes_binary, dtype=np.int8))
    return np.asarray(_intersections_device(b))


def jaccard_condensed_from_counts(inter: np.ndarray) -> np.ndarray:
    """Condensed (scipy pdist-ordered) f64 jaccard distances from exact
    integer intersection counts.

    scipy's double-dtype jaccard on 0/1 rows u, v is
    ``(|u| + |v| - 2*inter) / (|u| + |v| - inter)`` with 0 when the union is
    empty — both operands are exact small integers accumulated in f64, so one
    correctly-rounded host division reproduces scipy bit-for-bit."""
    a = inter.shape[0]
    card = np.diag(inter).astype(np.float64)
    out = np.empty(a * (a - 1) // 2, dtype=np.float64)
    pos = 0
    # row-sliced rather than triu_indices: the two (a^2/2,) int64 index
    # arrays plus the fancy gather measured 9.4 s at a=4,373 in this
    # runtime's degraded host memory path; contiguous row slices run at
    # full bandwidth
    with np.errstate(invalid="ignore", divide="ignore"):
        for i in range(a - 1):
            row = inter[i, i + 1:].astype(np.float64)
            s = card[i] + card[i + 1:]
            union = s - row
            d = (s - 2.0 * row) / union
            d[union == 0.0] = 0.0
            out[pos:pos + a - i - 1] = d
            pos += a - i - 1
    return out


@functools.partial(jax.jit, static_argnames=("num_domains",))
def _domain_counts_device(b, domain_of_attr, num_domains: int):
    """(N, D) int32: per node, how many domain-d attributes it is enriched
    for — ``B @ onehot(domain)`` (reference safe.py:683-695's groupby-sum)."""
    onehot = (domain_of_attr[:, None]
              == jnp.arange(num_domains)[None, :]).astype(jnp.bfloat16)
    counts = jax.lax.dot_general(b.astype(jnp.bfloat16), onehot,
                                 (((1,), (0,)), ((), ())),
                                 preferred_element_type=jnp.float32)
    # int16 is always safe (counts <= A < 32,767 attributes) and halves the
    # (N, D) host download
    return counts.astype(jnp.int16)


@functools.partial(jax.jit, static_argnames=("num_domains",))
def _domain_max_nes_device(nes, domain_of_attr, num_domains: int):
    """(N, D) f32: per node, max NES over each domain's attribute columns
    (NaN -> -inf, matching the reference's masked nanmax at safe.py:697-700);
    empty domains give -inf via the segment-max identity."""
    clean = jnp.where(jnp.isnan(nes), -jnp.inf, nes)
    seg = jax.ops.segment_max(clean.T, domain_of_attr,
                              num_segments=num_domains)
    return seg.T


@jax.jit
def _bitpack_colmajor(b):
    """Little-endian uint8 bitmap of b's (N, A) nonzero mask in COLUMN-major
    order. A device `jnp.nonzero` lowers to a full-length sort, and its
    static size recompiles per dataset; the bitmap is one bandwidth-bound
    reduce, ships 8x fewer bytes
    than the int8 indicator, and the host unpacks + flatnonzeros in ~1 s."""
    mask = b.T.reshape(-1) != 0
    pad = (-mask.shape[0]) % 8
    if pad:
        mask = jnp.concatenate([mask, jnp.zeros(pad, bool)])
    # uint8 arithmetic throughout: each product is <= 128 and a row's sum is
    # exactly <= 255, so nothing wraps — and the temp stays 1 byte/cell
    # (an int32 formulation would transiently hold 4x N*A bytes, 8.6 GB at
    # the caller's 2^31-cell ceiling)
    weights = jnp.array([1, 2, 4, 8, 16, 32, 64, 128], jnp.uint8)
    return jnp.sum(mask.reshape(-1, 8).astype(jnp.uint8) * weights,
                   axis=1, dtype=jnp.uint8)


def indicator_csc(nes_binary_dev, column_counts: np.ndarray):
    """scipy CSC view of a device-resident 0/1 indicator WITHOUT the dense
    download: only a 1-bit bitmap crosses to the host (N*A/8 = 55 MB vs the
    437 MB int8 indicator at the 99,840 x 4,373 GO band scale).
    ``column_counts`` = per-attribute enriched counts (the facade's
    num_neighborhoods_enriched); their sum cross-checks the bitmap."""
    import scipy.sparse as sp
    n, a = nes_binary_dev.shape
    if n * a >= np.iinfo(np.int32).max:
        raise ValueError("indicator too large for flat int32 indexing")
    counts = np.asarray(column_counts, dtype=np.int64)
    nnz = int(counts.sum())
    if nnz == 0:
        return sp.csc_matrix((n, a), dtype=np.int8)
    packed = np.asarray(_bitpack_colmajor(nes_binary_dev))
    bits = np.unpackbits(packed, bitorder="little")[:n * a]
    flat = np.flatnonzero(bits)
    if len(flat) != nnz:
        raise AssertionError(
            f"indicator nonzero count {len(flat)} != enriched-count sum "
            f"{nnz}; the facade's counts are stale")
    rows = (flat % n).astype(np.int32)
    indptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    return sp.csc_matrix((np.ones(nnz, np.int8), rows, indptr),
                         shape=(n, a))


def domain_aggregates(nes_binary, nes, domain_of_attr: np.ndarray,
                      num_domains: int):
    """Host (counts (N, D) int64, max_nes (N, D) f64) from device GEMM +
    segment-max. `nes_binary`/`nes` may be numpy or device arrays."""
    b = nes_binary if isinstance(nes_binary, jax.Array) else \
        jnp.asarray(np.asarray(nes_binary, dtype=np.int8))
    nv = nes if isinstance(nes, jax.Array) else \
        jnp.asarray(np.asarray(nes, dtype=np.float32))
    dom = jnp.asarray(np.asarray(domain_of_attr, dtype=np.int32))
    counts_dev = _domain_counts_device(b, dom, num_domains)
    max_dev = _domain_max_nes_device(nv, dom, num_domains)
    # download the compact dtypes (int16 / source f32), widen on host —
    # bytes are the cost of a download at band scale
    counts = np.asarray(counts_dev).astype(np.int64)
    max_nes = np.asarray(max_dev).astype(np.float64)
    return counts, max_nes
