"""Batched permutation null for quantitative attribute enrichment.

Reference semantics (safepy/safe_extras.py:36-70 + safepy/safe.py:474-554): permute
the rows of ``node2attribute`` restricted to rows with >=1 non-NaN value, recompute
neighborhood scores, and accumulate two-sided empirical counts
``counts_neg += (perm <= obs)``, ``counts_pos += (perm >= obs)`` (ties count on both
sides). The reference runs this as a serial NumPy loop (optionally forked over a
multiprocessing pool); here the whole null is a batched GEMM stream on the device:

  * permutations are independent keyed draws — NOT a replication of NumPy's
    in-place compounding permutation stream; each permuted state is still uniform,
    and the reference's own test asserts only a distributional tolerance
    (637 +/- 20 at 1000 permutations);
  * for single-attribute inputs (the flagship quantitative workload) the
    permuted value matrix comes from ONE ``lax.sort`` of random keys against the
    value column — a uniform random permutation applied directly to the data,
    with no index materialization and no gather. Wider inputs use explicit
    ``jax.random.permutation`` indices + one row gather, whose single (C, V)
    index set amortizes over all columns (crossover at
    SORT_PATH_MAX_ATTRIBUTES);
  * permuted attribute chunks are scored against the neighborhood indicator in one
    ``(N, V) x (C, V, A)`` contraction; count accumulation happens on device in
    int32; nothing leaves the device until the final (N, A) count matrices.

Rows with no annotated values are dropped from both operands up front: their score
contribution is identically zero, so the GEMM contracts over the V valid rows only.

RNG note: the sort path orders by independent uint32 keys with a stable sort; a
key collision (expected ~0.05 tied pairs per permutation at V=20k) leaves the tied
pair in index order — an O(2^-32) departure from uniformity, far below the
statistical resolution of any permutation count.

Multi-device: `safepy_tpu.parallel.permutation_sharded` shards the permutation
batch axis over the device mesh and psums these counts.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from safepy_tpu.ops.score import dot_kwargs

# auto-engine crossover, NOT a capability cap (the sort engine serves any
# width if forced): one (C, V) index set amortizes over all A columns of a
# row gather, while the sort's per-column key traffic grows linearly. The
# value predates the GPU port and is not yet re-measured on it
# (ROADMAP.md). The broadcast-key single-sort formulation keeps XLA program
# size flat in A.
SORT_PATH_MAX_ATTRIBUTES = 1


def default_batch_size(num_valid: int, num_attributes: int,
                       num_permutations: int, budget_bytes: int = 1 << 28) -> int:
    """Largest permutation chunk whose gathered operands fit the memory budget."""
    per_perm = max(1, num_valid * num_attributes * 4 * 3)
    return int(max(1, min(num_permutations, budget_bytes // per_perm)))


def _scores_from_permuted(nbr_valid, Bp, NBp, score_type: str,
                          precision: str = "highest", shift=None):
    """Scores of already-permuted operands.

    Bp: (C, V, A) permuted NaN->0 values; NBp: (C, V, A) permuted finite masks
    (only consulted for z-score). The squared term is (Bp)^2 — squaring commutes
    with permutation, so it is never permuted separately. For z-score, Bp must
    be the SHIFTED values (``ops.score.zscore_shift``; shifting commutes with
    row permutation, so callers center once before the permutation machinery)
    and ``shift`` the matching (A,) column means.
    """
    _DOT_KW = dot_kwargs(precision)
    AB = jnp.einsum("nv,cva->cna", nbr_valid, Bp, **_DOT_KW)
    if score_type == "sum":
        return AB
    if score_type != "z-score":
        raise ValueError(f"unknown neighborhood_score_type: {score_type!r}")
    from safepy_tpu.ops.score import zscore_from_contractions
    Np = jnp.einsum("nv,cva->cna", nbr_valid, NBp, **_DOT_KW)
    EXX_sum = jnp.einsum("nv,cva->cna", nbr_valid, Bp * Bp, **_DOT_KW)
    return zscore_from_contractions(AB, Np, EXX_sum, shift=shift)


def permutation_scores(nbr_valid, vals, mask, perm_idx, score_type: str,
                       precision: str = "highest", shift=None):
    """Scores of a chunk of row-permuted attribute matrices (explicit indices).

    Args:
      nbr_valid: (N, V) neighborhood indicator restricted to valid columns.
      vals: (V, A) NaN->0 attribute values of the valid rows.
      mask: (V, A) 0/1 finite-value mask of the valid rows.
      perm_idx: (C, V) int permutation indices.
      score_type: 'sum' or 'z-score'.

    Returns:
      (C, N, A) f32 scores (NaN where the z-score is undefined).
    """
    Bp = jnp.take(vals, perm_idx, axis=0)                    # (C, V, A)
    NBp = (jnp.take(mask, perm_idx, axis=0)
           if score_type == "z-score" else None)
    return _scores_from_permuted(nbr_valid, Bp, NBp, score_type, precision,
                                 shift=shift)


def permuted_operands_sorted(vals, mask, chunk_key, chunk_size: int,
                             with_mask: bool, pad_to: int | None = None):
    """A chunk of row-permuted operands drawn by key-sorting the data itself.

    ONE stable ``lax.sort`` call permutes every attribute column (and its
    mask) by independent per-permutation uint32 keys — the permutation
    indices never exist. The key row is broadcast across the column axis, so
    each (chunk, column) lane sorts by the SAME keys, and a stable sort of
    identical keys produces the identical permutation: rows stay aligned
    across columns of any width (reference safe_extras.py:50-62 permutes
    matrices of arbitrary width). A single 2-3-operand sort keeps the XLA
    program size flat in A (unrolling one variadic sort per column group
    made compile time grow with A). Returns (Bp, NBp): (C, V, A) permuted values and (when
    ``with_mask``) their finite masks, permuted identically.

    ``pad_to``: return (C, pad_to, A) with all-zero tail rows, produced by
    sorting max-key zero rows along with the data — stability puts every pad
    row after the (at most original-ordered) real rows, so the first V output
    rows are BIT-identical to the unpadded sort and the tail is exact zeros:
    the same result as a post-sort jnp.pad without the extra full-size copy
    (the banded tail's slack rows at million-node scale).
    """
    V, A = vals.shape
    bits = jax.random.bits(chunk_key, (chunk_size, V), dtype=jnp.uint32)
    vals_t, mask_t = vals.T, (mask.T if with_mask else None)
    if pad_to is not None and pad_to > V:
        pad = pad_to - V
        bits = jnp.pad(bits, ((0, 0), (0, pad)),
                       constant_values=np.uint32(0xFFFFFFFF))
        vals_t = jnp.pad(vals_t, ((0, 0), (0, pad)))
        mask_t = jnp.pad(mask_t, ((0, 0), (0, pad))) if with_mask else None
    vp = bits.shape[1]
    keys = jnp.broadcast_to(bits[:, None, :], (chunk_size, A, vp))
    ops = (keys, jnp.broadcast_to(vals_t[None], (chunk_size, A, vp)))
    if with_mask:
        ops += (jnp.broadcast_to(mask_t[None], (chunk_size, A, vp)),)
    sorted_ops = jax.lax.sort(ops, dimension=-1, num_keys=1,
                              is_stable=True)[1:]
    Bp = jnp.swapaxes(sorted_ops[0], 1, 2)                   # (C, Vp, A)
    NBp = jnp.swapaxes(sorted_ops[1], 1, 2) if with_mask else None
    return Bp, NBp


def permutation_scores_sorted(nbr_valid, vals, mask, chunk_key, chunk_size: int,
                              score_type: str, precision: str = "highest",
                              shift=None):
    """Scores of a chunk of permutations drawn by key-sorting the data itself."""
    Bp, NBp = permuted_operands_sorted(vals, mask, chunk_key, chunk_size,
                                       score_type == "z-score")
    return _scores_from_permuted(nbr_valid, Bp, NBp, score_type, precision,
                                 shift=shift)


def uses_sort_path(num_attributes: int) -> bool:
    return num_attributes <= SORT_PATH_MAX_ATTRIBUTES


def count_scan(chunk_scores, obs, key, *, num_permutations: int,
               batch_size: int, chunk_counts=None):
    """The shared two-sided count accumulator over permutation chunks.

    ``chunk_scores(chunk_key) -> (C, N, A)`` supplies one chunk of permuted
    scores (dense GEMM, banded, or shard-local — every engine reuses this
    driver so tie semantics, the live-permutation mask, and the shard_map
    varying-axes carry trick stay defined in exactly one place).
    Tie-inclusive two-sided counts, reference safe_extras.py:64-66.

    ``chunk_counts(chunk_key, live) -> (cn, cp)`` (optional) replaces the
    score materialization + comparison with a FUSED per-chunk counter
    (ops/apsp_bandstore.band_count_batch) — required bit-identical to the
    default comparisons; the giant-band tail uses it so the (C, N, A) score
    array never exists.
    """
    num_chunks = -(-num_permutations // batch_size)
    chunk_keys = jax.random.split(key, num_chunks)

    def chunk_body(carry, inputs):
        counts_neg, counts_pos = carry
        chunk_key, chunk_start = inputs
        live = (chunk_start + jnp.arange(batch_size)) < num_permutations
        if chunk_counts is not None:
            dn, dp = chunk_counts(chunk_key, live)
            return (counts_neg + dn, counts_pos + dp), None
        scores = chunk_scores(chunk_key)
        live = live[:, None, None]
        counts_neg = counts_neg + jnp.sum(
            jnp.where(live & (scores <= obs[None]), 1, 0), axis=0,
            dtype=jnp.int32)
        counts_pos = counts_pos + jnp.sum(
            jnp.where(live & (scores >= obs[None]), 1, 0), axis=0,
            dtype=jnp.int32)
        return (counts_neg, counts_pos), None

    zeros = jnp.zeros(obs.shape, jnp.int32)
    # inherit the key's varying-manual-axes: under shard_map the per-device key
    # makes the chunk counts device-varying, and the scan carry's type must be
    # varying from iteration 0 as well
    zeros = zeros + (chunk_keys.ravel()[0] * 0).astype(jnp.int32)
    starts = jnp.arange(num_chunks) * batch_size
    (counts_neg, counts_pos), _ = jax.lax.scan(
        chunk_body, (zeros, zeros), (chunk_keys, starts))
    return counts_neg, counts_pos


def scan_counts(nbr_valid, vals, mask, obs, key, *, score_type: str,
                num_permutations: int, batch_size: int,
                precision: str = "highest"):
    """Core count loop over permutation chunks (shard_map-compatible).

    All shapes static; `key` is a single PRNG key. Returns int32 (N, A) counts.
    """
    V, A = vals.shape
    sort_path = uses_sort_path(A)

    shift = None
    if score_type == "z-score":
        # center ONCE before the permutation machinery (shifting commutes with
        # row permutation) — kills the E[X^2]-E[X]^2 cancellation, see
        # ops.score.zscore_shift
        from safepy_tpu.ops.score import zscore_shift
        shift = zscore_shift(vals, mask)
        vals = vals - mask * shift

    def chunk_scores(chunk_key):
        if sort_path:
            return permutation_scores_sorted(
                nbr_valid, vals, mask, chunk_key, batch_size, score_type,
                precision, shift=shift)
        perm_keys = jax.random.split(chunk_key, batch_size)
        perm_idx = jax.vmap(lambda k: jax.random.permutation(k, V))(perm_keys)
        return permutation_scores(nbr_valid, vals, mask, perm_idx,
                                  score_type, precision, shift=shift)

    return count_scan(chunk_scores, obs, key,
                      num_permutations=num_permutations,
                      batch_size=batch_size)


def prepare_valid(neighborhoods, node2attribute, valid_rows):
    """Restrict operands to the valid rows: (nbr_valid, vals, mask).

    ``valid_rows=None`` means EVERY row is valid: the (N, V) column gather of
    the indicator — a multi-GB lane gather at 20k nodes — is skipped entirely
    (callers know V == N statically and pass None)."""
    nbr = jnp.asarray(neighborhoods, jnp.float32)
    n2a = jnp.asarray(node2attribute, jnp.float32)
    if valid_rows is None:
        rows = n2a
        nbr_valid = nbr
    else:
        valid_rows = jnp.asarray(valid_rows, jnp.int32)
        nbr_valid = jnp.take(nbr, valid_rows, axis=1)
        rows = jnp.take(n2a, valid_rows, axis=0)
    mask = jnp.isfinite(rows).astype(jnp.float32)
    vals = jnp.where(mask > 0, rows, 0.0)
    return nbr_valid, vals, mask


@functools.partial(
    jax.jit,
    static_argnames=("score_type", "num_permutations", "batch_size", "precision"))
def run_permutations(neighborhoods, node2attribute, valid_rows, obs, key,
                     *, score_type: str = "sum", num_permutations: int = 1000,
                     batch_size: int | None = None, precision: str = "highest"):
    """Two-sided empirical null counts over keyed permutations.

    Args:
      neighborhoods: (N, N) 0/1 indicator.
      node2attribute: (N, A) attribute values with NaNs.
      valid_rows: (V,) int indices of rows with >=1 finite value.
      obs: (N, A) observed neighborhood scores (``compute_neighborhood_score``).
      key: jax PRNG key.
      score_type, num_permutations, batch_size: static knobs.

    Returns:
      (counts_neg, counts_pos): (N, A) int32 — #permutations with score <= / >= obs.
      Positions where obs is NaN count zero on both sides (the facade masks them to
      NaN, matching safepy/safe.py:528-530).
    """
    obs = jnp.asarray(obs, jnp.float32)
    nbr_valid, vals, mask = prepare_valid(neighborhoods, node2attribute, valid_rows)

    V, A = vals.shape
    if batch_size is None:
        batch_size = default_batch_size(V, A, num_permutations)

    return scan_counts(nbr_valid, vals, mask, obs, key, score_type=score_type,
                       num_permutations=num_permutations, batch_size=batch_size,
                       precision=precision)
