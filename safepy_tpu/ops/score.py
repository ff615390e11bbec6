"""Neighborhood scores as device GEMMs, with explicit NaN masks.

Reference semantics: safepy/safe_extras.py:6-33 — ``AB = neighborhoods @
nan_to_zero(node2attribute)`` is the 'sum' score; the 'z-score' variant divides the
per-neighborhood mean by the per-neighborhood standard deviation computed via
``E[X^2] - E[X]^2`` with a NaN-count matmul, and NaNs out neighborhoods with zero
variance or fewer than 3 annotated members.

Device notes: NaNs are carried as an explicit 0/1 mask instead of NaN arithmetic,
so every contraction is a clean dense GEMM. ``precision=HIGHEST`` keeps f32 matmuls
at full f32 (an NVIDIA GPU's default f32 path runs TF32 on the tensor cores, ~3
significant digits), which keeps integer-valued scores exact — the permutation null
counts ties with ``<=`` / ``>=`` so score determinism matters.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

_PRECISIONS = {"highest": jax.lax.Precision.HIGHEST,
               "high": jax.lax.Precision.HIGH,
               "default": jax.lax.Precision.DEFAULT}


def dot_kwargs(precision: str = "highest"):
    """Matmul precision for the score contractions. 'highest' keeps f32
    accumulation exact for integer-valued scores (full tie parity with the
    reference's counting); 'high' and 'default' let the backend trade digits
    for speed (on an NVIDIA GPU: 3-pass bf16 and TF32 tensor cores) — obs
    and permuted scores are rounded identically, so tie semantics stay
    consistent."""
    return dict(precision=_PRECISIONS[precision],
                preferred_element_type=jnp.float32)


_DOT_KW = dot_kwargs()


def zscore_shift(B, NB):
    """Per-attribute mean of the annotated values — the conditioning shift for
    the z-score contractions.

    ``E[X^2] - E[X]^2`` in f32 amplifies the GEMM rounding error by
    ``E[X^2]/Var[X]`` (measured 1.8e-5 relative on mean-offset data vs the
    reference's f64 host path, safe_extras.py:19-31). Subtracting the
    attribute's global mean BEFORE the contractions is mathematically exact
    (variance is shift-invariant; any constant works, so the f32 rounding of
    the mean itself does not matter) and removes the amplification: the
    shifted path measures <= 2e-6 mixed error. The column mean is invariant
    under the null's row permutations (the permuted multiset is the same), so
    the SAME shift serves the observed and permuted scores.

    B: (..., V, A) masked values (NaN -> 0); NB: matching 0/1 finite mask.
    Rows that are padding (value 0, mask 0) contribute nothing. Returns (A,)
    in B's dtype.
    """
    tot = jnp.sum(NB, axis=-2)
    return jnp.sum(B, axis=-2) / jnp.maximum(tot, 1.0)


def zscore_from_contractions(AB, N, EXX_sum, shift=None):
    """z-scores from the three neighborhood contractions (value sum, annotated
    count, squared-value sum) — shared by the dense, permuted-batch, and
    banded score paths. NaN where std == 0 or fewer than 3 annotated members
    (reference safe_extras.py:19-31).

    When ``shift`` (the (A,) per-attribute mean from :func:`zscore_shift`) is
    given, ``AB`` and ``EXX_sum`` must be contractions of the SHIFTED values
    ``B - NB * shift``; the shift is added back to the mean here, after the
    cancellation-prone variance subtraction has run on the well-conditioned
    centered moments."""
    safe_N = jnp.where(N > 0, N, 1.0)
    M = AB / safe_N
    EXX = EXX_sum / safe_N
    std = jnp.sqrt(jnp.maximum(EXX - M * M, 0.0))
    if shift is not None:
        M = M + shift.astype(M.dtype)
    score = jnp.where(std > 0, M / jnp.where(std > 0, std, 1.0), jnp.nan)
    return jnp.where(N < 3, jnp.nan, score)


@functools.partial(jax.jit, static_argnames=("score_type", "precision"))
def compute_neighborhood_score(neighborhoods, node2attribute,
                               score_type: str = "sum",
                               precision: str = "highest"):
    """Per-neighborhood attribute scores.

    Args:
      neighborhoods: (N, N) 0/1 indicator, row i = members of node i's neighborhood.
      node2attribute: (N, A) attribute values, NaN = unannotated.
      score_type: 'sum' or 'z-score'.
      precision: 'highest' (default) or 'default' — see :func:`dot_kwargs`.

    Returns:
      (N, A) f32 scores; NaN where undefined (z-score with std 0 or < 3 members).
    """
    _DOT_KW = dot_kwargs(precision)
    A = jnp.asarray(neighborhoods, jnp.float32)
    vals = jnp.asarray(node2attribute, jnp.float32)
    mask = jnp.isfinite(vals)
    B = jnp.where(mask, vals, 0.0)

    if score_type == "sum":
        return jnp.dot(A, B, **_DOT_KW)  # sum of values in a neighborhood

    if score_type != "z-score":
        raise ValueError(f"unknown neighborhood_score_type: {score_type!r}")

    NB = mask.astype(jnp.float32)
    N = jnp.dot(A, NB, **_DOT_KW)  # annotated members per neighborhood
    c = zscore_shift(B, NB)
    Bs = B - NB * c
    ABs = jnp.dot(A, Bs, **_DOT_KW)
    EXXs_sum = jnp.dot(A, Bs * Bs, **_DOT_KW)
    return zscore_from_contractions(ABs, N, EXXs_sum, shift=c)
