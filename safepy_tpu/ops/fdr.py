"""Vectorized Benjamini-Hochberg FDR correction.

Reference semantics: statsmodels ``fdrcorrection`` applied row-by-row via
``np.apply_along_axis`` (safepy/safe.py:538-542, 599-605) — each neighborhood's
p-values are corrected across attributes. Here the whole (N, A) matrix is corrected
in one sorted scan along the last axis on device.

NaN policy: the reference feeds NaN-bearing rows straight into statsmodels, where a
NaN poisons the reversed cumulative minimum for the entire row. We instead exclude
NaNs from the test count and the scan, and return NaN at NaN positions — the behavior
statsmodels produces on NaN-free input, extended sanely. (The reference's own
multiple-testing path is NaN-free in its tested configurations: the hypergeometric
test never emits NaN p-values.)
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


@jax.jit
def fdr_bh(pvalues):
    """Benjamini-Hochberg adjusted p-values along the last axis.

    Matches ``statsmodels.stats.multitest.fdrcorrection(p)[1]`` on finite input.
    """
    p = jnp.asarray(pvalues, jnp.float64)
    nan_mask = ~jnp.isfinite(p)
    big = jnp.where(nan_mask, jnp.inf, p)  # NaNs sort to the end, excluded from m

    order = jnp.argsort(big, axis=-1)
    p_sorted = jnp.take_along_axis(big, order, axis=-1)

    m = jnp.sum(~nan_mask, axis=-1, keepdims=True).astype(p.dtype)
    rank = jnp.arange(1, p.shape[-1] + 1, dtype=p.dtype)
    raw = p_sorted * m / rank

    # Reversed cumulative minimum; inf (ex-NaN) tail never lowers the minimum.
    last = raw.ndim - 1
    rev_cummin = jnp.flip(jax.lax.cummin(jnp.flip(raw, axis=last), axis=last), axis=last)
    corrected_sorted = jnp.minimum(rev_cummin, 1.0)

    inv = jnp.argsort(order, axis=-1)
    corrected = jnp.take_along_axis(corrected_sorted, inv, axis=-1)
    return jnp.where(nan_mask, jnp.nan, corrected)


def _bh_logsf_rows(logsf, log_threshold):
    """BH on LOG p-values along the last axis, exp-free (trace-time core).

    BH's ``p * m / rank`` scaling and reversed cumulative minimum are
    monotone under ``log``, so the whole step-up procedure runs in log
    space: ``adj_log = min(0, revcummin(logp + log(m) - log(rank)))``.
    No device f64 ``exp`` is trusted (ops/hypergeom.py) — the linear-space
    :func:`fdr_bh` would need p-values exp'd on the device. ``-inf`` log-p (exact p = 0, the 'above' branch of
    the survival finalization) flows through exactly: it sorts first and
    stays ``-inf`` after adjustment, like statsmodels' 0.0.

    The significance indicator is decided in f64 BEFORE the f32 rounding
    (strict ``log p_adj < log(threshold)``, the reference's
    ``|nes| > -log10(threshold)`` on the adjusted values, safe.py:468-470),
    so enriched counts are exact.

    Returns (logsf_adj_f32, indicator_int8).
    """
    lp = jnp.asarray(logsf, jnp.float64)
    nan_mask = jnp.isnan(lp)
    big = jnp.where(nan_mask, jnp.inf, lp)  # NaNs sort last, excluded from m

    order = jnp.argsort(big, axis=-1)
    lp_sorted = jnp.take_along_axis(big, order, axis=-1)

    m = jnp.sum(~nan_mask, axis=-1, keepdims=True).astype(lp.dtype)
    log_rank = jnp.log(jnp.arange(1, lp.shape[-1] + 1, dtype=lp.dtype))
    raw = lp_sorted + jnp.log(m) - log_rank

    last = raw.ndim - 1
    rev_cummin = jnp.flip(jax.lax.cummin(jnp.flip(raw, axis=last), axis=last),
                          axis=last)
    adj_sorted = jnp.minimum(rev_cummin, 0.0)  # p <= 1

    inv = jnp.argsort(order, axis=-1)
    adj = jnp.take_along_axis(adj_sorted, inv, axis=-1)
    adj = jnp.where(nan_mask, jnp.nan, adj)
    nbin = (adj < jnp.float64(log_threshold)).astype(jnp.int8)
    # storage dtype follows the input (f16-staged logsf stays f16: at the
    # 349,440 x 4,373 wall the f32 upgrade would be the 6 GB whale back)
    out_dtype = (logsf.dtype if np.issubdtype(logsf.dtype, np.floating)
                 else jnp.float32)
    return adj.astype(out_dtype), nbin


_bh_logsf_rows_jit = jax.jit(_bh_logsf_rows)


@functools.partial(jax.jit, donate_argnums=(0, 1))
def _bh_place_rows(adj_out, bin_out, adj_c, bin_c, start):
    z = jnp.int32(0)
    s = jnp.asarray(start, jnp.int32)
    return (jax.lax.dynamic_update_slice(adj_out, adj_c, (s, z)),
            jax.lax.dynamic_update_slice(bin_out, bin_c, (s, z)))


def fdr_bh_logsf_np(logsf, log_threshold):
    """NumPy twin of :func:`fdr_bh_logsf` for HOST-streamed results
    (``logsf_out='host'``): same log-space BH step-up, no device round trip
    for a matrix that was deliberately kept off the chip. Within ~1 ulp of
    the device path (log/argsort orders agree; ties adjust equally).

    Returns (logsf_adj, indicator_int8, enriched_counts) as numpy arrays.
    """
    lp = np.asarray(logsf, np.float64)
    nan_mask = np.isnan(lp)
    big = np.where(nan_mask, np.inf, lp)
    order = np.argsort(big, axis=-1, kind="stable")
    lp_sorted = np.take_along_axis(big, order, axis=-1)
    m = (~nan_mask).sum(axis=-1, keepdims=True).astype(np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        raw = (lp_sorted + np.log(m)
               - np.log(np.arange(1, lp.shape[-1] + 1, dtype=np.float64)))
    rev_cummin = np.minimum.accumulate(raw[..., ::-1], axis=-1)[..., ::-1]
    adj_sorted = np.minimum(rev_cummin, 0.0)
    inv = np.argsort(order, axis=-1, kind="stable")
    adj = np.take_along_axis(adj_sorted, inv, axis=-1)
    adj = np.where(nan_mask, np.nan, adj)
    nbin = (adj < np.float64(log_threshold)).astype(np.int8)
    out_dtype = (logsf.dtype if np.issubdtype(np.asarray(logsf).dtype,
                                              np.floating) else np.float32)
    return (adj.astype(out_dtype), nbin,
            nbin.sum(axis=0, dtype=np.int32))


def fdr_bh_logsf(logsf32, log_threshold, *, row_chunk: int | None = None):
    """Device BH adjustment of a (N, A) f32 log-survival matrix.

    The reference corrects each neighborhood's p-values across attributes
    (statsmodels fdrcorrection row-by-row, safe.py:599-605); rows are
    independent, so at band scale the sort runs in ``row_chunk``-row
    dispatches streaming into donated outputs — the f64 sort internals for
    the full 349,440 x 4,373 matrix (12+ GB plus sort temps) never coexist
    with the resident band (test-pinned bit-equal to the unchunked path).
    The last chunk CLAMPS its start (overlap rows recompute identically).

    Returns (logsf_adj_f32, indicator_int8, enriched_counts_int32_dev).
    """
    n = logsf32.shape[0]
    if row_chunk is None or row_chunk >= n:
        adj, nbin = _bh_logsf_rows_jit(logsf32, np.float64(log_threshold))
    else:
        dt = (logsf32.dtype if np.issubdtype(logsf32.dtype, np.floating)
              else jnp.float32)
        adj = jnp.zeros(logsf32.shape, dt)
        nbin = jnp.zeros(logsf32.shape, jnp.int8)
        for ci in range(-(-n // row_chunk)):
            start = min(ci * row_chunk, n - row_chunk)
            rows = jax.lax.dynamic_slice_in_dim(logsf32, start, row_chunk, 0)
            adj_c, bin_c = _bh_logsf_rows_jit(rows, np.float64(log_threshold))
            adj, nbin = _bh_place_rows(adj, nbin, adj_c, bin_c, start)
    return adj, nbin, jnp.sum(nbin, axis=0, dtype=jnp.int32)
