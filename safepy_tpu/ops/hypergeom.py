"""Vectorized hypergeometric survival function on the device.

Replaces the elementwise SciPy call of the reference
(``hypergeom.sf(k - 1, M, K, n)`` at safepy/safe.py:596) with a fully vectorized,
jit-compiled tail sum that meets <=1e-6 absolute p-value parity with SciPy.

Numerical design
----------------
The device core is f32-first, but ``lgamma`` of factorial-scale arguments in f32
would lose ~1e-3 absolute on the log — fatal for 1e-6 p-value parity. Instead of
evaluating ``lgamma`` per term on device:

  * the single *leading* log-pmf per cell is assembled in f64 from a host-precomputed
    ``lgamma(x + 1)`` table (six gathers + adds),
  * the rest of the tail is accumulated with the exact pmf *ratio recurrence*

        pmf(t+1)/pmf(t) = (K - t)(n - t) / ((t + 1)(M - K - n + t + 1))

    whose numerator/denominator are exact small-integer products, so no further
    transcendentals are needed,
  * the tail is always summed in its *decaying* direction: upper tail when the start
    point is at/past the distribution mode, otherwise the complement (1 - lower tail)
    summed downward — both directions have monotonically decaying terms, so a fixed
    iteration count bounded by the distribution width captures the sum to ~1e-12.

The hypergeometric pmf decays like a Gaussian of standard deviation
``sigma <= sqrt(n)/2`` away from its mode, so ``O(12 * sigma)`` terms suffice for
1e-12 truncation error; :func:`tail_iterations` computes the static bound.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from scipy.special import gammaln as _host_gammaln


def lgamma_table(max_m: int) -> np.ndarray:
    """Host-precomputed ``lgamma(x + 1)`` for integer x in [0, max_m], f64."""
    return _host_gammaln(np.arange(max_m + 1, dtype=np.float64) + 1.0)


def tail_iterations(max_population: int, max_draws: int) -> int:
    """Static per-cell iteration bound for the tail sum.

    sigma <= sqrt(min(n, M)) / 2; 12 sigma of Gaussian decay reaches ~1e-31, and far
    tails decay faster than the Gaussian bound. The +48 floor covers tiny supports
    and pre-asymptotic wiggle; the support size itself is always a hard cap.
    """
    sigma = 0.5 * float(min(max_draws, max_population)) ** 0.5
    return int(min(max_draws + 2, 12.0 * sigma + 48.0))


@functools.partial(jax.jit, static_argnames=("iterations",))
def _sf_parts(k, M, K, n, lgt, iterations: int):
    """Device part of the survival function: leading log-pmf + tail ratio sum.

    Returns ``(log_pmf0, acc, use_upper, lower, upper)`` — everything needed to
    finalize ``sf = exp(log_pmf0) * acc`` (upper branch) or ``1 - exp(...) * acc``
    (complement branch). The final transcendentals stay OFF the device on purpose,
    so p-values never depend on a device f64 ``exp`` (whether the GPU's can take
    them over is open, ROADMAP.md Design 6); the adds/mults/divides used here hold
    ~1e-13.

    k, K, n are f64 arrays of integer values (any mutually broadcastable shapes);
    M is a scalar; lgt is the f64 lgamma table covering [0, M].
    """

    f64 = jnp.float64
    k = k.astype(f64)
    K = K.astype(f64)
    n = n.astype(f64)
    M = jnp.asarray(M, f64)

    lower = jnp.maximum(0.0, n + K - M)  # support lower bound
    upper = jnp.minimum(K, n)            # support upper bound

    # Mode of the pmf; summing away from it guarantees decaying terms.
    mode = jnp.floor((n + 1.0) * (K + 1.0) / (M + 2.0))

    k_eff = jnp.clip(k, lower, upper + 1.0)
    # Upper branch: start at t0 = k_eff, sum up.  Complement branch: start at
    # t0 = k_eff - 1, sum down, sf = 1 - cdf.
    use_upper = k_eff >= mode

    t0 = jnp.where(use_upper, k_eff, k_eff - 1.0)
    t0 = jnp.clip(t0, lower, upper)

    def gather(x):
        return jnp.take(lgt, x.astype(jnp.int32), mode="clip")

    # log pmf(t0) = log C(K, t0) + log C(M-K, n-t0) - log C(M, n)
    log_pmf0 = (gather(K) - gather(t0) - gather(K - t0)
                + gather(M - K) - gather(n - t0) - gather(M - K - n + t0)
                - (gather(M) - gather(n) - gather(M - n)))

    # Ratio recurrences (all operands are exact small integers in f64). The
    # branch select happens on the small integer products BEFORE the division:
    # f64 division dominates the loop, so one selected divide beats two
    # branch divides merged by a where.
    def ratio(t):
        num = jnp.where(use_upper, (K - t) * (n - t),
                        t * (M - K - n + t))
        den = jnp.where(use_upper, (t + 1.0) * (M - K - n + t + 1.0),
                        (K - t + 1.0) * (n - t + 1.0))
        return num / jnp.where(den == 0.0, 1.0, den)

    # Terms only ever DECAY (both branches sum away from the mode), so the
    # largest live term bounds everything still to come: once it drops below
    # 1e-18 the truncation error is < support * 1e-18 ~ 1e-14 relative. The
    # static `iterations` bound covers the worst cell; most inputs exit the
    # while_loop after ~half of it (every skipped f64 iteration is real
    # time).
    def cond(carry):
        i, _acc, term, _t = carry
        return jnp.logical_and(i < iterations, jnp.max(term) > 1e-18)

    def body(carry):
        i, acc, term, t = carry
        fi = jnp.asarray(i, f64)
        in_range = jnp.where(use_upper, t0 + fi <= upper, t0 - fi >= lower)
        term = jnp.where(in_range, term, 0.0)
        acc = acc + term
        r = ratio(t)
        t_next = jnp.where(use_upper, t + 1.0, t - 1.0)
        return i + 1, acc, term * r, t_next

    acc0 = jnp.zeros_like(k_eff)
    term0 = jnp.ones_like(k_eff)
    _, acc, _, _ = jax.lax.while_loop(
        cond, body, (jnp.asarray(0, jnp.int32), acc0, term0, t0))

    return log_pmf0, acc, use_upper, k <= lower, k > upper


def _parts(k, M, K, n, iterations):
    M = int(M)
    if iterations is None:
        iterations = tail_iterations(M, M)
    lgt = jnp.asarray(lgamma_table(M))
    k, K, n = jnp.broadcast_arrays(
        jnp.asarray(k, jnp.float64), jnp.asarray(K, jnp.float64),
        jnp.asarray(n, jnp.float64))
    lp0, acc, use_upper, below, above = _sf_parts(k, M, K, n, lgt, iterations)
    return (np.asarray(lp0), np.asarray(acc), np.asarray(use_upper),
            np.asarray(below), np.asarray(above))


def hypergeom_sf(k, M, K, n, *, iterations: int | None = None):
    """P[X >= k] for X ~ Hypergeometric(M, K, n), vectorized.

    Matches ``scipy.stats.hypergeom.sf(k - 1, M, K, n)`` semantics used by the
    reference at safepy/safe.py:596 when called as ``hypergeom_sf(k, M, K, n)``
    (i.e. this function computes P[X >= k] directly — pass the raw count, not k-1).

    The tail sum runs on device; the final ``exp`` runs on the host in true f64
    (see :func:`_sf_parts` for why). Not jittable end to end by design.

    Args:
      k: observed counts (broadcastable to the output shape).
      M: population size (python int).
      K: per-attribute annotated totals.
      n: per-neighborhood sizes.
      iterations: static tail-length bound; derived from M when omitted.
    """
    return _host_sf(_parts(k, M, K, n, iterations))


def _host_sf(parts):
    lp0, acc, use_upper, below, above = parts
    tail = np.exp(lp0) * acc
    sf = np.where(use_upper, tail, 1.0 - tail)
    sf = np.where(below, 1.0, sf)
    sf = np.where(above, 0.0, sf)
    return np.clip(sf, 0.0, 1.0)


def _host_nes(parts):
    lp0, acc, use_upper, below, above = parts
    with np.errstate(divide="ignore", invalid="ignore"):
        upper_nes = -(lp0 + np.log(np.maximum(acc, 0.0))) / np.log(10.0)
        lower_nes = -np.log10(np.clip(1.0 - np.exp(lp0) * acc, 0.0, 1.0))
    nes = np.where(use_upper, upper_nes, lower_nes)
    nes = np.where(below, 0.0, nes)
    nes = np.where(above, np.inf, nes)
    return np.maximum(nes, 0.0)


def finalize_logsf_device(parts, enrichment_threshold):
    """Device-side finalization to (nes_f32, log_sf_f32, nes_binary_int8).

    No device f64 ``exp`` is trusted (ROADMAP.md Design 6), while f64 ``log``
    holds ~1e-12 — so the upper-branch log-survival
    ``lp0 + log(acc)`` stays f64-exact on device, the complement branch's
    moderate-argument ``exp`` runs in f32 (relative error ~1e-7 on a tail bounded
    away from the extremes), and the caller recovers p-values HOST-side as
    ``exp(float64(log_sf_f32))`` — absolute p error <= max_p |log p| * eps_f32
    ~= 2e-8, well inside the 1e-6 parity budget.

    The significance indicator is decided on device in f64 before any f32
    rounding, so enriched-pair counts are exact.
    """
    import jax.numpy as jnp

    lp0, acc, use_upper, below, above = parts
    log_acc = jnp.log(jnp.maximum(acc, 1e-300))
    log_sf_upper = lp0 + log_acc  # f64, exact to ~1e-11

    tail32 = jnp.exp(lp0.astype(jnp.float32)) * acc.astype(jnp.float32)
    tail32 = jnp.clip(tail32, 0.0, 1.0)
    log_sf_lower = jnp.log1p(-jnp.minimum(tail32, 1.0 - 1e-7)).astype(jnp.float64)

    log_sf = jnp.where(use_upper, log_sf_upper, log_sf_lower)
    log_sf = jnp.where(below, 0.0, log_sf)
    log_sf = jnp.where(above, -jnp.inf, log_sf)
    log_sf = jnp.minimum(log_sf, 0.0)

    nes = -log_sf / jnp.float64(np.log(10.0))
    threshold = -jnp.log(jnp.float64(enrichment_threshold))
    nes_binary = (-log_sf > threshold).astype(jnp.int8)
    return nes.astype(jnp.float32), log_sf.astype(jnp.float32), nes_binary


def hypergeom_sf_and_nes(k, M, K, n, *, iterations: int | None = None):
    """(sf, -log10(sf)) from ONE device tail-sum pass — the enrichment stage needs
    both the p-value matrix and the full-precision NES."""
    parts = _parts(k, M, K, n, iterations)
    return _host_sf(parts), _host_nes(parts)


def hypergeom_neglog10_sf(k, M, K, n, *, iterations: int | None = None):
    """-log10(P[X >= k]) — the neighborhood enrichment score, full f64 precision.

    Computed as ``-(log_pmf0 + log(acc)) / ln(10)`` on the upper branch, avoiding
    the underflow of ``sf`` itself for deeply-enriched neighborhoods (the reference
    caps displayed NES at ``enrichment_max_log10``, but the raw score is exact).
    """
    return _host_nes(_parts(k, M, K, n, iterations))
