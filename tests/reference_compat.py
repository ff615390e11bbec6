"""Import the reference implementation (/root/reference, baryshnikova-lab/safepy)
inside this image so differential parity tests can run BOTH frameworks on the same
inputs (the BASELINE metric is "p-value deviation <= 1e-6 vs reference", which
must be measured, not inferred).

Two compatibility shims are needed (the reference pins older deps,
extras/requirements.txt, and this image carries pandas 3.x and no statsmodels):

  * ``statsmodels.stats.multitest.fdrcorrection`` (safepy/safe.py:30) — supplied as a
    stub module implementing the same Benjamini-Hochberg math (sorted p * n / rank,
    reversed cummin, clip to 1) so the reference's FDR path runs unmodified.
  * ``DataFrame.groupby(axis=1)`` (safepy/safe.py:695,703) — removed in pandas 3.0;
    patched to the transpose equivalent ``df.T.groupby(level=...)`` with transposed
    reductions. Plain ``groupby`` calls delegate to pandas untouched.

Neither shim alters reference *semantics*; they only let the pinned-older-API code
execute on the image's library versions.
"""

from __future__ import annotations

import sys
import types

import numpy as np

REFERENCE_ROOT = "/root/reference"

_loaded = None


def _bh_fdrcorrection(pvals, alpha=0.05, method="indep", is_sorted=False):
    """Benjamini-Hochberg, statsmodels.stats.multitest.fdrcorrection semantics:
    returns (reject, pvals_corrected)."""
    pvals = np.asarray(pvals, dtype=float)
    order = np.argsort(pvals)
    p_sorted = pvals[order]
    n = p_sorted.shape[0]
    ecdf = np.arange(1, n + 1) / float(n)
    corrected_sorted = np.minimum.accumulate((p_sorted / ecdf)[::-1])[::-1]
    corrected_sorted = np.clip(corrected_sorted, 0.0, 1.0)
    corrected = np.empty(n)
    corrected[order] = corrected_sorted
    reject = np.empty(n, dtype=bool)
    reject[order] = p_sorted <= ecdf * alpha
    return reject, corrected


def _install_statsmodels_stub():
    if "statsmodels" in sys.modules:
        return
    root = types.ModuleType("statsmodels")
    stats = types.ModuleType("statsmodels.stats")
    multitest = types.ModuleType("statsmodels.stats.multitest")
    multitest.fdrcorrection = _bh_fdrcorrection
    root.stats = stats
    stats.multitest = multitest
    sys.modules["statsmodels"] = root
    sys.modules["statsmodels.stats"] = stats
    sys.modules["statsmodels.stats.multitest"] = multitest


def _install_groupby_axis1_compat():
    import pandas as pd

    if getattr(pd.DataFrame.groupby, "_safepy_axis1_compat", False):
        return
    original = pd.DataFrame.groupby

    class _TransposedGroupBy:
        def __init__(self, gb):
            self._gb = gb

        def sum(self, *args, **kwargs):
            return self._gb.sum(*args, **kwargs).T

        def max(self, *args, **kwargs):
            return self._gb.max(*args, **kwargs).T

        def min(self, *args, **kwargs):
            return self._gb.min(*args, **kwargs).T

        def mean(self, *args, **kwargs):
            return self._gb.mean(*args, **kwargs).T

    def groupby(self, *args, axis=0, **kwargs):
        if axis in (1, "columns"):
            return _TransposedGroupBy(self.T.groupby(*args, **kwargs))
        return original(self, *args, **kwargs)

    groupby._safepy_axis1_compat = True
    pd.DataFrame.groupby = groupby


def load_reference():
    """Return the reference ``safepy.safe`` module, or None if unavailable."""
    global _loaded
    if _loaded is not None:
        return _loaded
    import os

    if not os.path.isdir(REFERENCE_ROOT):
        return None
    _install_statsmodels_stub()
    _install_groupby_axis1_compat()
    if REFERENCE_ROOT not in sys.path:
        sys.path.insert(0, REFERENCE_ROOT)
    import matplotlib

    matplotlib.use("Agg")
    from safepy import safe as reference_safe  # noqa: PLC0415

    _loaded = reference_safe
    return _loaded
