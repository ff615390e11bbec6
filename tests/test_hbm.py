"""Pre-dispatch device-memory plan guard (safepy_tpu/hbm.py).

The census peak is modeled as resident + table + (2 + group) chunk-cells;
at a 16 GB budget the model admits 299,520 x 4,373 device/f32 group-8 and
349,440 x 4,373 f16 group-8 and refuses 399,360 x 4,373 @80 f16 group-8
(15.04 GB admit line). The slot-loop ``lookup_group`` is the planner's
lever (ops/hypergeom_table._lookup_slot_loop keeps ``group`` gather
outputs live per fori step).
"""

import numpy as np
import pytest

from safepy_tpu.hbm import (band_geometry, band_go_hbm_plan, census_select,
                            device_hbm_budget, explain)

BUDGET_16GB = 16 * 10 ** 9
TRUE_TABLE = 268 * 10 ** 6  # measured GO chunk table (R=256, S=256, C=512+)


def _plan(n, band, a=4373, budget=BUDGET_16GB, **kw):
    kw.setdefault("packed", True)
    kw.setdefault("split_front", True)
    kw.setdefault("keep_distances", False)
    return band_go_hbm_plan(n, band, a, budget=budget, **kw)


def _select(n, band, mode, group, a=4373, table=TRUE_TABLE, budget=BUDGET_16GB):
    bt, rows, window = band_geometry(n, band)
    return census_select(n=n, n_attrs=a, rows=rows, chunk_w=512,
                         ind_bytes=rows * window // 8, ann_bytes=n * a,
                         table_bytes=table, budget=budget,
                         modes=(mode,), groups=(group,))


def test_geometry_matches_band_store():
    from safepy_tpu.ops.apsp_bandstore import BandedMatrix
    bm = BandedMatrix(np.zeros((1, 1)), np.arange(500), 500, 37)
    bt, rows, window = band_geometry(500, 37)
    assert bt == bm.bt
    assert rows == (-(-500 // 128) + 2 * bt) * 128
    assert window == (2 * bt + 1) * 128


def test_measured_anchors_consistent():
    """At a 16 GB budget the census model admits the two configurations
    below its admit line at their true geometry and refuses the one
    above it."""
    assert _select(299_520, 4095, "device", 8)["fits"]
    assert _select(349_440, 4095, "f16", 8)["fits"]
    assert not _select(399_360, 3583, "f16", 8)["fits"]


def test_wall_point_routes_to_smaller_group():
    """399,360 x 4,373 @80 — the r5e/r5f census wall — must now be
    admitted via a smaller lookup group, modeled BELOW the largest
    measured-safe peak (299,520 device g8 = 14.75 GB)."""
    plan = _plan(399_360, 3583)
    assert plan["fits"]
    assert plan["logsf_out"] == "device" and plan["lookup_group"] < 8
    safe_line = _select(299_520, 4095, "device", 8)["census_peak"]
    sel = _select(399_360, 3583, plan["logsf_out"], plan["lookup_group"])
    assert sel["fits"] and sel["census_peak"] <= safe_line


def test_anchor_299520_admits_device_outputs():
    plan = _plan(299_520, 4095)
    assert plan["fits"] and plan["logsf_out"] == "device"
    assert plan["lookup_group"] == 8  # no perf regression at the ran anchor


def test_anchor_349440_downgrades_from_group8():
    """The r4 OOM point: full-rate device residency (group 8) must NOT be
    admitted; 'auto' keeps device-f32 fidelity by dialing the group down."""
    plan = _plan(349_440, 4095)
    assert plan["fits"]
    assert plan["logsf_out"] == "device" and plan["lookup_group"] < 8
    forced = _select(349_440, 4095, "device", 8)
    assert not forced["fits"]


def test_auto_walks_device_f16_host():
    """Annotation-dominated shape (the (n, A) outputs dwarf the band): as
    the budget shrinks, 'auto' walks device -> f16 -> host -> refuse. A
    band-dominated shape would hit the relax gate first — and the group
    lever now lets 'device' stretch all the way down to it."""
    base = _plan(100_000, 800, a=50_000, budget=40 * 10 ** 9)
    assert base["logsf_out"] == "device"
    seen = []
    for budget in np.linspace(40 * 10 ** 9, 5 * 10 ** 9, 80):
        p = _plan(100_000, 800, a=50_000, budget=int(budget))
        seen.append(p["logsf_out"])
    order = [m for i, m in enumerate(seen) if m not in seen[:i]]
    assert order == ["device", "f16", "host", None]
    assert seen[-1] is None  # eventually nothing fits -> caller refuses


def test_group_walks_down_within_mode():
    """Within one residency mode, the group dials 8 -> 4 -> 2 -> 1 as the
    budget tightens — trading lookup bandwidth for peak HBM."""
    groups = []
    for budget in np.linspace(BUDGET_16GB, 4 * 10 ** 9, 120):
        s = census_select(n=200_000, n_attrs=4373, rows=201_728,
                          chunk_w=512, ind_bytes=10 ** 8,
                          ann_bytes=200_000 * 4373, table_bytes=TRUE_TABLE,
                          budget=int(budget), modes=("device",))
        if s["fits"]:
            groups.append(s["lookup_group"])
    walked = [g for i, g in enumerate(groups) if g not in groups[:i]]
    assert walked == [8, 4, 2, 1]


def test_relax_phase_governs_when_band_dominates():
    p = _plan(200_000, 3000, budget=10 ** 9)
    assert not p["fits"] and p["governing_phase"] == "relax"
    assert "relax peak" in explain(p)


def test_unsplit_front_double_buffers():
    split = _plan(100_000, 2000, split_front=True)
    fused = _plan(100_000, 2000, split_front=False)
    assert (fused["relax_peak"] - split["relax_peak"]
            == split["f32_band"])


def test_device_budget_positive():
    assert device_hbm_budget() > 0


class _FakeDevice:
    def __init__(self, platform, stats):
        self.platform = platform
        self._stats = stats

    def memory_stats(self):
        return self._stats


@pytest.mark.parametrize("platform,stats,want", [
    ("gpu", {"bytes_limit": 60 * 10 ** 9}, 60 * 10 ** 9),
    ("cpu", None, 16 * 10 ** 9),
    ("cpu", {}, 16 * 10 ** 9),
])
def test_device_budget_per_platform(monkeypatch, platform, stats, want):
    from safepy_tpu import hbm

    monkeypatch.setattr(hbm, "_device", lambda: _FakeDevice(platform, stats))
    assert hbm.device_hbm_budget() == want
    if platform == "cpu":
        assert hbm.device_hbm_budget(10 ** 9) == 10 ** 9


def test_device_budget_raises_on_accelerator_without_limit(monkeypatch):
    """An accelerator that reports no bytes_limit is an error, not 16 GB."""
    from safepy_tpu import hbm

    monkeypatch.setattr(hbm, "_device", lambda: _FakeDevice("gpu", {}))
    with pytest.raises(RuntimeError, match="reports no bytes_limit"):
        hbm.device_hbm_budget()


def test_facade_guard_raises_clean_before_dispatch(tmp_path):
    """An over-budget config raises ValueError with the plan BEFORE any
    device dispatch — no enrichment state, no poisoned backend."""
    from tests.test_bandstore_facade import _binary_attrs, _write_net
    from safepy_tpu import SAFE

    net, n = _write_net(tmp_path)
    sf = SAFE(verbose=False)
    sf.apsp_mode = "band"
    sf.random_seed = 7
    sf.hbm_budget_bytes = 10 ** 6  # nothing fits
    sf.load_network(network_file=net, node_key_attribute="key")
    sf.load_attributes(attribute_file=_binary_attrs(n))
    with pytest.raises(ValueError, match="band GO HBM plan"):
        sf.run_pipeline()
    assert sf._logsf_dev is None and sf._logsf_np is None
    assert not sf._hbm_plan_last["fits"]
    # the guard must fire BEFORE the operand prep builds any (N, A)-sized
    # device buffer (an over-budget prep would OOM before a later guard)
    assert sf._band_operands_cache is None


def test_prep_phase_in_plan():
    """The operand prep is a modeled phase: full-device prep peaks at ~10
    cells (the measured 399,360 x 4,373 prep OOM at 17.5 GB vs the 349,440
    fit at 15.3 GB) while the chunked prep (the facade's GO-scale route)
    peaks at ~2 cells + one f32 chunk."""
    full = _plan(399_360, 4300, prep_chunked=False)
    assert full["prep_peak"] == 10 * 399_360 * 4373
    assert full["prep_peak"] > full["admit_relax"]
    chunked = _plan(399_360, 4300, prep_chunked=True)
    assert chunked["prep_peak"] < 5 * 10 ** 9
    # prep governs only when it is the phase that breaks the budget
    p = _plan(250_000, 2000, a=12_000, prep_chunked=False)
    if not p["fits"] and p["prep_peak"] > p["admit_relax"]:
        assert p["governing_phase"] == "prep"
    assert "prep peak" in explain(full)


def test_chunked_prep_matches_device_prep():
    """band_hyper_operands_chunked must be BIT-identical to the full-device
    build — int8 operands, row-validity, per-column K, and the binary flag —
    including the chunk-remainder path and a non-binary matrix."""
    import jax.numpy as jnp
    from safepy_tpu.ops.enrich_band import (band_hyper_operands_chunked,
                                            band_hyper_operands_device)

    rng = np.random.default_rng(11)
    for binary, a in ((True, 13), (True, 5), (False, 7)):
        vals = (rng.random((97, a)) < 0.2).astype(np.float64)
        if not binary:
            vals[0, 0] = 2.5
        vals[rng.random((97, a)) < 0.3] = np.nan
        order = rng.permutation(97)
        ref = band_hyper_operands_device(
            jnp.asarray(vals, jnp.float32), jnp.asarray(order, jnp.int32))
        got = band_hyper_operands_chunked(vals, order, chunk_cols=4)
        np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(ref[0]))
        np.testing.assert_array_equal(np.asarray(got[1]), np.asarray(ref[1]))
        np.testing.assert_array_equal(np.asarray(got[2]), np.asarray(ref[2]))
        assert got[3] == bool(np.asarray(ref[3])) == binary


def test_count_other_chunked_matches_full():
    from safepy_tpu.ops.enrich_band import count_other_values_chunked

    rng = np.random.default_rng(3)
    vals = rng.choice([0.0, 1.0, 2.0, np.nan], size=(61, 9),
                      p=[0.4, 0.3, 0.1, 0.2])
    expect = int(np.sum(np.isfinite(vals) & (vals != 0) & (vals != 1)))
    assert count_other_values_chunked(vals, chunk_cols=2) == expect


def test_record_peak_marks_unavailable_counters(monkeypatch):
    """A backend without allocator counters (the CPU) yields -1 samples;
    record_peak must flag them so calibration never mistakes -1 for a real
    peak."""
    from safepy_tpu import hbm

    monkeypatch.setenv("SAFEPY_TPU_HBM_TRACE", "1")
    monkeypatch.setattr(hbm, "HBM_TRACE", [])
    rec = hbm.record_peak("unit", sync=False)
    if rec is None:  # backend raised inside the sampler — nothing recorded
        assert hbm.HBM_TRACE == []
        return
    assert hbm.HBM_TRACE == [rec]
    has_counters = (rec["bytes_in_use"] >= 0 or rec["peak_bytes_in_use"] >= 0)
    assert rec.get("unavailable", False) == (not has_counters)


def test_record_peak_noop_without_env(monkeypatch):
    from safepy_tpu import hbm

    monkeypatch.delenv("SAFEPY_TPU_HBM_TRACE", raising=False)
    monkeypatch.setattr(hbm, "HBM_TRACE", [])
    assert hbm.record_peak("unit") is None
    assert hbm.HBM_TRACE == []
