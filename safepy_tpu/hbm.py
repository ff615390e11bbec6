"""Analytic pre-dispatch device-memory accounting for the band-storage
pipelines.

A device OOM in the middle of a fused band program loses the whole dispatch
and can leave the process's backend unusable, so the facade never hands XLA
an allocation it cannot satisfy: before any band GO dispatch it consults this
model and either auto-routes (f16 / host-streamed logsf residency, split FW
front) or raises a clean ValueError carrying the full plan.

The model is the structure of the fused band programs, not an XLA query (an
AOT lowering would itself cost a compile per shape). Phases:

  * ``prep`` — the operand build (band_hyper_operands_*): ~2 cells/byte
    plus one f32 column chunk when chunked, ~10 cells full-device;
  * ``relax`` — the FW front: the f32 distance band, DOUBLE-buffered by
    XLA inside a fused while-loop program unless the split front runs it
    donated; plus the indicator output and any device-resident (N, A)
    operands;
  * ``census`` — the class-table enrichment loop: indicator band + int8
    annotations + the (n, A) outputs at the chosen ``logsf_out`` residency
    + one chunk's live transients (counts / logsf / table, bounded by
    ops/hypergeom_table.plan's chunk budgets).

The slot-loop lookup (ops/hypergeom_table._lookup_slot_loop) keeps up to
``group`` (N, chunk) f32 gather outputs live per fori step, so the census
peak is modeled as

    resident + table + (2 + group) * rows * chunk_w * 4

and admitted under CENSUS_SAFETY x budget; the relax and prep phases under
RELAX_SAFETY x budget. ``group`` is a planner-chosen lever (smaller group =
fewer live gathers, more accumulator round trips). The safety factors keep
the values they had before the program ran on a GPU; they are not yet
re-measured on one (ROADMAP.md).
"""

from __future__ import annotations

import os

RELAX_SAFETY = 0.88
CENSUS_SAFETY = 0.94
#: pre-prep estimate of one chunk's live class table (the true R*S_max*C
#: geometry needs K, known only after the operand prep); measured GO chunks
#: build ~0.27 GB tables, the estimate leaves headroom
TABLE_BYTES_ESTIMATE = 4 * 10 ** 8
#: the budget the planner assumes on the CPU backend, which reports no
#: allocator limit (tests, CPU rehearsals)
CPU_BUDGET = 16 * 10 ** 9

#: phase-boundary allocator samples appended by :func:`record_peak` when
#: SAFEPY_TPU_HBM_TRACE is set — the calibration data for the phase models
#: above (each entry: tag, bytes_in_use, peak_bytes_in_use).
HBM_TRACE: list[dict] = []


def trace_active() -> bool:
    return os.environ.get("SAFEPY_TPU_HBM_TRACE", "") not in ("", "0")


def _device():
    """The device a program is placed on: ``jax.default_device`` when set,
    else the first device."""
    import jax
    dev = jax.config.jax_default_device
    if dev is None:
        return jax.devices()[0]
    return jax.devices(dev)[0] if isinstance(dev, str) else dev


def record_peak(tag: str, sync: bool = True):
    """Sample the device allocator (PJRT ``memory_stats``) at a phase
    boundary into :data:`HBM_TRACE` — no-op unless SAFEPY_TPU_HBM_TRACE is
    set. ``peak_bytes_in_use`` is CUMULATIVE, so the rise between two
    consecutive samples attributes the peak to the phase between them;
    ``sync`` drains the execution stream first so frees from completed
    (donated) dispatches have landed before the sample. A backend without
    allocator counters (the CPU) records -1 and ``unavailable``."""
    if not trace_active():
        return None
    import jax.numpy as jnp
    if sync:
        jnp.zeros(()).block_until_ready()
    stats = _device().memory_stats() or {}
    rec = {"tag": tag,
           "bytes_in_use": int(stats.get("bytes_in_use", -1)),
           "peak_bytes_in_use": int(stats.get("peak_bytes_in_use", -1))}
    if rec["bytes_in_use"] < 0 and rec["peak_bytes_in_use"] < 0:
        rec["unavailable"] = True
    HBM_TRACE.append(rec)
    return rec


def device_hbm_budget(default_bytes: int | None = None) -> int:
    """The device's memory budget: the allocator's ``bytes_limit``. On a GPU
    that is JAX's preallocated pool — by default 75% of the card
    (XLA_PYTHON_CLIENT_MEM_FRACTION), ~60 GB of an 80 GB H100. The CPU
    backend reports no limit and gets ``default_bytes`` or
    :data:`CPU_BUDGET`; an accelerator that reports none raises instead of
    being planned against a guess."""
    dev = _device()
    limit = int((dev.memory_stats() or {}).get("bytes_limit", 0))
    if limit > 0:
        return limit
    if dev.platform == "cpu":
        return CPU_BUDGET if default_bytes is None else int(default_bytes)
    raise RuntimeError(f"{dev.platform} device {dev} reports no bytes_limit; "
                       "pass an explicit budget")


def band_geometry(n: int, band: int, block: int = 128):
    """(bt, padded rows, window columns) of the skewed band store."""
    bt = band // block + 1
    rows = (-(-n // block) + 2 * bt) * block
    window = (2 * bt + 1) * block
    return bt, rows, window


#: slot-loop unroll depths the planner may pick, preferred first (fewest
#: accumulator round trips; smaller groups trade lookup bandwidth for fewer
#: live gather outputs)
LOOKUP_GROUPS = (8, 4, 2, 1)


def census_select(*, n: int, n_attrs: int, rows: int, chunk_w: int,
                  ind_bytes: int, ann_bytes: int, table_bytes: int,
                  keep_band: int = 0, extra_resident: int = 0,
                  budget: int | None = None,
                  modes=("device", "f16", "host"),
                  groups=LOOKUP_GROUPS):
    """Choose the census phase's (logsf residency, slot-loop group).

    The census chunk loop's peak is the device-RESIDENT set (indicator band
    + int8 annotations + the (n, A) outputs at the chosen residency + any
    kept distance band) plus one chunk's LIVE set, which the slot-loop
    lookup dominates: the class table, the counts/k buffer, the f32
    accumulator, and ``group`` (rows, chunk_w) f32 gather outputs XLA keeps
    in flight per unrolled fori step (ops/hypergeom_table._lookup_slot_loop)
    — (2 + group) chunk-cells in all. Modes are walked cheapest-loss-first
    ('device' -> 'f16' -> 'host'), groups largest-first within a mode; the
    first fit under CENSUS_SAFETY x budget wins. Returns a dict with
    ``logsf_out`` (None = nothing fits), ``lookup_group``, ``census_peak``.
    """
    budget = device_hbm_budget() if budget is None else int(budget)
    admit = CENSUS_SAFETY * budget
    cell = rows * chunk_w * 4
    out_bytes = {"device": 5 * n * n_attrs,  # f32 logsf + int8 indicator
                 "f16": 3 * n * n_attrs,
                 "host": 0}
    best = None
    for mode in modes:
        resident = (ind_bytes + ann_bytes + keep_band + extra_resident
                    + out_bytes[mode])
        for g in groups:
            peak = resident + table_bytes + (2 + g) * cell
            sel = dict(logsf_out=mode, lookup_group=int(g),
                       census_peak=int(peak), admit=int(admit),
                       budget=budget, fits=peak <= admit)
            if sel["fits"]:
                return sel
            if best is None or peak < best["census_peak"]:
                best = dict(sel, logsf_out=None)
    return best


def band_go_hbm_plan(n: int, band: int, n_attrs: int, *, packed: bool,
                     split_front: bool, keep_distances: bool,
                     logsf_out: str = "auto", prep_chunked: bool = True,
                     budget: int | None = None,
                     block: int = 128, chunk_cols: int = 512,
                     table_bytes: int | None = None):
    """Phase-peak HBM plan for the single-chip band GO (binary) pipeline.

    Returns a dict with per-phase byte peaks, the admitted ``logsf_out``
    residency ('auto' picks the cheapest-loss mode that fits: device ->
    f16 -> host) and slot-loop ``lookup_group``, ``fits`` and the governing
    phase. Callers raise on ``fits=False`` — never dispatch.

    ``table_bytes``: one chunk's live class table; this pre-prep plan
    defaults to :data:`TABLE_BYTES_ESTIMATE` (the true R*S_max*C geometry
    needs K — ops/enrich_band.hypergeom_band_table re-selects with the
    exact table once its plan exists).

    ``prep_chunked``: the operand-prep phase builds the int8 annotations
    from column-chunked uploads (~2 cells/byte peak + one f32 chunk,
    ops/enrich_band.band_hyper_operands_chunked); False models the
    full-device prep, whose jit peak is ~10 cells (the f32 upload + the
    twice-consumed f32 nan0 XLA materializes + int8 + gather out —
    not yet re-measured on a GPU).
    """
    budget = device_hbm_budget() if budget is None else int(budget)
    admit_relax = RELAX_SAFETY * budget
    bt, rows, window = band_geometry(n, band, block)
    f32_band = rows * window * 4
    ind_bytes = rows * window // 8 if packed else rows * window
    ann8 = n * n_attrs  # int8 operands (band_hyper_operands_device)

    prep_peak = (2 * ann8 + 4 * n * min(chunk_cols, n_attrs)
                 if prep_chunked else 10 * ann8)
    relax_peak = (f32_band * (1 if split_front else 2)
                  + ind_bytes + ann8)

    keep_band = f32_band if keep_distances else 0
    w = min(chunk_cols, n_attrs)
    sel = census_select(
        n=n, n_attrs=n_attrs, rows=rows, chunk_w=w, ind_bytes=ind_bytes,
        ann_bytes=ann8, keep_band=keep_band,
        table_bytes=(TABLE_BYTES_ESTIMATE if table_bytes is None
                     else int(table_bytes)),
        budget=budget,
        modes=(("device", "f16", "host") if logsf_out == "auto"
               else (logsf_out,)))
    census_peak = sel["census_peak"]
    fits = (sel["fits"] and relax_peak <= admit_relax
            and prep_peak <= admit_relax)
    # governing = the phase closest to (or furthest past) its admit line
    ratios = {"prep": prep_peak / admit_relax,
              "relax": relax_peak / admit_relax,
              "census": census_peak / sel["admit"]}
    governing = max(ratios, key=ratios.get)
    return dict(n=n, band=band, n_attrs=n_attrs, bt=bt, rows=rows,
                window=window, packed=packed, split_front=split_front,
                keep_distances=keep_distances, prep_chunked=prep_chunked,
                f32_band=f32_band, indicator_bytes=ind_bytes,
                annotations_int8=ann8, prep_peak=prep_peak,
                relax_peak=relax_peak, census_peak=census_peak,
                logsf_out=sel["logsf_out"] if fits else None,
                lookup_group=sel["lookup_group"],
                budget=budget, admit=sel["admit"],
                admit_relax=int(admit_relax), fits=fits,
                governing_phase=governing)


def band_go_shard_hbm_plan(n: int, band: int, n_attrs: int, ndev: int, *,
                           packed: bool = True, budget: int | None = None,
                           block: int = 128, chunk_cols: int = 1024,
                           table_bytes: int | None = None,
                           groups=LOOKUP_GROUPS):
    """Per-shard HBM plan for the ROW-SHARDED band GO engine
    (parallel/band_sharded.hypergeom_band_table_sharded) over a 'data' mesh
    axis of ``ndev`` devices — the facade's pre-dispatch assertion that the
    sharded engine genuinely starts where one device ends.

    Resident per shard: the f32 FW slab + 2*bt*block ghost/halo rows, the
    (packed) indicator slab, the row-sharded int8 annotations, the two
    row-sharded (n, A) outputs, and one census chunk's live set — the
    replicated class table plus (2 + group) per-shard chunk-cells (the
    slot-loop lookup's counts/acc/gather buffers, see
    :func:`census_select`); ``lookup_group`` is chosen largest-first.
    """
    budget = device_hbm_budget() if budget is None else int(budget)
    admit = CENSUS_SAFETY * budget
    bt, rows, window = band_geometry(n, band, block)
    local_rows = -(-rows // (block * ndev)) * block
    ghost = 2 * bt * block
    slab_rows = local_rows + ghost
    fw_slab = slab_rows * window * 4
    ind_bytes = slab_rows * window // 8 if packed else slab_rows * window
    ann8 = rows * n_attrs // ndev
    out_bytes = 5 * (n * n_attrs // ndev)  # f32 logsf + int8 bin, row-sharded
    w = min(chunk_cols, n_attrs)
    table = (TABLE_BYTES_ESTIMATE if table_bytes is None
             else int(table_bytes))
    resident = fw_slab + ind_bytes + ann8 + out_bytes
    per_shard = group = transient = None
    for g in groups:
        group = int(g)
        transient = table + (2 + group) * slab_rows * w * 4
        per_shard = resident + transient
        if per_shard <= admit:
            break
    return dict(n=n, band=band, n_attrs=n_attrs, ndev=ndev, bt=bt,
                rows=rows, window=window, packed=packed,
                fw_slab=fw_slab, indicator_bytes=ind_bytes,
                annotations_int8=ann8, out_bytes=out_bytes,
                census_transient=transient, per_shard_peak=per_shard,
                lookup_group=group, budget=budget, admit=int(admit),
                fits=per_shard <= admit, sharded=True)


def explain(plan: dict) -> str:
    """One-line human summary of a plan (used in the guard's ValueError)."""
    gb = 1e9
    if plan.get("sharded"):
        return (f"sharded band GO HBM plan at {plan['n']:,} x "
                f"{plan['n_attrs']:,} over {plan['ndev']} devices (band "
                f"{plan['band']}, packed={plan['packed']}): per-shard peak "
                f"{plan['per_shard_peak'] / gb:.2f} GB vs admitted "
                f"{plan['admit'] / gb:.2f} GB of {plan['budget'] / gb:.2f} GB")
    return (f"band GO HBM plan at {plan['n']:,} x {plan['n_attrs']:,} "
            f"(band {plan['band']}, packed={plan['packed']}, "
            f"split_front={plan['split_front']}, "
            f"keep_distances={plan['keep_distances']}): "
            f"prep peak {plan['prep_peak'] / gb:.2f} GB, "
            f"relax peak {plan['relax_peak'] / gb:.2f} GB, census peak "
            f"{(plan['census_peak'] or 0) / gb:.2f} GB "
            f"(logsf_out={plan['logsf_out']}, "
            f"lookup_group={plan.get('lookup_group')}) vs admitted "
            f"{plan['admit'] / gb:.2f} GB of {plan['budget'] / gb:.2f} GB")
