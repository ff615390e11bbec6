"""Min-plus relaxation on the card: the Triton kernel against what XLA makes
of the plain jnp version, at the widths the chip_smoke phases use.

    python tools/minplus_bench.py [--out chiprun_out/minplus_bench.json]
                                  [--trace-dir chiprun_out/minplus_trace]

Widths: Example_1's banded window and its dense FW (3,971-node kNN network,
radius 0.1 of the x extent, as chip_smoke phases A and B), and the band
store's skew window at 49,920 nodes (radius sqrt(125 / (pi n)) of the x
extent, bt bucketed to a multiple of 4 as the facade does — phase D).

Per relaxation: seconds per call (median of 5 timed loops of ``REPS`` calls
inside one jit, each finished with block_until_ready) for the Triton kernel
at several tilings, the jnp relax at several k-chunks and the plain
one-pivot-per-step fori_loop; every variant is checked bit for bit against
the jnp relax. Then whole Floyd-Warshall runs with each implementation, the
diagonal closure as jnp or kernel, and a profiler trace of each FW with the
per-kernel device time. Runs on a GPU only.
"""

import argparse
import json
import os
import statistics
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

REPS = 20
#: (rows, cols, warps) tilings of the Triton kernel to sweep
TRITON_TILES = [(64, 64, 8), (64, 64, 4), (64, 64, 2), (128, 128, 4),
                (128, 128, 8), (32, 64, 2)]
JNP_CHUNKS = [8, 16, 32]


def _kloop(c, a, b):
    """The plain jnp relax with one pivot per fori_loop step."""
    import jax
    import jax.numpy as jnp

    m = a.shape[0]

    def body(k, acc):
        col = jax.lax.dynamic_slice(a, (0, k), (m, 1))
        row = jax.lax.dynamic_slice(b, (k, 0), (1, b.shape[1]))
        return jnp.minimum(acc, col + row)

    return jax.lax.fori_loop(0, a.shape[1], body, c)


def per_call(fn, x):
    """(compile s, median s per call, output) of ``fn`` applied REPS times."""
    import jax

    loop = jax.jit(lambda x: jax.lax.fori_loop(0, REPS, lambda i, y: fn(y),
                                               x))
    t0 = time.perf_counter()
    out = jax.block_until_ready(loop(x))
    compile_s = time.perf_counter() - t0
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        jax.block_until_ready(loop(x))
        times.append((time.perf_counter() - t0) / REPS)
    return compile_s, statistics.median(times), np.asarray(out)


def widths(seed=0, n_a=3971, n_d=49920):
    """Problem data at phase A/B and phase D widths."""
    import jax.numpy as jnp
    from bench import knn_network
    from safepy_tpu.ops import apsp_banded as ab
    from safepy_tpu.ops import apsp_bandstore as bs
    from safepy_tpu.ops.apsp import pad_distances
    from safepy_tpu.ops.neighborhoods import initial_distances_device

    out = {}
    coords, edges, lengths = knn_network(seed, n=n_a)
    n = len(coords)
    nr = 0.1 * np.ptp(coords[:, 0])
    order, band = ab.banded_order(coords, nr * (1 + 1e-5))
    rank = np.empty(n, np.int64)
    rank[order] = np.arange(n)
    window = ab.window_width(n, band)
    out["A"] = dict(
        n=n, band=int(band), window=int(window),
        d_perm=pad_distances(initial_distances_device(n, rank[edges],
                                                      lengths), 128),
        d_dense=initial_distances_device(n, edges, lengths))

    coords, edges, lengths = knn_network(seed, n=n_d, k=9,
                                         edge_budget=None)
    n = len(coords)
    nr = float(np.sqrt(125.0 / (np.pi * n))) * np.ptp(coords[:, 0])
    order, band = ab.banded_order(coords, nr * (1 + 1e-5))
    bt = -(-(band // 128 + 1) // 4) * 4
    band = bt * 128 - 1
    rank = np.empty(n, np.int64)
    rank[order] = np.arange(n)
    pe = rank[edges]
    out["D"] = dict(
        n=n, band=int(band), bt=int(bt),
        s=bs.band_init_from_edges(jnp.asarray(pe[:, 0], jnp.int32),
                                  jnp.asarray(pe[:, 1], jnp.int32),
                                  jnp.asarray(lengths, jnp.float32),
                                  n=n, band=band))
    return out


def kernel_cases(w):
    """{case: (input, {variant: fn})} for every relaxation the FWs run."""
    import jax.numpy as jnp
    from safepy_tpu.ops import minplus

    rng = np.random.default_rng(0)

    def rand(shape, lo=0.0, hi=10.0):
        return jnp.asarray(rng.uniform(lo, hi, shape).astype(np.float32))

    blk = 128
    wa = w["A"]["window"]
    half = (wa - blk) // 2
    band_tiles_a = half // blk + 3
    npad_b = -(-w["A"]["n"] // blk) * blk
    bt = w["D"]["bt"]
    nt = 2 * bt + 1
    wd = nt * blk

    diag = rand((blk, blk))
    q_a = rand((wa, blk))
    q_b = rand((npad_b, blk))
    p_d = jnp.pad(rand((blk, wd)), ((0, 0), (bt * blk, bt * blk)),
                  constant_values=np.inf)

    def variants(triton_fn, jnp_fn, with_kloop=True):
        v = {f"triton{t}": (lambda t=t: lambda c: triton_fn(c, t))()
             for t in TRITON_TILES}
        v.update({f"jnp_chunk{k}": (lambda k=k: lambda c: jnp_fn(c, k))()
                  for k in JNP_CHUNKS})
        if with_kloop:
            v["jnp_kloop"] = lambda c: jnp_fn(c, "kloop")
        return v

    def jnp_relax(c, a, b, chunk):
        if chunk == "kloop":
            return _kloop(c, a, b)
        return minplus.relax_jnp(c, a, b, chunk=chunk)

    def with_chunk(chunk, f):
        """Run a structured jnp relaxation with another relax inside."""
        saved = minplus.relax_jnp, minplus.JNP_CHUNK
        if chunk == "kloop":
            minplus.relax_jnp = lambda c, a, b, chunk=None: _kloop(c, a, b)
        else:
            minplus.JNP_CHUNK = chunk
        try:
            return f()
        finally:
            minplus.relax_jnp, minplus.JNP_CHUNK = saved

    cases = {
        "rows_A (128 x W_A)": (rand((blk, wa), 1, 20), variants(
            lambda c, t: minplus.relax(c, diag, c, impl="triton", tiles=t),
            lambda c, k: jnp_relax(c, diag, c, k))),
        "window_upper_A (W_A x W_A)": (rand((wa, wa), 1, 20), variants(
            lambda c, t: minplus.relax_upper(
                c, q_a, q_a.T, block=blk, band_tiles=band_tiles_a,
                impl="triton", tiles=t),
            lambda c, k: with_chunk(k, lambda: minplus.relax_upper(
                c, q_a, q_a.T, block=blk, band_tiles=band_tiles_a,
                impl="jnp")))),
        "dense_upper_B (N x N)": (rand((npad_b, npad_b), 1, 20), variants(
            lambda c, t: minplus.relax_upper(
                c, q_b, q_b.T, block=blk, band_tiles=npad_b // blk,
                impl="triton", tiles=t),
            lambda c, k: with_chunk(k, lambda: minplus.relax_upper(
                c, q_b, q_b.T, block=blk, band_tiles=npad_b // blk,
                impl="jnp")), with_kloop=False)),
        "rows_D (128 x W_D)": (rand((blk, wd), 1, 20), variants(
            lambda c, t: minplus.relax(c, diag, c, impl="triton", tiles=t),
            lambda c, k: jnp_relax(c, diag, c, k))),
        "skew_D (W_D x W_D)": (rand((wd, wd), 1, 20), variants(
            lambda c, t: minplus.relax_skew(c, p_d, bt=bt, block=blk,
                                            impl="triton", tiles=t),
            lambda c, k: with_chunk(k, lambda: minplus.relax_skew(
                c, p_d, bt=bt, block=blk, impl="jnp")),
            with_kloop=False)),
        "close (128 x 128)": (rand((blk, blk)), {
            "triton": lambda t: minplus.close_tile(t, impl="triton"),
            "jnp": lambda t: minplus.close_tile(t, impl="jnp")}),
        "mirror_skew_D (jnp)": (rand((wd, wd)), {
            "jnp": lambda c: minplus._mirror_skew(c, bt=bt, block=blk)}),
        "mirror_lower_A (jnp)": (rand((wa, wa)), {
            "jnp": lambda c: minplus.mirror_lower(
                c, block=blk, band_tiles=band_tiles_a)}),
    }
    return cases


def fw_cases(w):
    """{name: fn(impl) -> distances} — the three FW engines at their
    phase widths."""
    from safepy_tpu.ops import apsp_banded as ab
    from safepy_tpu.ops import apsp_bandstore as bs
    from safepy_tpu.ops.apsp import apsp_blocked_fw

    a, d = w["A"], w["D"]
    return {
        "banded_window_A": lambda impl: ab.apsp_banded_fw(
            a["d_perm"], window=a["window"], impl=impl),
        "dense_B": lambda impl: apsp_blocked_fw(
            a["d_dense"], symmetric=True, impl=impl),
        "band_store_D": lambda impl: bs.apsp_band_fw(d["s"], bt=d["bt"],
                                                     impl=impl),
    }


def run_fw(fn, impl, close_impl):
    """(compile s, median steady s of 3, output) of one FW engine."""
    import jax
    from safepy_tpu.ops import minplus

    real_close = minplus.close_tile
    if close_impl is not None:
        minplus.close_tile = lambda t, impl: real_close(t, impl=close_impl)
    jax.clear_caches()
    try:
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(impl))
        compile_s = time.perf_counter() - t0
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            jax.block_until_ready(fn(impl))
            times.append(time.perf_counter() - t0)
    finally:
        minplus.close_tile = real_close
    return compile_s, statistics.median(times), np.asarray(out)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", default="chiprun_out/minplus_bench.json")
    parser.add_argument("--trace-dir", default="chiprun_out/minplus_trace")
    parser.add_argument("--skip-kernels", action="store_true")
    args = parser.parse_args(argv)

    import jax
    from safepy_tpu.ops import minplus
    from safepy_tpu.profiling import (card_line, device_summary,
                                      kernel_times, require_gpu)

    device = device_summary(require_gpu())
    card = card_line()
    print(card, flush=True)
    t0 = time.perf_counter()
    w = widths()
    report = {"card": card, "device": device,
              "widths": {"A": {k: w["A"][k] for k in ("n", "band", "window")},
                         "D": {k: w["D"][k] for k in ("n", "band", "bt")}},
              "setup_s": time.perf_counter() - t0,
              "kernels": {}, "fw": {}, "trace": {}}
    print("widths", json.dumps(report["widths"]), flush=True)

    if not args.skip_kernels:
        for case, (x, variants) in kernel_cases(w).items():
            ref = None
            rows = {}
            for name, fn in variants.items():
                try:
                    comp, sec, out = per_call(fn, x)
                except Exception as e:  # noqa: BLE001 — a variant the
                    # compiler refuses is a finding, not a crash
                    rows[name] = {"error": f"{type(e).__name__}: {e}"[:300]}
                    print(f"{case:28s} {name:24s} ERROR {rows[name]}",
                          flush=True)
                    continue
                if ref is None and name.startswith("jnp"):
                    ref = out
                rows[name] = {"compile_s": comp, "per_call_s": sec,
                              "out": out}
                print(f"{case:28s} {name:24s} {sec * 1e6:10.1f} us "
                      f"(compile {comp:.1f} s)", flush=True)
            for name, row in rows.items():
                if "out" in row:
                    row["bit_identical_to_jnp"] = bool(
                        ref is None or np.array_equal(row.pop("out"), ref))
            report["kernels"][case] = rows
            print(case, "bit-identical:", {k: v.get("bit_identical_to_jnp")
                                           for k, v in rows.items()},
                  flush=True)

    best = None
    if report["kernels"]:
        totals = {t: sum(rows.get(f"triton{t}", {}).get("per_call_s", 1e9)
                         for rows in report["kernels"].values()
                         if any(k.startswith("triton(") for k in rows))
                  for t in TRITON_TILES}
        best = min(totals, key=totals.get)
        report["best_tiles"] = list(best)
        print("best tiles", best, flush=True)
    for name, fn in fw_cases(w).items():
        rows = {}
        ref = None
        for impl, close_impl, tiles in (
                ("jnp", None, None), ("triton", None, None),
                ("triton", "jnp", None), ("triton", None, best)):
            label = impl if close_impl is None else f"{impl}+close_{close_impl}"
            if tiles is not None:
                if tuple(tiles) == tuple(minplus.TILES):
                    continue
                label += f"+tiles{tuple(tiles)}"
            saved, minplus.TILES = minplus.TILES, tiles or minplus.TILES
            try:
                comp, sec, out = run_fw(fn, impl, close_impl)
            finally:
                minplus.TILES = saved
            if ref is None:
                ref = out
            rows[label] = {"compile_s": comp, "steady_s": sec,
                           "bit_identical_to_jnp": bool(
                               np.array_equal(out, ref))}
            print(f"FW {name:18s} {label:22s} {sec * 1e3:10.2f} ms "
                  f"(compile {comp:.1f} s) identical="
                  f"{rows[label]['bit_identical_to_jnp']}", flush=True)
        report["fw"][name] = rows

        trace_dir = os.path.join(args.trace_dir, name)
        jax.block_until_ready(fn("triton"))
        jax.profiler.start_trace(trace_dir)
        jax.block_until_ready(fn("triton"))
        jax.profiler.stop_trace()
        lines = kernel_times(trace_dir)
        report["trace"][name] = {
            line: sorted(([k, c, s] for k, (c, s) in evs.items()),
                         key=lambda r: -r[2])[:25]
            for line, evs in lines.items()}
        for line, top in report["trace"][name].items():
            total = sum(r[2] for r in top)
            print(f"TRACE {name} [{line}] top-25 total {total * 1e3:.2f} ms",
                  flush=True)
            for k, c, s in top[:12]:
                print(f"    {s * 1e3:9.3f} ms  {c:7d}x  {k[:90]}",
                      flush=True)

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1, default=str)
    print("wrote", args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
