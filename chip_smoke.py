"""Smoke run of SAFE on an NVIDIA GPU: the main path end to end, through the
``SAFE`` facade as a user calls it, at the sizes its users run, with every
Floyd-Warshall kernel compiled for the card and compared with its plain
reference.

    python chip_smoke.py              # one card: phases A-E
    python chip_smoke.py --cards 4    # four cards: the sharded paths only

One card:
  A  Example_1: 3,971-node / 28,202-edge kNN network, one quantitative
     attribute (33% NaN), 1,000 permutations, apsp_mode='auto' (the
     radius-bounded window FW, then the fused null);
  B  the same with apsp_mode='full' (dense blocked FW);
  C  Costanzo-scale GO: 3,971 nodes x 4,373 binary terms, hypergeometric
     class-table engine;
  D  band-store engine: 49,920 nodes x 2,048 GO terms, apsp_mode='band', then
     the quantitative 1,000-permutation null at the same scale;
  E  every min-plus kernel against the jnp relax at the widths A and D use.
Four cards (``--cards 4``): phase D's GO configuration on make_mesh({'data':
4}) and Example_1's null on make_mesh({'perm': 4}), each against the
one-card run on device 0 in the same process.

Every comparison prints its maximum error beside its tolerance and fails the
run when above it; no phase failure is caught. The data is synthetic, from
``--seed``. Earlier lines give the card's name and power limit and, per
phase, compile (set-up) time, one steady time (block_until_ready) and the
allocator's peak bytes so far; the last line is one JSON object with the
device as JAX reports it. Off the GPU the script exits non-zero and prints
no result. The phase functions take their sizes as arguments (and ``impl``,
the min-plus implementation) so tests run them small on the CPU.
"""

import argparse
import json
import sys
import time

import numpy as np

#: the Example_1 network (Costanzo-2016 scale) and its attribute
EX1 = dict(n=3971, k=16, edges=28202, perms=1000, nan=0.33)
#: Costanzo GO-BP matrix shape (BASELINE.md)
GO = dict(attrs=4373)
#: band-store scale (the benchmark's band cell)
BAND = dict(n=49920, k=9, attrs=2048, nan=0.05, perms=1000)
#: sampled source rows of the APSP / hypergeometric checks
SAMPLE_ROWS = 256


class CheckFailed(AssertionError):
    pass


def check(name, err, tol, extra=""):
    """Print one comparison beside its tolerance; raise above it."""
    ok = bool(err <= tol)
    print(f"  check {name}: max err {err:.3g} (tolerance {tol:.3g}) "
          f"{'ok' if ok else 'FAILED'}{extra}", flush=True)
    if not ok:
        raise CheckFailed(f"{name}: {err} > {tol}")


def report(phase, compile_s, steady_s):
    from safepy_tpu.profiling import peak_bytes
    print(f"phase {phase}: compile+first {compile_s:.6f} s, steady "
          f"{steady_s:.6f} s, peak_bytes_in_use {peak_bytes()}", flush=True)


def _run_twice(sf, attrs, **kwargs):
    """(first s, steady s) of load_attributes + run_pipeline, synced."""
    from bench import sync

    walls = []
    for _ in range(2):
        t0 = time.perf_counter()
        sf.load_attributes(attribute_file=attrs)
        sf.run_pipeline(**kwargs)
        sync(sf)
        walls.append(time.perf_counter() - t0)
    return walls


def _session(graph, *, impl, seed, **attrs):
    from safepy_tpu import SAFE

    sf = SAFE(verbose=False)
    sf.minplus_impl = impl
    sf.random_seed = seed
    for k, v in attrs.items():
        setattr(sf, k, v)
    sf.load_network(network_file=graph, node_key_attribute="key")
    return sf


def _frame(vals, prefix):
    import pandas as pd
    return pd.DataFrame(vals, index=[f"{prefix}{i}" for i in
                                     range(vals.shape[0])],
                        columns=[f"a{j}" for j in range(vals.shape[1])])


# --------------------------------------------------------------- oracles

def _csgraph(n, edges, lengths):
    from scipy.sparse import coo_matrix
    a = coo_matrix((lengths, (edges[:, 0], edges[:, 1])), shape=(n, n))
    return a.maximum(a.T).tocsr()


def check_distances(name, rows, got_rows, graph_csr, nr, limit=True):
    """Sampled-row APSP against scipy Dijkstra (f64): finite distances within
    rtol 1e-5 (f32 sums), the <= radius indicator identical except pairs
    within 1e-5 relative of the radius (counted)."""
    from scipy.sparse.csgraph import dijkstra

    ref = dijkstra(graph_csr, indices=rows,
                   limit=nr * (1 + 1e-4) if limit else np.inf)
    inside = ref <= nr
    both = inside & np.isfinite(got_rows)
    rel = np.abs(got_rows[both] - ref[both]) / np.maximum(ref[both], 1e-30)
    check(f"{name} distances vs scipy dijkstra ({len(rows)} rows)",
          float(rel.max(initial=0.0)), 1e-5)
    near = np.abs(ref - nr) <= 1e-5 * nr
    got_in = got_rows <= nr * (1 + 1e-6)
    bad = (got_in != inside) & ~near
    check(f"{name} neighborhood indicator vs scipy", float(bad.sum()), 0,
          f"; {int(near.sum())} pairs within 1e-5 of the radius excluded")


def check_scores(name, nbr_rows, vals, got):
    """Observed 'sum' scores against NumPy f64: the error of each sum
    relative to the magnitude of its terms (f32 GEMM at HIGHEST)."""
    x = np.where(np.isnan(vals), 0.0, vals).astype(np.float64)
    ref = nbr_rows.astype(np.float64) @ x
    scale = np.maximum(np.abs(nbr_rows.astype(np.float64) @ np.abs(x)),
                       1e-30)
    ok = np.isfinite(got)
    check(f"{name} observed scores vs numpy f64",
          float((np.abs(got[ok] - ref[ok]) / scale[ok]).max(initial=0.0)),
          1e-5)


def check_hypergeom(name, nbr_rows, vals, got_p, got_bin, threshold=0.05):
    """p-values of sampled rows against scipy.stats.hypergeom.sf (absolute,
    the repo's 1e-6 parity target) and the enriched indicator (p < thr)."""
    from scipy.stats import hypergeom

    finite = ~np.isnan(vals)
    nan0 = np.where(finite, vals, 0.0)
    node_ok = finite.any(axis=1).astype(np.float64)
    M = int(node_ok.sum())
    K = nan0.sum(axis=0)
    k = nbr_rows.astype(np.float64) @ nan0
    n = nbr_rows.astype(np.float64) @ node_ok
    ref = hypergeom.sf(k - 1, M, K[None, :], n[:, None])
    check(f"{name} p-values vs scipy hypergeom.sf",
          float(np.nanmax(np.abs(got_p - ref))), 1e-6)
    near = np.abs(ref - threshold) <= 1e-6
    bad = ((ref < threshold) != (got_bin > 0)) & ~near
    check(f"{name} enriched indicator vs scipy", float(bad.sum()), 0,
          f"; {int(near.sum())} cells within 1e-6 of the threshold excluded")


def _counts(pvalues, permutations):
    """Permutation counts back from the facade's p-values (NaN kept)."""
    return np.rint(pvalues * permutations)


def check_counts(name, got, ref, against="CPU backend"):
    """Permutation counts against the same program on the CPU backend (same
    key, same threefry bits) or another engine with the same neighborhoods:
    a cell may differ only where a permuted score ties the observed one
    within f32 rounding (the runs sum in other orders). Bound: at most 1% of
    cells differ, by at most 3 counts."""
    diff = np.abs(np.nan_to_num(got - ref))
    frac = float((diff > 0).mean())
    print(f"  {name}: {int((diff > 0).sum())} of {diff.size} count cells "
          f"differ from the {against} run", flush=True)
    check(f"{name} counts vs {against} (max |diff|)", float(diff.max()), 3)
    check(f"{name} counts vs {against} (cells differing)", frac, 0.01)


def _sample(n, seed):
    rng = np.random.default_rng(seed)
    return np.sort(rng.choice(n, size=min(SAMPLE_ROWS, n), replace=False))


# ---------------------------------------------------------------- phases

def phase_a(*, n=EX1["n"], k=EX1["k"], edges=EX1["edges"],
            perms=EX1["perms"], seed=0, impl=None):
    """Example_1 through the facade, apsp_mode='auto'. Returns the session
    and what later phases compare with."""
    import jax
    from bench import knn_network, network_graph, quantitative_attribute

    coords, edge_arr, lengths = knn_network(seed, n, k, edges)
    graph = network_graph(coords, edge_arr, lengths, "gene")
    vals = quantitative_attribute(np.random.default_rng(seed + 1), n,
                                  EX1["nan"])
    attrs = _frame(vals, "gene")
    sf = _session(graph, impl=impl, seed=seed + 1885)
    first, steady = _run_twice(sf, attrs, num_permutations=perms)
    report("A (Example_1, window FW + null)", first, steady)
    window = next(p for p in sf._banded_cache.values() if p is not None)[2]
    nr = sf.neighborhood_radius * np.ptp(coords[:, 0])
    rows = _sample(n, seed)
    csr = _csgraph(n, edge_arr, lengths)
    dist = sf.node_distances
    check_distances("A", rows, dist[rows], csr, nr)
    nbr = sf.neighborhoods
    check_scores("A", nbr[rows], vals, sf.ns[rows])
    counts = _counts(sf.pvalues_pos, perms)
    with jax.default_device(jax.devices("cpu")[0]):
        cpu = _session(graph, impl=None, seed=seed + 1885)
        cpu.load_attributes(attribute_file=attrs)
        cpu.run_pipeline(num_permutations=perms)
        check_counts("A", counts, _counts(cpu.pvalues_pos, perms))
        check_counts("A (neg)", _counts(sf.pvalues_neg, perms),
                     _counts(cpu.pvalues_neg, perms))
    return dict(graph=graph, coords=coords, edges=edge_arr, lengths=lengths,
                vals=vals, attrs=attrs, window=int(window), nbr=nbr,
                counts=counts, nr=nr, seed=seed, perms=perms)


def phase_b(a, *, impl=None):
    """The same network with apsp_mode='full': dense blocked FW."""
    sf = _session(a["graph"], impl=impl, seed=a["seed"] + 1885,
                  apsp_mode="full")
    first, steady = _run_twice(sf, a["attrs"], num_permutations=a["perms"])
    report("B (dense FW + null)", first, steady)
    n = len(a["coords"])
    rows = _sample(n, a["seed"] + 7)
    dist = sf.node_distances
    csr = _csgraph(n, a["edges"], a["lengths"])
    check_distances("B", rows, dist[rows], csr, a["nr"], limit=False)
    near = np.abs(dist - a["nr"]) <= 1e-5 * a["nr"]
    check("B indicator vs A (cells differing)",
          float(((sf.neighborhoods != a["nbr"]) & ~near).sum()), 0,
          f"; {int(near.sum())} pairs within 1e-5 of the radius excluded")
    check_counts("B", _counts(sf.pvalues_pos, a["perms"]), a["counts"],
                 against="phase A")


def phase_c(a, *, attrs=GO["attrs"], impl=None):
    """Costanzo-scale GO through the hypergeometric class-table engine."""
    from bench import GO_NAN_FRACTION, go_annotations

    n = len(a["coords"])
    vals = go_annotations(np.random.default_rng(a["seed"] + 2), n, attrs,
                          GO_NAN_FRACTION)
    sf = _session(a["graph"], impl=impl, seed=a["seed"])
    first, steady = _run_twice(sf, _frame(vals, "gene"))
    report(f"C (GO {n} x {attrs}, {sf._hypergeom_engine_used})", first,
           steady)
    rows = _sample(n, a["seed"] + 3)
    nbr = sf.neighborhoods
    check_hypergeom("C", nbr[rows], vals, sf.pvalues_pos[rows],
                    sf.nes_binary[rows])


def _band_rows(banded, rows):
    """Dense rows (original frame) of a device BandedMatrix."""
    return banded.to_sparse()[rows].toarray()


def phase_d(*, n=BAND["n"], k=BAND["k"], attrs=BAND["attrs"],
            perms=BAND["perms"], seed=0, impl=None):
    """Band-store engine: GO then the quantitative null at the same scale."""
    import jax
    from bench import (go_annotations, knn_network, network_graph,
                       quantitative_attribute)

    coords, edge_arr, lengths = knn_network(seed, n, k, None)
    graph = network_graph(coords, edge_arr, lengths, "n")
    radius = float(np.sqrt(125.0 / (np.pi * n)))
    band_kw = dict(apsp_mode="band", neighborhood_radius=radius)
    rng = np.random.default_rng(seed + 4)
    go = go_annotations(rng, n, attrs, BAND["nan"])
    sf = _session(graph, impl=impl, seed=seed + 17, **band_kw)
    first, steady = _run_twice(sf, _frame(go, "n"))
    report(f"D (band GO {n} x {attrs}, {sf._hypergeom_engine_used})",
           first, steady)
    band = sf._neighborhoods_dev
    nr = radius * np.ptp(coords[:, 0])
    rows = _sample(n, seed + 5)
    csr = _csgraph(n, edge_arr, lengths)
    dist_rows = _band_rows(sf._node_distances_dev, rows)
    dist_rows = np.where(dist_rows > 0, dist_rows, np.inf)
    dist_rows[np.arange(len(rows)), rows] = 0.0
    check_distances("D", rows, dist_rows, csr, nr)
    nbr_rows = _band_rows(band, rows)
    check_hypergeom("D", nbr_rows, go, sf.pvalues_pos[rows],
                    sf.nes_binary[rows])

    q = quantitative_attribute(rng, n, 0.3)
    qattrs = _frame(q, "n")
    first, steady = _run_twice(sf, qattrs, num_permutations=perms)
    report(f"D (band null {n}, {perms} permutations)", first, steady)
    check_scores("D null", _band_rows(sf._neighborhoods_dev, rows), q,
                 sf.ns[rows])
    with jax.default_device(jax.devices("cpu")[0]):
        cpu = _session(graph, impl=None, seed=seed + 17, **band_kw)
        cpu.load_attributes(attribute_file=qattrs)
        cpu.run_pipeline(num_permutations=perms)
        check_counts("D null", _counts(sf.pvalues_pos, perms),
                     _counts(cpu.pvalues_pos, perms))
    return dict(bt=band.bt, band=band.band)


def phase_e(*, window, bt, n_dense, block=128, impl="triton", seed=0):
    """Every min-plus kernel against the jnp relax at real widths: bit for
    bit (each candidate is one f32 add; min is exact and order-free)."""
    import jax
    import jax.numpy as jnp
    from safepy_tpu.ops import minplus

    rng = np.random.default_rng(seed)

    def rand(shape, lo=0.0, hi=10.0):
        return jnp.asarray(rng.uniform(lo, hi, shape).astype(np.float32))

    half = (window - block) // 2
    nt = 2 * bt + 1
    npad = -(-n_dense // block) * block
    q_win, q_dense = rand((window, block)), rand((npad, block))
    diag = rand((block, block))
    sym = lambda x: jnp.minimum(x, x.T)  # noqa: E731
    cases = {
        f"relax rows 128x{window}": (
            lambda i, c: minplus.relax(c, diag, c, impl=i),
            rand((block, window), 1, 20)),
        f"relax rows 128x{nt * block}": (
            lambda i, c: minplus.relax(c, diag, c, impl=i),
            rand((block, nt * block), 1, 20)),
        f"relax cols {window}x128": (
            lambda i, c: minplus.relax(c, c, diag, impl=i),
            rand((window, block), 1, 20)),
        f"window upper {window}x{window}": (
            lambda i, c: minplus.relax_upper(
                c, q_win, q_win.T, block=block,
                band_tiles=half // block + 3, impl=i),
            sym(rand((window, window), 1, 20))),
        f"dense upper {npad}x{npad}": (
            lambda i, c: minplus.relax_upper(
                c, q_dense, q_dense.T, block=block,
                band_tiles=npad // block, impl=i),
            sym(rand((npad, npad), 1, 20))),
        f"skew wedge bt={bt} ({nt * block}x{nt * block})": (
            lambda i, c: minplus.relax_skew(
                c, jnp.pad(c[:block], ((0, 0), (bt * block, bt * block)),
                           constant_values=np.inf),
                bt=bt, block=block, impl=i),
            rand((nt * block, nt * block), 1, 20)),
        f"close tile {block}x{block}": (
            lambda i, c: minplus.close_tile(c, impl=i),
            sym(rand((block, block), 0.1, 9))),
    }
    for name, (fn, x) in cases.items():
        kern = jax.jit(lambda c, fn=fn: fn(impl, c))
        ref = jax.jit(lambda c, fn=fn: fn("jnp", c))
        t0 = time.perf_counter()
        got = jax.block_until_ready(kern(x))
        comp = time.perf_counter() - t0
        t0 = time.perf_counter()
        got = jax.block_until_ready(kern(x))
        steady = time.perf_counter() - t0
        want = jax.block_until_ready(ref(x))
        report(f"E ({name}, {impl})", comp, steady)
        both_inf = np.isinf(got) & np.isinf(want)
        err = np.where(both_inf, 0.0, np.abs(np.asarray(got)
                                             - np.asarray(want)))
        check(f"E {name} vs jnp relax", float(err.max()), 0.0)


def phase_mesh(*, ndev=4, n_band=BAND["n"], k_band=BAND["k"],
               attrs=BAND["attrs"], n=EX1["n"], k=EX1["k"],
               edges=EX1["edges"], perms=EX1["perms"], seed=0, impl=None):
    """Sharded paths on ``ndev`` devices against the one-card run on device
    0: phase D's GO on make_mesh({'data': ndev}) (row-sharded band FW,
    census, class-table lookup) and Example_1's null on
    make_mesh({'perm': ndev}) (psum of the per-device counts)."""
    import jax
    from bench import build_network, go_annotations, quantitative_attribute
    from safepy_tpu.parallel import make_mesh
    from safepy_tpu.profiling import peak_bytes

    graph, _ = build_network(seed, n_band, k_band, None, prefix="n")
    go = _frame(go_annotations(np.random.default_rng(seed + 4), n_band,
                               attrs, BAND["nan"]), "n")
    band_kw = dict(apsp_mode="band",
                   neighborhood_radius=float(np.sqrt(125.0 / (np.pi
                                                              * n_band))))
    runs = {}
    for label, mesh in (("one card", None),
                        (f"data={ndev}", make_mesh({"data": ndev},
                                                   jax.devices()[:ndev]))):
        sf = _session(graph, impl=impl, seed=seed + 17, **band_kw)
        sf.mesh = mesh
        first, steady = _run_twice(sf, go)
        report(f"mesh GO {label} ({sf._hypergeom_engine_used})", first,
               steady)
        runs[label] = (sf.pvalues_pos, sf.nes_binary)
    (p1, b1), (p4, b4) = runs.values()
    check("mesh GO enriched indicator vs one card (cells differing)",
          float((b4 != b1).sum()), 0)
    check("mesh GO p-values vs one card", float(np.nanmax(np.abs(p4 - p1))),
          1e-6)

    graph, _ = build_network(seed, n, k, edges)
    q = _frame(quantitative_attribute(np.random.default_rng(seed + 1), n,
                                      EX1["nan"]), "gene")
    runs = {}
    for label, mesh in (("one card", None),
                        (f"perm={ndev}", make_mesh({"perm": ndev},
                                                   jax.devices()[:ndev]))):
        sf = _session(graph, impl=impl, seed=seed + 1885)
        sf.mesh = mesh
        first, steady = _run_twice(sf, q, num_permutations=perms)
        report(f"mesh null {label}", first, steady)
        runs[label] = sf.pvalues_pos
    # per-device keys draw other permutations: compare by distribution.
    # Each p is a mean of `perms` Bernoulli draws, so two independent
    # estimates differ with std sqrt(2 p (1 - p) / perms); bound every cell
    # at 6 of those (2e-9 two-sided per cell), plus one count of slack.
    p1, p4 = runs.values()
    pm = (p1 + p4) / 2
    sd = np.sqrt(2 * pm * (1 - pm) / perms) + 1.0 / perms
    ok = np.isfinite(p1) & np.isfinite(p4)
    check("mesh null p-values vs one card (in std units)",
          float((np.abs(p4 - p1)[ok] / sd[ok]).max(initial=0.0)), 6.0)
    for dev in jax.devices()[:ndev]:
        print(f"  peak_bytes_in_use {dev}: {peak_bytes(dev)}", flush=True)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--cards", type=int, default=1, choices=(1, 4),
                        help="1: phases A-E on one card; 4: the sharded "
                             "paths on four cards, compared with one")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    from safepy_tpu.profiling import card_line, device_summary, require_gpu

    devices = require_gpu()
    if len(devices) < args.cards:
        raise SystemExit(f"--cards {args.cards} needs {args.cards} GPUs, "
                         f"JAX sees {len(devices)}")
    print(card_line(), flush=True)
    device = device_summary(devices[:args.cards])
    print(f"device {json.dumps(device)}", flush=True)
    t0 = time.perf_counter()
    if args.cards == 1:
        a = phase_a(seed=args.seed)
        phase_b(a)
        phase_c(a)
        d = phase_d(seed=args.seed)
        phase_e(window=a["window"], bt=d["bt"], n_dense=EX1["n"],
                seed=args.seed)
    else:
        phase_mesh(ndev=args.cards, seed=args.seed)
    print(f"total {time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
