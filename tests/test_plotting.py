"""Plot smoke tests on the Agg backend: every figure renders without error."""

import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt
import networkx as nx
import numpy as np
import pandas as pd
import pytest

from safepy_tpu import SAFE
from safepy_tpu.colormaps import MidpointRangeNormalize, get_colors


@pytest.fixture(scope="module")
def analyzed(tmp_path_factory):
    """A pipeline state guaranteed to have >= 2 domains: two ring communities."""
    rng = np.random.default_rng(0)
    n = 80
    # two dense communities bridged by one edge -> two spatial regions
    g = nx.ring_of_cliques = nx.Graph()
    half = n // 2
    g.add_edges_from(nx.connected_watts_strogatz_graph(half, 6, 0.1, seed=1).edges())
    g2 = nx.connected_watts_strogatz_graph(n - half, 6, 0.1, seed=2)
    g.add_edges_from(((u + half, v + half) for u, v in g2.edges()))
    g.add_edge(0, half)
    path = tmp_path_factory.mktemp("plotdata") / "net.txt"
    with open(path, "w") as f:
        for u, v in g.edges():
            f.write(f"g{u}\tg{v}\t1.0\n")
    sf = SAFE(verbose=False)
    sf.random_seed = 3
    sf.load_network(network_file=str(path), node_key_attribute="key")
    sf.define_neighborhoods()
    labels = [sf.graph.nodes[i]["key"] for i in range(n)]
    vals = np.zeros((n, 6))
    vals[:half, :3] = (rng.random((half, 3)) < 0.8)
    vals[half:, 3:] = (rng.random((n - half, 3)) < 0.8)
    df = pd.DataFrame(vals, index=labels, columns=[f"attr {i}" for i in range(6)])
    sf.load_attributes(attribute_file=df)
    sf.compute_pvalues()
    sf.define_top_attributes(attribute_enrichment_min_size=3)
    if sf.attributes["top"].sum() >= 2:
        sf.define_domains()
        sf.trim_domains()
    return sf


def test_fixture_has_domains(analyzed):
    assert analyzed.domains is not None, (
        "plot fixture must produce domains; adjust the synthetic input")


def test_plot_network(analyzed):
    ax = analyzed.plot_network()
    assert ax is not None
    plt.close("all")


def test_plot_network_with_labels(analyzed):
    ax = analyzed.plot_network(labels=["g0", "g1", "not-there"])
    assert ax is not None
    plt.close("all")


def test_plot_composite_network(analyzed):
    fig, axes = analyzed.plot_composite_network(show_each_domain=False,
                                                color_seed=0)
    assert len(axes) >= 2
    plt.close("all")


def test_plot_composite_network_each_domain(analyzed, tmp_path):
    out = tmp_path / "composite.png"
    fig, axes = analyzed.plot_composite_network(show_each_domain=True,
                                                color_seed=0,
                                                save_fig=str(out))
    assert out.exists()
    plt.close("all")


def test_plot_composite_network_contours(analyzed):
    fig, axes = analyzed.plot_composite_network_contours(color_seed=0)
    assert len(axes) == 2
    plt.close("all")


def test_plot_sample_attributes(analyzed, tmp_path):
    out = tmp_path / "fig.png"
    fig, axes = analyzed.plot_sample_attributes(
        attributes=["attr 0"], show_raw_data=True, show_significant_nodes=True,
        save_fig=str(out))
    assert out.exists()
    plt.close("all")


def test_midpoint_normalize():
    norm = MidpointRangeNormalize(vmin=-10, vmax=10,
                                  midrange=[-1.3, 0, 1.3])
    out = np.asarray(norm(np.array([-10, -1.3, 0, 1.3, 10])))
    np.testing.assert_allclose(out, [0, 0.25, 0.5, 0.75, 1])


def test_get_colors_seeded():
    c1 = get_colors("hsv", 7, seed=4)
    c2 = get_colors("hsv", 7, seed=4)
    np.testing.assert_array_equal(c1, c2)
    assert tuple(c1[0]) == (0, 0, 0, 1)


# ---- content assertions (not just "returns axes") --------------------------

def test_composite_network_content(analyzed):
    """Domain-mixture panel draws every node, one id text per domain, and the
    per-domain panels carry NES-scaled alpha in [0.2, 1]."""
    n = analyzed.graph.number_of_nodes()
    num_domains = int((analyzed.domains["id"] > 0).sum())
    fig, axes = analyzed.plot_composite_network(show_each_domain=True,
                                                color_seed=0)
    mixture = axes[1].collections[0]
    assert len(mixture.get_offsets()) == n
    assert len(axes[1].texts) == num_domains  # one id label per domain

    for domain in range(1, num_domains + 1):
        panel = axes[1 + domain]
        assert panel.get_title().startswith(f"Domain {domain}")
        members = panel.collections[0]
        expected = int((analyzed.node2domain["primary_domain"] == domain).sum())
        assert len(members.get_offsets()) == expected
        alphas = members.get_facecolors()[:, 3]
        assert np.all((alphas >= 0.2) & (alphas <= 1.0))
        # NES-scaled transparency is live (reference sketched and abandoned it)
        nes = analyzed.node2domain.loc[
            analyzed.node2domain["primary_domain"] == domain, "primary_nes"]
        expected_alpha = np.clip(nes.values / analyzed.enrichment_max_log10,
                                 0.2, 1.0)
        np.testing.assert_allclose(alphas, expected_alpha, atol=1e-6)
    plt.close("all")


def test_attribute_map_content(analyzed):
    """NES scatter covers all nodes, the significant nodes get exactly one mark
    each, and the log-p colorbar axis exists."""
    fig, axes = analyzed.plot_sample_attributes(
        attributes="attr 0", show_raw_data=False, show_significant_nodes=True)
    panel = axes[1]
    n = analyzed.graph.number_of_nodes()
    sizes = [len(c.get_offsets()) for c in panel.collections]
    assert n in sizes  # the NES scatter
    n_significant = int((analyzed.nes_binary[:, 0] > 0).sum())
    assert n_significant > 0 and n_significant in sizes  # the "+" marks
    # the colorbar was added as an extra (non-shared) axes on the figure
    assert len(fig.axes) > len(axes)
    plt.close("all")


def test_costanzo_overlay_draws_contours(analyzed, tmp_path):
    """Synthetic safe-data bundle (same-schema TSV + color table): the KDE
    contour path draws one isoline per published process region."""
    from safepy_tpu.plotting import plot_costanzo2016_network_annotations

    other = tmp_path / "other"
    other.mkdir()
    half = analyzed.graph.number_of_nodes() // 2
    rows = [("Process One", f"g{i}") for i in range(0, half, 2)]
    rows += [("Process Two", f"g{i}") for i in range(half, 2 * half, 2)]
    clusters = pd.DataFrame(rows, columns=[
        "Global Similarity Network Region name", "Gene/Allele"])
    clusters.to_csv(other / ("Data File S5_SAFE analysis_Gene cluster identity "
                             "and functional enrichments.tsv"),
                    sep="\t", index=False)
    pd.DataFrame({"R": [255, 0, 64], "G": [0, 255, 64], "B": [0, 0, 192]}).to_csv(
        other / "costanzo_2016_colors.txt", sep="\t", index=False)

    fig, ax = plt.subplots()
    plot_costanzo2016_network_annotations(analyzed.graph, ax, str(tmp_path))
    assert len(ax.collections) == 2  # one contour set per process
    plt.close("all")


def test_fused_pipeline_requires_edge_lengths():
    """run_pipeline must reject shortpath_weighted_layout on graphs without
    'length' edge attributes, like define_neighborhoods does."""
    import networkx as _nx
    from safepy_tpu import SAFE as _SAFE

    g = _nx.path_graph(12)
    for node in g:
        g.nodes[node]["x"] = float(node)
        g.nodes[node]["y"] = 0.0
        g.nodes[node]["label"] = g.nodes[node]["key"] = f"n{node}"
    sf = _SAFE(verbose=False)
    sf.load_network(network_file=g, node_key_attribute="key")
    df = pd.DataFrame({"a": np.ones(12)}, index=[f"n{i}" for i in range(12)])
    sf.load_attributes(attribute_file=df)
    with pytest.raises(ValueError, match="length"):
        sf.run_pipeline(num_permutations=10)
    with pytest.raises(ValueError, match="length"):
        sf.define_neighborhoods()


def test_domain_mixture_counts_reuse_matches_indicator(analyzed):
    """The node2domain count columns ARE the per-domain enriched-attribute
    sums, so _domain_mixture_colors' reuse branch must color identically to
    the (N, A)-indicator fallback it replaced (reference safe.py:884-904)."""
    from safepy_tpu.plotting import _domain_colors, _domain_mixture_colors

    domains, rgb = _domain_colors(analyzed, seed=0)
    via_node2domain = _domain_mixture_colors(analyzed, rgb)
    saved = analyzed.node2domain
    try:
        analyzed.node2domain = None  # force the indicator fallback
        via_indicator = _domain_mixture_colors(analyzed, rgb)
    finally:
        analyzed.node2domain = saved
    np.testing.assert_array_equal(via_node2domain, via_indicator)


def test_domain_mixture_stale_node2domain_falls_back(analyzed):
    """After enrichment is recomputed (serial bump) the mixture colors must
    NOT reuse the old node2domain counts — the fallback recomputes from the
    current indicator (reference safe.py:884-904 semantics)."""
    from safepy_tpu.plotting import _domain_colors, _domain_mixture_colors

    domains, rgb = _domain_colors(analyzed, seed=0)
    baseline = _domain_mixture_colors(analyzed, rgb)
    saved_n2d = analyzed.node2domain
    try:
        poisoned = analyzed.node2domain.copy()
        cols = [c for c in poisoned.columns
                if c not in ("primary_domain", "primary_nes")]
        poisoned[cols] = 999.0
        analyzed.node2domain = poisoned
        analyzed._enrichment_serial += 1  # simulate a fresh enrichment run
        stale = _domain_mixture_colors(analyzed, rgb)
    finally:
        analyzed.node2domain = saved_n2d
        analyzed._enrichment_serial -= 1
    np.testing.assert_array_equal(stale, baseline)


def test_select_attributes_top_ids_not_positions(analyzed):
    """Requesting more attributes than exist with top_attributes_only must
    return the top attribute IDS, not positions 0..k-1."""
    from safepy_tpu.plotting import _select_attributes

    tops = analyzed.attributes.index.values[
        analyzed.attributes["top"].values.astype(bool)]
    got = _select_attributes(analyzed, len(tops) + 5, True, seed=0)
    np.testing.assert_array_equal(np.sort(np.asarray(got)), np.sort(tops))


def _write_min_xlsx(path, sheet_name, header, rows):
    """Hand-built ECMA-376 workbook: shared strings for the header, INLINE
    strings and numerics in the body — the cell types pd.read_excel's
    engines and safepy_tpu.io.xlsx must both resolve."""
    import zipfile

    def esc(s):
        return (str(s).replace("&", "&amp;").replace("<", "&lt;")
                .replace(">", "&gt;").replace('"', "&quot;"))

    ns = 'xmlns="http://schemas.openxmlformats.org/spreadsheetml/2006/main"'
    shared = [esc(h) for h in header]
    sheet_rows = ["<row r=\"1\">" + "".join(
        f'<c r="{chr(65 + j)}1" t="s"><v>{j}</v></c>'
        for j in range(len(header))) + "</row>"]
    for i, row in enumerate(rows, start=2):
        cells = []
        for j, v in enumerate(row):
            ref = f"{chr(65 + j)}{i}"
            if v is None:
                continue
            if isinstance(v, str):
                cells.append(f'<c r="{ref}" t="inlineStr"><is><t>{esc(v)}'
                             "</t></is></c>")
            else:
                cells.append(f'<c r="{ref}"><v>{v}</v></c>')
        sheet_rows.append(f'<row r="{i}">' + "".join(cells) + "</row>")

    parts = {
        "[Content_Types].xml":
            '<?xml version="1.0"?><Types xmlns="http://schemas.openxml'
            'formats.org/package/2006/content-types">'
            '<Default Extension="xml" ContentType="application/xml"/>'
            '<Default Extension="rels" ContentType="application/vnd.open'
            'xmlformats-package.relationships+xml"/>'
            '<Override PartName="/xl/workbook.xml" ContentType="application/'
            'vnd.openxmlformats-officedocument.spreadsheetml.sheet.main+xml"/>'
            '<Override PartName="/xl/worksheets/sheet1.xml" ContentType='
            '"application/vnd.openxmlformats-officedocument.spreadsheetml.'
            'worksheet+xml"/>'
            '<Override PartName="/xl/sharedStrings.xml" ContentType='
            '"application/vnd.openxmlformats-officedocument.spreadsheetml.'
            'sharedStrings+xml"/></Types>',
        "_rels/.rels":
            '<?xml version="1.0"?><Relationships xmlns="http://schemas.open'
            'xmlformats.org/package/2006/relationships">'
            '<Relationship Id="rId1" Type="http://schemas.openxmlformats.org/'
            'officeDocument/2006/relationships/officeDocument" '
            'Target="xl/workbook.xml"/></Relationships>',
        "xl/workbook.xml":
            f'<?xml version="1.0"?><workbook {ns} xmlns:r="http://schemas.'
            'openxmlformats.org/officeDocument/2006/relationships"><sheets>'
            f'<sheet name="{esc(sheet_name)}" sheetId="1" r:id="rId1"/>'
            "</sheets></workbook>",
        "xl/_rels/workbook.xml.rels":
            '<?xml version="1.0"?><Relationships xmlns="http://schemas.open'
            'xmlformats.org/package/2006/relationships">'
            '<Relationship Id="rId1" Type="http://schemas.openxmlformats.org/'
            'officeDocument/2006/relationships/worksheet" '
            'Target="worksheets/sheet1.xml"/></Relationships>',
        "xl/sharedStrings.xml":
            f'<?xml version="1.0"?><sst {ns} count="{len(shared)}" '
            f'uniqueCount="{len(shared)}">'
            + "".join(f"<si><t>{s}</t></si>" for s in shared) + "</sst>",
        "xl/worksheets/sheet1.xml":
            f'<?xml version="1.0"?><worksheet {ns}><sheetData>'
            + "".join(sheet_rows) + "</sheetData></worksheet>",
    }
    with zipfile.ZipFile(path, "w") as zf:
        for name, data in parts.items():
            zf.writestr(name, data)


def test_min_xlsx_reader_types(tmp_path):
    """safepy_tpu.io.xlsx resolves shared strings, inline strings, numbers,
    and blank cells with pd.read_excel semantics (reference safe_io.py:549)."""
    from safepy_tpu.io.xlsx import read_xlsx

    path = tmp_path / "t.xlsx"
    _write_min_xlsx(path, "Sheet One", ["name", "score", "note"],
                    [["alpha", 1.5, "x"], ["beta", 3, None],
                     ["gamma & <co>", -2.25, "y"]])
    df = read_xlsx(str(path), sheet_name="Sheet One")
    assert list(df.columns) == ["name", "score", "note"]
    assert df["name"].tolist() == ["alpha", "beta", "gamma & <co>"]
    assert df["score"].tolist() == [1.5, 3, -2.25]
    assert df["note"][0] == "x" and pd.isna(df["note"][1])
    with pytest.raises(ValueError, match="not in workbook"):
        read_xlsx(str(path), sheet_name="nope")


def test_min_xlsx_gap_rows_and_absolute_target(tmp_path):
    """Writers may omit empty <row> elements and use absolute ('/xl/...')
    relationship targets; the reader must emit all-NaN gap rows (row
    alignment) and resolve the rooted target."""
    import zipfile

    from safepy_tpu.io.xlsx import read_xlsx

    path = tmp_path / "gap.xlsx"
    _write_min_xlsx(path, "S", ["a", "b"],
                    [["r2", 1], ["r3", 2], ["r4", 3]])
    # drop row 3 entirely and switch the worksheet relationship target to
    # the absolute form
    with zipfile.ZipFile(path) as zf:
        parts = {n: zf.read(n).decode() for n in zf.namelist()}
    sheet = parts["xl/worksheets/sheet1.xml"]
    import re as _re
    sheet = _re.sub(r'<row r="3">.*?</row>', "", sheet)
    parts["xl/worksheets/sheet1.xml"] = sheet
    parts["xl/_rels/workbook.xml.rels"] = parts[
        "xl/_rels/workbook.xml.rels"].replace(
        'Target="worksheets/sheet1.xml"',
        'Target="/xl/worksheets/sheet1.xml"')
    with zipfile.ZipFile(path, "w") as zf:
        for name, data in parts.items():
            zf.writestr(name, data)

    df = read_xlsx(str(path), sheet_name="S")
    assert df.shape == (3, 2)
    assert df["a"].tolist()[0] == "r2"
    assert pd.isna(df["a"][1]) and pd.isna(df["b"][1])  # the omitted row 3
    assert df["a"][2] == "r4" and df["b"][2] == 3


def test_costanzo_overlay_xlsx_branch(analyzed, tmp_path):
    """The xlsx branch — the format safe-data actually
    ships (reference safe_io.py:549-551) — draws the same contours as the
    tsv fallback, through the engine-free SpreadsheetML reader."""
    from safepy_tpu.plotting import plot_costanzo2016_network_annotations

    half = analyzed.graph.number_of_nodes() // 2
    rows = [("Process One", f"g{i}") for i in range(0, half, 2)]
    rows += [("Process Two", f"g{i}") for i in range(half, 2 * half, 2)]
    header = ["Global Similarity Network Region name", "Gene/Allele"]
    colors = pd.DataFrame({"R": [255, 0, 64], "G": [0, 255, 64],
                           "B": [0, 0, 192]})

    def bundle(dirname, writer):
        other = tmp_path / dirname / "other"
        other.mkdir(parents=True)
        base = other / ("Data File S5_SAFE analysis_Gene cluster identity "
                        "and functional enrichments")
        writer(base)
        colors.to_csv(other / "costanzo_2016_colors.txt", sep="\t",
                      index=False)
        fig, ax = plt.subplots()
        plot_costanzo2016_network_annotations(analyzed.graph, ax,
                                              str(tmp_path / dirname))
        segs = [np.concatenate([p.vertices for p in c.get_paths()])
                if c.get_paths() else np.zeros((0, 2))
                for c in ax.collections]
        plt.close(fig)
        return segs

    xlsx_segs = bundle("via_xlsx", lambda base: _write_min_xlsx(
        str(base) + ".xlsx", "Global net. cluster gene list", header, rows))
    tsv_segs = bundle("via_tsv", lambda base: pd.DataFrame(
        rows, columns=header).to_csv(str(base) + ".tsv", sep="\t",
                                     index=False))
    assert len(xlsx_segs) == len(tsv_segs) == 2
    for got, want in zip(xlsx_segs, tsv_segs):
        np.testing.assert_allclose(got, want)
