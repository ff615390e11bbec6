"""Author + execute the Example_1 / Example_2 notebooks.

The reference ships three example notebooks; two are `.MISSING_LARGE_BLOBS`
in the checkout (only Example_3 survives — /root/reference/examples/). Their
roles are documented in the reference README (README.md:27-51): Example_1 is
the "hello world" quantitative SAFE run on the Costanzo-2016 GI network with
doxorubicin sensitivity, Example_2 the binary GO-annotation workflow. These
notebooks reproduce those narratives self-contained (the safe-data bundle is
not vendored; a synthetic network of the same shape stands in, with the
swap-in lines shown).

Run: PYTHONPATH=. python tools/build_example_notebooks.py
Executes both notebooks (CPU) and writes them with outputs embedded.
"""

import os
import sys

import nbformat as nbf
from nbclient import NotebookClient

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def md(s):
    return nbf.v4.new_markdown_cell(s.strip())


def code(s):
    return nbf.v4.new_code_cell(s.strip())


EX1_CELLS = [
    md("""
# Example 1 — quantitative SAFE analysis of a genetic-interaction network

This is the "hello world" workflow of the reference package
(`Example_1_GI_network_doxorubicin.ipynb` in baryshnikova-lab/safepy): load a
network, map a **quantitative** phenotype (there: doxorubicin sensitivity
scores from a chemogenomic screen) onto local neighborhoods, and test each
neighborhood's aggregate score against a permutation null.

The reference notebook reads the Costanzo-2016 yeast GI similarity network
from the external [safe-data](https://github.com/baryshnikova-lab/safe-data)
checkout, which is not vendored here. This notebook synthesizes a geometric
network of comparable shape so it runs self-contained; to run the real
dataset, swap the network cell for

```python
sf.load_network(network_file="<safe-data>/networks/Costanzo_Science_2016.gpickle")
```

and pass the attribute table path to `load_attributes`.
"""),
    code("""
%matplotlib inline
import numpy as np
import pandas as pd
import networkx as nx
import matplotlib.pyplot as plt

from safepy_tpu import SAFE
from safepy_tpu.io.layout import calculate_edge_lengths
"""),
    md("""
## Build a network

A random geometric graph with node coordinates stands in for the GI
similarity network's spring layout. SAFE only needs: node `label`/`key`
attributes, `x`/`y` coordinates, and edge `length`s (computed below exactly
as the facade would).
"""),
    code("""
n = 1000
rng = np.random.default_rng(0)
coords = rng.uniform(-1, 1, (n, 2))
g = nx.random_geometric_graph(
    n, 0.12, seed=0, pos={i: tuple(coords[i]) for i in range(n)})
for i in range(n):
    g.nodes[i]["label"] = g.nodes[i]["key"] = f"gene{i}"
    g.nodes[i]["x"], g.nodes[i]["y"] = coords[i]
    del g.nodes[i]["pos"]
g = calculate_edge_lengths(g, verbose=False)
print(g)
"""),
    md("""
## A quantitative phenotype

The reference's doxorubicin score is continuous, signed, and spatially
clustered (resistance genes co-locate in the GI network). The synthetic
analog: a Gaussian "sensitive region" plus noise, with a few missing values
(real screens never cover every gene — SAFE masks NaNs, it does not impute).
"""),
    code("""
signal = np.exp(-(np.linalg.norm(coords - [0.5, 0.5], axis=1) ** 2) / 0.05)
values = signal + 0.3 * rng.normal(size=n)
values[rng.random(n) < 0.05] = np.nan
attr = pd.DataFrame({"synthetic sensitivity": values},
                    index=[f"gene{i}" for i in range(n)])
attr.head()
"""),
    md("""
## Run SAFE

Quantitative attributes route to the **permutation null** (the reference's
`neighborhood_enrichment_type = 'randomization'` path): each neighborhood's
summed score is ranked against the same sum under random relabelings of the
attribute across annotated nodes. On the device the permutations run as one batched
device program; `random_seed` makes the null reproducible.
"""),
    code("""
sf = SAFE(verbose=False)
sf.random_seed = 42

sf.load_network(network_file=g, node_key_attribute="key")
sf.define_neighborhoods()
sf.load_attributes(attribute_file=attr)
sf.compute_pvalues(num_permutations=1000)

print(f"enriched neighborhoods: {int((sf.nes_binary > 0).sum())} / {n}")
print(f"max NES: {np.nanmax(sf.nes):.2f}")
"""),
    md("""
## The enrichment landscape

With a single phenotype the domain stage has nothing to cluster (it needs
at least two enriched attributes — Example 2 shows it doing real work
across hundreds of GO terms); the deliverable here is the per-attribute
landscape: neighborhood enrichment score as node color, '+' marks on the
nodes carrying the raw phenotype.
"""),
    code("""
fig = sf.plot_sample_attributes(show_raw_data=True)
fig
"""),
    md("""
## Save the results

TSV reports with the same schema as the reference's `save_*` outputs
(the domain report joins them after a multi-attribute run — see Example 2).
"""),
    code("""
import tempfile, os
outdir = tempfile.mkdtemp()
sf.print_output_files(output_dir=outdir)
sorted(os.listdir(outdir))
"""),
]

EX2_CELLS = [
    md("""
# Example 2 — GO-annotation enrichment (binary attributes)

The reference's second notebook maps **binary** functional annotations (Gene
Ontology terms) onto network neighborhoods. Binary attributes route to the
**hypergeometric test** (the reference's default `enrichment_type`): for
each (neighborhood, term) pair, the tail probability of drawing `k`
annotated genes in a neighborhood of size `s` from a universe of `M` genes
of which `K` carry the term.

Self-contained stand-in for the safe-data inputs: a geometric network plus a
heavy-tailed synthetic GO matrix (most terms annotate a handful of genes —
the real GO-BP median term size is ~10). To run real data, point
`load_attributes` at a GO matrix built by `safepy_tpu.utils.make_go` (the
port of the reference's GO matrix builder).
"""),
    code("""
%matplotlib inline
import numpy as np
import pandas as pd
import networkx as nx
import matplotlib.pyplot as plt

from safepy_tpu import SAFE
from safepy_tpu.io.layout import calculate_edge_lengths
"""),
    code("""
n, n_terms = 1200, 300
rng = np.random.default_rng(7)
coords = rng.uniform(-1, 1, (n, 2))
g = nx.random_geometric_graph(
    n, 0.11, seed=7, pos={i: tuple(coords[i]) for i in range(n)})
for i in range(n):
    g.nodes[i]["label"] = g.nodes[i]["key"] = f"gene{i}"
    g.nodes[i]["x"], g.nodes[i]["y"] = coords[i]
    del g.nodes[i]["pos"]
g = calculate_edge_lengths(g, verbose=False)

# heavy-tailed term sizes; 20 "functional modules" are spatially coherent
sizes = np.exp(rng.uniform(np.log(5), np.log(0.05 * n), n_terms))
vals = (rng.random((n, n_terms)) < (sizes / n)[None, :]).astype(float)
centers = rng.uniform(-0.8, 0.8, (20, 2))
for t in range(20):
    near = np.linalg.norm(coords - centers[t], axis=1) < 0.25
    vals[near, t] = (rng.random(near.sum()) < 0.6).astype(float)
go = pd.DataFrame(vals, index=[f"gene{i}" for i in range(n)],
                  columns=[f"GO:{7000 + j}" for j in range(n_terms)])
go.sum().describe()
"""),
    md("""
## Run SAFE

`compute_pvalues` auto-detects the binary matrix and dispatches the
hypergeometric test: the census matmul runs as a device GEMM and the survival
tail in device f64 log space. (`SAFE._hypergeom_engine_used` records which
engine actually ran — at GO scale the one-shot `run_pipeline` and the
band-store paths ride the class-table engine, one f64 recurrence per
distinct (K, neighborhood-size) class.)
"""),
    code("""
sf = SAFE(verbose=False)
sf.random_seed = 13
sf.load_network(network_file=g, node_key_attribute="key")
sf.define_neighborhoods()
sf.load_attributes(attribute_file=go)
sf.compute_pvalues()
print("engine:", sf._hypergeom_engine_used)
print("terms with any enriched neighborhood:",
      int((sf.attributes["num_neighborhoods_enriched"] > 0).sum()))
"""),
    md("""
## Functional domains

With hundreds of terms the domain stage earns its keep: terms whose
enrichment landscapes overlap are clustered (Jaccard distance over their
enriched-neighborhood sets), and each network region is assigned to the
domain that dominates it — the reference's composite map.
"""),
    code("""
sf.define_top_attributes()
sf.define_domains(attribute_distance_threshold=0.65)
sf.trim_domains()
sf.domains
"""),
    code("""
fig = sf.plot_composite_network(show_each_domain=False)
fig
"""),
    md("""
## Inspect one term

`plot_sample_attributes` draws per-term landscapes; '+' marks nodes carrying
the raw annotation, color the neighborhood enrichment score.
"""),
    code("""
top_term = sf.attributes["num_neighborhoods_enriched"].idxmax()
fig = sf.plot_sample_attributes(
    attributes=[sf.attributes.loc[top_term, "name"]], show_raw_data=True)
fig
"""),
]


def build(path, cells, kernel="python3"):
    nb = nbf.v4.new_notebook()
    nb.cells = cells
    nb.metadata["kernelspec"] = {
        "display_name": "Python 3", "language": "python", "name": kernel}
    client = NotebookClient(nb, timeout=900, kernel_name=kernel,
                            resources={"metadata": {"path": ROOT}})
    client.execute()
    nbf.write(nb, path)
    print(f"wrote {path} ({len(cells)} cells, executed)")


def main():
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    build(os.path.join(ROOT, "examples",
                       "Example_1_GI_network_quantitative.ipynb"), EX1_CELLS)
    build(os.path.join(ROOT, "examples",
                       "Example_2_GO_annotations.ipynb"), EX2_CELLS)


if __name__ == "__main__":
    sys.exit(main())
