"""Method comparison on one corpus with the PyTorch port: HNSW
post/traversal filtering vs fiber-navigable beam / guided search (paper
Table 2, miniature; host numpy, as ``examples/filtered_search.py``).

    PYTHONPATH=src python examples/torch_filtered_search.py
"""
import argparse
import time

import numpy as np

from repro_torch.core.atlas import AnchorAtlas
from repro_torch.core.graph import build_alpha_knn
from repro_torch.core.hnsw import HNSW
from repro_torch.core.predicate import In, Not, Or
from repro_torch.core.search import FiberIndex, SearchParams, search
from repro_torch.data.ground_truth import attach_ground_truth, recall_at_k
from repro_torch.data.synth import SynthSpec, make_dataset, make_queries

K = 10


def run(spec: SynthSpec, n_queries: int = 50) -> dict:
    """The five methods on ``n_queries`` filtered queries over ``spec``'s
    corpus, then one Or/Not expression; prints what
    ``examples/filtered_search.py`` prints and returns each method's mean
    recall@10."""
    ds = make_dataset(spec)
    queries = make_queries(ds, n_queries=n_queries, seed=1)
    attach_ground_truth(ds, queries, k=K)
    graph = build_alpha_knn(ds.vectors, k=32, r_max=96, alpha=1.2)
    atlas = AnchorAtlas.build(ds)
    index = FiberIndex(ds.vectors, ds.metadata, graph, atlas)
    print("building HNSW baseline...")
    hnsw = HNSW.build(ds.vectors, m=24, ef_construction=80)
    hnsw_index = FiberIndex(ds.vectors, ds.metadata, hnsw.base_graph(), atlas)

    methods = {
        "hnsw post-filter": lambda qi, q: hnsw.search_post_filter(
            q.vector, q.predicate, ds.metadata, K),
        "hnsw traversal-filter": lambda qi, q: hnsw.search_traversal_filter(
            q.vector, q.predicate, ds.metadata, K),
        "guided on hnsw-base B=2": lambda qi, q: search(
            hnsw_index, q.vector, q.predicate,
            SearchParams(k=K, walk="guided", beam_width=2), seed=qi)[0],
        "beam on alpha-kNN B=40": lambda qi, q: search(
            index, q.vector, q.predicate,
            SearchParams(k=K, walk="beam", beam_width=40), seed=qi)[0],
        "guided on alpha-kNN B=2": lambda qi, q: search(
            index, q.vector, q.predicate,
            SearchParams(k=K, walk="guided", beam_width=2), seed=qi)[0],
    }
    print(f"\n{'method':26s} {'recall':>7s} {'zero':>6s} {'ms/q':>7s}")
    recall = {}
    for name, fn in methods.items():
        t0 = time.time()
        recs = [recall_at_k(np.asarray(fn(qi, q)), q.gt_ids)
                for qi, q in enumerate(queries)]
        ms = (time.time() - t0) / len(queries) * 1000
        recall[name] = float(np.mean(recs))
        print(f"{name:26s} {np.mean(recs):7.3f} "
              f"{np.mean([r == 0 for r in recs]):6.1%} {ms:7.2f}")

    # -- composable filter expressions (DESIGN.md §8) -----------------------
    # Any Or/Not/Range composition compiles to bounded-DNF clause tables
    # and runs through the same engines; the sequential path unions the
    # atlas candidates per disjunct.
    expr = Or(In(0, [int(ds.metadata[0, 0])]),
              In(1, [int(ds.metadata[1, 1])])) & Not(In(2, [0]))
    sel = expr.mask(ds.metadata, ds.vocab_sizes).mean()
    ids, sims, stats = search(index, queries[0].vector, expr,
                              SearchParams(k=K, walk="guided", beam_width=2))
    print(f"\nOr/Not expression (selectivity {sel:.1%}): "
          f"{len(ids)} results, {stats.n_walks} walks, {stats.hops} hops")
    return recall


def main(argv=None) -> dict:
    argparse.ArgumentParser(description=__doc__.split("\n\n")[0]).parse_args(
        argv)
    return run(SynthSpec(n=6000, d=128, n_fields=24, seed=0))


if __name__ == "__main__":
    main()
