"""Quickstart on the PyTorch port: build a fiber-navigable index and run
filtered queries (host numpy, as ``examples/quickstart.py``).

    PYTHONPATH=src python examples/torch_quickstart.py
"""
import argparse

import numpy as np

from repro_torch.core.atlas import AnchorAtlas
from repro_torch.core.graph import build_alpha_knn
from repro_torch.core.search import FiberIndex, SearchParams, search
from repro_torch.data.ground_truth import attach_ground_truth, recall_at_k
from repro_torch.data.synth import SynthSpec, make_dataset, make_queries


def run(spec: SynthSpec, n_queries: int = 20) -> list[float]:
    """Build the index over ``spec``'s corpus, search ``n_queries``
    filtered queries and print what ``examples/quickstart.py`` prints;
    returns each query's recall@10."""
    # 1. corpus: unit vectors + categorical metadata (H&M-like structure)
    ds = make_dataset(spec)
    print(f"corpus: {ds.n} vectors x {ds.d}d, {ds.n_fields} metadata fields")

    # 2. index = alpha-kNN proximity graph (Alg 1) + anchor atlas (4.2)
    graph = build_alpha_knn(ds.vectors, k=32, r_max=96, alpha=1.2)
    atlas = AnchorAtlas.build(ds)
    index = FiberIndex(ds.vectors, ds.metadata, graph, atlas)
    print(f"graph: {graph.n_edges} edges, mean degree "
          f"{graph.degrees.mean():.1f}; atlas: {atlas.n_clusters} clusters")

    # 3. filtered queries with exact ground truth
    queries = make_queries(ds, n_queries=n_queries, seed=1)
    attach_ground_truth(ds, queries, k=10)

    # 4. drift-guided two-phase search (Alg 4) with anchor restarts (Alg 2)
    params = SearchParams(k=10, walk="guided", beam_width=2)
    recalls = []
    for qi, q in enumerate(queries):
        ids, sims, stats = search(index, q.vector, q.predicate, params,
                                  seed=qi)
        r = recall_at_k(ids, q.gt_ids)
        recalls.append(r)
        if qi < 5:
            print(f"q{qi}: selectivity={q.selectivity:6.2%} "
                  f"walks={stats.n_walks} hops={stats.hops:3d} "
                  f"recall@10={r:.2f} top sims {np.round(sims[:3], 3)}")
    print(f"\nmean recall@10 = {np.mean(recalls):.3f} "
          f"(zero-recall: {np.mean([r == 0 for r in recalls]):.1%})")
    return recalls


def main(argv=None) -> list[float]:
    argparse.ArgumentParser(description=__doc__.split("\n\n")[0]).parse_args(
        argv)
    return run(SynthSpec(n=8000, d=128, n_fields=24, seed=0))


if __name__ == "__main__":
    main()
