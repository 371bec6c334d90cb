"""Paper §8 miniature on the PyTorch port: classify every walk stall into
the three regimes and show the selectivity shift (Tables 4-6 shapes; host
numpy, as ``examples/stall_analysis.py``).

    PYTHONPATH=src python examples/torch_stall_analysis.py
"""
import argparse

from repro_torch.core.atlas import AnchorAtlas
from repro_torch.core.graph import build_alpha_knn
from repro_torch.core.search import FiberIndex, SearchParams, search
from repro_torch.core.stall import aggregate_stalls, regimes_by_selectivity
from repro_torch.data.ground_truth import attach_ground_truth, recall_at_k
from repro_torch.data.synth import SynthSpec, make_dataset, make_queries


def run(spec: SynthSpec, n_queries: int = 150) -> dict:
    """Guided search (B=4, 500 hops) on ``n_queries`` filtered queries
    over ``spec``'s corpus; prints the regime mix by selectivity bin and
    the stall diagnostics by regime, and returns the latter."""
    ds = make_dataset(spec)
    qs = make_queries(ds, n_queries=n_queries, seed=1)
    attach_ground_truth(ds, qs, k=10)
    index = FiberIndex(ds.vectors, ds.metadata,
                       build_alpha_knn(ds.vectors, k=32, r_max=96),
                       AnchorAtlas.build(ds))
    params = SearchParams(k=10, walk="guided", beam_width=4, max_hops=500)
    stats, recalls, sels = [], [], []
    for qi, q in enumerate(qs):
        ids, _, st = search(index, q.vector, q.predicate, params, seed=qi)
        stats.append(st)
        recalls.append(recall_at_k(ids, q.gt_ids))
        sels.append(q.selectivity)

    print("regime mix by selectivity bin (cut / fold / basin):")
    for row in regimes_by_selectivity(stats, sels, recalls):
        print(f"  {row['bin']:>8s} n={row['n']:3d} "
              f"recall={row['recall']:.3f} "
              f"{row['topological_cut']:5.1%} {row['geometric_fold']:5.1%} "
              f"{row['genuine_basin']:5.1%}")
    print("\nstall diagnostics by regime:")
    by_regime = aggregate_stalls(stats, sels, recalls)
    for reg, r in by_regime.items():
        print(f"  {reg:16s} count={r['count']:4d} rho={r['rho']:.4f} "
              f"|B-|={r['b_minus']:5.1f} drift={r['drift']:+.4f} "
              f"V(x*)={r['potential']:.4f}")
    return by_regime


def main(argv=None) -> dict:
    argparse.ArgumentParser(description=__doc__.split("\n\n")[0]).parse_args(
        argv)
    return run(SynthSpec(n=8000, d=128, n_fields=24, seed=0))


if __name__ == "__main__":
    main()
