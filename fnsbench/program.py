"""The system under test, and the only module of the benchmark that imports
it: ``repro_torch``'s ``RetrievalService`` built over the benchmark's
corpus and served through ``ServePipeline``. The benchmark's plain
predicates become the port's predicate objects here, on the port's side
only. Imports happen inside the functions, so the reference and the CPU
tests can load the harness without the port.
"""
from __future__ import annotations

import time

# the kernels of the timed path, by the names the port gives them
K1_KERNELS = ("filter_eval_batch_kernel",)
K3_KERNELS = ("topk_partial_kernel", "topk_merge_kernel")
WR_KERNELS = ("walk_round_kernel",)


def port_predicate(pred: tuple):
    """The port's predicate object for a plain predicate: a conjunction
    of ``In`` clauses as ``FilterPredicate``, anything else as a
    ``FilterExpr`` tree."""
    from repro_torch.core.predicate import And, In, Or, Range
    from repro_torch.core.types import FilterPredicate
    if len(pred) == 1 and all(c[0] == "in" for c in pred[0]):
        return FilterPredicate.make({c[1]: c[2] for c in pred[0]})

    def leaf(c):
        return In(c[1], c[2]) if c[0] == "in" else Range(c[1], c[2], c[3])

    terms = [leaf(d[0]) if len(d) == 1 else And(*map(leaf, d)) for d in pred]
    return terms[0] if len(terms) == 1 else Or(*terms)


def build_service(corpus, knobs: dict, device, stages: dict):
    """``RetrievalService.build`` over ``corpus`` with the ``FnsConfig``
    knobs given (dotted paths; the rest at their defaults), its engine
    placed on ``device``. ``stages`` receives the seconds of the graph
    build, the atlas build and the placement."""
    import torch
    from repro_torch.core.config import FnsConfig
    from repro_torch.core.search import SearchParams
    from repro_torch.core.types import Dataset
    from repro_torch.serve import retrieval

    def timed(fn, key):
        def run(*a, **kw):
            t = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                stages[key] = stages.get(key, 0.0) + time.perf_counter() - t
        return run

    cfg = FnsConfig().with_knobs(knobs)
    ds = Dataset(corpus.vectors, corpus.metadata, list(corpus.field_names),
                 list(corpus.vocab_sizes))
    atlas = retrieval.AnchorAtlas
    build_knn, atlas_build = retrieval.build_alpha_knn, atlas.__dict__["build"]
    retrieval.build_alpha_knn = timed(build_knn, "graph_s")
    atlas.build = timed(atlas.build, "atlas_s")
    try:
        svc = retrieval.RetrievalService.build(
            ds, config=cfg, params=SearchParams(k=cfg.walk.k), device=device)
    finally:
        retrieval.build_alpha_knn = build_knn
        atlas.build = atlas_build
    t = time.perf_counter()
    svc.engine()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    stages["place_s"] = time.perf_counter() - t
    return svc


def pipeline(svc, clock):
    from repro_torch.serve.pipeline import ServePipeline
    return ServePipeline(svc, clock=clock)
