"""End-to-end serving example on the PyTorch port (the paper's kind:
filtered retrieval serving), as ``examples/rag_serve.py``.

A SmolLM-135M-family encoder embeds documents and batched queries on
``--device`` (CUDA unless told otherwise; no CUDA raises); the
fiber-navigable index answers metadata-filtered nearest-neighbour
requests, the batched ones through the hand-written kernels on the card.

    PYTHONPATH=src python examples/torch_rag_serve.py [--full]
    PYTHONPATH=src python examples/torch_rag_serve.py --device cpu

--full uses the real smollm-135m config (slow on CPU); default is the
reduced same-family config so the example runs in seconds. Weights are
random (``init_params`` with seed 0).
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.core.search import SearchParams
from repro_torch.core.types import Dataset, FilterPredicate
from repro_torch.data.ground_truth import filtered_topk, recall_at_k
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models.transformer import (ShardEnv, encode, init_params,
                                            place_params)
from repro_torch.serve.retrieval import EncodedRetriever, RetrievalService

DOC_LEN = 32        # tokens a document and a query
ENCODE_BATCH = 256  # documents an encode call
CODES = 8           # codes of each metadata field


def inputs(cfg, n_docs: int, n_queries: int, n_fields: int = 6):
    """Document tokens, metadata, query tokens and the predicate, drawn
    from ``np.random.default_rng(0)`` in the reference's order."""
    rng = np.random.default_rng(0)
    doc_tokens = rng.integers(0, cfg.vocab_size,
                              (n_docs, DOC_LEN)).astype(np.int32)
    meta = rng.integers(0, CODES, (n_docs, n_fields)).astype(np.int32)
    q_tokens = rng.integers(0, cfg.vocab_size,
                            (n_queries, DOC_LEN)).astype(np.int32)
    return doc_tokens, q_tokens, meta, FilterPredicate.make(
        {0: [2, 3], 3: [1, 4, 5]})


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run(cfg, params, doc_tokens, q_tokens, meta, pred, device) -> dict:
    """Encode ``doc_tokens`` with ``params`` on ``device``, index them
    with ``meta`` and serve ``q_tokens`` under ``pred``: sequentially
    (``retrieve``, host search) and batched (``retrieve_batch``, one
    warm-up call, then the timed one). Prints the reference's lines and
    returns what they report, with the vectors, dataset, service and
    retriever, the query embeddings and both answers."""
    n_docs, n_queries = doc_tokens.shape[0], q_tokens.shape[0]
    env = ShardEnv(make_local_mesh(devices=[device]))
    params = place_params(params, env)

    # --- offline: embed the document corpus, attach metadata, build the
    # index ------------------------------------------------------------------
    t0 = time.time()
    vecs = [encode(params, {"tokens": doc_tokens[s:s + ENCODE_BATCH]}, cfg,
                   env).cpu().numpy()
            for s in range(0, n_docs, ENCODE_BATCH)]
    vectors = np.concatenate(vecs)
    ds = Dataset(vectors, meta, [f"f{i}" for i in range(meta.shape[1])],
                 [CODES] * meta.shape[1])
    service = RetrievalService.build(ds, graph_k=24, r_max=64,
                                     params=SearchParams(k=10),
                                     device=device)
    index_s = time.time() - t0
    print(f"indexed {n_docs} model-encoded docs in {index_s:.1f}s")

    # --- online: filtered retrieval, one query at a time ------------------
    retr = EncodedRetriever(cfg, env, params, service)
    passes = pred.mask(meta)
    sel = passes.mean()
    t0 = time.time()
    out = retr.retrieve(q_tokens, pred)
    dt = time.time() - t0
    qvecs = retr.embed_tokens(q_tokens)
    recs = []
    for (ids, sims, stats), qv in zip(out, qvecs):
        gt, _ = filtered_topk(vectors, qv, passes, 10)
        recs.append(recall_at_k(np.asarray(ids), gt))
    print(f"served {n_queries} filtered queries (selectivity {sel:.1%}) "
          f"in {dt*1000:.0f} ms ({dt*1000/n_queries:.1f} ms/q incl. encode)")
    print(f"recall@10 vs exact filtered search: {np.mean(recs):.3f}")

    # --- online, batched: all queries share each restart round -------------
    preds = [pred] * n_queries
    retr.retrieve_batch(q_tokens, preds)  # warm-up (allocator, cuBLAS)
    _sync(device)
    t0 = time.time()
    ids_b, stats = retr.retrieve_batch(q_tokens, preds)
    dt_b = time.time() - t0
    recs_b = [recall_at_k(np.asarray(ids), filtered_topk(
        vectors, qv, passes, 10)[0]) for ids, qv in zip(ids_b, qvecs)]
    print(f"batched (device-resident atlas): {dt_b*1000:.0f} ms "
          f"({dt_b*1000/n_queries:.1f} ms/q incl. encode), "
          f"recall@10 {np.mean(recs_b):.3f}, "
          f"mean restarts {stats['walks'].mean():.2f}")
    return {"vectors": vectors, "dataset": ds, "service": service,
            "retriever": retr, "predicate": pred, "query_vectors": qvecs,
            "sequential": out, "ids": ids_b, "stats": stats,
            "index_s": index_s,
            "recall": float(np.mean(recs)),
            "recall_batch": float(np.mean(recs_b)),
            "ms_per_query": dt * 1000 / n_queries,
            "ms_per_query_batch": dt_b * 1000 / n_queries,
            "mean_restarts": float(stats["walks"].mean())}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--docs", type=int, default=2048)
    ap.add_argument("--queries", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = (get_config("smollm-135m") if args.full
           else reduced_config("smollm-135m"))
    params = init_params(cfg, 0, args.device)
    doc_tokens, q_tokens, meta, pred = inputs(cfg, args.docs, args.queries)
    return run(cfg, params, doc_tokens, q_tokens, meta, pred, args.device)


if __name__ == "__main__":
    main()
