"""Frozen numpy copy of the port's corpus and query recipe.

Copied from ``src/repro_torch/data/synth.py`` (``make_dataset``,
``add_or_pair_fields``, ``add_timestamp_field``, ``make_queries``,
``make_or_queries``, ``make_range_queries``) so that a later change to
the program cannot move the benchmark's data. Two departures, both
parameters that leave the copy bit for bit equal to the original at
their defaults:

* ``noise_scale`` multiplies the corpus noise and the query noise. The
  recipe adds noise per dimension, so its norm grows as sqrt(d) and at
  d=2048 the cluster structure drowns; the configurations scale both
  noises by sqrt(64/d).
* predicates are plain tuples (see ``fnsbench.reference.predicates``),
  not the port's predicate objects.

Every generator takes a ``seed`` that ``numpy.random.default_rng``
accepts (an int or a list of ints).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from fnsbench.reference.predicates import conj, mask_np, or_pair, prefix_range


@dataclasses.dataclass
class Corpus:
    """Unit-norm float32 vectors (n, d) and int32 metadata codes (n, F);
    code -1 marks an unpopulated field."""

    vectors: np.ndarray
    metadata: np.ndarray
    field_names: list[str]
    vocab_sizes: list[int]

    @property
    def n(self) -> int:
        return self.vectors.shape[0]

    @property
    def d(self) -> int:
        return self.vectors.shape[1]


def normalize(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, dtype=np.float32)
    nrm = np.linalg.norm(x, axis=-1, keepdims=True)
    return x / np.maximum(nrm, 1e-12)


def _zipf_probs(v: int, a: float = 1.1) -> np.ndarray:
    p = 1.0 / np.arange(1, v + 1) ** a
    return p / p.sum()


def make_dataset(*, n: int, d: int, n_components: int, n_fields: int,
                 noise: float = 0.35, corr: float = 0.85,
                 radial_lognorm: float = 0.6, seed=0,
                 noise_scale: float = 1.0) -> Corpus:
    """Mixture of anisotropic Gaussians on the sphere with Zipfian
    component sizes and a lognormal radial spread; ``n_fields``
    categorical fields of 2..200 Zipfian codes, each equal to its
    component's code with probability ``corr``, 3% unpopulated."""
    rng = np.random.default_rng(seed)
    C = n_components
    centers = normalize(rng.standard_normal((C, d)))
    comp_p = _zipf_probs(C, a=1.05)
    comp = rng.choice(C, size=n, p=comp_p)
    scales = (0.5 + rng.random(C)) * (noise * noise_scale)
    radial = rng.lognormal(mean=-0.5 * radial_lognorm**2,
                           sigma=radial_lognorm, size=n)
    eps = rng.standard_normal((n, d))
    x = centers[comp] + eps * (scales[comp] * radial)[:, None]
    vectors = normalize(x)

    field_names, vocab_sizes = [], []
    metadata = np.empty((n, n_fields), dtype=np.int32)
    for f in range(n_fields):
        v = int(rng.choice([2, 4, 8, 16, 32, 64, 128, 200]))
        field_names.append(f"field_{f}")
        vocab_sizes.append(v)
        comp_to_val = rng.integers(0, v, size=C)
        correlated = comp_to_val[comp]
        random_vals = rng.choice(v, size=n, p=_zipf_probs(v))
        use_corr = rng.random(n) < corr
        col = np.where(use_corr, correlated, random_vals).astype(np.int32)
        col[rng.random(n) < 0.03] = -1
        metadata[:, f] = col
    return Corpus(vectors, metadata, field_names, vocab_sizes)


def add_uniform_fields(ds: Corpus, n_fields: int, codes: int, *,
                       seed) -> Corpus:
    """Append ``n_fields`` fields of ``codes`` codes each, drawn
    uniformly and independently of the geometry (the RAG deployment's
    tenant / source / date-bucket attributes)."""
    rng = np.random.default_rng(seed)
    cols = rng.integers(0, codes, (ds.n, n_fields)).astype(np.int32)
    return Corpus(ds.vectors, np.concatenate([ds.metadata, cols], axis=1),
                  ds.field_names + [f"u{i}" for i in range(n_fields)],
                  ds.vocab_sizes + [codes] * n_fields)


def add_or_pair_fields(ds: Corpus, sels=(0.1, 0.02), *, seed=23) -> Corpus:
    """Two independent fields ``orA``/``orB``: code ``i+1`` selects
    ``sels[i]/2`` of the rows on each, so ``orA == i+1 or orB == i+1``
    selects about ``sels[i]``."""
    rng = np.random.default_rng(seed)
    n = ds.n
    cols = []
    probs = np.asarray(sels, dtype=np.float64) / 2.0
    edges = np.concatenate([np.cumsum(probs), [1.0]])
    for _ in range(2):
        draw = rng.random(n)
        code = np.searchsorted(edges, draw, side="right") + 1
        code[draw >= edges[-2]] = 0
        cols.append(code.astype(np.int32))
    metadata = np.concatenate([ds.metadata, np.stack(cols, axis=1)], axis=1)
    return Corpus(ds.vectors, metadata, ds.field_names + ["orA", "orB"],
                  ds.vocab_sizes + [len(sels) + 1, len(sels) + 1])


TS_DOMAIN = 1 << 20


def add_timestamp_field(ds: Corpus, *, domain: int = TS_DOMAIN,
                        seed=31) -> Corpus:
    """A ``ts`` field of ``n`` distinct codes out of ``domain``, so a
    prefix window selects an exact share and compiles only through the
    port's interval path."""
    rng = np.random.default_rng(seed)
    codes = np.sort(rng.choice(domain, size=ds.n, replace=False))
    col = codes[rng.permutation(ds.n)].astype(np.int32)
    metadata = np.concatenate([ds.metadata, col[:, None]], axis=1)
    return Corpus(ds.vectors, metadata, ds.field_names + ["ts"],
                  ds.vocab_sizes + [domain])


def or_pair_predicate(ds: Corpus, code: int):
    return or_pair(ds.field_names.index("orA"), ds.field_names.index("orB"),
                   code)


def range_predicate(ds: Corpus, sel: float):
    f = ds.field_names.index("ts")
    col = np.sort(ds.metadata[:, f])
    k = max(1, int(round(sel * ds.n)))
    return prefix_range(f, int(col[k - 1]))


def _near_members(ds: Corpus, pred, n_queries: int, rng,
                  query_noise: float) -> list:
    members = np.nonzero(mask_np(pred, ds.metadata))[0]
    if members.size == 0:
        raise ValueError(f"no corpus rows pass {pred}")
    out = []
    for _ in range(n_queries):
        src = members[rng.integers(members.size)]
        qv = normalize(ds.vectors[src]
                       + query_noise * rng.standard_normal(ds.d))
        out.append((qv, pred))
    return out


def make_or_queries(ds: Corpus, code: int, n_queries: int, *, seed=5,
                    noise_scale: float = 1.0) -> list:
    """(vector, predicate) pairs near rows passing the OR pair ``code``."""
    rng = np.random.default_rng(seed + code)
    return _near_members(ds, or_pair_predicate(ds, code), n_queries, rng,
                         0.15 * noise_scale)


def make_range_queries(ds: Corpus, sel: float, n_queries: int, *, seed=11,
                       noise_scale: float = 1.0) -> list:
    """(vector, predicate) pairs near rows inside the ``sel`` window."""
    rng = np.random.default_rng(seed + int(round(sel * 1000)))
    return _near_members(ds, range_predicate(ds, sel), n_queries, rng,
                         0.15 * noise_scale)


def make_queries(ds: Corpus, n_queries: int = 500, max_clauses: int = 3,
                 seed=1, query_noise: float = 0.15,
                 cross_fiber_frac: float = 0.5, n_fields: int | None = None,
                 noise_scale: float = 1.0) -> list:
    """(vector, predicate) pairs: perturbed corpus points with 1 to
    ``max_clauses`` single-code clauses over the first ``n_fields``
    fields, their codes taken from a different random row with
    probability ``cross_fiber_frac``. Predicates that pass no row are
    redrawn."""
    rng = np.random.default_rng(seed)
    nf = ds.metadata.shape[1] if n_fields is None else n_fields
    out: list = []
    while len(out) < n_queries:
        i = int(rng.integers(ds.n))
        q = normalize(ds.vectors[i] + rng.standard_normal(ds.d)
                      * (query_noise * noise_scale))
        src = int(rng.integers(ds.n)) if rng.random() < cross_fiber_frac else i
        n_clauses = int(rng.integers(1, max_clauses + 1))
        fields = rng.choice(nf, size=n_clauses, replace=False)
        clauses = {}
        redrawn = False
        for f in fields:
            v = int(ds.metadata[src, f])
            if v < 0:
                col = ds.metadata[:, f]
                pop = col[col >= 0]
                if pop.size == 0:
                    continue
                v = int(pop[rng.integers(pop.size)])
                redrawn = True
            clauses[int(f)] = [v]
        if not clauses:
            continue
        pred = conj(clauses)
        # row ``src`` passes its own codes, so only a redrawn code can
        # leave the predicate with no passing row
        if redrawn and not mask_np(pred, ds.metadata).any():
            continue
        out.append((q, pred))
    return out
