"""Structure-matched synthetic corpus generator.

The paper evaluates on H&M product embeddings (105,100 x 2048, 24 categorical
fields). Offline we reproduce the *structural* properties that drive the
fiber phenomenon (DESIGN.md §1):

* unit vectors from a mixture of anisotropic Gaussians on the sphere
  ("product groups" = geometric clusters);
* categorical metadata correlated with mixture component, so fibers are
  geometrically localized and a selective filter's nearest points can be far
  from the unfiltered nearest points;
* Zipfian value frequencies, giving filter selectivities from <0.1% to >20%.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.predicate import In, Or, Range
from repro_torch.core.types import Dataset, FilterPredicate, Query, normalize


@dataclasses.dataclass(frozen=True)
class SynthSpec:
    n: int = 20_000
    d: int = 256
    n_components: int = 64        # geometric mixture components
    n_fields: int = 24
    noise: float = 0.35           # within-component spread (relative)
    corr: float = 0.85            # P(field value determined by component)
    radial_lognorm: float = 0.6   # per-point radial spread (density gradient:
    # real embedding clusters have cores+peripheries; this is what makes
    # drift<0 fiber-descent valleys exist at all — see DESIGN.md §1)
    seed: int = 0


def _zipf_probs(v: int, a: float = 1.1) -> np.ndarray:
    p = 1.0 / np.arange(1, v + 1) ** a
    return p / p.sum()


def make_dataset(spec: SynthSpec = SynthSpec()) -> Dataset:
    rng = np.random.default_rng(spec.seed)
    C = spec.n_components
    centers = normalize(rng.standard_normal((C, spec.d)))
    # Zipfian component sizes: a few big product groups, many small ones.
    comp_p = _zipf_probs(C, a=1.05)
    comp = rng.choice(C, size=spec.n, p=comp_p)
    # anisotropic noise: per-component random scale in [0.5, 1.5] * spec.noise
    scales = (0.5 + rng.random(C)) * spec.noise
    # per-point radial factor: lognormal gives cluster cores + peripheries
    radial = rng.lognormal(mean=-0.5 * spec.radial_lognorm**2,
                           sigma=spec.radial_lognorm, size=spec.n)
    eps = rng.standard_normal((spec.n, spec.d))
    x = centers[comp] + eps * (scales[comp] * radial)[:, None]
    vectors = normalize(x)

    field_names, vocab_sizes = [], []
    metadata = np.empty((spec.n, spec.n_fields), dtype=np.int32)
    for f in range(spec.n_fields):
        # vocab sizes vary like real product metadata (2 .. 200 values)
        v = int(rng.choice([2, 4, 8, 16, 32, 64, 128, 200]))
        field_names.append(f"field_{f}")
        vocab_sizes.append(v)
        # component -> canonical value map (many-to-one when v < C)
        comp_to_val = rng.integers(0, v, size=C)
        correlated = comp_to_val[comp]
        random_vals = rng.choice(v, size=spec.n, p=_zipf_probs(v))
        use_corr = rng.random(spec.n) < spec.corr
        col = np.where(use_corr, correlated, random_vals).astype(np.int32)
        # sparse metadata: ~3% of entries unpopulated (-1), as in real corpora
        col[rng.random(spec.n) < 0.03] = -1
        metadata[:, f] = col
    return Dataset(vectors, metadata, field_names, vocab_sizes)


def make_selectivity_dataset(selectivities=(0.5, 0.1, 0.02), *,
                             n: int = 2400, d: int = 48,
                             n_components: int = 16,
                             seed: int = 7) -> Dataset:
    """Corpus with *engineered* filter selectivities: field 0's code
    marginals are pinned to ``selectivities`` (code i selects fraction
    selectivities[i] of the corpus) and field 1 is component-correlated so
    the anchor atlas has structure to index. Shared by the tier-1
    selectivity-sweep fixture and the end-to-end search benchmark so the
    parity tests validate the same distribution the benchmark measures."""
    rng = np.random.default_rng(seed)
    centers = normalize(rng.standard_normal((n_components, d)))
    comp = rng.integers(0, n_components, n)
    vectors = normalize(centers[comp] + 0.3 * rng.standard_normal((n, d)))
    meta = np.empty((n, 2), np.int32)
    meta[:, 0] = np.searchsorted(np.cumsum(selectivities), rng.random(n))
    meta[:, 1] = (comp % 5).astype(np.int32)
    return Dataset(vectors, meta, ["sel", "grp"],
                   [len(selectivities) + 1, 5])


def make_selectivity_queries(ds: Dataset, sel_code: int, n_queries: int, *,
                             seed: int = 1) -> list[Query]:
    """Queries near corpus points that pass ``field 0 == sel_code`` (so
    recall is attainable), for a ``make_selectivity_dataset`` corpus."""
    rng = np.random.default_rng(seed + sel_code)
    pred = FilterPredicate.make({0: [sel_code]})
    members = np.nonzero(ds.metadata[:, 0] == sel_code)[0]
    sel = float(pred.mask(ds.metadata).mean())
    out = []
    for _ in range(n_queries):
        src = members[rng.integers(members.size)]
        qv = normalize(ds.vectors[src] + 0.15 * rng.standard_normal(ds.d))
        out.append(Query(vector=qv, predicate=pred, selectivity=sel))
    return out


def add_or_pair_fields(ds: Dataset, sels=(0.1, 0.02), *,
                       seed: int = 23) -> Dataset:
    """Append two independent fields ``orA``/``orB`` with engineered
    marginals: code ``i+1`` selects fraction ``sels[i]/2`` on each field,
    so the two-field disjunction ``Or(In(orA, [i+1]), In(orB, [i+1]))``
    has selectivity ≈ ``sels[i]`` (minus the tiny independent overlap).
    The base dataset's fields are untouched, so conjunctive fixtures and
    benchmark rows keep their distribution."""
    rng = np.random.default_rng(seed)
    n = ds.n
    cols = []
    probs = np.asarray(sels, dtype=np.float64) / 2.0
    edges = np.concatenate([np.cumsum(probs), [1.0]])
    for _ in range(2):
        draw = rng.random(n)
        code = np.searchsorted(edges, draw, side="right") + 1
        code[draw >= edges[-2]] = 0          # bulk: code 0 (matches nothing)
        cols.append(code.astype(np.int32))
    metadata = np.concatenate([ds.metadata, np.stack(cols, axis=1)], axis=1)
    return Dataset(ds.vectors, metadata,
                   ds.field_names + ["orA", "orB"],
                   ds.vocab_sizes + [len(sels) + 1, len(sels) + 1])


def or_pair_predicate(ds: Dataset, code: int) -> Or:
    """The two-field disjunction over an ``add_or_pair_fields`` dataset."""
    fa, fb = ds.field_names.index("orA"), ds.field_names.index("orB")
    return Or(In(fa, [code]), In(fb, [code]))


def make_or_queries(ds: Dataset, code: int, n_queries: int, *,
                    seed: int = 5) -> list[Query]:
    """Queries near corpus points passing the or-pair disjunction for
    ``code`` (so recall is attainable), mirroring
    ``make_selectivity_queries`` for the disjunctive benchmark rows."""
    rng = np.random.default_rng(seed + code)
    pred = or_pair_predicate(ds, code)
    passes = pred.mask(ds.metadata, ds.vocab_sizes)
    members = np.nonzero(passes)[0]
    if members.size == 0:
        raise ValueError(f"no corpus rows match or-pair code {code}")
    sel = float(passes.mean())
    out = []
    for _ in range(n_queries):
        src = members[rng.integers(members.size)]
        qv = normalize(ds.vectors[src] + 0.15 * rng.standard_normal(ds.d))
        out.append(Query(vector=qv, predicate=pred, selectivity=sel))
    return out


# large enough that value-set lowering of a window over it would be
# hopeless (2^20 codes) — range workloads MUST take the interval path
TS_DOMAIN = 1 << 20


def add_timestamp_field(ds: Dataset, *, domain: int = TS_DOMAIN,
                        seed: int = 31) -> Dataset:
    """Append a large-vocab ``ts`` field: n distinct codes drawn uniformly
    from ``[0, domain)`` and dealt out by a random permutation. Because the
    codes are distinct, a prefix window ``Range(ts, 0, hi)`` has an exactly
    controllable selectivity (pick ``hi`` as the k-th smallest code), and
    because ``domain`` is ~10^6 the predicate only compiles through the
    symbolic interval path — a value-set expansion would need the whole
    window enumerated. The base dataset's fields are untouched."""
    rng = np.random.default_rng(seed)
    codes = np.sort(rng.choice(domain, size=ds.n, replace=False))
    col = codes[rng.permutation(ds.n)].astype(np.int32)
    metadata = np.concatenate([ds.metadata, col[:, None]], axis=1)
    return Dataset(ds.vectors, metadata, ds.field_names + ["ts"],
                   ds.vocab_sizes + [domain])


def add_window_indicator_fields(ds: Dataset, sels, *,
                                prefix: str = "win") -> Dataset:
    """Append one binary field per selectivity marking EXACTLY the rows
    inside ``range_predicate(ds, sel)``'s window. ``In(win<sel>, [1])``
    through the legacy value-set path is then the matched categorical
    baseline for the interval row — same mask, same attainable recall —
    which is what the ``range_sel*`` benchmark rows compare against."""
    cols, names, vocabs = [], [], []
    for sel in sels:
        pred = range_predicate(ds, sel)
        cols.append(pred.mask(ds.metadata, ds.vocab_sizes)
                    .astype(np.int32))
        names.append(f"{prefix}{sel}")
        vocabs.append(2)
    metadata = np.concatenate([ds.metadata, np.stack(cols, axis=1)], axis=1)
    return Dataset(ds.vectors, metadata, ds.field_names + names,
                   ds.vocab_sizes + vocabs)


def range_predicate(ds: Dataset, sel: float) -> Range:
    """A prefix window over an ``add_timestamp_field`` dataset's ``ts``
    field selecting (as close as n allows) fraction ``sel`` of the rows."""
    f = ds.field_names.index("ts")
    col = np.sort(ds.metadata[:, f])
    k = max(1, int(round(sel * ds.n)))
    return Range(f, 0, int(col[k - 1]))


def make_range_queries(ds: Dataset, sel: float, n_queries: int, *,
                       seed: int = 11) -> list[Query]:
    """Queries near corpus points inside the ``sel`` timestamp window (so
    recall is attainable), mirroring ``make_or_queries`` for the range
    benchmark rows."""
    rng = np.random.default_rng(seed + int(round(sel * 1000)))
    pred = range_predicate(ds, sel)
    passes = pred.mask(ds.metadata, ds.vocab_sizes)
    members = np.nonzero(passes)[0]
    if members.size == 0:
        raise ValueError(f"no corpus rows inside the sel={sel} window")
    real_sel = float(passes.mean())
    out = []
    for _ in range(n_queries):
        src = members[rng.integers(members.size)]
        qv = normalize(ds.vectors[src] + 0.15 * rng.standard_normal(ds.d))
        out.append(Query(vector=qv, predicate=pred, selectivity=real_sel))
    return out


def make_queries(
    ds: Dataset,
    n_queries: int = 500,
    max_clauses: int = 3,
    seed: int = 1,
    query_noise: float = 0.15,
    cross_fiber_frac: float = 0.5,
) -> list[Query]:
    """Queries = perturbed corpus points; filters sampled to span selectivity.

    With probability ``cross_fiber_frac`` the filter values are taken from a
    *different* random point's metadata — the hard case where the filtered
    neighbours are geometrically distant from the unfiltered ones (paper §7
    "why HNSW fails").
    """
    rng = np.random.default_rng(seed)
    out: list[Query] = []
    while len(out) < n_queries:
        i = int(rng.integers(ds.n))
        q = normalize(ds.vectors[i] + rng.standard_normal(ds.d) * query_noise)
        src = int(rng.integers(ds.n)) if rng.random() < cross_fiber_frac else i
        n_clauses = int(rng.integers(1, max_clauses + 1))
        fields = rng.choice(ds.n_fields, size=n_clauses, replace=False)
        clauses = {}
        for f in fields:
            v = int(ds.metadata[src, f])
            if v < 0:  # unpopulated — pick any populated value
                col = ds.metadata[:, f]
                pop = col[col >= 0]
                if pop.size == 0:
                    continue
                v = int(pop[rng.integers(pop.size)])
            clauses[int(f)] = [v]
        if not clauses:
            continue
        pred = FilterPredicate.make(clauses)
        sel = float(pred.mask(ds.metadata).mean())
        if sel <= 0.0:
            continue  # empty fiber: no ground truth exists
        out.append(Query(vector=q, predicate=pred, selectivity=sel))
    return out
