"""The general generator: a corpus from a configuration's recipe and a
query pool from a mix file. The corpus comes from the recipe's own
``seed``: a deployment serves one catalogue, and a corpus drawn anew
each run changed recall by by up to 10% between seeds (PERF.md). The pool
comes from the run's ``--seed``. Both are drawn through named streams
(``stream``), so a seed gives the same data whatever else changes.

A mix (``fnsbench/mixes/<name>.json``) lists components, each with a
``kind``, a ``share`` of the pool and that kind's parameters:

* ``conj``: ``make_queries`` over the first ``n_fields`` fields;
* ``or_pair``: ``make_or_queries`` at each of ``codes``, equally;
* ``range``: ``make_range_queries`` at each of ``sels``, equally;
* ``codes``: a query near a random row, with one clause per entry of a
  width class over the fields whose names start with ``prefix``, each
  clause ``width`` distinct codes drawn uniformly; the classes of
  ``widths`` equally.
"""
from __future__ import annotations

import dataclasses
import zlib

import numpy as np

from fnsbench.data import recipe
from fnsbench.reference.predicates import conj


def stream(seed: int, name: str) -> np.random.Generator:
    """The generator of stream ``name`` of run seed ``seed``."""
    return np.random.default_rng(stream_seed(seed, name))


def stream_seed(seed: int, name: str) -> int:
    """A 63-bit integer seed for stream ``name`` of run seed ``seed``."""
    ss = np.random.SeedSequence([int(seed) & (2**64 - 1),
                                 zlib.crc32(name.encode())])
    return int(ss.generate_state(2, np.uint64)[0] >> np.uint64(1))


def make_corpus(rc: dict) -> recipe.Corpus:
    """The corpus a configuration's ``recipe`` block describes."""
    seed = rc["seed"]
    ds = recipe.make_dataset(
        n=rc["n"], d=rc["d"], n_components=rc["n_components"],
        n_fields=rc["correlated_fields"], noise=rc["noise"],
        corr=rc["corr"], radial_lognorm=rc["radial_lognorm"],
        seed=stream_seed(seed, "dataset"), noise_scale=rc["noise_scale"])
    if "uniform_fields" in rc:
        u = rc["uniform_fields"]
        ds = recipe.add_uniform_fields(ds, u["count"], u["codes"],
                                       seed=stream_seed(seed, "uniform"))
    if "or_pair_sels" in rc:
        ds = recipe.add_or_pair_fields(ds, tuple(rc["or_pair_sels"]),
                                       seed=stream_seed(seed, "or_pair"))
    if "timestamp_domain" in rc:
        ds = recipe.add_timestamp_field(ds, domain=rc["timestamp_domain"],
                                        seed=stream_seed(seed, "ts"))
    return ds


@dataclasses.dataclass
class Pool:
    """Distinct queries: unit float32 vectors (P, d) and a predicate each."""

    vectors: np.ndarray
    preds: list

    def __len__(self) -> int:
        return len(self.preds)


def _split(total: int, shares: list[float]) -> list[int]:
    """``total`` items over ``shares``, largest remainders first."""
    w = np.asarray(shares, dtype=np.float64)
    raw = w / w.sum() * total
    out = np.floor(raw).astype(int)
    for i in np.argsort(-(raw - out), kind="stable")[:total - out.sum()]:
        out[i] += 1
    return out.tolist()


def _codes_queries(ds, comp, count, seed, noise_scale) -> list:
    rng = np.random.default_rng(seed)
    fields = [i for i, name in enumerate(ds.field_names)
              if name.startswith(comp["prefix"])]
    widths = comp["widths"]
    qn = comp.get("query_noise", 0.15) * noise_scale
    out = []
    for j in range(count):
        i = int(rng.integers(ds.n))
        q = recipe.normalize(ds.vectors[i] + qn * rng.standard_normal(ds.d))
        order = rng.permutation(len(fields))
        w = widths[j * len(widths) // count]
        out.append((q, conj({fields[o]: rng.choice(
            ds.vocab_sizes[fields[o]], c, replace=False).tolist()
            for o, c in zip(order, w)})))
    return out


def _component(ds, comp, count, seed, noise_scale) -> list:
    kind = comp["kind"]
    if kind == "conj":
        return recipe.make_queries(
            ds, n_queries=count, max_clauses=comp["max_clauses"], seed=seed,
            query_noise=comp.get("query_noise", 0.15),
            cross_fiber_frac=comp["cross_fiber_frac"],
            n_fields=comp["n_fields"], noise_scale=noise_scale)
    if kind == "or_pair":
        parts = _split(count, [1.0] * len(comp["codes"]))
        return [x for c, m in zip(comp["codes"], parts)
                for x in recipe.make_or_queries(ds, c, m, seed=seed,
                                                noise_scale=noise_scale)]
    if kind == "range":
        parts = _split(count, [1.0] * len(comp["sels"]))
        return [x for s, m in zip(comp["sels"], parts)
                for x in recipe.make_range_queries(ds, s, m, seed=seed,
                                                   noise_scale=noise_scale)]
    if kind == "codes":
        return _codes_queries(ds, comp, count, seed, noise_scale)
    raise ValueError(f"unknown mix component kind {kind!r}")


def make_pool(ds: recipe.Corpus, mix: dict, size: int, seed: int,
              noise_scale: float) -> Pool:
    """``size`` queries split over the mix's components by share, in an
    order shuffled from the seed."""
    comps = mix["components"]
    items = []
    for i, (comp, count) in enumerate(zip(
            comps, _split(size, [c["share"] for c in comps]))):
        items += _component(ds, comp, count,
                            stream_seed(seed, f"mix{i}") % 2**31,
                            noise_scale)
    order = stream(seed, "pool_order").permutation(len(items))
    return Pool(np.stack([items[i][0] for i in order]).astype(np.float32),
                [items[i][1] for i in order])

