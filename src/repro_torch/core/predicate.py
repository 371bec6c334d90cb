"""Composable filter-expression algebra + bounded-DNF compiler.

The paper fixes predicates to conjunctions of value-sets (§3.1); this
module is the serving-grade generalization (DESIGN.md §8): an expression
tree of ``In`` / ``Range`` leaves composed with ``And`` / ``Or`` / ``Not``,
plus a compiler that normalizes any expression into a *bounded* disjunctive
normal form — at most ``max_disjuncts`` disjuncts, each a conjunctive
clause list of the exact shape ``FilterPredicate.clauses`` already has, so
every disjunct reuses the existing dense clause-table machinery and the
device kernels only add a small OR-reduction over disjuncts.

Semantics (shared by the numpy oracles here, the lowering, and the device
kernels — property-tested bit-identical in ``tests/test_predicate.py``):

* a metadata code of ``-1`` means "field not populated" and fails every
  constraint on that field, **including negated ones** — ``Not`` is the
  complement within the field's populated domain ``[0, vocab_sizes[f])``,
  not a boolean flip. This is what makes ``Not``/``Range`` lowerable to
  complement value-sets (small domains) or symbolic ``Interval`` clauses
  (large domains) with identical semantics.
* ``In`` is literal: its values are kept as given (negatives dropped),
  so high-cardinality codes beyond a default domain still match.
* ``Range`` compiles to a symbolic ``(field, Interval(lo, hi))`` clause —
  two ints regardless of the field's vocabulary — never a materialized
  value-set, so clause-table bytes are O(1) in the domain size.
* ``Range(f, lo, hi)`` is the inclusive interval clipped to the field's
  domain; open ends (``None``) extend to the domain edge.

``vocab_sizes`` (the per-field domain) is only needed when an expression
contains ``Not`` or an open-ended ``Range``; when omitted, a field's
domain defaults to ``DEFAULT_DOMAIN``. Any domain that covers every code
actually present in the corpus yields the same masks, so engines derive it
from their metadata (``max+1`` per field) when the dataset's
``vocab_sizes`` isn't at hand.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, NamedTuple, Sequence

import numpy as np

from repro_torch.core.config import AtlasConfig, KernelConfig

# fallback per-field domain for Not/Range when no vocab_sizes is given;
# matches the kernels' default value-bitmap capacity (kernels.ops.V_CAP)
DEFAULT_DOMAIN = AtlasConfig().v_cap_min


class Interval(NamedTuple):
    """Symbolic inclusive interval clause value: the row passes iff
    ``lo <= code <= hi`` (and the code is populated, i.e. >= 0). Appears
    as the second element of a clause tuple in place of a value tuple, so
    a ``Range`` over a vocab-10^6 field costs two ints instead of a
    materialized million-value set. NOTE: a NamedTuple *is* a tuple —
    every consumer that iterates clause values must check
    ``isinstance(spec, Interval)`` first."""

    lo: int
    hi: int

    @property
    def width(self) -> int:
        return max(self.hi - self.lo + 1, 0)

# bound on the disjunctive blow-up: And-over-Or distribution is cut off
# (ValueError) once a (sub)expression needs more conjunctive clause tables
# than this. The default (KernelConfig.max_disjuncts = 8) keeps the device
# tables one power-of-two wider than the common or2/or4 serving shapes
# while capping worst-case kernel work.
MAX_DISJUNCTS = KernelConfig().max_disjuncts

Clauses = tuple  # tuple[(field, (values...)), ...] — FilterPredicate shape


class FilterExpr:
    """Base class for filter expression nodes. Compose with ``&``, ``|``,
    ``~`` or the node constructors directly."""

    def __and__(self, other: "FilterExpr") -> "And":
        return And(self, other)

    def __or__(self, other: "FilterExpr") -> "Or":
        return Or(self, other)

    def __invert__(self) -> "Not":
        return Not(self)

    @staticmethod
    def never() -> "Or":
        """Canonical match-nothing expression (0 disjuncts): the inert
        predicate serving uses for bucket-pad queries."""
        return Or()

    @staticmethod
    def always() -> "And":
        """Canonical match-everything expression (1 empty disjunct)."""
        return And()

    def mask(self, metadata: np.ndarray,
             vocab_sizes: Sequence[int] | None = None) -> np.ndarray:
        """Vectorized corpus-wide pass mask — the numpy oracle every device
        path is tested bit-identical against."""
        return _eval(self, np.asarray(metadata), vocab_sizes, neg=False)

    def matches_row(self, row: np.ndarray,
                    vocab_sizes: Sequence[int] | None = None) -> bool:
        return bool(self.mask(np.asarray(row)[None, :], vocab_sizes)[0])


@dataclasses.dataclass(frozen=True, init=False)
class In(FilterExpr):
    """field's code is one of ``values`` (negatives dropped: code -1 means
    unpopulated and can never match)."""

    field: int
    values: tuple[int, ...]

    def __init__(self, field: int, values: Iterable[int]):
        object.__setattr__(self, "field", int(field))
        object.__setattr__(self, "values",
                           tuple(sorted({int(v) for v in values
                                         if int(v) >= 0})))


@dataclasses.dataclass(frozen=True, init=False)
class Range(FilterExpr):
    """field's code lies in the inclusive interval [lo, hi] ∩ [0, domain);
    ``None`` ends are open (extend to the domain edge)."""

    field: int
    lo: int | None
    hi: int | None

    def __init__(self, field: int, lo: int | None = None,
                 hi: int | None = None):
        object.__setattr__(self, "field", int(field))
        object.__setattr__(self, "lo", None if lo is None else int(lo))
        object.__setattr__(self, "hi", None if hi is None else int(hi))


@dataclasses.dataclass(frozen=True, init=False)
class And(FilterExpr):
    children: tuple[FilterExpr, ...]

    def __init__(self, *children: FilterExpr):
        object.__setattr__(self, "children", tuple(children))


@dataclasses.dataclass(frozen=True, init=False)
class Or(FilterExpr):
    children: tuple[FilterExpr, ...]

    def __init__(self, *children: FilterExpr):
        object.__setattr__(self, "children", tuple(children))


@dataclasses.dataclass(frozen=True)
class Not(FilterExpr):
    child: FilterExpr


def _domain(field: int, vocab_sizes: Sequence[int] | None) -> int:
    if vocab_sizes is not None and field < len(vocab_sizes):
        return int(vocab_sizes[field])
    return DEFAULT_DOMAIN


def _range_bounds(e: Range, dom: int) -> tuple[int, int]:
    lo = 0 if e.lo is None else max(int(e.lo), 0)
    hi = dom - 1 if e.hi is None else min(int(e.hi), dom - 1)
    return lo, hi


def _eval(e: FilterExpr, meta: np.ndarray,
          vocab_sizes: Sequence[int] | None, neg: bool) -> np.ndarray:
    """Recursive oracle. ``neg`` pushes negation De-Morgan-style to the
    leaves, where it becomes the domain complement — exactly the lowering
    ``compile_to_dnf`` performs, so tree eval and compiled eval agree
    bit-for-bit by construction."""
    n = meta.shape[0]
    if isinstance(e, Not):
        return _eval(e.child, meta, vocab_sizes, not neg)
    if isinstance(e, (And, Or)):
        conj = isinstance(e, And) ^ neg
        out = np.full(n, conj, dtype=bool)
        for c in e.children:
            m = _eval(c, meta, vocab_sizes, neg)
            out = (out & m) if conj else (out | m)
        return out
    col = meta[:, e.field]
    if isinstance(e, In):
        m = np.isin(col, np.asarray(e.values, dtype=np.int64))
    elif isinstance(e, Range):
        lo, hi = _range_bounds(e, _domain(e.field, vocab_sizes))
        m = (col >= lo) & (col <= hi)
    else:
        raise TypeError(f"not a FilterExpr node: {e!r}")
    if neg:
        dom = _domain(e.field, vocab_sizes)
        m = (col >= 0) & (col < dom) & ~m
    return m


# -- bounded DNF -------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DNF:
    """Compiled predicate: a union of conjunctive clause lists, each of the
    exact ``FilterPredicate.clauses`` shape. Zero disjuncts match nothing;
    one empty disjunct matches everything."""

    disjuncts: tuple[Clauses, ...]

    @property
    def n_disjuncts(self) -> int:
        return len(self.disjuncts)

    @property
    def max_clauses(self) -> int:
        return max((len(d) for d in self.disjuncts), default=0)

    @property
    def has_intervals(self) -> bool:
        return any(isinstance(spec, Interval)
                   for d in self.disjuncts for _, spec in d)

    def mask(self, metadata: np.ndarray,
             vocab_sizes: Sequence[int] | None = None) -> np.ndarray:
        """Union over disjuncts of conjunctive clause masks (``vocab_sizes``
        accepted for interface parity; negation is already lowered).
        Interval clauses are two comparisons; value-set clauses an isin."""
        del vocab_sizes
        meta = np.asarray(metadata)
        out = np.zeros(meta.shape[0], dtype=bool)
        for clauses in self.disjuncts:
            m = np.ones(meta.shape[0], dtype=bool)
            for f, spec in clauses:
                col = meta[:, f]
                # col >= 0 guard: unpopulated codes fail every clause even
                # if a hand-built DNF carries negative values (the device
                # packers drop them; the oracles must agree)
                if isinstance(spec, Interval):
                    m &= (col >= 0) & (col >= spec.lo) & (col <= spec.hi)
                else:
                    m &= (col >= 0) & np.isin(
                        col, np.asarray(spec, dtype=np.int64))
            out |= m
        return out

    def matches_row(self, row: np.ndarray,
                    vocab_sizes: Sequence[int] | None = None) -> bool:
        return bool(self.mask(np.asarray(row)[None, :], vocab_sizes)[0])

    def to_predicate(self):
        """Lower a ≤1-disjunct DNF to a plain conjunctive FilterPredicate
        (0 disjuncts become the canonical match-nothing clause), so purely
        conjunctive batches keep the legacy clause-table shape and its
        compiled programs. Interval clauses have no FilterPredicate form —
        callers must check ``has_intervals`` first."""
        from repro_torch.core.types import FilterPredicate
        if self.has_intervals:
            raise ValueError(
                "DNF with interval clauses cannot lower to a value-set "
                "FilterPredicate; keep the DNF form")
        if self.n_disjuncts == 0:
            return FilterPredicate(((0, ()),))
        if self.n_disjuncts == 1:
            return FilterPredicate(tuple(self.disjuncts[0]))
        raise ValueError(
            f"DNF with {self.n_disjuncts} disjuncts is not conjunctive")


def _runs(vals: Iterable[int]) -> list[tuple[int, int]]:
    """Maximal consecutive runs of a sorted-able int collection."""
    out: list[tuple[int, int]] = []
    for v in sorted(vals):
        if out and v == out[-1][1] + 1:
            out[-1] = (out[-1][0], v)
        else:
            out.append((v, v))
    return out


def _complement_intervals(vals: Iterable[int], dom: int) -> list[Interval]:
    """[0, dom) minus the given values, as a list of gap intervals."""
    gaps, prev = [], 0
    for lo, hi in _runs(v for v in vals if 0 <= v < dom):
        if lo > prev:
            gaps.append(Interval(prev, lo - 1))
        prev = hi + 1
    if prev <= dom - 1:
        gaps.append(Interval(prev, dom - 1))
    return gaps


def _leaf_specs(e: FilterExpr, neg: bool, vocab_sizes: Sequence[int] | None,
                v_cap: int | None) -> list[dict]:
    """Lower one leaf (possibly negated) to a list of single-field
    conjunct dicts (its disjuncts). Each dict value is a ``frozenset`` of
    codes or a symbolic ``Interval`` — never a materialized range: the
    choice is what keeps both the host compile and the device clause
    tables O(1) in the field's vocabulary size.

    * ``Range`` stays a single clipped interval; its negation is the ≤2
      complement intervals within the domain.
    * ``In`` stays a literal value-set unless a value exceeds the device
      bitmap capacity ``v_cap`` — then it splits into consecutive-run
      intervals (one disjunct per run).
    * ``Not(In)`` is the domain complement: a value-set only while the
      domain fits the bitmap (byte-identical legacy tables for small
      categorical vocabs), gap intervals beyond that.
    """
    dom = _domain(e.field, vocab_sizes)
    small = v_cap if v_cap is not None else DEFAULT_DOMAIN
    if isinstance(e, Range):
        lo, hi = _range_bounds(e, dom)
        if not neg:
            return [] if hi < lo else [{e.field: Interval(lo, hi)}]
        if hi < lo:  # empty range: complement is the whole domain
            return [] if dom <= 0 else [{e.field: Interval(0, dom - 1)}]
        out = []
        if lo > 0:
            out.append({e.field: Interval(0, lo - 1)})
        if hi < dom - 1:
            out.append({e.field: Interval(hi + 1, dom - 1)})
        return out
    if not isinstance(e, In):
        raise TypeError(f"not a FilterExpr leaf: {e!r}")
    base = frozenset(e.values)
    if not neg:
        if v_cap is not None and any(v >= v_cap for v in base):
            return [{e.field: Interval(lo, hi)} for lo, hi in _runs(base)]
        return [] if not base else [{e.field: base}]
    if dom <= 0:
        return []
    if dom <= small:
        comp = frozenset(range(dom)) - base
        return [] if not comp else [{e.field: comp}]
    return [{e.field: iv} for iv in _complement_intervals(base, dom)]


def _isect(a, b):
    """Intersection of two clause specs (frozenset or Interval). Returns
    a spec, or None/empty-set when unsatisfiable."""
    a_iv, b_iv = isinstance(a, Interval), isinstance(b, Interval)
    if a_iv and b_iv:
        lo, hi = max(a.lo, b.lo), min(a.hi, b.hi)
        return None if hi < lo else Interval(lo, hi)
    if a_iv:
        return frozenset(v for v in b if a.lo <= v <= a.hi)
    if b_iv:
        return frozenset(v for v in a if b.lo <= v <= b.hi)
    return a & b


def _merge_conj(a: dict, b: dict) -> dict | None:
    """AND of two conjuncts: intersect same-field specs (value sets and/or
    intervals); ``None`` if any intersection is empty (the combined
    disjunct is unsatisfiable)."""
    out = dict(a)
    for f, vs in b.items():
        inter = _isect(out[f], vs) if f in out else vs
        if inter is None or (not isinstance(inter, Interval) and not inter):
            return None
        out[f] = inter
    return out


def _dedupe(disjuncts: list[dict]) -> list[dict]:
    seen, out = set(), []
    for d in disjuncts:
        key = frozenset(d.items())
        if key not in seen:
            seen.add(key)
            out.append(d)
    return out


def _lower(e: FilterExpr, neg: bool, vocab_sizes: Sequence[int] | None,
           cap: int, v_cap: int | None) -> list[dict]:
    if isinstance(e, Not):
        return _lower(e.child, not neg, vocab_sizes, cap, v_cap)
    if isinstance(e, (And, Or)):
        conj = isinstance(e, And) ^ neg
        parts = [_lower(c, neg, vocab_sizes, cap, v_cap)
                 for c in e.children]
        if conj:
            acc: list[dict] = [{}]
            for p in parts:
                nxt = []
                for a in acc:
                    for b in p:
                        m = _merge_conj(a, b)
                        if m is not None:
                            nxt.append(m)
                acc = _dedupe(nxt)
                if len(acc) > cap:
                    raise ValueError(
                        f"expression needs {len(acc)} disjuncts > "
                        f"max_disjuncts={cap}; simplify the predicate or "
                        f"raise the bound")
            return acc
        out: list[dict] = []
        for p in parts:
            out.extend(p)
        out = _dedupe(out)
        if any(not d for d in out):   # an unconstrained disjunct absorbs all
            return [{}]
        if len(out) > cap:
            raise ValueError(
                f"expression needs {len(out)} disjuncts > "
                f"max_disjuncts={cap}; simplify the predicate or raise "
                f"the bound")
        return out
    return _leaf_specs(e, neg, vocab_sizes, v_cap)


def _norm_spec(spec):
    return spec if isinstance(spec, Interval) else tuple(sorted(spec))


def compile_to_dnf(expr, vocab_sizes: Sequence[int] | None = None, *,
                   max_disjuncts: int = MAX_DISJUNCTS,
                   v_cap: int | None = None) -> DNF:
    """Normalize any ``FilterExpr`` (or FilterPredicate / DNF) to a bounded
    DNF: ``Range`` stays a symbolic interval clause, ``Not`` lowers to the
    domain complement (value-set for small domains, gap intervals beyond),
    ``And`` distributes over ``Or`` with unsatisfiable disjuncts dropped
    and duplicates merged, and the disjunct count is capped at
    ``max_disjuncts`` (ValueError beyond). ``v_cap`` is the device bitmap
    capacity: when given, ``In`` values beyond it split into interval-run
    disjuncts so the result always packs."""
    if isinstance(expr, DNF):
        return expr
    if not isinstance(expr, FilterExpr):
        clauses = getattr(expr, "clauses", None)  # FilterPredicate
        if clauses is None:
            raise TypeError(f"cannot compile {type(expr).__name__} to DNF")
        # drop negative values on wrap: they can never match (code -1 means
        # unpopulated), and the device packers skip them too
        return DNF((tuple((f, tuple(v for v in vals if v >= 0))
                          for f, vals in clauses),))
    disjuncts = _lower(expr, False, vocab_sizes, max_disjuncts, v_cap)
    return DNF(tuple(
        tuple(sorted(((f, _norm_spec(vs)) for f, vs in d.items()),
                     key=lambda c: c[0]))
        for d in disjuncts))


def as_dnf(pred, vocab_sizes: Sequence[int] | None = None, *,
           max_disjuncts: int = MAX_DISJUNCTS,
           v_cap: int | None = None) -> DNF:
    """Uniform entry point for every layer that consumes predicates:
    DNF passes through, FilterPredicate wraps as its single disjunct
    (verbatim — no simplification, so legacy clause tables stay
    byte-identical), FilterExpr compiles."""
    return compile_to_dnf(pred, vocab_sizes, max_disjuncts=max_disjuncts,
                          v_cap=v_cap)


def disjunct_selectivity(clauses: Clauses,
                         vocab_sizes: Sequence[int] | None = None) -> float:
    """Independence-assumption selectivity estimate of one conjunctive
    clause list: product over clauses of |spec| / domain. Used to pack
    rare disjuncts first so the kernel's short-circuit skips the broad
    tail once a tile's pass words saturate."""
    s = 1.0
    for f, spec in clauses:
        dom = max(_domain(f, vocab_sizes), 1)
        width = spec.width if isinstance(spec, Interval) else len(spec)
        s *= min(width / dom, 1.0)
    return s


def derived_vocab_sizes(metadata: np.ndarray) -> tuple[int, ...]:
    """Per-field domain derived from observed codes (``max+1``). Any domain
    covering every present code yields identical masks, so this is a safe
    stand-in when the dataset's declared ``vocab_sizes`` isn't available."""
    meta = np.asarray(metadata)
    if meta.size == 0:
        return tuple(0 for _ in range(meta.shape[1]))
    return tuple(int(c) + 1 for c in meta.max(axis=0))
