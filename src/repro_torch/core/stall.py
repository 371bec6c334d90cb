r"""Stall-regime taxonomy and diagnostics (paper §8).

A stall point x* is the last node expanded by a walk before termination.
Classification (paper §8.2), with σ = |X_S|/n the global filter selectivity:

* topological cut:  ρ_S(x*) <  σ/2
* geometric fold:   ρ_S(x*) ≥ σ/2 and |B⁻(x*)| > 0
* genuine basin:    ρ_S(x*) ≥ σ/2 and |B⁻(x*)| = 0

where B⁻(x*) = {y ∈ N(x*) \ X_S : V(y) < V(x*)} is the boundary-improving
set. All three regimes share one resolution: restart in a fiber-present
cluster near q (the anchor atlas).
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict

import numpy as np

from repro_torch.core.types import SearchStats, WalkStats

REGIMES = ("topological_cut", "geometric_fold", "genuine_basin")

SELECTIVITY_BINS = ((0.0, 0.001), (0.001, 0.01), (0.01, 0.05),
                    (0.05, 0.20), (0.20, 1.01))


def bin_name(lo: float, hi: float) -> str:
    def pct(x: float) -> str:
        return f"{x * 100:g}%"
    if hi > 1.0:
        return f">{pct(lo)}"
    if lo == 0.0:
        return f"<{pct(hi)}"
    return f"{pct(lo)}-{pct(hi)}"


def classify_stall(ws: WalkStats, selectivity: float) -> str | None:
    """Regime of one walk's stall point; None if no stall point recorded."""
    if ws.stall_node < 0 or not np.isfinite(ws.stall_rho):
        return None
    if ws.stall_rho < selectivity / 2.0:
        return "topological_cut"
    if ws.stall_b_minus > 0:
        return "geometric_fold"
    return "genuine_basin"


@dataclasses.dataclass
class RegimeAggregate:
    count: int = 0
    rho: float = 0.0
    b_minus: float = 0.0
    drift: float = 0.0
    potential: float = 0.0
    recall: float = 0.0

    def finalize(self) -> dict:
        c = max(self.count, 1)
        return {"count": self.count, "rho": self.rho / c,
                "b_minus": self.b_minus / c, "drift": self.drift / c,
                "potential": self.potential / c, "recall": self.recall / c}


def aggregate_stalls(stats: list[SearchStats], selectivities: list[float],
                     recalls: list[float]) -> dict[str, dict]:
    """Paper Table 6: mean diagnostics at stall points by regime."""
    agg = {r: RegimeAggregate() for r in REGIMES}
    for st, sel, rec in zip(stats, selectivities, recalls):
        for ws in st.walks:
            r = classify_stall(ws, sel)
            if r is None:
                continue
            a = agg[r]
            a.count += 1
            a.rho += ws.stall_rho
            a.b_minus += ws.stall_b_minus
            a.drift += 0.0 if not np.isfinite(ws.stall_drift) else ws.stall_drift
            a.potential += ws.stall_potential
            a.recall += rec
    return {r: a.finalize() for r, a in agg.items()}


def regimes_by_selectivity(stats: list[SearchStats], selectivities: list[float],
                           recalls: list[float]) -> list[dict]:
    """Paper Table 4: recall/hops/walks + regime mix per selectivity bin."""
    rows = []
    for lo, hi in SELECTIVITY_BINS:
        sel_idx = [i for i, s in enumerate(selectivities) if lo <= s < hi]
        regime_counts = defaultdict(int)
        hops = walks = 0
        rec = 0.0
        for i in sel_idx:
            rec += recalls[i]
            hops += stats[i].hops
            walks += stats[i].n_walks
            for ws in stats[i].walks:
                r = classify_stall(ws, selectivities[i])
                if r:
                    regime_counts[r] += 1
        nq = len(sel_idx)
        tot = max(sum(regime_counts.values()), 1)
        rows.append({
            "bin": bin_name(lo, hi), "n": nq,
            "recall": rec / nq if nq else float("nan"),
            "hops": hops / nq if nq else float("nan"),
            "walks": walks / nq if nq else float("nan"),
            **{r: regime_counts[r] / tot for r in REGIMES},
        })
    return rows


def termination_by_selectivity(stats: list[SearchStats],
                               selectivities: list[float]) -> list[dict]:
    """Paper Table 5: termination-reason mix per selectivity bin.

    The paper reports three reasons; walks that converge (beam exhausted)
    are reported separately here for honesty and folded into ``early_stop``
    for the paper-faithful column mapping.
    """
    reasons = ("early_stop", "stall_budget", "max_hops", "converged")
    rows = []
    for lo, hi in SELECTIVITY_BINS:
        counts = defaultdict(int)
        tot = 0
        for st, sel in zip(stats, selectivities):
            if not (lo <= sel < hi):
                continue
            for ws in st.walks:
                counts[ws.termination] += 1
                tot += 1
        tot = max(tot, 1)
        rows.append({"bin": bin_name(lo, hi),
                     **{r: counts[r] / tot for r in reasons}})
    return rows
