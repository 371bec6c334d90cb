"""Background maintenance: budgeted incremental steps that take repair
off the ingest path (DESIGN.md §12).

With ``maintenance.defer_repair`` on, ingest costs slab writes + validity
bit flips + one nearest-cluster matmul; everything the inline path runs —
per-shard ``patch_adjacency`` graph repair, centroid refresh / atlas
re-cluster — and tombstone compaction become deferred work this
loop drains in small host-side steps, each followed by one device
publish. The scheduler is signal-driven, reading the same ``staleness()``
numbers operators see:

* ``repair_backlog_rows`` > 0   → drain up to ``repair_batch_rows`` of
  the insert backlog FIFO (``lifecycle.drain_pending``);
* ``tombstone_fraction`` past ``compact_tombstone_frac`` (per shard,
  with the ``compact_min_rows`` floor)  → compact those shards
  (``lifecycle.compact_state``);
* ``centroid_drift`` past ``drift_threshold`` with no backlog left
  → run the per-shard recluster check (``repair_range`` already folds
  it into backlog drains, so this only fires on drift from deletes).

One ``step()`` does ONE category of work — the cheapest stale one — so a
serving loop can interleave ``step()`` between query batches with a
bounded per-call cost; ``run_until_idle()`` drains everything (capped by
``max_steps_per_drain``). Every step that mutated host state publishes
through the engine's ``refresh_device(touched)`` hook, keeping the device
slabs current without touching the search path.

Crash consistency: host mutations here are all reconstructible — the
backlog and tombstone set ride the journal/snapshot, and compaction is
deterministic given the slab — so the fault points
(``maintenance.pre-repair``, ``maintenance.mid-compact``,
``maintenance.pre-publish``) are testable SIGKILL moments, not new
durability obligations. The ``on_compact`` callback lets the serving
layer append a WAL record BEFORE compaction mutates anything.
"""
from __future__ import annotations

from typing import Callable

from repro_torch import faults
from repro_torch.core.batched import lifecycle
from repro_torch.core.batched.insert import _needs_recluster, _recluster
from repro_torch.core.config import MaintenanceConfig


class MaintenanceLoop:
    """Budgeted background maintenance over one engine's host state.

    ``engine`` is any capacity-slab engine (the port has
    ``BatchedEngine``) exposing ``.state`` and ``.refresh_device``;
    ``on_compact`` (optional) is called with the shard list about to be
    compacted — the serving layer uses it to journal the operation
    before it runs."""

    def __init__(self, engine, mcfg: MaintenanceConfig | None = None,
                 on_compact: Callable[[list[int]], None] | None = None):
        if getattr(engine, "state", None) is None:
            raise ValueError(
                "maintenance needs a capacity-slab engine (build with "
                "serve.capacity set)")
        self.engine = engine
        self.mcfg = mcfg or MaintenanceConfig()
        self.on_compact = on_compact
        self.steps = 0
        self.repaired_rows = 0
        self.reclaimed_rows = 0
        self.reclusters = 0

    # -- scheduling signals --------------------------------------------------

    def stale_shards(self) -> list[int]:
        """Shards past the compaction threshold."""
        m = self.mcfg
        out = []
        for s, sh in enumerate(self.engine.state.shards):
            t = sh.tombstones
            if (t >= m.compact_min_rows
                    and t / max(sh.n_valid, 1) >= m.compact_tombstone_frac):
                out.append(s)
        return out

    def pending_work(self) -> dict:
        """What the loop would do next, from the staleness signals — the
        operator-facing view (all zeros = idle)."""
        st = self.engine.state
        return {"repair_backlog_rows": st.pending_rows,
                "compactable_shards": len(self.stale_shards()),
                "drifted": float(st.centroid_drift())
                > self.mcfg.drift_threshold}

    @property
    def idle(self) -> bool:
        w = self.pending_work()
        return (w["repair_backlog_rows"] == 0
                and w["compactable_shards"] == 0 and not w["drifted"])

    # -- the incremental step ------------------------------------------------

    def step(self, budget_rows: int | None = None) -> dict:
        """Run ONE budgeted unit of deferred work and publish it.

        Priority order is cheapest-stale-first: backlog repair (bounded
        by ``budget_rows`` / ``repair_batch_rows``), then compaction of
        any shard past its tombstone threshold, then a drift-triggered
        recluster sweep. Returns {"kind", ...accounting}; kind "idle"
        means there was nothing to do (and nothing was published). A
        published step also reports the engine's new ``generation`` —
        the counter the serve path's dispatch fence checks, so an
        in-flight batch either re-packs against this publish or carries
        the pre-publish generation in its stats (DESIGN.md §13)."""
        st = self.engine.state
        m = self.mcfg
        touched: list[int] | None = None
        if st.pending_rows:
            faults.fire("maintenance.pre-repair")
            budget = budget_rows or m.repair_batch_rows
            shards_before = sorted({s for s, _lo, _hi in st.pending})
            done = lifecycle.drain_pending(st, budget_rows=budget)
            self.repaired_rows += done
            # conservative publish set: every shard that had backlog (an
            # unreached one costs a wasted transfer, never a stale read)
            touched = shards_before
            out = {"kind": "repair", "rows": done,
                   "remaining": st.pending_rows}
        elif self.stale_shards():
            shards = self.stale_shards()
            if self.on_compact is not None:
                self.on_compact(shards)
            rep = lifecycle.compact_state(st, m)
            self.reclaimed_rows += rep["reclaimed"]
            touched = rep["shards"]
            out = {"kind": "compact", **{k: rep[k] for k in
                                         ("reclaimed", "relinked",
                                          "repairs", "shards")}}
        elif float(st.centroid_drift()) > m.drift_threshold:
            touched = []
            for s, sh in enumerate(st.shards):
                if _needs_recluster(sh, st.params):
                    _recluster(sh, st.params.kmeans_iters,
                               seed=st.seed + 1 + sh.atlas.reclusters)
                    self.reclusters += 1
                    touched.append(s)
            out = {"kind": "recluster", "shards": touched}
            if not touched:
                # drifted but under the recluster triggers: re-averaged
                # centroids are already current, nothing to publish
                return {"kind": "idle"}
        else:
            return {"kind": "idle"}
        self.steps += 1
        # host work done; the device publish is what makes it visible
        faults.fire("maintenance.pre-publish")
        self.engine.refresh_device(touched)
        out["generation"] = getattr(self.engine, "publish_generation", None)
        return out

    def run_until_idle(self, max_steps: int | None = None) -> dict:
        """Drain all deferred work (bounded by ``max_steps_per_drain``):
        the ``compact_now`` / shutdown / test path. Returns summed
        accounting."""
        cap = max_steps or self.mcfg.max_steps_per_drain
        total = {"steps": 0, "repaired": 0, "reclaimed": 0}
        for _ in range(cap):
            out = self.step()
            if out["kind"] == "idle":
                break
            total["steps"] += 1
            total["repaired"] += out.get("rows", 0)
            total["reclaimed"] += out.get("reclaimed", 0)
        return total
