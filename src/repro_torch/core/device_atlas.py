"""Device-resident anchor atlas: batched anchor selection as fixed-shape
tensor ops (paper §4.2–4.3 moved onto the accelerator; DESIGN.md §3).

``DeviceAtlas`` packs the host ``AnchorAtlas`` into flat tensors on one
device so one call selects anchors for all Q queries:

* ``csr_pts`` (n,) + ``csr_offsets`` (K+1,) int64 index tensors — the
  members lists CSR-flattened: point ids grouped by cluster, ascending
  id within a cluster. The per-(field, value) sublists of the host atlas
  are recovered through the query's pass bitmap, so the pack is O(n),
  not O(n·F).
* ``presence`` (F, K, W) i32 words — the inverted cluster_index
  transposed into fixed-shape bitmaps: bit v of ``presence[f, k]`` is set
  iff cluster k holds ≥1 point with metadata[·, f] == v. A conjunctive
  cluster-match is then a bitwise AND over clauses of OR-reduced words.

``select_anchors_batch`` reproduces ``AnchorAtlas.select_anchors`` exactly
(same seed sets, same consumed clusters) for every query in the batch; the
in-cluster nearest-matching-member scan runs either as one lexicographic
sort over (cluster rank, cosine distance) ["sort" backend] or as one
top-k per yielding-cluster slot ["topk" backend]: on CUDA each slot is a
``masked_cosine_topk`` kernel call, on the CPU the slots share one dense
score product.

Sorting follows the reference exactly: every top-k is a stable
descending sort (``lax.top_k`` puts the lower index first among ties),
every argsort is stable, and a multi-key ``lax.sort`` is a chain of
stable sorts from the last key to the first.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.batched.bitmap import n_words as _n_words
from repro_torch.core.batched.bitmap import pack_bits
from repro_torch.core.config import AtlasConfig
from repro_torch.core.predicate import Interval
from repro_torch.kernels import ops
# sentinel + device-side count derivation live with the kernel that
# consumes the tables; re-exported here next to the packers that emit them
from repro_torch.kernels.filter_eval import DEAD_DISJUNCT, table_n_disj
from repro_torch.kernels.ops import V_CAP
from repro_torch.kernels.ref import top_k

NEG = -3.4e38
_ACFG = AtlasConfig()
# mirrors AnchorAtlas.cluster_members_matching's cap
MEMBER_CAP = _ACFG.member_cap

# ceiling on the *auto-sized* value-bitmap width: beyond this, per-value
# presence bitmaps would scale device memory with the vocabulary, so codes
# past the cap are tracked only by the per-cluster [code_min, code_max]
# envelope and served by interval clauses. An explicit v_cap still sizes
# exactly as asked.
AUTO_V_CAP_MAX = _ACFG.auto_v_cap_max

INT32_MAX = np.int32(2**31 - 1)


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another. Asking for CUDA where there is none raises — the port never
    falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch path on the host")
    return dev


def auto_v_cap(vmax: int) -> int:
    """Value-bitmap width for a corpus whose largest metadata code is
    ``vmax``: at least V_CAP (common small vocabularies share one width),
    else the next 32-bit word boundary, ceilinged at AUTO_V_CAP_MAX."""
    return min(max(V_CAP, 32 * _n_words(vmax + 1)), AUTO_V_CAP_MAX)


def _pack_clauses(clauses, fields_row: np.ndarray, allowed_row: np.ndarray,
                  v_cap: int, bounds_row: np.ndarray | None = None) -> None:
    """Write one conjunctive clause list into a (C,) fields row + a
    (C, Wv) value-bitmap row (+ optionally a (C, 2) interval-bounds row).
    An ``Interval`` spec writes only its bounds — the bitmap row stays
    zero and the kernels dispatch on ``lo <= hi``. Negative values are
    dropped (code -1 = unpopulated can never match); a non-negative value
    ≥ v_cap cannot be represented in the bitmap and raises — compile with
    ``v_cap=`` so such values lower to interval clauses instead."""
    for ci, (f, spec) in enumerate(clauses):
        fields_row[ci] = f
        if isinstance(spec, Interval):
            if bounds_row is None:
                raise ValueError(
                    "interval clause in a value-set-only table; pack via "
                    "pack_dnf (bounds-capable) instead of pack_predicates")
            bounds_row[ci, 0] = max(spec.lo, 0)
            bounds_row[ci, 1] = min(spec.hi, int(INT32_MAX))
            continue
        for v in spec:
            if 0 <= v < v_cap:
                allowed_row[ci, v >> 5] |= np.uint32(1) << np.uint32(v & 31)
            elif v >= v_cap:
                raise ValueError(
                    f"clause value {v} >= v_cap={v_cap} cannot pack into "
                    f"the value bitmap; compile the predicate with "
                    f"v_cap={v_cap} so it lowers to interval clauses")


def pack_predicates(preds, *, max_clauses: int | None = None,
                    v_cap: int = V_CAP) -> tuple[np.ndarray, np.ndarray]:
    """FilterPredicates -> clause tables (fields (Q, C) i32, -1 = inactive;
    allowed (Q, C, ceil(v_cap/32)) u32 value bitmaps)."""
    n_cl = max((p.n_clauses for p in preds), default=0)
    C = max(1, n_cl) if max_clauses is None else max_clauses
    if n_cl > C:
        raise ValueError(f"predicate has {n_cl} clauses > max_clauses={C}")
    Q = len(preds)
    fields = np.full((Q, C), -1, np.int32)
    allowed = np.zeros((Q, C, _n_words(v_cap)), np.uint32)
    for qi, pred in enumerate(preds):
        _pack_clauses(pred.clauses, fields[qi], allowed[qi], v_cap)
    return fields, allowed


def pack_dnf(dnfs, *, max_disjuncts: int | None = None,
             max_clauses: int | None = None, v_cap: int = V_CAP,
             ) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Compiled DNF predicates -> disjunctive clause tables:
    fields (Q, D, C) i32 (-1 inactive clause, DEAD_DISJUNCT = -2 for the
    dead-disjunct padding tail), allowed (Q, D, C, ceil(v_cap/32)) u32
    value bitmaps, bounds (Q, D, C, 2) i32 interval-bounds rows, n_disj
    (Q,) i32 per-query live-disjunct counts. A clause is *either* a
    value-set (its bitmap populated, bounds at the inert (0, -1) sentinel)
    *or* an interval (bounds = [lo, hi] with lo <= hi, bitmap zero)."""
    n_dj = max((d.n_disjuncts for d in dnfs), default=0)
    D = max(1, n_dj) if max_disjuncts is None else max_disjuncts
    if n_dj > D:
        raise ValueError(f"predicate has {n_dj} disjuncts > "
                         f"max_disjuncts={D}")
    n_cl = max((d.max_clauses for d in dnfs), default=0)
    C = max(1, n_cl) if max_clauses is None else max_clauses
    if n_cl > C:
        raise ValueError(f"disjunct has {n_cl} clauses > max_clauses={C}")
    Q = len(dnfs)
    fields = np.full((Q, D, C), DEAD_DISJUNCT, np.int32)
    allowed = np.zeros((Q, D, C, _n_words(v_cap)), np.uint32)
    bounds = np.zeros((Q, D, C, 2), np.int32)
    bounds[..., 1] = -1
    n_disj = np.zeros(Q, np.int32)
    for qi, dnf in enumerate(dnfs):
        n_disj[qi] = dnf.n_disjuncts
        for di, clauses in enumerate(dnf.disjuncts):
            fields[qi, di, :] = -1
            _pack_clauses(clauses, fields[qi, di], allowed[qi, di], v_cap,
                          bounds[qi, di])
    return fields, allowed, bounds, n_disj


def words_to_torch(words: np.ndarray, device) -> torch.Tensor:
    """numpy uint32 words (a packer's or the reference's bitmaps) -> the
    port's int32 words with the same bits."""
    return torch.from_numpy(np.array(words, np.uint32)
                            .view(np.int32)).to(device)


def stack_atlases(atlases: list["DeviceAtlas"]) -> "DeviceAtlas":
    """Stack per-shard atlases into one DeviceAtlas whose leaves carry a
    leading shard dim (the sharded index's form; ``DeviceAtlas.shard``
    takes one back out). Shards must agree on v_cap and on every leaf's
    shape — the sharded build pads them to common shapes first."""
    caps = {a.v_cap for a in atlases}
    if len(caps) != 1:
        raise ValueError(f"shard atlases disagree on v_cap: {sorted(caps)}")
    shapes = {tuple(tuple(t.shape) for t in a.leaves()) for a in atlases}
    if len(shapes) != 1:
        raise ValueError(f"shard atlases disagree on shapes: {shapes}")
    return DeviceAtlas(*(torch.stack(ls) for ls in
                         zip(*(a.leaves() for a in atlases))),
                       v_cap=caps.pop())


def _excl_cumsum(x: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(x, dim=-1) - x


def _lexsort(*keys: torch.Tensor) -> torch.Tensor:
    """Permutation sorting rows lexicographically by ``keys`` (first key
    most significant), ties kept in index order — a multi-key ``lax.sort``
    as a chain of stable sorts from the last key to the first."""
    perm = torch.argsort(keys[-1], dim=1, stable=True)
    for key in reversed(keys[:-1]):
        perm = perm.gather(1, torch.argsort(key.gather(1, perm), dim=1,
                                            stable=True))
    return perm


@dataclasses.dataclass
class DeviceAtlas:
    centroids: torch.Tensor    # (K, d) f32 unit-norm
    assign: torch.Tensor       # (n,) i64 point -> cluster
    csr_pts: torch.Tensor      # (n,) i64 point ids grouped by cluster
    csr_offsets: torch.Tensor  # (K+1,) i64
    inv_perm: torch.Tensor     # (n,) i64 point id -> position in csr_pts
    presence: torch.Tensor     # (F, K, W) i32 cluster/field/value bitmap
    code_min: torch.Tensor     # (F, K) i32 smallest code present (INT32_MAX
    #                            if the cluster holds no populated code)
    code_max: torch.Tensor     # (F, K) i32 largest code present (-1 if none)
    v_cap: int = V_CAP

    @property
    def n_clusters(self) -> int:
        return self.centroids.shape[0]

    @property
    def device(self) -> torch.device:
        return self.centroids.device

    def leaves(self) -> tuple[torch.Tensor, ...]:
        """The tensor fields in declaration order (``v_cap`` left out)."""
        return tuple(getattr(self, f.name) for f in dataclasses.fields(self)
                     if f.name != "v_cap")

    def shard(self, s: int) -> "DeviceAtlas":
        """Shard ``s`` of a stacked atlas (``stack_atlases``): each leaf's
        ``leaf[s]``, a view that copies nothing and, for a contiguous
        stack, is contiguous itself."""
        return DeviceAtlas(*(t[s] for t in self.leaves()), v_cap=self.v_cap)

    def pad_rows(self, m: int) -> "DeviceAtlas":
        """Extend the point-indexed tensors to ``m`` rows with inert pad
        entries (sharded indexes pad every shard to a common row count).

        Pads are assigned to cluster 0 and appended at the tail of
        ``csr_pts``/``inv_perm`` (each pad maps to itself). That leaves
        the real-row CSR ranks untouched, and a pad position contributes
        nothing to the selection math because the caller's pass bitmap
        (ANDed with the shard's row-validity bitmap) is always 0 on
        pads."""
        n = self.assign.shape[0]
        if m < n:
            raise ValueError(f"pad_rows to {m} < current {n} rows")
        if m == n:
            return self
        tail = torch.arange(n, m, dtype=self.csr_pts.dtype,
                            device=self.device)
        return DeviceAtlas(
            self.centroids,
            torch.cat([self.assign, torch.zeros(m - n, dtype=self.assign.dtype,
                                                device=self.device)]),
            torch.cat([self.csr_pts, tail]),
            self.csr_offsets,
            torch.cat([self.inv_perm, tail]),
            self.presence, self.code_min, self.code_max, v_cap=self.v_cap)

    @staticmethod
    def from_atlas(atlas, v_cap: int | None = None,
                   device=None) -> "DeviceAtlas":
        """CSR/bitmap-pack a host AnchorAtlas (numpy build) onto ``device``
        (None means CUDA). ``v_cap=None`` auto-sizes to the largest
        metadata code in the inverted index (≥ V_CAP, rounded up to a
        32-bit word, ceilinged at AUTO_V_CAP_MAX) — codes beyond the auto
        ceiling are tracked only by the per-cluster code_min/code_max
        envelope. An explicit v_cap must cover every code."""
        device = resolve_device(device)
        assign = np.asarray(atlas.assign, np.int32)
        n = assign.shape[0]
        k = atlas.n_clusters
        explicit = v_cap is not None
        if v_cap is None:
            vmax = max((v for by_f in atlas.cluster_index for v in by_f),
                       default=-1)
            v_cap = auto_v_cap(vmax)
        order = np.argsort(assign, kind="stable").astype(np.int32)
        offsets = np.zeros(k + 1, np.int64)
        offsets[1:] = np.cumsum(np.bincount(assign, minlength=k))
        inv_perm = np.empty(n, np.int32)
        inv_perm[order] = np.arange(n, dtype=np.int32)
        f_count = len(atlas.cluster_index)
        pres = np.zeros((f_count, k, _n_words(v_cap)), np.uint32)
        cmin = np.full((f_count, k), INT32_MAX, np.int32)
        cmax = np.full((f_count, k), -1, np.int32)
        for f in range(f_count):
            for v, clusters in atlas.cluster_index[f].items():
                if v < 0 or (explicit and v >= v_cap):
                    raise ValueError(
                        f"metadata code {v} out of DeviceAtlas range "
                        f"[0, {v_cap}); rebuild with a larger v_cap")
                cmin[f, clusters] = np.minimum(cmin[f, clusters], v)
                cmax[f, clusters] = np.maximum(cmax[f, clusters], v)
                if v < v_cap:
                    pres[f, clusters, v >> 5] |= (np.uint32(1)
                                                  << np.uint32(v & 31))

        def t(x, dtype):
            return torch.from_numpy(np.ascontiguousarray(x)).to(
                device=device, dtype=dtype)

        return DeviceAtlas(
            t(atlas.centroids, torch.float32), t(assign, torch.int64),
            t(order, torch.int64), t(offsets, torch.int64),
            t(inv_perm, torch.int64), words_to_torch(pres, device),
            t(cmin, torch.int32), t(cmax, torch.int32), v_cap=v_cap)

    # -- batched query-time operations (fixed shapes) -----------------------
    def matching_clusters_batch(self, fields: torch.Tensor,
                                allowed: torch.Tensor,
                                bounds: torch.Tensor | None = None
                                ) -> torch.Tensor:
        """Clause tables -> (Q, K) bool match mask (host matching_clusters
        for every query at once): AND over active clauses of 'cluster has
        ≥1 point with an allowed value on that field'. Disjunctive (Q, D, C)
        tables (``pack_dnf``) OR the per-disjunct conjunctive masks, with
        dead disjuncts contributing False. Interval clauses use the
        conservative per-cluster [code_min, code_max] envelope-overlap
        test."""
        if fields.ndim == 3:
            return self._disjunct_cluster_masks(fields, allowed,
                                                bounds).any(dim=1)
        pres = self.presence[fields.clamp(min=0).long()]     # (Q, C, K, W)
        hit = ((pres & allowed[:, :, None, :]) != 0).any(-1)  # (Q, C, K)
        return torch.where((fields >= 0)[:, :, None], hit, True).all(dim=1)

    def _disjunct_cluster_masks(self, fields: torch.Tensor,
                                allowed: torch.Tensor,
                                bounds: torch.Tensor | None = None
                                ) -> torch.Tensor:
        """(Q, D, C) DNF tables -> (Q, D, K) bool per-disjunct conjunctive
        cluster-match masks (dead disjuncts all-False) — the pre-union form
        the per-disjunct seed quota needs."""
        fsafe = fields.clamp(min=0).long()
        pres = self.presence[fsafe]                          # (Q, D, C, K, W)
        hit = ((pres & allowed[..., None, :]) != 0).any(-1)  # (Q, D, C, K)
        if bounds is not None:
            lo, hi = bounds[..., 0], bounds[..., 1]          # (Q, D, C)
            cmin = self.code_min[fsafe]                      # (Q, D, C, K)
            cmax = self.code_max[fsafe]
            overlap = (cmin <= hi[..., None]) & (cmax >= lo[..., None])
            hit = torch.where((lo <= hi)[..., None], overlap, hit)
        conj = torch.where((fields >= 0)[..., None], hit, True).all(dim=2)
        alive = fields[:, :, 0] > DEAD_DISJUNCT              # (Q, D)
        return conj & alive[:, :, None]

    def _matched_counts(self, passes: torch.Tensor
                        ) -> tuple[torch.Tensor, torch.Tensor]:
        """passes (Q, n) bool -> (counts (Q, K) of matching points per
        cluster, per-point within-cluster matched rank (Q, n) in id order,
        for the member-cap cutoff)."""
        q_n = passes.shape[0]
        p_int = passes.to(torch.int64)
        cnt = torch.zeros((q_n, self.n_clusters), dtype=torch.int64,
                          device=passes.device).index_add_(1, self.assign,
                                                           p_int)
        p_csr = p_int[:, self.csr_pts]                        # (Q, n) csr order
        inc0 = torch.nn.functional.pad(torch.cumsum(p_csr, dim=1), (1, 0))
        starts = self.csr_offsets[self.assign[self.csr_pts]]  # (n,)
        rank_csr = inc0[:, :-1] - inc0[:, starts]
        return cnt, rank_csr[:, self.inv_perm]

    def select_anchors_batch(
        self, q_vecs: torch.Tensor, clause_tables: tuple,
        processed: torch.Tensor, vectors: torch.Tensor,
        passes: torch.Tensor, *, n_seeds: int = 10, c_max: int = 5,
        member_cap: int = MEMBER_CAP, backend: str = "sort",
        disjunct_quota: int = 2,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """One anchor-selection round for Q queries (Alg. 2 lines 3–14,
        batched). Exact host semantics: rank matching unprocessed clusters
        by centroid score, scan until the seed budget fills or c_max
        clusters yield, take the nearest matching members of each visited
        cluster (quota = remaining budget), consume every scanned cluster.

        q_vecs (Q, d); clause_tables from ``pack_predicates``/``pack_dnf``
        as int32 tensors; processed (Q, K) bool; vectors (n, d); passes
        (Q, n) bool. Returns (seeds (Q, n_seeds) i32 -1-padded, used (Q, K)
        bool to OR into ``processed``).

        Disjunctive (Q, D, C) tables add a minimum per-disjunct quota
        (``disjunct_quota`` seeds): each *starved* live disjunct — one with
        an available matching cluster but none visited this round — gets
        its best-scoring cluster force-visited and up to
        ``disjunct_quota`` nearest passing members spliced into the seed
        set (displacing tail main seeds)."""
        fields, allowed = clause_tables[0], clause_tables[1]
        bounds = clause_tables[2] if len(clause_tables) > 2 else None
        if allowed.shape[-1] != self.presence.shape[-1]:
            raise ValueError(
                f"clause tables packed for {32 * allowed.shape[-1]} codes "
                f"but atlas v_cap is {self.v_cap}; pack_predicates with "
                f"v_cap=atlas.v_cap")
        q_n, k = q_vecs.shape[0], self.n_clusters
        n = vectors.shape[0]
        n_seeds = min(n_seeds, n)

        # one presence expansion per round: the pre-union (Q, D, K) masks
        # feed both the availability union and the disjunct-quota repair
        dmasks = (self._disjunct_cluster_masks(fields, allowed, bounds)
                  if fields.ndim == 3 else None)
        match = (dmasks.any(dim=1) if dmasks is not None
                 else self.matching_clusters_batch(fields, allowed))
        avail = match & ~processed
        scores = q_vecs @ self.centroids.T                    # (Q, K)
        order = torch.argsort(-torch.where(avail, scores, NEG), dim=1,
                              stable=True)

        cnt, rank_id = self._matched_counts(passes)
        cnt = cnt.clamp(max=member_cap)

        # scan ranked clusters with exclusive cumsums: a cluster is visited
        # iff neither stop condition held when its turn came; monotone
        # cumsums make the all-available prefix equal the visited prefix.
        avail_r = avail.gather(1, order)
        cnt_r = cnt.gather(1, order) * avail_r
        yld_r = (cnt_r > 0).to(torch.int64)
        visited_r = (avail_r & (_excl_cumsum(cnt_r) < n_seeds)
                     & (_excl_cumsum(yld_r) < c_max))
        used = torch.zeros((q_n, k), dtype=torch.bool,
                           device=q_vecs.device).scatter(1, order, visited_r)

        elig = passes & used[:, self.assign] & (rank_id < member_cap)
        # one dense (Q, n) score sweep shared by the seed backends and the
        # disjunct-quota repair; on CUDA the topk backend replaces it with
        # masked_cosine_topk kernel calls, one per slot and per disjunct
        sims = (None if backend == "topk" and vectors.is_cuda
                else q_vecs @ vectors.T)
        if backend == "sort":
            seeds = self._seed_by_sort(sims, elig, order, n_seeds)
        elif backend == "topk":
            seeds = self._seed_by_topk(q_vecs, vectors, sims, elig, order,
                                       cnt_r, visited_r, yld_r, n_seeds,
                                       c_max)
        else:
            raise ValueError(f"unknown seed backend {backend!r}")
        if dmasks is not None and disjunct_quota > 0:
            seeds, used = self._apply_disjunct_quota(
                q_vecs, dmasks, processed, vectors, sims, passes,
                rank_id, scores, used, seeds,
                n_seeds=n_seeds, member_cap=member_cap,
                quota=min(disjunct_quota, n_seeds))
        return seeds, used

    def _apply_disjunct_quota(self, q_vecs, dmasks, processed,
                              vectors, sims, passes, rank_id, scores, used,
                              seeds,
                              *, n_seeds: int, member_cap: int, quota: int):
        """Starved-disjunct repair: force-visit each starved live
        disjunct's best available cluster and splice up to ``quota`` of its
        nearest passing members into the seed set (deduped against the
        main seeds, quota entries winning the truncation to n_seeds).

        The reference gates the per-disjunct top-k sweeps with a
        ``lax.cond`` on "any disjunct starved"; here both sides are
        computed and one is selected on the device (no host sync), which
        is the same function. Where ``sims`` is None (the topk backend on
        CUDA) each disjunct's sweep is a ``masked_cosine_topk`` kernel
        call over its one-cluster mask, so no dense (Q, n) product is
        formed; the mask is empty for lanes that are not starved."""
        q_n, k = used.shape
        n = vectors.shape[0]
        d_tab = dmasks.shape[1]
        dev = q_vecs.device
        dmask = dmasks & ~processed[:, None, :]              # (Q, D, K)
        best_c = torch.argmax(torch.where(dmask, scores[:, None, :], NEG),
                              dim=2)                          # (Q, D)
        starved = dmask.any(dim=2) & ~(dmask & used[:, None, :]).any(dim=2)
        used = used | (starved[:, :, None]
                       & (torch.arange(k, device=dev)[None, None, :]
                          == best_c[..., None])).any(dim=1)

        big = d_tab * quota + n_seeds
        pos = torch.arange(quota, device=dev)[None, :]
        q_ids, q_keys = [], []
        for dj in range(d_tab):
            m = (passes & starved[:, dj, None]
                 & (self.assign[None, :] == best_c[:, dj, None])
                 & (rank_id < member_cap))
            if sims is None:
                s_j, ids_j = ops.masked_cosine_topk(q_vecs, vectors,
                                                    pack_bits(m), quota)
            else:
                s_j, ids_j = top_k(torch.where(m, sims, float("-inf")), quota)
            ok = torch.isfinite(s_j)
            q_ids.append(torch.where(ok, ids_j.to(torch.int64), -1))
            q_keys.append(torch.where(ok, dj * quota + pos, big))
        # merge: quota entries carry keys < main entries; dedup by id via a
        # lexicographic (id, key) sort, then re-sort by key and truncate to
        # the seed budget
        main_pos = torch.arange(n_seeds, device=dev)[None, :]
        all_ids = torch.cat(q_ids + [seeds.to(torch.int64)], dim=1)
        all_keys = torch.cat(
            q_keys + [torch.where(seeds >= 0, d_tab * quota + main_pos,
                                  big)], dim=1)
        sort_ids = torch.where(all_keys < big, all_ids, n)   # invalid last
        perm = _lexsort(sort_ids, all_keys)
        ids_s, keys_s = sort_ids.gather(1, perm), all_keys.gather(1, perm)
        dup = torch.cat(
            [torch.zeros((q_n, 1), dtype=torch.bool, device=dev),
             ids_s[:, 1:] == ids_s[:, :-1]], dim=1) & (ids_s < n)
        keys_f = torch.where(dup | (ids_s >= n), big, keys_s)
        perm = torch.argsort(keys_f, dim=1, stable=True)
        keys_o, ids_o = keys_f.gather(1, perm), ids_s.gather(1, perm)
        quota_seeds = torch.where(keys_o[:, :n_seeds] < big,
                                  ids_o[:, :n_seeds], -1).to(torch.int32)
        return torch.where(starved.any(), quota_seeds, seeds), used

    def _seed_by_sort(self, sims, elig, order, n_seeds: int):
        """Quota fill via one lexicographic sort: ordering every eligible
        point by (its cluster's rank, cosine distance) and taking the first
        n_seeds reproduces the host's cluster-by-cluster nearest-first fill,
        including the final cluster's truncated quota."""
        q_n, k = order.shape
        ranks = torch.arange(k, device=order.device).expand(q_n, k)
        cluster_rank = torch.zeros_like(order).scatter(1, order, ranks)
        key1 = torch.where(elig, cluster_rank[:, self.assign], k)
        key2 = torch.where(elig, -sims, float("inf"))
        ids = _lexsort(key1, key2)
        k1s = key1.gather(1, ids)
        return torch.where(k1s[:, :n_seeds] < k, ids[:, :n_seeds],
                           -1).to(torch.int32)

    def _seed_by_topk(self, q_vecs, vectors, sims, elig, order, cnt_r,
                      visited_r, yld_r, n_seeds: int, c_max: int):
        """Quota fill via masked cosine top-k: one top-k per
        yielding-cluster slot (≤ c_max) over the corpus with the filter
        bitmap restricted to that slot's cluster. On CUDA each slot is a
        ``masked_cosine_topk`` kernel call (``sims`` is None); on the CPU
        the slots share the caller's dense score product."""
        q_n = q_vecs.shape[0]
        dev = q_vecs.device
        # slot j (yield order) -> cluster id and its matched count
        slot_pos = torch.where(visited_r & (yld_r > 0), _excl_cumsum(yld_r),
                               c_max)
        init = torch.full((q_n, c_max + 1), -1, dtype=torch.int64, device=dev)
        slot_cluster = init.scatter(1, slot_pos, order)[:, :c_max]
        slot_cnt = torch.zeros((q_n, c_max + 1), dtype=torch.int64,
                               device=dev).scatter(1, slot_pos,
                                                   cnt_r)[:, :c_max]
        take = torch.minimum((n_seeds - _excl_cumsum(slot_cnt)).clamp(min=0),
                             slot_cnt)
        all_keys, all_ids = [], []
        pos = torch.arange(n_seeds, device=dev)[None, :]
        for j in range(c_max):
            mask = elig & (self.assign[None, :] == slot_cluster[:, j, None])
            if sims is None:
                _, ids_j = ops.masked_cosine_topk(q_vecs, vectors,
                                                  pack_bits(mask), n_seeds)
            else:
                s_j, ids_j = top_k(torch.where(mask, sims, float("-inf")),
                                   n_seeds)
                ids_j = torch.where(torch.isfinite(s_j), ids_j, -1)
            keep = pos < take[:, j, None]
            all_keys.append(torch.where(keep, j * n_seeds + pos,
                                        c_max * n_seeds))
            all_ids.append(torch.where(keep, ids_j.to(torch.int64), -1))
        keys = torch.cat(all_keys, dim=1)
        ids = torch.cat(all_ids, dim=1)
        perm = torch.argsort(keys, dim=1, stable=True)
        ks, ids_s = keys.gather(1, perm), ids.gather(1, perm)
        return torch.where(ks[:, :n_seeds] < c_max * n_seeds,
                           ids_s[:, :n_seeds], -1).to(torch.int32)
