"""Placement on a device mesh: the sharded search index's, and the LM's
parameters, batches and decode caches (DESIGN.md §5, §7, §13).

The reference's functions return ``NamedSharding``s of
``jax.sharding``; the port's return ``launch.placement.NamedSharding``s
of its own mesh with the same specs, leaf for leaf, which
``placement.place`` turns into each cell's block. The LM's policy (the
reference's): TP over ``model`` for attention heads, FFN hidden, MoE
expert dim and unembed vocab; DP over (``pod``, ``data``) for batch dims.
Tensors whose natural axis is not divisible by the TP degree fall back to
replication on that axis (e.g. smollm 9 heads, gemma3 kv=1), recorded
rather than padded.

The sharded index's placement (``index_shardings``) is said directly:
which cell holds which row shard for which lane, and which block of the
batch a lane takes. Cells of any other axis (``model`` when it carries no
lanes) would hold replicas that compute the same result; the port runs
the first of them only.

The optimizer state's (``opt_shardings``): ``m`` and ``v`` mirror the
parameters' specs and ``step`` is replicated; ZeRO-1 adds the data axes
on the first free dim they divide (``_zero1_spec``). On the reference's
stacked layout that dim is often the layer dim L; the port's per-layer
leaves have none, so a layer's ``m``/``v`` then sit whole on the data
block that holds that layer in the reference's layout (``NamedSharding.
stack``), and their spec is the rest of the stacked one.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.configs.base import ArchConfig
from repro_torch.launch.mesh import data_axis_names, index_axis_size
from repro_torch.launch.placement import NamedSharding, P, map_with_path


def _div(n: int, by: int) -> bool:
    return by > 0 and n % by == 0


def _path_names(path) -> list[str]:
    """A leaf's path as names: dict keys, list indices as strings (also
    the keys and indices of jax's path entries)."""
    out = []
    for p in path:
        if hasattr(p, "key"):
            out.append(str(p.key))
        elif hasattr(p, "idx"):
            out.append(str(p.idx))
        else:
            out.append(str(p))
    return out


def _stacked(names: list[str]) -> bool:
    """A leaf of the reference's layer stack (leading L dim): under
    ``layers``/``enc_layers`` with no layer index after it (the port's
    modules hold one tree a layer, whose paths carry the index)."""
    return any(n in ("layers", "enc_layers")
               and not (i + 1 < len(names) and names[i + 1].isdigit())
               for i, n in enumerate(names))


def param_pspec(path, leaf, cfg: ArchConfig, n_model: int) -> P:
    """The reference's spec of a parameter leaf; for a leaf of one layer
    (the port's layout), the same spec without the stack's leading
    None."""
    names = _path_names(path)
    name = names[-1] if names else ""
    lead = (None,) if _stacked(names) else ()
    shape = leaf.shape
    in_attn = any(n in ("attn", "cross") for n in names)
    H, KV = cfg.n_heads, cfg.n_kv_heads

    if name == "unembed":
        return P("model" if _div(shape[0], n_model) else None, None)
    if name == "embed":
        return P(None, None)  # replicated input table (gather stays local)
    if in_attn:
        if name == "wq":
            return P(*lead, None, "model" if _div(H, n_model) else None)
        if name in ("wk", "wv"):
            return P(*lead, None, "model" if _div(KV, n_model) else None)
        if name == "wo":
            return P(*lead, "model" if _div(H, n_model) else None, None)
    if name in ("w1", "w3", "w2"):  # MoE experts: (E, d, f)/(E, f, d)
        e_ax = len(lead)
        return P(*lead, "model" if _div(shape[e_ax], n_model) else None,
                 None, None)
    if name == "router":
        return P(*lead, None, None)
    if name in ("w_gate", "w_up", "cm_k", "in_proj", "wr", "wk", "wv", "wg",
                "x_proj"):
        last = shape[-1]
        return P(*((None,) * (len(shape) - 1)),
                 "model" if _div(last, n_model) else None)
    if name in ("w_down", "cm_v", "out_proj", "wo", "cm_r", "dt_proj"):
        first_ax = len(lead)
        return P(*lead, "model" if _div(shape[first_ax], n_model) else None,
                 *((None,) * (len(shape) - len(lead) - 1)))
    return P(*((None,) * len(shape)))  # norms, scalars, small tensors


def _tree(specs):
    """A parameter module as its tree of leaves (others as they are)."""
    return specs.tree() if hasattr(specs, "tree") else specs


def param_shardings(cfg: ArchConfig, mesh, specs, policy: str = "tp"):
    """policy="tp": tensor-parallel rules above. policy="dp": replicate all
    params (pure data parallel); "sp" keeps the TP layout (only the
    activations change, ``ShardEnv.act3``). ``specs``: a parameter tree
    (the port's per-layer layout, a ``Transformer``, or the reference's
    stacked one) of tensors or anything with a ``shape``."""
    n_model = mesh.shape["model"]
    if policy == "dp":
        return map_with_path(
            lambda _, leaf: NamedSharding(mesh, P(*((None,) *
                                                    len(leaf.shape)))),
            _tree(specs))
    return map_with_path(
        lambda path, leaf: NamedSharding(mesh, param_pspec(path, leaf, cfg,
                                                           n_model)),
        _tree(specs))


def _zero1_spec(base: P, shape, mesh) -> P:
    """Extend a param spec with the dp axes on the first divisible free
    dim (ZeRO-1: optimizer state sharded over data parallelism)."""
    dp = data_axis_names(mesh)
    n_dp = _n(mesh, dp)
    spec = list(base) + [None] * (len(shape) - len(base))
    for i, (s, cur) in enumerate(zip(shape, spec)):
        if cur is None and s % n_dp == 0 and s > 0:
            spec[i] = dp
            return P(*spec)
    return base


def _layer_of(names: list[str], cfg: ArchConfig):
    """(layer index, layers) of a leaf of the port's per-layer tree (its
    path ``layers/<i>/...`` or ``enc_layers/<i>/...``), else None."""
    for i, n in enumerate(names[:-1]):
        if n in ("layers", "enc_layers") and names[i + 1].isdigit():
            count = cfg.n_layers if n == "layers" else cfg.n_enc_layers
            return int(names[i + 1]), count
    return None


def opt_shardings(cfg: ArchConfig, mesh, opt_specs, policy: str = "tp",
                  zero1: bool = False):
    """m/v mirror the param specs; step replicated. zero1=True additionally
    shards m/v over the data axes (ZeRO-1); the parameters stay in their
    layout, and the update takes each cell's block of its gradient and
    gathers the new parameters (``optim.adamw.adamw_update``).
    ``opt_specs``: {"m", "v", "step"}, m and v parameter trees in the
    reference's stacked layout or the port's per-layer one (a module, or
    anything with shapes). A per-layer leaf gets the spec its stacked leaf
    would have without the L entry; where ZeRO-1 puts the data axes on L,
    it is held whole (by that spec) by the data block of its layer
    (``NamedSharding.stack``)."""
    n_model = mesh.shape["model"]

    def assign(path, leaf):
        names = _path_names(path)
        if names and names[0] == "step":
            return NamedSharding(mesh, P())
        shape = tuple(leaf.shape)
        base = (P(*((None,) * len(shape))) if policy == "dp"
                else param_pspec(path[1:], leaf, cfg, n_model))  # sp == tp
        if not zero1:
            return NamedSharding(mesh, base)
        layer = _layer_of(names, cfg)
        if layer is None:
            return NamedSharding(mesh, _zero1_spec(base, shape, mesh))
        li, count = layer
        spec = _zero1_spec(P(None, *base), (count,) + shape, mesh)
        if spec[0] is None:
            return NamedSharding(mesh, P(*spec[1:]))
        return NamedSharding(mesh, P(*spec[1:]), stack=(spec[0], li, count))

    return map_with_path(assign, {k: _tree(v) for k, v in opt_specs.items()})


def layer_sharding(stacked: NamedSharding, layer: int,
                   layers: int) -> NamedSharding:
    """Layer ``layer``'s sharding of a leaf stacked under L that
    ``stacked`` places (the reference's layout): the spec without its L
    entry, held by the cells whose block of L holds the layer where L is
    split (as ``opt_shardings`` gives the per-layer tree)."""
    lead, rest = (tuple(stacked.spec) + (None,))[0], stacked.spec[1:]
    if lead is None:
        return NamedSharding(stacked.mesh, P(*rest))
    return NamedSharding(stacked.mesh, P(*rest), stack=(lead, layer, layers))


def _all_axes(mesh) -> tuple:
    return tuple(mesh.axis_names)


def _n(mesh, axes) -> int:
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    return n


def batch_shardings(cfg: ArchConfig, mesh, batch_specs, policy: str = "tp"):
    """A batch's leaves split on their leading (batch) dim over the data
    axes (over every axis under "dp" where it divides), replicated where
    it does not divide."""
    dp = data_axis_names(mesh)
    n_data = _n(mesh, dp)
    full = _all_axes(mesh)
    n_full = _n(mesh, full)

    def assign(path, leaf):
        b = leaf.shape[0]
        if policy == "dp" and _div(b, n_full):
            return NamedSharding(mesh, P(full,
                                         *((None,) * (len(leaf.shape) - 1))))
        lead = dp if _div(b, n_data) else None
        return NamedSharding(mesh, P(lead,
                                     *((None,) * (len(leaf.shape) - 1))))

    return map_with_path(assign, batch_specs)


def cache_shardings(cfg: ArchConfig, mesh, cache_spec_tree):
    """A decode cache's leaves (stacked under a leading L): K/V by batch
    over the data axes and KV heads over ``model`` where they divide, by
    sequence over ``model`` where the batch does not split; the recurrent
    states by batch and their widest dim; ``pos`` replicated."""
    dp = data_axis_names(mesh)
    n_data = _n(mesh, dp)
    n_model = mesh.shape["model"]

    def assign(path, leaf):
        names = _path_names(path)
        name = names[-1] if names else ""
        if name == "pos":
            return NamedSharding(mesh, P())
        s = leaf.shape
        b_ax = dp if _div(s[1], n_data) else None
        if name in ("k", "v", "ck", "cv"):       # (L, B, S, KV, hd)
            if b_ax is not None:
                kv_ax = "model" if _div(s[3], n_model) else None
                return NamedSharding(mesh, P(None, b_ax, None, kv_ax, None))
            # batch unshardable (long_500k B=1): shard the cache sequence
            seq_ax = "model" if _div(s[2], n_model) else None
            return NamedSharding(mesh, P(None, None, seq_ax, None, None))
        if name == "ssm":                        # (L, B, d_in, N)
            return NamedSharding(mesh, P(
                None, b_ax, "model" if _div(s[2], n_model) else None, None))
        if name == "conv":                       # (L, B, 3, d_in)
            return NamedSharding(mesh, P(
                None, b_ax, None, "model" if _div(s[3], n_model) else None))
        if name == "wkv":                        # (L, B, H, N, N)
            return NamedSharding(mesh, P(
                None, b_ax, "model" if _div(s[2], n_model) else None,
                None, None))
        if name in ("shift_tm", "shift_cm"):     # (L, B, d)
            return NamedSharding(mesh, P(None, b_ax, None))
        return NamedSharding(mesh, P(*((None,) * len(s))))

    return map_with_path(assign, cache_spec_tree)


@dataclasses.dataclass(frozen=True)
class IndexShardings:
    """``rows[s, l]`` is the cell that holds row shard s and searches
    lane l's block of the query batch (``query_block``): a shard is
    replicated over the lanes, and lane l's per-shard top-ks merge on its
    lead cell ``rows[0, l]``."""

    rows: np.ndarray   # (S, L) object array of torch.device

    @property
    def n_lanes(self) -> int:
        return self.rows.shape[1]

    def query_block(self, q_n: int, lane: int) -> slice:
        """Lane ``lane``'s contiguous block of a batch of ``q_n`` queries
        (``q_n`` a multiple of the lane count, as ``shard_map`` needs)."""
        if q_n % self.n_lanes:
            raise ValueError(
                f"a batch of {q_n} queries does not split over "
                f"{self.n_lanes} lanes; pad it to a multiple first")
        b = q_n // self.n_lanes
        return slice(lane * b, (lane + 1) * b)


def index_shardings(mesh, axis: str = "data",
                    query_axis: str | None = None) -> IndexShardings:
    """Placement for the sharded search index: every corpus-row-indexed
    tensor of shard s (vectors, adjacency, metadata, global ids, validity
    bitmap, atlas leaves) on the cells at index s of ``axis``; the query
    batch split into blocks over ``query_axis`` when the mesh carries
    one, else replicated, so one lane searches the whole batch."""
    names = mesh.axis_names
    n_shards = index_axis_size(mesh, axis)
    n_lanes = int(mesh.shape[query_axis]) if query_axis is not None else 1
    rows = np.empty((n_shards, n_lanes), dtype=object)
    for s in range(n_shards):
        for lane in range(n_lanes):
            at = [0] * len(names)
            if axis in names:
                at[names.index(axis)] = s
            if query_axis is not None:
                at[names.index(query_axis)] = lane
            rows[s, lane] = mesh.devices[tuple(at)]
    return IndexShardings(rows)
