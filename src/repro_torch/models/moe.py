"""Mixture-of-Experts FFN: top-k token choice, softmax combine over the
chosen experts, deterministic capacity drop; on one device or with the
experts split over a mesh's ``model`` axis (expert parallelism).

The reference runs two paths over its ``model`` mesh axis
(``src/repro/models/moe.py``), and so does the port on a mesh
(``moe_ffn(..., mesh)``, or ``moe_cell`` inside a model's cell pass):

* ``train``/``prefill`` (``_moe_a2a``): the tokens split by batch block
  over the data axes and sequence block over ``model``; each cell routes
  its own, deals the (token, choice) rows into capacity-bounded buckets
  by destination expert shard (``cap_s``, from its own slice), ships them
  with an all_to_all, regroups what it received by local expert
  (``cap_e``, from the rows received, in source-cell order), runs its
  experts and ships the outputs home with a second all_to_all. So which
  token is dropped depends on the mesh's shape, and a mesh pass is held
  to the reference's on the same shape.
* ``decode``, or where the batch or sequence does not split
  (``_moe_replicated``): every model cell sees every token of its batch
  block, runs its local experts densely masked, and a psum combines.
  Dropless.

On one device (``mesh=None``) the same two cell bodies run as a mesh of
one cell (``ONE_CELL``, whose collectives return their input): rows are
bucketed by a stable sort into capacity-bounded buckets, first come
first kept, the capacity factor applied twice, as there. So a token can
be dropped because of what else is in its batch.

The expert products take the fp32 master weights as they are (the
reference passes them uncast, so jnp promotes the bf16 rows to fp32);
the router casts its weight to the activations' dtype.
"""
from __future__ import annotations

import dataclasses
from types import SimpleNamespace

import torch
import torch.nn.functional as F

from repro_torch.launch.placement import (NamedSharding, P, Sharded, fit,
                                          gather, place, run_cells)


@dataclasses.dataclass(frozen=True)
class MoEDims:
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25


def _route(x: torch.Tensor, w_router: torch.Tensor, dims: MoEDims):
    """Returns (expert ids (T, k), combine weights (T, k) fp32). The
    logits are formed in ``x.dtype`` and then cast, so bf16 ties are
    common; a stable descending sort takes the lower expert id first, as
    ``lax.top_k`` does (``torch.topk`` promises no order among ties)."""
    logits = (x @ w_router.to(x.dtype)).float()
    top_logits, top_ids = torch.sort(logits, dim=-1, descending=True,
                                     stable=True)
    top_logits, top_ids = top_logits[:, :dims.top_k], top_ids[:, :dims.top_k]
    return top_ids, torch.softmax(top_logits, dim=-1)


def _grouped_ffn(xe: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor,
                 w2: torch.Tensor) -> torch.Tensor:
    """xe: (E, C, d); per-expert SwiGLU as batched products in the
    promoted dtype of ``xe`` and the weights (fp32 for bf16 rows and fp32
    masters, as jnp promotes), the SiLU rounded to ``xe.dtype`` as
    there."""
    dt = torch.promote_types(xe.dtype, w1.dtype)
    xp = xe.to(dt)
    g = torch.bmm(xp, w1.to(dt))
    u = torch.bmm(xp, w3.to(dt))
    h = F.silu(g.float()).to(xe.dtype) * u
    return torch.bmm(h.to(dt), w2.to(dt))


def _slots(dest: torch.Tensor, n_buckets: int, cap: int):
    """Each row's (bucket, slot) when rows are dealt into ``n_buckets``
    buckets of ``cap`` slots by ``dest`` (T,), first come first kept (a
    stable sort by bucket); -1 for overflow and ``dest < 0`` rows."""
    T = dest.shape[0]
    dev = dest.device
    destx = torch.where(dest < 0, n_buckets, dest)
    order = torch.argsort(destx, stable=True)
    sd = destx[order]
    start = torch.searchsorted(sd, torch.arange(n_buckets, device=dev))
    slot_sorted = (torch.arange(T, device=dev)
                   - start[sd.clamp(0, n_buckets - 1)])
    keep = (slot_sorted < cap) & (sd < n_buckets)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(T, device=dev)
    return (torch.where(keep, sd, -1)[inv],
            torch.where(keep, slot_sorted, -1)[inv])


def _fill_buckets(x: torch.Tensor, dest: torch.Tensor, n_buckets: int,
                  cap: int, fill_value=0):
    """Scatter rows of x (T, ...) into (n_buckets, cap, ...) by ``dest``
    (``_slots``). Also returns each row's bucket and slot (-1 where
    dropped)."""
    row_bucket, row_slot = _slots(dest, n_buckets, cap)
    flat = _scatter_rows(x, torch.where(row_bucket >= 0,
                                        row_bucket * cap + row_slot, -1),
                         n_buckets * cap, fill_value)
    return (flat.reshape((n_buckets, cap) + tuple(x.shape[1:])), row_bucket,
            row_slot)


def _scatter_rows(x: torch.Tensor, dest: torch.Tensor, n: int,
                  fill_value=0) -> torch.Tensor:
    """(n, ...) rows of ``fill_value`` with row ``dest[i]`` set to
    ``x[i]``; a row with ``dest < 0`` goes to one spare row past the end,
    cut off after. No boolean mask selects the kept rows, so no shape
    depends on the data (the dry-run traces this on the meta device, and
    on the card no launch waits for a row count)."""
    out = torch.full((n + 1,) + tuple(x.shape[1:]), fill_value,
                     dtype=x.dtype, device=x.device)
    out[torch.where(dest >= 0, dest, n)] = x
    return out[:n]


class _OneCell:
    """The collectives of a mesh of one cell: a group of one, so each
    returns its input. ``mesh=None`` runs the cell bodies through it."""

    def size(self, entry) -> int:
        return 1

    def block(self, entry) -> int:
        return 0

    def psum(self, x, entry):
        return x

    def all_to_all(self, x, axis):
        return x


ONE_CELL = _OneCell()


def _dispatch(top_ids: torch.Tensor, dims: MoEDims, cell=ONE_CELL,
              model_axis: str = "model"):
    """The capacity path's two bucketings, as the reference's
    ``_moe_a2a`` makes them: the cell's T·k (token, choice) rows into
    one bucket of ``cap_s`` slots for each expert cell (``cap_s`` from
    the cell's own rows), shipped by an all_to_all over ``model_axis``;
    then the slots received, in source-cell order, into buckets of
    ``cap_e`` for each local expert. Returns ``cap_e``, each row's slot
    in the send buffer (n_model·cap_s, flat), each received slot's local
    expert, and each received slot's expert bucket and slot in it (-1
    where dropped or empty)."""
    n_model, shard = cell.size(model_axis), cell.block(model_axis)
    E_loc, cf = dims.n_experts // n_model, dims.capacity_factor
    flat_e = top_ids.reshape(-1)
    cap_s = int((top_ids.shape[0] * dims.top_k // n_model) * cf) + 1
    be, rb, rs = _fill_buckets(flat_e, torch.div(
        flat_e, E_loc, rounding_mode="floor"), n_model, cap_s, fill_value=-1)
    slot_e = cell.all_to_all(be, model_axis).reshape(-1)
    slot_e = torch.where(slot_e >= 0, slot_e - shard * E_loc, -1)
    cap_e = int(slot_e.shape[0] // E_loc * cf) + 1
    return ((cap_e, torch.where(rb >= 0, rb * cap_s + rs, -1), slot_e)
            + _slots(slot_e, E_loc, cap_e))


def moe_ffn(x: torch.Tensor, params, dims: MoEDims, mesh=None,
            model_axis: str = "model", data_axes=("data",),
            mode: str = "train") -> torch.Tensor:
    """x: (B, S, d). Returns the same shape and dtype. ``params`` holds
    ``router`` (d, E), ``w1``/``w3`` (E, d, f) and ``w2`` (E, f, d).
    With a ``mesh`` (more than one cell), ``x`` is placed with its batch
    over ``data_axes``, the experts split over ``model_axis``, every cell
    runs ``moe_cell`` and the result is gathered on the first cell."""
    if mesh is None or mesh.devices.size == 1:
        body = _replicated_local if mode == "decode" else _a2a_local
        return body(x, params.router, params.w1, params.w3, params.w2, dims,
                    ONE_CELL, model_axis, dims.n_experts)
    spec = fit(mesh, P(tuple(data_axes)), x.shape)
    xs = place(x, NamedSharding(mesh, spec))
    placed = {n: place(getattr(params, n), NamedSharding(
        mesh, P() if n == "router" else P(model_axis)))
        for n in ("router", "w1", "w3", "w2")}

    def cell_fn(cell):
        local = SimpleNamespace(**{n: leaf.local(cell)
                                   for n, leaf in placed.items()})
        return moe_cell(xs.local(cell), local, dims, cell, spec, x.shape,
                        model_axis, data_axes, mode)

    ys = run_cells(mesh, cell_fn)
    return gather(Sharded(NamedSharding(mesh, spec), x.shape, x.dtype, ys))


def _local_experts(params, E: int, n_model: int, shard: int):
    """This model cell's E / n_model experts: the leaves as they are where
    they are already split, else its block of the whole ones (under the
    "dp" policy every cell holds every expert, and the MoE still splits
    them)."""
    if E % n_model:
        raise ValueError(f"{E} experts do not split over {n_model} model "
                         f"cells")
    E_loc = E // n_model
    w1, w3, w2 = params.w1, params.w3, params.w2
    if w1.shape[0] == E and E_loc != E:
        lo = shard * E_loc
        w1, w3, w2 = (w[lo:lo + E_loc] for w in (w1, w3, w2))
    return E_loc, w1, w3, w2


def moe_cell(x: torch.Tensor, params, dims: MoEDims, cell, spec, shape,
             model_axis: str = "model", data_axes=("data",),
             mode: str = "train") -> torch.Tensor:
    """One cell's MoE: ``x`` its block, laid out by ``spec``, of the
    (B, S, d) tokens of ``shape``; ``params`` its router and experts
    (split or whole). Runs the reference's dispatch rule on the global
    shape (``_moe_replicated`` for decode or where the batch or the
    sequence does not split, else ``_moe_a2a``) and returns this cell's
    block of the output, laid out as ``x`` was."""
    B, S, _ = shape
    n_model = cell.size(model_axis)
    n_data = cell.size(tuple(data_axes))
    E_loc, w1, w3, w2 = _local_experts(params, dims.n_experts, n_model,
                                       cell.block(model_axis))
    if mode == "decode" or S % n_model or B % n_data:
        # tokens replicated over the model axis (the batch over the data
        # axes where it splits)
        mine = fit(cell.mesh, P(tuple(data_axes)), shape)
        xb = cell.relayout(x, spec, mine)
        y = _replicated_local(xb, params.router, w1, w3, w2, dims, cell,
                              model_axis, E_loc)
    else:
        mine = P(tuple(data_axes), model_axis)  # batch x sequence blocks
        xb = cell.relayout(x, spec, mine)
        y = _a2a_local(xb, params.router, w1, w3, w2, dims, cell, model_axis,
                       E_loc)
    return cell.relayout(y, mine, spec)


def _a2a_local(xb, w_router, w1, w3, w2, dims: MoEDims, cell,
               model_axis: str, E_loc: int):
    """The reference's ``_moe_a2a`` body on one cell: xb (B_loc, S_loc,
    d) is exactly this cell's tokens. Routes them, ships the kept
    (token, choice) rows to their expert cells (``_dispatch``), runs the
    local experts and ships the outputs home, combined in fp32."""
    d = xb.shape[-1]
    n_model = cell.size(model_axis)
    xt = xb.reshape(-1, d)
    T_loc, k = xt.shape[0], dims.top_k
    top_ids, weights = _route(xt, w_router, dims)
    cap_e, row_slot, slot_e, eb, es = _dispatch(top_ids, dims, cell,
                                                model_axis)
    bx = _scatter_rows(xt.repeat_interleave(k, dim=0), row_slot,
                       slot_e.shape[0])
    rx = cell.all_to_all(bx.reshape(n_model, -1, d), model_axis)
    ex = _scatter_rows(rx.reshape(-1, d),
                       torch.where(eb >= 0, eb * cap_e + es, -1),
                       E_loc * cap_e).reshape(E_loc, cap_e, d)
    ey = _grouped_ffn(ex, w1, w3, w2)
    ry = torch.where((eb >= 0)[:, None],
                     ey[eb.clamp(min=0), es.clamp(min=0)], 0)
    back = cell.all_to_all(ry.reshape(n_model, -1, d),
                           model_axis).reshape(-1, d)
    y_flat = torch.where((row_slot >= 0)[:, None],
                         back[row_slot.clamp(min=0)], 0)
    y = (y_flat.reshape(T_loc, k, d).float() * weights[..., None]).sum(dim=1)
    return y.to(xb.dtype).reshape(xb.shape)


def _replicated_local(xb, w_router, w1, w3, w2, dims: MoEDims, cell,
                      model_axis: str, E_loc: int):
    """The reference's ``_moe_replicated`` body on one cell: its E_loc
    experts over every token of ``xb``, densely masked by the one-hot
    routing (few tokens, so (E_loc, T, d) is cheap), then a psum over the
    model axis. Dropless. The one-hot is built by a comparison (a choice
    of another cell's expert matches no local id), so no shape depends
    on the data."""
    d = xb.shape[-1]
    xt = xb.reshape(-1, d)
    top_ids, weights = _route(xt, w_router, dims)
    local_ids = top_ids - cell.block(model_axis) * E_loc
    oh = (local_ids[..., None] == torch.arange(
        E_loc, device=xt.device)).to(xt.dtype)            # (T, k, E_loc)
    xe = torch.einsum("td,tke->etd", xt, oh)
    ye = _grouped_ffn(xe, w1, w3, w2)                     # (E_loc, T, d)
    y = torch.einsum("etd,tke,tk->td", ye.float(), oh.float(), weights)
    y = cell.psum(y, model_axis)
    return y.reshape(xb.shape).to(xb.dtype)
