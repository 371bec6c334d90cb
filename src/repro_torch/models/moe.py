"""Mixture-of-Experts FFN on one device: top-k token choice, softmax
combine over the chosen experts, deterministic capacity drop.

The reference runs two paths over its ``model`` mesh axis
(``src/repro/models/moe.py``); on one device (``n_model = 1``) each keeps
its semantics and loses its collectives:

* ``train``/``prefill`` (``_moe_a2a``): rows are bucketed by a stable sort
  into capacity-bounded buckets, first come first kept. The capacity
  factor applies twice, as there: once to the destination-shard bucket
  (``cap_s``) and once to the per-expert bucket cut from it (``cap_e``).
  So a token can be dropped because of what else is in its batch.
* ``decode`` (``_moe_replicated``): every expert runs densely masked over
  every token; dropless.

The expert products take the fp32 master weights as they are (the
reference passes them uncast, so jnp promotes the bf16 rows to fp32);
the router casts its weight to the activations' dtype. The all_to_all and
psum of the multi-GPU path wait for ROADMAP queue 1 item 5.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F


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


def _dispatch(top_ids: torch.Tensor, dims: MoEDims):
    """The capacity path's two bucketings, as the reference's
    ``_moe_a2a`` makes them with one model shard: the T·k (token, choice)
    rows into the shard's one bucket of ``cap_s`` slots, then those
    slots into per-expert buckets of ``cap_e``. Returns ``cap_e``, each
    row's shard slot, each shard slot's expert, and each shard slot's
    expert bucket and slot in it (-1 where dropped or empty)."""
    E, cf = dims.n_experts, dims.capacity_factor
    flat_e = top_ids.reshape(-1)
    cap_s = int(flat_e.shape[0] * cf) + 1
    slot_e, _, row_slot = _fill_buckets(flat_e[:, None],
                                        torch.zeros_like(flat_e), 1, cap_s,
                                        fill_value=-1)
    slot_e = slot_e.reshape(-1)
    cap_e = int(cap_s // E * cf) + 1
    return (cap_e, row_slot, slot_e) + _slots(slot_e, E, cap_e)


def moe_ffn(x: torch.Tensor, params, dims: MoEDims,
            mode: str = "train") -> torch.Tensor:
    """x: (B, S, d). Returns the same shape and dtype. ``params`` holds
    ``router`` (d, E), ``w1``/``w3`` (E, d, f) and ``w2`` (E, f, d)."""
    if mode == "decode":
        return _moe_replicated(x, params, dims)
    return _moe_capacity(x, params, dims)


def _moe_capacity(x, params, dims: MoEDims):
    """The reference's ``_moe_a2a`` on one shard: route, bucket with
    capacity drops, grouped FFN, gather back and combine in fp32."""
    B, S, d = x.shape
    xt = x.reshape(-1, d)
    T, k = xt.shape[0], dims.top_k
    top_ids, weights = _route(xt, params.router, dims)
    cap_e, row_slot, slot_e, eb, es = _dispatch(top_ids, dims)
    kept = row_slot >= 0
    slot_x = _scatter_rows(xt.repeat_interleave(k, dim=0), row_slot,
                           slot_e.shape[0])
    valid = eb >= 0
    ex = _scatter_rows(slot_x, torch.where(valid, eb * cap_e + es, -1),
                       dims.n_experts * cap_e).reshape(dims.n_experts, cap_e,
                                                       d)
    ey = _grouped_ffn(ex, params.w1, params.w3, params.w2)
    slot_y = torch.where(valid[:, None],
                         ey[eb.clamp(min=0), es.clamp(min=0)], 0)
    y_flat = torch.where(kept[:, None], slot_y[row_slot.clamp(min=0)], 0)
    y = (y_flat.reshape(T, k, d).float() * weights[..., None]).sum(dim=1)
    return y.to(x.dtype).reshape(B, S, d)


def _moe_replicated(x, params, dims: MoEDims):
    """Decode: every expert's SwiGLU over every token, masked by the
    one-hot routing (few tokens, so (E, T, d) is cheap); dropless."""
    B, S, d = x.shape
    xt = x.reshape(-1, d)
    top_ids, weights = _route(xt, params.router, dims)
    oh = (top_ids[..., None] == torch.arange(
        dims.n_experts, device=x.device)).to(xt.dtype)      # (T, k, E)
    xe = torch.einsum("td,tke->etd", xt, oh)
    ye = _grouped_ffn(xe, params.w1, params.w3, params.w2)  # (E, T, d)
    y = torch.einsum("etd,tke,tk->td", ye.float(), oh.float(), weights)
    return y.to(x.dtype).reshape(B, S, d)
