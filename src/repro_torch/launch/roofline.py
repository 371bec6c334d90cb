"""Roofline terms of one model step on one GPU, and the counter that
measures the step (DESIGN.md §6).

    compute    = FLOPs_per_chip / peak_FLOPs
    memory     = bytes_per_chip / HBM_bw
    collective = wire_bytes_per_chip / (links * link_bw)

The reference reads FLOPs and bytes from XLA's ``cost_analysis()`` and
collective bytes from the compiled HLO text. The port has neither: it
runs eagerly, one aten op at a time, so ``CostCounter`` (a
``TorchDispatchMode``) sees every op the step dispatches and tallies
them. The same count comes out on ``meta`` tensors (nothing allocated)
and on real ones. Collective wire bytes use the reference's
ring-algorithm per-device costs (``wire_bytes``), applied by the counter
to each ``_c10d_functional`` collective it sees and to each collective a
mesh cell reports (``CostCounter.collective``: ``launch/placement.py``'s
cells report theirs to the counter active in their thread); on one GPU
it sees none.

A mesh of H100s spans nodes of ``CELLS_PER_NODE`` cards (cell ``i`` on
node ``i // CELLS_PER_NODE``, the mesh's cells in row-major order): a
collective whose group stays in one node runs over NVLink, one whose
group spans nodes over the node network, priced at ``Chip.node_bw``.

The chip's constants come from ``CHIPS``, selected by the card's name
(``chip_for``); a card that matches no row raises.
"""
from __future__ import annotations

import dataclasses
import threading
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry


@dataclasses.dataclass(frozen=True)
class Chip:
    """Per-chip peaks: dense bf16 FLOP/s, HBM bytes/s, link bytes/s a
    direction and links, memory bytes, and the node network's bytes/s a
    direction a chip (0: none; every collective over the links)."""
    name: str
    peak_flops: float
    hbm_bw: float
    link_bw: float
    n_links: int
    memory_bytes: float
    node_bw: float = 0.0


# NVIDIA's H100 data sheet, dense rates (no sparsity) at the full power
# limit; NVLink 4 at 25 GB/s a link a direction. Between nodes, NVIDIA's
# DGX H100 data sheet: one 400 Gb/s ConnectX-7 port a GPU, 50 GB/s a
# direction (the PCIe row takes the same one NIC a card)
H100_SXM = Chip("H100 SXM", peak_flops=989.4e12, hbm_bw=3.35e12,
                link_bw=25e9, n_links=18, memory_bytes=80e9, node_bw=50e9)
H100_PCIE = Chip("H100 PCIe", peak_flops=756e12, hbm_bw=2.0e12,
                 link_bw=25e9, n_links=12, memory_bytes=80e9, node_bw=50e9)
CHIPS = (H100_SXM, H100_PCIE)
CELLS_PER_NODE = 8   # a DGX H100 node's cards


def chip_for(device_name: str) -> Chip:
    """The row for a ``torch.cuda.get_device_name()``: "NVIDIA H100 80GB
    HBM3" is the SXM part, "NVIDIA H100 PCIe" the PCIe one. Any other card
    (an H100 NVL, an H200, ...) raises rather than take another's peaks."""
    if "H100" in device_name and "PCIe" in device_name:
        return H100_PCIE
    if "H100" in device_name and "HBM3" in device_name:
        return H100_SXM
    raise ValueError(f"no roofline constants for {device_name!r}; known: "
                     f"{[c.name for c in CHIPS]}")


def wire_bytes(kind: str, nbytes: float, group_size: int) -> float:
    """Per-device ring-algorithm wire bytes of one collective whose
    output is ``nbytes`` over ``group_size`` devices (the reference's
    formulas):
        all-gather / all-to-all:  out_bytes * (n-1)/n
        reduce-scatter:           out_bytes * (n-1)
        all-reduce:               2 * bytes * (n-1)/n
        collective-permute:       bytes
    """
    n = group_size
    if kind in ("all-gather", "all-to-all"):
        return nbytes * (n - 1) / n
    if kind == "reduce-scatter":
        return nbytes * (n - 1)
    if kind == "all-reduce":
        return 2 * nbytes * (n - 1) / n
    if kind == "collective-permute":
        return nbytes
    raise ValueError(f"unknown collective {kind!r}")


# _c10d_functional op -> (kind, position of its group-size argument or
# None where only the group's name says it)
_COLLECTIVES = {
    "all_reduce": ("all-reduce", None),
    "all_gather_into_tensor": ("all-gather", 1),
    "reduce_scatter_tensor": ("reduce-scatter", 2),
    "all_to_all_single": ("all-to-all", None),
}


def _group_size(args, pos) -> int:
    if pos is not None:
        return int(args[pos])
    from torch.distributed.distributed_c10d import _resolve_process_group
    return _resolve_process_group(args[-1]).size()


_ACTIVE = threading.local()


def active_counter():
    """The ``CostCounter`` entered last on the calling thread and not yet
    left, None where there is none."""
    stack = getattr(_ACTIVE, "stack", None)
    return stack[-1] if stack else None


def _tensors(xs):
    for x in xs:
        if isinstance(x, torch.Tensor):
            yield x
        elif isinstance(x, (list, tuple)):
            yield from _tensors(x)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


_NO_KERNEL = {torch.ops.aten.empty.memory_format,
              torch.ops.aten.empty_strided.default,
              torch.ops.aten.empty_like.default}
# a view its schema does not mark as one (matmul's reshapes)
_UNMARKED_VIEWS = {torch.ops.aten._unsafe_view.default}
_ABSENT = object()
_PLAIN = (bool, int, float, str, torch.dtype, torch.device, torch.layout,
          torch.memory_format)


def _key_add(parts: list, x) -> bool:
    """Appends ``x``'s part of a ``_meta_key``; False where it has none."""
    if isinstance(x, torch.Tensor):
        if not x.is_meta:
            if x.device.type != "cpu" or x.dim():
                return False
            parts.append(x.item())
        parts.append((x.shape, x.stride(), x.dtype, x.is_meta))
    elif isinstance(x, (list, tuple)):
        parts.append(len(x))
        for v in x:
            if not _key_add(parts, v):
                return False
    elif x is None or isinstance(x, _PLAIN):
        parts.append(x)
    else:
        return False
    return True


def _meta_key(func, args, kwargs):
    """A hashable key of an op's call from its tensors' metadata and its
    other arguments, or None where that does not settle the outputs'
    metadata (a tensor off ``meta`` that is not a 0-dim host scalar,
    whose values might shape the output, or an argument it cannot hash).
    A 0-dim host scalar enters with its value."""
    parts = [func]
    for a in args:
        if not _key_add(parts, a):
            return None
    for k in sorted(kwargs):
        parts.append(k)
        if not _key_add(parts, kwargs[k]):
            return None
    return tuple(parts)


class CostCounter(TorchDispatchMode):
    """Counts what a step dispatches, op by op, while it is entered:

    * ``flops``: ``torch.utils.flop_counter``'s formulas (matmuls,
      convolutions, attention) for each op they cover; elementwise work
      counts no FLOPs, as in ``FlopCounterMode``;
    * ``bytes``: each op's tensor inputs read once and outputs written
      once, every op apart (eager runs unfused, so this is the same upper
      bound as HLO's "bytes accessed");
    * ``kernel_ops``: ops that launch work (views and ``empty`` do not);
    * ``peak_bytes``: the most storage the step's own new tensors held at
      once (tensors alive before it are the caller's to add);
    * collectives by kind: count and ``wire_bytes``, and the share of
      those bytes that crossed the node network (``coll_network``).

    Backward ops count too (autograd runs them under the same mode). The
    tallies are the same on ``meta`` tensors and on real ones. On
    ``meta``, where torch computes most outputs' shapes in Python (about
    0.1 ms an op), an op called again with the same metadata gets fresh
    outputs of the metadata its first call gave and adds the tallies its
    first call counted, without running its meta function or the FLOP
    formulas again: a traced layer loop repeats the same few shapes.
    Collectives are never memoized (their group is not in the key).

    A mesh cell's collective (``launch/placement.py``) is not a dispatched
    op: the cell reports it (``collective``) to the counter active in its
    thread (``active_counter``), and the ops that carry it out are not
    counted. It adds its wire bytes and its output's storage, no FLOPs,
    bytes or kernel op."""

    def __init__(self):
        super().__init__()
        self._memo: dict = {}
        self.flops = 0
        self.bytes = 0
        self.kernel_ops = 0
        self.live_bytes = 0
        self.peak_bytes = 0
        self.coll_by_kind: dict[str, float] = {}
        self.coll_counts: dict[str, int] = {}
        self.coll_network: dict[str, float] = {}
        self._seen: dict[int, weakref.ref] = {}
        # storages die on whichever thread drops them (autograd's device
        # threads in a backward on the card), and a garbage collection
        # inside ``_track`` can free one on this thread: reentrant
        self._lock = threading.RLock()

    @property
    def wire_bytes(self) -> float:
        return sum(self.coll_by_kind.values())

    @property
    def network_bytes(self) -> float:
        """The wire bytes of collectives whose group spans nodes."""
        return sum(self.coll_network.values())

    def __enter__(self):
        out = super().__enter__()
        if not hasattr(_ACTIVE, "stack"):
            _ACTIVE.stack = []
        _ACTIVE.stack.append(self)
        return out

    def __exit__(self, *exc):
        _ACTIVE.stack.pop()
        return super().__exit__(*exc)

    def collective(self, kind: str, nbytes: int, group: int, nodes: int,
                   out=None) -> None:
        """A collective of ``kind`` whose output is ``nbytes`` over a
        group of ``group`` cells on ``nodes`` nodes: its ``wire_bytes``
        (over the node network where ``nodes`` > 1); ``out``, the tensor
        it returned, is tracked as the step's own storage."""
        w = wire_bytes(kind, nbytes, group)
        with self._lock:
            self.coll_by_kind[kind] = self.coll_by_kind.get(kind, 0.0) + w
            self.coll_counts[kind] = self.coll_counts.get(kind, 0) + 1
            if nodes > 1:
                self.coll_network[kind] = (self.coll_network.get(kind, 0.0)
                                           + w)
        if out is not None:
            self._track(out)

    def _freed(self, key: int, nbytes: int) -> None:
        with self._lock:
            self._seen.pop(key, None)
            self.live_bytes -= nbytes

    def _track(self, out) -> None:
        for t in _tensors(out if isinstance(out, (list, tuple)) else (out,)):
            st = t.untyped_storage()
            key = st._cdata
            with self._lock:
                if key in self._seen:
                    continue
                n = st.nbytes()
                self._seen[key] = weakref.ref(
                    st, lambda _, k=key, n=n: self._freed(k, n))
                self.live_bytes += n
                self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.is_view or func in _UNMARKED_VIEWS:
            return func(*args, **kwargs)
        # in place writes an input's storage (nothing new to track), and a
        # collective's group is not in the key: neither is memoized
        mutable = func._schema.is_mutable
        key = (None if mutable or func.namespace == "_c10d_functional"
               else _meta_key(func, args, kwargs))
        hit = self._memo.get(key, _ABSENT) if key is not None else None
        if hit is not _ABSENT and hit is not None:
            single, metas, flops, nbytes = hit
            outs = [torch.empty_strided(shape, stride, dtype=dt,
                                        device="meta")
                    for shape, stride, dt in metas]
            out = outs[0] if single else tuple(outs)
            self._tally(func, flops, nbytes)
            self._track(out)
            return out
        out = func(*args, **kwargs)
        flops = nbytes = 0
        if func not in _NO_KERNEL:
            packet = func.overloadpacket
            if packet in flop_registry:
                flops = flop_registry[packet](*args, **kwargs, out_val=out)
            outs = out if isinstance(out, (list, tuple)) else (out,)
            nbytes = (sum(_nbytes(t) for t in _tensors(args))
                      + sum(_nbytes(t) for t in _tensors(kwargs.values()))
                      + sum(_nbytes(t) for t in _tensors(outs)))
            if func.namespace == "_c10d_functional" and \
                    packet.__name__ in _COLLECTIVES:
                kind, pos = _COLLECTIVES[packet.__name__]
                nb = sum(_nbytes(t) for t in _tensors(outs))
                w = wire_bytes(kind, nb, _group_size(args, pos))
                self.coll_by_kind[kind] = self.coll_by_kind.get(kind, 0.0) + w
                self.coll_counts[kind] = self.coll_counts.get(kind, 0) + 1
        self._tally(func, flops, nbytes)
        if key is not None and hit is _ABSENT:
            self._memo[key] = self._memo_entry(args, out, flops, nbytes)
        if not mutable:
            self._track(out)
        return out

    def _tally(self, func, flops, nbytes) -> None:
        if func not in _NO_KERNEL:
            self.flops += flops
            self.bytes += nbytes
            self.kernel_ops += 1

    @staticmethod
    def _memo_entry(args, out, flops, nbytes):
        """What a later call with the same metadata replays: the outputs'
        metadata and the tallies, or None where the outputs are not fresh
        meta tensors (a view or an input handed back), which always run."""
        single = isinstance(out, torch.Tensor)
        outs = (out,) if single else out
        ins = {t.untyped_storage()._cdata for t in _tensors(args)}
        if isinstance(outs, tuple) and all(
                isinstance(t, torch.Tensor) and t.device.type == "meta"
                and t.untyped_storage()._cdata not in ins
                and t.storage_offset() == 0 for t in outs):
            return (single, [(tuple(t.shape), t.stride(), t.dtype)
                             for t in outs], flops, nbytes)
        return None

    def costs(self) -> dict:
        return {"flops": self.flops, "bytes": self.bytes,
                "wire_bytes": self.wire_bytes,
                "coll_by_kind": dict(self.coll_by_kind),
                "coll_counts": dict(self.coll_counts),
                "coll_network": dict(self.coll_network),
                "kernel_ops": self.kernel_ops,
                "peak_bytes": self.peak_bytes}


@dataclasses.dataclass
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float
    flops_per_chip: float
    bytes_per_chip: float
    wire_bytes_per_chip: float

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)  # type: ignore[arg-type]

    @property
    def bound_time_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)


def collective_s(wire: float, chip: Chip, network: float = 0.0) -> float:
    """Seconds of ``wire`` bytes a chip, ``network`` of them over the node
    network (at ``chip.node_bw``) and the rest over its links."""
    out = (wire - network) / (chip.n_links * chip.link_bw)
    return out + (network / chip.node_bw if network else 0.0)


def roofline_terms(flops_per_chip: float, bytes_per_chip: float,
                   wire_bytes_per_chip: float,
                   chip: Chip = H100_SXM,
                   network_bytes: float = 0.0) -> RooflineTerms:
    return RooflineTerms(
        compute_s=flops_per_chip / chip.peak_flops,
        memory_s=bytes_per_chip / chip.hbm_bw,
        collective_s=collective_s(wire_bytes_per_chip, chip, network_bytes),
        flops_per_chip=flops_per_chip,
        bytes_per_chip=bytes_per_chip,
        wire_bytes_per_chip=wire_bytes_per_chip,
    )


def model_flops(cfg, spec, n_tokens: int | None = None) -> float:
    """MODEL_FLOPS = 6·N(_active)·D for the step's token count."""
    from repro_torch.configs.base import model_flops_per_token
    if n_tokens is None:
        if spec.kind == "train":
            n_tokens = spec.global_batch * spec.seq_len
        elif spec.kind == "prefill":
            n_tokens = spec.global_batch * spec.seq_len
        else:  # decode: one token per sequence
            n_tokens = spec.global_batch
    f = model_flops_per_token(cfg) * n_tokens
    if spec.kind == "train":
        return f  # 6ND already counts fwd+bwd
    return f / 3.0  # forward-only: 2ND


# ---------------------------------------------------------------------------
# Analytic minimum HBM traffic (lower bound; the counter's bytes are an
# upper bound that counts every unfused operand). True traffic lies in
# between; the report takes the dominant-term call from (compute,
# memory_lower, collective) with memory_upper as diagnostic.
# ---------------------------------------------------------------------------

def analytic_hbm_bytes(cfg, spec, n_chips: int, tp: int = 16) -> float:
    """Per-chip minimum HBM bytes for one step (the reference's model,
    with its ``n_chips``/``tp`` split; one GPU is ``n_chips=1, tp=1``).

    Model: params stream once per pass (fwd + bwd + remat-fwd for train);
    optimizer state read+write fp32 (train); layer-boundary residual
    activations write+read with a 2x intra-layer spill allowance; decode adds
    KV-cache/state streaming; embeddings stream only the gathered rows.
    """
    d = cfg.d_model
    L = cfg.n_layers + (cfg.n_enc_layers or 0)
    N_total = cfg.param_count()
    N_active = cfg.param_count(active_only=True)
    emb_params = 2 * cfg.vocab_size * d
    body = max(N_total - emb_params, 1)
    body_active = max(N_active - emb_params, 1)
    kind = spec.kind
    B, S = spec.global_batch, spec.seq_len
    dp = n_chips // tp
    tokens_loc = (B * S) / dp if kind != "decode" else B / dp
    if B < dp:
        tokens_loc = (B * S) if kind != "decode" else B  # unsharded batch

    if kind == "train":
        p_bytes = body / tp * 4
        param_traffic = 3 * p_bytes            # fwd + bwd + remat re-read
        opt_traffic = 4 * (body / tp) * 4 * 2  # m,v read+write fp32 + grads
        act = 4 * L * tokens_loc * d * 2       # boundaries w+r, 2x spill
        vocab_t = tokens_loc * d * 2 * 4       # embed rows + logits stream
        return param_traffic + opt_traffic + act + vocab_t
    if kind == "prefill":
        p_bytes = body_active / tp * 2         # bf16 serving weights
        act = 2 * L * tokens_loc * d * 2
        cache_w = _cache_bytes(cfg, spec, tp, dp)
        return p_bytes + act + cache_w + tokens_loc * d * 2
    # decode: weights stream once per step + cache read
    p_bytes = body_active / tp * 2
    cache = _cache_bytes(cfg, spec, tp, dp)
    return p_bytes + cache + tokens_loc * d * 2 * L / max(L, 1)


def _cache_bytes(cfg, spec, tp: int, dp: int) -> float:
    """Per-chip KV-cache/state bytes touched by one decode/prefill step."""
    B, S = spec.global_batch, spec.seq_len
    b_loc = B / dp if B >= dp else B
    if cfg.family == "ssm":
        H = cfg.d_model // cfg.rwkv_head_size
        return (cfg.n_layers * b_loc
                * (H * cfg.rwkv_head_size ** 2 * 4 + 2 * cfg.d_model * 2))
    kv, hd = cfg.n_kv_heads, cfg.hd
    if cfg.family == "hybrid":
        W = min(cfg.sliding_window or S, S)
        ssm = cfg.n_layers * b_loc * (cfg.ssm_expand * cfg.d_model
                                      * cfg.ssm_state * 4)
        return cfg.n_layers * b_loc * 2 * W * kv * hd * 2 + ssm
    seq = S if spec.kind == "decode" else S
    shard = tp if B < dp else 1  # long-context cache is seq-sharded
    return cfg.n_layers * b_loc * 2 * seq * kv * hd * 2 / shard
