"""Tensors placed on a device mesh, and the cells that compute on them.

The reference places arrays with ``NamedSharding(mesh, PartitionSpec)``
and ``jax.device_put``, and XLA's SPMD partitioner (or a ``shard_map``)
runs one program on every device, joined by collectives. The port's mesh
is a grid of ``torch.device``s driven by one process
(``launch/mesh.py``), so both halves are said directly here:

* **placement**: ``P`` (one entry a dim: a mesh axis, a tuple of axes
  major to minor, or None), ``NamedSharding``, ``place`` (a tensor as
  ``Sharded``, each cell's block of it), ``gather`` (the blocks as one
  tensor again) and ``reshard`` (the blocks of another layout, from
  those held). Cells on one device share storage: a sharded leaf's
  blocks are views of one copy there, and a replicated leaf is one tensor
  a device, not one a cell. ``psum_partials`` sums the cells' partials of
  one tensor (a gradient, each cell's from its own pass) into its
  layout: the gradient sync.
* **cells**: ``run_cells(mesh, fn)`` calls ``fn(cell)`` for every cell,
  each in a thread of its own, and returns their results. The cells take
  turns, one running at a time in cell order, and hand over at their
  collectives: so one process drives them all, as it drives the search
  mesh's, and no two contend for the interpreter. A ``Cell`` knows its
  place on the mesh and joins the others in collectives over named axes
  (``psum``, ``pmax``, ``all_gather``, ``all_to_all``, ``relayout``; a
  gradient sync's ``psum_scatter`` and ``gather_blocks``):
  each cell leaves its tensor for the others and computes its result from
  theirs on its own device, in cell order, so every run gives the same
  numbers. Every cell must call the same collectives in the same order,
  as under ``shard_map``.
* **cost**: a cell reports each collective (kind, output bytes, group
  size, nodes spanned) to the ``roofline.CostCounter`` active in its
  thread, and the ops that carry it out are not counted. Under
  ``cell_counters`` every ``run_cells`` enters one counter a cell around
  the cell's work, so each cell's count is its chip's. Under
  ``cell_counters(..., trace=index)`` the cell at ``index`` runs alone,
  in the calling thread, as a ``TraceCell``: its collectives meet no
  other cell and return tensors of the shape the group would give (on
  ``meta``, nothing is computed), so one cell's count of a 256- or
  512-cell mesh costs one cell's trace. Its collectives are autograd
  functions whose backward reports the adjoint collective (an
  all-reduce's all-reduce, an all-gather's reduce-scatter, an
  all_to_all's all_to_all), so a traced backward is counted too.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import threading

import numpy as np
import torch
from torch.utils._python_dispatch import _disable_current_modes

from repro_torch.launch import roofline as rf
from repro_torch.launch.mesh import Mesh, staging_device

RENDEZVOUS_TIMEOUT_S = 600.0   # a turn that never comes back is a fault


class P(tuple):
    """The port's ``PartitionSpec``: one entry a dim, each a mesh axis
    name, a tuple of names (the dim split over their product, the first
    name major) or None (the dim whole on every cell). Missing trailing
    entries are None. Entries are canonical as the reference's are: a
    tuple of one name is the name, an empty one None."""

    def __new__(cls, *dims):
        return super().__new__(cls, (_canonical(d) for d in dims))

    def __repr__(self) -> str:
        return "P" + tuple.__repr__(tuple(self))


def _canonical(entry):
    if isinstance(entry, (tuple, list)):
        entry = tuple(entry)
        return None if not entry else entry[0] if len(entry) == 1 else entry
    return entry


def axes_of(entry) -> tuple:
    """One spec entry as a tuple of axis names (None: ())."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def axes_size(mesh: Mesh, entry) -> int:
    n = 1
    for a in axes_of(entry):
        n *= int(mesh.shape[a])
    return n


def full_spec(spec, ndim: int) -> tuple:
    """``spec``'s entries padded with None to ``ndim``, each as a tuple of
    axes."""
    if len(spec) > ndim:
        raise ValueError(f"spec {spec} has more entries than {ndim} dims")
    return tuple(axes_of(e) for e in spec) + ((),) * (ndim - len(spec))


def fit(mesh: Mesh, spec, shape) -> P:
    """``spec`` for a tensor of ``shape``, every entry whose axes do not
    divide its dim replaced by None (the dim kept whole)."""
    out = []
    for e, n in zip(full_spec(spec, len(shape)), shape):
        out.append(e if e and n % axes_size(mesh, e) == 0 else None)
    return P(*out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """Where a tensor lives: ``mesh`` and a spec ``P``. ``stack`` =
    (entry, layer, layers) says the tensor is layer ``layer`` of a stack
    of ``layers`` whose leading dim the reference splits over ``entry``'s
    axes (ZeRO-1 on the layer dim, ``shardings.opt_shardings``): only the
    cells whose block of that dim holds the layer hold the tensor, each
    its block under ``spec``; the others hold nothing."""
    mesh: Mesh
    spec: P
    stack: tuple | None = None


def holds(sharding: NamedSharding, index: tuple) -> bool:
    """Whether the cell at ``index`` holds a block of a tensor laid out
    by ``sharding`` (every cell does, unless ``stack`` says otherwise)."""
    if sharding.stack is None:
        return True
    entry, layer, layers = sharding.stack
    per = layers // axes_size(sharding.mesh, entry)
    return block_index(sharding.mesh, index, entry) == layer // per


def block_index(mesh: Mesh, index: tuple, entry) -> int:
    """The block a cell at ``index`` holds of a dim split over ``entry``'s
    axes (mixed radix, the first axis major)."""
    b = 0
    for a in axes_of(entry):
        i = mesh.axis_names.index(a)
        b = b * int(mesh.shape[a]) + int(index[i])
    return b


def block_slices(mesh: Mesh, spec, shape, index: tuple) -> tuple:
    """The slices of a tensor of ``shape`` that the cell at ``index``
    holds under ``spec``. A dim its axes do not divide raises."""
    out = []
    for e, n in zip(full_spec(spec, len(shape)), shape):
        parts = axes_size(mesh, e)
        if n % parts:
            raise ValueError(f"dim of {n} does not split over {e} "
                             f"({parts} blocks)")
        size = n // parts
        b = block_index(mesh, index, e)
        out.append(slice(b * size, (b + 1) * size))
    return tuple(out)


def _key(slices: tuple) -> tuple:
    return tuple((s.start, s.stop) for s in slices)


def group_of(mesh: Mesh, index: tuple, entry) -> list[tuple]:
    """The cells that differ from the one at ``index`` only on ``entry``'s
    axes, ordered by their block along them (cell order where the axes
    are in the mesh's order)."""
    axes = axes_of(entry)
    ranges = [range(n) if a in axes else (index[i],)
              for i, (a, n) in enumerate(zip(mesh.axis_names,
                                             mesh.devices.shape))]
    return sorted(itertools.product(*ranges),
                  key=lambda idx: block_index(mesh, idx, axes))


def replica_axes(sharding: NamedSharding) -> tuple:
    """The mesh's axes that ``sharding``'s spec does not split, in mesh
    order: cells that differ only on them hold the same block."""
    used = {a for e in sharding.spec for a in axes_of(e)}
    return tuple(a for a in sharding.mesh.axis_names if a not in used)


def sync_axes(param: NamedSharding, opt: NamedSharding) -> tuple:
    """How a gradient laid out by ``param`` is synced onto optimizer
    state laid out by ``opt``: (the axes it is reduce-scattered over onto
    ``opt``'s blocks, the axes those blocks are then all-reduced over),
    each in mesh order. Together they are ``replica_axes(param)``, the
    cells whose partials ``psum_partials`` sums."""
    on_opt = {a for e in opt.spec for a in axes_of(e)}
    if opt.stack is not None:
        on_opt |= set(axes_of(opt.stack[0]))
    rep = replica_axes(param)
    return (tuple(a for a in rep if a in on_opt),
            tuple(a for a in rep if a not in on_opt))


class Sharded:
    """A tensor placed on a mesh: its global ``shape`` and ``dtype``, its
    ``sharding``, and each cell's block (``shards``, an object array of
    the mesh's shape; cells on one device that hold the same block hold
    the same tensor; None where a cell holds nothing, ``holds``)."""

    def __init__(self, sharding: NamedSharding, shape, dtype,
                 shards: np.ndarray):
        self.sharding, self.shards = sharding, shards
        self.shape, self.dtype = torch.Size(shape), dtype

    @property
    def mesh(self) -> Mesh:
        return self.sharding.mesh

    @property
    def spec(self) -> P:
        return self.sharding.spec

    def local(self, cell) -> torch.Tensor:
        """The block of ``cell`` (a ``Cell`` or a mesh index)."""
        return self.shards[cell.index if isinstance(cell, Cell) else
                           tuple(cell)]

    def __repr__(self) -> str:
        return (f"Sharded(shape={tuple(self.shape)}, dtype={self.dtype}, "
                f"spec={self.spec})")


def place(x, sharding: NamedSharding) -> Sharded:
    """``x`` (a tensor or array) on ``sharding``'s mesh: each cell's
    block. Where every cell is on one device, ``x`` is copied there once
    (not at all if it is there) and the blocks are views of it; otherwise
    each device copies the blocks its cells hold, each once."""
    if not torch.is_tensor(x):
        x = torch.as_tensor(np.asarray(x))
    mesh = sharding.mesh
    one = staging_device(mesh)
    if len(set(mesh.devices.flat)) == 1 and x.device != one:
        x = x.to(one)
    shards = np.empty(mesh.devices.shape, dtype=object)
    held: dict = {}
    for index in np.ndindex(mesh.devices.shape):
        if not holds(sharding, index):
            continue
        dev = mesh.devices[index]
        sl = block_slices(mesh, sharding.spec, x.shape, index)
        k = (dev, _key(sl))
        if k not in held:
            whole = all(s.stop - s.start == n for s, n in zip(sl, x.shape))
            blk = x if whole else x[sl]
            held[k] = blk if x.device == dev else blk.to(dev)
        shards[index] = held[k]
    return Sharded(sharding, x.shape, x.dtype, shards)


def gather(s: Sharded, device=None) -> torch.Tensor:
    """The whole tensor from its blocks, on ``device`` (default: the
    mesh's first cell's)."""
    mesh = s.mesh
    dev = mesh.devices.flat[0] if device is None else torch.device(device)
    out = torch.empty(s.shape, dtype=s.dtype, device=dev)
    done = set()
    for index in np.ndindex(mesh.devices.shape):
        if s.shards[index] is None:
            continue
        sl = block_slices(mesh, s.spec, s.shape, index)
        if _key(sl) not in done:
            done.add(_key(sl))
            out[sl] = s.shards[index].to(dev)
    return out


def _overlap(a: tuple, b: tuple) -> tuple | None:
    """The global slices ``a`` and ``b`` share, None where they are
    disjoint."""
    out = tuple(slice(max(x.start, y.start), min(x.stop, y.stop))
                for x, y in zip(a, b))
    return out if all(s.start < s.stop for s in out) else None


def _rel(sl: tuple, base: tuple) -> tuple:
    return tuple(slice(s.start - b.start, s.stop - b.start)
                 for s, b in zip(sl, base))


def reshard(s: Sharded, sharding: NamedSharding) -> Sharded:
    """``s`` laid out by ``sharding`` (same mesh): a cell whose block of
    ``s`` holds its new block takes a view of it (a reduce-scatter's
    second half, after ``psum_partials``); any other new block is
    assembled once a device from the blocks that cover it, each read
    from a cell on that device where one holds it (an all-gather)."""
    mesh = s.mesh
    have: dict = {}    # block key -> (slices, {device: tensor})
    for index in np.ndindex(mesh.devices.shape):
        x = s.shards[index]
        if x is None:
            continue
        sl = block_slices(mesh, s.spec, s.shape, index)
        have.setdefault(_key(sl), (sl, {}))[1].setdefault(
            mesh.devices[index], x)
    shards = np.empty(mesh.devices.shape, dtype=object)
    made: dict = {}
    for index in np.ndindex(mesh.devices.shape):
        if not holds(sharding, index):
            continue
        dev = mesh.devices[index]
        new = block_slices(mesh, sharding.spec, s.shape, index)
        k = (dev, _key(new))
        if k not in made:
            own = s.shards[index]
            held = None if own is None else block_slices(
                mesh, s.spec, s.shape, index)
            if held is not None and _overlap(new, held) == new:
                made[k] = own[_rel(new, held)]
            else:
                out = torch.empty([x.stop - x.start for x in new],
                                  dtype=s.dtype, device=dev)
                for sl, on in have.values():
                    both = _overlap(new, sl)
                    if both is not None:
                        src = on.get(dev, next(iter(on.values())))
                        out[_rel(both, new)] = src[_rel(both, sl)].to(dev)
                made[k] = out
        shards[index] = made[k]
    return Sharded(sharding, s.shape, s.dtype, shards)


def psum_partials(partials: np.ndarray, sharding: NamedSharding,
                  shape) -> Sharded:
    """The sync of a tensor of ``shape`` laid out by ``sharding`` whose
    every cell computed a partial of its block (``partials``, an object
    array of the mesh's shape; None counts as zeros): for each block, the
    partials of every cell that holds it (its batch block's share, and
    where a cell's pass covers part of the model, that part's share of a
    replicated leaf) summed in cell order. One sum a device that holds
    the block, on it, so every device's copy is the whole gradient. The
    cells that hold a block are those that differ only on
    ``replica_axes(sharding)`` (``group_of``), as a cell's
    ``psum_scatter`` sums them."""
    mesh = sharding.mesh
    rep = replica_axes(sharding)
    shards = np.empty(mesh.devices.shape, dtype=object)
    sums: dict = {}     # (device, the group's first cell) -> its sum
    for index in np.ndindex(mesh.devices.shape):
        cells = group_of(mesh, index, rep)
        dev = mesh.devices[index]
        k = (dev, cells[0])
        if k not in sums:
            total = None
            for c in cells:
                if partials[c] is not None:
                    x = partials[c].to(dev)
                    total = x if total is None else total + x
            if total is None:
                sl = block_slices(mesh, sharding.spec, shape, index)
                total = torch.zeros([x.stop - x.start for x in sl],
                                    dtype=torch.float32, device=dev)
            sums[k] = total
        shards[index] = sums[k]
    return Sharded(sharding, shape, shards.flat[0].dtype, shards)


def map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over a tree of dicts, lists and leaves (None
    kept), ``path`` the tuple of dict keys and list indices, as strings,
    from the root."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_path(fn, v, path + (str(i),))
                          for i, v in enumerate(tree))
    return None if tree is None else fn(path, tree)


def _zip_map(fn, tree, other):
    if isinstance(tree, dict):
        return {k: _zip_map(fn, v, other[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_zip_map(fn, v, o) for v, o in zip(tree, other))
    return None if tree is None else fn(tree, other)


def place_tree(tree, shardings):
    """Every leaf of ``tree`` placed by the matching leaf of
    ``shardings`` (a tree of the same structure)."""
    return _zip_map(place, tree, shardings)


# -- cells ---------------------------------------------------------------------

class _Rendezvous:
    """Where the cells of one ``run_cells`` take turns and hand each other
    tensors. One cell runs at a time, in cell order: a cell runs until its
    next collective, leaves its tensor in its slot and passes the turn
    on; when the turn comes back every cell has left its tensor, and it
    reads them all. Collectives alternate between two sets of slots, so a
    cell that runs ahead to the next one overwrites nothing that another
    has still to read. With no two cells running at once, no two threads
    contend for the interpreter between collectives."""

    def __init__(self, n: int):
        self.n, self.turn = n, 0
        self.lock = threading.Lock()
        # one condition a cell, so passing the turn wakes that cell alone
        self.conds = [threading.Condition(self.lock) for _ in range(n)]
        self.slots = ([None] * n, [None] * n)
        self.made = [0] * n       # collectives each cell has made
        self.done = [False] * n
        self.failed = False

    def _wait_turn(self, flat: int) -> None:
        ok = self.conds[flat].wait_for(
            lambda: self.failed or self.turn == flat,
            timeout=RENDEZVOUS_TIMEOUT_S)
        if self.failed or not ok:
            raise threading.BrokenBarrierError(
                "a cell failed or never reached its collective")

    def _pass(self, flat: int) -> None:
        nxt = (flat + 1) % self.n
        while self.done[nxt] and nxt != flat:
            nxt = (nxt + 1) % self.n
        self.turn = nxt
        self.conds[nxt].notify()

    def _fail(self) -> None:
        self.failed = True
        for c in self.conds:
            c.notify_all()

    def start(self, flat: int) -> None:
        with self.lock:
            self._wait_turn(flat)

    def exchange(self, flat: int, value) -> list:
        with self.lock:
            if any(self.done):
                self._fail()
                raise RuntimeError("cells made different collectives")
            slots = self.slots[self.made[flat] % 2]
            self.made[flat] += 1
            slots[flat] = value
            self._pass(flat)
            self._wait_turn(flat)
            return list(slots)

    def finish(self, flat: int) -> None:
        with self.lock:
            self.done[flat] = True
            self._pass(flat)

    def abort(self) -> None:
        with self.lock:
            self._fail()


_CURRENT = threading.local()


def current_cell():
    """The ``Cell`` the calling thread computes for, None outside
    ``run_cells``."""
    return getattr(_CURRENT, "cell", None)


class Cell:
    """One cell of a ``run_cells``: its ``index`` on the mesh, its
    ``device``, and the collectives that join it to the other cells."""

    def __init__(self, mesh: Mesh, index: tuple, rendezvous: _Rendezvous):
        self.mesh, self.index = mesh, tuple(index)
        self.device = mesh.devices[self.index]
        self.flat = int(np.ravel_multi_index(self.index,
                                             mesh.devices.shape))
        self._rv = rendezvous
        self._groups: dict = {}

    def block(self, entry) -> int:
        """This cell's block index along ``entry``'s axes."""
        return block_index(self.mesh, self.index, entry)

    def size(self, entry) -> int:
        return axes_size(self.mesh, entry)

    def _group(self, entry) -> list[int]:
        """Flat indices of the cells that share this cell's place on
        every axis but ``entry``'s, ordered by their block along it."""
        axes = axes_of(entry)
        if axes not in self._groups:
            self._groups[axes] = [int(np.ravel_multi_index(
                idx, self.mesh.devices.shape)) for idx in group_of(
                    self.mesh, self.index, axes)]
        return self._groups[axes]

    def _values(self, x, entry) -> list | None:
        """The group's tensors along ``entry``, in block order, each on
        this cell's device; None where the group is this cell alone."""
        if len(self._group(entry)) == 1:
            return None
        return [v.to(self.device) for v in self._every(x, entry)]

    def report(self, kind: str, nbytes: int, entry, out=None,
               counter=None) -> None:
        """A collective of ``kind`` over ``entry``'s group whose output on
        this cell is ``nbytes`` (``out``, where it is a tensor), reported
        to ``counter`` (default: the thread's ``CostCounter``, if any)
        with the group's size and the nodes it spans."""
        counter = counter or rf.active_counter()
        if counter is not None:
            group = self._group(entry)
            nodes = len({g // rf.CELLS_PER_NODE for g in group})
            counter.collective(kind, nbytes, len(group), nodes, out)

    def _report(self, kind: str, out: torch.Tensor, entry,
                counter=None) -> torch.Tensor:
        self.report(kind, out.numel() * out.element_size(), entry, out,
                    counter)
        return out

    def _collect(self, kind: str, x, entry, combine) -> torch.Tensor:
        """``combine`` of the group's tensors (``x`` itself where the
        group is this cell alone), uncounted, reported as one ``kind``."""
        if len(self._group(entry)) == 1:
            return x
        with _disable_current_modes():
            out = combine(self._values(x, entry))
        return self._report(kind, out, entry)

    def psum(self, x: torch.Tensor, entry) -> torch.Tensor:
        """The sum of the group's ``x`` in block order, in ``x.dtype``."""
        def total(vals):
            out = vals[0]
            for v in vals[1:]:
                out = out + v
            return out
        return self._collect("all-reduce", x, entry, total)

    def pmax(self, x: torch.Tensor, entry) -> torch.Tensor:
        def most(vals):
            out = vals[0]
            for v in vals[1:]:
                out = torch.maximum(out, v)
            return out
        return self._collect("all-reduce", x, entry, most)

    def all_gather(self, x: torch.Tensor, entry, dim: int) -> torch.Tensor:
        """The group's blocks joined along ``dim`` in block order."""
        return self._collect("all-gather", x, entry,
                             lambda vals: torch.cat(vals, dim=dim))

    def all_to_all(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """``x`` (n, ...) with n the size of ``axis``: row m goes to the
        m-th cell of the group, and row m of the result came from it
        (``lax.all_to_all(x, axis, 0, 0, tiled=False)``)."""
        me = self.block(axis)
        return self._collect("all-to-all", x, axis,
                             lambda vals: torch.stack([v[me] for v in vals]))

    def _every(self, value, entry) -> list:
        """The group's ``value``s along ``entry``, in block order."""
        every = self._rv.exchange(self.flat, value)
        return [every[g] for g in self._group(entry)]

    def psum_scatter(self, x: torch.Tensor, scatter, reduce, sl):
        """The gradient sync of one leaf (``sync_axes``): the sum of ``x``
        over the cells that differ from this one only on the ``scatter``
        and ``reduce`` axes, in cell order as ``psum_partials`` sums it,
        and this cell's block ``sl`` of it (None where ``sl`` is: the cell
        keeps none). Reported as what an SPMD program runs: a
        reduce-scatter over ``scatter``, then an all-reduce of the block
        over ``reduce``."""
        axes = tuple(a for a in self.mesh.axis_names
                     if a in tuple(scatter) + tuple(reduce))
        total = x
        if len(self._group(axes)) > 1:
            with _disable_current_modes():
                total = self._sum(x, axes)
        if scatter:
            self.report("reduce-scatter", x.numel() * x.element_size()
                        // self.size(scatter), scatter)
        if sl is None:
            return None
        with _disable_current_modes():
            out = total[sl].clone()
        if reduce:
            self._report("all-reduce", out, reduce)
        return out

    def _sum(self, x, axes) -> torch.Tensor:
        vals = self._values(x, axes)
        out = vals[0]
        for v in vals[1:]:
            out = out + v
        return out

    def gather_blocks(self, piece, sl, entry, shape, dtype) -> torch.Tensor:
        """The tensor of ``shape`` whose block ``sl`` each cell of
        ``entry``'s group holds (``piece``, None where the cell holds
        none), assembled on this cell: an all-gather, reported."""
        with _disable_current_modes():
            out = torch.empty(shape, dtype=dtype, device=self.device)
            for x, s in self._pieces((piece, sl), entry):
                if x is not None:
                    out[s] = x.to(self.device)
        return self._report("all-gather", out, entry)

    def _pieces(self, value, entry) -> list:
        return self._every(value, entry)

    def take(self, x: torch.Tensor, spec) -> torch.Tensor:
        """This cell's block of ``x`` (a tensor it holds whole) under
        ``spec``."""
        return x[block_slices(self.mesh, spec, x.shape, self.index)]

    def relayout(self, x: torch.Tensor, src, dst) -> torch.Tensor:
        """This cell's block under ``dst`` of the tensor whose block under
        ``src`` is ``x``: each dim whose entry changes is gathered over
        its old axes, then cut by its new ones."""
        a, b = full_spec(src, x.ndim), full_spec(dst, x.ndim)
        if a == b:
            return x
        for d, (old, new) in enumerate(zip(a, b)):
            if old != new and old:
                x = self.all_gather(x, old, d)
        for d, (old, new) in enumerate(zip(a, b)):
            if old != new and new:
                n = x.shape[d] // self.size(new)
                x = x.narrow(d, self.block(new) * n, n)
        return x


class _Shaped(torch.autograd.Function):
    """A traced collective: a fresh tensor of the group's result's shape,
    reported as ``kind``; its backward a fresh tensor of the input's
    shape, reported as the adjoint ``back``."""

    @staticmethod
    def forward(ctx, x, cell, entry, kind, back, shape):
        ctx.cell, ctx.entry, ctx.back = cell, entry, back
        ctx.in_shape, ctx.counter = x.shape, rf.active_counter()
        with _disable_current_modes():
            out = x.new_empty(shape)
        return cell._report(kind, out, entry, ctx.counter)

    @staticmethod
    def backward(ctx, g):
        with _disable_current_modes():
            out = g.new_empty(ctx.in_shape)
        return (ctx.cell._report(ctx.back, out, ctx.entry, ctx.counter),
                None, None, None, None, None)


class TraceCell(Cell):
    """A cell that runs alone (``cell_counters(..., trace=index)``): its
    place on the mesh and its blocks are a ``Cell``'s, but each collective
    returns a fresh tensor of the shape the group would give (a
    ``_Shaped``) and reports it, with no other cell to meet. On ``meta``
    tensors that is a trace of the cell's work at no cost."""

    def __init__(self, mesh: Mesh, index: tuple):
        super().__init__(mesh, index, None)

    def _shaped(self, kind, back, x, entry, shape) -> torch.Tensor:
        if len(self._group(entry)) == 1:
            return x
        return _Shaped.apply(x, self, axes_of(entry), kind, back,
                             torch.Size(shape))

    def psum(self, x, entry):
        return self._shaped("all-reduce", "all-reduce", x, entry, x.shape)

    def pmax(self, x, entry):
        return self._shaped("all-reduce", "all-reduce", x, entry, x.shape)

    def all_gather(self, x, entry, dim):
        shape = list(x.shape)
        shape[dim] *= len(self._group(entry))
        return self._shaped("all-gather", "reduce-scatter", x, entry, shape)

    def all_to_all(self, x, axis):
        return self._shaped("all-to-all", "all-to-all", x, axis, x.shape)

    def _sum(self, x, axes):
        return x

    def _pieces(self, value, entry):
        return [value]


class _Counting(threading.local):
    make = None          # counter factory, set by ``cell_counters``
    counters = None      # cell index -> its counter
    trace = None         # the one cell to run, or None: every cell


_COUNTING = _Counting()


@contextlib.contextmanager
def cell_counters(make, trace: tuple | None = None):
    """While inside, every ``run_cells`` called from this thread enters
    each cell's own counter (``make()``, one a cell index, kept across
    calls) around that cell's work; yields the dict of counters by index.
    With ``trace``, the cell at that index runs alone as a ``TraceCell``
    in this thread, and every slot of ``run_cells``' result holds its
    result."""
    saved = (_COUNTING.make, _COUNTING.counters, _COUNTING.trace)
    _COUNTING.make, _COUNTING.counters = make, {}
    _COUNTING.trace = None if trace is None else tuple(trace)
    try:
        yield _COUNTING.counters
    finally:
        _COUNTING.make, _COUNTING.counters, _COUNTING.trace = saved


def run_cells(mesh: Mesh, fn) -> np.ndarray:
    """``fn(cell)`` for every cell of ``mesh``, each in its own thread
    (under the caller's grad mode), the cells taking turns between their
    collectives (``_Rendezvous``). Returns the results as an object array
    of the mesh's shape. A cell that raises breaks the others'
    rendezvous, and its exception is raised here. Under ``cell_counters``
    each cell's work is counted by its own counter, or one cell is traced
    alone."""
    shape = mesh.devices.shape
    out = np.empty(shape, dtype=object)
    make, counters = _COUNTING.make, _COUNTING.counters
    if _COUNTING.trace is not None:
        cell = TraceCell(mesh, _COUNTING.trace)
        counter = counters.setdefault(cell.index, make())
        _CURRENT.cell = cell
        try:
            with counter:
                res = fn(cell)
        finally:
            _CURRENT.cell = None
        for index in np.ndindex(shape):
            out[index] = res
        return out
    rv = _Rendezvous(int(np.prod(shape)))
    cells = [Cell(mesh, idx, rv) for idx in np.ndindex(shape)]
    grad = torch.is_grad_enabled()
    if make is not None:
        for c in cells:
            counters.setdefault(c.index, make())

    def one(cell):
        _CURRENT.cell = cell
        try:
            rv.start(cell.flat)
            with torch.set_grad_enabled(grad), (
                    counters[cell.index] if make is not None
                    else contextlib.nullcontext()):
                out = fn(cell)
            rv.finish(cell.flat)
            return out
        except BaseException:
            rv.abort()
            raise
        finally:
            _CURRENT.cell = None

    if len(cells) == 1:
        out[cells[0].index] = one(cells[0])
        return out
    with mesh.run_lock:
        futures = [mesh.threads().submit(one, c) for c in cells]
        errors = [f.exception() for f in futures]
    raised = [e for e in errors if e is not None]
    if raised:
        first = [e for e in raised
                 if not isinstance(e, threading.BrokenBarrierError)]
        raise (first or raised)[0]
    for c, f in zip(cells, futures):
        out[c.index] = f.result()
    return out
