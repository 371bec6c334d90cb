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
  (``psum``, ``pmax``, ``all_gather``, ``all_to_all``, ``relayout``):
  each cell leaves its tensor for the others and computes its result from
  theirs on its own device, in cell order, so every run gives the same
  numbers. Every cell must call the same collectives in the same order,
  as under ``shard_map``.
"""
from __future__ import annotations

import dataclasses
import threading

import numpy as np
import torch

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
    the block, on it, so every device's copy is the whole gradient."""
    mesh = sharding.mesh
    blocks: dict = {}   # block key -> (block shape, cells in cell order)
    for index in np.ndindex(mesh.devices.shape):
        sl = block_slices(mesh, sharding.spec, shape, index)
        blocks.setdefault(_key(sl), ([x.stop - x.start for x in sl],
                                     []))[1].append(index)
    shards = np.empty(mesh.devices.shape, dtype=object)
    for blk_shape, cells in blocks.values():
        sums: dict = {}
        for index in cells:
            dev = mesh.devices[index]
            if dev not in sums:
                total = None
                for c in cells:
                    if partials[c] is not None:
                        x = partials[c].to(dev)
                        total = x if total is None else total + x
                sums[dev] = total if total is not None else torch.zeros(
                    blk_shape, dtype=torch.float32, device=dev)
            shards[index] = sums[dev]
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
            names = self.mesh.axis_names
            members = [idx for idx in np.ndindex(self.mesh.devices.shape)
                       if all(idx[i] == self.index[i]
                              for i, a in enumerate(names) if a not in axes)]
            members.sort(key=lambda idx: block_index(self.mesh, idx, axes))
            self._groups[axes] = [int(np.ravel_multi_index(
                idx, self.mesh.devices.shape)) for idx in members]
        return self._groups[axes]

    def _values(self, x, entry) -> list | None:
        """The group's tensors along ``entry``, in block order, each on
        this cell's device; None where the group is this cell alone."""
        group = self._group(entry)
        if len(group) == 1:
            return None
        every = self._rv.exchange(self.flat, x)
        return [every[g].to(self.device) for g in group]

    def psum(self, x: torch.Tensor, entry) -> torch.Tensor:
        """The sum of the group's ``x`` in block order, in ``x.dtype``."""
        vals = self._values(x, entry)
        if vals is None:
            return x
        out = vals[0]
        for v in vals[1:]:
            out = out + v
        return out

    def pmax(self, x: torch.Tensor, entry) -> torch.Tensor:
        vals = self._values(x, entry)
        if vals is None:
            return x
        out = vals[0]
        for v in vals[1:]:
            out = torch.maximum(out, v)
        return out

    def all_gather(self, x: torch.Tensor, entry, dim: int) -> torch.Tensor:
        """The group's blocks joined along ``dim`` in block order."""
        vals = self._values(x, entry)
        return x if vals is None else torch.cat(vals, dim=dim)

    def all_to_all(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """``x`` (n, ...) with n the size of ``axis``: row m goes to the
        m-th cell of the group, and row m of the result came from it
        (``lax.all_to_all(x, axis, 0, 0, tiled=False)``)."""
        vals = self._values(x, axis)
        if vals is None:
            return x
        me = self.block(axis)
        return torch.stack([v[me] for v in vals])

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


def run_cells(mesh: Mesh, fn) -> np.ndarray:
    """``fn(cell)`` for every cell of ``mesh``, each in its own thread
    (under the caller's grad mode), the cells taking turns between their
    collectives (``_Rendezvous``). Returns the results as an object array
    of the mesh's shape. A cell that raises breaks the others'
    rendezvous, and its exception is raised here."""
    shape = mesh.devices.shape
    rv = _Rendezvous(int(np.prod(shape)))
    cells = [Cell(mesh, idx, rv) for idx in np.ndindex(shape)]
    out = np.empty(shape, dtype=object)
    grad = torch.is_grad_enabled()

    def one(cell):
        _CURRENT.cell = cell
        try:
            rv.start(cell.flat)
            with torch.set_grad_enabled(grad):
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
