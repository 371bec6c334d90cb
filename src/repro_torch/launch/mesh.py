"""Device meshes for the sharded search and serving (DESIGN.md §7, §13).

The reference builds ``jax.sharding.Mesh`` objects over ``jax.devices()``
and runs one ``shard_map`` program across them. The port's mesh is a
single-process grid of ``torch.device``s: one Python process drives every
cell, as the reference's single-controller ``ShardedEngine`` and
``RetrievalService`` do, so the serving API is the same with or without a
mesh. A cell is a device; cells may repeat a device.

``devices`` defaults to ``cuda:0 … cuda:{n-1}`` and raises when the
process has fewer cards than the mesh has cells. An explicit ``devices``
list is the counterpart of the reference's
``--xla_force_host_platform_device_count``: ``["cpu"] * n`` runs a mesh
of n cells on the host (through the plain kernels), ``[cuda:0] * n`` a
mesh of n cells on one card.

``launch/placement.py`` places tensors on a mesh and runs its cells.
"""
from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from repro_torch.core.device_atlas import resolve_device


class Mesh:
    """Named axes over an object ndarray of ``torch.device``s.

    ``devices[i, j, ...]`` is the cell at index i of the first axis, j of
    the second and so on; ``shape`` maps each axis name to its size (in
    axis order), as ``jax.sharding.Mesh.shape`` does."""

    def __init__(self, devices, axis_names: tuple[str, ...]):
        devices = np.asarray(devices, dtype=object)
        if devices.ndim != len(axis_names):
            raise ValueError(
                f"mesh of {devices.ndim} dims given {len(axis_names)} axis "
                f"names {axis_names}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, devices.shape))
        self._threads = None
        self.run_lock = threading.Lock()   # one ``run_cells`` at a time

    def threads(self) -> ThreadPoolExecutor:
        """One thread a cell for ``placement.run_cells``, made on first
        use and kept, so a cell's thread keeps its CUDA context and
        handles from call to call; they end when the mesh is collected."""
        if self._threads is None:
            self._threads = ThreadPoolExecutor(
                int(self.devices.size), thread_name_prefix="mesh-cell")
        return self._threads


def mesh_devices(n: int, devices=None) -> list[torch.device]:
    """The first ``n`` of ``devices`` (default: the process's CUDA cards
    in order). Raises when there are fewer than ``n``: a mesh never falls
    back to the CPU and never reuses a device unless ``devices`` says so."""
    if devices is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if count < n:
            raise RuntimeError(
                f"a mesh of {n} cells needs {n} CUDA devices, this process "
                f"has {count}; pass devices= to place cells explicitly "
                f"(e.g. devices=['cpu'] * {n})")
        return [torch.device("cuda", i) for i in range(n)]
    devices = [_indexed(torch.device(d)) for d in devices]
    if len(devices) < n:
        raise ValueError(
            f"a mesh of {n} cells was given {len(devices)} devices")
    return devices[:n]


def _indexed(dev: torch.device) -> torch.device:
    """``cuda`` as the current card's ``cuda:i``, so cells given either
    name are on one device."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def _grid(shape: tuple[int, ...], devices) -> np.ndarray:
    flat = mesh_devices(int(np.prod(shape)), devices)
    grid = np.empty(len(flat), dtype=object)
    grid[:] = flat
    return grid.reshape(shape)


def make_production_mesh(*, multi_pod: bool = False, devices=None) -> Mesh:
    """16x16 ("data", "model") single pod (256 cells) or 2x16x16 ("pod",
    "data", "model") multi-pod (512 cells), as the reference's; raises
    where the process has fewer cards and ``devices`` is not given."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(_grid(shape, devices), axes)


def make_local_mesh(data: int = 1, model: int = 1, devices=None) -> Mesh:
    """Small (data, model) mesh (tests and the chip smoke)."""
    return Mesh(_grid((data, model), devices), ("data", "model"))


def make_serving_mesh(data: int = 1, query: int = 1, devices=None) -> Mesh:
    """2D query×data serving mesh (DESIGN.md §13): the corpus is
    row-partitioned over ``data`` and the query batch over ``query``, so
    each of the ``query`` lanes walks Q/query queries against every data
    shard. ``query=1`` degrades to the queries-replicated layout."""
    return Mesh(_grid((data, query), devices), ("data", "query"))


def data_axis_names(mesh) -> tuple:
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def index_axis_size(mesh, axis: str = "data") -> int:
    """Corpus shard count a sharded index gets on this mesh: the size of
    the row-partition axis (DESIGN.md §7), 1 when the mesh lacks it."""
    return int(mesh.shape[axis]) if axis in mesh.axis_names else 1


def query_axis_name(mesh, candidates=("query", "model")) -> str | None:
    """The mesh axis that carries query lanes (DESIGN.md §13): the first
    candidate axis present with size > 1, else None (queries replicated).
    A dedicated ``query`` axis wins over reusing ``model``."""
    if mesh is None:
        return None
    for a in candidates:
        if a in mesh.axis_names and int(mesh.shape[a]) > 1:
            return a
    return None


def query_axis_size(mesh, candidates=("query", "model")) -> int:
    """Number of query lanes the mesh provides (1 = replicated)."""
    name = query_axis_name(mesh, candidates)
    return int(mesh.shape[name]) if name is not None else 1


def lead_device(mesh, device=None) -> torch.device:
    """Where a caller given ``mesh`` and ``device`` runs what is not
    placed on the mesh (packing queries, the engines it falls back to):
    without a mesh, ``device`` (None means CUDA, which raises where there
    is none); with one, its first cell, and ``device`` must be None,
    since the mesh places everything. Anything but a ``Mesh`` raises
    ``TypeError``."""
    if mesh is None:
        return resolve_device(device)
    if not isinstance(mesh, Mesh):
        raise TypeError(
            f"mesh must be a repro_torch.launch.mesh.Mesh or None, not "
            f"{type(mesh).__name__}")
    if device is not None:
        raise ValueError(
            f"pass device=None with a mesh (got device={device!r}); the "
            f"mesh places everything")
    return mesh.devices.flat[0]


def staging_device(mesh: Mesh) -> torch.device:
    """Where to build a sharded index bound for ``mesh``: its one device
    when every cell is on it (the cells then take views of the stacked
    tensors, with no copy), else the host (each cell copies only its own
    shard, and no card keeps the whole stack)."""
    devices = set(mesh.devices.flat)
    return devices.pop() if len(devices) == 1 else torch.device("cpu")
