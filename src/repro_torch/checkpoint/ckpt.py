"""Sharding-agnostic checkpointing: atomic, async-capable, keep-last-k,
reshard-on-load (elastic mesh change), checksummed.

Format: one directory per step —
    step_0000123/
        manifest.json      # flattened tree paths, shapes, dtypes, step,
                           # per-leaf crc32 checksums
        arrays.npz         # host-gathered leaves keyed by flat path
Writes go to ``<name>.tmp`` then os.rename (atomic on POSIX) so a preempted
writer never leaves a half-checkpoint that restore would pick up; stale
``.tmp`` directories from crashed writers are swept on the next save or
restore. Every leaf's raw bytes are CRC32'd into the manifest at save time
and verified on load, so a flipped byte is a loud ``CheckpointCorruption``
instead of silently restored garbage.

A tree is nested dicts, lists and tuples whose leaves are numpy arrays,
torch tensors, tensors placed on a mesh (``launch.placement.Sharded``,
gathered) or scalars (None is an empty subtree). Leaf keys are the
reference's: dict keys sorted, list indices as strings, joined by ``/``,
``_root`` for a bare leaf, so either package reads the other's
checkpoints. Tensors are copied to the host with ``.cpu().numpy()``.

Restore maps saved leaves back onto any "like" template (arrays or tensors
of the target shapes) as host numpy arrays, or, given ``shardings``,
places each on its mesh, whatever mesh saved it.
``load_arrays`` is the template-free variant (flat path -> host array) used
by consumers that reconstruct their own structures (serve durability).
``restore_latest`` walks steps newest-first and returns the first *readable*
one, so a corrupted newest checkpoint degrades to the previous snapshot
instead of an unrecoverable service.

Async saves run ``_write`` in a daemon thread; a failure there is recorded
and re-raised on the next ``save`` (or an explicit ``handle.wait()``), so a
dead writer can't silently stop producing checkpoints.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import zlib
from typing import Any

import numpy as np
import torch

from repro_torch import faults
from repro_torch.launch.placement import NamedSharding, Sharded, gather, place

_SEP = "/"

# tmp dirs currently owned by a live (possibly async) writer: the stale-tmp
# sweep must not delete a checkpoint that is mid-write in this process
_inflight: set[str] = set()
# ckpt_dir -> first unreported async write failure (re-raised on next save)
_async_failures: dict[str, BaseException] = {}
_lock = threading.Lock()


class CheckpointCorruption(ValueError):
    """A checkpoint failed checksum verification (or structural load)."""


class AsyncSave(threading.Thread):
    """Handle for an asynchronous save. ``join()`` is plain Thread join;
    ``wait()`` joins AND re-raises the writer's exception, if any."""

    exception: BaseException | None = None

    def run(self) -> None:
        # the writer is the thread's ``target``, which ``Thread.run``
        # drops when it returns: a writer that named its own handle would
        # be a reference cycle holding the host copy of the whole tree
        try:
            super().run()
        except BaseException as e:  # record, surface on next save/wait
            self.exception = e

    def wait(self) -> None:
        self.join()
        if self.exception is not None:
            raise RuntimeError(
                "async checkpoint write failed") from self.exception


def _walk(node, path: tuple, out: dict) -> None:
    """Add ``node``'s leaves to ``out`` under their flat keys. A
    module-level recursion, not a closure over ``out``: a self-recursive
    closure is a reference cycle, so the tree would wait for the garbage
    collector."""
    if isinstance(node, dict):
        for k in sorted(node):
            _walk(node[k], path + (str(k),), out)
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            _walk(v, path + (str(i),), out)
    elif node is not None:
        out[_SEP.join(path) or "_root"] = node


def _flatten(tree) -> dict[str, Any]:
    """Flat key -> leaf, in the reference's leaf order (depth first, dict
    keys sorted)."""
    out: dict[str, Any] = {}
    _walk(tree, (), out)
    return out


def _unflatten(like, leaves: dict[str, Any], path=()):
    """``like``'s structure with each leaf replaced by ``leaves[key]``."""
    if isinstance(like, dict):
        return {k: _unflatten(v, leaves, path + (str(k),))
                for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        out = [_unflatten(v, leaves, path + (str(i),))
               for i, v in enumerate(like)]
        return out if isinstance(like, list) else tuple(out)
    if like is None:
        return None
    return leaves[_SEP.join(path) or "_root"]


def _to_host(leaf) -> np.ndarray:
    if isinstance(leaf, Sharded):
        leaf = gather(leaf, "cpu")
    if hasattr(leaf, "detach"):  # a torch tensor, on any device
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _leaf_crc(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).tobytes())


def _sweep_stale_tmp(ckpt_dir: str) -> None:
    """Remove ``step_*.tmp`` directories left by crashed writers. Tmp dirs
    owned by a live writer in this process are skipped."""
    if not os.path.isdir(ckpt_dir):
        return
    with _lock:
        inflight = set(_inflight)
    for n in os.listdir(ckpt_dir):
        if n.startswith("step_") and n.endswith(".tmp"):
            path = os.path.join(ckpt_dir, n)
            if path not in inflight:
                shutil.rmtree(path, ignore_errors=True)


def save(ckpt_dir: str, step: int, tree, *, asynchronous: bool = False,
         keep: int = 3, meta: dict | None = None) -> AsyncSave | None:
    """Write checkpoint for ``step``. ``meta`` is an optional caller-owned
    JSON-serializable dict recorded verbatim in the manifest (e.g. the
    serving config fingerprint + knob dict, so two snapshots are
    comparable from the manifest alone, without loading the arrays).
    With asynchronous=True the device→host
    copy happens inline (consistent snapshot) and the file write runs in a
    daemon thread; returns the ``AsyncSave`` handle. A failure in a
    previous async write for this directory is re-raised here, so silent
    writer death can't masquerade as successful checkpointing."""
    with _lock:
        pending = _async_failures.pop(ckpt_dir, None)
    if pending is not None:
        raise RuntimeError(
            f"a previous asynchronous checkpoint write to {ckpt_dir!r} "
            f"failed; no checkpoint was produced") from pending
    _sweep_stale_tmp(ckpt_dir)
    flat = _flatten(tree)
    host = {k: _to_host(v) for k, v in flat.items()}
    manifest = {"step": step,
                "leaves": {k: {"shape": list(v.shape), "dtype": str(v.dtype)}
                           for k, v in host.items()},
                "crc32": {k: _leaf_crc(v) for k, v in host.items()}}
    if meta is not None:
        manifest["meta"] = meta
    name = f"step_{step:08d}"
    tmp = os.path.join(ckpt_dir, name + ".tmp")
    final = os.path.join(ckpt_dir, name)

    def _write():
        os.makedirs(tmp, exist_ok=True)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        np.savez(os.path.join(tmp, "arrays.npz"), **host)
        faults.fire("snapshot.pre-rename")
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        with _lock:
            _inflight.discard(tmp)
        _cleanup(ckpt_dir, keep)

    with _lock:
        _inflight.add(tmp)
    if asynchronous:
        def _guarded():
            try:
                _write()
            except BaseException as e:  # AsyncSave.run records it
                with _lock:
                    _inflight.discard(tmp)
                    _async_failures.setdefault(ckpt_dir, e)
                raise

        handle = AsyncSave(target=_guarded, daemon=True)
        handle.start()
        return handle
    try:
        _write()
    finally:
        with _lock:
            _inflight.discard(tmp)
    return None


def _cleanup(ckpt_dir: str, keep: int) -> None:
    steps = all_steps(ckpt_dir)
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)


def all_steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for n in os.listdir(ckpt_dir):
        if n.startswith("step_") and not n.endswith(".tmp"):
            try:
                out.append(int(n.split("_")[1]))
            except ValueError:
                continue
    return sorted(out)


def latest_step(ckpt_dir: str) -> int | None:
    steps = all_steps(ckpt_dir)
    return steps[-1] if steps else None


def load_arrays(ckpt_dir: str, step: int, *,
                verify: bool = True) -> tuple[dict[str, np.ndarray], dict]:
    """Template-free load: every saved leaf as a host array keyed by its
    flat tree path, plus the manifest. With ``verify`` (default), each
    leaf's bytes are checked against the manifest CRC32 — a mismatch (or a
    structurally unreadable manifest/npz) raises ``CheckpointCorruption``."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    try:
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        with np.load(os.path.join(path, "arrays.npz")) as data:
            out = {k: data[k] for k in data.files}
    except CheckpointCorruption:
        raise
    except Exception as e:
        raise CheckpointCorruption(
            f"checkpoint step {step} at {ckpt_dir!r} is unreadable: "
            f"{type(e).__name__}: {e}") from e
    if verify:
        crcs = manifest.get("crc32")  # absent on pre-checksum checkpoints
        if crcs is not None:
            for k, arr in out.items():
                want = crcs.get(k)
                if want is not None and _leaf_crc(arr) != want:
                    raise CheckpointCorruption(
                        f"checkpoint step {step} leaf {k!r} failed CRC32 "
                        f"verification (corrupted bytes)")
    return out, manifest


def restore(ckpt_dir: str, step: int, like, shardings=None, *,
            verify: bool = True):
    """Restore ``step`` into the structure of ``like`` (arrays or tensors
    of the target shapes) as host numpy arrays; with ``shardings`` (a
    tree of ``launch.placement.NamedSharding`` matching ``like``), each
    leaf placed on its mesh instead (``placement.place``), so a
    checkpoint taken on one mesh restores onto another (elastic
    reshard)."""
    data, manifest = load_arrays(ckpt_dir, step, verify=verify)
    flat_shard = _flatten(shardings) if shardings is not None else None
    out = {}
    for key, leaf in _flatten(like).items():
        if key not in data:
            raise KeyError(f"checkpoint at step {step} missing leaf {key!r}")
        arr = data[key]
        want = tuple(leaf.shape) if hasattr(leaf, "shape") else np.shape(leaf)
        if tuple(arr.shape) != want:
            raise ValueError(
                f"shape mismatch for {key}: ckpt {arr.shape} vs {want}")
        if flat_shard is not None:
            where = flat_shard.get(key)
            if not isinstance(where, NamedSharding):
                raise TypeError(f"restore: no NamedSharding for leaf "
                                f"{key!r} (got {type(where).__name__})")
            arr = place(torch.from_numpy(arr), where)
        out[key] = arr
    return _unflatten(like, out), manifest["step"]


def restore_latest(ckpt_dir: str, like=None, shardings=None, *,
                   verify: bool = True):
    """Restore the newest *readable* step: candidates are tried
    newest-first, and one that fails manifest/npz load or checksum
    verification falls back to the next (a crashed or bit-flipped newest
    checkpoint must not strand the older good ones). Sweeps stale
    ``.tmp`` dirs first. With ``like=None`` returns the template-free
    ``(flat dict, manifest)`` pair as ``((arrays, manifest), step)``.
    Raises ``FileNotFoundError`` when no step exists at all, and
    ``CheckpointCorruption`` listing every failure when none is readable."""
    _sweep_stale_tmp(ckpt_dir)
    steps = all_steps(ckpt_dir)
    if not steps:
        raise FileNotFoundError(f"no checkpoint steps in {ckpt_dir!r}")
    failures: list[str] = []
    for step in reversed(steps):
        try:
            if like is None:
                return load_arrays(ckpt_dir, step, verify=verify), step
            return restore(ckpt_dir, step, like, shardings, verify=verify)
        except Exception as e:
            failures.append(f"step {step}: {type(e).__name__}: {e}")
    raise CheckpointCorruption(
        f"no readable checkpoint in {ckpt_dir!r}; tried "
        f"{len(failures)}: " + " | ".join(failures))
