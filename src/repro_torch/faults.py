"""Named fault-injection points for the crash-consistency harness
(DESIGN.md §10; the port's copy of the reference's ``faults`` module, so
its live-index modules fire the same points without importing it).

The durability-critical code paths call ``fire(point)`` at the moments a
real crash would be most damaging — after slab writes but before the
validity flip, mid-journal-append, after a snapshot's tmp directory is
written but before its atomic rename. In production every ``fire`` is a
dictionary miss + one environ probe (nanoseconds); under test a point can
be armed two ways:

* **in-process** — ``arm(point)`` registers a callable (default: raise
  ``InjectedFault``), so pytest can drive crash/recovery interleavings
  deterministically without forking;
* **cross-process** — set ``FNS_FAULT=<point>`` (or ``<point>:raise``) in
  a subprocess's environment and the process SIGKILLs itself the moment it
  reaches that point — the honest crash: no atexit, no flush, no cleanup.
  The env var is read at fire time, so a test script can run a healthy
  prefix of work and only then arm the kill.

Points are an open set (any string), but the canonical catalog lives in
``POINTS`` so tests and DESIGN.md can enumerate them.
"""
from __future__ import annotations

import os
import signal
from typing import Callable

ENV_VAR = "FNS_FAULT"

# the canonical crash-point catalog (DESIGN.md §10). Each name is
# ``<subsystem>.<moment>``; the moment is always BEFORE the action that
# would make the preceding work durable/visible.
POINTS = (
    # slab rows written, validity not yet flipped (insert_rows)
    "ingest.post-slab-write",
    # journal record half-written, not yet fsynced (Journal.append)
    "journal.mid-append",
    # snapshot tmp dir complete, atomic rename not yet done (ckpt._write)
    "snapshot.pre-rename",
    # validity bits cleared on the host, device bitmap not yet re-placed
    # (lifecycle.delete_rows)
    "lifecycle.post-tombstone",
    # maintenance step about to drain deferred graph repair (repair_range
    # backlog) — a crash here must leave the backlog replayable
    "maintenance.pre-repair",
    # compaction has picked its survivors but the slab remap is not done
    # (lifecycle.compact_shard) — the classic torn-compaction moment
    "maintenance.mid-compact",
    # maintenance finished host-side work, device refresh not yet published
    # (MaintenanceLoop.step)
    "maintenance.pre-publish",
    # serving has packed a query batch but not yet dispatched it — the
    # window where a concurrent maintenance publish would make the packed
    # tables stale (engine._fence_pack re-packs; DESIGN.md §13)
    "serve.pre-dispatch",
)


class InjectedFault(RuntimeError):
    """Raised by an armed in-process fault point (simulated crash)."""


_hooks: dict[str, Callable[[], None]] = {}


def arm(point: str, action: Callable[[], None] | None = None) -> None:
    """Arm ``point``: on the next ``fire(point)`` run ``action`` (default:
    raise ``InjectedFault(point)``)."""
    if action is None:
        def action(_p=point):  # pragma: no cover - trivial
            raise InjectedFault(_p)
    _hooks[point] = action


def disarm(point: str | None = None) -> None:
    """Disarm one point, or all of them (``point=None``)."""
    if point is None:
        _hooks.clear()
    else:
        _hooks.pop(point, None)


def armed() -> tuple[str, ...]:
    return tuple(_hooks)


def fire(point: str) -> None:
    """Hit a named fault point. No-op unless the point is armed in-process
    or named by the ``FNS_FAULT`` environment variable."""
    hook = _hooks.get(point)
    if hook is not None:
        hook()
        return
    spec = os.environ.get(ENV_VAR)
    if not spec:
        return
    name, _, mode = spec.partition(":")
    if name != point:
        return
    if mode == "raise":
        raise InjectedFault(point)
    # the real thing: die NOW, with no chance to flush or clean up
    os.kill(os.getpid(), signal.SIGKILL)
