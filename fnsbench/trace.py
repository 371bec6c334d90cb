"""A ``torch.profiler`` trace of a stretch of the window, reduced in memory
to device operations, the harness's host spans, busy time and the
breakdown the result line carries. Nothing is written to disk.
"""
from __future__ import annotations

import bisect
import collections
import dataclasses

import torch

START, STOP = "fnsbench.trace_start", "fnsbench.trace_stop"
NAME_CHARS = 120


@dataclasses.dataclass
class DeviceTrace:
    """Times in seconds from the stretch's start."""

    window_s: float
    ops: list          # (name, start, end) of every device operation
    host: list         # (name, start, end) of the harness's spans

    def busy_intervals(self) -> list:
        """Union of the device operations, clipped to the stretch."""
        out: list = []
        for _, a, b in sorted(self.ops, key=lambda o: o[1]):
            a, b = max(a, 0.0), min(b, self.window_s)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    @property
    def busy_s(self) -> float:
        return float(sum(b - a for a, b in self.busy_intervals()))

    def op_seconds(self, names) -> tuple[float, int]:
        """Device seconds and launches of the kernels named ``names`` (a
        trace names a kernel by its whole signature, template arguments
        included) that started inside the stretch."""
        calls = tuple(f"{k}{c}" for k in names for c in "(<")
        sel = [b - a for n, a, b in self.ops
               if 0.0 <= a < self.window_s and any(c in n for c in calls)]
        return float(sum(sel)), len(sel)

    def breakdown(self) -> dict:
        """The ten device operations that took most time, and the idle
        time between them by the harness span the host was in."""
        by_op = collections.Counter()
        for n, a, b in self.ops:
            by_op[n[:NAME_CHARS]] += b - a
        gaps, t = [], 0.0
        for a, b in self.busy_intervals():
            if a > t:
                gaps.append((t, a))
            t = b
        if t < self.window_s:
            gaps.append((t, self.window_s))
        spans = sorted(self.host, key=lambda s: s[1])
        starts = [s[1] for s in spans]
        by_host = collections.Counter()
        for a, b in gaps:
            mid, label = (a + b) / 2, "harness loop"
            i = bisect.bisect_right(starts, mid) - 1
            while i >= 0:
                if spans[i][1] <= mid <= spans[i][2]:
                    label = spans[i][0]
                    break
                i -= 1
            by_host[label] += b - a
        return {"device_ops": [[n, s] for n, s in by_op.most_common(10)],
                "idle_gaps": [[n, s] for n, s in by_host.most_common(10)]}


def reduce(prof) -> DeviceTrace | None:
    """The stretch between the ``START`` and ``STOP`` markers of a
    finished profile; None where it holds no device operation."""
    from torch.autograd import DeviceType
    events = prof.events()
    marks = {e.name: e.time_range.start for e in events
             if e.name in (START, STOP)}
    if START not in marks or STOP not in marks:
        return None
    t0, t1 = marks[START], marks[STOP]
    ops, host = [], []
    for e in events:
        a, b = (e.time_range.start - t0) / 1e6, (e.time_range.end - t0) / 1e6
        if e.name.startswith("fnsbench."):
            # the harness's spans; on the device timeline they only
            # mirror the kernels they enclose
            if e.device_type == DeviceType.CPU and e.name not in (START, STOP):
                host.append((e.name[len("fnsbench."):], a, b))
        elif e.device_type == DeviceType.CUDA and not getattr(
                e, "is_user_annotation", False):
            ops.append((e.name, a, b))
    if not ops:
        return None
    return DeviceTrace((t1 - t0) / 1e6, ops, host)


def activities(device: torch.device) -> list:
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def warm_profiler(device: torch.device) -> None:
    """One short profile in set-up: the first start of the device tracer
    in a process takes seconds, which would otherwise fall in the
    window."""
    with torch.profiler.profile(activities=activities(device)):
        torch.ones(1, device=device).add_(1)
        if device.type == "cuda":
            torch.cuda.synchronize(device)


class Stretch:
    """Profiles the window from ``start`` (host clock) to its close, so
    that stopping the profiler and reading its events fall outside it."""

    def __init__(self, start: float, device: torch.device):
        self.start = start
        self.device = device
        self.prof = None
        self.host = None          # (start, stop) on the host clock
        self.trace = None

    def tick(self, now: float, clock) -> None:
        if self.prof is None and self.host is None and now >= self.start:
            self.prof = torch.profiler.profile(
                activities=activities(self.device))
            self.prof.__enter__()
            with torch.profiler.record_function(START):
                self.host = (clock(), None)

    def finish(self, clock) -> None:
        if self.prof is None:
            return
        with torch.profiler.record_function(STOP):
            self.host = (self.host[0], clock())
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        self.prof.__exit__(None, None, None)
        self.trace = reduce(self.prof)
        self.prof = None


def idle_pct(trace: DeviceTrace | None) -> float | None:
    if trace is None or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
