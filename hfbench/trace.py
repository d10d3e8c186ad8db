"""The device trace of the traced jobs, read from ``torch.profiler``'s
events in memory (nothing is written to disk).

Device activity is every kernel, memcpy and memset on the card; their
union is the busy time. ``device_summary`` reads a profile of device
activity alone, takes the window from the host clock around its jobs, and
keeps the wall the same jobs took without the profiler. ``summarize`` reads a profile
with host operations too, whose window is the span of the harness's
``hfbench.window`` annotation: its idle gaps are the holes in the union,
each named by the innermost host operation running at its midpoint
("python" where none was).
"""

from __future__ import annotations

import dataclasses
import heapq

WINDOW = "hfbench.window"


@dataclasses.dataclass
class Summary:
    window_s: float
    busy_s: float
    #: device seconds by kernel (or copy) name, inside the window
    device_ops: dict
    #: idle seconds by what the host was doing
    idle_gaps: dict
    #: host-clock wall of the same jobs run without the profiler
    untraced_s: float | None = None

    def device_time(self, patterns) -> float:
        """Device seconds of every operation whose name contains one of
        ``patterns``."""
        return sum(s for name, s in self.device_ops.items() if any(p in name for p in patterns))

    def breakdown(self) -> dict:
        """The ten largest of each, as the result line carries them."""
        def head(d):
            return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]

        return {"device_ops": head(self.device_ops), "idle_gaps": head(self.idle_gaps)}


def _is_device(e) -> bool:
    from torch.autograd import DeviceType

    return e.device_type() == DeviceType.CUDA and not e.is_user_annotation()


def _union(spans) -> tuple[int, list]:
    """(covered nanoseconds, holes between the spans) of (start, end) spans."""
    busy, gaps, end = 0, [], None
    for s, e in sorted(spans):
        if end is not None and s > end:
            gaps.append((end, s))
        if end is None or e > end:
            busy += e - (s if end is None else max(s, end))
            end = e
    return busy, gaps


def device_summary(events, window_s: float, untraced_s: float) -> Summary:
    """A ``Summary`` of a device-only profile over ``window_s`` seconds of
    the host clock, of jobs that took ``untraced_s`` without the profiler
    (no idle gaps: nothing says what the host did)."""
    ops: dict = {}
    spans = []
    for e in events:
        if _is_device(e) and e.end_ns() > e.start_ns():
            ops[e.name()] = ops.get(e.name(), 0.0) + (e.end_ns() - e.start_ns()) * 1e-9
            spans.append((e.start_ns(), e.end_ns()))
    busy, _ = _union(spans)
    return Summary(window_s, busy * 1e-9, ops, {}, untraced_s)


def summarize(events) -> Summary:
    """Reduce the profiler's kineto events (``prof.profiler.kineto_results
    .events()``) to a ``Summary``."""
    host, device, window = [], [], None
    for e in events:
        if _is_device(e):
            device.append((e.start_ns(), e.end_ns(), e.name()))
        elif e.name() == WINDOW:
            window = (e.start_ns(), e.end_ns())
        else:
            host.append((e.start_ns(), e.end_ns(), e.name()))
    if window is None:
        raise RuntimeError(f"the trace holds no {WINDOW!r} span")
    t0, t1 = window
    ops: dict = {}
    spans = []
    for s, e, name in device:
        s, e = max(s, t0), min(e, t1)
        if e > s:
            ops[name] = ops.get(name, 0.0) + (e - s) * 1e-9
            spans.append((s, e))
    busy, gaps = _union([(t0, t0)] + spans + [(t1, t1)])
    # each gap's label: the open host operation that started last before
    # its midpoint, found by one sweep over the midpoints in order
    host.sort()
    idle: dict = {}
    open_ops, k = [], 0
    for g0, g1 in sorted(gaps, key=lambda g: g[0] + g[1]):
        mid = (g0 + g1) // 2
        while k < len(host) and host[k][0] <= mid:
            heapq.heappush(open_ops, (-host[k][0], host[k][1], host[k][2]))
            k += 1
        while open_ops and open_ops[0][1] < mid:
            heapq.heappop(open_ops)
        label = open_ops[0][2] if open_ops else "python"
        idle[label] = idle.get(label, 0.0) + (g1 - g0) * 1e-9
    return Summary((t1 - t0) * 1e-9, busy * 1e-9, ops, idle)
