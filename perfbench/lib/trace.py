"""The profiler's events, reduced in memory to what the readers need.

``torch.profiler`` records the host's operations, the CUDA runtime calls
and the device's kernels, copies and fills over the traced ticks; nothing
is written to disk (a PCG tick dispatches hundreds of thousands of
operations). The traced window is the span from the first traced tick's
start to the last one's end, as the ticks' ``record_function`` ranges
give it on the trace's own clock.
"""

from __future__ import annotations

import bisect

TICK = "perfbench.tick"
DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
# runtime calls after which the host waits for the device: a host look
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpy", "cudaMemcpy2D",
              "cudaMemcpyFromSymbol")


def _activities():
    import torch

    return [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]


def warm() -> None:
    """Start and stop the profiler once in set-up, so that its own first
    start does not fall inside the window."""
    import torch

    with torch.profiler.profile(activities=_activities()):
        torch.zeros(1, device="cuda").add_(1)
        torch.cuda.synchronize()


def start():
    import torch

    prof = torch.profiler.profile(activities=_activities())
    prof.start()
    return prof


def stop(prof) -> "Trace":
    import torch

    torch.cuda.synchronize()
    prof.stop()
    return Trace(prof.profiler.kineto_results.events())


def _kind(e) -> str:
    """The event's activity: ``kernel``, ``gpu_memcpy``, ``gpu_memset``,
    ``cuda_runtime``, ``user_annotation``, ``cpu_op`` or ``other``, read
    from the device the event ran on and its name."""
    name = e.name()
    annotation = getattr(e, "is_user_annotation", lambda: False)()
    if str(e.device_type()).endswith("CUDA"):
        if annotation or name == TICK:
            return "other"
        if name.startswith("Memcpy"):
            return "gpu_memcpy"
        if name.startswith("Memset"):
            return "gpu_memset"
        return "kernel"
    if annotation:
        return "user_annotation"
    if name.startswith("cuda") or (name.startswith("cu")
                                   and "::" not in name):
        return "cuda_runtime"
    return "cpu_op"


def _union(intervals):
    """Merged, sorted ``(start, end)`` intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return out


class Trace:
    """Intervals in nanoseconds of the trace's clock: ``ticks`` (the traced
    ticks), ``device`` (kernels, copies, fills: ``(start, end, name,
    activity)``), ``runtime`` (CUDA API calls: ``(start,
    end, name)``), ``host`` (the host's operations)."""

    def __init__(self, events):
        self.ticks, self.device, self.runtime, self.host = [], [], [], []
        for e in events:
            kind = _kind(e)
            name = e.name()
            s = e.start_ns()
            t = s + e.duration_ns()
            if kind in DEVICE_KINDS:
                self.device.append((s, t, name, kind))
            elif kind.startswith("cuda_"):
                self.runtime.append((s, t, name))
            elif name == TICK and kind in ("user_annotation", "cpu_op"):
                self.ticks.append((s, t))
            elif kind in ("cpu_op", "user_annotation"):
                self.host.append((s, t, name))
        if not self.ticks:
            raise RuntimeError("the trace holds no traced tick")
        self.ticks.sort()
        self.lo = self.ticks[0][0]
        self.hi = self.ticks[-1][1]
        self.window_s = (self.hi - self.lo) * 1e-9
        self.device = [(max(s, self.lo), min(t, self.hi), n, k)
                       for s, t, n, k in self.device
                       if t > self.lo and s < self.hi]
        self.runtime = [r for r in self.runtime
                        if self.lo <= r[0] < self.hi]
        self.busy = _union([(s, t) for s, t, _, _ in self.device])
        self.busy_s = sum(b - a for a, b in self.busy) * 1e-9

    @property
    def n_ticks(self) -> int:
        return len(self.ticks)

    def count_device(self, kind: str) -> int:
        return sum(1 for d in self.device if d[3] == kind)

    def count_syncs(self) -> int:
        return sum(1 for r in self.runtime if r[2] in SYNC_CALLS)

    def gaps(self):
        """Idle intervals ``(start, end)`` of the device in the window."""
        out, cur = [], self.lo
        for a, b in self.busy:
            if a > cur:
                out.append((cur, a))
            cur = max(cur, b)
        if self.hi > cur:
            out.append((cur, self.hi))
        return out

    def _host_at(self, starts, ops, t: int) -> str:
        """The innermost host operation or runtime call running at ``t``."""
        i = bisect.bisect_right(starts, t)
        for k in range(i - 1, max(i - 20000, -1), -1):
            s, e, name = ops[k]
            if e >= t:
                return name
        return "(host outside any operation)"

    def breakdown(self, top: int = 10, labelled: int = 5000) -> dict:
        """The device operations that took the most time, and the idle
        time by what the host was doing (the ``labelled`` longest gaps,
        each named by the host's innermost operation at its middle, summed
        by name)."""
        by_op: dict = {}
        for s, t, name, _ in self.device:
            by_op[name[:160]] = by_op.get(name[:160], 0) + (t - s) * 1e-9
        ops = sorted(self.host + self.runtime)
        starts = [o[0] for o in ops]
        idle: dict = {}
        gaps = sorted(self.gaps(), key=lambda g: g[0] - g[1])[:labelled]
        for a, b in gaps:
            name = self._host_at(starts, ops, (a + b) // 2)[:160]
            idle[name] = idle.get(name, 0) + (b - a) * 1e-9
        return {
            "device_ops": [[k, v] for k, v in sorted(
                by_op.items(), key=lambda kv: -kv[1])[:top]],
            "idle_gaps": [[k, v] for k, v in sorted(
                idle.items(), key=lambda kv: -kv[1])[:top]]}
