"""The traced window of a ``--trace 1`` run: torch.profiler with CPU and
CUDA activity around whole units of work, read from its raw events.

``Trace`` holds the device records (name, start ns, end ns) inside the
window, the host ops (name, start, end), the window's length and the
seconds in which some device record ran (the union of their intervals).
"""

from __future__ import annotations

import bisect
import contextlib

import torch

WINDOW_SPAN = "port_bench.window"
# host ops scanned back from an idle gap for the op that covers it
_SCAN = 4000


class Trace:
    def __init__(self, prof):
        from torch.autograd import DeviceType

        dev, host, win = [], [], None
        for e in prof.profiler.kineto_results.events():
            rec = (e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            if e.device_type() == DeviceType.CUDA:
                dev.append(rec)
            elif e.name() == WINDOW_SPAN:
                win = rec
            else:
                host.append(rec)
        # a span's device-side annotation (this window's, or one the
        # program records) bears its host record's name and is no device
        # work; kernels, copies and fills never share a host op's name
        spans = {r[0] for r in host} | {WINDOW_SPAN}
        dev = [r for r in dev if r[0] not in spans]
        if win is None:
            raise RuntimeError("the profiler recorded no window span")
        self.t0, self.t1 = win[1], win[2]
        self.window_s = (self.t1 - self.t0) / 1e9
        self.device = sorted((r for r in dev if r[2] > self.t0 and r[1] < self.t1),
                             key=lambda r: r[1])
        self.host = sorted(host, key=lambda r: r[1])
        self._host_starts = [r[1] for r in self.host]
        self.busy_intervals = self._union()
        self.busy_s = sum(b - a for a, b in self.busy_intervals) / 1e9

    def _union(self):
        out = []
        for _, a, b in self.device:
            a, b = max(a, self.t0), min(b, self.t1)
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    def gaps(self):
        """[(start ns, end ns)] of the window's idle time."""
        out, t = [], self.t0
        for a, b in self.busy_intervals:
            if a > t:
                out.append((t, a))
            t = max(t, b)
        if t < self.t1:
            out.append((t, self.t1))
        return out

    def host_op_at(self, t):
        """The innermost host op running at ``t``, or 'python' where none
        does (the interpreter between ops)."""
        k = bisect.bisect_right(self._host_starts, t)
        for i in range(k - 1, max(-1, k - 1 - _SCAN), -1):
            name, a, b = self.host[i]
            if b > t:
                return name
        return "python"

    def breakdown(self, top=10):
        """The device ops that took most time and the idle time by what
        the host was doing, each [name, seconds], at most ``top`` each."""
        ops = {}
        for name, a, b in self.device:
            ops[name] = ops.get(name, 0.0) + (b - a) / 1e9
        idle = {}
        for a, b in self.gaps():
            name = self.host_op_at(a)
            idle[name] = idle.get(name, 0.0) + (b - a) / 1e9
        pick = sorted(ops.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k[:160], v] for k, v in pick],
                "idle_gaps": [[k[:160], v] for k, v in gaps]}


@contextlib.contextmanager
def traced():
    """Profile the body; yields a holder whose ``trace`` is set on exit.
    Without a card (the CPU tests) the trace holds host ops alone."""
    from torch.profiler import ProfilerActivity, profile, record_function

    holder = type("Traced", (), {"trace": None})()
    cuda = torch.cuda.is_available()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    sync()
    with profile(activities=activities) as prof:
        with record_function(WINDOW_SPAN):
            yield holder
            sync()
    holder.trace = Trace(prof)
