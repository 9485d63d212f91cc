"""Spans around the calls into each layer, and the device trace of a
traced window.

The spans are the benchmark's own: a named host-clock range around a
method of the program, wrapped on the instance (``wrap``), so the
program's code is untouched. Each span is also a ``record_function``
range, so the device trace can say which span a device gap fell in.

``profile(fn)`` runs ``fn`` under ``torch.profiler`` (host and CUDA
activity) and reduces the trace to device intervals (kernels, copies,
memsets). The trace also puts each host op's range on the device timeline
under the op's name; those are dropped, as the port's
``profile_step.device_rows`` drops them, so no device time counts twice.
"""

from __future__ import annotations

import collections
import time

import torch

SPANS = ("reset", "step", "rollout", "update", "insert")


def _sync():
    """Wait for the device, where there is one (the benchmark's CPU tests
    drive the same code without)."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()


class Spans:
    """Host-clock totals and counts of named spans."""

    def __init__(self):
        self.total = collections.defaultdict(float)
        self.count = collections.defaultdict(int)

    def wrap(self, obj, attr: str, name: str, fence: bool = False):
        """Replace ``obj.attr`` on the instance by a spanned call;
        ``fence`` synchronises the device before and after, so the span
        holds the call's device time too."""
        fn = getattr(obj, attr)
        spans = self

        def spanned(*a, **kw):
            if fence:
                _sync()
            with torch.profiler.record_function(name):
                t0 = time.perf_counter()
                out = fn(*a, **kw)
                if fence:
                    _sync()
                spans.total[name] += time.perf_counter() - t0
            spans.count[name] += 1
            return out

        setattr(obj, attr, spanned)


def _ns(e, what: str) -> int:
    f = getattr(e, f"{what}_ns", None)
    if f is not None:
        return int(f())
    return int(getattr(e, f"{what}_us")() * 1000)


class Trace:
    """The device intervals of one traced window."""

    def __init__(self, device: list, host: list, window_s: float,
                 ops: list = ()):
        self.device = device      # [(start_ns, end_ns, name)], sorted
        self.host = host          # [(start_ns, end_ns, span name)]
        self.ops = ops            # [(start_ns, end_ns, host op name)]
        self.window_s = window_s  # host-clock length of the window

    def busy_s(self) -> float:
        """Seconds in which some device operation ran (the union)."""
        return sum(b - a for a, b in self.merged()) / 1e9

    def merged(self) -> list:
        out = []
        for a, b, _ in self.device:
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    def launches(self) -> int:
        return len(self.device)

    def by_name(self) -> dict:
        acc = collections.defaultdict(int)
        for a, b, n in self.device:
            acc[n] += b - a
        return acc

    def kernel_s(self, part: str) -> tuple:
        """(seconds, count) of the device operations whose name holds
        ``part``."""
        s = [b - a for a, b, n in self.device if part in n]
        return sum(s) / 1e9, len(s)

    def idle_gaps(self, top: int = 10) -> list:
        """The longest gaps between device intervals, each named by what
        the host was doing when it began: the innermost benchmark span and
        the innermost host op (``span/op``)."""
        m = self.merged()
        gaps = [(b0, a1) for (_, b0), (a1, _) in zip(m[:-1], m[1:])
                if a1 > b0]
        gaps.sort(key=lambda g: g[0] - g[1])
        gaps = gaps[:top]
        held = {a: [] for a, _ in gaps}
        for s0, s1, n in list(self.host) + list(self.ops):
            for a in held:
                if s0 <= a < s1:
                    held[a].append((s1 - s0, n in SPANS, n))
        out = []
        for a, b in gaps:
            span = min((h for h in held[a] if h[1]), default=None)
            op = min((h for h in held[a] if not h[1]), default=None)
            # outside any op the host is in Python, between ops
            out.append([f"{span[2] if span else 'other'}/"
                        f"{op[2] if op else 'python'}", (b - a) / 1e9])
        return out

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.by_name().items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n[:160], v / 1e9] for n, v in ops],
                "idle_gaps": self.idle_gaps(top)}


def start():
    """A running torch.profiler (host and CUDA activity)."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile
    _sync()
    prof = tprofile(activities=[ProfilerActivity.CPU,
                                ProfilerActivity.CUDA])
    prof.start()
    return prof


def finish(prof, window_s: float) -> Trace:
    """Stop ``prof`` (the device already waited for) and reduce its trace
    to device intervals and benchmark spans."""
    prof.stop()
    events = prof.profiler.kineto_results.events()
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    host_names, host, device = set(), [], []
    ops = []
    for e in events:
        if e.device_type() == cpu:
            host_names.add(e.name())
            s = _ns(e, "start")
            (host if e.name() in SPANS else ops).append(
                (s, s + _ns(e, "duration"), e.name()))
    for e in events:
        if e.device_type() == cuda and e.name() not in host_names:
            s = _ns(e, "start")
            device.append((s, s + _ns(e, "duration"), e.name()))
    device.sort()
    return Trace(device, host, window_s, ops)


def profile(fn) -> tuple:
    """(fn's result, Trace) of one call of ``fn`` under torch.profiler,
    synchronised before and after; the window is that call."""
    prof = start()
    t0 = time.perf_counter()
    out = fn()
    _sync()
    window = time.perf_counter() - t0
    return out, finish(prof, window)
