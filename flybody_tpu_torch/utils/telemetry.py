"""The port's spans and counters: on while a torch profiler records, and
nothing else turns them on.

    from flybody_tpu_torch.utils import telemetry as tm

    with tm.span("physics.collision"):
        d = col.collision(m, d)
    tm.count("solver.rows", R * B)          # a host number, summed at once
    tm.count("solver.rows_used", d.sol_f)   # a tensor, kept by reference
    with tm.span("render.eyes", device=dev):   # and its device time
        ...
    tm.counters()   # {name: float}, after the profiler stopped
    tm.clear()
    with tm.unrecorded():   # what is counted inside is dropped
        ...

A span is a ``torch.profiler.record_function`` range while a profiler
records (``torch.profiler.profile`` or ``torch.autograd.profiler.profile``),
so it lies in the profiler's host timeline on the clock of the device
events, and names the stage the host was in. Otherwise ``span`` returns
one shared no-op context: the test is a read of the flag that torch's
profiler sets while it records.

A counter adds to one process-wide registry, and only while a profiler
records. A host number is summed at once. A tensor is kept by reference
and counts its non-zero elements when ``counters()`` reads the registry,
so counting launches nothing on the device: pass a tensor that the
program does not write again in place. The registry holds what every
profiled stretch counted until ``clear()``.

A span given a CUDA ``device`` also records a pair of CUDA timing events
at its two ends, on that device's current stream, kept in the registry;
``counters()`` reports the summed intervals as ``<name>.device_ms``. An
interval runs from the end of the device work queued before the span to
the end of the span's own, so it is the span's device time where the
span's kernels are long beside its launches.
"""

from __future__ import annotations

import collections
import contextlib
import functools

import torch
import torch.autograd.profiler as _profiler

_OFF = contextlib.nullcontext()
_host = collections.defaultdict(float)
_held = collections.defaultdict(list)
_events = collections.defaultdict(list)


def span(name: str, device=None):
    """A ``record_function`` range named ``name`` while a profiler
    records, else the shared no-op context; with a CUDA ``device``, timed
    on it as well."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    if device is not None and torch.device(device).type == "cuda":
        return _timed(name, torch.device(device))
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def _timed(name: str, device: torch.device):
    """``record_function(name)`` between two CUDA timing events on
    ``device``'s current stream, kept under ``name``."""
    stream = torch.cuda.current_stream(device)
    ends = (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))
    with torch.profiler.record_function(name):
        ends[0].record(stream)
        yield
        ends[1].record(stream)
    _events[name].append(ends)


def spanned(name: str):
    """A decorator: each call of the function runs inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def recording() -> bool:
    """True while a torch profiler records (spans and counters are on)."""
    return bool(_profiler._is_profiler_enabled)


def count(name: str, value) -> None:
    """Add ``value`` to the counter ``name`` while a profiler records: a
    host number as it is, a tensor as the number of its non-zero elements,
    reduced when the counters are read."""
    if not _profiler._is_profiler_enabled:
        return
    if isinstance(value, torch.Tensor):
        _held[name].append(value)
    else:
        _host[name] += value


def counters() -> dict:
    """{name: total} of every counter since the last ``clear()``, and
    ``<span>.device_ms`` of every timed span; waits for the device where
    tensors were counted or spans timed."""
    out = dict(_host)
    for n, pairs in _events.items():
        out[n + ".device_ms"] = 0.0
        for a, b in pairs:
            b.synchronize()
            out[n + ".device_ms"] += a.elapsed_time(b)
    held = [(n, t) for n, ts in _held.items() for t in ts]
    if held:
        dev = held[0][1].device
        nz = torch.stack([torch.count_nonzero(t).to(dev)
                          for _, t in held]).tolist()
        for (n, _), v in zip(held, nz):
            out[n] = out.get(n, 0.0) + v
    return {n: float(v) for n, v in out.items()}


def clear() -> None:
    """Empty the registry."""
    _host.clear()
    _held.clear()
    _events.clear()


@contextlib.contextmanager
def unrecorded():
    """Counters and timed spans made inside are dropped on exit: the
    capture of a CUDA graph runs the program's code, but its work runs
    later, on each replay."""
    saved = (dict(_host), {n: list(v) for n, v in _held.items()},
             {n: list(v) for n, v in _events.items()})
    try:
        yield
    finally:
        clear()
        _host.update(saved[0])
        _held.update(saved[1])
        _events.update(saved[2])
