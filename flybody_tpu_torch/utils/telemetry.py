"""The port's spans and counters: on while a torch profiler records, and
nothing else turns them on.

    from flybody_tpu_torch.utils import telemetry as tm

    with tm.span("physics.collision"):
        d = col.collision(m, d)
    tm.count("solver.rows", R * B)          # a host number, summed at once
    tm.count("solver.rows_used", d.sol_f)   # a tensor, kept by reference
    ...
    tm.counters()   # {name: float}, after the profiler stopped
    tm.clear()

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


def span(name: str):
    """A ``record_function`` range named ``name`` while a profiler
    records, else the shared no-op context."""
    if _profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _OFF


def spanned(name: str):
    """A decorator: each call of the function runs inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


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
    """{name: total} of every counter since the last ``clear()``; waits
    once for the device, where tensors were counted."""
    out = dict(_host)
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
