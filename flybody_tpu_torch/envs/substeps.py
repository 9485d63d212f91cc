"""The physics substeps of one control step, run eager or replayed as one
CUDA graph.

    data, sensor_mean, sol_f = substeps.run(model, data, n_substeps)

    graphs = substeps.Graphs()          # one per env
    (data, sensor_mean, sol_f), replayed = graphs(model, data, n_substeps)

``run`` is the loop: substep k runs the full collision selection where
k % col_refresh == 0 and refreshes the selected lanes' geometry
otherwise. It returns the final Data, the substeps' mean sensordata and
each substep's ``sol_f`` (B1's forces, for the counter
``solver.rows_used``).

``Graphs`` runs the same loop as one CUDA graph a key (the model and
its timestep tensor, which ``FlyEnv`` sets, the substeps, the shapes
and dtypes of the Data's tensors, so the batch, the dtype and the
device, and the TF32 and determinism switches) where ``engages`` admits
it: the Data on a CUDA device, the fused contact solve (whose loop
launches every kernel without waiting for the device), and no autograd
through the loop. Elsewhere it runs ``run``.

A key's first call runs the loop eager on a side stream, and its result
is the call's: that run loads every kernel and fills every per-model
cache. The graph is then captured on that stream into its own memory
pool; a capture error raises. It holds one ``col_refresh`` block of
substeps where col_refresh > 1 divides the substeps (every block runs
the same schedule, and the block's end copies its state into the
graph's inputs, where the next block starts), else the whole schedule.
Every later call copies the caller's Data into the graph's static
inputs, replays the graph once a block on the current stream and hands
back fresh copies of what it wrote, so no returned tensor aliases a
graph buffer: a state kept across steps stays as it was. A field the
loop leaves as it is comes back as the caller's own tensor, as eager.

A replay calls no Python: the ``physics.*`` spans, the kernel wrappers'
``.launches`` (host calls: the eager run and the capture call each
wrapper, a replay calls none) and their telemetry counters
(``ccd.lanes``, ``kinematics.bodies``) see eager calls only; a device
trace shows a replay's kernels one by one. ``sol_f`` comes back (as a fresh copy)
only while a profiler records.
"""

from __future__ import annotations

import torch

from flybody_tpu_torch.physics import forward as F
from flybody_tpu_torch.physics.types import Data, Model
from flybody_tpu_torch.utils import telemetry as tm


def run(model: Model, data: Data, n_substeps: int) -> tuple:
    """(final Data, mean sensordata (nsensordata, B), each substep's
    sol_f) of ``n_substeps`` physics substeps from ``data``, eager."""
    data, sensors, sol_f = _substeps(model, data, n_substeps)
    return data, torch.stack(sensors).mean(dim=0), tuple(sol_f)


def _substeps(model: Model, data: Data, n_substeps: int) -> tuple:
    """(final Data, each substep's sensordata, each substep's sol_f)."""
    r = int(model.col_refresh or 1)
    sensors, sol_f = [], []
    for k in range(n_substeps):
        data = F.step(model, data, col_update=(r > 1 and k % r != 0))
        sensors.append(data.sensordata)
        sol_f.append(data.sol_f)
    return data, sensors, sol_f


def leaves(d: Data) -> list:
    """The tensors of a Data, its contact's among them, in the order of
    ``Data.map_tensors``."""
    ts: list = []
    d.map_tensors(lambda t: ts.append(t) or t)
    return ts


def rebuild(d: Data, it) -> Data:
    """``d`` with its tensors taken in ``leaves`` order from ``it``."""
    return d.map_tensors(lambda _: next(it))


def engages(model: Model, data: Data) -> bool:
    """True where the loop runs as a CUDA graph: the Data on a CUDA
    device, the fused contact solve, and no tensor of the loop's inputs
    requiring grad while grad mode is on."""
    if data.qpos.device.type != "cuda":
        return False
    if model.opt.contact_solver != "fused":
        return False
    if not torch.is_grad_enabled():
        return True
    params = [v for obj in (model, model.opt) for v in vars(obj).values()
              if isinstance(v, torch.Tensor)]
    return not any(t.requires_grad for t in leaves(data) + params)


def _by_dtype(ts, index=None) -> list:
    """Lists of ``index`` (by default the positions in ``ts``) grouped by
    the dtype of ``ts`` (a foreach copy takes its fast path on one
    dtype)."""
    groups: dict = {}
    for i, t in zip(range(len(ts)) if index is None else index, ts):
        groups.setdefault(t.dtype, []).append(i)
    return list(groups.values())


def _copy(dst, src, groups) -> None:
    for g in groups:
        torch._foreach_copy_([dst[i] for i in g], [src[i] for i in g])


class _Graph:
    """One captured substep loop (see the module doc). Where the graph
    holds one ``col_refresh`` block, a control step replays it once a
    block: the capture's Python pass and the graph's instantiation, both
    set-up, shrink with the block. A col_refresh of 1 would make the
    block one substep and the copy at its end one more pass over the
    state a substep, so such a model's graph holds the whole schedule."""

    def __init__(self, model: Model, n_substeps: int):
        # held so that the ids in the key stay this model's and timestep's
        self.model, self.timestep = model, model.opt.timestep
        self.n = n_substeps
        r = int(model.col_refresh or 1)
        self.block = r if r > 1 and n_substeps % r == 0 else n_substeps

    def capture(self, data: Data, ins: list) -> tuple:
        """The eager loop's result on ``data``; the loop captured."""
        dev = ins[0].device
        main = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            out = run(self.model, data, self.n)
        main.wait_stream(side)
        for t in [*leaves(out[0]), out[1], *out[2]]:
            t.record_stream(main)
        self.inputs = [t.clone() for t in ins]
        self.in_groups = _by_dtype(ins)
        self.graph = torch.cuda.CUDAGraph()
        with tm.unrecorded(), torch.no_grad(), \
                torch.cuda.graph(self.graph, stream=side):
            d, self.sensors, self.sol_f = _substeps(
                self.model, rebuild(data, iter(self.inputs)), self.block)
            if self.block < self.n:
                chain = [i for i, t in enumerate(leaves(d))
                         if t is not self.inputs[i]]
                _copy(self.inputs, leaves(d),
                      _by_dtype([self.inputs[i] for i in chain], chain))
        self.data = d
        # each output tensor: an input passed through (its index), or one
        # the graph wrote (copied out after a control step's replays)
        pos = {id(t): i for i, t in enumerate(self.inputs)}
        self.written, self.src = [], []
        seen: dict = {}
        for t in leaves(d):
            if id(t) in pos:
                self.src.append(("in", pos[id(t)]))
                continue
            if id(t) not in seen:
                seen[id(t)] = len(self.written)
                self.written.append(t)
            self.src.append(("out", seen[id(t)]))
        self.out_groups = _by_dtype(self.written)
        return out

    def replay(self, ins: list) -> tuple:
        """The loop on the Data whose tensors are ``ins``, replayed."""
        _copy(self.inputs, ins, self.in_groups)
        sensors, sol_f = [], []
        for _ in range(self.n // self.block):
            self.graph.replay()
            sensors.append(torch.stack(self.sensors))
            if tm.recording():
                sol_f.extend(torch.stack(self.sol_f).unbind(0))
        fresh = [torch.empty_like(t) for t in self.written]
        _copy(fresh, self.written, self.out_groups)
        outs = [ins[i] if kind == "in" else fresh[i]
                for kind, i in self.src]
        sensors = sensors[0] if len(sensors) == 1 else torch.cat(sensors)
        return (rebuild(self.data, iter(outs)), sensors.mean(dim=0),
                tuple(sol_f))


class Graphs:
    """The CUDA graphs of one env's substep loop, one a key (see the module
    doc). ``graphs(model, data, n)`` -> ((Data, sensor_mean, sol_f),
    replayed): ``run``'s result where the graph does not engage and on a
    key's first call, a replay's after it."""

    def __init__(self):
        self._graphs: dict = {}

    def __call__(self, model: Model, data: Data, n_substeps: int) -> tuple:
        if not engages(model, data):
            return run(model, data, n_substeps), False
        ins = leaves(data)
        key = (id(model), id(model.opt.timestep), n_substeps,
               int(model.col_refresh or 1),
               torch.backends.cuda.matmul.allow_tf32,
               torch.are_deterministic_algorithms_enabled(),
               tuple((t.shape, t.dtype, t.device) for t in ins))
        g = self._graphs.get(key)
        if g is None:
            g = _Graph(model, n_substeps)
            out = g.capture(data, ins)
            self._graphs[key] = g
            return out, False
        return g.replay(ins), True
