"""On-device replay: a uniform-sampling ring buffer in device memory.

Transitions live in preallocated tensors with a leading capacity axis.
Insert writes a batch at the ring position (a wrapped ``index_copy_``,
overwriting the oldest items: FIFO); sampling draws indices uniformly with
replacement over the filled prefix and gathers them. ``size`` and
``insert_pos`` are host ints, so neither needs a device sync. The
samples-per-insert rate becomes a fixed number of updates per insert in
the training loop.
"""

from __future__ import annotations

import dataclasses

import torch

from flybody_tpu_torch.utils import telemetry as tm


def _fields(x) -> dict:
    if dataclasses.is_dataclass(x):
        return {f.name: getattr(x, f.name) for f in dataclasses.fields(x)}
    return dict(x)


class ReplayBuffer:
    """Ring of ``capacity`` items shaped like ``example`` (a dataclass or
    dict of tensors with a leading batch axis of 1), on ``device``."""

    def __init__(self, capacity: int, example, device=None):
        self.capacity = capacity
        self._kind = type(example)
        self.storage = {
            k: torch.zeros((capacity,) + tuple(v.shape[1:]), dtype=v.dtype,
                           device=device)
            for k, v in _fields(example).items()}
        self.insert_pos = 0
        self.size = 0

    @tm.spanned("replay.insert")
    def insert(self, batch) -> None:
        """Write a batch (leading dim K <= capacity) at the ring
        position."""
        items = _fields(batch)
        k = next(iter(items.values())).shape[0]
        if k > self.capacity:
            raise ValueError(f"insert of {k} items into a ring of "
                             f"{self.capacity}")
        some = next(iter(self.storage.values()))
        idx = (self.insert_pos + torch.arange(k, device=some.device)) \
            % self.capacity
        for name, store in self.storage.items():
            store.index_copy_(0, idx, items[name].to(store.dtype))
        self.insert_pos = (self.insert_pos + k) % self.capacity
        self.size = min(self.size + k, self.capacity)

    @tm.spanned("replay.sample")
    def sample(self, generator: torch.Generator | None, batch_size: int):
        """Uniform sample of ``batch_size`` items (with replacement) over
        the filled prefix, as the example's type."""
        some = next(iter(self.storage.values()))
        idx = torch.randint(0, max(self.size, 1), (batch_size,),
                            generator=generator, device=some.device)
        return self._kind(**{k: v.index_select(0, idx)
                             for k, v in self.storage.items()})
