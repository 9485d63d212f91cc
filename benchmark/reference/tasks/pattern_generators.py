"""Wing-beat pattern generator (WBPG): device tables and batched index
arithmetic.

201 frequency variants of a cyclic wing-beat sequence are computed once in
numpy (repeat counts chosen to minimise the phase error at the cycle
boundary), padded into one (num_freqs, max_len, 6) float32 table and held
on the env's device. ``reset`` and ``step`` work on a batch of envs: the
per-env state (table row, position in the sequence, filtered frequency)
lives in (B,) tensors, and nothing is read back to the host.

The arithmetic follows the JAX package's generator operation for
operation: the frequency filter and every table lookup run in float32
whatever the env's dtype (only the blend of the old and the requested
frequency runs in the request's dtype), the phase table's padding is 1e9
and is read modulo 1, and ties in an argmin go to the first index.

``synthetic_base_pattern`` is a one-cycle drosophila-like pattern for runs
without a recorded one; a recorded (n, 3) pattern can be passed instead.

A frozen plain copy of the program's generator. ``reset`` reads the
phase in float32 whatever its dtype, as the program's float32 env does, so
that a float64 reference picks the program's table positions.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from benchmark.reference.tasks import constants as C


def synthetic_base_pattern(n: int = 100) -> np.ndarray:
    """One wing-beat cycle (n, 3): yaw (stroke), roll (deviation),
    pitch (rotation). Amplitudes/phases approximate published drosophila
    kinematics about the model's wing springrefs."""
    t = np.linspace(0.0, 1.0, n, endpoint=False)
    yaw = 1.25 * np.cos(2 * np.pi * t)
    roll = 0.25 * np.sin(4 * np.pi * t) + 0.1
    pitch = -0.45 + 1.0 * np.sin(2 * np.pi * t + 0.65)
    return np.stack([yaw, roll, pitch], axis=-1).astype(np.float32)


@dataclasses.dataclass
class WBPGState:
    freq_idx: torch.Tensor   # (B,) int64 table row
    step: torch.Tensor       # (B,) int64 position in the row's sequence
    ctrl_freq: torch.Tensor  # (B,) float32 filtered requested frequency, Hz


def build_tables(base_pattern: np.ndarray, beat_freqs: np.ndarray,
                 min_repeats: int, max_repeats: int, dt_ctrl: float):
    """(table (F, L, 6), phase_table (F, L), cycle_len (F,)) in numpy: per
    beat frequency, the pattern repeated a whole number of times and
    resampled at the control rate; rows shorter than the longest are
    filled cyclically, their phases padded with 1e9."""
    trajs, phases, lens = [], [], []
    for beat_freq in beat_freqs:
        beat_time = 1.0 / beat_freq
        reps = np.arange(min_repeats, max_repeats + 1)
        rel_error = ((reps * beat_time) % dt_ctrl) / dt_ctrl
        a1 = int(np.argmin(rel_error))
        a2 = int(np.argmin(np.abs(1 - rel_error)))
        if rel_error[a1] < np.abs(1 - rel_error[a2]):
            n_reps, shift = int(reps[a1]), dt_ctrl
        else:
            n_reps, shift = int(reps[a2]), 0.0
        repeated = np.tile(base_pattern, (n_reps, 1))
        phase = np.linspace(0, n_reps, repeated.shape[0], endpoint=False)
        dt_data = beat_time / base_pattern.shape[0]
        duration = repeated.shape[0] * dt_data
        t_data = np.linspace(0, duration, repeated.shape[0])
        t_ctrl = np.arange(0, duration - shift, dt_ctrl)
        traj = np.stack([np.interp(t_ctrl, t_data, repeated[:, i])
                         for i in range(repeated.shape[1])], axis=-1)
        trajs.append(traj.astype(np.float32))
        phases.append(np.interp(t_ctrl, t_data, phase).astype(np.float32))
        lens.append(traj.shape[0])
    max_len = max(lens)
    table = np.zeros((len(beat_freqs), max_len, trajs[0].shape[1]),
                     np.float32)
    ptable = np.full((len(beat_freqs), max_len), 1e9, np.float32)
    for i, (tr, ph) in enumerate(zip(trajs, phases)):
        table[i, :len(tr)] = tr
        if len(tr) < max_len:
            # cyclic fill keeps padded reads on-pattern (never indexed in
            # steady state: step wraps at cycle_len)
            idx = np.arange(len(tr), max_len) % len(tr)
            table[i, len(tr):] = tr[idx]
        ptable[i, :len(ph)] = ph
    return table, ptable, np.asarray(lens, np.int32)


class WingBeatPatternGenerator:
    """The tables on ``device`` and batched reset/step over them."""

    def __init__(self, base_pattern: np.ndarray | None = None,
                 base_beat_freq: float = C.WING_PARAMS["base_freq"],
                 rel_freq_range: float = C.WING_PARAMS["rel_freq_range"],
                 num_freqs: int = C.WING_PARAMS["num_freqs"],
                 min_repeats: int = 10, max_repeats: int = 20,
                 dt_ctrl: float = C.FLY_CONTROL_TIMESTEP,
                 ctrl_filter: float = 0.5 / C.WING_PARAMS["base_freq"],
                 device=None):
        if base_pattern is None:
            base_pattern = synthetic_base_pattern()
        base_pattern = np.tile(base_pattern, (1, 2))  # both wings
        self.base_beat_freq = base_beat_freq
        self.dt_ctrl = dt_ctrl
        self.ctrl_filter = ctrl_filter
        self.rate = float(np.exp(-dt_ctrl / ctrl_filter)) \
            if ctrl_filter else 0.0
        self.beat_freqs = np.linspace((1 - rel_freq_range) * base_beat_freq,
                                      (1 + rel_freq_range) * base_beat_freq,
                                      num_freqs)
        table, ptable, lens = build_tables(base_pattern, self.beat_freqs,
                                           min_repeats, max_repeats, dt_ctrl)
        self.n_angles = table.shape[-1]
        self.table = torch.as_tensor(table, device=device)
        self.phase_table = torch.as_tensor(ptable, device=device)
        # read modulo 1 by every frequency switch: computed once
        self.phase_frac = torch.remainder(self.phase_table, 1.0)
        self.cycle_len = torch.as_tensor(lens.astype(np.int64),
                                         device=device)
        self.beat_freqs_t = torch.as_tensor(
            self.beat_freqs.astype(np.float32), device=device)

    @property
    def device(self) -> torch.device:
        return self.table.device

    def _nearest_row(self, f: torch.Tensor) -> torch.Tensor:
        """(B,) row of the beat frequency nearest each float32 f (B,)."""
        return torch.argmin(torch.abs(self.beat_freqs_t - f[:, None]), dim=1)

    def reset(self, initial_phase: torch.Tensor, ctrl_freq=None):
        """-> (angles (B, 6) float32, qvel (B, 6) float32, WBPGState) at the
        table position nearest each env's ``initial_phase`` (B,)."""
        B = initial_phase.shape[0]
        f = torch.full((B,), self.base_beat_freq if ctrl_freq is None
                       else ctrl_freq, dtype=torch.float32,
                       device=self.device)
        idx = self._nearest_row(f)
        phase = initial_phase.to(torch.float32)
        step = torch.argmin(torch.abs(phase[:, None]
                                      - self.phase_table[idx]), dim=1)
        angles = self.table[idx, step]
        nxt = self.table[idx, torch.remainder(step + 1, self.cycle_len[idx])]
        # times the reciprocal, as the JAX package's compiled reset
        # rounds this float32 quotient
        qvel = (nxt - angles) * (1.0 / self.dt_ctrl)
        return angles, qvel, WBPGState(freq_idx=idx, step=step, ctrl_freq=f)

    def step(self, state: WBPGState, ctrl_freq: torch.Tensor):
        """-> (angles (B, 6) float32, new state). The filtered frequency
        picks the table row; a row switch keeps the wing-beat phase."""
        step = torch.remainder(state.step + 1,
                               self.cycle_len[state.freq_idx])
        if self.ctrl_filter == 0.0:
            f = ctrl_freq
        else:
            f = (state.ctrl_freq.to(ctrl_freq.dtype) * self.rate
                 + ctrl_freq * (1.0 - self.rate))
        f = f.to(state.ctrl_freq.dtype)
        idx_new = self._nearest_row(f)
        changed = idx_new != state.freq_idx
        cur_phase = self.phase_frac[state.freq_idx, step]
        step_new = torch.argmin(torch.abs(cur_phase[:, None]
                                          - self.phase_frac[idx_new]), dim=1)
        step = torch.where(changed, step_new, step)
        idx = torch.where(changed, idx_new, state.freq_idx)
        angles = self.table[idx, step]
        return angles, WBPGState(freq_idx=idx, step=step, ctrl_freq=f)
