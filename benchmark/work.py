"""The yardstick's counting functions: operations and bytes from the
configuration's sizes alone, and the published peaks they are held to.

They give the same count whatever code implements the step. B1's
(``solve_rows``) loop counts are fixed, so its count is exact for any
data; the arithmetic is a frozen copy of the port's
``ops/solver_kernels.solve_rows_work`` and of ``chip_smoke.bound``.
"""

from __future__ import annotations

# One NVIDIA H100 SXM (NVIDIA's data sheet, 700 W): float32 outside the
# tensor cores, and device memory bandwidth.
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12


def solve_rows_flops(nv: int, R: int, B: int, n_up: int, n_down: int,
                     iterations: int, noslip_iterations: int,
                     power_iters: int) -> float:
    """Floating-point operations of one ``solve_rows`` call: J build
    15 nv R, rhs 4 nv R, up-solve 2 n_up R, D^{-1/2} scaling and diag
    3 nv R, one Yd^T Yd application 4 nv R per power / APGD / noslip
    iteration, the final Yd f 2 nv R and the two output sweeps
    2 (n_up + n_down), per env."""
    napply = power_iters + iterations + 2 * noslip_iterations
    per_env = (nv * R * (15 + 4 + 3 + 2 + 4 * napply) + 2 * n_up * R
               + 2 * (n_up + n_down))
    return float(per_env) * B


def solve_rows_bytes(nv: int, R: int, B: int, nbody: int, nM: int,
                     kc: int) -> float:
    """Bytes one ``solve_rows`` call must move, each input read once and
    each output written once (4-byte floats and ints): d6 (nv, 6, B),
    u6 (R, 6, B), b1, b2, lim_sign, lim_dadr, kcoef, bcoef, posr, rreg,
    active, f0, v0 (R, B) each, maskd (nbody, nv), ld (nM, B), dinv,
    qacc_smooth, qvel (nv, B) each, mu (max(kc, 1), B); out f, v (R, B)
    and qfrc, dqacc (nv, B)."""
    words = (nv * 6 * B + R * 6 * B + 13 * R * B + nbody * nv + nM * B
             + 3 * nv * B + max(kc, 1) * B + 2 * R * B + 2 * nv * B)
    return 4.0 * words


def bound_s(flops: float, moved: float) -> float:
    """The least seconds the card could take: the larger of operations
    over the float32 peak and bytes over the bandwidth."""
    return max(flops / PEAK_F32, moved / PEAK_BYTES)


def b1_per_call(body: dict, B: int) -> tuple:
    """(operations, bytes) of one B1 call on a configuration's ``body``."""
    flops = solve_rows_flops(body["nv"], body["R"], B, body["n_up"],
                             body["n_down"], body["solver_iterations"],
                             body["noslip_iterations"], body["power_iters"])
    moved = solve_rows_bytes(body["nv"], body["R"], B, body["nbody"],
                             body["nM"], body["kc"])
    return flops, moved


def sim_step_flops(body: dict, B: int) -> float:
    """Counted operations of one control step of B envs: B1's exact count
    times the substeps (B1 runs once per substep). Kinematics, collision
    and the other eager stages are not counted, so a share of the peak
    built on this is a floor."""
    return b1_per_call(body, B)[0] * body["substeps"]


def mlp_flops(sizes: list, rows: int) -> float:
    """Forward operations of a dense stack ``sizes`` = [in, h1, ..., out]
    over ``rows`` rows: 2 x in x out per layer per row."""
    return float(sum(2 * a * b for a, b in zip(sizes[:-1], sizes[1:])
                     )) * rows
