"""Where the time of the solve_rows kernel goes, by cutting parts out.

    python3 -m flybody_tpu_torch.profile_solve_rows [--task TASK] [PKG_DIR ...]

Builds the solve_rows inputs of TASK (a ``fly_envs`` factory:
walk_on_ball by default, R 152 rows, the narrow instance; walk_imitation,
R 176, the wide one) on the card: B=4096, float32, a reset from a seeded
CUDA generator and two control steps at mid-range actions. Then, for each
package directory
(default: this package; an older version unpacked with
``git archive <rev> flybody_tpu_torch | tar -x -C DIR`` is given as
DIR/flybody_tpu_torch), it copies the package into ``_build/profile/``,
cuts ``csrc/solve_rows.cu`` there and times solve_rows (CUDA events, 20
calls) in a fresh process for each version of the source:

    full        the kernel as it is
    no_sweeps   without the output sweeps (qfrc = L^T ..., dqacc = L^-1 ...)
    no_upsweep  also without the up-sweep of Yd

each with the main path's solver loop and with the loop off (iterations,
noslip and power iterations 0). Prints one JSON line per package. The
cuts are textual and know three versions of the source (the first port,
the register-tiled redesign, and the one with the top chain out of the
up-sweep's pull); any other source raises. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys

PKG = os.path.dirname(os.path.abspath(__file__))
SCRATCH = os.path.join(PKG, "_build", "profile")
INPUTS = os.path.join(SCRATCH, "fly_inputs.pt")

# Each cut lists alternatives, one per version of the source; an
# alternative is a list of edits (start, end, replacement), each replacing
# the text from start up to end. The first alternative whose first start
# is found applies.
_SWEEPS = [
    [("    // ---- 7. qfrc = L^T", "    // ---- 7. qfrc = L^T",
      "    return;\n")],
    [("    if (r == 0) {\n        for (int k = 0; k < nv; ++k)\n",
      "    __syncthreads();\n    for (int k = r; k < nv; k += T) {", "")],
]
_UPSWEEP = [
    # the pull, the top chain's sums and its resolution (both instances)
    [("        pull(p, cptr, cidx, S, r, max(v0, m), v1);\n",
      "    }\n    if (lower) {", ""),
     ("    if (m > 0) chain_resolve(", "    *diag = ", "")],
    [("    for (int j = nv - 1; j >= 0; --j) {\n", "    float dg = 0.0f;",
      "")],
    [("    for (int t = 0; t < n_up; ++t) {\n", "    float dg = 0.0f;", "")],
]
CUTS = {"full": [], "no_sweeps": [_SWEEPS],
        "no_upsweep": [_SWEEPS, _UPSWEEP]}

_TIME = r"""
import json, sys, torch, numpy as np
from flybody_tpu_torch.ops import solver_kernels as SK, tree_ldl as TL
d = torch.load(sys.argv[1])
tree = TL.build_tree_meta(np.asarray(d["parent"], np.int32))
kw0 = dict(d["kw"], iterations=0, noslip_iterations=0, power_iters=0)
def ms(kw, reps=20):
    SK.solve_rows(tree, **d["args"], **kw)
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        SK.solve_rows(tree, **d["args"], **kw)
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps
print(json.dumps({"loop_on": ms(d["kw"]), "loop_off": ms(kw0)}))
"""


def cut(src: str, cuts) -> str:
    """``src`` with each cut applied (one alternative of each)."""
    for alternatives in cuts:
        for edits in alternatives:
            if src.find(edits[0][0]) < 0:
                continue
            for start, end, repl in edits:
                i = src.index(start)
                j = src.index(end, i)
                src = src[:i] + repl + src[j:]
            break
        else:
            raise ValueError("profile_solve_rows: no cut matches this "
                             "version of csrc/solve_rows.cu")
    return src


def make_inputs(task: str = "walk_on_ball", B: int = 4096) -> None:
    """``task``'s solve_rows inputs after two control steps, saved."""
    import torch
    from flybody_tpu_torch import fly_envs
    from flybody_tpu_torch.physics import forward as F
    from flybody_tpu_torch.physics import solver_fused as SF
    env = getattr(fly_envs, task)()
    lo, hi = env.action_spec()
    mid = torch.as_tensor((lo + hi) / 2, dtype=torch.float32,
                          device="cuda")[None].expand(B, -1)
    state = env.reset(B, torch.Generator("cuda").manual_seed(0))
    for _ in range(2):
        state = env.autoreset_step(state, mid)
    m = env.model
    prob = SF.assemble(m, F.smooth_forward(m, state.data))
    os.makedirs(SCRATCH, exist_ok=True)
    torch.save(dict(args=prob["args"], kw=prob["kw"],
                    parent=[int(p) for p in m.dof_parentid]), INPUTS)


def profile(package: str) -> dict:
    """{cut: {"loop_on": ms, "loop_off": ms}} for one package directory."""
    out = {}
    for name, cuts in CUTS.items():
        root = os.path.join(SCRATCH, name)
        shutil.rmtree(root, ignore_errors=True)
        dst = os.path.join(root, "flybody_tpu_torch")
        shutil.copytree(package, dst, ignore=shutil.ignore_patterns(
            "_build", "__pycache__"))
        path = os.path.join(dst, "csrc", "solve_rows.cu")
        with open(path) as fh:
            src = cut(fh.read(), cuts)
        with open(path, "w") as fh:
            fh.write(src)
        res = subprocess.run([sys.executable, "-c", _TIME, INPUTS],
                             cwd=root, capture_output=True, text=True,
                             check=True)
        out[name] = json.loads(res.stdout.strip().splitlines()[-1])
        shutil.rmtree(root)
    return out


def main(argv) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--task", default="walk_on_ball",
                    choices=("walk_on_ball", "walk_imitation"))
    ap.add_argument("packages", nargs="*", default=[PKG])
    args = ap.parse_args(argv)
    os.makedirs(SCRATCH, exist_ok=True)
    make_inputs(args.task)
    for package in args.packages:
        print(json.dumps({"task": args.task, "package": package,
                          **profile(package)}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
