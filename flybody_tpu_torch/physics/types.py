"""Core types of the batched physics engine, as dataclasses of tensors.

Mirrors ``flybody_tpu/physics/types.py`` field for field:

* ``Model`` holds the numeric parameters as tensors on one device and the
  structural metadata (tree topology, joint types, pair tables, the sparse
  mass-matrix layout, ``names``) as static numpy.
* ``Data`` is the state of a whole batch of envs. Every tensor carries a
  trailing batch axis B (``qpos (nq, B)``, ``xpos (nbody, 3, B)``, ...), so
  each field can be compared one to one with the JAX package's.

Static numpy index tables are turned into device tensors once per model
(``Model.ix`` / ``Model.const``) so the hot path never copies indices from
the host.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

# Joint types (mjtJoint order).
FREE = 0
BALL = 1
SLIDE = 2
HINGE = 3

# Geom types (mjtGeom codes).
GEOM_PLANE = 0
GEOM_HFIELD = 1
GEOM_SPHERE = 2
GEOM_CAPSULE = 3
GEOM_ELLIPSOID = 4
GEOM_CYLINDER = 5
GEOM_BOX = 6
GEOM_MESH = 7

# Actuator dynamics / gain / bias types (mjt* codes).
DYN_NONE = 0
DYN_INTEGRATOR = 1
DYN_FILTER = 2
DYN_FILTEREXACT = 3
GAIN_FIXED = 0
GAIN_AFFINE = 1
BIAS_NONE = 0
BIAS_AFFINE = 1
# Transmission types.
TRN_JOINT = 0
TRN_TENDON = 3
TRN_BODY = 5  # adhesion

# Friction cone.
CONE_PYRAMIDAL = 0
CONE_ELLIPTIC = 1

# Integrators.
EULER = 0
RK4 = 1
IMPLICIT = 2

# Sensor types (the engine's own enum, independent of mjtSensor codes).
SENS_ACCELEROMETER = 0
SENS_GYRO = 1
SENS_VELOCIMETER = 2
SENS_FORCE = 3
SENS_TOUCH = 4
SENS_JOINTPOS = 5
SENS_JOINTVEL = 6
SENS_ACTUATORFRC = 7
SENS_FRAMEPOS = 8
SENS_FRAMEQUAT = 9
SENS_SUBTREECOM = 10
SENS_TENDONPOS = 11
SENS_TENDONVEL = 12
SENS_SUBTREELINVEL = 13
SENS_FRAMEZAXIS = 14
SENS_TORQUE = 15


def _map_tensors(obj, fn):
    """dataclasses.replace(obj) with ``fn`` applied to every tensor field
    (recursing into nested dataclasses)."""
    upd = {}
    for f in dataclasses.fields(obj):
        if not f.init:
            continue
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor):
            upd[f.name] = fn(v)
        elif dataclasses.is_dataclass(v) and not isinstance(v, type):
            upd[f.name] = _map_tensors(v, fn)
    return dataclasses.replace(obj, **upd)


class _Tensors:
    """replace() / map_tensors() / to() for dataclasses whose leaves are
    tensors."""

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)

    def map_tensors(self, fn):
        """A copy with ``fn`` applied to every tensor, those of nested
        dataclasses too, in field order."""
        return _map_tensors(self, fn)

    def to(self, device=None, dtype=None):
        """Move every tensor to ``device``; floating tensors also to
        ``dtype`` (integer index tensors keep theirs)."""
        def fn(t):
            if dtype is not None and t.is_floating_point():
                return t.to(device=device, dtype=dtype)
            return t.to(device=device)
        return self.map_tensors(fn)


@dataclasses.dataclass
class Option(_Tensors):
    """Simulation options (mjOption subset)."""

    timestep: torch.Tensor
    gravity: torch.Tensor          # (3,)
    density: torch.Tensor
    viscosity: torch.Tensor
    wind: torch.Tensor             # (3,)
    impratio: torch.Tensor
    tolerance: torch.Tensor
    integrator: int
    cone: int
    solver_iterations: int
    ls_iterations: int
    noslip_iterations: int
    has_fluid: bool
    contact_solver: str = "apgd"


MODEL_STATIC = (
    "nq", "nv", "nu", "na", "nbody", "njnt", "ngeom", "nsite", "ntendon",
    "nwrap", "nsensor", "nsensordata", "ncon_max", "nefc",
    "nhfield", "hfield_nrow", "hfield_ncol",
    "body_parentid", "body_rootid", "body_jntadr", "body_jntnum",
    "body_dofadr", "body_dofnum", "body_geomadr", "body_geomnum",
    "body_tree",
    "jnt_type", "jnt_qposadr", "jnt_dofadr", "jnt_bodyid", "jnt_limited",
    "dof_bodyid", "dof_jntid", "dof_parentid", "ancestor_mask",
    "body_dof_mask", "tree",
    "geom_type", "geom_bodyid", "geom_condim", "geom_priority",
    "geom_fluid_active", "site_bodyid",
    "ten_adr", "ten_num", "wrap_jntid",
    "actuator_trntype", "actuator_dyntype", "actuator_gaintype",
    "actuator_biastype", "actuator_trnid", "actuator_actadr",
    "actuator_ctrllimited", "actuator_forcelimited",
    "sensor_type", "sensor_objid", "sensor_objtype", "sensor_adr",
    "sensor_dim",
    "pair_geom1", "pair_geom2", "pair_type", "con_dim", "con_sel",
    "fused_sel", "names",
    "nccd", "ccd_budget", "ccd_classes", "ccd_iters",
    "ccd_geom1", "ccd_geom2", "ccd_b1", "ccd_b2", "ccd_rbsum",
    "col_refresh",
)

MODEL_TENSORS = (
    "qpos0", "qpos_spring", "body_pos", "body_quat", "body_ipos",
    "body_iquat", "body_mass", "body_subtreemass", "body_inertia",
    "body_invweight0", "jnt_pos", "jnt_axis", "jnt_range", "jnt_stiffness",
    "jnt_solref", "jnt_solimp", "jnt_margin", "dof_armature", "dof_damping",
    "dof_frictionloss", "dof_invweight0", "geom_pos", "geom_quat",
    "geom_size", "geom_friction", "geom_solref", "geom_solimp",
    "geom_solmix", "geom_margin", "geom_gap", "geom_fluid", "site_pos",
    "site_quat", "site_size", "ten_stiffness", "ten_damping",
    "ten_lengthspring", "ten_invweight0", "wrap_coef", "actuator_dynprm",
    "actuator_gainprm", "actuator_biasprm", "actuator_ctrlrange",
    "actuator_forcerange", "actuator_gear", "actuator_acc0", "hfield_data",
    "hfield_size", "con_solref", "con_solimp", "con_friction",
    "con_includemargin", "con_margin", "ccd_core", "ccd_solref",
    "ccd_solimp", "ccd_mu", "ccd_includemargin", "ccd_margin",
)


@dataclasses.dataclass(eq=False)
class Model(_Tensors):
    """Static model description + numeric parameters.

    Same fields as the JAX package's ``Model``: sizes and structure are
    Python ints, tuples and numpy arrays; numeric parameters are tensors
    on ``self.device``."""

    nq: int; nv: int; nu: int; na: int
    nbody: int; njnt: int; ngeom: int; nsite: int
    ntendon: int; nwrap: int; nsensor: int; nsensordata: int
    ncon_max: int; nefc: int
    nhfield: int; hfield_nrow: int; hfield_ncol: int

    body_parentid: np.ndarray; body_rootid: np.ndarray
    body_jntadr: np.ndarray; body_jntnum: np.ndarray
    body_dofadr: np.ndarray; body_dofnum: np.ndarray
    body_geomadr: np.ndarray; body_geomnum: np.ndarray
    body_tree: tuple
    jnt_type: np.ndarray; jnt_qposadr: np.ndarray; jnt_dofadr: np.ndarray
    jnt_bodyid: np.ndarray; jnt_limited: np.ndarray
    dof_bodyid: np.ndarray; dof_jntid: np.ndarray; dof_parentid: np.ndarray
    ancestor_mask: np.ndarray
    body_dof_mask: np.ndarray
    tree: Any              # ops.tree_ldl.TreeMeta
    geom_type: np.ndarray; geom_bodyid: np.ndarray
    geom_condim: np.ndarray; geom_priority: np.ndarray
    geom_fluid_active: np.ndarray
    site_bodyid: np.ndarray
    ten_adr: np.ndarray; ten_num: np.ndarray; wrap_jntid: np.ndarray
    actuator_trntype: np.ndarray; actuator_dyntype: np.ndarray
    actuator_gaintype: np.ndarray; actuator_biastype: np.ndarray
    actuator_trnid: np.ndarray; actuator_actadr: np.ndarray
    actuator_ctrllimited: np.ndarray; actuator_forcelimited: np.ndarray
    sensor_type: np.ndarray; sensor_objid: np.ndarray
    sensor_objtype: np.ndarray
    sensor_adr: np.ndarray; sensor_dim: np.ndarray
    pair_geom1: np.ndarray; pair_geom2: np.ndarray; pair_type: np.ndarray
    con_dim: np.ndarray
    con_sel: tuple
    fused_sel: tuple
    names: Any
    nccd: int
    ccd_budget: int
    ccd_classes: tuple
    ccd_iters: int
    ccd_geom1: np.ndarray; ccd_geom2: np.ndarray
    ccd_b1: np.ndarray; ccd_b2: np.ndarray
    ccd_rbsum: np.ndarray
    col_refresh: int

    opt: Option
    qpos0: torch.Tensor; qpos_spring: torch.Tensor
    body_pos: torch.Tensor; body_quat: torch.Tensor
    body_ipos: torch.Tensor; body_iquat: torch.Tensor
    body_mass: torch.Tensor; body_subtreemass: torch.Tensor
    body_inertia: torch.Tensor
    body_invweight0: torch.Tensor
    jnt_pos: torch.Tensor; jnt_axis: torch.Tensor
    jnt_range: torch.Tensor; jnt_stiffness: torch.Tensor
    jnt_solref: torch.Tensor; jnt_solimp: torch.Tensor
    jnt_margin: torch.Tensor
    dof_armature: torch.Tensor; dof_damping: torch.Tensor
    dof_frictionloss: torch.Tensor; dof_invweight0: torch.Tensor
    geom_pos: torch.Tensor; geom_quat: torch.Tensor; geom_size: torch.Tensor
    geom_friction: torch.Tensor; geom_solref: torch.Tensor
    geom_solimp: torch.Tensor; geom_solmix: torch.Tensor
    geom_margin: torch.Tensor; geom_gap: torch.Tensor
    geom_fluid: torch.Tensor
    site_pos: torch.Tensor; site_quat: torch.Tensor; site_size: torch.Tensor
    ten_stiffness: torch.Tensor; ten_damping: torch.Tensor
    ten_lengthspring: torch.Tensor; ten_invweight0: torch.Tensor
    wrap_coef: torch.Tensor
    actuator_dynprm: torch.Tensor; actuator_gainprm: torch.Tensor
    actuator_biasprm: torch.Tensor
    actuator_ctrlrange: torch.Tensor; actuator_forcerange: torch.Tensor
    actuator_gear: torch.Tensor
    actuator_acc0: torch.Tensor
    hfield_data: torch.Tensor
    hfield_size: torch.Tensor
    con_solref: torch.Tensor
    con_solimp: torch.Tensor
    con_friction: torch.Tensor
    con_includemargin: torch.Tensor
    con_margin: torch.Tensor
    ccd_core: torch.Tensor
    ccd_solref: torch.Tensor
    ccd_solimp: torch.Tensor
    ccd_mu: torch.Tensor
    ccd_includemargin: torch.Tensor
    ccd_margin: torch.Tensor

    # per-model cache of device index/constant tensors and static plans
    _cache: dict = dataclasses.field(default_factory=dict, init=False,
                                     repr=False)

    @property
    def device(self) -> torch.device:
        return self.qpos0.device

    @property
    def dtype(self) -> torch.dtype:
        return self.qpos0.dtype

    def ix(self, a) -> torch.Tensor:
        """Static numpy integer array -> cached int64 tensor on device."""
        a = np.asarray(a)
        key = ("ix", a.dtype.str, a.shape, a.tobytes())
        t = self._cache.get(key)
        if t is None:
            t = torch.as_tensor(a.astype(np.int64), device=self.device)
            self._cache[key] = t
        return t

    def const(self, a, dtype=None) -> torch.Tensor:
        """Static numpy array -> cached tensor (model dtype by default;
        bool arrays stay bool)."""
        a = np.asarray(a)
        if dtype is None:
            dtype = torch.bool if a.dtype == bool else self.dtype
        key = ("c", str(dtype), a.dtype.str, a.shape, a.tobytes())
        t = self._cache.get(key)
        if t is None:
            t = torch.as_tensor(a, device=self.device).to(dtype)
            self._cache[key] = t
        return t

    def plan(self, name, build):
        """Cached static plan ``build(self)`` (built once per model)."""
        key = ("plan", name)
        p = self._cache.get(key)
        if p is None:
            p = build(self)
            self._cache[key] = p
        return p

    def to(self, device=None, dtype=None):
        out = super().to(device=device, dtype=dtype)
        out._cache = {}
        return out

    def replace(self, **kw):
        out = dataclasses.replace(self, **kw)
        out._cache = {}
        return out


@dataclasses.dataclass
class Contact(_Tensors):
    """Selected active contact islands (top-K by penetration per condim
    group; row layout = constraint.efc_meta(m).groups order)."""

    sel: torch.Tensor        # (Ksum, B) int32 global candidate slot id
    dist: torch.Tensor       # (Ksum, B) signed distance
    pos: torch.Tensor        # (Ksum, 3, B)
    frame: torch.Tensor      # (Ksum, 3, 3, B) rows = normal, t1, t2
    k: torch.Tensor
    b: torch.Tensor
    R: torch.Tensor
    mu: torch.Tensor
    invw: torch.Tensor
    margin: torch.Tensor
    marginfull: torch.Tensor
    b1: torch.Tensor         # int32
    b2: torch.Tensor         # int32
    g1: torch.Tensor         # int32
    g2: torch.Tensor         # int32
    typ: torch.Tensor        # int32; -1 = ccd lane
    sub: torch.Tensor        # int32
    solref: torch.Tensor     # (Ksum, 2, B)
    solimp: torch.Tensor     # (Ksum, 5, B)


@dataclasses.dataclass
class Data(_Tensors):
    """Dynamic state of a batch of envs (trailing batch axis B)."""

    qpos: torch.Tensor
    qvel: torch.Tensor
    act: torch.Tensor
    ctrl: torch.Tensor
    qfrc_applied: torch.Tensor
    xfrc_applied: torch.Tensor
    time: torch.Tensor

    xpos: torch.Tensor; xquat: torch.Tensor; xmat: torch.Tensor
    xipos: torch.Tensor; ximat: torch.Tensor
    xanchor: torch.Tensor; xaxis: torch.Tensor
    geom_xpos: torch.Tensor; geom_xmat: torch.Tensor
    site_xpos: torch.Tensor; site_xmat: torch.Tensor
    subtree_com: torch.Tensor
    cinert: torch.Tensor
    cdof: torch.Tensor
    ten_length: torch.Tensor
    qM: torch.Tensor
    qLD: torch.Tensor
    qLDiagInv: torch.Tensor
    qLDh: torch.Tensor
    qLDiagInvh: torch.Tensor
    contact: Contact

    cvel: torch.Tensor
    cdof_dot: torch.Tensor
    ten_velocity: torch.Tensor
    qfrc_bias: torch.Tensor
    qfrc_passive: torch.Tensor
    qfrc_fluid: torch.Tensor

    actuator_length: torch.Tensor
    actuator_velocity: torch.Tensor
    actuator_force: torch.Tensor
    act_dot: torch.Tensor
    qfrc_actuator: torch.Tensor

    qfrc_smooth: torch.Tensor
    qacc_smooth: torch.Tensor
    qfrc_constraint: torch.Tensor
    qacc: torch.Tensor
    warm_sel: torch.Tensor     # (Ksum, B) int32
    warm_f: torch.Tensor       # (Ksum, 3, B)
    warm_lim: torch.Tensor     # (nlimit, B)
    apgd_v: torch.Tensor       # (R_fused, B)
    sol_lim_sel: torch.Tensor  # (n_lim_fused, B) int32
    sol_cone_sel: torch.Tensor  # (k_cone_fused, B) int32
    sol_f: torch.Tensor        # (R_fused, B)
    ccd_warm_id: torch.Tensor  # (ccd_budget, B) int32
    ccd_warm_u: torch.Tensor   # (ccd_budget, 3, B)
    ccd_lane_tab: torch.Tensor  # (ccd_budget, 25, B)

    sensordata: torch.Tensor


# The dynamical state that env auto-reset swaps. forward() recomputes the
# rest except the warm starts apgd_v, ccd_warm_id and ccd_warm_u, which
# carry over an auto-reset, as in the JAX package.
STATE_FIELDS = ("qpos", "qvel", "act", "ctrl", "qfrc_applied",
                "xfrc_applied", "time", "warm_sel", "warm_f", "warm_lim")
