"""Procedural fruit-fly model builder.

Re-authors the anatomically detailed drosophila model from the extracted
morphology asset (see tools/extract_fly_morphology.py) as a programmatic
``mujoco.MjSpec`` construction: 67 bodies, 102 hinge joints + free root,
78 actuators (70 general + 8 adhesion), 8 fixed tendons, 15 sensors, and
2 eye cameras — primitive-only geometry (no meshes).

Build-time "surgery" mirrors the reference walker's capability surface
(reference vnl_ray/fruitfly/fruitfly.py:115-326): retract/disable legs,
wings, mouth, antennae; flight pose (body pitch + stroke plane); actuator
filter dynamics; adhesion filters. All surgery happens before compilation —
per-episode variation never touches the model (SURVEY.md §7 delta 1).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Callable

import numpy as np

_ASSET_DIR = os.path.join(os.path.dirname(__file__), "assets")

# Action classes in canonical order (reference fruitfly.py:25).
ACTION_CLASSES = ("adhesion", "head", "mouth", "antennae", "wings",
                  "abdomen", "legs", "user")

_NAME_SUBSTR = {
    "adhesion": (),
    "head": ("head",),
    "mouth": ("rostrum", "haustellum", "labrum"),
    "antennae": ("antenna",),
    "wings": ("wing",),
    "abdomen": ("abdomen",),
    "legs": ("T1", "T2", "T3"),
    "user": (),
}


def _any(substrs, s):
    return any(x in s for x in substrs)


@dataclasses.dataclass
class _Body:
    name: str; parent: str
    pos: np.ndarray; quat: np.ndarray
    mass: float; ipos: np.ndarray; iquat: np.ndarray; inertia: np.ndarray
    joints: list; geoms: list; sites: list; cams: list


@dataclasses.dataclass
class _Joint:
    name: str; jtype: int; pos: np.ndarray; axis: np.ndarray
    range: np.ndarray; limited: bool; stiffness: float; springref: float
    damping: float; armature: float; margin: float
    solref_limit: np.ndarray; solimp_limit: np.ndarray


@dataclasses.dataclass
class _Geom:
    name: str; gtype: int; pos: np.ndarray; quat: np.ndarray
    size: np.ndarray; contype: int; conaffinity: int; condim: int
    friction: np.ndarray; solref: np.ndarray; solimp: np.ndarray
    solmix: float; margin: float; gap: float; priority: int; group: int
    rgba: np.ndarray
    fluidshape: str = ""  # "" or "ellipsoid"
    fluidcoef: tuple = (0.5, 0.25, 1.5, 1.7, 1.0)


@dataclasses.dataclass
class _Site:
    name: str; pos: np.ndarray; quat: np.ndarray
    size: np.ndarray; stype: int


@dataclasses.dataclass
class _Cam:
    name: str; pos: np.ndarray; quat: np.ndarray; fovy: float; mode: int


@dataclasses.dataclass
class _Actuator:
    name: str; trntype: int; target: str; dyntype: int; dynprm: np.ndarray
    gaintype: int; gainprm: np.ndarray; biastype: int; biasprm: np.ndarray
    ctrlrange: np.ndarray; ctrllimited: bool
    forcerange: np.ndarray; forcelimited: bool; gear: np.ndarray


@dataclasses.dataclass
class _Tendon:
    name: str; stiffness: float; damping: float
    lengthspring: np.ndarray
    joints: list  # (joint_name, coef)


@dataclasses.dataclass
class _Sensor:
    name: str; stype: int; objtype: int; objname: str


@dataclasses.dataclass
class Morphology:
    bodies: list           # topological order, world excluded
    actuators: list
    tendons: list
    sensors: list
    springref_of_joint: dict
    opt: dict
    # explicit contact exclude pairs [(body1, body2), ...] (reference XML
    # <contact><exclude> rules — abdomen chain skips, wing-abdomen,
    # coxa/femur left-right, rostrum-labrum)
    excludes: list = None

    def body(self, name):
        for b in self.bodies:
            if b.name == name:
                return b
        raise KeyError(name)

    def all_joints(self):
        return [j for b in self.bodies for j in b.joints]

    def find_actuator(self, name):
        for a in self.actuators:
            if a.name == name:
                return a
        return None


def load_morphology() -> Morphology:
    import mujoco
    z = np.load(os.path.join(_ASSET_DIR, "fly_morphology.npz"))
    with open(os.path.join(_ASSET_DIR, "fly_morphology.json")) as f:
        names = json.load(f)

    nbody = len(names["bodies"])
    bodies = []
    body_by_id = {}
    springref = {}
    for b in range(1, nbody):
        body = _Body(
            name=names["bodies"][b], parent=names["bodies"][
                int(z["body_parentid"][b])],
            pos=z["body_pos"][b].copy(), quat=z["body_quat"][b].copy(),
            mass=float(z["body_mass"][b]), ipos=z["body_ipos"][b].copy(),
            iquat=z["body_iquat"][b].copy(),
            inertia=z["body_inertia"][b].copy(),
            joints=[], geoms=[], sites=[], cams=[])
        bodies.append(body)
        body_by_id[b] = body

    for j in range(len(names["joints"])):
        bid = int(z["jnt_bodyid"][j])
        dadr = int(z["jnt_dofadr"][j])
        qadr = int(z["jnt_qposadr"][j])
        sref = float(z["qpos_spring"][qadr]) if int(z["jnt_type"][j]) >= 2 \
            else 0.0
        jnt = _Joint(
            name=names["joints"][j], jtype=int(z["jnt_type"][j]),
            pos=z["jnt_pos"][j].copy(), axis=z["jnt_axis"][j].copy(),
            range=z["jnt_range"][j].copy(),
            limited=bool(z["jnt_limited"][j]),
            stiffness=float(z["jnt_stiffness"][j]), springref=sref,
            damping=float(z["dof_damping"][dadr]),
            armature=float(z["dof_armature"][dadr]),
            margin=float(z["jnt_margin"][j]),
            solref_limit=z["jnt_solref"][j].copy(),
            solimp_limit=z["jnt_solimp"][j].copy())
        body_by_id[bid].joints.append(jnt)
        springref[jnt.name] = sref

    for k, g in enumerate(z["geom_keep"]):
        bid = int(z["geom_bodyid"][k])
        if bid == 0:
            continue  # world geoms (none expected in the fly)
        geom = _Geom(
            name=names["geoms"][k], gtype=int(z["geom_type"][k]),
            pos=z["geom_pos"][k].copy(), quat=z["geom_quat"][k].copy(),
            size=z["geom_size"][k].copy(),
            contype=int(z["geom_contype"][k]),
            conaffinity=int(z["geom_conaffinity"][k]),
            condim=int(z["geom_condim"][k]),
            friction=z["geom_friction"][k].copy(),
            solref=z["geom_solref"][k].copy(),
            solimp=z["geom_solimp"][k].copy(),
            solmix=float(z["geom_solmix"][k]),
            margin=float(z["geom_margin"][k]), gap=float(z["geom_gap"][k]),
            priority=int(z["geom_priority"][k]),
            group=int(z["geom_group"][k]), rgba=z["geom_rgba"][k].copy(),
            fluidshape="ellipsoid" if "fluid" in names["geoms"][k] else "")
        body_by_id[bid].geoms.append(geom)

    for s in range(len(names["sites"])):
        bid = int(z["site_bodyid"][s])
        if bid == 0:
            continue
        body_by_id[bid].sites.append(_Site(
            name=names["sites"][s], pos=z["site_pos"][s].copy(),
            quat=z["site_quat"][s].copy(), size=z["site_size"][s].copy(),
            stype=int(z["site_type"][s])))

    for c in range(len(names["cameras"])):
        bid = int(z["cam_bodyid"][c])
        cam = _Cam(name=names["cameras"][c], pos=z["cam_pos"][c].copy(),
                   quat=z["cam_quat"][c].copy(),
                   fovy=float(z["cam_fovy"][c]), mode=int(z["cam_mode"][c]))
        if bid == 0:
            # tracking cameras attach to the root body instead
            body_by_id[1].cams.append(cam)
        else:
            body_by_id[bid].cams.append(cam)

    actuators = []
    for u in range(len(names["actuators"])):
        trntype = int(z["actuator_trntype"][u])
        tid = int(z["actuator_trnid"][u, 0])
        if trntype == int(mujoco.mjtTrn.mjTRN_JOINT):
            target = names["joints"][tid]
        elif trntype == int(mujoco.mjtTrn.mjTRN_TENDON):
            target = names["tendons"][tid]
        else:  # body (adhesion)
            target = names["bodies"][tid]
        actuators.append(_Actuator(
            name=names["actuators"][u], trntype=trntype, target=target,
            dyntype=int(z["actuator_dyntype"][u]),
            dynprm=z["actuator_dynprm"][u].copy(),
            gaintype=int(z["actuator_gaintype"][u]),
            gainprm=z["actuator_gainprm"][u].copy(),
            biastype=int(z["actuator_biastype"][u]),
            biasprm=z["actuator_biasprm"][u].copy(),
            ctrlrange=z["actuator_ctrlrange"][u].copy(),
            ctrllimited=bool(z["actuator_ctrllimited"][u]),
            forcerange=z["actuator_forcerange"][u].copy(),
            forcelimited=bool(z["actuator_forcelimited"][u]),
            gear=z["actuator_gear"][u].copy()))

    tendons = []
    for t in range(len(names["tendons"])):
        adr, num = int(z["tendon_adr"][t]), int(z["tendon_num"][t])
        joints = [(names["joints"][int(z["wrap_objid"][w])],
                   float(z["wrap_prm"][w])) for w in range(adr, adr + num)]
        tendons.append(_Tendon(
            name=names["tendons"][t],
            stiffness=float(z["tendon_stiffness"][t]),
            damping=float(z["tendon_damping"][t]),
            lengthspring=z["tendon_lengthspring"][t].copy(), joints=joints))

    sensors = []
    for s in range(len(names["sensors"])):
        st = int(z["sensor_type"][s])
        ot = int(z["sensor_objtype"][s])
        oid = int(z["sensor_objid"][s])
        oname = {int(mujoco.mjtObj.mjOBJ_SITE): lambda: names["sites"][oid],
                 int(mujoco.mjtObj.mjOBJ_JOINT): lambda: names["joints"][oid],
                 }[ot]()
        sensors.append(_Sensor(name=names["sensors"][s], stype=st,
                               objtype=ot, objname=oname))

    opt = dict(timestep=float(z["opt_timestep"]),
               gravity=z["opt_gravity"].copy(),
               density=float(z["opt_density"]),
               viscosity=float(z["opt_viscosity"]),
               cone=int(z["opt_cone"]),
               noslip_iterations=int(z["opt_noslip_iterations"]))
    return Morphology(bodies=bodies, actuators=actuators, tendons=tendons,
                      sensors=sensors, springref_of_joint=springref, opt=opt,
                      excludes=[tuple(e) for e in names.get("excludes", [])])


# ---------------------------------------------------------------------------
# quaternion helpers (host-side, numpy)
# ---------------------------------------------------------------------------

def _mulq(a, b):
    w1, x1, y1, z1 = a
    w2, x2, y2, z2 = b
    return np.array([w1*w2 - x1*x2 - y1*y2 - z1*z2,
                     w1*x2 + x1*w2 + y1*z2 - z1*y2,
                     w1*y2 - x1*z2 + y1*w2 + z1*x2,
                     w1*z2 + x1*y2 - y1*x2 + z1*w2])


def _negq(q):
    return np.array([-q[0], q[1], q[2], q[3]])


def _axangq(axis, angle):
    axis = np.asarray(axis, dtype=float)
    axis = axis / max(np.linalg.norm(axis), 1e-12)
    return np.concatenate([[np.cos(angle / 2)], np.sin(angle / 2) * axis])


def _rotq(vec, q):
    w, u = q[0], q[1:]
    uv = np.cross(u, vec)
    uuv = np.cross(u, uv)
    return vec + 2 * (w * uv + uuv) / max(np.dot(q, q), 1e-12)


def _body_quat_from_springrefs(body: _Body) -> np.ndarray:
    """Bake the springref pose of a body's hinge joints into its quat
    (used to retract disabled legs; reference fruitfly.py surgery)."""
    import mujoco
    quat = body.quat.copy()
    for j in body.joints:
        if j.jtype == int(mujoco.mjtJoint.mjJNT_HINGE) and j.springref:
            quat = _mulq(quat, _axangq(j.axis, j.springref))
    return quat


def _change_body_frame(body: _Body, new_quat: np.ndarray):
    """Re-orient a body frame in place, keeping all children fixed in space
    (reference make_fruitfly.change_body_frame, re-derived)."""
    old_quat = body.quat.copy()
    dquat = _mulq(_negq(new_quat), old_quat)
    body.quat = new_quat
    for child in body.joints + body.geoms + body.sites + body.cams:
        if hasattr(child, "quat"):
            child.quat = _mulq(dquat, child.quat)
        child.pos = _rotq(child.pos, dquat)
        if hasattr(child, "axis"):
            child.axis = _rotq(child.axis, dquat)
    # child bodies
    return dquat


# ---------------------------------------------------------------------------
# builder
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class FlyConfig:
    """Build-time configuration (reference FruitFly._build options)."""
    use_legs: bool = True
    use_wings: bool = False
    use_mouth: bool = False
    use_antennae: bool = False
    joint_filter: float = 0.01
    adhesion_filter: float = 0.007
    body_pitch_angle: float = 47.5
    stroke_plane_angle: float = 0.0
    physics_timestep: float = 1e-4
    control_timestep: float = 2e-3
    num_user_actions: int = 0
    eye_camera_fovy: float = 150.0
    eye_camera_size: int = 32
    # root handling: 'free' (locomotion), 'none' (tethered / fused)
    root_joint: str = "free"
    spawn_pos: tuple = (0.0, 0.0, 0.0)
    spawn_quat: tuple = (1.0, 0.0, 0.0, 0.0)
    # per-geom ellipsoid fluid model on the wings — flight tasks only
    # (reference tasks/base.py:309-313 activates it at task build)
    wing_fluid: bool = False


def apply_surgery(morph: Morphology, cfg: FlyConfig) -> Morphology:
    """Retract/disable body parts and set actuator dynamics (in place)."""
    import mujoco
    def remove_actuator(name):
        a = morph.find_actuator(name)
        if a is not None:
            morph.actuators.remove(a)

    if not cfg.use_legs:
        for b in morph.bodies:
            if _any(_NAME_SUBSTR["legs"], b.name):
                b.quat = _body_quat_from_springrefs(b)
        for t in list(morph.tendons):
            if _any(_NAME_SUBSTR["legs"], t.name):
                remove_actuator(t.name)
                morph.tendons.remove(t)
        for b in morph.bodies:
            if not _any(_NAME_SUBSTR["legs"], b.name):
                continue
            for j in list(b.joints):
                remove_actuator(j.name)
                b.joints.remove(j)
        morph.actuators = [a for a in morph.actuators
                           if not ("adhere" in a.name
                                   and _any(_NAME_SUBSTR["legs"], a.name))]
        morph.sensors = [s for s in morph.sensors
                         if not _any(_NAME_SUBSTR["legs"], s.name)]

    if not cfg.use_wings:
        for b in morph.bodies:
            if _any(_NAME_SUBSTR["wings"], b.name):
                for j in b.joints:
                    remove_actuator(j.name)
        morph.sensors = [s for s in morph.sensors
                         if not _any(_NAME_SUBSTR["wings"], s.name)]

    if not cfg.use_mouth:
        for b in morph.bodies:
            if _any(_NAME_SUBSTR["mouth"], b.name):
                for j in b.joints:
                    remove_actuator(j.name)
        morph.actuators = [a for a in morph.actuators
                           if not ("adhere" in a.name
                                   and _any(_NAME_SUBSTR["mouth"], a.name))]

    if not cfg.use_antennae:
        for b in morph.bodies:
            if _any(_NAME_SUBSTR["antennae"], b.name):
                for j in b.joints:
                    remove_actuator(j.name)

    # flight pose: body pitch (hover_up_dir) + stroke plane re-framing
    if cfg.use_wings:
        thorax = morph.bodies[0]
        up_dir = None
        for s in thorax.sites:
            if s.name == "hover_up_dir":
                up_dir = s
        if up_dir is not None:
            angle = 2 * np.arccos(np.clip(up_dir.quat[0], -1, 1))
            delta = np.deg2rad(cfg.body_pitch_angle) - angle
            dq = np.array([np.cos(delta / 2), 0, np.sin(delta / 2), 0])
            up_dir.quat = _mulq(dq, up_dir.quat)
            sp = np.deg2rad(cfg.stroke_plane_angle)
            spq = np.array([np.cos(sp / 2), 0, np.sin(sp / 2), 0])
            for base, wing in [(np.array([0.0, 0, 0, 1]), "wing_left"),
                               (np.array([0.0, -1, 0, 0]), "wing_right")]:
                dquat = _mulq(_negq(spq), base)
                new_quat = _mulq(dquat, _negq(up_dir.quat))
                _change_body_frame(morph.body(wing), new_quat)

    # actuator dynamics -> filter
    for a in morph.actuators:
        is_adhesion = a.trntype == int(mujoco.mjtTrn.mjTRN_BODY)
        filt = cfg.adhesion_filter if is_adhesion else cfg.joint_filter
        if filt > 0:
            a.dyntype = int(mujoco.mjtDyn.mjDYN_FILTER)
            a.dynprm = a.dynprm.copy()
            a.dynprm[0] = filt

    # eye camera fovy
    for b in morph.bodies:
        for c in b.cams:
            if c.name.startswith("eye"):
                c.fovy = cfg.eye_camera_fovy
    return morph


def to_spec(morph: Morphology, cfg: FlyConfig,
            arena_fn: Callable | None = None):
    """Emit an mujoco.MjSpec from the (post-surgery) morphology."""
    import mujoco
    spec = mujoco.MjSpec()
    spec.option.timestep = cfg.physics_timestep
    spec.option.gravity = morph.opt["gravity"]
    spec.option.density = morph.opt["density"]
    spec.option.viscosity = morph.opt["viscosity"]
    spec.option.cone = morph.opt["cone"]
    spec.option.noslip_iterations = morph.opt["noslip_iterations"]
    spec.compiler.degree = False

    # explicit contact excludes from the reference XML (skipped when a
    # body was removed by surgery)
    present = {b.name for b in morph.bodies}
    for b1, b2 in (morph.excludes or []):
        if b1 in present and b2 in present:
            ex = spec.add_exclude()
            ex.name = f"{b1}_{b2}"
            ex.bodyname1 = b1
            ex.bodyname2 = b2

    if arena_fn is not None:
        arena_fn(spec)

    handles = {"world": spec.worldbody}
    for b in morph.bodies:
        parent = handles[b.parent] if b.parent != "world" \
            else spec.worldbody
        pos, quat = b.pos, b.quat
        if b.parent == "world":
            pos = np.asarray(cfg.spawn_pos)
            quat = np.asarray(cfg.spawn_quat)
        hb = parent.add_body(name=b.name, pos=pos, quat=quat)
        hb.mass = b.mass
        hb.ipos = b.ipos
        hb.iquat = b.iquat
        hb.inertia = b.inertia
        hb.explicitinertial = True
        handles[b.name] = hb
        for j in b.joints:
            if j.name == "free":
                continue  # root joint handled below
            hj = hb.add_joint(
                name=j.name, type=mujoco.mjtJoint(j.jtype), pos=j.pos,
                axis=j.axis, range=j.range, stiffness=j.stiffness,
                springref=j.springref, damping=j.damping,
                armature=j.armature, margin=j.margin,
                solref_limit=j.solref_limit, solimp_limit=j.solimp_limit)
            hj.limited = (mujoco.mjtLimited.mjLIMITED_TRUE if j.limited
                          else mujoco.mjtLimited.mjLIMITED_FALSE)
        for g in b.geoms:
            hg = hb.add_geom(
                name=g.name, type=mujoco.mjtGeom(g.gtype), pos=g.pos,
                quat=g.quat, size=g.size, contype=g.contype,
                conaffinity=g.conaffinity, condim=g.condim,
                friction=g.friction, solref=g.solref, solimp=g.solimp,
                solmix=g.solmix, margin=g.margin, gap=g.gap,
                priority=g.priority, group=g.group, rgba=g.rgba, mass=0.0)
            if g.fluidshape and cfg.wing_fluid:
                hg.fluid_ellipsoid = 1
                hg.fluid_coefs = np.asarray(g.fluidcoef)
        for s in b.sites:
            hb.add_site(name=s.name, pos=s.pos, quat=s.quat, size=s.size,
                        type=mujoco.mjtGeom(s.stype), group=3)
        for c in b.cams:
            hb.add_camera(name=c.name, pos=c.pos, quat=c.quat, fovy=c.fovy,
                          mode=mujoco.mjtCamLight(c.mode))

    if cfg.root_joint == "free":
        handles[morph.bodies[0].name].add_freejoint(name="free")

    for t in morph.tendons:
        ht = spec.add_tendon(name=t.name, stiffness=t.stiffness,
                             damping=t.damping,
                             springlength=t.lengthspring)
        for jn, coef in t.joints:
            ht.wrap_joint(jn, coef)

    for a in morph.actuators:
        spec.add_actuator(
            name=a.name, target=a.target, trntype=mujoco.mjtTrn(a.trntype),
            dyntype=mujoco.mjtDyn(a.dyntype), dynprm=a.dynprm,
            gaintype=mujoco.mjtGain(a.gaintype), gainprm=a.gainprm,
            biastype=mujoco.mjtBias(a.biastype), biasprm=a.biasprm,
            ctrlrange=a.ctrlrange,
            ctrllimited=(mujoco.mjtLimited.mjLIMITED_TRUE if a.ctrllimited
                         else mujoco.mjtLimited.mjLIMITED_FALSE),
            forcerange=a.forcerange,
            forcelimited=(mujoco.mjtLimited.mjLIMITED_TRUE if a.forcelimited
                          else mujoco.mjtLimited.mjLIMITED_FALSE),
            gear=a.gear)

    for s in morph.sensors:
        spec.add_sensor(name=s.name, type=mujoco.mjtSensor(s.stype),
                        objtype=mujoco.mjtObj(s.objtype), objname=s.objname)
    return spec


def action_indices(morph: Morphology, cfg: FlyConfig) -> dict:
    """Action-class -> ctrl indices and env-action indices
    (reference fruitfly.py:283-318 semantics)."""
    names = [a.name for a in morph.actuators]
    ctrl_idx = {}
    for cls in ACTION_CLASSES:
        if cls in ("adhesion", "user"):
            continue
        idx = [i for i, n in enumerate(names)
               if _any(_NAME_SUBSTR[cls], n) and "adhere" not in n]
        ctrl_idx[cls] = idx
    ctrl_idx["adhesion"] = [i for i, n in enumerate(names) if "adhere" in n]
    ctrl_idx["user"] = []

    num = {cls: len(ctrl_idx[cls]) for cls in ACTION_CLASSES}
    num["user"] = cfg.num_user_actions
    action_idx = {}
    counter = 0
    for cls in ACTION_CLASSES:
        action_idx[cls] = list(range(counter, counter + num[cls]))
        counter += num[cls]

    # observable joints: the reference keeps disabled-part joints in the
    # model (only their actuators go) but REMOVES them from the walker's
    # observable_joints list (reference fruitfly.py:209-247); mirror that
    # so joints_pos/joints_vel sizes match the reference exactly.
    disabled = []
    for cls, flag in (("wings", cfg.use_wings), ("mouth", cfg.use_mouth),
                      ("antennae", cfg.use_antennae),
                      ("legs", cfg.use_legs)):
        if not flag:
            disabled.extend(_NAME_SUBSTR[cls])
    observable_joints = []
    for b in morph.bodies:
        for j in b.joints:
            if not _any(tuple(disabled), j.name):
                observable_joints.append(j.name)
    return dict(ctrl=ctrl_idx, action=action_idx, num=num,
                total=counter, observable_joints=observable_joints)

