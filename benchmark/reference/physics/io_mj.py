"""Model compilation in two steps, so a GPU machine needs no mujoco.

1. ``export_mj(mj_model)`` runs where mujoco is installed: it copies the
   compiled MjModel fields that ``put_model`` reads into a plain dict of
   numpy arrays (plus the name tables as JSON). ``tasks/walk_on_ball.py``
   writes that dict to ``models/assets/walk_on_ball_model.npz``, which is
   committed.
2. ``put_model(mapping, device=...)`` builds the engine's ``Model`` from
   such a mapping on any device: the static structure (candidate pairs,
   per-slot contact parameters, ccd tables, the tree schedule) is numpy,
   the numeric parameters become tensors.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from benchmark.reference.physics import types as T
from benchmark.reference.physics.types import Contact, Data, Model, Option


_SUPPORTED_GEOMS = {
    T.GEOM_PLANE, T.GEOM_HFIELD, T.GEOM_SPHERE, T.GEOM_CAPSULE,
    T.GEOM_ELLIPSOID, T.GEOM_CYLINDER, T.GEOM_BOX, T.GEOM_MESH,
}

# Max contacts generated per candidate pair, keyed by (type1, type2) with
# type1 <= type2.
PAIR_NCON = {
    (T.GEOM_PLANE, T.GEOM_SPHERE): 1,
    (T.GEOM_PLANE, T.GEOM_CAPSULE): 2,
    (T.GEOM_PLANE, T.GEOM_ELLIPSOID): 1,
    (T.GEOM_PLANE, T.GEOM_CYLINDER): 3,
    (T.GEOM_PLANE, T.GEOM_BOX): 4,
    (T.GEOM_HFIELD, T.GEOM_SPHERE): 1,
    (T.GEOM_HFIELD, T.GEOM_CAPSULE): 2,
    (T.GEOM_HFIELD, T.GEOM_ELLIPSOID): 1,
    (T.GEOM_HFIELD, T.GEOM_CYLINDER): 3,
    (T.GEOM_SPHERE, T.GEOM_SPHERE): 1,
    (T.GEOM_SPHERE, T.GEOM_CAPSULE): 1,
    (T.GEOM_SPHERE, T.GEOM_BOX): 1,
    (T.GEOM_CAPSULE, T.GEOM_CAPSULE): 1,
    (T.GEOM_CAPSULE, T.GEOM_BOX): 2,
}
# Every ellipsoid/cylinder vs {sphere, capsule, ellipsoid, cylinder} pair
# routes through the gated exact-convex narrowphase (physics/ccd.py).
_CCD_TYPES = {T.GEOM_SPHERE, T.GEOM_CAPSULE, T.GEOM_ELLIPSOID,
              T.GEOM_CYLINDER}

# MjModel fields put_model reads (besides the sizes and opt below).
_MJ_FIELDS = (
    "body_parentid", "body_rootid", "body_jntadr", "body_jntnum",
    "body_dofadr", "body_dofnum", "body_geomadr", "body_geomnum",
    "body_weldid", "body_pos", "body_quat", "body_ipos", "body_iquat",
    "body_mass", "body_subtreemass", "body_inertia", "body_invweight0",
    "jnt_type", "jnt_qposadr", "jnt_dofadr", "jnt_bodyid", "jnt_limited",
    "jnt_pos", "jnt_axis", "jnt_range", "jnt_stiffness", "jnt_solref",
    "jnt_solimp", "jnt_margin",
    "dof_bodyid", "dof_jntid", "dof_parentid", "dof_armature",
    "dof_damping", "dof_frictionloss", "dof_invweight0",
    "geom_type", "geom_bodyid", "geom_condim", "geom_priority",
    "geom_contype", "geom_conaffinity", "geom_solref", "geom_solimp",
    "geom_solmix", "geom_friction", "geom_margin", "geom_gap", "geom_size",
    "geom_pos", "geom_quat", "geom_fluid", "geom_rbound",
    "site_bodyid", "site_pos", "site_quat", "site_size",
    "tendon_adr", "tendon_num", "tendon_stiffness", "tendon_damping",
    "tendon_lengthspring", "tendon_invweight0", "wrap_objid", "wrap_prm",
    "actuator_trntype", "actuator_dyntype", "actuator_gaintype",
    "actuator_biastype", "actuator_trnid", "actuator_actadr",
    "actuator_ctrllimited", "actuator_forcelimited", "actuator_dynprm",
    "actuator_gainprm", "actuator_biasprm", "actuator_ctrlrange",
    "actuator_forcerange", "actuator_gear", "actuator_acc0",
    "sensor_objid", "sensor_objtype", "sensor_adr", "sensor_dim",
    "exclude_signature", "qpos0", "qpos_spring",
    "hfield_nrow", "hfield_ncol", "hfield_adr", "hfield_data", "hfield_size",
)
_MJ_SIZES = ("nq", "nv", "nu", "na", "nbody", "njnt", "ngeom", "nsite",
             "ntendon", "nwrap", "nsensor", "nsensordata", "nhfield",
             "nexclude")
_MJ_OPT = ("timestep", "gravity", "density", "viscosity", "wind",
           "impratio", "tolerance", "integrator", "cone", "iterations",
           "ls_iterations", "noslip_iterations")


def _sensor_codes():
    import mujoco
    S = mujoco.mjtSensor
    return {
        int(S.mjSENS_ACCELEROMETER): T.SENS_ACCELEROMETER,
        int(S.mjSENS_GYRO): T.SENS_GYRO,
        int(S.mjSENS_VELOCIMETER): T.SENS_VELOCIMETER,
        int(S.mjSENS_FORCE): T.SENS_FORCE,
        int(S.mjSENS_TOUCH): T.SENS_TOUCH,
        int(S.mjSENS_JOINTPOS): T.SENS_JOINTPOS,
        int(S.mjSENS_JOINTVEL): T.SENS_JOINTVEL,
        int(S.mjSENS_ACTUATORFRC): T.SENS_ACTUATORFRC,
        int(S.mjSENS_FRAMEPOS): T.SENS_FRAMEPOS,
        int(S.mjSENS_FRAMEQUAT): T.SENS_FRAMEQUAT,
        int(S.mjSENS_SUBTREECOM): T.SENS_SUBTREECOM,
        int(S.mjSENS_TENDONPOS): T.SENS_TENDONPOS,
        int(S.mjSENS_TENDONVEL): T.SENS_TENDONVEL,
        int(S.mjSENS_SUBTREELINVEL): T.SENS_SUBTREELINVEL,
        int(S.mjSENS_FRAMEZAXIS): T.SENS_FRAMEZAXIS,
        int(S.mjSENS_TORQUE): T.SENS_TORQUE,
    }


def _names(m) -> dict:
    """name -> id tables from an MjModel."""
    import mujoco
    out = {}
    for kind, n in [
        ("body", m.nbody), ("joint", m.njnt), ("geom", m.ngeom),
        ("site", m.nsite), ("actuator", m.nu), ("tendon", m.ntendon),
        ("sensor", m.nsensor), ("camera", m.ncam),
    ]:
        obj = getattr(mujoco.mjtObj, "mjOBJ_" + kind.upper())
        table = {}
        for i in range(n):
            name = mujoco.mj_id2name(m, obj, i)
            if name:
                table[name] = i
        out[kind] = table
    return out


def export_mj(m) -> dict:
    """The compiled MjModel fields ``put_model`` reads, as numpy arrays.
    Needs mujoco (the model compiler); the result does not."""
    import mujoco
    for w in range(m.nwrap):
        if m.wrap_type[w] != mujoco.mjtWrap.mjWRAP_JOINT:
            raise NotImplementedError("only fixed tendons supported")
    codes = _sensor_codes()
    out = {k: np.asarray(getattr(m, k)).copy() for k in _MJ_FIELDS}
    out.update({k: np.asarray(int(getattr(m, k))) for k in _MJ_SIZES})
    out.update({"opt_" + k: np.asarray(getattr(m.opt, k)).copy()
                for k in _MJ_OPT})
    st = []
    for t in m.sensor_type:
        if int(t) not in codes:
            raise NotImplementedError(f"sensor type {t}")
        st.append(codes[int(t)])
    out["sensor_type"] = np.asarray(st, np.int32)
    out["names_json"] = np.asarray(json.dumps(_names(m), sort_keys=True))
    return out


def _is_ccd_pair(t1: int, t2: int) -> bool:
    return (t1 in _CCD_TYPES and t2 in _CCD_TYPES
            and (T.GEOM_ELLIPSOID in (t1, t2)
                 or T.GEOM_CYLINDER in (t1, t2)))


def _tree_levels(parentid: np.ndarray) -> tuple:
    """Body ids (excluding world=0) grouped by depth for level-parallel
    FK."""
    nbody = len(parentid)
    depth = np.zeros(nbody, dtype=np.int32)
    for i in range(1, nbody):
        depth[i] = depth[parentid[i]] + 1
    levels = []
    for dl in range(1, depth.max() + 1 if nbody > 1 else 1):
        ids = np.nonzero(depth == dl)[0]
        if len(ids):
            levels.append(ids.astype(np.int32))
    return tuple(levels)


def _body_dof_mask(mj) -> np.ndarray:
    """(nbody, nv) bool: the dof belongs to the body or an ancestor."""
    nbody, nv = int(mj["nbody"]), int(mj["nv"])
    mask = np.zeros((nbody, nv), dtype=bool)
    for b in range(nbody):
        cur = b
        while cur != 0:
            adr, num = mj["body_dofadr"][cur], mj["body_dofnum"][cur]
            mask[b, adr:adr + num] = True
            cur = mj["body_parentid"][cur]
    return mask


def _ancestor_mask(dof_parentid: np.ndarray, nv: int) -> np.ndarray:
    """mask[i, j] iff dof j is an ancestor of dof i (or j == i)."""
    mask = np.zeros((nv, nv), dtype=bool)
    for i in range(nv):
        j = i
        while j >= 0:
            mask[i, j] = True
            j = dof_parentid[j]
    return mask


def _collision_pairs(mj):
    """Static candidate geom pairs passing MuJoCo's collision filters,
    split into analytic-narrowphase pairs and gated ccd pairs."""
    geom1, geom2, ccd1, ccd2 = [], [], [], []
    weld = mj["body_weldid"]
    parent = mj["body_parentid"]
    gtype, gbody = mj["geom_type"], mj["geom_bodyid"]
    nbody, ngeom = int(mj["nbody"]), int(mj["ngeom"])
    weldparent = np.array([weld[parent[weld[b]]] for b in range(nbody)])
    excluded = set()
    for sig in mj["exclude_signature"][:int(mj["nexclude"])]:
        excluded.add((int(sig) >> 16, int(sig) & 0xFFFF))
    for i in range(ngeom):
        for j in range(i + 1, ngeom):
            t1, t2 = int(gtype[i]), int(gtype[j])
            g1, g2 = i, j
            if t1 > t2:
                g1, g2, t1, t2 = j, i, t2, t1
            is_ccd = _is_ccd_pair(t1, t2)
            if not is_ccd and (t1, t2) not in PAIR_NCON:
                continue
            b1, b2 = int(gbody[g1]), int(gbody[g2])
            con1, aff1 = int(mj["geom_contype"][g1]), int(
                mj["geom_conaffinity"][g1])
            con2, aff2 = int(mj["geom_contype"][g2]), int(
                mj["geom_conaffinity"][g2])
            if not ((con1 & aff2) or (con2 & aff1)):
                continue
            w1, w2 = int(weld[b1]), int(weld[b2])
            if w1 == w2:
                continue
            wp1, wp2 = int(weldparent[b1]), int(weldparent[b2])
            if (w1 == wp2 and w1 != 0) or (w2 == wp1 and w2 != 0):
                continue
            bb = (min(b1, b2), max(b1, b2))
            if bb in excluded or (bb[1], bb[0]) in excluded:
                continue
            if is_ccd:
                ccd1.append(g1)
                ccd2.append(g2)
            else:
                geom1.append(g1)
                geom2.append(g2)
    types = [(int(gtype[a]), int(gtype[b])) for a, b in zip(geom1, geom2)]
    return (np.array(geom1, dtype=np.int32), np.array(geom2, dtype=np.int32),
            types, np.array(ccd1, dtype=np.int32),
            np.array(ccd2, dtype=np.int32))


def put_model(mj, device=None, dtype=torch.float32,
              con_sel: dict | None = None, ccd_budget: int = 128,
              ccd_iters: int = 8, contact_solver: str = "apgd",
              fused_sel: tuple = (24, 24), col_refresh: int = 1,
              ccd_class_budgets: dict | None = None) -> Model:
    """Build the engine's Model from an ``export_mj`` mapping.

    con_sel: optional {condim: K} overrides of the per-condim active
    contact island sizes; ccd_budget / ccd_class_budgets: lane budgets of
    the gated exact-convex narrowphase; ccd_iters: PGD iterations per
    narrowphase run; fused_sel: (limit rows, cones) of the fused solver;
    col_refresh: contact-selection refresh period in substeps."""
    from benchmark.reference.ops import tree_ldl as TL
    from benchmark.reference.physics import ccd as ccd_mod
    mj = {k: np.asarray(v) for k, v in mj.items()}
    ngeom = int(mj["ngeom"])
    gtype = mj["geom_type"]
    for g in range(ngeom):
        if int(gtype[g]) not in _SUPPORTED_GEOMS:
            raise NotImplementedError(f"geom type {gtype[g]}")

    a = lambda x: torch.as_tensor(np.asarray(x, np.float64), device=device
                                  ).to(dtype)
    empty = lambda *shape: torch.zeros(shape, dtype=dtype, device=device)

    pair_g1, pair_g2, pair_types, ccd_g1, ccd_g2 = _collision_pairs(mj)
    ncon_max = int(sum(PAIR_NCON[t] for t in pair_types))

    def combined_params(g1, g2):
        """mj_contactParam semantics for one geom pair."""
        p1, p2 = int(mj["geom_priority"][g1]), int(mj["geom_priority"][g2])
        if p1 != p2:
            hi = g1 if p1 > p2 else g2
            cd = int(mj["geom_condim"][hi])
            solref = mj["geom_solref"][hi].copy()
            solimp = mj["geom_solimp"][hi].copy()
            fric = mj["geom_friction"][hi].copy()
        else:
            cd = max(int(mj["geom_condim"][g1]), int(mj["geom_condim"][g2]))
            s1 = float(mj["geom_solmix"][g1])
            s2 = float(mj["geom_solmix"][g2])
            mix = s1 / (s1 + s2) if (s1 + s2) > 1e-12 else 0.5
            r1, r2 = mj["geom_solref"][g1], mj["geom_solref"][g2]
            if r1[0] <= 0 or r2[0] <= 0:
                solref = np.minimum(r1, r2)
            else:
                solref = mix * r1 + (1 - mix) * r2
            solimp = (mix * mj["geom_solimp"][g1]
                      + (1 - mix) * mj["geom_solimp"][g2])
            fric = np.maximum(mj["geom_friction"][g1],
                              mj["geom_friction"][g2])
        # the pair margin is the sum of the two geoms' margins (MuJoCo 3.x)
        margin = float(mj["geom_margin"][g1]) + float(mj["geom_margin"][g2])
        fric5 = np.array([fric[0], fric[0], fric[1], fric[2], fric[2]])
        return cd, solref, solimp, fric5, margin

    con_dim, con_solref, con_solimp, con_fric, con_margin = [], [], [], [], []
    for g1, g2 in zip(pair_g1, pair_g2):
        cd, solref, solimp, fric5, margin = combined_params(g1, g2)
        k = PAIR_NCON[(int(gtype[g1]), int(gtype[g2]))]
        con_dim += [cd] * k
        con_solref += [solref] * k
        con_solimp += [solimp] * k
        con_fric += [fric5] * k
        con_margin += [margin] * k

    # ccd pair tables, sorted class-major by kink structure (ax1, ax2)
    nccd = len(ccd_g1)
    core = lambda g: ccd_mod.geom_core_params(int(gtype[g]),
                                              mj["geom_size"][g])
    order = sorted(((int(core(g1)[5]), int(core(g2)[5])), i)
                   for i, (g1, g2) in enumerate(zip(ccd_g1, ccd_g2)))
    perm = [i for _, i in order]
    if nccd:
        ccd_g1, ccd_g2 = ccd_g1[perm], ccd_g2[perm]
    ccd_core, ccd_solref, ccd_solimp, ccd_mu = [], [], [], []
    ccd_margin, ccd_rbsum, cls_axes = [], [], []
    for g1, g2 in zip(ccd_g1, ccd_g2):
        cd, solref, solimp, fric5, margin = combined_params(g1, g2)
        if cd == 1:
            # a friction cone with mu = 0 is exactly a frictionless
            # contact, so condim-1 pairs join the condim-3 pool
            fric5 = np.zeros_like(fric5)
        elif cd != 3:
            raise NotImplementedError(
                f"ccd pair condim {cd} (only 1/3 supported)")
        c1, c2 = core(g1), core(g2)
        cls_axes.append((bool(c1[5]), bool(c2[5])))
        ccd_core.append(np.concatenate([c1[:5], c2[:5]]))
        ccd_solref.append(solref)
        ccd_solimp.append(solimp)
        ccd_mu.append(fric5[0])
        ccd_margin.append(margin)
        ccd_rbsum.append(float(mj["geom_rbound"][g1] + mj["geom_rbound"][g2]))

    # class segments; budgets split the total lane budget 25% smooth /
    # 50% one-axis (both variants) / 25% two-axis unless given per class
    ccd_classes = []
    ccd_budget_eff = 0
    if nccd:
        flags = np.array(cls_axes)
        for key in ((False, False), (False, True), (True, False),
                    (True, True)):
            idx = np.nonzero((flags[:, 0] == key[0])
                             & (flags[:, 1] == key[1]))[0]
            if not len(idx):
                continue
            start, n = int(idx[0]), int(len(idx))
            if ccd_class_budgets and key in ccd_class_budgets:
                budget = min(n, int(ccd_class_budgets[key]))
            else:
                budget = min(n, max(8, int(round(ccd_budget * 0.25))))
            ccd_classes.append((key[0], key[1], start, n, budget))
            ccd_budget_eff += budget

    n_limit = int(mj["jnt_limited"].sum())
    nefc = n_limit + int(sum(con_dim)) + 3 * ccd_budget_eff
    integ = {0: T.EULER, 1: T.RK4, 2: T.IMPLICIT}.get(
        int(mj["opt_integrator"]), T.EULER)
    has_fluid = bool(float(mj["opt_density"]) > 0
                     or float(mj["opt_viscosity"]) > 0
                     or np.any(mj["opt_wind"]))
    opt = Option(
        timestep=a(mj["opt_timestep"]), gravity=a(mj["opt_gravity"]),
        density=a(mj["opt_density"]), viscosity=a(mj["opt_viscosity"]),
        wind=a(mj["opt_wind"]), impratio=a(mj["opt_impratio"]),
        tolerance=a(mj["opt_tolerance"]),
        integrator=integ, cone=int(mj["opt_cone"]),
        solver_iterations=min(int(mj["opt_iterations"]), 32),
        ls_iterations=min(int(mj["opt_ls_iterations"]), 16),
        noslip_iterations=int(mj["opt_noslip_iterations"]),
        has_fluid=has_fluid, contact_solver=contact_solver)

    nhf = int(mj["nhfield"])
    if nhf:
        hfield_data = a(np.concatenate([
            mj["hfield_data"][mj["hfield_adr"][i]:mj["hfield_adr"][i]
                              + mj["hfield_nrow"][i] * mj["hfield_ncol"][i]
                              ].reshape(mj["hfield_nrow"][i],
                                        mj["hfield_ncol"][i])[None]
            for i in range(nhf)]))
    else:
        hfield_data = empty(0, 0, 0)
    stack = lambda lst, w: a(np.stack(lst)) if lst else empty(0, w)
    vec = lambda lst: a(np.array(lst)) if lst else empty(0)
    s = lambda k: np.asarray(mj[k])

    return Model(
        nq=int(mj["nq"]), nv=int(mj["nv"]), nu=int(mj["nu"]),
        na=int(mj["na"]), nbody=int(mj["nbody"]), njnt=int(mj["njnt"]),
        ngeom=ngeom, nsite=int(mj["nsite"]), ntendon=int(mj["ntendon"]),
        nwrap=int(mj["nwrap"]), nsensor=int(mj["nsensor"]),
        nsensordata=int(mj["nsensordata"]), ncon_max=ncon_max, nefc=nefc,
        nhfield=nhf,
        hfield_nrow=int(mj["hfield_nrow"][0]) if nhf else 0,
        hfield_ncol=int(mj["hfield_ncol"][0]) if nhf else 0,
        body_parentid=s("body_parentid"), body_rootid=s("body_rootid"),
        body_jntadr=s("body_jntadr"), body_jntnum=s("body_jntnum"),
        body_dofadr=s("body_dofadr"), body_dofnum=s("body_dofnum"),
        body_geomadr=s("body_geomadr"), body_geomnum=s("body_geomnum"),
        body_tree=_tree_levels(s("body_parentid")),
        jnt_type=s("jnt_type"), jnt_qposadr=s("jnt_qposadr"),
        jnt_dofadr=s("jnt_dofadr"), jnt_bodyid=s("jnt_bodyid"),
        jnt_limited=s("jnt_limited"),
        dof_bodyid=s("dof_bodyid"), dof_jntid=s("dof_jntid"),
        dof_parentid=s("dof_parentid"),
        ancestor_mask=_ancestor_mask(s("dof_parentid"), int(mj["nv"])),
        body_dof_mask=_body_dof_mask(mj),
        tree=TL.build_tree_meta(s("dof_parentid")),
        geom_type=s("geom_type"), geom_bodyid=s("geom_bodyid"),
        geom_condim=s("geom_condim"), geom_priority=s("geom_priority"),
        geom_fluid_active=s("geom_fluid")[:, 0] != 0,
        site_bodyid=s("site_bodyid"),
        ten_adr=s("tendon_adr"), ten_num=s("tendon_num"),
        wrap_jntid=s("wrap_objid").astype(np.int32),
        actuator_trntype=s("actuator_trntype"),
        actuator_dyntype=s("actuator_dyntype"),
        actuator_gaintype=s("actuator_gaintype"),
        actuator_biastype=s("actuator_biastype"),
        actuator_trnid=s("actuator_trnid"),
        actuator_actadr=s("actuator_actadr"),
        actuator_ctrllimited=s("actuator_ctrllimited"),
        actuator_forcelimited=s("actuator_forcelimited"),
        sensor_type=s("sensor_type"), sensor_objid=s("sensor_objid"),
        sensor_objtype=s("sensor_objtype"), sensor_adr=s("sensor_adr"),
        sensor_dim=s("sensor_dim"),
        pair_geom1=pair_g1, pair_geom2=pair_g2,
        pair_type=np.array(pair_types, dtype=np.int32).reshape(-1, 2),
        con_dim=np.array(con_dim, dtype=np.int32),
        con_sel=tuple(sorted((con_sel or {}).items())),
        fused_sel=tuple(fused_sel),
        names=json.loads(str(mj["names_json"])),
        nccd=nccd, ccd_budget=ccd_budget_eff,
        ccd_classes=tuple(ccd_classes), ccd_iters=int(ccd_iters),
        ccd_geom1=ccd_g1, ccd_geom2=ccd_g2,
        ccd_b1=s("geom_bodyid")[ccd_g1].astype(np.int32),
        ccd_b2=s("geom_bodyid")[ccd_g2].astype(np.int32),
        ccd_rbsum=np.array(ccd_rbsum, dtype=np.float64),
        col_refresh=int(col_refresh),
        opt=opt,
        qpos0=a(mj["qpos0"]), qpos_spring=a(mj["qpos_spring"]),
        body_pos=a(mj["body_pos"]), body_quat=a(mj["body_quat"]),
        body_ipos=a(mj["body_ipos"]), body_iquat=a(mj["body_iquat"]),
        body_mass=a(mj["body_mass"]),
        body_subtreemass=a(mj["body_subtreemass"]),
        body_inertia=a(mj["body_inertia"]),
        body_invweight0=a(mj["body_invweight0"]),
        jnt_pos=a(mj["jnt_pos"]), jnt_axis=a(mj["jnt_axis"]),
        jnt_range=a(mj["jnt_range"]), jnt_stiffness=a(mj["jnt_stiffness"]),
        jnt_solref=a(mj["jnt_solref"]), jnt_solimp=a(mj["jnt_solimp"]),
        jnt_margin=a(mj["jnt_margin"]),
        dof_armature=a(mj["dof_armature"]),
        dof_damping=a(mj["dof_damping"]),
        dof_frictionloss=a(mj["dof_frictionloss"]),
        dof_invweight0=a(mj["dof_invweight0"]),
        geom_pos=a(mj["geom_pos"]), geom_quat=a(mj["geom_quat"]),
        geom_size=a(mj["geom_size"]), geom_friction=a(mj["geom_friction"]),
        geom_solref=a(mj["geom_solref"]), geom_solimp=a(mj["geom_solimp"]),
        geom_solmix=a(mj["geom_solmix"]),
        geom_margin=a(mj["geom_margin"]), geom_gap=a(mj["geom_gap"]),
        geom_fluid=a(mj["geom_fluid"]),
        site_pos=a(mj["site_pos"]), site_quat=a(mj["site_quat"]),
        site_size=a(mj["site_size"]),
        ten_stiffness=a(mj["tendon_stiffness"]),
        ten_damping=a(mj["tendon_damping"]),
        ten_lengthspring=a(mj["tendon_lengthspring"]),
        ten_invweight0=a(mj["tendon_invweight0"]),
        wrap_coef=a(mj["wrap_prm"]),
        actuator_dynprm=a(mj["actuator_dynprm"]),
        actuator_gainprm=a(mj["actuator_gainprm"]),
        actuator_biasprm=a(mj["actuator_biasprm"]),
        actuator_ctrlrange=a(mj["actuator_ctrlrange"]),
        actuator_forcerange=a(mj["actuator_forcerange"]),
        actuator_gear=a(mj["actuator_gear"]),
        actuator_acc0=a(mj["actuator_acc0"]),
        hfield_data=hfield_data,
        hfield_size=a(mj["hfield_size"]) if nhf else empty(0, 4),
        con_solref=stack(con_solref, 2), con_solimp=stack(con_solimp, 5),
        con_friction=stack(con_fric, 5),
        con_includemargin=vec(con_margin), con_margin=vec(con_margin),
        ccd_core=stack(ccd_core, 10), ccd_solref=stack(ccd_solref, 2),
        ccd_solimp=stack(ccd_solimp, 5), ccd_mu=vec(ccd_mu),
        ccd_includemargin=vec(ccd_margin), ccd_margin=vec(ccd_margin),
    )


def ksum(model: Model) -> int:
    from benchmark.reference.physics import constraint as C
    return sum(k for _, k in C.efc_meta(model).groups)


def nlimit(model: Model) -> int:
    from benchmark.reference.physics import constraint as C
    return len(C.efc_meta(model).limit_ids)


def fused_dims(model: Model) -> tuple[int, int, int]:
    """(R, n_lim, k_cone) of the fused solver (zeros when it is off)."""
    if model.opt.contact_solver != "fused":
        return 0, 0, 0
    from benchmark.reference.physics import constraint as C
    from benchmark.reference.physics import solver_fused as SF
    lay = SF.fused_layout(model, C.efc_meta(model))
    return lay["R"], lay["n_lim"], lay["k_cone"]


def make_data(model: Model, B: int = 1, dtype=None) -> Data:
    """Fresh batched Data (trailing batch axis B) at qpos0, zero velocity,
    on the model's device."""
    dtype = dtype or model.dtype
    dev = model.device
    z = lambda *shape: torch.zeros(shape + (B,), dtype=dtype, device=dev)
    zi = lambda *shape: torch.zeros(shape + (B,), dtype=torch.int32,
                                    device=dev)
    full = lambda v, *shape, dt=dtype: torch.full(shape + (B,), v, dtype=dt,
                                                  device=dev)
    nv, nbody, nq = model.nv, model.nbody, model.nq
    nM = model.tree.nM
    eye = lambda n: torch.eye(3, dtype=dtype, device=dev)[None, :, :, None
                                                           ].expand(
        n, 3, 3, B).clone()
    xquat = z(nbody, 4)
    xquat[:, 0] = 1.0
    ks = ksum(model)
    R, n_lim, k_cone = fused_dims(model)
    contact = Contact(
        sel=zi(ks), dist=full(1e10, ks), pos=z(ks, 3), frame=z(ks, 3, 3),
        k=z(ks), b=z(ks), R=full(1.0, ks), mu=z(ks), invw=z(ks),
        margin=z(ks), marginfull=z(ks), b1=zi(ks), b2=zi(ks), g1=zi(ks),
        g2=zi(ks), typ=full(-1, ks, dt=torch.int32), sub=zi(ks),
        solref=z(ks, 2), solimp=z(ks, 5))
    return Data(
        qpos=model.qpos0.to(dtype)[:, None].expand(nq, B).clone(),
        qvel=z(nv), act=z(model.na), ctrl=z(model.nu),
        qfrc_applied=z(nv), xfrc_applied=z(nbody, 6),
        time=torch.zeros((B,), dtype=dtype, device=dev),
        xpos=z(nbody, 3), xquat=xquat, xmat=eye(nbody), xipos=z(nbody, 3),
        ximat=eye(nbody), xanchor=z(model.njnt, 3), xaxis=z(model.njnt, 3),
        geom_xpos=z(model.ngeom, 3), geom_xmat=eye(model.ngeom),
        site_xpos=z(model.nsite, 3), site_xmat=eye(model.nsite),
        subtree_com=z(nbody, 3), cinert=z(nbody, 10), cdof=z(nv, 6),
        ten_length=z(model.ntendon), qM=z(nM), qLD=z(nM), qLDiagInv=z(nv),
        qLDh=z(nM), qLDiagInvh=z(nv), contact=contact,
        cvel=z(nbody, 6), cdof_dot=z(nv, 6), ten_velocity=z(model.ntendon),
        qfrc_bias=z(nv), qfrc_passive=z(nv), qfrc_fluid=z(nv),
        actuator_length=z(model.nu), actuator_velocity=z(model.nu),
        actuator_force=z(model.nu), act_dot=z(model.na),
        qfrc_actuator=z(nv), qfrc_smooth=z(nv), qacc_smooth=z(nv),
        qfrc_constraint=z(nv), qacc=z(nv),
        warm_sel=zi(ks), warm_f=z(ks, 3), warm_lim=z(nlimit(model)),
        apgd_v=full(1.0, R), sol_lim_sel=zi(n_lim), sol_cone_sel=zi(k_cone),
        sol_f=z(R), ccd_warm_id=full(-1, model.ccd_budget, dt=torch.int32),
        ccd_warm_u=z(model.ccd_budget, 3),
        ccd_lane_tab=z(model.ccd_budget, 25),
        sensordata=z(model.nsensordata))


def set_state(d: Data, **kw) -> Data:
    """Set per-env state columns on a B=1 batched Data from unbatched
    (mjData-shaped) arrays: ``set_state(d, qpos=..., qvel=...)``."""
    upd = {k: torch.as_tensor(np.asarray(v), dtype=d.qpos.dtype,
                              device=d.qpos.device)[..., None]
           for k, v in kw.items()}
    return d.replace(**upd)
