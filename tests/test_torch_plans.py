"""Static per-model plans on the three benchmark configurations' CPU models
(fly walk_imitation, rat two_touch, vision_flight): each plan is built
once per model, a warmed-up control step derives no index set
(``numpy.nonzero`` is never called), collision's contact-slot layout
equals the pair tables expanded pair by pair, and the walkers' contact
readers agree with that expansion on a stepped state."""

import collections

import numpy as np
import pytest
import torch

from flybody_tpu_torch import fly_envs, rodent_envs
from flybody_tpu_torch.physics import collision as COL
from flybody_tpu_torch.physics import io_mj
from flybody_tpu_torch.physics.types import Model

torch.set_num_threads(2)

B = 4
CONFIGS = {
    "walk_imitation": lambda: fly_envs.walk_imitation(device="cpu"),
    "rodent_two_touch": lambda: rodent_envs.rodent_two_touch(device="cpu"),
    "vision_flight": lambda: fly_envs.vision_guided_flight(device="cpu"),
}
_ENVS: dict = {}


def env_of(name):
    """The config's env (built once per module), its cache of plans
    emptied, as a fresh model has it."""
    if name not in _ENVS:
        _ENVS[name] = CONFIGS[name]()
    env = _ENVS[name]
    env.model._cache.clear()
    return env


def actions(env, k):
    lo, hi = env.action_spec()
    rng = np.random.RandomState(k)
    return torch.as_tensor(lo + (hi - lo) * rng.rand(B, len(lo)),
                           dtype=torch.float32)


def run(env, steps, state=None):
    state = env.reset(B, torch.Generator().manual_seed(0)) \
        if state is None else state
    for k in range(steps):
        state = env.autoreset_step(state, actions(env, k))
    return state


def expanded_slots(m):
    """Per analytic slot (g1, g2, b1, b2, typ, sub), each candidate pair
    repeated by its PAIR_NCON, typ its type pair's first-occurrence rank."""
    gb = np.asarray(m.geom_bodyid)
    order, rows = [], []
    for k, (t1, t2) in enumerate(np.asarray(m.pair_type).tolist()):
        if (t1, t2) not in order:
            order.append((t1, t2))
        g1, g2 = int(m.pair_geom1[k]), int(m.pair_geom2[k])
        for j in range(io_mj.PAIR_NCON[(t1, t2)]):
            rows.append((g1, g2, gb[g1], gb[g2], order.index((t1, t2)), j))
    return order, np.array(rows, np.int64).reshape(-1, 6)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_each_plan_is_built_once(name, monkeypatch):
    """Over a reset and three control steps, every plan is built at
    most once, all on the env's one model; the stages' plans are among
    them."""
    env = env_of(name)
    built = collections.Counter()
    plan = Model.plan

    def counted(self, key, build):
        def build_once(m):
            built[(id(m), key)] += 1
            return build(m)
        return plan(self, key, build_once)

    monkeypatch.setattr(Model, "plan", counted)
    run(env, 3)
    assert {i for i, _ in built} == {id(env.model)}
    assert max(built.values()) == 1, built
    names = {k[0] if isinstance(k, tuple) else k for _, k in built}
    assert {"slot_layout", "slot_table", "efc_meta", "actuators", "joints",
            "sensors", "kinematics", "subtree_matrix"} <= names, names


@pytest.mark.parametrize("name", list(CONFIGS))
def test_a_warm_step_calls_no_nonzero(name, monkeypatch):
    """A warmed-up autoreset_step (its reset included) never calls
    numpy.nonzero: every index set comes from a plan."""
    env = env_of(name)
    state = run(env, 1)
    calls = []
    nonzero = np.nonzero

    def counting(*a, **k):
        calls.append(1)
        return nonzero(*a, **k)

    monkeypatch.setattr(np, "nonzero", counting)
    run(env, 1, state)
    assert calls == []
    np.nonzero(np.ones(2))
    assert calls == [1]


@pytest.mark.parametrize("name", list(CONFIGS))
def test_slot_layout_expands_the_pair_tables(name):
    """slot_layout(m) equals the pair tables expanded pair by pair: each
    slot's geoms, bodies, type group and sub-contact, the pairs' slot
    offsets, the candidate slots (the analytic, then the convex pairs'),
    and the group and condim index sets."""
    m = env_of(name).model
    lay = COL.slot_layout(m)
    order, rows = expanded_slots(m)
    assert rows.shape[0] == m.ncon_max
    for col, field in enumerate(("g1", "g2", "b1", "b2", "typ", "sub")):
        np.testing.assert_array_equal(getattr(lay, field), rows[:, col],
                                      err_msg=field)
    ncon = [io_mj.PAIR_NCON[tuple(t)] for t in np.asarray(m.pair_type)]
    np.testing.assert_array_equal(lay.slot_of_pair,
                                  np.concatenate([[0], np.cumsum(ncon)]))
    for field, col, ccd in (("cand_g1", 0, m.ccd_geom1),
                            ("cand_g2", 1, m.ccd_geom2),
                            ("cand_b1", 2, m.ccd_b1),
                            ("cand_b2", 3, m.ccd_b2)):
        np.testing.assert_array_equal(
            getattr(lay, field), list(rows[:, col]) + list(ccd),
            err_msg=field)
    assert list(lay.groups) == order
    pt = [tuple(t) for t in np.asarray(m.pair_type).tolist()]
    for tid, (key, (pg1, pg2, slots)) in enumerate(zip(lay.groups,
                                                       lay.group_ix)):
        pairs = [k for k, t in enumerate(pt) if t == key]
        np.testing.assert_array_equal(lay.groups[key], pairs)
        np.testing.assert_array_equal(pg1.numpy(), m.pair_geom1[pairs])
        np.testing.assert_array_equal(pg2.numpy(), m.pair_geom2[pairs])
        np.testing.assert_array_equal(
            slots.numpy(), [s for s in range(len(rows)) if rows[s, 4] == tid])
    con_dim = np.asarray(m.con_dim)
    assert sorted(lay.condim_slots) == sorted(set(con_dim.tolist()))
    for cd, slots in lay.condim_slots.items():
        want = [s for s in range(len(rows)) if con_dim[s] == cd]
        np.testing.assert_array_equal(slots.numpy(), want)
        tids = sorted({int(rows[s, 4]) for s in want})
        assert lay.condim_typ[cd] == tuple((t, order[t]) for t in tids)


def _selected_force(data, mask):
    """The walkers' reduction with ``mask`` over the candidate slots."""
    sel = data.warm_sel.long()
    flag = torch.where(sel >= 0, torch.as_tensor(mask).to(
        data.qpos.dtype)[sel.clamp(min=0)], torch.zeros(()))
    return torch.sum(torch.abs(data.warm_f[:, 0]) * flag, dim=0)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_walker_contact_readers_on_a_stepped_state(name):
    """The fly's self_contact and the rat's contact_flag, on a stepped
    state as selected and with every candidate slot drawn into the
    selection, against masks built from the expanded pair tables."""
    env = env_of(name)
    m, w = env.model, env.task.walker
    data = run(env, 2).data
    _, rows = expanded_slots(m)
    b1 = np.concatenate([rows[:, 2], m.ccd_b1])
    b2 = np.concatenate([rows[:, 3], m.ccd_b2])
    g1 = np.concatenate([rows[:, 0], m.ccd_geom1])
    g2 = np.concatenate([rows[:, 1], m.ccd_geom2])
    n = len(b1)
    rng = np.random.RandomState(1)
    drawn = data.replace(
        warm_sel=torch.as_tensor(rng.randint(-1, n, data.warm_sel.shape),
                                 dtype=torch.int32),
        warm_f=torch.as_tensor(rng.rand(*data.warm_f.shape),
                               dtype=data.warm_f.dtype))
    for d in (data, drawn):
        if hasattr(w, "self_contact"):
            want = _selected_force(d, (b1 != 0) & (b2 != 0))
            torch.testing.assert_close(w.self_contact(m, d), want,
                                       rtol=0, atol=0)
        else:
            for a, b in ((w.nonfoot_geoms, w.ground_geoms),
                         (w.walker_geoms, w.ground_geoms),
                         (w.walker_geoms, w.walker_geoms)):
                joins = ((np.isin(g1, a) & np.isin(g2, b))
                         | (np.isin(g1, b) & np.isin(g2, a)))
                want = (_selected_force(d, joins) > 0).to(d.qpos.dtype)
                torch.testing.assert_close(w.contact_flag(m, d, a, b), want,
                                           rtol=0, atol=0)
    if hasattr(w, "self_contact"):
        assert float(w.self_contact(m, data).sum()) > 0
    else:
        assert float(w.contact_flag(m, drawn, w.walker_geoms,
                                    w.ground_geoms).sum()) > 0
