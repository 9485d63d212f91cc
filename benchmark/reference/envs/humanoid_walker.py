"""CMU humanoid walker (the position-controlled 2020 variant).

The walker of the reference's walk_humanoid tracking factory (reference
vnl_ray/tasks/basic_rodent_2020.py:286-337). It shares the rat's walker;
only the name map differs: the root, the pelvis, the hands and the five
end-effector bodies.

Its ``end_effectors_pos`` observable is empty, as in the JAX package:
``RodentWalker.__init__`` counts the limb tips from the rat's body and
site names, which the humanoid does not have, before this walker sets its
end-effector bodies (ROADMAP C).
"""

from __future__ import annotations

import numpy as np

from benchmark.reference.envs.rodent_walker import RodentWalker
from benchmark.reference.math import quaternions as mq
from benchmark.reference.physics.types import Data, Model


class HumanoidWalker(RodentWalker):
    PREFIX = "walker/"

    def __init__(self, model: Model):
        super().__init__(model)
        bodies = model.names["body"]
        p = self.PREFIX
        root = bodies.get(p + "root", bodies.get(p + "torso",
                                                 self.root_body_id))
        self.root_body_id = root
        self.torso_id = root
        self.pelvis_id = bodies.get(p + "pelvis", root)
        self.lhand_body = bodies.get(p + "lhand", 0)
        self.rhand_body = bodies.get(p + "rhand", 0)
        # end effectors: the hands, the feet and the head
        self.end_effector_bodies = np.asarray(
            [bodies[p + n] for n in ("lhand", "rhand", "lfoot", "rfoot",
                                     "head") if p + n in bodies],
            dtype=np.int64)

    def appendages_pos(self, data: Data):
        """Egocentric end-effector positions, (B, 3 n) (no head site)."""
        m = self.model
        tips = data.xpos[m.ix(self.end_effector_bodies)].permute(2, 0, 1)
        root_pos = data.xpos[self.root_body_id].T[:, None]     # (B, 1, 3)
        root_quat = data.xquat[self.root_body_id].T[:, None]   # (B, 1, 4)
        ego = mq.rotate_vec_with_quat(tips - root_pos,
                                      mq.conj_quat(root_quat))
        return ego.reshape(ego.shape[0], -1)
