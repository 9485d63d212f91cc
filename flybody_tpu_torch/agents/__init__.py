"""DMPO agent: distributions, networks, the MPO loss, the learner, replay,
the batched actor and the training loop."""
