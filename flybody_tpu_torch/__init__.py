"""PyTorch/CUDA port of flybody_tpu: the batched fruit-fly physics engine
and its environments, with the contact solve as a hand-written CUDA
kernel for Hopper. Imports torch and numpy only (mujoco only inside the
model exporter)."""
