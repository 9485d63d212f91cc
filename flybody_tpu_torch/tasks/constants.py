"""Task constants (reference vnl_ray/tasks/constants.py)."""

# Timesteps (seconds, CGS time base)
WALK_PHYSICS_TIMESTEP = 2e-4
WALK_CONTROL_TIMESTEP = 2e-3

# Termination thresholds
TERMINAL_LINVEL = 50.0      # cm/s
TERMINAL_ANGVEL = 200.0     # rad/s
TERMINAL_QACC = 1e14
