"""Task constants (reference vnl_ray/tasks/constants.py)."""

# Timesteps (seconds, CGS time base)
WALK_PHYSICS_TIMESTEP = 2e-4
WALK_CONTROL_TIMESTEP = 2e-3
FLY_PHYSICS_TIMESTEP = 5e-5
FLY_CONTROL_TIMESTEP = 2e-4

# Termination thresholds
TERMINAL_LINVEL = 50.0      # cm/s
TERMINAL_ANGVEL = 200.0     # rad/s
TERMINAL_HEIGHT = 0.2       # cm (flight)
TERMINAL_QACC = 1e14

# Wing-beat pattern generator parameters
WING_PARAMS = {
    "base_freq": 218.0,          # Hz
    "rel_freq_range": 0.05,
    "num_freqs": 201,
    "gainprm": (18.0, 18.0, 18.0),
    "stiffness": 0.01,
    "damping": 7.77e-3,
    "fluidcoef": (1.0, 0.5, 1.5, 1.7, 1.0),
}

BODY_PITCH_ANGLE = 47.5  # degrees, hover body pitch
