"""Reference-compatible alias for ``glimslib/simulation_helpers/
math_reaction_diffusion.py``."""

from glimslib_tpu_torch.ops.forms import compute_growth_logistic  # noqa: F401
