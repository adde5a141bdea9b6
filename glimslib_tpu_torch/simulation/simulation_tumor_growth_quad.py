"""Reference-compatible module path for ``glimslib/simulation/
simulation_tumor_growth_quad.py`` (P2 concentration)."""

from glimslib_tpu_torch.models.tumor_growth_quad import TumorGrowth  # noqa: F401
