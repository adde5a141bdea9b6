"""Reference-compatible module path for ``glimslib/simulation/
simulation_tumor_growth.py``."""

from glimslib_tpu_torch.models.tumor_growth import TumorGrowth  # noqa: F401
