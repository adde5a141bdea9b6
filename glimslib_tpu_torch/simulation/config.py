"""Reference-compatible sub-config (reference ``glimslib/simulation/config.py``
re-exports the root config)."""

from glimslib_tpu_torch.config import *  # noqa: F401,F403
from glimslib_tpu_torch.config import output_dir, output_dir_simulation_tmp, USE_ADJOINT  # noqa: F401
