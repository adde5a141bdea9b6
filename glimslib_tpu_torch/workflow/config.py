"""Reference-compatible sub-config (counterpart of
``glimslib_tpu/workflow/config.py``): the port's output paths."""

from glimslib_tpu_torch.config import *  # noqa: F401,F403
from glimslib_tpu_torch.config import output_dir  # noqa: F401
