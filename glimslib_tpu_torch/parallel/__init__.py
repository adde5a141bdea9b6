"""Multi-process execution on ``torch.distributed`` (counterpart of
``glimslib_tpu/parallel/``): the 1-D mesh over a process group, the
launcher, and the crossings between replicated and rank-local tensors
(``shard.py``).  ``Simulation.use_sharding(mode="bell")`` builds on them."""

from glimslib_tpu_torch.parallel.shard import (
    DeviceMesh, enter, gather_rows, make_device_mesh, run_ranks,
)

__all__ = ["DeviceMesh", "enter", "gather_rows", "make_device_mesh", "run_ranks"]
