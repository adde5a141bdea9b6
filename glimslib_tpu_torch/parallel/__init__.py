"""Multi-process execution on ``torch.distributed`` (counterpart of
``glimslib_tpu/parallel/``): the 1-D mesh over a process group, the
launcher, and the crossings between replicated and rank-local tensors
(``shard.py``), on which ``Simulation.use_sharding(mode="bell")`` builds;
the lattice node slabs, their halo exchange and the node-sharded time
loop (``gspmd.py``), on which ``use_sharding(mode="nodes")`` builds."""

from glimslib_tpu_torch.parallel.gspmd import (
    NodeSlab, gather_nodes, halo_exchange, halo_exchange_many, shard_simulate,
)
from glimslib_tpu_torch.parallel.shard import (
    DeviceMesh, enter, gather_rows, make_device_mesh, reduce_sum, run_ranks,
)

__all__ = ["DeviceMesh", "NodeSlab", "enter", "gather_nodes", "gather_rows",
           "halo_exchange", "halo_exchange_many", "make_device_mesh", "reduce_sum",
           "run_ranks", "shard_simulate"]
