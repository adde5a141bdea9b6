"""Multi-process execution on ``torch.distributed`` (counterpart of
``glimslib_tpu/parallel/``): the 1-D mesh over a process group, the
launcher, and the crossings between replicated and rank-local tensors
(``shard.py``), on which ``Simulation.use_sharding(mode="bell")`` builds;
the element kernels of ``mode="cells"`` on a rank's block of cells
(``shard.py ShardedP1Kernels``, the blocks from ``partition.py``); the
lattice node slabs, their halo exchange and the node-sharded time loop
(``gspmd.py``), and the owned/ghost node sharding of unstructured meshes
(``nodeshard.py``), on which ``use_sharding(mode="nodes")`` builds."""

from glimslib_tpu_torch.parallel.gspmd import (
    NodeSlab, gather_nodes, halo_exchange, halo_exchange_many, shard_simulate,
)
from glimslib_tpu_torch.parallel.nodeshard import NodeShardedP1Kernels, NodeShardSpec
from glimslib_tpu_torch.parallel.partition import CellPartition, partition_cells
from glimslib_tpu_torch.parallel.shard import (
    DeviceMesh, ShardedP1Kernels, enter, gather_rows, make_device_mesh, reduce_sum,
    run_ranks,
)

__all__ = ["CellPartition", "DeviceMesh", "NodeShardSpec", "NodeShardedP1Kernels",
           "NodeSlab", "ShardedP1Kernels", "enter", "gather_nodes", "gather_rows",
           "halo_exchange", "halo_exchange_many", "make_device_mesh", "partition_cells",
           "reduce_sum", "run_ranks", "shard_simulate"]
