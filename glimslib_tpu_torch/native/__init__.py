"""The port's native host helpers (g++ library, ctypes, numpy and scipy
fallbacks)."""

from glimslib_tpu_torch.native.meshops import (
    available, build, cell_adjacency, facets, partition_graph, rcm_permutation,
)

__all__ = ["available", "build", "cell_adjacency", "facets", "partition_graph", "rcm_permutation"]
