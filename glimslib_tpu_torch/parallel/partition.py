"""Mesh partitioning for ``use_sharding(mode="cells")`` (copy of
``glimslib_tpu/parallel/partition.py``): cells are split into ``n_parts``
spatially-contiguous, equal-size (padded) blocks on the host; each rank
owns one block of cells and runs the element gather, compute and
scatter on it (``parallel/shard.py ShardedP1Kernels``).

The split is the native greedy graph-growing partitioner
(``native/meshops.py partition_graph``); where the library fails it falls
back to a Morton (Z-order) sort of cell centroids.  ``method`` on the
partition says which one ran.

Padding: blocks are padded to equal cell counts with entries whose volume
is zeroed (``pad_mask``), so padded slots contribute exactly zero.
"""

from __future__ import annotations

import dataclasses

import numpy as np


def morton_order(points: np.ndarray, bits: int = 10) -> np.ndarray:
    """Z-order curve sort indices for spatial locality."""
    pts = np.asarray(points, dtype=np.float64)
    mins = pts.min(axis=0)
    spans = np.maximum(pts.max(axis=0) - mins, 1e-300)
    q = ((pts - mins) / spans * ((1 << bits) - 1)).astype(np.uint64)
    dim = pts.shape[1]
    code = np.zeros(len(pts), dtype=np.uint64)
    for b in range(bits):
        for a in range(dim):
            code |= ((q[:, a] >> np.uint64(b)) & np.uint64(1)) << np.uint64(
                b * dim + a
            )
    return np.argsort(code, kind="stable")


@dataclasses.dataclass
class CellPartition:
    """Equal-size padded cell blocks + per-block sorted scatter plans.

    Arrays have leading axis ``n_parts`` and are sharded over it:
      cells      (P, C, npe)   node ids (pad slots alias cell 0)
      vol        (P, C)        volumes, 0.0 on pad slots
      grads      (P, C, npe, d)
      cell_perm  (P, C)        original cell index of each slot (pad: 0)
      pad_mask   (P, C)        1.0 real / 0.0 pad
      sort_idx   (P, C*npe)    per-block COO sort permutation
      sorted_ids (P, C*npe)    node ids after permutation
    """

    n_parts: int
    n_nodes: int
    npe: int
    cells: np.ndarray
    vol: np.ndarray
    grads: np.ndarray
    cell_perm: np.ndarray
    pad_mask: np.ndarray
    sort_idx: np.ndarray
    sorted_ids: np.ndarray
    # the partitioner that ran: "graph" (native) or "morton"
    method: str = "graph"

    def shard_cell_values(self, values: np.ndarray) -> np.ndarray:
        """Per-cell array (nc, ...) -> per-block (P, C, ...) via cell_perm.
        Pad slots repeat cell 0's value but are masked by zero volume."""
        return np.asarray(values)[self.cell_perm]


def partition_cells(mesh, n_parts: int, method: str = "graph") -> CellPartition:
    nc = mesh.n_cells
    npe = mesh.dim + 1
    per = -(-nc // n_parts)  # ceil

    if method == "graph":
        # native greedy graph-growing partitioner (lower edge-cut / halo)
        try:
            from glimslib_tpu_torch.native import meshops

            part_ids = meshops.partition_graph(mesh.cells, n_parts)
        except Exception:
            method = "morton"
    if method == "morton":
        order = morton_order(mesh.cell_midpoints)
        part_ids = np.empty(nc, dtype=np.int64)
        part_ids[order] = np.minimum(np.arange(nc) // per, n_parts - 1)

    cell_perm = np.zeros((n_parts, per), dtype=np.int64)
    mask = np.zeros((n_parts, per))
    # First fill every block with up to `per` of its own cells, collecting
    # overflow; only THEN spill overflow into the least-filled blocks.  Doing
    # the spill during the fill loop could place cells into a later block's
    # slots that the fill pass would clobber (advisor finding r1).
    overflow_all = []
    for p in range(n_parts):
        mine = np.where(part_ids == p)[0]
        take = mine[:per]
        cell_perm[p, : len(take)] = take
        mask[p, : len(take)] = 1.0
        overflow_all.extend(mine[per:])
    if overflow_all:
        fills = mask.sum(axis=1)
        for c in overflow_all:
            q = int(np.argmin(fills))
            slot = int(fills[q])
            assert slot < per, "partition overflow exceeds total padded capacity"
            cell_perm[q, slot] = c
            mask[q, slot] = 1.0
            fills[q] += 1.0
    assert int(mask.sum()) == nc, "partitioner dropped or duplicated cells"
    cells = mesh.cells[cell_perm]
    vol = mesh.cell_volumes[cell_perm] * mask
    grads = mesh.cell_grads[cell_perm]

    sort_idx = np.zeros((n_parts, per * npe), dtype=np.int32)
    sorted_ids = np.zeros((n_parts, per * npe), dtype=np.int32)
    for p in range(n_parts):
        flat = cells[p].ravel()
        si = np.argsort(flat, kind="stable").astype(np.int32)
        sort_idx[p] = si
        sorted_ids[p] = flat[si]

    return CellPartition(
        n_parts=n_parts,
        n_nodes=mesh.n_nodes,
        npe=npe,
        cells=cells.astype(np.int32),
        vol=vol,
        grads=grads,
        cell_perm=cell_perm,
        pad_mask=mask,
        sort_idx=sort_idx,
        sorted_ids=sorted_ids,
        method=method,
    )
