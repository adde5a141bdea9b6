"""Node-sharded execution of the lattice lane on ``torch.distributed``
(counterpart of ``glimslib_tpu/parallel/gspmd.py``).

The reference shards the flat node axis of every node vector and every
stencil plane over its devices and lets GSPMD turn each ``jnp.roll`` into
collective-permutes of the halo slices.  The port does the same thing
explicitly, SPMD on the ranks of a process group:

- each rank owns a contiguous range of node rows, ``[start, end)``, n /
  world of them (:class:`NodeSlab`); its planes, its state and every
  vector of its solves hold those rows only;
- before each stencil apply a halo exchange (:func:`halo_exchange`) fills
  ``H = max |offset|`` rows on either side of the owned ones, and the
  halo form of ``stencil_apply`` (``ops/stencil_kernels.py``) reads them
  with no wrap;
- the stencil planes are assembled from the cells that touch an owned
  node, in node ids local to the halo-padded slab;
- every norm and dot product is reduced over the ranks
  (``solvers/cg.py pcg`` and ``solvers/coupled.py make_step`` take a
  ``reduce`` hook), so every rank takes the same convergence decisions.

The exchange is one ``all_reduce`` of a zero buffer over the rows within
H of an interior rank boundary, in which each rank fills the rows it
owns: exact (adding zeros is exact), one code path on gloo and NCCL, and
it serves a halo that reaches past the nearest neighbour (a rank of 16
nodes under a halo of 21).  Point-to-point sends of the halo slices
alone are later work.

Differentiation.  The exchange is an autograd Function whose JVP is the
same exchange of the tangent (the matrix-free lane's ``torch.func.jvp``)
and whose VJP is the transposed exchange: each rank writes the
cotangents of its halo rows into the band at their global rows, one
all-reduce sums them, and each owner adds the band rows it sent into the
cotangent of its own rows
(again one collective, none at world 1).  Every rank runs the same
autograd graph, so the backward's collectives come in the same order on
all of them.  :func:`gather_nodes` is differentiable as
``parallel/shard.py gather_rows`` is (a rank's rows of the replicated
cotangent).  A replicated coefficient entering a rank's slab work goes
through ``shard.enter`` (``Simulation._augment_theta_with_operators``),
which sums its cotangent over the ranks once, and a rank-local partial
sum leaves it through ``shard.reduce_sum``: so the gradient of a
functional of the trajectory is the unsharded model's on every rank.

Non-divisible node counts: pad the mesh with
:func:`glimslib_tpu_torch.core.mesh.pad_mesh_nodes` before building the
model (its padding nodes are unused, zero-Dirichlet dofs; every rank then
owns whole planes of the slowest lattice axis).

This module is the functional entry; the object API is
``sim.use_sharding(device_mesh, mode="nodes")`` followed by ``run()``,
or by ``optimize.InverseProblem`` for a gradient.
"""

from __future__ import annotations

import types

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from glimslib_tpu_torch.ops.stencil import stencil_offsets
from glimslib_tpu_torch.parallel.shard import gather_rows


class NodeSlab:
    """Rank ``rank``'s slab of the flat node axis of a lattice mesh, for a
    world of ``world`` ranks: owned rows ``[start, end)``, the halo ``H``
    (the largest |offset| of the mesh's stencil), the cells that touch an
    owned node (``cell_ids``) and the same cells in node ids local to the
    halo-padded slab (``local_mesh``: padded row k is global node
    ``start - H + k``), and the exchange plan.

    The plan: ``band`` holds, sorted, the global rows within H of an
    interior rank boundary; the rank writes ``x_own[send_src]`` into
    ``band[send_pos]`` and, after the all-reduce, reads ``band[recv_pos]``
    into the padded rows ``recv_dst``.  Padded rows outside the mesh stay
    zero (no plane reads them: a boundary node has no neighbour there)."""

    def __init__(self, mesh, rank, world, device="cpu"):
        n = int(mesh.n_nodes)
        if n % world:
            raise ValueError(
                f"n_nodes={n} not divisible by {world} devices; pad the mesh with "
                "core.mesh.pad_mesh_nodes before constructing the model")
        self.rank, self.world, self.n_total = int(rank), int(world), n
        self.n_own = n // world
        self.start = self.rank * self.n_own
        self.end = self.start + self.n_own
        self.offsets = [int(o) for o in stencil_offsets(mesh.cells)]
        self.halo = H = max(abs(o) for o in self.offsets)
        self.n_pad = self.n_own + 2 * H
        lo = self.start - H
        cells = np.asarray(mesh.cells, dtype=np.int64)
        owned = (cells >= self.start) & (cells < self.end)
        self.cell_ids = np.flatnonzero(owned.any(axis=1))
        # a cell's nodes differ by at most H: its local ids lie in the slab
        self.local_mesh = types.SimpleNamespace(
            dim=mesh.dim, n_nodes=self.n_pad, n_cells=len(self.cell_ids),
            cells=cells[self.cell_ids] - lo, cell_volumes=np.asarray(mesh.cell_volumes)[self.cell_ids],
            cell_grads=np.asarray(mesh.cell_grads)[self.cell_ids],
            lattice_strides=mesh.lattice_strides)
        bounds = [r * self.n_own for r in range(1, self.world)]
        band = (np.unique(np.concatenate([np.arange(b - H, b + H) for b in bounds]))
                if bounds else np.zeros(0, np.int64))
        band = band[(band >= 0) & (band < n)]
        mine = (band >= self.start) & (band < self.end)
        pad_rows = np.concatenate([np.arange(H), np.arange(H + self.n_own, self.n_pad)])
        glob = pad_rows + lo
        inside = (glob >= 0) & (glob < n)
        # every halo row in the mesh lies within H of one of this rank's
        # interior boundaries, so in the band
        recv_pos = np.searchsorted(band, glob[inside])
        dev = torch.device(device)
        idx = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=dev)  # noqa: E731
        self.n_band = len(band)
        self.send_pos = idx(np.flatnonzero(mine))
        self.send_src = idx(band[mine] - self.start)
        self.recv_pos = idx(recv_pos)
        self.recv_dst = idx(pad_rows[inside])

    @property
    def own_rows(self):
        """The owned rows' range in the halo-padded slab: (H, H + n_own)."""
        return self.halo, self.halo + self.n_own

    def own(self, x):
        """The owned rows of a whole node array (node axis first)."""
        return x[self.start:self.end]


def _exchange(mesh, slab, x_own):
    H, tail = slab.halo, tuple(x_own.shape[1:])
    out = x_own.new_zeros((slab.n_pad,) + tail)
    out[H:H + slab.n_own] = x_own
    if slab.n_band:
        band = x_own.new_zeros((slab.n_band,) + tail)
        band[slab.send_pos] = x_own[slab.send_src]
        mesh.all_reduce(band)
        out[slab.recv_dst] = band[slab.recv_pos]
    return out


def _exchange_T(mesh, slab, g_pad):
    """The transposed exchange: (n_own + 2 H, ...) cotangents of the
    padded rows -> (n_own, ...) cotangents of the owned rows, each halo
    row's added to its owner's row (one all-reduce over the band)."""
    H = slab.halo
    g = g_pad[H:H + slab.n_own].clone()
    if slab.n_band:
        band = g_pad.new_zeros((slab.n_band,) + tuple(g_pad.shape[1:]))
        band[slab.recv_pos] = g_pad[slab.recv_dst]
        mesh.all_reduce(band)
        # send_src holds each owned row once: a plain indexed add
        g[slab.send_src] += band[slab.send_pos]
    return g


class _HaloExchange(torch.autograd.Function):
    @staticmethod
    def forward(x_own, mesh, slab):
        return _exchange(mesh, slab, x_own)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, ctx.mesh, ctx.slab = inputs

    @staticmethod
    def jvp(ctx, x_t, _mesh_t, _slab_t):
        return _exchange(ctx.mesh, ctx.slab, x_t)

    @staticmethod
    @once_differentiable
    def backward(ctx, g_pad):
        return _exchange_T(ctx.mesh, ctx.slab, g_pad.contiguous()), None, None


def halo_exchange(mesh, slab, x_own):
    """``x_own`` (n_own, ...) with H rows of the neighbouring ranks on
    either side: (n_own + 2 H, ...), zeros where the rows lie outside the
    mesh.  One all-reduce over the exchange band (none at world 1), and
    one more for a tangent (``torch.func.jvp``: the same exchange) or in
    the backward (the transposed exchange).  Every rank calls it at once.
    Every call goes through the autograd Function: a collective called on
    a tensor of a ``torch.func`` transform would move its primal alone."""
    return _HaloExchange.apply(x_own, mesh, slab)


def halo_exchange_many(mesh, slab, *xs):
    """:func:`halo_exchange` of several node vectors of one dtype, (n_own,)
    or (n_own, k), in one exchange: stacked as columns, exchanged, split
    again (each padded vector contiguous).  Under grad a padded vector
    whose input needs no gradient is detached, so no backward asks for its
    cotangent (a residual VJP in u and c wants c's alone); a tangent
    (``torch.func.jvp``) goes through every one."""
    if len(xs) == 1:
        return [halo_exchange(mesh, slab, xs[0])]
    cols = [x[:, None] if x.dim() == 1 else x for x in xs]
    padded = halo_exchange(mesh, slab, torch.cat(cols, dim=1))
    out, j = [], 0
    for x, c in zip(xs, cols):
        k = c.shape[1]
        part = padded[:, j:j + k]
        part = (part[:, 0] if x.dim() == 1 else part).contiguous()
        detach = torch.is_grad_enabled() and not x.requires_grad and part.requires_grad
        out.append(part.detach() if detach else part)
        j += k
    return out


def gather_nodes(mesh, slab, x_own):
    """The whole (n, ...) field on every rank from each rank's owned rows
    (one all-reduce of a zero buffer, ``shard.gather_rows``);
    differentiable: a rank's rows of the replicated cotangent."""
    return gather_rows(mesh, x_own, slab.start, slab.n_total)


def shard_simulate(sim, n_steps, dt, device_mesh):
    """The simulation's time loop with node-sharded inputs: returns
    ``(simulate_fn, prepare)``, where ``prepare(theta, u0, c0)`` takes the
    whole initial state and returns the arguments of ``simulate_fn``
    (theta, this rank's rows of ``u0`` and ``c0``), and ``simulate_fn``
    returns this rank's rows of the trajectory, differentiable in theta
    (the gradient of the ranks' summed objective, the same on every
    rank; module docstring).  Requires a lattice mesh
    and ``n_nodes % world == 0`` (see pad_mesh_nodes)."""
    if sim.mesh.lattice_strides is None:
        raise ValueError("gspmd sharding requires a lattice mesh (stencil mode)")
    sim.use_sharding(device_mesh, mode="nodes")  # raises where the world does not divide
    slab = sim._node_slab
    simulate = sim.build_simulate_fn(n_steps, dt)

    def prepare(theta, u0, c0):
        put = lambda x: torch.as_tensor(x, dtype=sim.dtype, device=sim.device)  # noqa: E731
        return theta, slab.own(put(u0)).contiguous(), slab.own(put(c0)).contiguous()

    return simulate, prepare
