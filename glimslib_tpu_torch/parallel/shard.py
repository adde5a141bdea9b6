"""Multi-process execution on ``torch.distributed`` (counterpart of
``glimslib_tpu/parallel/shard.py``'s ``make_device_mesh``).

The port runs SPMD, as the reference's ``mpirun`` does: every rank runs
the same script, node vectors stay replicated on every rank, and what a
model shards (``Simulation.use_sharding(mode="bell")``) lives only as the
rank's slab.  A rank reads the slab's part of a replicated vector,
contracts it, and one collective re-replicates the result.

- :func:`make_device_mesh` wraps the initialised default process group as
  a 1-D mesh (:class:`DeviceMesh`).  Without a group it raises: start the
  script under ``torchrun`` or through :func:`run_ranks`.
- :func:`run_ranks` spawns ``world`` processes, joins them into a group
  through a ``FileStore`` in a temporary directory (no fixed port, so
  runs side by side never collide), and returns what ``fn`` returned on
  each rank.  The caller names the backend: ``nccl`` with one card per
  rank, or ``gloo``, for the CPU and for ranks that share one card.
- :func:`enter`, :func:`gather_rows` and :func:`reduce_sum` are the
  crossings between replicated and rank-local tensors, each an autograd
  Function: a replicated tensor entering rank-local work is the identity
  forward and an ``all_reduce`` (sum) of its cotangent backward, since
  each rank's gradient is the part of its own slab; gathering the slabs'
  rows is an ``all_reduce`` of a zero buffer in which each rank fills its
  own rows (exact: adding zeros is exact; it takes uneven slabs and CUDA
  tensors on either backend), and its backward takes the rank's rows of
  the replicated cotangent; a rank-local partial sum made replicated is
  an ``all_reduce`` forward and the identity backward.

The lattice's node sharding (``mode="nodes"``) is ``parallel/gspmd.py``,
the unstructured one ``parallel/nodeshard.py``.

:class:`ShardedP1Kernels` is ``mode="cells"`` (counterpart of the
reference's class of that name): the mesh's cells are split into one
block a rank (``parallel/partition.py``, the native graph partitioner),
each rank evaluates the element kernels of its block on the replicated
node vectors and accumulates into the rows its cells touch, and one
``all_reduce`` (:func:`reduce_sum`) makes the result replicated.  The
replicated inputs enter through :func:`enter`, so a gradient sums each
rank's part of their cotangent once; under ``torch.func.jvp`` the
tangent of the residual is summed by the same collective.  It has the
reference's method surface and no ``elasticity_diag_blocks``: a model
on it takes point-Jacobi on its elasticity block, as the reference's.
"""

from __future__ import annotations

import datetime
import importlib
import os
import queue
import tempfile
import traceback
import types
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from glimslib_tpu_torch import config


class DeviceMesh(NamedTuple):
    """A 1-D mesh over the ranks of a process group: the group, this
    rank, the world size, the rank's device and the axis name."""

    group: object
    rank: int
    world: int
    device: torch.device
    axis_name: str
    backend: str

    def all_reduce(self, t):
        """Sum ``t`` over the ranks, in place; returns it."""
        dist.all_reduce(t, group=self.group)
        return t

    def all_max(self, t):
        """The elementwise maximum of ``t`` over the ranks, in place;
        returns it."""
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group)
        return t

    def gather_rows(self, local, start, total):
        """The (total, ...) tensor whose rows [start, start + len(local))
        are this rank's ``local`` and whose other rows are the other
        ranks': one ``all_reduce`` of a zero buffer."""
        buf = local.new_zeros((total,) + tuple(local.shape[1:]))
        buf[start:start + local.shape[0]] = local
        return self.all_reduce(buf)

    def broadcast(self, t, src=0):
        """``t`` from rank ``src`` on every rank, in place; returns it."""
        dist.broadcast(t, src, group=self.group)
        return t


def make_device_mesh(n_devices=None, axis_name: str = "mesh_x", device=None):
    """The 1-D mesh over the ranks of the initialised default process
    group, on ``device`` (default: the card; ``"cpu"`` for the CPU, gloo
    only).  ``n_devices``, where given, must be the world size."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "make_device_mesh needs an initialised torch.distributed process "
            "group: start the script under torchrun, or run it through "
            "glimslib_tpu_torch.parallel.run_ranks")
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_devices is not None and int(n_devices) != world:
        raise ValueError(f"n_devices={n_devices}, but the process group has "
                         f"{world} ranks")
    backend = str(dist.get_backend())
    dev = canonical_device(config.resolve_device(device))
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"the nccl backend needs a CUDA device, not {dev}")
    return DeviceMesh(dist.group.WORLD, rank, world, dev, axis_name, backend)


def canonical_device(dev):
    """``dev`` with its index: a bare ``cuda`` is the current card."""
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


# -- crossings between replicated and rank-local tensors ----------------------


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(x, mesh):
        return x.view_as(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mesh = inputs[1]

    @staticmethod
    def jvp(ctx, x_t, _mesh_t):
        return x_t.view_as(x_t)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce(g.contiguous().clone()), None


def enter(mesh, x):
    """A replicated tensor ``x`` as the input of rank-local work: itself
    (its tangent too, under ``torch.func.jvp``); its cotangent, each
    rank's part, is summed over the ranks once."""
    if mesh is not None and torch.is_grad_enabled() and x.requires_grad:
        return _Enter.apply(x, mesh)
    return x


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, local, mesh, start, total):
        ctx.rows = (start, start + local.shape[0])
        return mesh.gather_rows(local, start, total)

    @staticmethod
    def backward(ctx, g):
        lo, hi = ctx.rows
        return g[lo:hi].contiguous(), None, None, None


def gather_rows(mesh, local, start, total):
    """:meth:`DeviceMesh.gather_rows`, differentiable: the cotangent of
    the replicated result is the same on every rank, so a rank's rows of
    it are its slab's."""
    if torch.is_grad_enabled() and local.requires_grad:
        return _GatherRows.apply(local, mesh, start, total)
    return mesh.gather_rows(local, start, total)


class _ReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(x, mesh):
        return mesh.all_reduce(x.contiguous().clone())

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mesh = inputs[1]

    @staticmethod
    def jvp(ctx, x_t, _mesh_t):
        return ctx.mesh.all_reduce(x_t.contiguous().clone())

    @staticmethod
    def backward(ctx, g):
        return g, None


def reduce_sum(mesh, x):
    """The sum over the ranks of each rank's partial ``x``, the same on
    every rank (one ``all_reduce``): differentiable, each partial's
    cotangent being the replicated result's, and under ``torch.func.jvp``
    the tangent is summed by the same collective (one more).  Every call
    goes through the autograd Function: a collective called on a tensor
    of a ``torch.func`` transform would sum its primal alone."""
    if mesh is None:
        return x
    return _ReduceSum.apply(x, mesh)


# -- the launcher --------------------------------------------------------------


# what a forkserver imports once, so that CPU ranks start without
# importing torch and the port anew
_CPU_PRELOAD = ["torch", "torch.distributed", "glimslib_tpu_torch.examples",
                "glimslib_tpu_torch.optimize.adjoint"]


def _rank_main(rank, world, backend, device, store, timeout_s, threads, fn, args,
               results, environ=None):
    if environ is not None:
        # a forked rank starts from its server's environment and settings:
        # take the caller's, and read the settings again from them
        os.environ.clear()
        os.environ.update(environ)
        importlib.reload(config)
    torch.set_num_threads(threads)
    dev = torch.device(device)
    if dev.type == "cuda":
        # cuBLAS's deterministic workspace (use_sharding turns on
        # deterministic algorithms on the card), set before its first call
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        dev = torch.device("cuda", rank if backend == "nccl" else dev.index or 0)
        torch.cuda.set_device(dev)
    try:
        dist.init_process_group(
            backend, init_method=f"file://{store}", rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=timeout_s))
        try:
            out = fn(make_device_mesh(device=dev), *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:  # noqa: BLE001 - the parent re-raises it
        results.put((rank, False, traceback.format_exc()))


def run_ranks(fn, world: int, backend: str, device="cpu", args=(),
              timeout: float = 900.0):
    """Run ``fn(mesh, *args)`` on ``world`` spawned processes joined into
    one process group, and return what it returned on each rank, by rank
    (picklable values: numpy arrays, numbers).

    ``backend``: ``"nccl"`` (one card a rank: rank r takes ``cuda:r``) or
    ``"gloo"`` (the CPU, or ranks sharing ``device``).  The ranks share
    the host's cores: each runs torch on the caller's
    ``torch.get_num_threads()`` over ``world`` threads (at least one).
    The kernels are built here, before the ranks start, where ``device``
    is a card.  A rank's exception is raised here with its traceback; a
    collective that waits longer than ``timeout`` seconds raises in its
    rank, and the ranks are stopped after ``timeout`` seconds in all.
    CPU ranks fork from a server process that imports torch and the port
    once (each rank takes the caller's environment as it is at the call);
    ranks on a card are spawned."""
    import multiprocessing as mp

    dev = torch.device(device)
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r}: use 'nccl' or 'gloo'")
    if backend == "nccl" and (dev.type != "cuda" or torch.cuda.device_count() < world):
        raise ValueError(f"nccl takes one card a rank: {world} ranks on {dev}, "
                         f"{torch.cuda.device_count()} cards")
    if dev.type == "cuda":
        config.resolve_device(dev)
        from glimslib_tpu_torch import _build

        _build.build_all()
    if dev.type == "cpu":
        # forked from a server that imported torch and the port once in
        # this process's life; a card's ranks are spawned
        ctx = mp.get_context("forkserver")
        ctx.set_forkserver_preload(_CPU_PRELOAD)
        environ = dict(os.environ)
    else:
        ctx, environ = mp.get_context("spawn"), None
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="glims_ranks_") as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(
            target=_rank_main,
            args=(r, world, backend, str(dev), store, timeout,
                  max(1, torch.get_num_threads() // world), fn, tuple(args), results,
                  environ))
            for r in range(world)]
        for p in procs:
            p.start()
        got, deadline = {}, timeout
        try:
            while len(got) < world and deadline > 0:
                try:
                    rank, ok, out = results.get(timeout=1.0)
                    got[rank] = (ok, out)
                    if not ok:
                        # the others wait on a collective that never comes
                        deadline = min(deadline, 10.0)
                    continue
                except queue.Empty:
                    deadline -= 1.0
                if any(r not in got and p.exitcode is not None
                       for r, p in enumerate(procs)):
                    # a rank died without a result: collect the others'
                    deadline = min(deadline, 10.0)
            for p in procs:
                p.join(timeout=30)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
                    p.join()
    failed = {r: out for r, (ok, out) in got.items() if not ok}
    if failed:
        raise RuntimeError("run_ranks: " + "\n".join(
            f"rank {r} failed:\n{tb}" for r, tb in sorted(failed.items())))
    if len(got) < world:
        raise RuntimeError("run_ranks: ranks " + ", ".join(
            f"{r} (exit code {p.exitcode})" for r, p in enumerate(procs) if r not in got)
            + " gave no result (gloo aborts a rank whose collectives do not match "
            "the others')")
    return [got[r][1] for r in range(world)]


# -- mode 'cells': the element kernels on a rank's block of cells --------------


def local_coefficient(mesh, value, cell_ids, n_cells):
    """A replicated coefficient as the input of a rank's cells: a tensor
    enters (:func:`enter`) and a per-cell one, (nc, ...), is gathered at
    the rank's ``cell_ids``; a Python number stays as it is."""
    if not torch.is_tensor(value):
        return value
    value = enter(mesh, value)
    if value.dim() >= 1 and value.shape[0] == n_cells:
        return value.index_select(0, cell_ids)
    return value


def local_mesh(mesh, cell_ids, cells=None, n_nodes=None):
    """The mesh of ``mesh``'s cells ``cell_ids`` (their node ids
    ``cells``, default the mesh's, on ``n_nodes`` nodes, default the
    mesh's), for the P1 kernels of one rank."""
    return types.SimpleNamespace(
        dim=mesh.dim, n_nodes=mesh.n_nodes if n_nodes is None else n_nodes,
        n_cells=len(cell_ids),
        cells=np.asarray(mesh.cells)[cell_ids] if cells is None else cells,
        cell_volumes=np.asarray(mesh.cell_volumes)[cell_ids],
        cell_grads=np.asarray(mesh.cell_grads)[cell_ids], lattice_strides=None)


class ShardedP1Kernels:
    """The P1 kernels of ``mode="cells"`` on this rank's block of cells
    (module docstring): node vectors in and out are replicated, and every
    member that accumulates onto the nodes ends in one ``all_reduce``.
    ``part``: a :class:`~glimslib_tpu_torch.parallel.partition.CellPartition`
    to reuse (:meth:`like`), else ``partition_cells(mesh, world)``."""

    def __init__(self, mesh, device_mesh, dtype=torch.float64, device=None, part=None):
        from glimslib_tpu_torch.ops.assembly import P1Kernels
        from glimslib_tpu_torch.parallel.partition import partition_cells

        self.mesh, self.device_mesh = mesh, device_mesh
        self.device = device_mesh.device if device is None else torch.device(device)
        self.dtype = dtype
        self.dim, self.n_nodes, self.n_cells = mesh.dim, mesh.n_nodes, mesh.n_cells
        self.npe = mesh.dim + 1
        self.part = partition_cells(mesh, device_mesh.world) if part is None else part
        p = device_mesh.rank
        # the block's real cells (the reference's zero-volume pad slots add
        # exact zeros)
        ids = self.part.cell_perm[p][self.part.pad_mask[p] > 0]
        self.block_cells = ids
        self._k = P1Kernels(local_mesh(mesh, ids), dtype=dtype, device=self.device)
        self._ids = torch.as_tensor(np.asarray(ids, np.int64), device=self.device)
        self._m0, self._t0 = self._k._m0, self._k._t0

    def like(self, dtype):
        """The same kernels at ``dtype`` over the same partition."""
        return ShardedP1Kernels(self.mesh, self.device_mesh, dtype=dtype,
                                device=self.device, part=self.part)

    def _co(self, value):
        return local_coefficient(self.device_mesh, value, self._ids, self.n_cells)

    def _node(self, x):
        return enter(self.device_mesh, x)

    def _sum(self, partial):
        return reduce_sum(self.device_mesh, partial)

    def rd_residual(self, c, c_prev, D, rho, dt, source=0.0, conc_max=1.0, facet=None):
        """``facet``: this rank's partial of a facet term (its von Neumann
        facets), added before the one sum over the ranks."""
        co = self._co
        r = self._k.rd_residual(self._node(c), self._node(c_prev), co(D), co(rho), co(dt),
                                source=co(source), conc_max=conc_max)
        return self._sum(r if facet is None else r + facet)

    def elasticity_residual(self, u, c, mu, lam, coupling, body_force=None, facet=None):
        """``facet`` as in :meth:`rd_residual` (its tractions)."""
        co = self._co
        r = self._k.elasticity_residual(
            self._node(u), self._node(c), co(mu), co(lam), co(coupling),
            body_force=None if body_force is None else co(body_force))
        return self._sum(r if facet is None else r + facet)

    def rd_mass_stiffness_diag(self, D, rho, dt):
        return self._sum(self._k.rd_mass_stiffness_diag(self._co(D), rho, self._co(dt)))

    def elasticity_diag(self, mu, lam):
        return self._sum(self._k.elasticity_diag(self._co(mu), self._co(lam)))

    def mass_residual(self, c):
        return self._sum(self._k.mass_residual(self._node(c)))

    def mass_vector_residual(self, u):
        return self._sum(self._k.mass_vector_residual(self._node(u)))

    def integrate_p1(self, c):
        """∫ c dx (a 0-d tensor), the same on every rank."""
        k = self._k
        return self._sum(torch.sum(k.cell_integral(self._node(c))))
