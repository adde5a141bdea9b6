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

The lattice's node sharding (``mode="nodes"``) is ``parallel/gspmd.py``.
Not ported: ``ShardedP1Kernels`` (``mode="cells"``), the unstructured
node sharding (``parallel/nodeshard.py``, ``mode="nodes"`` on a mesh
without a lattice) and the partitioner they share
(``parallel/partition.py``): both swap the model's element kernels and
run the solves on the matrix-free jvp lane, which the port does not
have.  ``use_sharding`` raises for them.
"""

from __future__ import annotations

import datetime
import os
import queue
import tempfile
import traceback
from typing import NamedTuple

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
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce(g.contiguous().clone()), None


def enter(mesh, x):
    """A replicated tensor ``x`` as the input of rank-local work: itself;
    its cotangent, each rank's part, is summed over the ranks once."""
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
    def forward(ctx, x, mesh):
        return mesh.all_reduce(x.contiguous().clone())

    @staticmethod
    def backward(ctx, g):
        return g, None


def reduce_sum(mesh, x):
    """The sum over the ranks of each rank's partial ``x``, the same on
    every rank (one ``all_reduce``): differentiable, each partial's
    cotangent being the replicated result's."""
    if mesh is None:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _ReduceSum.apply(x, mesh)
    return mesh.all_reduce(x.contiguous().clone())


# -- the launcher --------------------------------------------------------------


def _rank_main(rank, world, backend, device, store, timeout_s, threads, fn, args,
               results):
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
    rank, and the ranks are stopped after ``timeout`` seconds in all."""
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
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="glims_ranks_") as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(
            target=_rank_main,
            args=(r, world, backend, str(dev), store, timeout,
                  max(1, torch.get_num_threads() // world), fn, tuple(args), results))
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
