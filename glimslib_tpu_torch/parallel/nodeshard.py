"""Node sharding of unstructured meshes on ``torch.distributed``
(counterpart of ``glimslib_tpu/parallel/nodeshard.py``): owned rows, a
ghost buffer and a static exchange.

- the nodes are split into ``n / world`` contiguous rows a rank (use a
  Morton-ordered mesh, ``core/mesh.py reordered_morton``, so that the
  ranges are compact and the exchanged surface small; pad with
  ``core.mesh.pad_mesh_nodes`` where the world does not divide them);
- each rank holds the cells that touch one of its rows (overlap
  assembly: a cell on a rank boundary lies on every rank owning one of
  its nodes), so it computes every contribution to its own rows, and
  drops those to rows a neighbour owns;
- the exchange is static: each rank publishes the owned rows that other
  ranks reference (``pub_idx``), one collective moves them, and each rank
  places its ghost rows (``ghost_src``).  The port's collective is an
  ``all_reduce`` of a zero ``(world * P, w)`` buffer in which each rank
  fills its own slab (exact: adding zeros is exact), where the reference
  has an ``all_gather``; there is none at world 1.

:class:`NodeShardSpec` is a numpy copy of the reference's tables, equal
to them.  :class:`NodeShardedP1Kernels` evaluates the element math of
``ops/assembly.py P1Kernels`` on the rank's local mesh (its owned rows,
then its ghosts), so an owned row sums the same contributions in the
same order as the unsharded kernels.

Differentiation.  The exchange is an autograd Function: its JVP is the
same exchange of the tangent (``torch.func.jvp`` of a residual on the
matrix-free lane), and its VJP the transposed exchange, in which each
rank writes the cotangents of its ghost rows into the slabs of their
owners, one ``all_reduce`` sums them, and each owner adds its slab into
the cotangents of its published rows.  A replicated coefficient enters
the rank's cells through ``shard.enter`` (its cotangent, each rank's
part, summed over the ranks once), and ``integrate_p1`` leaves through
``shard.reduce_sum``.
"""

from __future__ import annotations

import numpy as np
import torch

from glimslib_tpu_torch.ops.assembly import P1Kernels, make_scatter_plan_dropping
from glimslib_tpu_torch.parallel.shard import local_coefficient, local_mesh, reduce_sum


class NodeShardSpec:
    """Host-precomputed owned/ghost partition of one unstructured mesh
    (numpy copy of the reference's class; every table equal to its).

    All per-rank tables are stacked on a leading ``ndev`` axis and padded
    to common sizes: ``pub_idx`` (ndev, P), ``ghost_src`` (ndev, G),
    ``cells_xb`` (ndev, npe, Cl), ``cell_ids`` (ndev, Cl), ``grads_l``
    (ndev, npe, d, Cl), ``vol_l`` and ``cell_own`` (ndev, Cl) and
    ``res_pull`` (ndev, nnl, Kr); ``local_cells`` and ``ghosts`` hold each
    rank's real cells and ghost nodes."""

    def __init__(self, mesh, n_devices: int):
        n = mesh.n_nodes
        ndev = int(n_devices)
        if n % ndev:
            raise ValueError(
                f"n_nodes={n} not divisible by {ndev} devices; pad with "
                "core.mesh.pad_mesh_nodes first"
            )
        self.n = n
        self.ndev = ndev
        self.nnl = nnl = n // ndev
        cells = np.asarray(mesh.cells, dtype=np.int64)
        nc, npe = cells.shape
        self.nc, self.npe = nc, npe

        owner = cells // nnl  # (nc, npe) owning device of each cell node
        grads = np.moveaxis(np.asarray(mesh.cell_grads), 0, -1)  # (npe,d,nc)
        vol = np.asarray(mesh.cell_volumes)
        d = mesh.dim
        self.dim = d

        local_cells = [
            np.where((owner == p).any(axis=1))[0] for p in range(ndev)
        ]
        Cl = max(len(lc) for lc in local_cells)
        self.Cl = Cl
        ghosts = []
        for p in range(ndev):
            nd = np.unique(cells[local_cells[p]])
            ghosts.append(nd[(nd < p * nnl) | (nd >= (p + 1) * nnl)])
        G = max((len(g) for g in ghosts), default=1)
        G = max(G, 1)
        self.G = G

        # publish slabs: owned values referenced by any other device
        pubs = []
        for q in range(ndev):
            need = [g[(g >= q * nnl) & (g < (q + 1) * nnl)] for g in ghosts]
            pubs.append(np.unique(np.concatenate(need + [np.array([], np.int64)])))
        Pmax = max(max((len(pb) for pb in pubs), default=1), 1)
        self.P = Pmax
        pub_idx = np.full((ndev, Pmax), nnl, dtype=np.int32)  # sentinel
        for q, pb in enumerate(pubs):
            pub_idx[q, : len(pb)] = pb - q * nnl
        # ghost buffer assembly: position of each ghost in the gathered
        # (ndev * P) slab stack; sentinel points at the zero pad row
        ghost_src = np.full((ndev, G), ndev * Pmax, dtype=np.int32)
        for p, g in enumerate(ghosts):
            if len(g):
                q = g // nnl
                pos = np.array(
                    [np.searchsorted(pubs[qq], jj) for qq, jj in zip(q, g)],
                    dtype=np.int64,
                )
                ghost_src[p, : len(g)] = q * Pmax + pos

        # local cell tables: node -> xb index (own | nnl+ghost | zero pad)
        cells_xb = np.full((ndev, npe, Cl), nnl + G, dtype=np.int32)
        cell_ids = np.full((ndev, Cl), nc, dtype=np.int32)
        grads_l = np.zeros((ndev, npe, d, Cl))
        vol_l = np.zeros((ndev, Cl))
        cell_own = np.zeros((ndev, Cl))
        res_tables = []
        for p in range(ndev):
            lc = local_cells[p]
            cell_ids[p, : len(lc)] = lc
            grads_l[p, :, :, : len(lc)] = grads[:, :, lc]
            vol_l[p, : len(lc)] = vol[lc]
            # integration ownership: the device owning the MIN node of a
            # cell integrates it (every other copy weights it zero)
            cell_own[p, : len(lc)] = (cells[lc].min(axis=1) // nnl) == p
            cn = cells[lc]  # (cl, npe) global node ids
            xb = np.where(
                (cn >= p * nnl) & (cn < (p + 1) * nnl),
                cn - p * nnl,
                nnl + np.searchsorted(ghosts[p], np.clip(cn, 0, n)),
            )
            cells_xb[p, :, : len(lc)] = xb.T
            # owned-row accumulation plan over the (npe, Cl) entry order;
            # ghost-row entries (xb >= nnl) are dropped (overlap assembly)
            emap = np.full((npe, Cl), nnl + G, dtype=np.int64)
            emap[:, : len(lc)] = xb.T
            res_tables.append(make_scatter_plan_dropping(emap.ravel(), nnl))
        Kr = max(t.shape[1] for t in res_tables)
        n_entries = npe * Cl
        res_pull = np.full((ndev, nnl, Kr), n_entries, dtype=np.int32)
        for p, t in enumerate(res_tables):
            res_pull[p, :, : t.shape[1]] = t
        self.pub_idx = pub_idx
        self.ghost_src = ghost_src
        self.cells_xb = cells_xb
        self.cell_ids = cell_ids
        self.grads_l = grads_l
        self.vol_l = vol_l
        self.cell_own = cell_own
        self.res_pull = res_pull
        self.local_cells = local_cells
        self.ghosts = ghosts
        self.n_pub = [len(pb) for pb in pubs]


class _Plan:
    """One rank's exchange: its published rows (``pub``, real entries
    only), the places of its ghosts in the (world * P) slab stack
    (``src``), the slab's offset, and the buffer's row counts."""

    def __init__(self, spec, rank, device):
        idx = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=device)  # noqa: E731
        self.world, self.P, self.nnl = spec.ndev, spec.P, spec.nnl
        self.n_buf = spec.nnl + spec.G + 1
        self.n_ghost = len(spec.ghosts[rank])
        self.pub = idx(spec.pub_idx[rank, :spec.n_pub[rank]])
        self.src = idx(spec.ghost_src[rank, :self.n_ghost])
        self.slab = (rank * spec.P, rank * spec.P + spec.n_pub[rank])


def _exchange(mesh, plan, x_own):
    """(nnl, w) owned rows -> (nnl + G + 1, w) local buffer: the owned
    rows, the ghosts, zeros (the unused ghost slots and the pad row)."""
    w = x_own.shape[1]
    xb = x_own.new_zeros((plan.n_buf, w))
    xb[:plan.nnl] = x_own
    if plan.world > 1:
        buf = x_own.new_zeros((plan.world * plan.P, w))
        buf[plan.slab[0]:plan.slab[1]] = x_own.index_select(0, plan.pub)
        mesh.all_reduce(buf)
        xb[plan.nnl:plan.nnl + plan.n_ghost] = buf.index_select(0, plan.src)
    return xb


def _exchange_T(mesh, plan, g_buf):
    """The transposed exchange: cotangents of the local buffer's rows ->
    those of the owned rows, each ghost's added to its owner's row."""
    g = g_buf[:plan.nnl].clone()
    if plan.world > 1:
        buf = g_buf.new_zeros((plan.world * plan.P, g_buf.shape[1]))
        # a rank's ghosts take distinct slab rows: a plain indexed copy
        buf[plan.src] = g_buf[plan.nnl:plan.nnl + plan.n_ghost]
        mesh.all_reduce(buf)
        g.index_add_(0, plan.pub, buf[plan.slab[0]:plan.slab[1]])
    return g


class _Exchange(torch.autograd.Function):
    @staticmethod
    def forward(x_own, mesh, plan):
        return _exchange(mesh, plan, x_own)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, ctx.mesh, ctx.plan = inputs

    @staticmethod
    def jvp(ctx, x_t, _mesh_t, _plan_t):
        return _exchange(ctx.mesh, ctx.plan, x_t)

    @staticmethod
    def backward(ctx, g):
        return _exchange_T(ctx.mesh, ctx.plan, g.contiguous()), None, None


def exchange(mesh, plan, x_own):
    """The local buffer of owned rows ``x_own`` (nnl, w): one collective
    (none at world 1), and one more for a tangent or a cotangent.  Every
    rank calls it at once."""
    return _Exchange.apply(x_own, mesh, plan)


class NodeShardedP1Kernels:
    """The P1 kernels over owned/ghost node-sharded vectors (module
    docstring): node vectors in and out hold this rank's ``n_own`` rows,
    ``start`` to ``start + n_own`` of ``n_total``; per-cell coefficients
    are replicated (nc,) and the kernels take their local cells' values.
    ``spec``: a :class:`NodeShardSpec` to reuse (:meth:`like`)."""

    def __init__(self, mesh, device_mesh, dtype=torch.float64, device=None, spec=None):
        self.mesh, self.device_mesh = mesh, device_mesh
        self.device = device_mesh.device if device is None else torch.device(device)
        self.dtype = dtype
        self.dim, self.n_cells = mesh.dim, mesh.n_cells
        self.npe = mesh.dim + 1
        self.spec = spec = NodeShardSpec(mesh, device_mesh.world) if spec is None else spec
        p = self.rank = device_mesh.rank
        self.n_total, self.n_own = spec.n, spec.nnl
        self.n_nodes = spec.n
        self.start = p * spec.nnl
        lc = spec.local_cells[p]
        cells = np.ascontiguousarray(spec.cells_xb[p, :, :len(lc)].T)
        # owned rows, then the ghost buffer: the accumulation keeps the owned ones
        self._k = P1Kernels(local_mesh(mesh, lc, cells=cells, n_nodes=spec.nnl + spec.G + 1),
                            dtype=dtype, device=self.device, rows=(0, spec.nnl))
        self._ids = torch.as_tensor(lc, dtype=torch.int64, device=self.device)
        self._cell_own = torch.as_tensor(spec.cell_own[p, :len(lc)], dtype=dtype,
                                         device=self.device)
        self._plan = _Plan(spec, p, self.device)
        self._m0, self._t0 = self._k._m0, self._k._t0

    def like(self, dtype):
        """The same kernels at ``dtype`` over the same tables."""
        return NodeShardedP1Kernels(self.mesh, self.device_mesh, dtype=dtype,
                                    device=self.device, spec=self.spec)

    def own(self, x):
        """This rank's rows of a whole node array (node axis first)."""
        return x[self.start:self.start + self.n_own]

    def _co(self, value):
        return local_coefficient(self.device_mesh, value, self._ids, self.n_cells)

    def _xb(self, *xs):
        """The local buffers of owned node vectors, (nnl,) or (nnl, k), in
        one exchange."""
        cols = [x[:, None] if x.dim() == 1 else x for x in xs]
        xb = exchange(self.device_mesh, self._plan, torch.cat(cols, dim=1))
        out, j = [], 0
        for x, c in zip(xs, cols):
            k = c.shape[1]
            out.append(xb[:, j] if x.dim() == 1 else xb[:, j:j + k])
            j += k
        return out

    # -- the method surface of P1Kernels ---------------------------------------

    def rd_residual(self, c, c_prev, D, rho, dt, source=0.0, conc_max=1.0):
        co = self._co
        cb, cpb = self._xb(c, c_prev)
        return self._k.rd_residual(cb, cpb, co(D), co(rho), co(dt), source=co(source),
                                   conc_max=conc_max)

    def elasticity_residual(self, u, c, mu, lam, coupling, body_force=None):
        co = self._co
        ub, cb = self._xb(u, c)
        return self._k.elasticity_residual(
            ub, cb, co(mu), co(lam), co(coupling),
            body_force=None if body_force is None else co(body_force))

    def rd_mass_stiffness_diag(self, D, rho, dt):
        return self._k.rd_mass_stiffness_diag(self._co(D), rho, self._co(dt))

    def elasticity_diag(self, mu, lam):
        return self._k.elasticity_diag(self._co(mu), self._co(lam))

    def elasticity_diag_blocks(self, mu, lam):
        """Per-node (d, d) diagonal blocks of the owned rows (the
        block-Jacobi preconditioner of the matrix-free lane)."""
        return self._k.elasticity_diag_blocks(self._co(mu), self._co(lam))

    def block_jacobi_inverse_blocks(self, B, mask=None):
        """Row by row: no exchange."""
        return self._k.block_jacobi_inverse_blocks(B, mask=mask)

    apply_block_jacobi = staticmethod(P1Kernels.apply_block_jacobi)

    def mass_residual(self, c):
        return self._k.mass_residual(self._xb(c)[0])

    def mass_vector_residual(self, u):
        return self._k.mass_vector_residual(self._xb(u)[0])

    def lumped_mass(self):
        return self._k.lumped_mass()

    def integrate_p1(self, c):
        """∫ c dx (a 0-d tensor), the same on every rank: a cell on a rank
        boundary counts on the rank owning its smallest node only."""
        cb = self._xb(c)[0]
        part = torch.sum(self._cell_own * self._k.cell_integral(cb))
        return reduce_sum(self.device_mesh, part)
