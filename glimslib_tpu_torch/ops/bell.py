"""Supernode halo-ELL operators for unstructured meshes (counterpart of
``glimslib_tpu/ops/bell.py``, canonical layout).

Nodes are grouped into contiguous supernodes of ``s`` in mesh order (use a
Morton-ordered mesh, ``core/mesh.py reordered_morton``, so supernodes are
compact blobs).  Each supernode stores its operator rows against its
halo, OWN-FIRST: slots [0, s) are its own nodes (taken from x by a
reshape), slots [s, s + Khe) its sorted external neighbours (the only
gathered part).  A matvec is then one halo gather and a batched dense
contraction

    y[b, i] = sum_h W[b, i, h] xh[b, h]

through ``ops/bell_kernels.py batched_matvec`` (the CUDA kernel
``bell_bmv`` on the card).  Non-adjacent pairs store explicit zeros.

Assembly is split by entry class: diagonal entries accumulate per node,
off-diagonal entries per unique node pair, and one placement gather
spreads [off-pairs | diag | 0] into the dense halo layout.

Also the matching supernode block-Jacobi: the (s d x s d) self-block of
each supernode, inverted once.

The plan serves any dof space (P1 nodes, or the P2 dofs of
``ops/p2_ell.py``).  What the TPU build needed and the port leaves out:
the aux-threaded table dicts (``tables()``), chunk-aligned halos
(``halo_chunk``: aligned G-dof gather rows for the TPU's row-rate-bound
gathers; on the card they only add zero slots, 1.85x the table bytes of
the P2 flagship plan), block sharding (``shard_ctx``), the block-lanes
kernel layouts (``*_T``, ``transpose_tables_T``) and the memory-bounded
chunked scalar assembly (a TPU compile-memory bound).  The plan's index
tables live on its device as int64 tensors; every sentinel points at a
zero row appended at gather time.
"""

from __future__ import annotations

import numpy as np
import torch

from glimslib_tpu_torch.ops.assembly import (
    make_scatter_plan, pull_accumulate, pull_index, scatter_plan_from_pull,
)
from glimslib_tpu_torch.ops.bell_kernels import batched_matvec


class BellPlan:
    """Host-precomputed supernode halo structure over one dof space; the
    numpy arrays are those of the reference's plan (at ``halo_chunk`` 1),
    and their int64 tensor copies (``*_idx``, the pulls'
    :class:`PullIndex`) live on ``device``.

    Pass a ``mesh`` (P1: the dofs are the mesh nodes) or an explicit dof
    connectivity ``conn`` (nc, npe) over ``n`` dofs (the P2 space of
    ``ops/p2_ell.py``, npe = 10 in 3D and 6 in 2D).  ``prefix`` names the
    plan's tables in the reference's aux dicts (``_Bell``, ``_P2B``)."""

    def __init__(self, mesh=None, s: int = 32, device="cpu", conn=None, n=None,
                 prefix: str = "_Bell"):
        if mesh is not None:
            cells = np.asarray(mesh.cells, dtype=np.int64)
            n = mesh.n_nodes
        else:
            cells = np.asarray(conn, dtype=np.int64)
        self.prefix = prefix
        nc, npe = cells.shape
        self.n = n
        self.npe = npe
        self.s = s = int(s)
        nb_real = (n + s - 1) // s
        # the reference's block-count rounding (to 128 when that wastes
        # <= 6.25%, else to 8), kept so plans are identical; padded blocks
        # have sentinel halos and zero operator rows
        nb128 = -(-nb_real // 128) * 128
        nb = nb128 if nb128 <= 1.0625 * nb_real else -(-nb_real // 8) * 8
        self.nb = nb
        self.n_pad = nb * s

        # unique node-adjacency pairs, in (i, j, cell) entry order
        rows = np.repeat(cells.T, npe, axis=0).reshape(npe, npe, nc)
        cols = np.tile(cells.T, (npe, 1)).reshape(npe, npe, nc)
        rflat = rows.ravel()
        cflat = cols.ravel()
        uniq = np.unique(rflat * n + cflat)
        ur = (uniq // n).astype(np.int64)
        uc = (uniq % n).astype(np.int64)

        # own-first halo per supernode: slots [s, s + Khe) are the sorted
        # external neighbours (uniq is row-major sorted, so block ids are
        # nondecreasing)
        br = ur // s
        bounds = np.searchsorted(br, np.arange(nb + 1))
        exts = []
        for b in range(nb):
            h = np.unique(uc[bounds[b]:bounds[b + 1]])
            exts.append(h[(h < b * s) | (h >= (b + 1) * s)])
        Khe = max((len(e) for e in exts), default=0)
        self.Khe = Khe
        self.Kh = Kh = s + Khe
        ext_ids = np.full((nb, max(Khe, 1)), n, dtype=np.int32)
        for b, e in enumerate(exts):
            ext_ids[b, : len(e)] = e
        self.ext_ids = ext_ids[:, :Khe]

        # kh slot of each unique pair's column: own -> local index,
        # external -> s + position in the block's sorted external halo
        kh_u = np.empty(len(uniq), dtype=np.int64)
        for b in range(nb):
            sl = slice(bounds[b], bounds[b + 1])
            c = uc[sl]
            own = (c >= b * s) & (c < (b + 1) * s)
            kh_u[sl] = np.where(own, c - b * s, s + np.searchsorted(exts[b], c))
        dense_slot = ur * Kh + kh_u  # (b*s + i_loc) * Kh + kh

        # class-split assembly plans: diagonal entries per node,
        # off-diagonal entries per unique pair
        self.diag_plan = make_scatter_plan(cells.T.ravel(), n)
        ii, jj = np.meshgrid(np.arange(npe), np.arange(npe), indexing="ij")
        self.off_entry_idx = np.where((ii != jj).ravel())[0]
        isdiag_u = ur == uc
        off_u = np.where(~isdiag_u)[0]
        self.n_off = len(off_u)
        off_rank = np.full(len(uniq), -1, dtype=np.int64)
        off_rank[off_u] = np.arange(self.n_off)
        e_rows = rflat.reshape(npe, npe, nc)[ii != jj].ravel()
        e_cols = cflat.reshape(npe, npe, nc)[ii != jj].ravel()
        e_pair = np.searchsorted(uniq, e_rows * n + e_cols)
        self.off_plan = make_scatter_plan(off_rank[e_pair], self.n_off)
        # placement: dense slot -> [off-pairs | diag nodes | zero sentinel]
        place = np.full(nb * s * Kh, self.n_off + n, dtype=np.int64)
        place[dense_slot[~isdiag_u]] = off_rank[off_u]
        place[dense_slot[isdiag_u]] = self.n_off + ur[isdiag_u]
        self.place = place.astype(np.int32)
        # the placement as a pull of one entry a slot
        self.place_plan = scatter_plan_from_pull(place[:, None], self.n_off + n)

        self.device = torch.device(device)
        idx = lambda a: torch.as_tensor(  # noqa: E731
            np.asarray(a, dtype=np.int64), device=self.device)
        self.ext_idx = idx(self.ext_ids)
        self.diag_idx = pull_index(self.diag_plan, self.device)
        self.off_idx = pull_index(self.off_plan, self.device)
        self.place_pull = pull_index(self.place_plan, self.device)
        self.place_idx = self.place_pull.pull[:, 0]
        self.off_entry_t = idx(self.off_entry_idx)

    def assemble(self, entry_values):
        """(npe, npe, nc, ...) per-entry values -> (nb, s, Kh, ...)."""
        npe = self.npe
        tail = tuple(entry_values.shape[3:])
        flat = entry_values.reshape((npe * npe, -1) + tail)
        k = torch.arange(npe, device=flat.device)
        diag_flat = flat.reshape((npe, npe) + tuple(flat.shape[1:]))[k, k]
        diag_flat = diag_flat.reshape((-1,) + tail)
        off_flat = flat.index_select(0, self.off_entry_t).reshape((-1,) + tail)
        diag_vals = pull_accumulate(self.diag_idx, diag_flat)
        off_vals = pull_accumulate(self.off_idx, off_flat)
        vals = pull_accumulate(self.place_pull, torch.cat([off_vals, diag_vals]))
        return vals.reshape((self.nb, self.s, self.Kh) + tail)


def _t(x, like):
    return torch.as_tensor(x, dtype=like.dtype, device=like.device)


def elasticity_entries(mesh_arrays, mu, lam):
    """(npe, npe, nc, d, d) per-entry elasticity stiffness values:
    vol (mu (g_j[a] g_i[b] + δab g_i·g_j) + lam g_j[b] g_i[a])."""
    g, vol = mesh_arrays  # (npe, d, nc), (nc,)
    d = g.shape[1]
    mu, lam = _t(mu, vol), _t(lam, vol)
    gg = (g[:, None, :, :] * g[None, :, :, :]).sum(dim=2)  # (i, j, nc)
    eye = torch.eye(d, dtype=vol.dtype, device=vol.device)
    term1 = g[None, :, :, None, :] * g[:, None, None, :, :]
    term2 = gg[:, :, None, None, :] * eye[None, None, :, :, None]
    term3 = g[None, :, None, :, :] * g[:, None, :, None, :]
    ent = vol * (mu * (term1 + term2) + lam * term3)  # (i, j, a, b, nc)
    return torch.movedim(ent, -1, 2)  # (i, j, nc, a, b)


def coupling_uc_entries(mesh_arrays, mu, lam, coupling):
    """(npe, npe, nc, d) growth-coupling values:
    -coupling (2 mu + d lam) (vol/(d+1)) g[i, a], independent of j."""
    g, vol = mesh_arrays
    npe, d = g.shape[0], g.shape[1]
    mu, lam, coupling = _t(mu, vol), _t(lam, vol), _t(coupling, vol)
    kfac = coupling * (2.0 * mu + d * lam) * vol / (d + 1.0)  # (nc,)
    ent = (-kfac * g)[:, None].expand(npe, npe, d, g.shape[2])
    return torch.movedim(ent, -1, 2)  # (i, j, nc, a)


def rd_const_entries(mesh_arrays, D, rho, dt, m0):
    """(npe, npe, nc) entries of M + dt D K - dt rho M."""
    g, vol = mesh_arrays
    npe = g.shape[0]
    D, rho = _t(D, vol), _t(rho, vol)
    gg = (g[:, None, :, :] * g[None, :, :, :]).sum(dim=2)
    eye = torch.eye(npe, dtype=vol.dtype, device=vol.device)[:, :, None]
    M = m0 * (1.0 + eye) * vol
    return M + (dt * D) * (vol * gg) - (dt * rho) * M


def mass_entries(mesh_arrays, m0):
    """(npe, npe, nc) P1 mass entries m0 (1 + δij) vol."""
    g, vol = mesh_arrays
    npe = g.shape[0]
    eye = torch.eye(npe, dtype=vol.dtype, device=vol.device)[:, :, None]
    return (m0 * (1.0 + eye)) * vol


def assemble_fused(plan: BellPlan, ents):
    """Assemble several planes through one class-split pull and one
    placement gather of concatenated tails.  ``ents``: list of
    (npe, npe, nc) + tail entry tensors; returns the (nb, s, Kh) + tail
    planes in order (contiguous)."""
    shapes = [tuple(e.shape[3:]) for e in ents]
    widths = [int(np.prod(t)) if t else 1 for t in shapes]
    flat = [e.reshape(tuple(e.shape[:3]) + (w,)) for e, w in zip(ents, widths)]
    W = plan.assemble(torch.cat(flat, dim=3))  # (nb, s, Kh, sum(widths))
    outs, o = [], 0
    for t, w in zip(shapes, widths):
        outs.append(W[..., o:o + w].reshape(tuple(W.shape[:3]) + t).contiguous())
        o += w
    return outs


def build_bell_elasticity(plan: BellPlan, mesh_arrays, mu, lam):
    """(nb, s, d, Kh, d) elasticity operator values."""
    W = plan.assemble(elasticity_entries(mesh_arrays, mu, lam))
    return W.permute(0, 1, 3, 2, 4).contiguous()


def build_bell_rd_const(plan: BellPlan, mesh_arrays, D, rho, dt, m0):
    """(nb, s, Kh) values of M + dt D K - dt rho M."""
    return plan.assemble(rd_const_entries(mesh_arrays, D, rho, dt, m0))


def _cell_values(cells_flat, c, npe):
    return c[cells_flat].reshape(npe, -1)  # (npe, nc)


def build_bell_rd_wc(plan: BellPlan, mesh_arrays, cells_flat, c, rho, dt, t0,
                     conc_max):
    """(nb, s, Kh) values of the logistic Jacobian correction
    +2 dt rho W(c)/c_max, W(c)_ij = vol t0 (S + c_i + c_j + δij (S + 2 c_i))."""
    g, vol = mesh_arrays
    npe = g.shape[0]
    rho = _t(rho, vol)
    ce = _cell_values(cells_flat, c, npe)
    S = ce.sum(dim=0)
    eye = torch.eye(npe, dtype=vol.dtype, device=vol.device)[:, :, None]
    W = (vol * t0) * (
        S + ce[:, None, :] + ce[None, :, :] + eye * (S + 2.0 * ce[:, None, :])
    )
    return plan.assemble((2.0 * dt / conc_max) * rho * W)


def build_bell_rd_wc_lumped(plan: BellPlan, mesh_arrays, cells_flat, c, rho,
                            dt, t0, conc_max):
    """(n,) row sums of :func:`build_bell_rd_wc` (the chord operator's
    lumped logistic diagonal): per (node, cell) vol t0 (npe+2)(S + c_i),
    accumulated through the per-node diagonal plan."""
    g, vol = mesh_arrays
    npe = g.shape[0]
    rho = _t(rho, vol)
    ce = _cell_values(cells_flat, c, npe)
    S = ce.sum(dim=0)
    contrib = (2.0 * dt / conc_max) * rho * (vol * t0) * (npe + 2.0) * (S + ce)
    return pull_accumulate(plan.diag_idx, contrib.reshape(-1))


def _halo_vector(plan: BellPlan, x):
    """(nb, Kh*d) halo operand of x (n, d): own slots by reshape, external
    slots by one gather (sentinel n -> the appended zero row)."""
    n, d = x.shape
    xo = torch.cat([x, x.new_zeros((plan.n_pad - n, d))]).reshape(plan.nb, -1)
    xp = torch.cat([x, x.new_zeros((1, d))])
    xe = xp.index_select(0, plan.ext_idx.reshape(-1)).reshape(plan.nb, -1)
    return torch.cat([xo, xe], dim=1)


def _halo_scalar(plan: BellPlan, x):
    """(nb, Kh) halo operand of x (n,)."""
    n = x.shape[0]
    xo = torch.cat([x, x.new_zeros(plan.n_pad - n)]).reshape(plan.nb, plan.s)
    xp = torch.cat([x, x.new_zeros(1)])
    xe = xp.index_select(0, plan.ext_idx.reshape(-1)).reshape(plan.nb, plan.Khe)
    return torch.cat([xo, xe], dim=1)


def apply_bell_vector(plan: BellPlan, W, x, bmv=batched_matvec):
    """(A x)[i, a]; W (nb, s, d, Kh, d) contiguous, x (n, d)."""
    n, d = x.shape
    nb, s, Kh = plan.nb, plan.s, plan.Kh
    y = bmv(W.reshape(nb, s * d, Kh * d), _halo_vector(plan, x))
    return y.reshape(nb * s, d)[:n]


def apply_bell_scalar(plan: BellPlan, W, x, bmv=batched_matvec):
    """Scalar halo-ELL matvec; W (nb, s, Kh), x (n,)."""
    n = x.shape[0]
    y = bmv(W, _halo_scalar(plan, x))
    return y.reshape(plan.nb * plan.s)[:n]


def apply_bell_coupling(plan: BellPlan, Wc, c, bmv=batched_matvec):
    """(n,) concentration -> (n, d) coupling force; Wc (nb, s, d, Kh)."""
    n = c.shape[0]
    nb, s, d, Kh = Wc.shape
    y = bmv(Wc.reshape(nb, s * d, Kh), _halo_scalar(plan, c))
    return y.reshape(nb * s, d)[:n]


# -- supernode block-Jacobi --------------------------------------------------


def extract_self_blocks_vector(plan: BellPlan, W):
    """(nb, s d, s d) self-block of each supernode from (nb, s, d, Kh, d):
    the own-first halo puts it in the first s slots."""
    nb, s, d = W.shape[0], W.shape[1], W.shape[2]
    Wf = W.reshape(nb, s * d, plan.Kh, d)
    return Wf[:, :, :s, :].reshape(nb, s * d, s * d)


def extract_self_blocks_scalar(plan: BellPlan, W):
    """(nb, s, s) self-block of each supernode from (nb, s, Kh)."""
    return W[:, :, : plan.s]


def supernode_jacobi_inverse(plan: BellPlan, B, mask=None):
    """Invert the per-supernode self-blocks ``B`` (nb, m, m); masked dofs
    (``mask`` (n, d) or (n,) bool) and padded tail dofs get identity."""
    nb, m = B.shape[0], B.shape[1]
    n_dof = plan.n * (m // plan.s)
    fm = torch.ones(nb * m, dtype=torch.bool, device=B.device)
    fm[:n_dof] = False if mask is None else mask.reshape(-1)
    fm = fm.reshape(nb, m).to(B.dtype)
    keep = 1.0 - fm
    B = B * keep[:, :, None] * keep[:, None, :]
    B = B + torch.eye(m, dtype=B.dtype, device=B.device)[None] * fm[:, :, None]
    # row-major for the batched-matvec kernel (the batched inverse may
    # come back with column-major strides)
    return torch.linalg.inv(B).contiguous()


def apply_supernode_jacobi(plan: BellPlan, Binv, r, bmv=batched_matvec):
    """r (n, d) or (n,) -> per-supernode dense solve with Binv (nb, m, m)."""
    nb, m = Binv.shape[0], Binv.shape[1]
    flat = r.reshape(-1)
    rp = torch.cat([flat, flat.new_zeros(nb * m - flat.shape[0])])
    z = bmv(Binv, rp.reshape(nb, m))
    return z.reshape(-1)[: flat.shape[0]].reshape(r.shape)
