"""The coupled model, solved plainly in float64:

    F_rd = (c - c_prev) v + dt D grad c . grad v - dt rho c (1 - c) v     (dx)
    F_el = sigma(u) : eps(v) - k (2 mu + 3 lam) c div v                  (dx)

with implicit Euler, per-cell (per-tissue) D, rho, mu, lam, the
displacement clamped on the whole boundary and no flux of c.  Each step
solves the concentration by Newton (each linear system by Jacobi-CG),
then the displacement by block-Jacobi CG with c known.  The
concentration is P1 or P2; the displacement P1.  Every integral is taken
by a Grundmann-Moeller rule exact for its integrand: degree 3 for P1
(c^2 v is cubic), degree 7 for P2 (c^2 v is of degree 6).

The model is set by a configuration dict (``configs/*.json``): the box,
the tissue radii that label its vertices, and each tissue's E, nu and
which of D, rho it carries.  A cell's tissue is the integer part of the
mean of its vertices' labels, as upstream's label function at the cell
midpoint (helper_classes.py:441-443).
"""

from __future__ import annotations

import numpy as np
import torch

from .fem import Pattern, cg, scatter, vector_csr
from .mesh import EDGES, KuhnBox
from .quadrature import grundmann_moeller

F64 = torch.float64
# relative residual each reference CG solves to, the Newton stopping rule
# (the last update under this share of max |c|) and its iteration cap
CG_RTOL = 1e-12
NEWTON_DC = 1e-11
NEWTON_MAXITER = 25
# cells assembled at once for the elasticity blocks (bounds the memory)
CHUNK = 1 << 18


def _p2_tables(lam):
    """P2 basis values (nq, 10) and their derivatives by the barycentric
    coordinates (nq, 10, 4) at barycentric points ``lam`` (nq, 4)."""
    nq = lam.shape[0]
    vals = np.zeros((nq, 10))
    dvals = np.zeros((nq, 10, 4))
    for i in range(4):
        vals[:, i] = lam[:, i] * (2 * lam[:, i] - 1)
        dvals[:, i, i] = 4 * lam[:, i] - 1
    for e, (a, b) in enumerate(EDGES):
        vals[:, 4 + e] = 4 * lam[:, a] * lam[:, b]
        dvals[:, 4 + e, a] = 4 * lam[:, b]
        dvals[:, 4 + e, b] = 4 * lam[:, a]
    return vals, dvals


def tissue_labels(points, cfg):
    """Nodal tissue labels of ``points`` (m, 3) from the configuration's
    concentric spheres: label ``k`` inside radius ``r_k`` (as a share of
    the half box), the innermost sphere winning."""
    lab = cfg["labels"]
    centre = torch.tensor(lab["centre"], dtype=F64, device=points.device)
    r = torch.linalg.vector_norm((points - centre) / lab["half_width"], dim=1)
    out = torch.zeros(points.shape[0], dtype=torch.int64, device=points.device)
    for k, radius in lab["radii"]:
        out = torch.where(r < radius, torch.full_like(out, k), out)
    return out


class Reference:
    """The model of configuration ``cfg`` on the reference's own mesh."""

    def __init__(self, cfg, device="cpu"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.p2 = cfg["concentration_degree"] == 2
        self.mesh = m = KuhnBox(cfg["voxels_per_side"], cfg["box_length"], p2=self.p2,
                                device=self.device)
        labels = tissue_labels(m.points, cfg)
        self.cell_tissue = labels[m.cells].to(F64).mean(1).to(torch.int64)
        # concentration space
        if self.p2:
            lam, w = grundmann_moeller(3, 7)
            phi, dphi = _p2_tables(lam)
            self.cdofs, self.nc_dofs = m.cell_dofs2, m.n_dofs2
            self.c_keys = m.dof_keys
        else:
            lam, w = grundmann_moeller(3, 3)
            phi, dphi = lam, np.broadcast_to(np.eye(4), (len(w), 4, 4))
            self.cdofs, self.nc_dofs = m.cells, m.n_nodes
            self.c_keys = m.cell_vertex_keys
        t = dict(dtype=F64, device=self.device)
        self.w = torch.tensor(w, **t)
        self.phi = torch.tensor(phi, **t)  # (nq, mc)
        mc = self.phi.shape[1]
        self.phiphi = (self.phi[:, :, None] * self.phi[:, None, :]).reshape(-1, mc * mc)
        mass_hat = torch.einsum("q,qi,qj->ij", self.w, self.phi, self.phi)
        # stiffness: grad phi_i . grad phi_j = sum_kl dphi_i/dlam_k dphi_j/dlam_l G_kl
        dphi_t = torch.tensor(np.ascontiguousarray(dphi), **t)  # (nq, mc, 4)
        S = torch.einsum("q,qik,qjl->ijkl", self.w, dphi_t, dphi_t).reshape(mc * mc, 16)
        G = torch.einsum("cka,cla->ckl", m.grads, m.grads).reshape(-1, 16)
        self.cpat = Pattern(self.cdofs, self.nc_dofs)
        vol = m.vol
        self.M = self.cpat.values(vol[:, None, None] * mass_hat)
        # per-tissue stiffness and mass of the tissues that carry D and rho
        self.K_t, self.M_t = {}, {}
        for name in cfg["growth_tissues"]:
            sel = (self.cell_tissue == cfg["tissues"][name]["id"]).to(F64) * vol
            self.K_t[name] = self.cpat.values((sel[:, None] * (G @ S.T)).reshape(-1, mc, mc))
            self.M_t[name] = self.cpat.values(sel[:, None, None] * mass_hat)
        growth_ids = [cfg["tissues"][n]["id"] for n in cfg["growth_tissues"]]
        act = torch.isin(self.cell_tissue, torch.tensor(growth_ids, device=self.device))
        self.act = torch.nonzero(act).reshape(-1)
        self._elasticity()

    # -- parameters ----------------------------------------------------------
    def _value(self, v, params=None):
        """A configuration value: a number, or the name of a parameter."""
        if isinstance(v, str):
            return float((params or self.cfg["parameters"])[v])
        return float(v)

    def _per_cell(self, values):
        """Per-cell values from a {tissue id: value} table."""
        lut = torch.zeros(int(self.cell_tissue.max()) + 1, dtype=F64, device=self.device)
        for k, v in values.items():
            if k < lut.shape[0]:
                lut[k] = float(v)
        return lut[self.cell_tissue]

    def growth(self, params):
        """(D, rho) per tissue name from the model parameters."""
        names = self.cfg["growth_parameters"]
        return ({n: float(params[names[n]["D"]]) for n in self.cfg["growth_tissues"]},
                {n: float(params[names[n]["rho"]]) for n in self.cfg["growth_tissues"]})

    # -- elasticity (parameters fixed by the configuration) -------------------
    def _elasticity(self):
        m, cfg = self.mesh, self.cfg
        E = self._per_cell({t["id"]: self._value(t["E"]) for t in cfg["tissues"].values()})
        nu = self._per_cell({t["id"]: self._value(t["nu"]) for t in cfg["tissues"].values()})
        mu = E / (2 * (1 + nu))
        lam = E * nu / ((1 + nu) * (1 - 2 * nu))
        self.coupling_fac = cfg["parameters"]["coupling"] * (2 * mu + 3 * lam) * m.vol
        pat = Pattern(m.cells, m.n_nodes) if self.p2 else self.cpat
        self.upat = pat
        blocks = torch.zeros(pat.nnz, 3, 3, dtype=F64, device=self.device)
        eye = torch.eye(3, dtype=F64, device=self.device)
        for s in range(0, m.n_cells, CHUNK):
            g = m.grads[s:s + CHUNK]
            v = m.vol[s:s + CHUNK]
            gg = torch.einsum("cia,cja->cij", g, g)
            loc = (mu[s:s + CHUNK, None, None, None, None]
                   * (torch.einsum("cja,cib->cijab", g, g)
                      + gg[:, :, :, None, None] * eye)
                   + lam[s:s + CHUNK, None, None, None, None]
                   * torch.einsum("cia,cjb->cijab", g, g)) * v[:, None, None, None, None]
            slot = pat.slot.reshape(m.n_cells, 16)[s:s + CHUNK].reshape(-1)
            blocks.index_add_(0, slot, loc.reshape(-1, 3, 3))
        fixed = m.boundary_vertex
        keep = (~fixed[pat.rows] & ~fixed[pat.cols]).to(F64)
        blocks *= keep[:, None, None]
        fixed_diag = pat.diag_slot[fixed[pat.rows[pat.diag_slot]]]
        blocks[fixed_diag] = eye
        self.u_free = (~fixed).to(F64)[:, None].expand(-1, 3).reshape(-1)
        self.Ku = vector_csr(pat, blocks)
        diag = blocks[pat.diag_slot]  # (n, 3, 3), in node order
        self.Ku_binv = torch.linalg.inv(diag)
        self.M1 = pat.values(m.vol[:, None, None] * (torch.ones(4, 4, dtype=F64,
                                                               device=self.device)
                                                    + torch.eye(4, dtype=F64,
                                                                device=self.device)) / 20)

    def _load(self, c):
        """The elasticity's right side (3 n,) at concentration ``c``: the
        coupling's load on the free vertices, 0 on the clamped ones."""
        m = self.mesh
        cq = c[self.cdofs] @ self.phi.T  # (nc, nq)
        cint = cq @ self.w  # mean of c over each cell
        loc = (self.coupling_fac * cint)[:, None, None] * m.grads  # (nc, 4, 3)
        return scatter(m.cells, loc, m.n_nodes).reshape(-1) * self.u_free

    def solve_u(self, c):
        """The displacement (n, 3) at concentration ``c`` (this mesh's dof
        order), solved from 0."""
        return self._solve_u(c.to(F64), torch.zeros(self.mesh.n_nodes, 3, dtype=F64,
                                                    device=self.device))

    def _solve_u(self, c, u0):
        f = self._load(c)
        binv = self.Ku_binv

        def precond(r):
            return torch.einsum("nab,nb->na", binv, r.view(-1, 3)).reshape(-1)

        u, _, _ = cg(lambda x: self.Ku @ x, f, u0.reshape(-1), precond, CG_RTOL, 20000)
        return u.view(-1, 3)

    # -- reaction-diffusion --------------------------------------------------
    def _nonlinear(self, c, rho_cell):
        """(N(c) = int rho c^2 v, element matrices of int rho c phi_i phi_j)
        over the cells that carry rho."""
        a = self.act
        dofs = self.cdofs[a]
        cq = c[dofs] @ self.phi.T  # (na, nq)
        wr = (self.mesh.vol[a] * rho_cell[a])[:, None] * self.w
        n_loc = (wr * cq * cq) @ self.phi
        w_loc = (wr * cq) @ self.phiphi
        return scatter(dofs, n_loc, self.nc_dofs), w_loc

    def _solve_c(self, c_prev, L, rho_cell, dt):
        pat = self.cpat
        b = pat.csr(self.M) @ c_prev
        Lcsr = pat.csr(L)
        act_slot = pat.slot.reshape(self.mesh.n_cells, -1)[self.act].reshape(-1)
        c = c_prev.clone()
        for _ in range(NEWTON_MAXITER):
            N, w_loc = self._nonlinear(c, rho_cell)
            R = Lcsr @ c + dt * N - b
            Jv = L.clone().index_add_(0, act_slot, 2 * dt * w_loc.reshape(-1))
            Jcsr, diag = pat.csr(Jv), Jv[pat.diag_slot]
            dc, _, _ = cg(lambda x: Jcsr @ x, -R, torch.zeros_like(c),
                          lambda r: r / diag, CG_RTOL, 20000)
            c = c + dc
            if float(dc.abs().max()) <= NEWTON_DC * max(float(c.abs().max()), 1e-300):
                return c
        raise RuntimeError("reference Newton did not converge")

    def simulate(self, params, c0, n_steps, dt):
        """(u_T (n_nodes, 3), c_T (n_c,)) after ``n_steps`` implicit-Euler
        steps of ``dt`` from u = 0 and ``c0`` (this mesh's dof order), at
        the model parameters ``params`` (upstream's names)."""
        D, rho = self.growth(params)
        ids = {n: self.cfg["tissues"][n]["id"] for n in self.cfg["growth_tissues"]}
        rho_cell = self._per_cell({ids[n]: rho[n] for n in ids})
        L = self.M.clone()
        for n in ids:
            L += dt * float(D[n]) * self.K_t[n] - dt * float(rho[n]) * self.M_t[n]
        c = c0.to(F64)
        u = torch.zeros(self.mesh.n_nodes, 3, dtype=F64, device=self.device)
        for _ in range(n_steps):
            c = self._solve_c(c, L, rho_cell, dt)
            u = self._solve_u(c, u)
        return u, c

    def mass_norm2(self, f, vector=False):
        """int f^2 dx: ``f`` on the concentration dofs, or (``vector``) on
        the vertices (n, 3)."""
        if vector:
            M1 = self.upat.csr(self.M1)
            return sum(float(torch.dot(f[:, a], M1 @ f[:, a])) for a in range(3))
        return float(torch.dot(f, self.cpat.csr(self.M) @ f))
