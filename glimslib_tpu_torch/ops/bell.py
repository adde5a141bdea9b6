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
``ops/p2_ell.py``).  The reference's chunk-aligned halo (``halo_chunk``
G, the P2 plan's ``GLIMS_P2_HALO_CHUNK``) and its memory-bounded scalar
assembly (:func:`assemble_scalar_chunked`, selected by
:func:`assemble_maybe_chunked` under ``GLIMS_ASSEMBLE_CHUNK_SLOTS``) are
here with the reference's tables and values; the port's defaults leave
both off, where the reference's turn them on for limits of the TPU (its
row-rate-bound gathers; its compiler's memory planner) that the card
does not have: on the card the chunked halo adds zero slots (1.85x the
table bytes of the P2 flagship plan at G = 4) and the one-shot P2
placement peaks at 7.5 GB of the card's 80.  Left out are the
aux-threaded table dicts (``tables()``) and the block-lanes kernel
layouts (``*_T``, ``transpose_tables_T``): the port's plans hold their
tables, and it has one kernel layout.  The plan's index tables live on
its device as int64 tensors; every sentinel points at a zero row
appended at gather time.

Block sharding (``Simulation.use_sharding(mode="bell")``, the
reference's ``shard_ctx`` and ``_bmv`` under ``shard_map``): a
:class:`SlabPlan` is rank r's view of a plan, blocks [b0, b1) with
b0 = r nb / world.  Tables assembled through it hold those blocks only
(its own part of the block-major placement), the halo operand is
gathered for them only, and every contraction below runs the ``bmv``
hook on the slab and gathers the slabs' rows into the replicated result
(``parallel/shard.py gather_rows``).  The per-entry values and node
vectors stay replicated; a replicated vector that enters a slab's
contraction sums its cotangent over the ranks (``parallel/shard.py
enter``).  On a whole :class:`BellPlan` the same functions run as
before: b0 = 0, no crossing.
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch

from glimslib_tpu_torch.ops.assembly import (
    ScatterPlan, make_scatter_plan, pull_accumulate, pull_index,
)
from glimslib_tpu_torch.ops.bell_kernels import batched_matvec
from glimslib_tpu_torch.parallel import shard


class BellPlan:
    """Host-precomputed supernode halo structure over one dof space; the
    numpy arrays are those of the reference's plan at the same ``s`` and
    ``halo_chunk``, and their int64 tensor copies (``*_idx``, the pulls'
    :class:`PullIndex`) live on ``device``.

    ``halo_chunk`` G > 1 is the reference's chunk-aligned halo: a block's
    external slots are whole aligned chunks of G consecutive dofs
    (``khe_rows`` chunks, ``Khe = G khe_rows`` slots, those of dofs the
    block does not couple to zero), gathered as rows of the dof vector
    reshaped (chunks, G).

    Pass a ``mesh`` (P1: the dofs are the mesh nodes) or an explicit dof
    connectivity ``conn`` (nc, npe) over ``n`` dofs (the P2 space of
    ``ops/p2_ell.py``, npe = 10 in 3D and 6 in 2D).  ``prefix`` names the
    plan's tables in the reference's aux dicts (``_Bell``, ``_P2B``).

    The whole plan is the slab of one rank: blocks [b0, b1) = [0, nb)."""

    b0 = 0
    mesh = None

    def __init__(self, mesh=None, s: int = 32, device="cpu", conn=None, n=None,
                 prefix: str = "_Bell", halo_chunk: int = 1):
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
        self.halo_chunk = G = max(int(halo_chunk), 1)
        nb_real = (n + s - 1) // s
        # the reference's block-count rounding (to 128 when that wastes
        # <= 6.25%, else to 8), kept so plans are identical; padded blocks
        # have sentinel halos and zero operator rows
        nb128 = -(-nb_real // 128) * 128
        nb = nb128 if nb128 <= 1.0625 * nb_real else -(-nb_real // 8) * 8
        self.nb = nb
        self.n_pad = nb * s

        # unique node-adjacency pairs: the (row, col) keys of the entries in
        # (i, j, cell) order, sorted stably (an entry's pair is the run of
        # equal keys it falls in, its entries in entry order)
        ct = cells.T
        key = (ct[:, None, :] * n + ct[None, :, :]).ravel()
        order = np.argsort(key, kind="stable")
        skey = key[order]
        first = np.empty(len(skey), dtype=bool)
        first[:1] = True
        np.not_equal(skey[1:], skey[:-1], out=first[1:])
        uniq = skey[first]
        pair_sorted = np.cumsum(first) - 1
        del key, skey, first
        ur = (uniq // n).astype(np.int64)
        uc = (uniq % n).astype(np.int64)

        # own-first halo per supernode: slots [s, s + Khe) are the sorted
        # external neighbours, or with G > 1 the sorted aligned G-dof chunks
        # holding them, slot s + G (chunk position) + c % G.  Built for all
        # blocks at once: the unique (block, neighbour or chunk) keys sort
        # by block, then by neighbour, as the reference's per-block unique
        br = ur // s
        ext = uc // s != br
        eb, ec = br[ext], uc[ext]
        ev = ec if G == 1 else ec // G
        # the sentinel: the zero row appended to the (n,) or (chunks, G) source
        sentinel = n if G == 1 else -(-n // G)
        width = sentinel + 1
        ekey = eb * width + ev
        ukey, ext_of = np.unique(ekey, return_inverse=True)
        ub, uv = ukey // width, ukey % width
        bstart = np.searchsorted(ub, np.arange(nb + 1))
        # gathered rows a block: dofs, or chunks of G dofs
        self.khe_rows = khe_rows = int(np.diff(bstart).max()) if nb else 0
        self.Khe = Khe = khe_rows * G
        self.Kh = Kh = s + Khe
        ext_ids = np.full((nb, max(khe_rows, 1)), sentinel, dtype=np.int32)
        ext_ids[ub, np.arange(len(ukey)) - bstart[ub]] = uv
        self.ext_ids = ext_ids[:, :khe_rows]

        # kh slot of each unique pair's column: own -> local index,
        # external -> s + its place in the block's sorted external halo
        kh_u = uc - br * s
        pos = ext_of - bstart[eb]
        kh_u[ext] = s + pos if G == 1 else s + pos * G + ec % G
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
        self.off_plan = _off_pair_plan(order, pair_sorted, off_rank, npe, nc, self.n_off)
        # placement: dense slot -> [off-pairs | diag nodes | zero sentinel];
        # each pair has one slot, so an entry of the placement's source is
        # pulled by one slot (an unused node's diagonal by none: -1)
        place = np.full(nb * s * Kh, self.n_off + n, dtype=np.int64)
        place[dense_slot[~isdiag_u]] = off_rank[off_u]
        place[dense_slot[isdiag_u]] = self.n_off + ur[isdiag_u]
        self.place = place.astype(np.int32)
        self.entry_slot = np.full(self.n_off + n, -1, dtype=np.int64)
        self.entry_slot[:self.n_off] = dense_slot[off_u]
        self.entry_slot[self.n_off + ur[isdiag_u]] = dense_slot[isdiag_u]

        self.device = torch.device(device)
        idx = lambda a: torch.as_tensor(  # noqa: E731
            np.asarray(a, dtype=np.int64), device=self.device)
        self.ext_idx = idx(self.ext_ids)
        self.diag_idx = pull_index(self.diag_plan, self.device)
        self.off_idx = pull_index(self.off_plan, self.device)
        self.off_entry_t = idx(self.off_entry_idx)
        self.nb_total = self.b1 = nb

    @property
    def halo_ids(self):
        """The (nb, Kh) dof id of every halo slot (sentinel n for padding),
        the chunk-aligned halo expanded to its dofs: a diagnostic view;
        the applies gather :attr:`ext_ids` only."""
        blocks = self.b0 + np.arange(self.nb)  # a slab's blocks of the plan
        own = blocks[:, None] * self.s + np.arange(self.s)[None, :]
        own = np.where(own < self.n, own, self.n).astype(np.int32)
        ext = self.ext_ids
        if self.halo_chunk > 1:
            G = self.halo_chunk
            ext = (ext[:, :, None].astype(np.int64) * G
                   + np.arange(G)[None, None, :]).reshape(self.nb, -1)
            ext = np.where(ext < self.n, ext, self.n).astype(np.int32)
        return np.concatenate([own, ext], axis=1)

    @functools.cached_property
    def place_pull(self):
        """The placement as a pull of one entry a slot (its slots, int64
        on the device: the plan's largest index), built at first use: a
        model that shards the plan pulls through its slab's.  Its push
        table is each entry's one slot in this plan's (or slab's) range,
        else the sentinel."""
        lo, n_slots = self.b0 * self.s * self.Kh, len(self.place)
        local = self.entry_slot - lo
        push = np.where((local >= 0) & (local < n_slots), local, n_slots)
        return pull_index(ScatterPlan(
            pull_table=self.place.astype(np.int64)[:, None], push_table=push[:, None],
            n_entries=self.n_off + self.n, n_segments=n_slots), self.device)

    @property
    def place_idx(self):
        return self.place_pull.pull[:, 0]

    def enter(self, x):
        """A replicated vector as the input of this plan's contractions."""
        return shard.enter(self.mesh, x)

    def gather(self, y):
        """(nb_total, M) replicated rows from this plan's (nb, M) rows."""
        if self.mesh is None:
            return y
        return shard.gather_rows(self.mesh, y, self.b0, self.nb_total)

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


class SlabPlan(BellPlan):
    """Rank ``mesh.rank``'s slab of ``plan``: blocks [b0, b1) of its nb,
    nb / world of them (the reference raises where world does not divide
    nb, as here).  ``nb`` is the slab's block count, ``nb_total`` the
    plan's; the halo rows and the placement (its pull built at first use,
    as the plan's) are the slab's part, the per-entry pulls (O(n)) the
    plan's.  Belongs to the model that shards,
    never to the plan (which the models of a mesh share)."""

    def __init__(self, plan: BellPlan, mesh):
        if plan.nb % mesh.world:
            raise ValueError(f"supernode block count {plan.nb} not divisible by "
                             f"{mesh.world} ranks")
        nbl = plan.nb // mesh.world
        self.base, self.mesh = plan, mesh
        self.b0, self.b1 = mesh.rank * nbl, (mesh.rank + 1) * nbl
        self.nb, self.nb_total = nbl, plan.nb
        for k in ("prefix", "n", "npe", "s", "n_pad", "halo_chunk", "khe_rows", "Khe",
                  "Kh", "n_off", "device", "diag_plan", "off_plan", "off_entry_idx",
                  "diag_idx", "off_idx", "off_entry_t", "entry_slot"):
            setattr(self, k, getattr(plan, k))
        self.ext_ids = plan.ext_ids[self.b0:self.b1]
        self.ext_idx = plan.ext_idx[self.b0:self.b1].clone()
        slots = self.s * self.Kh
        self.place = plan.place[self.b0 * slots:self.b1 * slots]


def _off_pair_plan(order, pair_sorted, off_rank, npe, nc, n_off):
    """``make_scatter_plan`` of the off-diagonal entries (numbered in the
    (i, j != i, cell) order of ``off_entry_idx``) onto their pairs' ranks,
    from the entries' stable sort by pair (``order``, their pairs
    ``pair_sorted``): each pair's entries in entry order, as
    ``make_scatter_plan``'s stable sort gives them."""
    ij = order // nc
    off = ij % (npe + 1) != 0  # i != j: the diagonal slots are ij = i (npe + 1)
    ij = ij[off]
    ent = (ij - (ij + npe) // (npe + 1)) * nc + order[off] % nc
    seg = off_rank[pair_sorted[off]]
    counts = np.bincount(seg, minlength=n_off)
    starts = np.cumsum(counts) - counts
    n_ent = len(ent)
    table = np.full((n_off, max(int(counts.max()) if n_off else 0, 1)), n_ent,
                    dtype=np.int32)
    table[seg, np.arange(n_ent) - starts[seg]] = ent
    index_map = np.empty(n_ent, dtype=np.int64)
    index_map[ent] = seg
    return ScatterPlan(pull_table=table, push_table=index_map[:, None], n_entries=n_ent,
                       n_segments=n_off)


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


def _gather_sum_chunked(table, x, rows_per_chunk):
    """:func:`~glimslib_tpu_torch.ops.assembly.pull_accumulate`'s sum of
    x (entries,) over a (rows, K) pull table, ``rows_per_chunk`` rows at
    a time."""
    rows, K = table.shape
    padded = torch.cat([x, x.new_zeros(1)])
    out = []
    for a in range(0, rows, rows_per_chunk):
        t = table[a:a + rows_per_chunk]
        got = padded.index_select(0, t.reshape(-1))
        out.append(got if K == 1 else got.reshape(t.shape[0], K).sum(dim=1))
    return torch.cat(out)


def assemble_scalar_chunked(plan: BellPlan, ent, rows_per_chunk: int = None):
    """``plan.assemble`` of a scalar entry tensor (npe, npe, nc), bit-equal
    to it, with every gather of the class-split pulls and of the placement
    taken ``rows_per_chunk`` slots (default 2^19) at a time, as the
    reference's memory-bounded assembly (``ops/bell.py:390-446``) does
    under ``lax.map``.  Differentiable through torch's own VJP of the
    gathers."""
    rc = int(rows_per_chunk or (1 << 19))
    npe = plan.npe
    flat = ent.reshape(npe * npe, -1)
    k = torch.arange(npe, device=flat.device)
    diag_flat = flat.reshape(npe, npe, -1)[k, k].reshape(-1)
    off_flat = flat.index_select(0, plan.off_entry_t).reshape(-1)
    dpull, opull = plan.diag_idx.pull, plan.off_idx.pull
    diag_vals = _gather_sum_chunked(dpull, diag_flat, max(1, rc // dpull.shape[1]))
    off_vals = _gather_sum_chunked(opull, off_flat, max(1, rc // opull.shape[1]))
    vals = _gather_sum_chunked(plan.place_pull.pull, torch.cat([off_vals, diag_vals]), rc)
    return vals.reshape(plan.nb, plan.s, plan.Kh)


def assemble_maybe_chunked(plan: BellPlan, ent):
    """A scalar plane's assembly: :func:`assemble_scalar_chunked` where
    ``GLIMS_ASSEMBLE_CHUNK_SLOTS`` is set and the plan has more dense slots
    than it says (the reference's selector, ``ops/bell.py:449-466``, whose
    default is 32,000,000), else ``plan.assemble``.  Unset, the port never
    chunks: the reference's default answers the TPU compiler's memory
    planner, and on the card the one-shot P2 placement pull of the quad
    flagship peaks at 7.5 GB of 80 (``PERF.md``), where 98.3M slots would
    take the chunked path in every Newton iteration's ``build_p2_rd_wc``
    (~190 gather launches)."""
    thresh = os.environ.get("GLIMS_ASSEMBLE_CHUNK_SLOTS")
    if (thresh is not None and ent.dim() == 3
            and plan.nb * plan.s * plan.Kh > int(thresh)):
        return assemble_scalar_chunked(plan, ent)
    return plan.assemble(ent)


def build_bell_elasticity(plan: BellPlan, mesh_arrays, mu, lam):
    """(nb, s, d, Kh, d) elasticity operator values."""
    W = plan.assemble(elasticity_entries(mesh_arrays, mu, lam))
    return W.permute(0, 1, 3, 2, 4).contiguous()


def build_bell_rd_const(plan: BellPlan, mesh_arrays, D, rho, dt, m0):
    """(nb, s, Kh) values of M + dt D K - dt rho M."""
    return plan.assemble(rd_const_entries(mesh_arrays, D, rho, dt, m0))


def build_bell_mass(plan: BellPlan, mesh_arrays, m0):
    """(nb, s, Kh) values of the P1 mass matrix M_ij = m0 (1 + δij) vol a
    cell: the c_prev operand of the streamed rd residual
    R = W_const c + quad(c) - M c_prev - load (the model's ``_BellMrd``)."""
    return plan.assemble(mass_entries(mesh_arrays, m0))


def build_bell_coupling_uc(plan: BellPlan, mesh_arrays, mu, lam, coupling):
    """(nb, s, d, Kh) values of the growth-coupling operator C, scalar
    concentration -> vector force, of the streamed elasticity residual
    R = A u + C c - load (the model's ``_BellCuc``)."""
    W = plan.assemble(coupling_uc_entries(mesh_arrays, mu, lam, coupling))
    return W.permute(0, 1, 3, 2).contiguous()  # (nb, s, Kh, d) -> (nb, s, d, Kh)


def _cell_values(cells_flat, c, npe):
    return c[cells_flat].reshape(npe, -1)  # (npe, nc)


def rd_wc_entries(mesh_arrays, cells_flat, c, rho, dt, t0, conc_max):
    """(npe, npe, nc) entries of the logistic Jacobian correction
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
    return (2.0 * dt / conc_max) * rho * W


def build_bell_rd_wc(plan: BellPlan, mesh_arrays, cells_flat, c, rho, dt, t0,
                     conc_max):
    """(nb, s, Kh) values of :func:`rd_wc_entries`."""
    return plan.assemble(rd_wc_entries(mesh_arrays, cells_flat, c, rho, dt, t0,
                                       conc_max))


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


def _own_rows(plan: BellPlan, flat, width):
    """(nb, width) rows [b0, b1) of the flat vector zero-padded to
    nb_total * width."""
    lo, hi = plan.b0 * width, plan.b1 * width
    own = flat[lo:min(hi, flat.shape[0])]
    if own.shape[0] < hi - lo:
        own = torch.cat([own, own.new_zeros(hi - lo - own.shape[0])])
    return own.reshape(plan.nb, width)


def _gather_source(plan: BellPlan, x):
    """x (n, ...) as the rows the external slots gather: the dofs, or
    (G > 1) the aligned G-dof chunks, with the sentinel's zero row
    appended."""
    n, tail = x.shape[0], tuple(x.shape[1:])
    G = plan.halo_chunk
    rows = n + 1 if G == 1 else -(-n // G) + 1
    xp = torch.cat([x, x.new_zeros((rows * G - n,) + tail)])
    return xp if G == 1 else xp.reshape((rows, -1))


def _halo_vector(plan: BellPlan, x):
    """(nb, Kh*d) halo operand of x (n, d): own slots by reshape, external
    slots by one gather of dof (or chunk) rows."""
    n, d = x.shape
    x = plan.enter(x)
    xo = _own_rows(plan, x.reshape(-1), plan.s * d)
    xe = _gather_source(plan, x).index_select(0, plan.ext_idx.reshape(-1))
    return torch.cat([xo, xe.reshape(plan.nb, -1)], dim=1)


def _halo_scalar(plan: BellPlan, x):
    """(nb, Kh) halo operand of x (n,)."""
    x = plan.enter(x)
    xo = _own_rows(plan, x, plan.s)
    xe = _gather_source(plan, x).index_select(0, plan.ext_idx.reshape(-1))
    return torch.cat([xo, xe.reshape(plan.nb, plan.Khe)], dim=1)


def apply_bell_vector(plan: BellPlan, W, x, bmv=batched_matvec):
    """(A x)[i, a]; W (nb, s, d, Kh, d) contiguous, x (n, d)."""
    n, d = x.shape
    nb, s, Kh = plan.nb, plan.s, plan.Kh
    y = plan.gather(bmv(W.reshape(nb, s * d, Kh * d), _halo_vector(plan, x)))
    return y.reshape(-1, d)[:n]


def apply_bell_scalar(plan: BellPlan, W, x, bmv=batched_matvec):
    """Scalar halo-ELL matvec; W (nb, s, Kh), x (n,)."""
    n = x.shape[0]
    y = plan.gather(bmv(W, _halo_scalar(plan, x)))
    return y.reshape(-1)[:n]


def apply_bell_coupling(plan: BellPlan, Wc, c, bmv=batched_matvec):
    """(n,) concentration -> (n, d) coupling force; Wc (nb, s, d, Kh)."""
    n = c.shape[0]
    nb, s, d, Kh = Wc.shape
    y = plan.gather(bmv(Wc.reshape(nb, s * d, Kh), _halo_scalar(plan, c)))
    return y.reshape(-1, d)[:n]


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
    """Invert the per-supernode self-blocks ``B`` (nb, m, m) of the plan's
    blocks; masked dofs (``mask`` (n, d) or (n,) bool) and padded tail
    dofs get identity."""
    nb, m = B.shape[0], B.shape[1]
    n_dof = plan.n * (m // plan.s)
    fm = torch.ones(plan.nb_total * m, dtype=torch.bool, device=B.device)
    fm[:n_dof] = False if mask is None else mask.reshape(-1)
    fm = fm[plan.b0 * m:plan.b1 * m].reshape(nb, m).to(B.dtype)
    keep = 1.0 - fm
    B = B * keep[:, :, None] * keep[:, None, :]
    B = B + torch.eye(m, dtype=B.dtype, device=B.device)[None] * fm[:, :, None]
    # row-major for the batched-matvec kernel (the batched inverse may
    # come back with column-major strides)
    return torch.linalg.inv(B).contiguous()


def apply_supernode_jacobi(plan: BellPlan, Binv, r, bmv=batched_matvec):
    """r (n, d) or (n,) -> per-supernode dense solve with Binv (nb, m, m)."""
    m = Binv.shape[1]
    flat = plan.enter(r).reshape(-1)
    z = plan.gather(bmv(Binv, _own_rows(plan, flat, m)))
    return z.reshape(-1)[: flat.shape[0]].reshape(r.shape)
