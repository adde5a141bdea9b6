"""Frozen per-class factored assembly of the supernode halo-ELL planes
(counterpart of the P1 part of ``glimslib_tpu/ops/bell_factored.py``).

Every theta plane is linear in its per-cell coefficient with fixed
geometry, and the models' per-cell coefficients are constant within each
tissue class (label lookups), so

    W(theta) = P(c ⊙ g) = Σ_t coeff_t(theta) · P(1_t ⊙ g)

with P the plan's class-split pull and placement gather (``ops/bell.py``)
and 1_t the indicator of the cells of class t.  The placement gather runs
once per class channel when the model is set up (:func:`build_cache`,
frozen like the coarse factors), and each simulate reduces the channel
stacks with a handful of per-class scalars (:func:`planes_from_theta`).

Channels (T = the number of cell classes present):

- elasticity (2T): W = Σ_t mu_t G^mu_t + lam_t G^lam_t
- coupling (T): C = Σ_t coupling_t (2 mu_t + d lam_t) G^c_t
- rd constant (1 + |supp rho| + |supp D|): W = M − dt Σ rho_t M_t
  + dt Σ D_t K_t
- mass (1): theta-independent, channel 0 of the rd stack.

Exact while every per-cell coefficient is constant within each class,
which ``Simulation.theta_class_labels`` guarantees by returning labels.
The per-class scalars are read at one representative cell a class, so
autograd routes each class's cotangent through it to the same per-tissue
parameter gradients as the dense assembly.  The reduction is one
``tensordot`` of the scalars with the stacked channels (float32 products
stay full float32: ``config.py`` pins TF32 off), which autograd
differentiates in the scalars.

The quad models' P2 rd constant plane has channels of its own over the
P2 plan (:func:`build_p2_cache`, :func:`p2_planes_from_theta`): [M_full,
M_t (supp rho), K_t (supp D)], assembled one channel at a time (each is
one P2 plane, 393 MB at f32 on the n=32 brain box).
"""

from __future__ import annotations

import numpy as np
import torch

from glimslib_tpu_torch.ops import bell


def class_reps(labels):
    """(classes, reps): the sorted class labels and one representative
    cell index a class."""
    classes, reps = np.unique(np.asarray(labels), return_index=True)
    return classes, reps.astype(np.int64)


def _stiffness_entries(mesh_arrays, ind):
    """(npe, npe, nc) scalar stiffness entries ∫ ∇φi·∇φj masked to one
    class: (vol · ind) gg."""
    g, vol = mesh_arrays
    gg = (g[:, None, :, :] * g[None, :, :, :]).sum(dim=2)
    return (vol * ind) * gg


def _support_idx(classes, support, key):
    """Indices (into ``classes``) of the classes where the coefficient
    ``key`` can be nonzero: ``support`` maps a coefficient name to the
    set of class labels with structural support (the others are built as
    0 for any parameter values); a key it lacks keeps every class."""
    if not support or key not in support:
        return list(range(len(classes)))
    keep = support[key]
    return [i for i, c in enumerate(classes) if int(c) in keep]


def build_cache(plan, mesh_arrays, labels, m0, want_cuc, want_rd, want_mrd,
                support=None):
    """Frozen channel stacks of the theta planes, in the raw
    ``BellPlan.assemble`` layouts: ``_FReps`` (T,) representative cells,
    ``_FWel`` (2T, nb, s, Kh, d, d), ``_FCuc`` (T, nb, s, Kh, d),
    ``_FWrd`` (1 + |supp rho| + |supp D|, nb, s, Kh) (channel 0 the full
    mass plane) with ``_FWrdRhoReps`` / ``_FWrdDReps`` the matching
    representative cells, and ``_FMrd`` (channel 0).  One fused
    placement gather a family; built without a graph."""
    g, vol = mesh_arrays
    dev = vol.device
    labels = np.asarray(labels)
    classes, reps = class_reps(labels)
    T = len(classes)
    inds = torch.as_tensor(np.stack([labels == c for c in classes]).astype(np.float64),
                           dtype=vol.dtype, device=dev)  # (T, nc)
    idx = lambda a: torch.as_tensor(np.asarray(a, dtype=np.int64), device=dev)  # noqa: E731
    zero = torch.zeros((), dtype=vol.dtype, device=dev)
    out = {"_FReps": idx(reps)}
    with torch.no_grad():
        # mu channels, then lam channels (the order planes_from_theta reads)
        ents = [bell.elasticity_entries(mesh_arrays, inds[t], zero) for t in range(T)]
        ents += [bell.elasticity_entries(mesh_arrays, zero, inds[t]) for t in range(T)]
        out["_FWel"] = torch.stack(bell.assemble_fused(plan, ents))
        del ents
        if want_cuc:
            # mu = ind / 2, lam = 0, coupling = 1 makes the unit factor
            # ind vol / (d + 1) of bell.coupling_uc_entries
            one = torch.ones((), dtype=vol.dtype, device=dev)
            ents = [bell.coupling_uc_entries(mesh_arrays, 0.5 * inds[t], zero, one)
                    for t in range(T)]
            out["_FCuc"] = torch.stack(bell.assemble_fused(plan, ents))
            del ents
        if want_rd:
            rho_i = _support_idx(classes, support, "rho")
            d_i = _support_idx(classes, support, "D")
            M_full = bell.mass_entries(mesh_arrays, m0)
            ents = [M_full] + [M_full * inds[i] for i in rho_i]
            ents += [_stiffness_entries(mesh_arrays, inds[i]) for i in d_i]
            planes = torch.stack(bell.assemble_fused(plan, ents))
            del ents
            out["_FWrd"] = planes
            out["_FWrdRhoReps"] = idx(reps[rho_i])
            out["_FWrdDReps"] = idx(reps[d_i])
            if want_mrd:
                out["_FMrd"] = planes[0]
    return out


def _reduce(G, coeffs):
    """Σ_ch coeffs[ch] G[ch]: one pass over the stacked channels."""
    return torch.tensordot(coeffs, G, dims=1)


def _at_reps(x, reps, like):
    """Per-class scalars (len(reps),) of a per-cell or scalar coefficient."""
    x = torch.as_tensor(x, dtype=like.dtype, device=like.device)
    if x.dim() == 0:
        return x.expand(reps.shape[0])
    return x.index_select(0, reps)


def planes_from_theta(theta, dim, want_cuc, want_rd, want_mrd):
    """The channel stacks reduced with theta's per-class scalars: the
    plane list in ``bell.assemble_fused``'s order, [Wel, Cuc?, Wrd?,
    Mrd?], or None when theta does not carry the stacks they need."""
    if "_FReps" not in theta or "_FWel" not in theta:
        return None
    if (want_cuc and "_FCuc" not in theta) or (want_rd and "_FWrd" not in theta) \
            or (want_mrd and "_FMrd" not in theta):
        return None
    G = theta["_FWel"]
    reps = theta["_FReps"]
    mu_t = _at_reps(theta["mu"], reps, G)
    lam_t = _at_reps(theta["lam"], reps, G)
    planes = [_reduce(G, torch.cat([mu_t, lam_t]))]
    if want_cuc:
        cpl_t = _at_reps(theta["coupling"], reps, G)
        planes.append(_reduce(theta["_FCuc"], cpl_t * (2.0 * mu_t + dim * lam_t)))
    if want_rd:
        dt = torch.as_tensor(theta["dt"], dtype=G.dtype, device=G.device).reshape(1)
        rho_t = _at_reps(theta["rho"], theta["_FWrdRhoReps"], G)
        D_t = _at_reps(theta["D"], theta["_FWrdDReps"], G)
        coeffs = torch.cat([torch.ones_like(dt), -dt * rho_t, dt * D_t])
        planes.append(_reduce(theta["_FWrd"], coeffs))
    if want_mrd:
        planes.append(theta["_FMrd"])
    return planes


# -- P2 (quad) concentration plane (ops/p2_ell.py) ---------------------------


def build_p2_cache(p2plan, p2k, labels, support=None):
    """Frozen per-class channels of the assembled P2 rd constant plane:
    ``_FP2Wrd`` (1 + |supp rho| + |supp D|, nb, s, Kh), channels [M_full,
    M_t for t in supp rho, K_t for t in supp D], with ``_FP2RhoReps`` /
    ``_FP2DReps`` their representative cells.  One placement gather a
    channel, without a graph."""
    from glimslib_tpu_torch.ops import p2_ell

    labels = np.asarray(labels)
    classes, reps = class_reps(labels)
    dev, dt = p2k.device, p2k.dtype
    idx = lambda a: torch.as_tensor(np.asarray(a, dtype=np.int64), device=dev)  # noqa: E731
    rho_i = _support_idx(classes, support, "rho")
    d_i = _support_idx(classes, support, "D")
    with torch.no_grad():
        M0 = torch.as_tensor(p2_ell.p2_ref_tensors(p2k.dim)[0], dtype=dt, device=dev)
        Kg = p2_ell.stiffness_geom(p2k)
        det = p2k.detJ

        def ind(i):
            return torch.as_tensor(labels == classes[i], dtype=dt, device=dev)

        ents = [lambda: M0[:, :, None] * det]
        ents += [lambda i=i: M0[:, :, None] * (det * ind(i)) for i in rho_i]
        ents += [lambda i=i: (det * ind(i)) * Kg for i in d_i]
        planes = torch.empty((len(ents), p2plan.nb, p2plan.s, p2plan.Kh),
                             dtype=dt, device=dev)
        for k, ent in enumerate(ents):
            planes[k] = p2plan.assemble(ent())
    return {"_FP2Wrd": planes, "_FP2RhoReps": idx(reps[rho_i]),
            "_FP2DReps": idx(reps[d_i])}


def p2_planes_from_theta(theta):
    """The P2 rd constant plane M − dt Σ rho_t M_t + dt Σ D_t K_t reduced
    from the frozen channels, or None when theta does not carry them."""
    if "_FP2Wrd" not in theta:
        return None
    G = theta["_FP2Wrd"]
    dt = torch.as_tensor(theta["dt"], dtype=G.dtype, device=G.device).reshape(1)
    rho_t = _at_reps(theta["rho"], theta["_FP2RhoReps"], G)
    D_t = _at_reps(theta["D"], theta["_FP2DReps"], G)
    return _reduce(G, torch.cat([torch.ones_like(dt), -dt * rho_t, dt * D_t]))
