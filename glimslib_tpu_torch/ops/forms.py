"""Continuum-mechanics closed forms (counterpart of
``glimslib_tpu/ops/forms.py``): the material parameter maps ``make_theta``
reads (numpy arrays or torch tensors) and the strain, stress and growth
fields post-processing reads (torch tensors)."""

from __future__ import annotations

import torch


def compute_mu(young_modulus, poisson_ratio):
    return young_modulus / (2.0 * (1.0 + poisson_ratio))


def compute_lambda(young_modulus, poisson_ratio):
    return (
        young_modulus
        * poisson_ratio
        / ((1.0 + poisson_ratio) * (1.0 - 2.0 * poisson_ratio))
    )


# -- kinematics / stress (glimslib_tpu/ops/forms.py:33-98), torch tensors with
# the (d, d) tensor axes last and any leading shape ---------------------------


def compute_strain(grad_u):
    """Small strain sym(grad u) from the displacement gradient (..., d, d)."""
    return 0.5 * (grad_u + grad_u.transpose(-1, -2))


def _eye(d, like):
    return torch.eye(d, dtype=like.dtype, device=like.device)


def compute_stress(strain, mu, lmbda):
    """Isotropic linear-elastic stress 2 mu eps + lambda tr(eps) I; ``mu`` /
    ``lmbda`` broadcast over the leading axes (e.g. per-cell tensors)."""
    d = strain.shape[-1]
    tr = torch.diagonal(strain, dim1=-2, dim2=-1).sum(-1)
    mu = torch.as_tensor(mu, dtype=strain.dtype, device=strain.device)[..., None, None]
    lmbda = torch.as_tensor(lmbda, dtype=strain.dtype,
                            device=strain.device)[..., None, None]
    return 2.0 * mu * strain + lmbda * tr[..., None, None] * _eye(d, strain)


def compute_pressure_from_stress_tensor(stress):
    return torch.diagonal(stress, dim1=-2, dim2=-1).sum(-1) / 3.0


def u_norm(u):
    return torch.sqrt(torch.sum(u * u, dim=-1))


def compute_total_jacobian(grad_u):
    return torch.linalg.det(_eye(grad_u.shape[-1], grad_u) + grad_u)


def compute_growth_induced_strain(conc, coupling, dim):
    """c * k * I (math_linear_elasticity.py:32-33)."""
    coupling = torch.as_tensor(coupling, dtype=conc.dtype, device=conc.device)
    return conc[..., None, None] * coupling[..., None, None] * _eye(dim, conc)


def compute_growth_induced_jacobian(growth_strain, dim):
    return torch.linalg.det(_eye(dim, growth_strain) + growth_strain)


def compute_deviatoric_stress_tensor(stress, dim):
    tr = torch.diagonal(stress, dim1=-2, dim2=-1).sum(-1)
    return stress - (tr / 3.0)[..., None, None] * _eye(dim, stress)


def compute_van_mises_stress(stress, dim):
    dev = compute_deviatoric_stress_tensor(stress, dim)
    return torch.sqrt(1.5 * (dev * dev).sum(dim=(-2, -1)))


def compute_concentration_deformed(conc, grad_u, coupling, dim):
    """Concentration mapped to the deformed configuration
    (math_linear_elasticity.py:67-71)."""
    jac_total = compute_total_jacobian(grad_u)
    strain_growth = compute_growth_induced_strain(conc, coupling, dim)
    jac_growth = compute_growth_induced_jacobian(strain_growth, dim)
    return conc * jac_growth / jac_total


def compute_growth_logistic(conc, prolif_rate, conc_max):
    return prolif_rate * conc * (1.0 - conc / conc_max)
