"""Material parameter maps (counterpart of ``glimslib_tpu/ops/forms.py``,
the part ``make_theta`` reads).  Works on numpy arrays and torch tensors."""

from __future__ import annotations


def compute_mu(young_modulus, poisson_ratio):
    return young_modulus / (2.0 * (1.0 + poisson_ratio))


def compute_lambda(young_modulus, poisson_ratio):
    return (
        young_modulus
        * poisson_ratio
        / ((1.0 + poisson_ratio) * (1.0 - 2.0 * poisson_ratio))
    )
