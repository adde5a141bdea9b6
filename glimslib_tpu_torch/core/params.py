"""Simulation parameter management (counterpart of
``glimslib_tpu/core/params.py``).

Parameters are plain host values: scalars, or per-tissue dicts that become
:class:`TissueCoefficient` lookups.  The models turn them into tensors on
their device in ``make_theta``.
"""

from __future__ import annotations

import logging
from typing import Dict, List

import numpy as np
import torch

logger = logging.getLogger(__name__)


class Parameters:
    def __init__(self, functionspace, subdomains, time_dependent=False):
        self._functionspace = functionspace
        self._subdomains = subdomains
        self.time_dependent = time_dependent
        self.required_params: List[str] = []
        self.optional_params: List[str] = []
        self._param_names: List[str] = []
        self._iv_expressions = None

    def define_required_params(self, params: List[str]):
        self.required_params = list(params)
        if self.time_dependent:
            for p in ("sim_time", "sim_time_step"):
                if p not in self.required_params:
                    self.required_params.append(p)

    def define_optional_params(self, params: List[str]):
        self.optional_params = list(params)

    def init_parameters(self, param_dict: Dict):
        missing = [p for p in self.required_params if p not in param_dict]
        if missing:
            raise ValueError(f"missing required parameters: {missing}")
        unknown = [
            p
            for p in param_dict
            if p not in self.required_params and p not in self.optional_params
        ]
        if unknown:
            raise ValueError(f"unknown parameters: {unknown}")
        for name, value in param_dict.items():
            self.set_parameter(name, value)

    def set_parameter(self, name: str, value):
        """Dict values become per-tissue coefficient lookups."""
        if isinstance(value, dict):
            lookup = self._subdomains.tissue_value_array(value)
            value = TissueCoefficient(
                lookup, self._subdomains.cell_labels, tissue_map=value
            )
        setattr(self, name, value)
        if name not in self._param_names:
            self._param_names.append(name)

    def get_names(self):
        return list(self._param_names)

    def as_dict(self):
        return {n: getattr(self, n) for n in self._param_names}

    def cell_coefficient(self, name: str):
        """Per-cell coefficient array (or the scalar) of a parameter."""
        v = getattr(self, name)
        if isinstance(v, TissueCoefficient):
            return v.per_cell()
        return v

    def set_initial_value_expressions(self, iv_expression: Dict[int, object]):
        self._iv_expressions = iv_expression

    def create_initial_value_function(self):
        """L2-project the IV expressions onto their subspaces, as the
        reference does (numpy arrays, float64)."""
        if self._iv_expressions is None:
            raise ValueError("no initial value expressions set")
        return self._functionspace.project_over_space(self._iv_expressions)

    def time_update_parameters(self, time):
        """No-op: time-dependent parameters are callables evaluated when a
        step is solved.  Kept for the reference's API."""


class TissueCoefficient:
    """Heterogeneous per-tissue coefficient: ``values[cell_labels]``.
    ``values`` is numpy, or a tensor (kept as given, so a gradient flows
    to it through :meth:`per_cell`)."""

    def __init__(self, values, cell_labels, tissue_map=None):
        if isinstance(values, torch.Tensor):
            self.values = values
        else:
            self.values = np.asarray(values, dtype=np.float64)
        self.cell_labels = np.asarray(cell_labels, dtype=np.int64)
        self.tissue_map = tissue_map or {}

    def per_cell(self):
        if isinstance(self.values, torch.Tensor):
            return self.values[torch.as_tensor(self.cell_labels,
                                               device=self.values.device)]
        return self.values[self.cell_labels]

    def with_values(self, values):
        """The same labels and tissue map with other per-label values."""
        return TissueCoefficient(values, self.cell_labels, self.tissue_map)
