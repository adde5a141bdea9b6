"""Brain tumor-growth model with per-tissue parameters (counterpart of
``glimslib_tpu/models/tumor_growth_brain.py``).

13 per-tissue parameters (reference brain_quad.py:17-23) over the tissue
map {0: outside, 1: CSF, 2: GM, 3: WM, 4: Ventricles}, with zero
diffusion/proliferation outside GM+WM and a fixed stiff 'outside'
material E=10e3, nu=0.45.  Per-cell coefficients are lookups of the
per-tissue values by cell label.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from glimslib_tpu_torch import config
from glimslib_tpu_torch.models.tumor_growth import TumorGrowth
from glimslib_tpu_torch.ops import forms

# fixed material for the 'outside' region (reference brain_quad.py:38-39)
E_OUT = 10e3
NU_OUT = 0.45


class TumorGrowthBrain(TumorGrowth):
    TISSUES = ("outside", "CSF", "GM", "WM", "Ventricles")

    def _define_model_params(self):
        self.required_params = [
            "E_GM", "E_WM", "E_CSF", "E_VENT",
            "nu_GM", "nu_WM", "nu_CSF", "nu_VENT",
            "D_GM", "D_WM",
            "rho_GM", "rho_WM",
            "coupling",
        ]
        self.optional_params = ["body_force", "rd_source_term"]

    def _tissue_lookup(self, by_name: Dict[str, object], fill=0.0):
        """{tissue_name: value} -> lookup tensor indexed by label id.  Values
        may be tensors (a parameter that requires grad keeps its graph)."""
        id_name = self.subdomains.tissue_id_name_map
        max_id = max(
            [int(self.subdomains.cell_labels.max())] + list(id_name.keys())
        )
        vals = []
        for tid in range(max_id + 1):
            name = id_name.get(tid)
            vals.append(by_name.get(name, fill) if name is not None else fill)
        return torch.stack([self._tensor(v) for v in vals])

    def theta_class_labels(self):
        """Every coefficient is a per-tissue lookup over the cell labels
        (:meth:`make_theta`), so the factored assembly is always exact."""
        return np.asarray(self.subdomains.cell_labels)

    def theta_class_support(self):
        """D and rho are 0 outside GM and WM for any parameter values
        (:meth:`make_theta`): their factored channels exist only there."""
        name_id = {v: k for k, v in self.subdomains.tissue_id_name_map.items()}
        supp = {int(name_id[n]) for n in ("GM", "WM") if n in name_id}
        return {"D": supp, "rho": supp}

    def make_theta(self, params: Dict):
        p = params
        E_lut = self._tissue_lookup(
            {"CSF": p["E_CSF"], "GM": p["E_GM"], "WM": p["E_WM"],
             "Ventricles": p["E_VENT"], "outside": E_OUT},
            fill=E_OUT,
        )
        nu_lut = self._tissue_lookup(
            {"CSF": p["nu_CSF"], "GM": p["nu_GM"], "WM": p["nu_WM"],
             "Ventricles": p["nu_VENT"], "outside": NU_OUT},
            fill=NU_OUT,
        )
        # zero D / rho outside GM+WM (reference brain_quad.py:95-104)
        D_lut = self._tissue_lookup({"GM": p["D_GM"], "WM": p["D_WM"]}, fill=0.0)
        rho_lut = self._tissue_lookup(
            {"GM": p["rho_GM"], "WM": p["rho_WM"]}, fill=0.0
        )
        # per-cell values as the cells' one-hot label rows times each table:
        # equal to lut[labels] (a row sums one 1 x value and exact zeros),
        # and the VJP is one matrix-vector product, where indexing's
        # backward piles every cell's atomic add onto a handful of tissues
        labels = torch.as_tensor(
            self.subdomains.cell_labels, dtype=torch.int64, device=self.device
        )
        tissues = torch.arange(E_lut.shape[0], device=self.device)
        onehot = (labels[:, None] == tissues).to(self.dtype)
        E = onehot @ E_lut
        nu = onehot @ nu_lut
        return {
            "D": onehot @ D_lut,
            "rho": onehot @ rho_lut,
            "coupling": self._tensor(p["coupling"]),
            "mu": forms.compute_mu(E, nu),
            "lam": forms.compute_lambda(E, nu),
            "dt": self._tensor(float(p["sim_time_step"])),
            "body_force": self._body_force(p.get("body_force")),
            "source": self._tensor(p.get("rd_source_term", 0.0)),
        }

    # -- adjoint runners (reference brain_quad.py:131-210) --------------------
    # Given tensors that require grad, the returned solution keeps its
    # graph (Simulation.run), gathered differentiably under node sharding.

    def _set_and_run(self, updates: Dict, output_dir=None):
        for k, v in updates.items():
            setattr(self.params, k, v)
        self.run(keep_nth=1, save_method=None, clear_all=False, plot=False,
                 output_dir=output_dir or config.output_dir_simulation_tmp)
        return self.solution

    def run_for_adjoint(self, parameters, output_dir=None):
        """5 params: D_WM, D_GM, rho_WM, rho_GM, coupling (brain_quad.py:131-149)."""
        d_wm, d_gm, r_wm, r_gm, k = parameters
        return self._set_and_run(
            {"D_WM": d_wm, "D_GM": d_gm, "rho_WM": r_wm, "rho_GM": r_gm,
             "coupling": k},
            output_dir,
        )

    run_for_adjoint_5params = run_for_adjoint

    def run_for_adjoint_4params(self, parameters, output_dir=None):
        """D_WM, D_GM, rho(=WM=GM), coupling (brain_quad.py:192-210)."""
        d_wm, d_gm, r, k = parameters
        return self._set_and_run(
            {"D_WM": d_wm, "D_GM": d_gm, "rho_WM": r, "rho_GM": r, "coupling": k},
            output_dir,
        )

    def run_for_adjoint_3params(self, parameters, output_dir=None):
        """D_WM (D_GM=0.2*D_WM), rho, coupling (brain_quad.py:151-169)."""
        d_wm, r, k = parameters
        return self._set_and_run(
            {"D_WM": d_wm, "D_GM": 0.2 * d_wm, "rho_WM": r, "rho_GM": r,
             "coupling": k},
            output_dir,
        )

    def run_for_adjoint_2params(self, parameters, output_dir=None):
        """D_WM (D_GM=0.2*D_WM), rho; coupling unchanged (brain_quad.py:171-189)."""
        d_wm, r = parameters
        return self._set_and_run(
            {"D_WM": d_wm, "D_GM": 0.2 * d_wm, "rho_WM": r, "rho_GM": r},
            output_dir,
        )

    def init_postprocess(self, output_dir=None):
        from glimslib_tpu_torch.postprocess import PostProcessTumorGrowthBrain

        self.postprocess = PostProcessTumorGrowthBrain(
            self.results, self.params, output_dir=output_dir or "."
        )
        return self.postprocess
