"""Adjoint-based inverse problems: autograd through the time loop
(counterpart of ``glimslib_tpu/optimize/adjoint.py``).

The objective is a torch function of the parameter vector

    J(m) = ∫ (thresh_T2(c_T) - target_T2)^2 dx
         + ∫ (thresh_T1(c_T) - target_T1)^2 dx
         + ∫ |u_T - target_u|^2 dx

(the reference functional at image_based_optimization.py:687-698, with the
smooth-tanh threshold ``0.5*(tanh((f - level)/0.01) + 1)`` of l.1403-1407
and levels T2=0.12 / T1=0.80 of l.52-53), and ``torch.autograd.grad``
differentiates it through ``simulate``'s time loop, each step's exact
gradient coming from the implicit-function-theorem adjoint of
``solvers/coupled.py``.  On the card every forward and adjoint solve runs
through the port's kernels.

Parameter-tying variants mirror ``map_optimization_type``
(image_based_optimization.py:770-783) and the ``run_for_adjoint_*``
heuristics (simulation_tumor_growth_brain_quad.py:151-210), e.g. the
2-param estimation ties D_GM = 0.2*D_WM and rho_GM = rho_WM.

``InverseProblem.export_computation_graph`` writes the autograd graph of
one objective evaluation as text, the counterpart of the reference's
jaxpr dump.

On a model under ``use_sharding(mode="nodes")`` (lattice or
unstructured) every rank builds the problem on the same whole targets
and keeps its rows of them; each L2 term is the rank's owned rows
against their mass action (its halo or ghost rows exchanged), and the
rank's partial J is summed over the ranks once
(``parallel.shard.reduce_sum``), so J and the gradient are the same on
every rank, bit for bit, and ``minimize`` takes the same iterates on all
of them.  Under ``mode="cells"`` the fields and the mass actions are
replicated, so J is the same on every rank and is not summed again.
Rank 0 alone writes ``export_computation_graph``'s file.
"""

from __future__ import annotations

import logging
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from glimslib_tpu_torch.parallel.shard import reduce_sum

logger = logging.getLogger(__name__)

CONC_THRESHOLD_LEVELS = {"T2": 0.12, "T1": 0.80}  # reference l.52-53
THRESH_SMOOTHNESS = 0.01  # reference l.1404


def thresh(f, level, smooth=THRESH_SMOOTHNESS):
    """Smooth indicator 0.5*(tanh((f-level)/smooth)+1)
    (reference image_based_optimization.py:1403-1407)."""
    return 0.5 * (torch.tanh((f - level) / smooth) + 1.0)


# -- parameter-tying maps (reference l.770-783 + brain_quad.py:151-210) ------


def param_map_for_type(optimization_type: int):
    """Returns (param_names, update_fn) where update_fn maps the parameter
    vector to the model-parameter updates dict."""
    if optimization_type == 2:
        names = ["D_WM", "rho_WM"]

        def update(v):
            return {"D_WM": v[0], "D_GM": 0.2 * v[0], "rho_WM": v[1],
                    "rho_GM": v[1]}

    elif optimization_type == 3:
        names = ["D_WM", "rho_WM", "coupling"]

        def update(v):
            return {"D_WM": v[0], "D_GM": 0.2 * v[0], "rho_WM": v[1],
                    "rho_GM": v[1], "coupling": v[2]}

    elif optimization_type == 4:
        names = ["D_WM", "D_GM", "rho_WM", "coupling"]

        def update(v):
            return {"D_WM": v[0], "D_GM": v[1], "rho_WM": v[2],
                    "rho_GM": v[2], "coupling": v[3]}

    elif optimization_type == 5:
        names = ["D_WM", "D_GM", "rho_WM", "rho_GM", "coupling"]

        def update(v):
            return {"D_WM": v[0], "D_GM": v[1], "rho_WM": v[2],
                    "rho_GM": v[3], "coupling": v[4]}

    else:
        raise ValueError(f"unknown optimization type {optimization_type}")
    return names, update


def tumor_growth_param_map(n_params: int):
    """Parameter maps for the uniform TumorGrowth model
    (run_for_adjoint / run_for_adjoint2, simulation_tumor_growth.py:142-170)."""
    if n_params == 3:
        names = ["diffusion", "proliferation", "coupling"]

        def update(v):
            return {"diffusion": v[0], "proliferation": v[1], "coupling": v[2]}

    elif n_params == 2:
        names = ["diffusion", "proliferation"]

        def update(v):
            return {"diffusion": v[0], "proliferation": v[1]}

    else:
        raise ValueError(n_params)
    return names, update


class InverseProblem:
    """Differentiable objective for parameter estimation on a Simulation.

    targets: dict with any of
      'conc_T2' / 'conc_T1' : thresholded target concentration fields (n_c,)
      'conc'                : raw target concentration (compared un-thresholded)
      'disp'                : target displacement (n_u, d)
    as arrays or tensors; they are moved to the model's device and dtype.
    """

    def __init__(
        self,
        sim,
        param_names: List[str],
        targets: Dict[str, object],
        update_fn: Optional[Callable] = None,
        threshold_levels: Dict[str, float] = CONC_THRESHOLD_LEVELS,
        n_steps: Optional[int] = None,
        dt: Optional[float] = None,
        reg_alpha: float = 0.0,
        target_weights: Optional[Dict[str, float]] = None,
    ):
        # reg_alpha: Tikhonov weight on the final state, J += α ∫ |u|²+c² dx
        # (test_case_..._2D_uniform_adjoint_noise.py: alpha*inner(u,u)*dx)
        self.reg_alpha = float(reg_alpha)
        # target_weights: per-target misfit multipliers (default 1.0 each,
        # the reference's equal weighting at image_based_optimization.py:
        # 687-698)
        self.target_weights = dict(target_weights or {})
        self.sim = sim
        self.param_names = list(param_names)
        self.update_fn = update_fn or (
            lambda v: dict(zip(self.param_names, list(v)))
        )
        # node sharding: the rank's rows of the whole targets
        nodes = getattr(sim, "sharding_mode", None) == "nodes"
        self._mesh = sim.device_mesh if nodes else None
        self.targets = {
            k: sim._own((v.detach() if torch.is_tensor(v) else torch.as_tensor(np.array(v)))
                        .to(dtype=sim.dtype, device=sim.device)).contiguous()
            for k, v in targets.items()
        }
        self.levels = dict(threshold_levels)
        dt = dt if dt is not None else float(sim.params.sim_time_step)
        n_steps = n_steps if n_steps is not None else int(
            round(float(sim.params.sim_time) / dt + 1e-9)
        )
        self.n_steps = n_steps
        self.dt = dt
        self._simulate = sim.build_simulate_fn(n_steps, dt)
        self._base_params = dict(sim.params.as_dict())
        self._u0, self._c0 = sim.initial_state()
        # frozen preconditioner state ({} on lattice meshes), built once
        self._aux = sim.runtime_aux()

    # -- objective ----------------------------------------------------------

    def _l2sq(self, f):
        """∫ f² dx (or ∫|f|² for vectors) with the consistent mass matrix
        of the owning subspace (under node sharding this rank's part: its
        owned rows against their mass action)."""
        if f.dim() == 1:
            return torch.sum(f * self.sim.concentration_mass_action(f))
        return torch.sum(f * self.sim.displacement_mass_action(f))

    def _objective(self, v):
        """J at the parameter tensor ``v`` (on the model's device)."""
        p = dict(self._base_params)
        p.update(self.update_fn(v))
        theta = self.sim.make_theta(p)
        u_traj, c_traj, _, _ = self._simulate(theta, self._u0, self._c0,
                                              self._aux or None)
        u_T, c_T = u_traj[-1], c_traj[-1]
        targets, levels, w = self.targets, self.levels, self.target_weights
        l2sq = self._l2sq
        J = torch.zeros((), dtype=c_T.dtype, device=c_T.device)
        if "conc_T2" in targets:
            J = J + w.get("conc_T2", 1.0) * l2sq(
                thresh(c_T, levels["T2"]) - targets["conc_T2"])
        if "conc_T1" in targets:
            J = J + w.get("conc_T1", 1.0) * l2sq(
                thresh(c_T, levels["T1"]) - targets["conc_T1"])
        if "conc" in targets:
            J = J + w.get("conc", 1.0) * l2sq(c_T - targets["conc"])
        if "disp" in targets:
            J = J + w.get("disp", 1.0) * l2sq(u_T - targets["disp"])
        if self.reg_alpha > 0.0:
            J = J + self.reg_alpha * (l2sq(u_T) + l2sq(c_T))
        return reduce_sum(self._mesh, J)

    def export_computation_graph(self, path, v=None):
        """Write the autograd graph of one objective evaluation at ``v``
        (default zeros, as the reference's jaxpr dump) to ``path`` as
        text, the counterpart of the reference's
        ``sim.tape.visualise()`` (image_based_optimization.py:764-765):
        node counts by name, then every node by a depth-first walk of
        ``grad_fn`` from J, one line each, indented by depth and named
        with its id, with the ids of nodes already listed in brackets.
        Each implicit step is one ``_ImplicitStepBackward`` node.  Under
        node sharding every rank evaluates J and rank 0 alone writes.
        Returns ``path``."""
        v = np.zeros(len(self.param_names)) if v is None else np.asarray(v)
        with torch.enable_grad():
            J = self._objective(self._param(v, True))
        if self._mesh is not None and self._mesh.rank != 0:
            return path
        ids, lines, counts = {}, [], {}
        stack = [(J.grad_fn, 0)]
        while stack:
            fn, depth = stack.pop()
            if fn is None:
                continue
            name = type(fn).__name__
            if fn in ids:
                lines.append(f"{'  ' * depth}[{ids[fn]}] {name}")
                continue
            ids[fn] = len(ids)
            counts[name] = counts.get(name, 0) + 1
            lines.append(f"{'  ' * depth}{ids[fn]} {name}")
            stack.extend((nxt, depth + 1) for nxt, _ in reversed(fn.next_functions))
        with open(path, "w") as f:
            f.write(f"# autograd graph of J = {float(J.detach()):.17g} at v = "
                    f"{v.tolist()}: {len(ids)} nodes\n")
            for name, k in sorted(counts.items(), key=lambda x: (-x[1], x[0])):
                f.write(f"# {k} {name}\n")
            f.write("\n".join(lines) + "\n")
        return path

    def _param(self, v, requires_grad):
        return torch.tensor(np.asarray(v, dtype=np.float64), dtype=self.sim.dtype,
                            device=self.sim.device, requires_grad=requires_grad)

    def objective(self, v):
        """J(v) as a float: a forward run, no graph."""
        with torch.no_grad():
            return float(self._objective(self._param(v, False)))

    def value_and_grad(self, v):
        """(J, dJ/dv) as a float and a float64 numpy array: one forward run
        that keeps its graph, then the adjoint through every step."""
        vt = self._param(v, True)
        with torch.enable_grad():
            J = self._objective(vt)
            (g,) = torch.autograd.grad(J, vt, allow_unused=True)
        if g is None:
            g = torch.zeros_like(vt)
        return float(J.detach()), g.detach().cpu().numpy().astype(np.float64)

    # -- optimization (reference l.700-767) ---------------------------------

    def minimize(self, x0, bounds=None, opt_params=None):
        """Bounded optimization with the reference's defaults: L-BFGS-B,
        bounds [0.005, 0.5], tol 1e-6, gtol 1e-6
        (image_based_optimization.py:711-718).

        ``opt_params`` may carry ``method`` (any scipy gradient method) or
        ``algorithm`` (a user-supplied ``custom_optimizer``-style callable,
        reference image_based_optimization.py:646-658) besides the
        tolerance/maxiter keys.

        Returns (x_opt, OptimizationProgress, result)."""
        from glimslib_tpu_torch.optimize.lbfgsb import minimize_lbfgsb

        x0 = np.asarray(x0, dtype=np.float64)
        if bounds is None:
            bounds = [(0.005, 0.5)] * len(x0)
        params = {"tol": 1e-6, "gtol": 1e-6}
        if opt_params:
            params.update(opt_params)
        return minimize_lbfgsb(
            self.value_and_grad,
            x0,
            bounds=bounds,
            param_names=self.param_names,
            **params,
        )
