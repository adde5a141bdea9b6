"""The synthetic 3D brain box the benchmark runs (counterpart of
``__graft_entry__._brain_sim``, which imports jax and is not used here).

``brain_sim(n=32)`` is the main path's configuration: an n^3-voxel Kuhn
lattice of [0, 10]^3 (35,937 nodes and 196,608 tets at n=32) with
concentric-ellipsoid tissue labels, a clamped boundary and a Gaussian seed
off-centre in white matter; sim_time 5, dt 1.  ``unstructured=True``
strips the lattice structure and reorders the nodes along a Morton curve
(``bench.py run_unstructured``): the same tets through the unstructured
lane, which the benchmark times with :data:`UNSTRUCT_STEP_CONFIG`.
:data:`REFINED_STEP_CONFIG` is the benchmark's accuracy mode, the f32
step refined in f64.  ``quad=True`` builds the quad model (P2
concentration, ``models/tumor_growth_brain_quad.py``), the family the
reference's workflow drives: with ``unstructured=True`` at n=32 it is the
benchmark's quad flagship (274,625 P2 dofs), which at f32 takes
:data:`UNSTRUCT_STEP_CONFIG` as the benchmark times it.

``adjoint_problem`` is the benchmark's adjoint cell (``bench.py
run_adjoint``): the 2-parameter inverse problem on that box (on the quad
model with ``quad=True``).

The 2D problems, each with the settings of the reference example it is
named after (``examples/``):

- ``rect_sim(n=50)``: ``tumor_growth_2D_uniform.py``, a 50 x 50 rectangle
  lattice of [-5, 5]^2 (2,601 nodes, 7 stencil offsets), uniform
  parameters, 5 steps; ``subdomains=True``:
  ``tumor_growth_2D_subdomains.py``, two tissues with per-tissue
  parameters, 10 steps.  Both run the lattice lane at d=2.
- ``rect_adjoint_problem(n=50)``: ``tumor_growth_2D_uniform_adjoint.py``,
  the 3-parameter inverse problem on that rectangle.
- ``atlas2d_problem()``: ``brain_2D_atlas_reduced_domain_adjoint.py``, a
  slice of a synthetic brain labelmap meshed pixel by pixel, cut down to
  the tissues, on which ``TumorGrowthBrain`` runs the unstructured lane.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np
import torch

from glimslib_tpu_torch.core.mesh import Mesh, box_mesh, rectangle_mesh
from glimslib_tpu_torch.models.tumor_growth import TumorGrowth
from glimslib_tpu_torch.models import tumor_growth_brain_quad
from glimslib_tpu_torch.models.tumor_growth_brain import TumorGrowthBrain
from glimslib_tpu_torch.solvers.coupled import StepConfig

# the f32 operating point the benchmark times (bench.py build_problem)
BENCH_STEP_CONFIG = StepConfig(
    newton_rtol=1e-4, newton_atol=1e-5, cg_rtol=1e-7, cg_maxiter=800
)
# the f32 operating point of the unstructured lane (bench.py
# run_unstructured): inexact-Newton forcing on the c-block, chord method on
UNSTRUCT_STEP_CONFIG = StepConfig(
    newton_rtol=1e-4, newton_atol=1e-5, cg_rtol=1e-7, cg_maxiter=800,
    rd_cg_rtol=1e-3,
)
# the f32 accuracy mode (bench.py run_refined, its refined_steps_per_sec
# cell): the benchmark's operating point with f64 residuals around the f32
# solves, as Simulation's own f32 default does
REFINED_STEP_CONFIG = StepConfig(
    newton_rtol=1e-4, newton_atol=1e-5, cg_rtol=1e-7, cg_maxiter=800,
    refine_f64=True,
)


class _Boundary:
    def inside(self, x, on_boundary):
        return on_boundary


def brain_sim(n=10, dtype=None, device=None, plain=False, unstructured=False,
              quad=False):
    """TumorGrowthBrain on the synthetic brain box, set up as the reference
    benchmark sets it up; on the card unless ``device`` says otherwise.
    ``quad``: the quad model (needs ``unstructured``: the port runs it on
    the unstructured lane only), at f32 with :data:`UNSTRUCT_STEP_CONFIG`."""
    mesh = box_mesh((0, 0, 0), (10, 10, 10), n, n, n)
    if unstructured:
        mesh = Mesh.from_arrays(mesh.points, mesh.cells).reordered_morton()
    r = np.linalg.norm((mesh.points - 5.0) / 5.0, axis=1)
    labels = np.zeros(mesh.n_nodes)
    labels[r < 0.95] = 1
    labels[r < 0.80] = 2
    labels[r < 0.62] = 3
    labels[r < 0.20] = 4

    model = tumor_growth_brain_quad.TumorGrowthBrain if quad else TumorGrowthBrain
    sim = model(mesh, dtype=dtype, device=device, plain=plain)
    sim.setup_global_parameters(
        label_function=labels,
        domain_names={0: "outside", 1: "CSF", 2: "GM", 3: "WM", 4: "Ventricles"},
        boundaries={"boundary_all": _Boundary()},
        dirichlet_bcs={
            "clamped": {
                "bc_value": np.zeros(mesh.dim),
                "named_boundary": "boundary_all",
                "subspace_id": 0,
            }
        },
    )
    center = np.full(mesh.dim, 5.0)
    center[0] += 1.0  # seed off-centre inside WM
    sim.setup_model_parameters(
        iv_expression={
            0: np.zeros(mesh.dim),
            1: lambda x: np.exp(-((x - center) ** 2).sum(axis=1) / 0.5),
        },
        E_GM=3e3, E_WM=3e3, E_CSF=1e3, E_VENT=1e3,
        nu_GM=0.45, nu_WM=0.45, nu_CSF=0.45, nu_VENT=0.3,
        D_GM=0.02, D_WM=0.1, rho_GM=0.02, rho_WM=0.1, coupling=0.15,
        sim_time=5, sim_time_step=1,
    )
    if quad and sim.dtype == torch.float32:
        sim.step_config = UNSTRUCT_STEP_CONFIG
    return sim


# the adjoint cell's schedule (bench.py run_adjoint): 5 steps of dt = 1
ADJ_STEPS = 5


def adjoint_problem(n=16, unstructured=False, dtype=None, device=None, sim=None,
                    quad=False):
    """``(InverseProblem, v0)`` of the benchmark's adjoint cell, as
    ``bench.py run_adjoint`` sets it up: the brain box (``sim``, or a new
    :func:`brain_sim`, the quad model with ``quad``), at f32 the
    benchmark's StepConfig of its lane,
    targets ``conc_T2 = thresh(c_T, 0.12)`` and ``disp = u_T`` from a
    forward run at the set-up parameters, parameter map type 2 (D_WM,
    rho_WM), 5 steps of dt = 1, and ``v0 = [0.05, 0.05]``."""
    from glimslib_tpu_torch.optimize.adjoint import InverseProblem, param_map_for_type

    if sim is None:
        sim = brain_sim(n=n, dtype=dtype, device=device, unstructured=unstructured,
                        quad=quad)
    if sim.dtype == torch.float32:
        sim.step_config = (UNSTRUCT_STEP_CONFIG if sim.mesh.lattice_strides is None
                           else BENCH_STEP_CONFIG)
    targets = _targets(sim, sim.params.as_dict(), ("conc_T2", "disp"), ADJ_STEPS, 1.0)
    names, update = param_map_for_type(2)
    ip = InverseProblem(sim, names, targets, update_fn=update, n_steps=ADJ_STEPS,
                        dt=1.0)
    return ip, np.array([0.05, 0.05])


# -- the 2D problems (examples/example_config.py and the scripts named) -------

TISSUE_MAP = {0: "outside", 1: "CSF", 2: "GM", 3: "WM", 4: "Ventricles"}
BRAIN_PARAMS_FIXED = dict(
    E_GM=3e3, E_WM=3e3, E_CSF=1e3, E_VENT=1e3,
    nu_GM=0.45, nu_WM=0.45, nu_CSF=0.45, nu_VENT=0.3,
)
BRAIN_PARAMS_VARYING = dict(D_WM=0.1, D_GM=0.02, rho_WM=0.1, rho_GM=0.02,
                            coupling=0.15)


def gaussian_iv(center, width=1.0):
    """exp(-|x - center|^2 / (2 width^2)) (example_config.gaussian_iv)."""
    c = np.asarray(center, dtype=np.float64)

    def f(x):
        return np.exp(-((x - c) ** 2).sum(axis=1) / (2 * width**2))

    return f


def _clamped(d):
    return {"clamped_boundary": {"bc_value": np.zeros(d),
                                 "named_boundary": "boundary_all",
                                 "subspace_id": 0}}


def rect_sim(n=50, subdomains=False, dtype=None, device=None, plain=False):
    """TumorGrowth on the n x n rectangle lattice of [-5, 5]^2, clamped, as
    ``tumor_growth_2D_uniform.py`` sets it up (seed exp(-r^2), 5 steps), or
    with ``subdomains`` as ``tumor_growth_2D_subdomains.py`` does (an
    inclusion r < 2 in a background tissue, per-tissue parameters, seed
    exp(-r^2 / 2), 10 steps); dt 1."""
    mesh = rectangle_mesh((-5, -5), (5, 5), n, n)
    sim = TumorGrowth(mesh, dtype=dtype, device=device, plain=plain)
    if not subdomains:
        sim.setup_global_parameters(boundaries={"boundary_all": _Boundary()},
                                    dirichlet_bcs=_clamped(2), von_neumann_bcs={})
        sim.setup_model_parameters(
            iv_expression={0: np.zeros(2),
                           1: gaussian_iv((0.0, 0.0), width=1.0 / np.sqrt(2))},
            diffusion=0.1, coupling=1.0, proliferation=0.1, E=0.001, poisson=0.45,
            sim_time=5, sim_time_step=1,
        )
        return sim
    labels = np.where(np.linalg.norm(mesh.points, axis=1) < 2.0, 2.0, 1.0)
    sim.setup_global_parameters(label_function=labels, domain_names={1: "out", 2: "in"},
                                boundaries={"boundary_all": _Boundary()},
                                dirichlet_bcs=_clamped(2))
    sim.setup_model_parameters(
        iv_expression={0: np.zeros(2), 1: gaussian_iv((0.0, 0.0))},
        diffusion={"in": 0.2, "out": 0.05},
        proliferation={"in": 0.2, "out": 0.05},
        coupling={"in": 0.2, "out": 0.05},
        E={"in": 0.002, "out": 0.001},
        poisson={"in": 0.4, "out": 0.45},
        sim_time=10, sim_time_step=1,
    )
    return sim


# tumor_growth_2D_uniform_adjoint.py: the true parameters by count
RECT_V_TRUE = {3: (0.1, 0.1, 0.2), 2: (0.1, 0.1)}


def rect_adjoint_sim(n=50, dtype=None, device=None, plain=False):
    """The model of ``tumor_growth_2D_uniform_adjoint.py``: the n x n
    rectangle, clamped, seed exp(-r^2 / 2), diffusion 0.1, coupling 0.2,
    proliferation 0.1, E 0.001, poisson 0.45, 5 steps of dt 1."""
    mesh = rectangle_mesh((-5, -5), (5, 5), n, n)
    sim = TumorGrowth(mesh, dtype=dtype, device=device, plain=plain)
    sim.setup_global_parameters(boundaries={"boundary_all": _Boundary()},
                                dirichlet_bcs=_clamped(2))
    sim.setup_model_parameters(
        iv_expression={0: np.zeros(2), 1: gaussian_iv((0, 0))},
        diffusion=0.1, coupling=0.2, proliferation=0.1, E=0.001, poisson=0.45,
        sim_time=5, sim_time_step=1,
    )
    return sim


def _targets(sim, params, keys, n_steps=None, dt=None):
    """Targets from a forward run of ``sim`` at ``params`` (no graph), over
    ``n_steps`` steps of ``dt`` (by default the model's schedule):
    ``conc`` c_T, ``conc_T2`` / ``conc_T1`` its thresholds at 0.12 / 0.80,
    ``disp`` u_T."""
    from glimslib_tpu_torch.optimize.adjoint import thresh

    if dt is None:
        dt = float(sim.params.sim_time_step)
    if n_steps is None:
        n_steps = int(round(float(sim.params.sim_time) / dt + 1e-9))
    u0, c0 = sim.initial_state()
    with torch.no_grad():
        u_tr, c_tr, ok, _ = sim.build_simulate_fn(n_steps, dt)(
            sim.make_theta(params), u0, c0)
    if not bool(ok.all()):
        raise RuntimeError("the forward run for the targets did not converge")
    out = {"conc": c_tr[-1], "conc_T2": thresh(c_tr[-1], 0.12),
           "conc_T1": thresh(c_tr[-1], 0.80), "disp": u_tr[-1]}
    return {k: out[k] for k in keys}


def rect_adjoint_problem(n=50, n_params=3, dtype=None, device=None, sim=None):
    """``(InverseProblem, v0)`` of ``tumor_growth_2D_uniform_adjoint.py``:
    on :func:`rect_adjoint_sim` (or ``sim``), targets ``conc = c_T`` and
    ``disp = u_T`` from a forward run at the true parameters
    :data:`RECT_V_TRUE` (diffusion, proliferation[, coupling]), the whole
    schedule (5 steps), and ``v0 = 0.05`` in every component."""
    from glimslib_tpu_torch.optimize.adjoint import InverseProblem, tumor_growth_param_map

    if sim is None:
        sim = rect_adjoint_sim(n=n, dtype=dtype, device=device)
    names, update = tumor_growth_param_map(n_params)
    params = {**sim.params.as_dict(), **update(np.array(RECT_V_TRUE[n_params]))}
    targets = _targets(sim, params, ("conc", "disp"))
    ip = InverseProblem(sim, names, targets, update_fn=update)
    return ip, np.full(len(names), 0.05)


def atlas2d_mesh(nx=64, ny=64, nz=24, z_slice=12):
    """The reduced domain of ``brain_2D_atlas_reduced_domain_adjoint.py``:
    a synthetic (nz, ny, nx) brain labelmap, written as a MetaImage into a
    temporary directory and read back; its axial slice ``z_slice`` meshed
    pixel by pixel (a rectangle lattice); the cells of tissues 1-4 kept
    (the 'outside' removed), which leaves a mesh with no lattice.  Returns
    ``(mesh, nodal labels, full mesh, full nodal labels)``."""
    from glimslib_tpu_torch.core.subdomains import SubDomains
    from glimslib_tpu_torch.utils import data_io as dio
    from glimslib_tpu_torch.utils.image_io import Image, write_mha
    from glimslib_tpu_torch.utils.synthetic import brain_labelmap_3d
    from glimslib_tpu_torch.utils.vtk_utils import cell_to_point_data

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, f"synthetic_brain_atlas_{nx}x{ny}x{nz}.mha")
        write_mha(path, Image(brain_labelmap_3d(nx, ny, nz), origin=(0, 0, 0),
                              spacing=(1, 1, 1)))
        mesh_full, labels_full = dio.get_labelfunction_from_image(path, z_slice=z_slice)
    sd = SubDomains(mesh_full)
    sd.setup_subdomains(label_function=labels_full)
    mesh, cell_labels = dio.remove_mesh_subdomain(mesh_full, sd.cell_labels,
                                                  lower_thr=1, upper_thr=4)
    labels = np.rint(cell_to_point_data(mesh.n_nodes, mesh.cells, cell_labels))
    return mesh, labels, mesh_full, labels_full


def atlas2d_sim(nx=64, ny=64, nz=24, z_slice=12, dtype=None, device=None,
                plain=False):
    """TumorGrowthBrain on :func:`atlas2d_mesh`, as the reference example
    sets it up: the tissue map, clamped boundary, a Gaussian seed (width
    2) 4 right of the domain's mean point, the example's fixed and varying
    parameters, 3 steps of dt 1."""
    mesh, labels, _, _ = atlas2d_mesh(nx, ny, nz, z_slice)
    sim = TumorGrowthBrain(mesh, dtype=dtype, device=device, plain=plain)
    sim.setup_global_parameters(label_function=labels, domain_names=TISSUE_MAP,
                                boundaries={"boundary_all": _Boundary()},
                                dirichlet_bcs=_clamped(2))
    seed = mesh.points.mean(axis=0) + np.array([4.0, 0.0])
    sim.setup_model_parameters(
        iv_expression={0: np.zeros(2), 1: gaussian_iv(seed, width=2.0)},
        sim_time=3, sim_time_step=1, **BRAIN_PARAMS_FIXED, **BRAIN_PARAMS_VARYING,
    )
    return sim


def atlas2d_problem(nx=64, ny=64, nz=24, z_slice=12, dtype=None, device=None,
                    sim=None):
    """``(InverseProblem, v0)`` of ``brain_2D_atlas_reduced_domain_adjoint.py``
    on :func:`atlas2d_sim` (or ``sim``): targets ``conc_T2`` and
    ``conc_T1`` (c_T thresholded at 0.12 and 0.80) and ``disp = u_T`` from
    a forward run at the set-up parameters, parameter map type 2 (D_WM,
    rho_WM), 3 steps, ``v0 = [0.05, 0.05]``."""
    from glimslib_tpu_torch.optimize.adjoint import InverseProblem, param_map_for_type

    if sim is None:
        sim = atlas2d_sim(nx, ny, nz, z_slice, dtype=dtype, device=device)
    targets = _targets(sim, sim.params.as_dict(), ("conc_T2", "conc_T1", "disp"))
    names, update = param_map_for_type(2)
    ip = InverseProblem(sim, names, targets, update_fn=update)
    return ip, np.array([0.05, 0.05])
