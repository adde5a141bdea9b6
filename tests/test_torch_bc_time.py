"""Von Neumann conditions and time-dependent sources, body forces and
Dirichlet values in glimslib_tpu_torch, on every operator lane, against
the JAX package and the scipy FEM (tests/reference_fem.py).

The nine cases are tests/test_bc_paths.py's six and
tests/test_time_dependent.py's three, at their sizes and parameters.
Each runs the port at f64 on the CPU on three lanes: the lattice lane
(the whole-solve branch, plain on the CPU; a block with a facet or
time-dependent term takes the gather residual), the unstructured lane
(the same mesh without its lattice structure: halo-ELL operators), and
the matrix-free jvp lane (``operator_mode = "matrix-free"``).  Each is
held to the JAX test's own checks (the scipy path where it has one) and
to the JAX package's run of the same case (on its default lane, once a
case in a module fixture: its matrix-free lane on a 2D mesh runs
``P1Kernels.elasticity_diag_blocks``, which can abort the process there,
ROADMAP §3) at rel-L2 1e-8 a recorded step.  Time-dependent
values are written once with ``jnp`` for the JAX side and once with
``torch`` for the port.
"""

import os
import sys

import numpy as np
import pytest
import jax.numpy as jnp
import scipy.sparse.linalg as spla
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from glimslib_tpu.core.mesh import rectangle_mesh as jax_rectangle_mesh  # noqa: E402
from glimslib_tpu.models.tumor_growth import TumorGrowth as JaxTumorGrowth  # noqa: E402
from glimslib_tpu.solvers.coupled import StepConfig as JaxStepConfig  # noqa: E402
from glimslib_tpu_torch.core.mesh import Mesh, rectangle_mesh  # noqa: E402
from glimslib_tpu_torch.models.tumor_growth import TumorGrowth  # noqa: E402
from glimslib_tpu_torch.solvers.coupled import StepConfig  # noqa: E402

from reference_fem import ReferenceFEM  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

TIGHT = dict(newton_rtol=1e-10, newton_atol=1e-14, cg_rtol=1e-12)
LANES = ("lattice", "unstructured", "jvp")


class All:
    def inside(self, x, on_boundary):
        return on_boundary


class Left:
    def inside(self, x, on_boundary):
        return on_boundary and x[0] < -4.999


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12)


def _ones(x):
    if torch.is_tensor(x):
        return torch.ones(x.shape[0], dtype=x.dtype, device=x.device)
    return jnp.ones(x.shape[0])


def _sim(pkg, lane, box, n, clamped=True, **setup):
    """TumorGrowth of ``pkg`` ("jax" or "torch") on rectangle_mesh(box, n,
    n) set up with the clamped displacement and ``setup``; the port's on
    ``lane``."""
    if pkg == "jax":
        sim = JaxTumorGrowth(jax_rectangle_mesh(*box, n, n))
        sim.step_config = JaxStepConfig(**TIGHT)
    else:
        mesh = rectangle_mesh(*box, n, n)
        if lane == "unstructured":
            mesh = Mesh.from_arrays(mesh.points, mesh.cells)
        sim = TumorGrowth(mesh, dtype=torch.float64, device="cpu")
        sim.step_config = StepConfig(**TIGHT)
        if lane == "jvp":
            sim.operator_mode = "matrix-free"
    bcs = dict(setup.pop("dirichlet_bcs", {}))
    if clamped:
        bcs["clamped"] = {"bc_value": np.zeros(2), "named_boundary": "boundary_all",
                          "subspace_id": 0}
    sim.setup_global_parameters(boundaries={"boundary_all": All()}, dirichlet_bcs=bcs,
                                **setup)
    return sim


def _params(sim, iv=0.0, **kw):
    p = dict(diffusion=0.1, coupling=0.0, proliferation=0.0, E=0.001, poisson=0.4,
             sim_time=2, sim_time_step=1)
    p.update(kw)
    sim.setup_model_parameters(iv_expression={0: np.zeros(2), 1: iv}, **p)


def _run(sim, tmp):
    sim.run(keep_nth=1, save_method=None, plot=False, output_dir=str(tmp))
    steps = sim.results.get_recording_steps()
    return {"steps": [(np.asarray(sim.results.get_result(k)[0]),
                       np.asarray(sim.results.get_result(k)[1])) for k in steps]}


def _gauss(x):
    return np.exp(-(x[:, 0] ** 2 + x[:, 1] ** 2))


def _labels(mesh):
    return np.where(np.linalg.norm(mesh.points, axis=1) < 2.5, 2.0, 1.0)


# -- the cases: each builds and runs one package's sim and returns its steps ---


def vn_flux_in_solve(pkg, lane, tmp):
    sim = _sim(pkg, lane, ((-5, -5), (5, 5)), 10, von_neumann_bcs={
        "influx": {"bc_value": 0.5, "named_boundary": "boundary_all", "subspace_id": 1}})
    _params(sim)
    return _run(sim, tmp)


def time_dependent_vn(pkg, lane, tmp):
    sim = _sim(pkg, lane, ((0, 0), (1, 1)), 6, von_neumann_bcs={
        "ramp": {"bc_value": lambda x, t: 0.2 * t * _ones(x),
                 "named_boundary": "boundary_all", "subspace_id": 1}})
    _params(sim)
    return _run(sim, tmp)


def dirichlet_boundary_predicate(pkg, lane, tmp):
    sim = _sim(pkg, lane, ((-5, -5), (5, 5)), 8, dirichlet_bcs={
        "conc_left": {"bc_value": 1.0, "boundary": Left(), "subspace_id": 1}})
    _params(sim, diffusion=0.2)
    return _run(sim, tmp)


def vn_subdomain_boundary_is_zero(pkg, lane, tmp):
    out = {}
    for key, vn in (("vn", {"interface_flux": {
            "bc_value": 3.0, "subdomain_boundary": "out_in", "subspace_id": 1}}),
            ("none", None)):
        mesh = jax_rectangle_mesh((-5, -5), (5, 5), 10, 10)
        sim = _sim(pkg, lane, ((-5, -5), (5, 5)), 10, label_function=_labels(mesh),
                   domain_names={1: "out", 2: "in"}, von_neumann_bcs=vn)
        _params(sim, iv=_gauss, coupling=0.1, proliferation=0.2)
        got = _run(sim, tmp / key)
        if key == "vn":
            out.update(got)
            out["n_facets"] = len(sim.bcs.von_neumann_bcs["interface_flux"]["facet_idx"])
        else:
            out["none"] = got["steps"]
    return out


def dirichlet_on_subdomain_boundary(pkg, lane, tmp):
    mesh = jax_rectangle_mesh((-5, -5), (5, 5), 10, 10)
    sim = _sim(pkg, lane, ((-5, -5), (5, 5)), 10, label_function=_labels(mesh),
               domain_names={1: "out", 2: "in"}, dirichlet_bcs={
                   "interface": {"bc_value": 0.7, "subdomain_boundary": "out_in",
                                 "subspace_id": 1}})
    _params(sim, sim_time=1)
    out = _run(sim, tmp)
    out["nodes"] = sim.subdomains.subdomain_boundary_nodes("out_in")
    return out


def vn_interior_dS(pkg, lane, tmp):
    mesh = jax_rectangle_mesh((-5, -5), (5, 5), 10, 10)
    sim = _sim(pkg, lane, ((-5, -5), (5, 5)), 10, label_function=_labels(mesh),
               domain_names={1: "out", 2: "in"}, von_neumann_bcs={
                   "interface_flux": {"bc_value": 3.0, "subdomain_boundary": "out_in",
                                      "subspace_id": 1, "measure": "dS"}})
    out = {"vn_residual": np.asarray(sim.bcs.von_neumann_residual(1)),
           "fnodes": sim.subdomains.subdomain_boundary_facet_nodes("out_in"),
           "cells": sim.subdomains.subdomain_boundary_facet_cells("out_in"),
           "n_facets": len(sim.bcs.von_neumann_bcs["interface_flux"]["facet_idx"])}
    _params(sim, iv=_gauss, coupling=0.1, proliferation=0.2)
    out.update(_run(sim, tmp))
    return out


def _td_sim(pkg, lane, **kw):
    sim = _sim(pkg, lane, ((-2, -2), (2, 2)), 8)
    _params(sim, iv=lambda x: np.exp(-(x ** 2).sum(axis=1)), **kw)
    return sim


def td_source_vs_reference(pkg, lane, tmp):
    sim = _td_sim(pkg, lane, source_term=lambda x, t: 0.3 * t * _ones(x))
    out = _run(sim, tmp / "src")
    out["iv"] = np.asarray(sim.params.create_initial_value_function()[1])
    out["none"] = _run(_td_sim(pkg, lane), tmp / "none")["steps"]
    return out


def td_body_force(pkg, lane, tmp):
    def bf(x, t):
        if torch.is_tensor(x):
            return torch.stack([1e-4 * t * _ones(x), torch.zeros_like(x[:, 0])], dim=1)
        return jnp.stack([1e-4 * t * _ones(x), jnp.zeros(x.shape[0])], axis=1)
    return _run(_td_sim(pkg, lane, body_force=bf), tmp)


def td_dirichlet_in_loop(pkg, lane, tmp):
    sim = _sim(pkg, lane, ((0, 0), (1, 1)), 6, dirichlet_bcs={
        "conc_ramp": {"bc_value": lambda x, t: 0.1 * t * np.ones(len(x)),
                      "named_boundary": "boundary_all", "subspace_id": 1}})
    _params(sim, diffusion=0.05, sim_time=3)
    return _run(sim, tmp)


CASES = {f.__name__: f for f in (
    vn_flux_in_solve, time_dependent_vn, dirichlet_boundary_predicate,
    vn_subdomain_boundary_is_zero, dirichlet_on_subdomain_boundary, vn_interior_dS,
    td_source_vs_reference, td_body_force, td_dirichlet_in_loop)}
@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """The JAX package's run of each case, once a case a worker."""
    got = {}

    def get(name):
        if name not in got:
            got[name] = CASES[name]("jax", "lattice",
                                    tmp_path_factory.mktemp(f"jax_{name}"))
        return got[name]
    return get


def _check(name, out, mesh):
    """The JAX test's own checks of case ``name`` on the port's ``out``."""
    steps = out["steps"]
    c_end = steps[-1][1]
    if name == "vn_flux_in_solve":
        # (M + dt D K) c_new = M c + dt D q ∮ φ ds, with ∮ φ_i ds = A/2 a
        # facet node
        ref = ReferenceFEM(mesh)
        M, K = ref.mass_matrix(), ref.stiffness_matrix(0.1)
        load = np.zeros(mesh.n_nodes)
        for fn, fa in zip(mesh.boundary_facet_nodes, mesh.boundary_facet_area):
            load[fn] += fa / 2.0
        c = np.zeros(mesh.n_nodes)
        for _ in range(2):
            c = spla.spsolve((M + K).tocsc(), M @ c + 0.1 * 0.5 * load)
        assert _rel(c_end, c) < 1e-9 and c_end.max() > 0
    elif name == "time_dependent_vn":
        # implicit Euler with flux 0.2 t D over perimeter 4: dm_k = dt D q(t_k) 4
        ref = ReferenceFEM(mesh)
        ones = np.ones(mesh.n_nodes)
        m1, m2 = (float(ones @ (ref.mass_matrix() @ s[1])) for s in steps[1:3])
        assert np.isclose(m1, 0.1 * 0.2 * 4.0, rtol=1e-6), m1
        assert np.isclose(m2 - m1, 0.1 * 0.4 * 4.0, rtol=1e-6), (m1, m2)
    elif name == "dirichlet_boundary_predicate":
        left = mesh.points[:, 0] < -4.999
        mid = np.abs(mesh.points[:, 0]) < 1e-9
        assert np.allclose(c_end[left], 1.0, atol=1e-10)
        assert (c_end[mid] >= -1e-3).all() and c_end.max() <= 1.0 + 1e-9
    elif name == "vn_subdomain_boundary_is_zero":
        assert out["n_facets"] == 0
        for (u, c), (u0, c0) in zip(steps, out["none"]):
            np.testing.assert_allclose(c, c0, rtol=0, atol=1e-13)
    elif name == "dirichlet_on_subdomain_boundary":
        assert len(out["nodes"]) > 0
        assert np.allclose(c_end[out["nodes"]], 0.7, atol=1e-10)
    elif name == "vn_interior_dS":
        assert out["n_facets"] > 0
        want = np.zeros(mesh.n_nodes)
        for a, b in out["fnodes"]:
            L = np.linalg.norm(mesh.points[a] - mesh.points[b])
            want[a] += 3.0 * L / 2
            want[b] += 3.0 * L / 2
        np.testing.assert_allclose(out["vn_residual"], want, rtol=1e-12, atol=1e-14)
        assert out["cells"].shape == (len(out["fnodes"]), 2) and (out["cells"] >= 0).all()
        assert np.isfinite(c_end).all()
    elif name == "td_source_vs_reference":
        # (M + dt K) c_new = M c + dt s(t) load at t = 1, 2
        ref = ReferenceFEM(mesh)
        M, K, load = ref.mass_matrix(), ref.stiffness_matrix(0.1), ref.load_vector(1.0)
        c = out["iv"]
        for t in (1.0, 2.0):
            c = spla.spsolve((M + K).tocsc(), M @ c + 0.3 * t * load)
        assert _rel(c_end, c) < 1e-8
        assert c_end.sum() > out["none"][-1][1].sum()
    elif name == "td_body_force":
        m1, m2 = (np.abs(s[0][:, 0]).max() for s in steps[1:3])
        assert m2 > 1.5 * m1 > 0
    elif name == "td_dirichlet_in_loop":
        bn = mesh.boundary_nodes
        for k in (1, 2, 3):
            assert np.allclose(steps[k][1][bn], 0.1 * k, atol=1e-10), k


@pytest.mark.parametrize("lane", LANES)
@pytest.mark.parametrize("name", list(CASES))
def test_case_on_every_lane(jax_runs, name, lane, tmp_path):
    """One case on one lane: the JAX test's checks, then every recorded
    step's u and c within rel-L2 1e-8 of the JAX package's."""
    out = CASES[name]("torch", lane, tmp_path)
    box, n = {"time_dependent_vn": (((0, 0), (1, 1)), 6),
              "td_dirichlet_in_loop": (((0, 0), (1, 1)), 6),
              "dirichlet_boundary_predicate": (((-5, -5), (5, 5)), 8),
              "td_source_vs_reference": (((-2, -2), (2, 2)), 8),
              "td_body_force": (((-2, -2), (2, 2)), 8)}.get(name, (((-5, -5), (5, 5)), 10))
    _check(name, out, rectangle_mesh(*box, n, n))
    ref = jax_runs(name)
    assert len(out["steps"]) == len(ref["steps"])
    for k, ((u, c), (u_j, c_j)) in enumerate(zip(out["steps"], ref["steps"])):
        assert _rel(c, c_j) <= 1e-8, (k, _rel(c, c_j))
        assert _rel(u, u_j) <= 1e-8, (k, _rel(u, u_j))
