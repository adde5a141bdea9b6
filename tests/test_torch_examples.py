"""The example scripts on the port (``glimslib_tpu_torch/example_scripts``),
each run in-process through its ``main()`` on the CPU at f64 at the
smallest size its arguments allow, against the reference script's own
checks (which each ``main`` holds: the comparisons' errornorms below
1e-9, the reloaded series equal, the recovery limits) and what it returns.
``tumor_growth_2D_uniform`` and ``tumor_growth_2D_uniform_adjoint`` are
also held against the JAX package's ``TumorGrowth`` and
``InverseProblem`` built on the same mesh with the same settings: final c
and u and J at x0 to rel 1e-10, the gradient at x0 to rel 1e-9 (through
the JAX API: the JAX scripts reconfigure jax at import).  Torch is pinned to one thread,
as tests/test_torch_workflow_quad.py does."""

import importlib
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from glimslib_tpu.core.mesh import rectangle_mesh as jax_rectangle_mesh
from glimslib_tpu.models.tumor_growth import TumorGrowth as JaxTumorGrowth
from glimslib_tpu.optimize import adjoint as jax_adjoint
from glimslib_tpu_torch.example_scripts import RUNS
from glimslib_tpu_torch.example_scripts.example_config import (
    BoundaryAll, gaussian_iv, labelled_slice_vtu, synthetic_atlas_path,
)
from torch_threads import one_torch_thread  # noqa: E402,F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F64 = torch.float64
PARITY_RTOL = 1e-10
# the gradient at x0: both packages stop Newton at the f64 default
# newton_rtol 1e-9, so their forward states, which the adjoint solves
# take as data, agree to about that; measured 7.6e-11 to 3.7e-10 at n = 6
# to 12 (J 3.6e-11 to 6.6e-11)
GRAD_RTOL = 1e-9
SMALL_ATLAS = ["--atlas", "20", "18", "6", "--z", "3"]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _jax_uniform_sim(n, coupling, seed_width):
    mesh = jax_rectangle_mesh((-5, -5), (5, 5), n, n)
    sim = JaxTumorGrowth(mesh, dtype=jnp.float64)
    sim.setup_global_parameters(
        boundaries={"boundary_all": BoundaryAll()},
        dirichlet_bcs={"clamped_boundary": {"bc_value": np.zeros(2),
                                            "named_boundary": "boundary_all",
                                            "subspace_id": 0}})
    sim.setup_model_parameters(
        iv_expression={0: np.zeros(2), 1: gaussian_iv((0.0, 0.0), width=seed_width)},
        diffusion=0.1, coupling=coupling, proliferation=0.1, E=0.001, poisson=0.45,
        sim_time=5, sim_time_step=1)
    return sim


def _check_uniform(out, tmp_path):
    """The JAX TumorGrowth of examples/tumor_growth_2D_uniform.py at the
    same n: final c and u to rel 1e-10; the plots under the reference's
    names (a PNG a subspace a recorded step; postprocess plot_all's
    reference and deformed figures)."""
    sim = _jax_uniform_sim(10, 1.0, 1.0 / np.sqrt(2))
    sol = sim.run(save_method=None, plot=False, output_dir=str(tmp_path / "jax"))
    assert _rel(out["c"], sol[1]) <= PARITY_RTOL
    assert _rel(out["u"], sol[0]) <= PARITY_RTOL
    steps = range(6)
    plots = os.path.join(out["output_path"], "plots")
    assert sorted(os.listdir(plots)) == sorted(
        f"{nm}_{rs:04d}.png" for nm in ("concentration", "displacement") for rs in steps)
    pp = os.path.join(out["output_path"], "postprocess", "plots")
    assert sorted(f for f in os.listdir(pp) if f.endswith(".png")) == sorted(
        f"{k}_{tag}_{rs:04d}.png" for k in ("conc", "disp")
        for tag in ("reference", "deformed") for rs in steps)
    for d in (plots, pp):
        assert all(os.path.getsize(os.path.join(d, f)) > 0 for f in os.listdir(d)
                   if f.endswith(".png"))


def _check_adjoint(out, tmp_path):
    """J and the gradient at x0 (L-BFGS-B's first call) against the JAX
    InverseProblem of examples/tumor_growth_2D_uniform_adjoint.py at the
    same n, its targets from the JAX model, rel 1e-10 and GRAD_RTOL;
    recovery within the reference's 1e-2."""
    sim = _jax_uniform_sim(8, 0.2, 1.0)
    names, update = jax_adjoint.tumor_growth_param_map(3)
    theta = sim.make_theta({**sim.params.as_dict(), **update(np.array([0.1, 0.1, 0.2]))})
    iv = sim.params.create_initial_value_function()
    u_traj, c_traj, ok, _ = jax.jit(sim.build_simulate_fn(5, 1.0))(
        theta, jnp.asarray(iv[0]), jnp.asarray(iv[1]))
    assert bool(np.asarray(ok).all())
    ip = jax_adjoint.InverseProblem(
        sim, names, {"conc": np.asarray(c_traj[-1]), "disp": np.asarray(u_traj[-1])},
        update_fn=update)
    J, g = ip.value_and_grad(np.full(3, 0.05))
    assert abs(out["J0"] - float(J)) <= PARITY_RTOL * abs(float(J))
    assert _rel(out["grad0"], g) <= GRAD_RTOL
    assert (out["rel_errors"] < 1e-2).all()


def _check_fields(out, tmp_path):
    assert np.isfinite(out["c"]).all() and np.isfinite(out["u"]).all()
    assert out["c"].max() > 0.1


def _check_subdomains(out, tmp_path):
    _check_fields(out, tmp_path)
    assert sorted(os.listdir(os.path.join(out["output_path"], "plots"))) == sorted(
        f"{nm}_{rs:04d}.png" for nm in ("concentration", "displacement")
        for rs in range(11))


def _check_recovered(out, tmp_path):
    assert (out["rel_errors"] < out.get("rtol", 1e-2)).all(), out["rel_errors"]
    assert out["J"] < out["J0"]


def _check_reduced(out, tmp_path):
    """The reduced slice of a 20 x 18 x 6 atlas leaves the tumour little
    tissue: the script asserts nothing (as the reference's), and
    L-BFGS-B cuts J by an order of magnitude."""
    assert out["cells"][1] < out["cells"][0]
    assert out["J"] < 0.1 * out["J0"] and np.isfinite(out["grad0"]).all()


def _check_comparison(out, tmp_path):
    assert out["rtol"] == 1e-9
    assert (out["columns"]["errornorm_concentration"] < 1e-9).all()
    assert list(out["columns"]["recording_step"]) == [0, 1, 2]


def _check_workflow(out, tmp_path):
    assert set(out["params"]) == {"D_WM", "rho_WM"}
    assert all(0.005 <= v <= 0.5 for v in out["params"].values())


def _check_atlas_workflow(out, tmp_path):
    """L-BFGS-B moves each parameter from its start (0.05) toward the
    truth (0.1); the script asserts no limit on a slice this small."""
    _check_workflow(out, tmp_path)
    assert all(abs(v - 0.1) < 0.05 for v in out["params"].values()), out["params"]
    assert os.path.exists(out["summary"])


def _check_config(out, tmp_path):
    assert out["tissues"] == [0, 1, 2, 3, 4] and os.path.exists(out["atlas"])


def _check_convert(out, tmp_path):
    """The store holds the VTU's mesh and subdomains."""
    from glimslib_tpu_torch.utils import data_io as dio
    from glimslib_tpu_torch.utils.vtk_utils import read_vtu

    pts, cells, _, cell_data = read_vtu(str(tmp_path / "slice.vtu"))
    mesh, subdomains, _ = dio.read_mesh_hdf5(out["path"])
    assert out["path"].endswith(".npz")
    np.testing.assert_array_equal(mesh.points, pts[:, :2])
    np.testing.assert_array_equal(mesh.cells, cells)
    np.testing.assert_array_equal(subdomains, cell_data["subdomains"])


def _check_sharded(out, tmp_path):
    """Two gloo ranks: both shard in mode 'bell' and hold the same
    replicated fields, equal to the same model run unsharded in this
    process to atol 1e-11; rank 0 alone wrote the per-step VTUs, the
    series store and the postprocessed VTUs; each rank held half the
    blocks."""
    from glimslib_tpu_torch.example_scripts import tumor_growth_3D_atlas_sharded as m

    r0, r1 = out["ranks"]
    assert (r0["world"], r0["sharding_mode"], r1["sharding_mode"]) == (2, "bell", "bell")
    assert np.array_equal(r0["c"], r1["c"]) and np.array_equal(r0["u"], r1["u"])
    sim = m.build_model(out["store"], F64, "cpu")
    sol = sim.run(save_method=None, plot=False, output_dir=str(tmp_path / "whole"))
    np.testing.assert_allclose(out["c"], sol[1], rtol=0, atol=1e-11)
    np.testing.assert_allclose(out["u"], sol[0], rtol=0, atol=1e-11)
    assert 0.1 < out["final_max_c"] <= 1.0
    d = os.path.dirname(out["store"])
    files = os.listdir(d)
    assert "solution.pvd" in files and "solution_timeseries.npz" in files
    assert sum(f.startswith("solution_") and f.endswith(".vtu") for f in files) == 6
    assert len([f for f in os.listdir(os.path.join(d, "postprocess"))
                if f.endswith(".vtu")]) == 6
    nb = sim._get_bell_plan().nb
    assert r0["blocks"] == r1["blocks"] == (nb // 2, nb)
    assert r0["bell_bmv_launches"] == {}  # CPU tensors: the plain contraction


def _convert_argv(tmp_path):
    atlas = synthetic_atlas_path(str(tmp_path), 20, 18, 6)
    src = labelled_slice_vtu(str(tmp_path / "slice.vtu"), atlas, 3)
    return [src, str(tmp_path / "slice.h5")]


# script -> (argv, check): the smallest size each script's arguments allow
CASES = {
    "example_config": ([], _check_config),
    "tumor_growth_2D_uniform": (["--n", "10"], _check_uniform),
    "tumor_growth_2D_subdomains": (["--n", "8"], _check_subdomains),
    "tumor_growth_2D_uniform_reload": (["--n", "8"], _check_fields),
    "tumor_growth_2D_uniform_adjoint": (["--n", "8"], _check_adjoint),
    # the reference script's limit (0.5 below n = 25) fails at n = 8
    "tumor_growth_2D_uniform_adjoint_noise": (["--n", "10"], _check_recovered),
    "tumor_growth_2D_uniform_adjoint_reloaded": (["--n", "8"], _check_recovered),
    "tumor_growth_2D_uniform_adjoint_custom_minimizer": (["--n", "8"], _check_recovered),
    "comparison_2D_atlas": (SMALL_ATLAS, _check_comparison),
    "comparison_3D_atlas": (["--atlas", "8", "8", "6"], _check_comparison),
    "tumor_growth_3D_atlas_sharded": (["--atlas", "10", "10", "6", "--ranks", "2",
                                       "--backend", "gloo", "--save-method", "vtk"],
                                      _check_sharded),
    "brain_2D_atlas_reduced_domain_adjoint": (SMALL_ATLAS, _check_reduced),
    "atlas_optimization_workflow": (["--atlas", "20", "20", "8", "--z", "4",
                                     "--maxiter", "8"], _check_atlas_workflow),
    "patient_optimization_workflow": (["--maxiter", "3"], _check_workflow),
    "convert_vtu_mesh_to_hdf5": (None, _check_convert),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_example_script(name, tmp_path):
    argv, check = CASES[name]
    if argv is None:
        argv = _convert_argv(tmp_path)
    module = importlib.import_module(f"glimslib_tpu_torch.example_scripts.{name}")
    out = module.main(argv, device="cpu", dtype=F64, out_dir=str(tmp_path / "out"))
    check(out, tmp_path)


@pytest.mark.parametrize("name", [
    "tumor_growth_2D_uniform", "tumor_growth_2D_uniform_adjoint", "comparison_3D_atlas",
    "tumor_growth_3D_atlas_sharded", "brain_2D_atlas_reduced_domain_adjoint",
    "atlas_optimization_workflow", "patient_optimization_workflow"])
def test_example_script_runs_on_the_card_by_default(name, tmp_path, monkeypatch):
    """No device given: the card, which raises without CUDA (no silent
    move to the CPU); --device on the command line is the same request."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    module = importlib.import_module(f"glimslib_tpu_torch.example_scripts.{name}")
    with pytest.raises(RuntimeError, match="cuda"):
        module.main([], out_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="cuda"):
        module.main(["--device", "cuda"], out_dir=str(tmp_path))


def test_every_reference_example_has_a_port_script():
    """One port script per examples/*.py, each run by the runner and
    tested above."""
    ref = {f[:-3] for f in os.listdir(os.path.join(ROOT, "examples")) if f.endswith(".py")}
    port = {f[:-3] for f in os.listdir(os.path.join(
        ROOT, "glimslib_tpu_torch", "example_scripts"))
        if f.endswith(".py") and not f.startswith("_")}
    assert port == ref
    assert {name for name, _ in RUNS} == port == set(CASES)
