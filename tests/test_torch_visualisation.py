"""The port's visualisation/ against the JAX package's: the numpy helpers
give the same outputs (max abs 1e-12, NaN where JAX has NaN), the drawing
functions and ``Plotting.plot_all`` write non-empty PNGs under the JAX
package's names, ``run(plot=True)`` writes the file names the JAX run
writes, and without matplotlib every port module imports while
``run(plot=True)`` raises ImportError before any step or output file."""

import inspect
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from glimslib_tpu.core.mesh import rectangle_mesh as jax_rectangle_mesh
from glimslib_tpu.models.tumor_growth import TumorGrowth as JaxTumorGrowth
from glimslib_tpu.visualisation import helpers as jax_helpers
from glimslib_tpu.visualisation import plotting as jax_plotting
from glimslib_tpu_torch import examples
from glimslib_tpu_torch.core.mesh import rectangle_mesh
from glimslib_tpu_torch.visualisation import helpers, plotting
from torch_threads import one_torch_thread  # noqa: E402,F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _mesh_and_fields(n=7):
    """The same rectangle in both packages, a scalar and a vector field."""
    mesh, mesh_j = rectangle_mesh((-5, -5), (5, 5), n, n), jax_rectangle_mesh(
        (-5, -5), (5, 5), n, n)
    x = mesh.points
    c = np.exp(-(x ** 2).sum(axis=1) / 4.0)
    u = np.stack([np.sin(x[:, 0]), x[:, 0] * x[:, 1] / 25.0], axis=1)
    return mesh, mesh_j, c, u


def _close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    assert np.abs(got[ok] - want[ok]).max(initial=0.0) <= 1e-12


def test_triangulation_and_grid_interpolation_match_jax():
    mesh, mesh_j, c, u = _mesh_and_fields()
    tri, tri_j = helpers.mesh_to_triangulation(mesh), jax_helpers.mesh_to_triangulation(mesh_j)
    np.testing.assert_array_equal(tri.triangles, tri_j.triangles)
    _close(tri.x, tri_j.x)
    _close(tri.y, tri_j.y)
    for vals in (c, u):
        got = helpers.interpolate_to_grid(mesh, vals, 13, 11)
        want = jax_helpers.interpolate_to_grid(mesh_j, vals, 13, 11)
        _close(got[0], want[0])
        _close(got[1], want[1])
        _close(got[2], want[2])
    # outside the hull griddata gives NaN: a grid wider than the mesh
    wide = rectangle_mesh((-5, -5), (5, 5), 3, 3)
    wide.points[0] += 0.5
    want = jax_helpers.interpolate_to_grid(wide, np.arange(16.0), 9, 9)[2]
    assert np.isnan(want).any()
    _close(helpers.interpolate_to_grid(wide, np.arange(16.0), 9, 9)[2], want)
    with pytest.raises(ValueError, match="2D"):
        helpers.mesh_to_triangulation(examples.brain_sim(n=2, device="cpu").mesh)


def test_midpoint_normalize_and_value_range_match_jax():
    _, _, c, _ = _mesh_and_fields()
    v = c - 0.3
    for kw in ({}, {"vmin": -0.5, "vmax": 2.0, "midpoint": 0.25}):
        got = helpers.MidpointNormalize(**kw)
        want = jax_helpers.MidpointNormalize(**kw)
        if not kw:
            got.vmin, got.vmax = want.vmin, want.vmax = float(v.min()), float(v.max())
        _close(got(v), want(v))
        assert (got.vmin, got.vmax, got.midpoint) == (want.vmin, want.vmax, want.midpoint)
    assert isinstance(helpers.MidpointNormalize(), jax_helpers.mcolors.Normalize)
    for pct in (None, 5):
        _close(helpers.get_value_range(v, pct), jax_helpers.get_value_range(v, pct))


def test_midpoint_normalize_is_the_reference_code():
    """Defined at first use (so helpers imports without matplotlib), with
    the JAX package's method bodies, dedented."""
    for name in ("__init__", "__call__"):
        got = textwrap.dedent(inspect.getsource(getattr(helpers.MidpointNormalize, name)))
        want = textwrap.dedent(inspect.getsource(getattr(jax_helpers.MidpointNormalize, name)))
        assert got == want, name


def _draw(pkg, mesh, c, u, out):
    p = pkg
    img = np.add.outer(np.arange(12.0), np.arange(10.0))
    seg = (img > 8).astype(np.float64) + (img > 14)
    return sorted(os.path.basename(x) for x in (
        p.plot_scalar_field(mesh, c, path=os.path.join(out, "scalar.png"), title="c",
                            range_f=(0.0, 1.0), exclude_below=0.05),
        p.plot_scalar_field(mesh, c - 0.5, path=os.path.join(out, "centred.png"),
                            cmap_ref=0.0, exclude_around=(0.0, 0.01)),
        p.plot_vector_field(mesh, u, path=os.path.join(out, "quiver.png")),
        p.plot_vector_field(mesh, u, path=os.path.join(out, "stream.png"), mode="stream",
                            n_grid=12),
        p.show_img_seg_f(img, seg, c, mesh=mesh, path=os.path.join(out, "overlay.png"),
                         origin=(-5, -5), spacing=(1, 1), range_f=[0, 1]),
        p.plot_displacement(img, seg, u, "u", mesh=mesh, path=os.path.join(out, "disp.png")),
        p.plot_proliferation(img, seg, c, "p", mesh=mesh, path=os.path.join(out, "prolif.png")),
    ))


def test_drawing_functions_write_the_jax_packages_files(tmp_path):
    mesh, mesh_j, c, u = _mesh_and_fields()
    got = _draw(plotting, mesh, c, u, str(tmp_path / "port"))
    want = _draw(jax_plotting, mesh_j, c, u, str(tmp_path / "jax"))
    assert got == want == sorted(os.listdir(tmp_path / "port"))
    assert all(os.path.getsize(tmp_path / "port" / f) > 0 for f in got)


def _plotting_names(pkg_sim, tmp, plotting_cls):
    pkg_sim.run(save_method=None, plot=False, output_dir=str(tmp / "run"))
    p = plotting_cls(pkg_sim.results, output_dir=str(tmp / "plots"))
    for rs in pkg_sim.results.get_recording_steps():
        p.plot_all(rs)
    return sorted(os.listdir(tmp / "plots"))


def _jax_rect_sim(n):
    sim = JaxTumorGrowth(jax_rectangle_mesh((-5, -5), (5, 5), n, n), dtype=jnp.float64)
    sim.setup_global_parameters(
        boundaries={"boundary_all": examples._Boundary()},
        dirichlet_bcs={"clamped_boundary": {"bc_value": np.zeros(2),
                                            "named_boundary": "boundary_all",
                                            "subspace_id": 0}})
    sim.setup_model_parameters(
        iv_expression={0: np.zeros(2), 1: lambda x: np.exp(-(x ** 2).sum(axis=1))},
        diffusion=0.1, coupling=1.0, proliferation=0.1, E=0.001, poisson=0.45,
        sim_time=5, sim_time_step=1)
    return sim


def test_run_plot_writes_the_jax_runs_files(tmp_path):
    """run(plot=True) on the 2D rectangle (n=6, 5 steps) writes the PNGs the
    JAX run(plot=True) writes, non-empty; Plotting.plot_all and the
    postprocessor's plot_all / plot_for_pub likewise."""
    sim = examples.rect_sim(n=6, dtype=torch.float64, device="cpu")
    sim.run(save_method=None, plot=True, output_dir=str(tmp_path / "port"))
    sim_j = _jax_rect_sim(6)
    sim_j.run(save_method=None, plot=True, output_dir=str(tmp_path / "jax"))
    got = sorted(os.listdir(tmp_path / "port" / "plots"))
    assert got == sorted(os.listdir(tmp_path / "jax" / "plots"))
    assert got == sorted(f"{nm}_{rs:04d}.png" for nm in ("concentration", "displacement")
                         for rs in range(6))
    assert all(os.path.getsize(tmp_path / "port" / "plots" / f) > 0 for f in got)

    for pkg, s, d in ((sim, sim, "pp"), (sim_j, sim_j, "pp_j")):
        pp = s.init_postprocess(str(tmp_path / d))
        pp.plot_all(selection=[0, 5])
        pp.plot_all(deformed=True, selection=[5])
        pp.plot_for_pub(selection=[5])
    assert sorted(os.listdir(tmp_path / "pp")) == sorted(os.listdir(tmp_path / "pp_j"))
    assert sorted(os.listdir(tmp_path / "pp" / "pub")) == ["pub_0005.png"]


def test_plotting_plot_all_writes_the_jax_packages_files(tmp_path):
    sim = examples.rect_sim(n=5, dtype=torch.float64, device="cpu")
    sim_j = _jax_rect_sim(5)
    got = _plotting_names(sim, tmp_path / "port", plotting.Plotting)
    want = _plotting_names(sim_j, tmp_path / "jax", jax_plotting.Plotting)
    assert got == want and len(got) == 12
    assert all(os.path.getsize(tmp_path / "port" / "plots" / f) > 0 for f in got)


def test_3d_run_plots_nothing(tmp_path):
    sim = examples.brain_sim(n=2, dtype=torch.float64, device="cpu")
    sim.params.sim_time = 1
    sim.run(save_method=None, plot=True, output_dir=str(tmp_path))
    assert "plots" not in os.listdir(tmp_path)


_NO_MATPLOTLIB = """
import importlib, os, pkgutil, sys
sys.modules["matplotlib"] = None
import torch
import glimslib_tpu_torch
import glimslib_tpu_torch.simulation_helpers as sh
names = [m.name for m in pkgutil.walk_packages(glimslib_tpu_torch.__path__,
                                               "glimslib_tpu_torch.")]
for name in names:
    importlib.import_module(name)
print("IMPORTED", len(names))
from glimslib_tpu_torch import examples
out = sys.argv[1]
sim = examples.rect_sim(n=4, dtype=torch.float64, device="cpu")
try:
    sim.run(save_method="vtk", plot=True, output_dir=out)
except ImportError as err:
    assert "matplotlib" in str(err), err
    assert not os.path.exists(out), os.listdir(out)
    assert not hasattr(sim, "results") and "newton_iters" not in sim.solver_info
    print("REFUSED", err)
sim.run(save_method=None, plot=False, output_dir=out)
pp = sim.init_postprocess(out)
try:
    pp.plot_all()
except ImportError as err:
    assert "matplotlib" in str(err), err
    print("PLOT_ALL_REFUSED")
assert not [m for m in sys.modules if m == "jax" or m.startswith(("jax.", "glimslib_tpu."))]
"""


def test_without_matplotlib_modules_import_and_plotting_refuses(tmp_path):
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-c", _NO_MATPLOTLIB, str(tmp_path / "out")],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "REFUSED" in proc.stdout and "PLOT_ALL_REFUSED" in proc.stdout
    n = int(proc.stdout.split("IMPORTED")[1].split()[0])
    assert n > 60
