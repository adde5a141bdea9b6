"""Port parity for the results layer: ``Simulation.run``'s recording, the
per-step output (VTU + PVD, XDMF), the series store and the mesh and
function store, and the image <-> function conversions of
glimslib_tpu_torch against the JAX package, at f64 on the CPU.

The stores are ``.npz`` archives in the port and HDF5 files in the JAX
package: the same keys (HDF5 dataset paths, with the attributes as keys
beside them) and the same values, exactly.  Round trips are exact;
recorded fields agree to rel-L2 1e-8 (both packages converge the same
system to tight tolerances).
"""

import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from glimslib_tpu.core.functionspace import FunctionSpace as JaxFunctionSpace
from glimslib_tpu.core.mesh import box_mesh as jax_box_mesh
from glimslib_tpu.core.mesh import rectangle_mesh as jax_rectangle_mesh
from glimslib_tpu.core.results import Results as JaxResults
from glimslib_tpu.models.tumor_growth import TumorGrowth as JaxTumorGrowth
from glimslib_tpu.optimize.lbfgsb import OptimizationProgress as JaxProgress
from glimslib_tpu.solvers.coupled import StepConfig as JaxStepConfig
from glimslib_tpu.utils import data_io as jax_dio
from glimslib_tpu.utils import image_io as jax_image_io
from glimslib_tpu_torch import examples
from glimslib_tpu_torch.core.functionspace import FunctionSpace
from glimslib_tpu_torch.core.mesh import box_mesh, rectangle_mesh
from glimslib_tpu_torch.core.results import Results
from glimslib_tpu_torch.optimize.lbfgsb import OptimizationProgress
from glimslib_tpu_torch.solvers.coupled import StepConfig
from glimslib_tpu_torch.utils import data_io, image_io, vtk_utils
from torch_threads import one_torch_thread  # noqa: E402,F401

TIGHT = dict(newton_rtol=1e-10, newton_atol=1e-14, cg_rtol=1e-12)
NAMES = {0: "displacement", 1: "concentration"}


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300)


class Boundary:
    def inside(self, x, on_boundary):
        return on_boundary


def _jax_rect_sim(n):
    """The JAX package's model of examples.rect_sim (uniform)."""
    mesh = jax_rectangle_mesh((-5, -5), (5, 5), n, n)
    sim = JaxTumorGrowth(mesh, dtype=jnp.float64)
    sim.setup_global_parameters(
        boundaries={"boundary_all": Boundary()}, von_neumann_bcs={},
        dirichlet_bcs={"clamped_boundary": {"bc_value": np.zeros(2),
                                            "named_boundary": "boundary_all",
                                            "subspace_id": 0}})
    sim.setup_model_parameters(
        iv_expression={0: np.zeros(2), 1: lambda x: np.exp(-(x ** 2).sum(axis=1))},
        diffusion=0.1, coupling=1.0, proliferation=0.1, E=0.001, poisson=0.45,
        sim_time=5, sim_time_step=1)
    return sim


def _h5_as_keys(path):
    """An HDF5 file as {dataset path or group/attribute: array}."""
    import h5py

    out = {}
    with h5py.File(path, "r") as f:
        def visit(name, obj):
            if isinstance(obj, h5py.Dataset):
                out[name] = obj[...]
            for a, v in obj.attrs.items():
                out[f"{name}/{a}"] = np.asarray(v)
        f.visititems(visit)
    return out


def _assert_store_equal(npz_path, h5_path):
    with np.load(npz_path) as z:
        got = {k: z[k] for k in z.files}
    want = _h5_as_keys(h5_path)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_run_records_and_stores_like_jax(tmp_path):
    """run(keep_nth=2, save_method="vtk") on the 8 x 8 rectangle, 5 steps:
    t=0 and steps 2 and 4 recorded with the JAX package's times and step
    numbers, fields within 1e-8, the PVD series identical, the same VTU
    files, the series store equal in layout to the JAX package's HDF5
    one; it reloads exactly; it returns ``sim.solution``, the final state,
    equal to the JAX package's within 1e-8."""
    sim = examples.rect_sim(n=8, dtype=torch.float64, device="cpu")
    sim.step_config = StepConfig(**TIGHT)
    sol = sim.run(keep_nth=2, save_method="vtk", output_dir=str(tmp_path / "port"))
    assert sol is sim.solution and sol[1].shape == (81,)
    assert sim.solver_info["newton_iters"].shape == (5,)

    sim_j = _jax_rect_sim(8)
    sim_j.step_config = JaxStepConfig(**TIGHT, rd_modified_newton=False)
    sol_j = sim_j.run(keep_nth=2, save_method="vtk", output_dir=str(tmp_path / "jax"))
    for sid in (0, 1):
        assert _rel(sol[sid], sol_j[sid]) <= 1e-8

    res, res_j = sim.results, sim_j.results
    assert res.get_recording_steps() == res_j.get_recording_steps() == [0, 1, 2]
    series, series_j = (r.data.get_time_series("solution") for r in (res, res_j))
    for rs in [0, 1, 2]:
        obs, obs_j = series.get_observation(rs), series_j.get_observation(rs)
        assert (obs.time, obs.time_step) == (obs_j.time, obs_j.time_step)
        for sid in (0, 1):
            assert _rel(obs.fields[sid], obs_j.fields[sid]) <= 1e-8
    for rs in (0, 1, 2):
        _, _, pd, _ = vtk_utils.read_vtu(str(tmp_path / "port" / f"solution_{rs:06d}.vtu"))
        _, _, pd_j, _ = vtk_utils.read_vtu(str(tmp_path / "jax" / f"solution_{rs:06d}.vtu"))
        assert sorted(pd) == sorted(pd_j) == ["concentration", "displacement"]
        for k in pd:
            assert _rel(pd[k], pd_j[k]) <= 1e-8
    with open(tmp_path / "port" / "solution.pvd") as f, \
            open(tmp_path / "jax" / "solution.pvd") as f_j:
        assert f.read() == f_j.read()

    store = str(tmp_path / "port" / "solution_timeseries.npz")
    assert os.path.exists(store)
    with np.load(store) as z:
        keys = set(z.files)
    assert keys == set(_h5_as_keys(str(tmp_path / "jax" / "solution_timeseries.h5")))
    sim2 = examples.rect_sim(n=8, dtype=torch.float64, device="cpu")
    sim2.reload_from_hdf5(store)
    for rs in [0, 1, 2]:
        obs, obs2 = series.get_observation(rs), sim2.results.data.get_time_series(
            "solution").get_observation(rs)
        assert (obs.time, obs.time_step, obs.recording_step) == (
            obs2.time, obs2.time_step, obs2.recording_step)
        for sid in (0, 1):
            np.testing.assert_array_equal(obs2.fields[sid], obs.fields[sid])


def _results_pair(tmp_path):
    """Both packages' Results on one 4 x 3 rectangle with the same three
    recorded steps."""
    rng = np.random.default_rng(0)
    mesh, mesh_j = rectangle_mesh((0, 0), (2, 1), 4, 3), jax_rectangle_mesh((0, 0), (2, 1), 4, 3)
    fs, fs_j = FunctionSpace(mesh), JaxFunctionSpace(mesh_j)
    for f in (fs, fs_j):
        f.init_function_space([(1, 1), (0, 1)], NAMES)
    res = Results(fs, output_dir=str(tmp_path / "port"))
    res_j = JaxResults(fs_j, output_dir=str(tmp_path / "jax"))
    for rs in range(3):
        fields = {0: rng.standard_normal((mesh.n_nodes, 2)),
                  1: rng.standard_normal(mesh.n_nodes)}
        for r in (res, res_j):
            r.add_to_results(0.5 * rs, 2 * rs, rs, fields)
    return res, res_j


@pytest.mark.parametrize("method", ["vtk", "xdmf"])
def test_per_step_output_equals_jax(tmp_path, method):
    """save_solution_start / save_solution / save_solution_end write the
    JAX package's files byte for byte (XDMF: the index identically, the
    HDF5 heavy data with the same datasets)."""
    res, res_j = _results_pair(tmp_path)
    for r in (res, res_j):
        r.save_solution_start(method=method)
        for rs in r.get_recording_steps():
            r.save_solution(rs, 0.5 * rs, method=method)
        r.save_solution_end(method=method)
    files = sorted(os.listdir(tmp_path / "port"))
    assert files == sorted(os.listdir(tmp_path / "jax"))
    assert files == (["solution.pvd"] + [f"solution_{i:06d}.vtu" for i in range(3)]
                     if method == "vtk" else ["solution.h5", "solution.xdmf"])
    for name in files:
        if name.endswith(".h5"):
            assert _h5_as_keys(str(tmp_path / "port" / name)).keys() == \
                _h5_as_keys(str(tmp_path / "jax" / name)).keys()
            continue
        with open(tmp_path / "port" / name, "rb") as f, \
                open(tmp_path / "jax" / name, "rb") as f_j:
            assert f.read() == f_j.read(), name


def test_series_store_round_trip_and_layout(tmp_path):
    """The series store holds the JAX package's HDF5 datasets and
    attributes as keys, value for value, and a fresh Results reloads it
    exactly; the Orbax checkpoint raises, naming the store."""
    res, res_j = _results_pair(tmp_path)
    path = res.save_solution_hdf5()
    assert path == str(tmp_path / "port" / "solution_timeseries.npz")
    _assert_store_equal(path, res_j.save_solution_hdf5())
    fresh = Results(res._functionspace, output_dir=str(tmp_path))
    fresh.load_solution_hdf5(path)
    assert fresh.get_recording_steps() == [0, 1, 2]
    for rs in range(3):
        obs = fresh.data.get_time_series("solution").get_observation(rs)
        assert (obs.time, obs.time_step, obs.recording_step) == (0.5 * rs, 2 * rs, rs)
        for sid in (0, 1):
            np.testing.assert_array_equal(obs.fields[sid], res.get_result(rs)[sid])
    mesh = res.data.read_mesh_hdf5(path)
    np.testing.assert_array_equal(mesh.points, res.mesh.points)
    for call in (res.save_solution_orbax, lambda: res.load_solution_orbax(path)):
        with pytest.raises(NotImplementedError, match="series store"):
            call()


def test_mesh_and_function_store_equal_jax(tmp_path):
    """save_mesh_hdf5 (lattice, subdomains, boundaries), save_functions_hdf5
    (added to, by time step) and save_function_mesh: the JAX package's
    datasets and attributes value for value; every read is exact."""
    m, m_j = box_mesh((0, 0, 0), (1, 2, 1), 2, 3, 2), jax_box_mesh((0, 0, 0), (1, 2, 1), 2, 3, 2)
    sd = np.arange(m.n_cells) % 3
    bd = np.arange(7)
    p = data_io.save_mesh_hdf5(m, str(tmp_path / "mesh.h5"), subdomains=sd, boundaries=bd)
    assert p == str(tmp_path / "mesh.npz")
    _assert_store_equal(p, jax_dio.save_mesh_hdf5(m_j, str(tmp_path / "mesh_j.h5"),
                                                  subdomains=sd, boundaries=bd))
    m2, sd2, bd2 = data_io.read_mesh_hdf5(str(tmp_path / "mesh.h5"))
    np.testing.assert_array_equal(m2.points, m.points)
    np.testing.assert_array_equal(m2.cells, m.cells)
    assert m2.lattice_strides == m.lattice_strides is not None
    np.testing.assert_array_equal(sd2, sd)
    np.testing.assert_array_equal(bd2, bd)

    rng = np.random.default_rng(1)
    f1, f2 = rng.standard_normal(m.n_nodes), rng.standard_normal((m.n_nodes, 3))
    for save, path in ((data_io.save_functions_hdf5, str(tmp_path / "f.h5")),
                       (jax_dio.save_functions_hdf5, str(tmp_path / "f_j.h5"))):
        save({"conc": f1}, path)
        save({"disp": f2}, path)
        save({"conc_t": 2 * f1}, path, time_step=3)
    _assert_store_equal(str(tmp_path / "f.npz"), str(tmp_path / "f_j.h5"))
    np.testing.assert_array_equal(data_io.read_function_hdf5("disp", str(tmp_path / "f.h5")), f2)
    np.testing.assert_array_equal(
        data_io.read_function_hdf5("conc_t", str(tmp_path / "f.h5"), time_step=3), 2 * f1)
    assert data_io.read_function_hdf5("nope", str(tmp_path / "f.h5")) is None

    lab = np.arange(m.n_nodes) % 4
    p = data_io.save_function_mesh(f1, str(tmp_path / "fm.h5"), labelfunction=lab,
                                   mesh=m, subdomains=sd)
    _assert_store_equal(p, jax_dio.save_function_mesh(
        f1, str(tmp_path / "fm_j.h5"), labelfunction=lab, mesh=m_j, subdomains=sd))
    fct, mesh, lab2, sd3 = data_io.load_function_mesh(p)
    np.testing.assert_array_equal(fct, f1)
    np.testing.assert_array_equal(mesh.cells, m.cells)
    np.testing.assert_array_equal(lab2, lab)
    np.testing.assert_array_equal(sd3, sd)


def test_vtu_round_trip_and_merge_equal_jax(tmp_path):
    """write_vtu / read_vtu round-trip exactly (ascii repr); merge_VTUs
    merges one VTU per field and step as the JAX package does."""
    mesh = rectangle_mesh((0, 0), (1, 1), 4, 3)
    rng = np.random.default_rng(0)
    pd = {"c": rng.standard_normal(mesh.n_nodes), "u": rng.standard_normal((mesh.n_nodes, 2))}
    cd = {"label": np.arange(mesh.n_cells) % 3}
    p = vtk_utils.write_vtu(str(tmp_path / "m.vtu"), mesh.points, mesh.cells, pd, cd)
    pts, cells, pd2, cd2 = vtk_utils.read_vtu(p)
    np.testing.assert_array_equal(pts[:, :2], mesh.points)
    np.testing.assert_array_equal(cells, mesh.cells)
    np.testing.assert_array_equal(pd2["c"], pd["c"])
    np.testing.assert_array_equal(pd2["u"][:, :2], pd["u"])
    np.testing.assert_array_equal(cd2["label"], cd["label"])
    assert vtk_utils.total_measure(mesh.points, mesh.cells) == pytest.approx(1.0)

    merged = {}
    for tag, dio in (("port", data_io), ("jax", jax_dio)):
        base = tmp_path / tag
        for step in (0, 1):
            for name, arr in pd.items():
                vtk_utils.write_vtu(str(base / f"{name}_{step:06d}.vtu"), mesh.points,
                                    mesh.cells, {name: arr * (step + 1)})
        out = dio.merge_VTUs(str(base), 1.0, 1.0, remove=True)
        merged[tag] = [open(f, "rb").read() for f in out]
        assert sorted(os.listdir(base)) == ["merged_000000.vtu", "merged_000001.vtu"]
    assert merged["port"] == merged["jax"]


def test_image_function_conversions_equal_jax():
    """create_fenics_function_from_image (scalar and vector, 2D and 3D),
    create_image_from_fenics_function, fct2image2D and the structured
    measures equal the JAX package's."""
    rng = np.random.default_rng(2)
    img2 = image_io.Image(rng.standard_normal((6, 7)), origin=(0.5, 1.0), spacing=(0.5, 0.25))
    img2_j = jax_image_io.Image(img2.data, origin=img2.origin, spacing=img2.spacing)
    mesh, vals = data_io.image2fct2D(img2)
    mesh_j, vals_j = jax_dio.image2fct2D(img2_j)
    np.testing.assert_array_equal(vals, vals_j)
    got = data_io.create_fenics_function_from_image(img2, mesh)
    np.testing.assert_array_equal(got, jax_dio.create_fenics_function_from_image(img2_j, mesh_j))
    np.testing.assert_allclose(got, vals, rtol=0, atol=1e-12)
    vec = image_io.Image(rng.standard_normal((6, 7, 2)), origin=img2.origin,
                         spacing=img2.spacing, is_vector=True)
    vec_j = jax_image_io.Image(vec.data, origin=vec.origin, spacing=vec.spacing,
                               is_vector=True)
    np.testing.assert_array_equal(data_io.create_fenics_function_from_image(vec, mesh),
                                  jax_dio.create_fenics_function_from_image(vec_j, mesh_j))
    im, im_j = (data_io.create_image_from_fenics_function((mesh, vals), (5, 4)),
                jax_dio.create_image_from_fenics_function((mesh_j, vals_j), (5, 4)))
    np.testing.assert_array_equal(im.data, im_j.data)
    assert im.origin == im_j.origin and im.spacing == im_j.spacing
    np.testing.assert_array_equal(data_io.fct2image2D((mesh, vals), 5, 4).data,
                                  jax_dio.fct2image2D((mesh_j, vals_j), 5, 4).data)
    assert data_io.get_measures_from_structured_mesh(mesh) == \
        jax_dio.get_measures_from_structured_mesh(mesh_j)
    b, b_j = box_mesh((0, 0, 0), (2, 2, 1), 3, 3, 2), jax_box_mesh((0, 0, 0), (2, 2, 1), 3, 3, 2)
    img3 = image_io.Image(rng.standard_normal((3, 4, 5)), origin=(0, 0, 0),
                          spacing=(0.5, 0.6, 0.4))
    img3_j = jax_image_io.Image(img3.data, origin=img3.origin, spacing=img3.spacing)
    np.testing.assert_array_equal(data_io.create_fenics_function_from_image(img3, b),
                                  jax_dio.create_fenics_function_from_image(img3_j, b_j))


def test_progress_columns_equal_jax_dataframe(tmp_path):
    """The optimizer's progress table: the JAX package's DataFrame columns
    under the same names and values; saved as pickle and CSV."""
    prog, prog_j = OptimizationProgress(["D_WM", "rho_WM"]), JaxProgress(["D_WM", "rho_WM"])
    for j, x, g in ((0.5, [0.05, 0.05], [-1.0, 2.0]), (0.5, [0.06, 0.04], [-0.5, 1.0]),
                    (0.1, [0.09, 0.1], [0.01, -0.02])):
        for p in (prog, prog_j):
            p.record_eval(j, x)
            p.record_grad(j, g)
    cols, df = prog.to_columns(), prog_j.to_dataframe()
    assert list(cols) == list(df.columns)
    for k in cols:
        if k != "datetime":
            np.testing.assert_array_equal(cols[k], df[k].to_numpy())
    out = prog.save(path_pkl=str(tmp_path / "p.pkl"), path_xls=str(tmp_path / "p.xls"))
    assert out is not None and os.path.exists(tmp_path / "p.pkl")
    assert open(tmp_path / "p.csv").readline().strip().split(",") == list(cols)
