"""The port runs without JAX (a forward run and one value_and_grad of the
inverse problem on each lane), imports nothing of it (a static scan of
every source), runs on the card by default, and never moves a CUDA
request to the CPU."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = """
import sys
import torch
from glimslib_tpu_torch.examples import adjoint_problem, brain_sim

for unstructured in (False, True):
    sim = brain_sim(n=4, dtype=torch.float64, device="cpu",
                    unstructured=unstructured)
    assert (sim.mesh.lattice_strides is None) == unstructured
    u0, c0 = sim.initial_state()
    theta = sim.make_theta(sim.params.as_dict())
    u, c, ok, newton = sim.build_simulate_fn(1, 1.0)(theta, u0, c0)
    assert bool(ok.all()) and bool(torch.isfinite(c).all())
    # one gradient of the inverse problem on each lane
    ip, v0 = adjoint_problem(n=4, unstructured=unstructured,
                             dtype=torch.float64, device="cpu")
    J, g = ip.value_and_grad(v0)
    assert J > 0 and g.shape == (2,) and all(abs(x) < float("inf") for x in g), g
jax_mods = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
            or m.startswith("jaxlib") or m.startswith("glimslib_tpu.")
            or m == "glimslib_tpu"]
print("JAX_MODULES", jax_mods)
assert not jax_mods, jax_mods
"""


def test_slice_step_runs_without_importing_jax():
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-c", _SCRIPT], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "JAX_MODULES []" in proc.stdout


def test_cuda_request_without_cuda_raises(monkeypatch):
    from glimslib_tpu_torch import config
    from glimslib_tpu_torch.examples import brain_sim

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        config.resolve_device("cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        brain_sim(n=2, device="cuda")


def test_default_device_is_cuda(monkeypatch):
    from glimslib_tpu_torch import config

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert config.resolve_device(None) == torch.device("cuda")
    assert config.resolve_device("cpu") == torch.device("cpu")


def test_unstructured_model_without_device_needs_cuda(monkeypatch):
    """TumorGrowthBrain on a non-lattice mesh, no device given: the card,
    which raises without CUDA."""
    from glimslib_tpu_torch.core.mesh import Mesh, box_mesh
    from glimslib_tpu_torch.models.tumor_growth_brain import TumorGrowthBrain

    m = box_mesh((0, 0, 0), (1, 1, 1), 2, 2, 2)
    mesh = Mesh.from_arrays(m.points, m.cells).reordered_morton()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        TumorGrowthBrain(mesh)
    assert TumorGrowthBrain(mesh, device="cpu").device == torch.device("cpu")


def _import_roots(tree):
    """Top-level package of every import and from-import in an AST, at any
    depth (inside functions and classes too)."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.lineno, node.module.split(".")[0]


def _port_sources():
    pkg = os.path.join(ROOT, "glimslib_tpu_torch")
    for dirpath, _, files in os.walk(pkg):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def test_port_sources_import_nothing_of_jax():
    """Static scan: no import of jax, jaxlib or glimslib_tpu anywhere in
    the port or chip_smoke.py, lazy imports inside functions included."""
    banned = {"jax", "jaxlib", "glimslib_tpu"}
    hits, n_files, scanned = [], 0, set()
    for path in _port_sources():
        n_files += 1
        scanned.add(os.path.relpath(path, ROOT))
        with open(path) as fh:
            tree = ast.parse(fh.read(), filename=path)
        hits += [f"{os.path.relpath(path, ROOT)}:{line} imports {root}"
                 for line, root in _import_roots(tree) if root in banned]
    assert n_files > 20
    # the sharding modules and the sharded example script among them
    assert {"glimslib_tpu_torch/parallel/__init__.py", "glimslib_tpu_torch/parallel/shard.py",
            "glimslib_tpu_torch/parallel/gspmd.py",
            "glimslib_tpu_torch/example_scripts/tumor_growth_3D_atlas_sharded.py"} <= scanned
    assert not hits, hits


def test_import_scan_sees_lazy_imports():
    tree = ast.parse("def f():\n    from glimslib_tpu.native.meshops import x\n"
                     "    import jax.numpy as jnp\n")
    assert [r for _, r in _import_roots(tree)] == ["glimslib_tpu", "jax"]


def test_reordered_rcm_matches_jax_package():
    """The port's own RCM copy gives the JAX package's permutation, points
    and cells on a small box mesh."""
    from glimslib_tpu.core.mesh import box_mesh as jax_box_mesh
    from glimslib_tpu_torch.core.mesh import box_mesh

    want = jax_box_mesh((0, 0, 0), (1, 2, 1), 4, 5, 3).reordered_rcm()
    got = box_mesh((0, 0, 0), (1, 2, 1), 4, 5, 3).reordered_rcm()
    np.testing.assert_array_equal(got.points, want.points)
    np.testing.assert_array_equal(got.cells, want.cells)

    from glimslib_tpu.native.meshops import rcm_permutation as jax_rcm
    from glimslib_tpu_torch.native.meshops import rcm_permutation

    m = box_mesh((0, 0, 0), (1, 1, 1), 3, 4, 2)
    np.testing.assert_array_equal(rcm_permutation(m.cells, m.n_nodes),
                                  jax_rcm(m.cells, m.n_nodes))
