"""The port runs without JAX, runs on the card by default, and never
moves a CUDA request to the CPU."""

import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = """
import sys
import torch
from glimslib_tpu_torch.examples import brain_sim

for unstructured in (False, True):
    sim = brain_sim(n=4, dtype=torch.float64, device="cpu",
                    unstructured=unstructured)
    assert (sim.mesh.lattice_strides is None) == unstructured
    u0, c0 = sim.initial_state()
    theta = sim.make_theta(sim.params.as_dict())
    u, c, ok, newton = sim.build_simulate_fn(1, 1.0)(theta, u0, c0)
    assert bool(ok.all()) and bool(torch.isfinite(c).all())
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
