"""The port's utils/profiling.py against the JAX package's: Tracer's
summary (keys and counts of the same nested scopes), run_stats of a 2D
atlas run equal to the JAX package's on the same problem, and device_trace onto
torch.profiler (a Chrome trace with the run's ops on the CPU; a CUDA
request without CUDA raises)."""

import json
import os

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from glimslib_tpu.core.mesh import Mesh as JaxMesh
from glimslib_tpu.models.tumor_growth_brain import TumorGrowthBrain as JaxBrain
from glimslib_tpu.utils import profiling as jax_profiling
from glimslib_tpu_torch import examples
from glimslib_tpu_torch.utils import profiling
from torch_threads import one_torch_thread  # noqa: E402,F401


def _scopes(tracer):
    for _ in range(3):
        with tracer.scope("forward"):
            with tracer.scope("step"):
                pass
            with tracer.scope("step"):
                pass
    with tracer.scope("inverse"):
        pass
    return tracer.summary()


def test_tracer_summary_matches_jax(tmp_path):
    got, want = _scopes(profiling.Tracer()), _scopes(jax_profiling.Tracer())
    assert list(got) == list(want) == ["forward", "forward/step", "inverse"]
    for name in want:
        assert list(got[name]) == list(want[name])
        assert got[name]["count"] == want[name]["count"]
        assert got[name]["max_s"] <= got[name]["total_s"]
    assert [got[k]["count"] for k in got] == [3, 6, 1]
    tracer = profiling.Tracer()
    _scopes(tracer)
    path = tracer.save(str(tmp_path / "tracer.json"))
    with open(path) as f:
        assert list(json.load(f)) == list(want)


def test_run_stats_matches_jax(tmp_path):
    """A 3-step run of the reduced 2D atlas (a 20 x 18 x 6 labelmap, slice
    3; the unstructured lane, where both packages take linear warm starts
    and the algebraic anchor) in both packages at f64: the same Newton
    iterations a step.  (On a lattice the JAX package warm-starts on the
    CPU, where its solves are not fused, and the port, like the JAX
    package's fused TPU path, does not.)"""
    sim = examples.atlas2d_sim(20, 18, 6, 3, dtype=torch.float64, device="cpu")
    sim.run(save_method=None, output_dir=str(tmp_path / "port"))

    sim_j = JaxBrain(JaxMesh.from_arrays(sim.mesh.points, sim.mesh.cells),
                     dtype=jnp.float64)
    sim_j.setup_global_parameters(
        label_function=sim.subdomains.label_function,
        domain_names=examples.TISSUE_MAP,
        boundaries={"boundary_all": examples._Boundary()},
        dirichlet_bcs={"clamped_boundary": {"bc_value": np.zeros(2),
                                            "named_boundary": "boundary_all",
                                            "subspace_id": 0}})
    sim_j.setup_model_parameters(iv_expression=sim.params._iv_expressions,
                                 **sim.params.as_dict())
    sim_j.run(save_method=None, plot=False, output_dir=str(tmp_path / "jax"))
    got, want = profiling.run_stats(sim), jax_profiling.run_stats(sim_j)
    assert got == want and got["steps"] == 3, (got, want)


def test_device_trace_on_the_cpu_holds_the_run(tmp_path):
    x = torch.linspace(0.0, 1.0, 64, dtype=torch.float64)
    with profiling.device_trace(str(tmp_path / "trace"), device="cpu") as prof:
        y = torch.cumsum(torch.sin(x), 0)
    assert float(y[-1]) > 0
    assert os.path.dirname(prof.trace_path) == str(tmp_path / "trace")
    with open(prof.trace_path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"aten::sin", "aten::cumsum"} <= names


@pytest.mark.parametrize("device", [None, "cuda"], ids=["default", "cuda"])
def test_device_trace_asking_for_cuda_without_a_card_raises(device, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        with profiling.device_trace(str(tmp_path / "trace"), device=device):
            pass
    assert not os.path.exists(tmp_path / "trace")
