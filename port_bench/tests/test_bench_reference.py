"""The plain reference against the port at a tiny size in float64 on the
CPU, and what the benchmark's processes load.

The harness runs here on the CPU only through ``harness.run(device=
"cpu")``; ``run.py``, the measurement path, refuses a machine without
a card.
"""

import os
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from port_bench import harness

ROOT = Path(__file__).resolve().parents[2]
# the port in float64 solves to 1e-12; the quad model's P2 residuals and
# the reference's degree-7 rule agree to rounding; the reference's
# gradient is a central difference of relative step 1e-4
F64_LIMITS = {
    "lattice64.forward": (4, {"c_err": 1e-12, "u_err": 1e-12}),
    "quad32.forward": (3, {"c_err": 1e-8, "u_err": 1e-8}),
    "quad32.inverse": (3, {"J_err": 1e-8, "grad_err": 1e-6}),
}


def _tiny_run(workload, seed, n, dtype="float64", seconds=0.3):
    return harness.run(workload, seed, seconds, False, time.perf_counter(), device="cpu",
                       cfg_override={"voxels_per_side": n, "dtype": dtype})


@pytest.mark.parametrize("workload", sorted(F64_LIMITS))
def test_reference_agrees_with_the_port_in_f64(workload):
    torch.set_num_threads(min(4, torch.get_num_threads()))
    n, limits = F64_LIMITS[workload]
    result = _tiny_run(workload, 2 ** 31 + 11, n)
    assert result["failed"] == 0 and result["attempted"] >= 1
    for name, limit in limits.items():
        assert result["checks"][name]["value"] <= limit, (name, result["checks"][name])


def _modules_after(code):
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=600,
                         env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stderr[-2000:]
    return set(out.stdout.split())


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "glimslib_tpu_torch_not_a_module", None)
    assert "glimslib_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "glimslib_tpu.fake", None)
    assert "glimslib_tpu" in harness.forbidden_modules()


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = (
        "import sys, time, torch\n"
        "torch.set_num_threads(2)\n"
        "from port_bench import harness\n"
        "harness.run('quad32.inverse', 3, 0.2, True, time.perf_counter(), device='cpu',\n"
        "            cfg_override={'voxels_per_side': 3})\n"
        "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))\n")
    top = _modules_after(code)
    assert "glimslib_tpu_torch" in top
    assert not top & {"jax", "jaxlib", "flax", "glimslib_tpu"}


def test_the_reference_and_the_yardstick_load_nothing_of_the_port():
    code = (
        "import sys\n"
        "import port_bench.reference.model, port_bench.reference.inverse\n"
        "import port_bench.roofline, port_bench.loadgen, port_bench.tracing, port_bench.spec\n"
        "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))\n")
    top = _modules_after(code)
    assert not top & {"jax", "jaxlib", "flax", "glimslib_tpu", "glimslib_tpu_torch"}


def test_the_measurement_path_fails_without_a_card():
    out = subprocess.run(
        [sys.executable, "port_bench/run.py", "--workload", "lattice64.forward",
         "--seed", str(2 ** 31 + 5), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "no result" in out.stderr


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", sorted(F64_LIMITS))
def test_a_tiny_cell_on_the_card(card, workload):
    """The harness on the card at the cells' default precision (f32
    refined in f64), at a small box: the run completes and its numbers
    are finite."""
    n = {"lattice64.forward": 8, "quad32.forward": 4, "quad32.inverse": 4}[workload]
    result = harness.run(workload, 2 ** 31 + 21, 1.0, True, time.perf_counter(),
                         device=str(card), cfg_override={"voxels_per_side": n})
    assert result["failed"] == 0 and result["device"]["busy_s"] > 0
    assert all(v["value"] == v["value"] for v in result["checks"].values())
