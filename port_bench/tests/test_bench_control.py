"""The control: the port with its float64 refinement switched off
(``GLIMS_REFINE_F64=0``, float32 residuals and solves throughout), the
precision below the configuration's, read by ``port_bench/readings.py``.

On the card, at each cell's own size and on three seeds, every control
run has to fail the cell's limits (``limits/<cell>.json``).  On the CPU,
at a box a test run can hold, the number that separates the two, the
last elasticity solve's error ``el_err``, reads higher under the control
than in every sound run.  Each side runs in a process of its own: the
port reads the switch when it is imported.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from port_bench import spec

ROOT = Path(__file__).resolve().parents[2]
SEEDS = [2 ** 31 + 41, 2 ** 31 + 42, 2 ** 31 + 43]
TINY = {"lattice64.forward": 6, "quad32.forward": 6, "quad32.inverse": 6}


def _readings(workload, control, device, n=None):
    code = (
        "import json, sys, torch\n"
        "torch.set_num_threads(4)\n"
        "from port_bench.readings import readings\n"
        f"r = readings({workload!r}, {SEEDS!r}, {device!r}, "
        f"cfg_override={({'voxels_per_side': n} if n else None)!r}, "
        "log=lambda *a, **k: None)\n"
        "print(json.dumps(list(r.values())))\n")
    env = {k: v for k, v in os.environ.items() if k != "GLIMS_REFINE_F64"}
    env["PYTHONPATH"] = str(ROOT)
    if control:
        env["GLIMS_REFINE_F64"] = "0"
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=1800, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("workload", sorted(TINY))
def test_the_control_reads_higher_than_sound_runs(workload):
    sound = _readings(workload, False, "cpu", TINY[workload])
    control = _readings(workload, True, "cpu", TINY[workload])
    assert max(r["el_err"] for r in sound) < min(r["el_err"] for r in control)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("workload", sorted(TINY))
def test_the_control_fails_at_the_cells_size(card, workload):
    limits = spec.limits(workload, ROOT)
    for got in _readings(workload, True, card):
        assert any(got[name] > lim["limit"] for name, lim in limits.items()), got
