#!/usr/bin/env python3
"""What reading a torch.profiler window costs, on one NVIDIA GPU.

    python3 tools/profile_cost.py

Builds the kernels, then profiles (device activity only, as
``chip_smoke.py``'s breakdowns do) four runs of the port: the n=32
unstructured box, 5 steps ([6]'s model); the N=32 box on the matrix-free
jvp lane, 2 steps ([15a]); the quad model on the N=32 lattice, 1 refined
step ([15b]); and the example script ``brain_2D_atlas_reduced_domain_adjoint``
([12]).  Each run is made once unprofiled (after one warm-up) and once
profiled; a line a run prints the unprofiled seconds, the profiled run's
body and the profiler's exit, the time to fetch the raw records
(``kineto_results.events()``) and to sum their device durations in
Python (the records, the device ones, busy ms), and the time of
``key_averages()`` over the same window with the busy ms it sums.  The
first window of the process also pays the profiler's start-up.
Nothing else runs this script.
"""

import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def measure(torch, tag, fn):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    plain = time.perf_counter() - t0
    t0 = time.perf_counter()
    p = profile(activities=[ProfilerActivity.CUDA])
    p.__enter__()
    fn()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    p.__exit__(None, None, None)
    t2 = time.perf_counter()
    evs = p.profiler.kineto_results.events()
    t3 = time.perf_counter()
    n = ncuda = 0
    busy = 0
    for e in evs:
        n += 1
        if e.device_type() == DeviceType.CUDA:
            ncuda += 1
            busy += e.duration_ns()
    t4 = time.perf_counter()
    ka = p.key_averages()
    t5 = time.perf_counter()
    busy2 = sum(float(getattr(e, "self_device_time_total", 0) or 0) for e in ka
                if getattr(e, "device_type", None) == DeviceType.CUDA)
    print(f"{tag}: unprofiled {plain:.2f} s; profiled body {t1 - t0:.2f} s, exit "
          f"{t2 - t1:.2f} s, events() {t3 - t2:.2f} s, iterate {t4 - t3:.2f} s ({n} "
          f"events, {ncuda} cuda, busy {busy / 1e6:.1f} ms), key_averages "
          f"{t5 - t4:.2f} s (busy {busy2 / 1e3:.1f} ms)", flush=True)


def main():
    import torch

    if not torch.cuda.is_available():
        print("profile_cost: no CUDA device", file=sys.stderr)
        return 1
    from glimslib_tpu_torch import _build
    from glimslib_tpu_torch.example_scripts import (
        brain_2D_atlas_reduced_domain_adjoint as ex,
    )
    from glimslib_tpu_torch.examples import UNSTRUCT_STEP_CONFIG, brain_sim
    from glimslib_tpu_torch.models.base import default_step_config

    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    _build.build_all()
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)

    sim = brain_sim(n=32, dtype=torch.float32, device=dev, unstructured=True)
    sim.step_config = UNSTRUCT_STEP_CONFIG
    args = (sim.make_theta(sim.params.as_dict()), *sim.initial_state())
    f = sim.build_simulate_fn(5, 1.0)
    f(*args)
    measure(torch, "unstructured 5 steps", lambda: f(*args))
    del sim, f, args

    mf = brain_sim(n=32, dtype=torch.float32, device=dev)
    mf.operator_mode = "matrix-free"
    args = (mf.make_theta(mf.params.as_dict()), *mf.initial_state())
    f = mf.build_simulate_fn(2, 1.0)
    f(*args)
    measure(torch, "mf lattice 2 steps", lambda: f(*args))
    del mf, f, args

    q = brain_sim(n=32, dtype=torch.float32, device=dev, quad=True)
    q.step_config = default_step_config(torch.float32)
    args = (q.make_theta(q.params.as_dict()), *q.initial_state())
    f = q.build_simulate_fn(1, 1.0)
    f(*args)
    measure(torch, "quad mf 1 step", lambda: f(*args))
    del q, f, args

    with tempfile.TemporaryDirectory() as tmp:
        measure(torch, "reduced-domain adjoint script",
                lambda: ex.main([], device=dev, dtype=torch.float32, plot=False,
                                out_dir=tmp))
    return 0


if __name__ == "__main__":
    sys.exit(main())
