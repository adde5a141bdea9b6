"""The comparison that decides ``correct`` against a broken timed path.

Each case drives the rest of a run (set-up, warm-up, window, the
reference, the limits of ``limits/<cell>.json``) on the CPU at a tiny
box, with one fault planted in the port's simulate or in the inverse
problem's answer, and sees ``correct`` come out false:

- ``unchanged``: every step returns its state unchanged;
- ``altered``: the answer is altered where it is produced, 1% of the
  field's largest value added at one dof of the final state, or J scaled
  by 1.01 and the gradient's first component by 1.1.

The cells have no batch and one chip, so the faults of half a batch left
out and of a missing exchange between chips do not arise.

The control, the port with its float64 refinement switched off, is
``test_bench_control.py``'s.
"""

import time

import pytest
import torch

from port_bench import harness, system

SIZES = {"lattice64.forward": 4, "quad32.forward": 3, "quad32.inverse": 3}


def _broken_simulate(simulate, fault):
    def run(theta, u0, c0, aux=None):
        u, c, ok, newton = simulate(theta, u0, c0, aux)
        if fault == "unchanged":
            # keep the graph (a zero gradient) so the inverse problem runs on
            u = u0.expand_as(u) + 0.0 * u
            c = c0.expand_as(c) + 0.0 * c
        elif fault == "altered":
            k = int(torch.argmax(c[-1].detach().abs()))
            bump = torch.zeros_like(c)
            bump[-1, k] = 0.01 * float(c[-1].detach().abs().max())
            c = c + bump
        return u, c, ok, newton
    return run


def _plant(monkeypatch, fault, inverse):
    real_build = system.build_sim

    def build_sim(cfg, device, dtype=None):
        sim = real_build(cfg, device, dtype)
        make = sim.build_simulate_fn
        sim.build_simulate_fn = lambda n, dt: _broken_simulate(make(n, dt), fault)
        return sim

    if fault == "unchanged" or not inverse:
        monkeypatch.setattr(system, "build_sim", build_sim)
        return
    real_problem = system.inverse_problem

    def inverse_problem(*args, **kwargs):
        problem = real_problem(*args, **kwargs)
        vg = problem.value_and_grad

        def altered(v):
            J, g = vg(v)
            g = list(g)
            g[0] = 1.1 * g[0]
            return 1.01 * J, g
        problem.value_and_grad = altered
        return problem

    monkeypatch.setattr(system, "inverse_problem", inverse_problem)


@pytest.mark.parametrize("fault", ["unchanged", "altered"])
@pytest.mark.parametrize("workload", sorted(SIZES))
def test_a_broken_timed_path_is_not_correct(monkeypatch, workload, fault):
    torch.set_num_threads(min(4, torch.get_num_threads()))
    _plant(monkeypatch, fault, workload.endswith("inverse"))
    result = harness.run(workload, 2 ** 31 + 101, 0.3, False, time.perf_counter(),
                         device="cpu", cfg_override={"voxels_per_side": SIZES[workload]})
    assert result["attempted"] >= 1
    assert result["correct"] is False, result["checks"]


@pytest.mark.parametrize("workload", sorted(SIZES))
def test_the_sound_path_is_correct_at_the_same_size(workload):
    torch.set_num_threads(min(4, torch.get_num_threads()))
    result = harness.run(workload, 2 ** 31 + 101, 0.3, False, time.perf_counter(),
                         device="cpu", cfg_override={"voxels_per_side": SIZES[workload]})
    assert result["correct"] is True, result["checks"]
