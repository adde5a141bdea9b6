"""One run of one cell: set-up, warm-up, the measured window, the traced
unit (``--trace 1``), the per-layer metrics, the comparison with the
plain reference, and the result line.

A unit of work is one whole simulation (``simulate``) or one
``value_and_grad`` call, each ended by a device synchronisation.  The
window runs units back to back until ``seconds`` have passed and ends on
a whole unit; a rate is the units' steps (or calls) over the window's
whole time.  With ``trace`` one unit runs under the profiler before the
window opens, and the per-layer metrics are read from it and from the
window's units; the end-to-end metrics come from untraced runs.  The
reference runs once the window has closed, the peak memory has been read
and the port's state is freed.
"""

from __future__ import annotations

import gc
import math
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

from port_bench import loadgen, spec, system, tracing
from port_bench.reference import inverse as ref_inverse
from port_bench.reference.mesh import keys_of_points
from port_bench.reference.model import Reference

# top-level modules that no run may load, compared whole: the port's
# name begins with the JAX package's
FORBIDDEN = ("jax", "jaxlib", "flax", "glimslib_tpu")
GIB = 2.0 ** 30
# the solver counters of one unit, as the port records them
ITER_KEYS = ("rd_cg_iters", "el_cg_iters", "el_refine_cg_iters",
             "rd_adj_cg_iters", "el_adj_cg_iters")


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _match(ref_keys, port_keys):
    """Index into the reference's dofs of each of the port's dofs."""
    order = torch.argsort(ref_keys)
    srt = ref_keys[order]
    pos = torch.searchsorted(srt, port_keys).clamp(max=len(srt) - 1)
    if not torch.equal(srt[pos], port_keys):
        raise RuntimeError("a dof of the port has no dof of the reference at its place")
    return order[pos]


def _rel_max(got, want):
    return float((got - want).abs().max() / want.abs().max())


def _el_error(ref, rec, c_points, u_points, n, L):
    """The port's final displacement against the reference's solve of the
    elasticity equation at the port's own final concentration, in the L2
    norm relative to the solve's: the error of the last elasticity solve
    alone, which the concentration's Newton tolerances do not reach, and
    in which the float32 rounding of the state averages out."""
    m = ref.mesh
    ci = _match(ref.c_keys.cpu(), keys_of_points(c_points, n, L)).to(ref.device)
    ui = _match(m.cell_vertex_keys.cpu(), keys_of_points(u_points, n, L)).to(ref.device)
    c = torch.zeros(ref.nc_dofs, dtype=torch.float64, device=ref.device)
    c[ci] = rec.c_T.to(ref.device, torch.float64)
    want = ref.solve_u(c)
    got = torch.zeros_like(want)
    got[ui] = rec.u_T.to(ref.device, torch.float64)
    return math.sqrt(ref.mass_norm2(got - want, vector=True)
                     / ref.mass_norm2(want, vector=True))


class _Work:
    """What both kinds of unit share: the port's model, the design, the
    records of the units run."""

    def __init__(self, cfg, traffic, device):
        self.cfg, self.traffic, self.device = cfg, traffic, device
        self.design = None
        self.n_steps, self.dt = traffic["n_steps"], traffic["dt"]
        self.sim = system.build_sim(cfg, device)
        self.c_points = np.asarray(system.concentration_points(self.sim))
        self.u_points = np.asarray(self.sim.mesh.points)
        self.records = []

    def _record(self, i, t0, ok, extra):
        info = self.sim.solver_info
        rec = SimpleNamespace(index=i, wall_s=time.perf_counter() - t0, ok=ok,
                              iters={k: list(info.get(k, [])) for k in ITER_KEYS},
                              **extra)
        self.records.append(rec)
        return rec

    def setup_parts(self):
        return dict(getattr(self.sim, "setup_seconds", None) or {})

    def free(self):
        """Drop the port's state before the reference runs."""
        for k in [k for k in vars(self) if k not in (
                "cfg", "traffic", "design", "device", "n_steps", "dt", "c_points",
                "u_points", "records")]:
            delattr(self, k)
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


class ForwardWork(_Work):
    """Whole simulations of the model at the design's parameters and seeds."""

    steps_per_unit = property(lambda self: self.n_steps)

    def __init__(self, cfg, traffic, device):
        super().__init__(cfg, traffic, device)
        sim = self.sim
        self.simulate = sim.build_simulate_fn(self.n_steps, self.dt)
        self.base = sim.params.as_dict()
        self.u0 = torch.zeros(sim.mesh.n_nodes, 3, dtype=sim.dtype, device=sim.device)

    def use(self, design):
        """Take a run's inputs: each unit's initial concentration."""
        sim = self.sim
        self.design = design
        self.c0 = [torch.as_tensor(design.c0(self.c_points, u), dtype=sim.dtype,
                                   device=sim.device) for u in design.units]

    def warm_up(self):
        self.simulate(self.sim.make_theta(self.base), self.u0, self.c0[0])
        _sync(self.device)

    def run_unit(self, i):
        t0 = time.perf_counter()
        unit = self.design.unit(i)
        theta = self.sim.make_theta(self.design.params(self.base, unit))
        u_tr, c_tr, ok, newton = self.simulate(theta, self.u0,
                                               self.c0[i % len(self.c0)])
        _sync(self.device)
        return self._record(i, t0, bool(ok.all()), dict(
            newton=[int(k) for k in newton], u_T=u_tr[-1].cpu(), c_T=c_tr[-1].cpu()))

    def check(self, ref, rec):
        """{number: value} of one unit against the reference."""
        unit = self.design.unit(rec.index)
        m = ref.mesh
        c_pts = (m.dof_points2 if ref.p2 else m.points).cpu().numpy()
        c0 = torch.as_tensor(self.design.c0(c_pts, unit), device=ref.device)
        u, c = ref.simulate(self.design.params(self.cfg["parameters"], unit), c0,
                            self.n_steps, self.dt)
        n, L = self.cfg["voxels_per_side"], self.cfg["box_length"]
        ci = _match(ref.c_keys.cpu(), keys_of_points(self.c_points, n, L))
        ui = _match(m.cell_vertex_keys.cpu(), keys_of_points(self.u_points, n, L))
        return {"c_err": _rel_max(rec.c_T.double(), c.cpu()[ci]),
                "u_err": _rel_max(rec.u_T.double(), u.cpu()[ui]),
                "el_err": _el_error(ref, rec, self.c_points, self.u_points, n, L)}


class InverseWork(_Work):
    """``value_and_grad`` calls of the inverse problem at the design's points."""

    steps_per_unit = property(lambda self: self.n_steps)

    def __init__(self, cfg, traffic, device):
        super().__init__(cfg, traffic, device)
        self.final = system.keep_final_state(self.sim)

    def use(self, design):
        """Take a run's inputs: the initial concentration and the targets,
        from which the port builds its inverse problem."""
        sim, t = self.sim, self.traffic
        self.design = design
        system.set_initial_concentration(sim, self.cfg, design.c0(self.c_points))
        targets = {"conc_T2": design.target_T2(self.c_points),
                   "disp": design.target_disp(self.u_points)}
        self.problem = system.inverse_problem(
            sim, targets, t["parameter_map"], self.n_steps, self.dt, t["threshold"]["level"])

    def warm_up(self):
        self.problem.value_and_grad(self.traffic["warm_up_v"])
        _sync(self.device)

    def run_unit(self, i):
        t0 = time.perf_counter()
        v = self.design.v(self.design.unit(i))
        J, g = self.problem.value_and_grad(v)
        _sync(self.device)
        ok = math.isfinite(J) and bool(np.isfinite(g).all())
        return self._record(i, t0, ok, dict(v=v, J=J, g=np.asarray(g, dtype=np.float64),
                                            u_T=self.final["u_T"].cpu(),
                                            c_T=self.final["c_T"].cpu()))

    def check(self, ref, rec):
        d, m, t = self.design, ref.mesh, self.traffic
        c_pts = (m.dof_points2 if ref.p2 else m.points).cpu().numpy()
        dev = ref.device
        problem = {
            "base": self.cfg["parameters"], "parameter_map": t["parameter_map"],
            "c0": torch.as_tensor(d.c0(c_pts), device=dev),
            "target_T2": torch.as_tensor(d.target_T2(c_pts), device=dev),
            "target_u": torch.as_tensor(d.target_disp(m.points.cpu().numpy()), device=dev),
            "n_steps": self.n_steps, "dt": self.dt,
            "level": t["threshold"]["level"], "smooth": t["threshold"]["smooth"]}
        J, g = ref_inverse.value_and_grad(ref, problem, rec.v)
        g = np.asarray(g)
        n, L = self.cfg["voxels_per_side"], self.cfg["box_length"]
        return {"J_err": abs(rec.J - J) / abs(J),
                "grad_err": float(np.abs(rec.g - g).max() / np.abs(g).max()),
                "el_err": _el_error(ref, rec, self.c_points, self.u_points, n, L)}


# the unit of work of a traffic mix's "call"
WORK = {"simulate": ForwardWork, "value_and_grad": InverseWork}


def _read_metrics(bench, wl_name, ctx, root):
    out = {}
    for m in spec.per_layer(bench, wl_name):
        value = spec.metric_reader(m["name"], root)(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def run(wl_name, seed, seconds, trace, t_start, device="cuda", root=spec.ROOT,
        cfg_override=None):
    """One run of cell ``wl_name``; returns the result dict (the last line)
    and the checks, or raises.  ``cfg_override`` (tests): keys replaced
    in the configuration, such as a smaller box."""
    bench = spec.load(root)
    wl = spec.workload(bench, wl_name)
    cfg = {**spec.config(bench, wl["config"], root), **(cfg_override or {})}
    traffic = spec.traffic(wl["traffic"], root)
    limits = spec.limits(wl_name, root)
    device = torch.device(device)
    design = loadgen.Design(traffic, seed)
    work = WORK[traffic["call"]](cfg, traffic, device)
    work.use(design)
    work.warm_up()
    work.records.clear()
    if device.type == "cuda":
        setup_peak = torch.cuda.max_memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t_start

    # -- the window ------------------------------------------------------------
    ctx = SimpleNamespace(trace=None, traced=[], counters=None,
                          n_nodes=work.sim.mesh.n_nodes,
                          lattice=bool(getattr(work.sim, "lattice", False)))
    i = 0
    if trace:
        # the traced unit comes first and outside the timed window
        before = system.kernel_counters()
        with tracing.traced() as held:
            ctx.traced.append(work.run_unit(i))
        after = system.kernel_counters()
        ctx.trace = held.trace
        ctx.counters = {k: _diff(before[k], after[k]) for k in before}
        i += 1
    t_win = time.perf_counter()
    while time.perf_counter() - t_win < seconds:
        work.run_unit(i)
        i += 1
    window_s = time.perf_counter() - t_win
    records = work.records
    window_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    found = forbidden_modules()
    if found:
        raise SystemExit(f"modules loaded that no run may load: {found}")

    failed = sum(1 for r in records if not r.ok)
    metrics = {}
    if trace:
        ctx.records = records[len(ctx.traced):]
        ctx.setup_parts = work.setup_parts()
        ctx.steps_per_unit = work.steps_per_unit
        ctx.iters = _iter_ints
        metrics = _read_metrics(bench, wl_name, ctx, root)
    else:
        # an end-to-end metric is read by its unit, so that a cell's own
        # name for it (steps/s of one lane or another) needs no code
        done = len(records)
        by_unit = {"steps/s": done * work.steps_per_unit / window_s,
                   "calls/s": done / window_s,
                   "GiB": window_peak / GIB, "s": setup_s}
        for m in spec.end_to_end(bench, wl_name):
            metrics[m["name"]] = {"value": by_unit[m["unit"]], "unit": m["unit"]}

    # -- the comparison ----------------------------------------------------------
    work.free()
    ref = Reference(cfg, device)
    checks = {}
    for k in design.sample(len(records)):
        for name, value in work.check(ref, records[k]).items():
            checks[name] = max(checks.get(name, 0.0), value)
    correct = (failed == 0 and bool(checks)
               and all(checks[n] <= limits[n]["limit"] for n in limits)
               and all(math.isfinite(v) for v in checks.values()))
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": wl["chips"],
           "memory_peak_bytes": int(max(setup_peak, window_peak)) if device.type == "cuda"
           else 0}
    result = {"correct": bool(correct), "attempted": len(records), "failed": failed,
              "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = ctx.trace.busy_s
        dev["window_s"] = ctx.trace.window_s
        result["breakdown"] = ctx.trace.breakdown()
    result["checks"] = {n: {"value": checks.get(n, float("nan")), "limit": limits[n]["limit"]}
                        for n in limits}
    return result


def _diff(a, b):
    """The counts of ``b`` above those of ``a``, by key."""
    return {k: b.get(k, 0) - a.get(k, 0) for k in set(a) | set(b)
            if b.get(k, 0) - a.get(k, 0)}


def _iter_ints(rec, keys):
    """The iteration counts of ``keys`` of one unit, as ints."""
    return [int(x) for k in keys for x in rec.iters[k]]
