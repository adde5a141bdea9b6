# Counterpart of glimslib_tpu/utils/profiling.py. Tracer and run_stats are
# the JAX package's code byte for byte; device_trace maps onto
# torch.profiler in place of jax.profiler.
"""Tracing / profiling utilities.

The reference has no dedicated tracing (SURVEY.md §5 — closest are the
optimizer progress frames and ``total_time_optimization_seconds``).  This
module goes further: wall-clock scopes, per-run solver statistics, and a
hook into torch.profiler for on-device traces.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import time
from collections import defaultdict
from typing import Dict, Optional

import torch

from glimslib_tpu_torch import config

logger = logging.getLogger(__name__)


class Tracer:
    """Nested wall-clock scopes with aggregated statistics.

    >>> tracer = Tracer()
    >>> with tracer.scope("forward"):
    ...     ...
    >>> tracer.summary()
    """

    def __init__(self):
        self.records = defaultdict(list)
        self._stack = []

    @contextlib.contextmanager
    def scope(self, name: str):
        full = "/".join([*self._stack, name])
        self._stack.append(name)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._stack.pop()
            self.records[full].append(time.perf_counter() - t0)

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, times in sorted(self.records.items()):
            out[name] = {
                "count": len(times),
                "total_s": sum(times),
                "mean_s": sum(times) / len(times),
                "max_s": max(times),
            }
        return out

    def log_summary(self):
        for name, s in self.summary().items():
            logger.info(
                "%-40s n=%-4d total=%.3fs mean=%.4fs", name, s["count"],
                s["total_s"], s["mean_s"],
            )

    def save(self, path):
        with open(path, "w") as f:
            json.dump(self.summary(), f, indent=1)
        return path


@contextlib.contextmanager
def device_trace(log_dir: str, device=None):
    """On-device trace via torch.profiler, in place of jax.profiler: a
    Chrome trace (chrome://tracing, Perfetto) written into ``log_dir`` on
    exit, its path in the profiler's ``trace_path``.

    The activities are the CPU's, plus CUDA where ``device`` (default: the
    card, as every model of the port) is a CUDA device; a CUDA device
    without CUDA raises, so a trace never silently lacks the card."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if config.resolve_device(device).type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.trace_path = os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(prof.trace_path)


def run_stats(sim) -> Optional[Dict]:
    """Solver statistics of the last ``Simulation.run`` (Newton iteration
    counts per step; the analogue of SNES iteration reports)."""
    info = getattr(sim, "solver_info", None)
    if not info:
        return None
    iters = info["newton_iters"]
    return {
        "steps": int(len(iters)),
        "newton_iters_per_step": [int(k) for k in iters],
        "newton_iters_total": int(iters.sum()),
    }
