"""The one generator of every traffic mix: it reads a mix's data file
(``traffic/<mix>.json``) and makes, from ``--seed``, a run's inputs.

A mix is a closed loop with one client: units of work back to back, each
one whole simulation (``"call": "simulate"``) or one ``value_and_grad``
of the inverse problem (``"call": "value_and_grad"``).  A round of units
draws each parameter of ``draws`` log-uniformly, stratified: the product
of ``strata`` cells of the log box, one draw in each cell, the round's
order shuffled.  Every seed thus runs the same spread of parameters in
another order and with another jitter inside each cell, so the seed does
not change how much work a run does.  The tumour seed centre of a unit
(or, for the inverse problem, of the run) lies uniformly in direction
and radius within ``seed_centre``'s shell.  The window cycles through the
round; ``sample`` units of those completed are checked, drawn from the
seed.
"""

from __future__ import annotations

import itertools

import numpy as np


def _centre(rng, spec):
    d = rng.normal(size=3)
    d /= np.linalg.norm(d)
    r = rng.uniform(*spec["radius"])
    return np.asarray(spec["centre"], dtype=np.float64) + r * d


def gaussian(points, centre, width2):
    """exp(-|x - centre|^2 / width2) at ``points`` (m, 3)."""
    return np.exp(-((np.asarray(points) - centre) ** 2).sum(1) / width2)


class Design:
    """A run's inputs: ``units`` (one dict each: parameter values and, for
    simulations, the tumour seed centre), the run's own centre and
    targets (inverse problem), and the draw that picks the checked units."""

    def __init__(self, traffic, seed):
        rng = np.random.default_rng(int(seed))
        self.traffic = traffic
        names = list(traffic["draws"])
        cells = list(itertools.product(*[range(traffic["strata"][n]) for n in names]))
        units = []
        for cell in cells:
            u = {}
            for n, k in zip(names, cell):
                lo, hi = np.log(traffic["draws"][n]["log_uniform"])
                s = traffic["strata"][n]
                u[n] = float(np.exp(lo + (k + rng.uniform()) * (hi - lo) / s))
            if traffic["call"] == "simulate":
                u["centre"] = _centre(rng, traffic["seed_centre"])
            units.append(u)
        self.units = [units[i] for i in rng.permutation(len(units))]
        self.centre = _centre(rng, traffic["seed_centre"])
        self.target = None
        if traffic["call"] == "value_and_grad":
            t2, tu = traffic["target_T2"], traffic["target_disp"]
            self.target = {"radius": float(rng.uniform(*t2["radius"])), "edge": t2["edge"],
                           "amplitude": float(rng.uniform(*tu["amplitude"])),
                           "width": tu["width"]}
        self._pick = rng.uniform(size=traffic["sample"])

    def unit(self, i):
        return self.units[i % len(self.units)]

    def sample(self, n_done):
        """The indices of the completed units that are checked."""
        return sorted({int(p * n_done) for p in self._pick}) if n_done else []

    # -- fields, evaluated by each side at its own dofs ----------------------
    def c0(self, points, unit=None):
        centre = self.centre if unit is None else unit["centre"]
        return gaussian(points, centre, self.traffic["seed_width2"])

    def target_T2(self, points):
        """A smooth ball (the thresholded tumour) around the run's centre."""
        t = self.target
        r = np.linalg.norm(np.asarray(points) - self.centre, axis=1)
        return 0.5 * (np.tanh((t["radius"] - r) / t["edge"]) + 1.0)

    def target_disp(self, points):
        """A smooth radial displacement away from the run's centre."""
        t = self.target
        x = np.asarray(points) - self.centre
        w = t["width"]
        return t["amplitude"] * x / w * np.exp(-(x ** 2).sum(1, keepdims=True) / (2 * w * w))

    def v(self, unit):
        return [unit[n] for n in self.traffic["draws"]]

    def params(self, base, unit):
        """Model parameters of a simulation unit: ``base`` with the drawn
        names set."""
        return {**base, **{n: unit[n] for n in self.traffic["draws"]}}
