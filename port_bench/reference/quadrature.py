"""Grundmann-Moeller quadrature on the unit simplex.

A. Grundmann and H. M. Moeller, "Invariant integration formulas for the
n-simplex by combinatorial methods", SIAM J. Numer. Anal. 15 (1978):
the rule of index s integrates polynomials of degree 2s + 1 exactly.
Points are returned in barycentric coordinates and the weights sum to 1,
so that a cell integral is its volume times the weighted sum.
"""

from __future__ import annotations

import itertools
import math

import numpy as np


def _compositions(total, parts):
    """Every tuple of ``parts`` non-negative integers summing to ``total``."""
    for cut in itertools.combinations(range(total + parts - 1), parts - 1):
        prev, out = -1, []
        for c in cut:
            out.append(c - prev - 1)
            prev = c
        out.append(total + parts - 1 - prev - 1)
        yield tuple(out)


def grundmann_moeller(dim, degree):
    """(barycentric points (nq, dim + 1), weights (nq,)) exact to ``degree``
    on the ``dim``-simplex; the weights sum to 1."""
    s = degree // 2
    d = 2 * s + 1
    pts, wts = [], []
    for i in range(s + 1):
        w = ((-1) ** i * 2.0 ** (-2 * s) * (d + dim - 2 * i) ** d
             / (math.factorial(i) * math.factorial(d + dim - i)))
        for beta in _compositions(s - i, dim + 1):
            pts.append([(2 * b + 1) / (d + dim - 2 * i) for b in beta])
            wts.append(w)
    w = np.asarray(wts, dtype=np.float64)
    return np.asarray(pts, dtype=np.float64), w / w.sum()
