"""Bounded L-BFGS-B driver with per-iteration progress records.

Rebuild of the reference's optimizer plumbing: the custom scipy minimizer
(image_based_optimization.py:646-658), the eval/derivative callbacks
recording ``(J, params...)`` / ``(J, dJ...)`` with wall-clock timestamps
(l.614-625), and ``create_opt_progress_df`` merging them into one table
exported to pkl and csv (l.627-644, 748-762).

A copy of ``glimslib_tpu/optimize/lbfgsb.py``, numpy and scipy only, but
for the table: a dict of numpy columns under the reference's names, not a
pandas DataFrame (the port's workflow path does not import pandas).
"""

from __future__ import annotations

import logging
from datetime import datetime
from typing import Callable, List, Optional

import numpy as np

logger = logging.getLogger(__name__)


class OptimizationProgress:
    """Per-iteration (J, params, dJ, datetime) records."""

    def __init__(self, param_names: List[str]):
        self.param_names = list(param_names)
        self.eval_records = []  # (eval#, J, *params)
        self.grad_records = []  # (eval#, J, *dJ)
        self.datetime_records = []  # (eval#, J, datetime)

    def record_eval(self, j, params):
        # merge key is the eval counter, NOT J: duplicate J values
        # (line-search re-evaluations, plateaus) would cartesian-product
        # rows when merged on J (advisor finding r1)
        seq = len(self.eval_records)
        self.eval_records.append((seq, float(j), *np.asarray(params, float)))
        self.datetime_records.append((seq, float(j), datetime.now()))

    def record_grad(self, j, dj):
        seq = max(len(self.eval_records) - 1, 0)
        self.grad_records.append((seq, float(j), *np.asarray(dj, float)))

    def to_columns(self):
        """The reference's create_opt_progress_df (l.627-644) as a dict of
        numpy columns: ``eval``, ``J``, the parameters, ``datetime`` and
        ``dJd<name>`` (NaN where an evaluation has no gradient)."""
        ev = np.asarray([r[0] for r in self.eval_records], dtype=np.int64)
        cols = {"eval": ev,
                "J": np.asarray([r[1] for r in self.eval_records], dtype=np.float64)}
        for i, name in enumerate(self.param_names):
            cols[name] = np.asarray([r[2 + i] for r in self.eval_records],
                                    dtype=np.float64)
        cols["datetime"] = np.asarray([r[2] for r in self.datetime_records],
                                      dtype="datetime64[us]")
        if self.grad_records:
            by_eval = {r[0]: r[2:] for r in self.grad_records}
            for i, name in enumerate(self.param_names):
                cols[f"dJd{name}"] = np.asarray(
                    [by_eval[e][i] if e in by_eval else np.nan for e in ev],
                    dtype=np.float64)
        return cols

    def save(self, path_pkl=None, path_xls=None):
        """Pickle the columns to ``path_pkl`` and write them as CSV beside
        ``path_xls`` (its extension swapped to .csv, the reference's
        fallback when no excel writer is installed); returns them."""
        from glimslib_tpu_torch.utils.data_io import save_columns

        csv = str(path_xls).rsplit(".", 1)[0] + ".csv" if path_xls else None
        return save_columns(self.to_columns(), path_pkl=path_pkl, path_csv=csv)

    @property
    def total_time_seconds(self):
        if len(self.datetime_records) < 2:
            return 0.0
        t0 = self.datetime_records[0][2]
        t1 = self.datetime_records[-1][2]
        return (t1 - t0).total_seconds()

    @property
    def number_iterations(self):
        return len(self.eval_records)


def minimize_lbfgsb(
    value_and_grad: Callable,
    x0,
    bounds=None,
    param_names: Optional[List[str]] = None,
    tol: float = 1e-6,
    gtol: float = 1e-6,
    maxiter: int = 200,
    eval_cb: Optional[Callable] = None,
    derivative_cb: Optional[Callable] = None,
    disp: bool = False,
    method: str = "L-BFGS-B",
    algorithm: Optional[Callable] = None,
):
    """Run a bounded optimizer on a (J, dJ) oracle
    (reference defaults: method L-BFGS-B, tol 1e-6, gtol 1e-6, bounds
    [0.005, 0.5]; image_based_optimization.py:711-718).

    The optimizer is pluggable like the reference's ``minimize_custom`` /
    ``custom_optimizer`` path (image_based_optimization.py:646-658, 733):

    - ``method``: any scipy.optimize gradient method name
      ('L-BFGS-B', 'TNC', 'SLSQP', ...);
    - ``algorithm``: a user-supplied callable
      ``algorithm(J, x0, dJ, H, bounds, **kwargs) -> x_opt | OptimizeResult``
      — the reference ``custom_optimizer`` signature — which takes over the
      whole solve.  ``J``/``dJ`` share one memoized oracle evaluation, so a
      J-then-dJ call at the same point costs one simulation.

    Returns (x_opt, progress, scipy_result_or_equivalent)."""
    from scipy.optimize import OptimizeResult
    from scipy.optimize import minimize as scipy_minimize

    x0 = np.asarray(x0, dtype=np.float64)
    param_names = param_names or [f"p{i}" for i in range(len(x0))]
    progress = OptimizationProgress(param_names)

    def fun(x):
        j, g = value_and_grad(x)
        progress.record_eval(j, x)
        progress.record_grad(j, dj=g)
        if eval_cb:
            eval_cb(j, x)
        if derivative_cb:
            derivative_cb(j, g, x)
        logger.info("optimization eval: J=%.6e params=%s", j, list(x))
        return j, g

    if algorithm is not None:
        memo = {}

        def _eval(x):
            key = np.asarray(x, np.float64).tobytes()
            if key not in memo:
                memo[key] = fun(np.asarray(x, np.float64))
            return memo[key]

        out = algorithm(
            lambda x: _eval(x)[0], x0, lambda x: _eval(x)[1], None, bounds,
            tol=tol, options={"maxiter": maxiter},
        )
        if isinstance(out, OptimizeResult):
            res = out
        else:
            x_opt = np.asarray(out, dtype=np.float64)
            j_opt, _ = _eval(x_opt)
            res = OptimizeResult(
                x=x_opt, fun=j_opt, success=True,
                nit=progress.number_iterations,
                message="custom algorithm finished",
            )
        logger.info("-- Finished Optimization (custom): %s", res.message)
        return np.asarray(res.x), progress, res

    # TNC spells the evaluation budget 'maxfun'; passing 'maxiter' raises
    # an unknown-option OptimizeWarning (scipy _minimize_tnc signature)
    options = (
        {"maxfun": maxiter} if method.upper() == "TNC"
        else {"maxiter": maxiter}
    )
    if method.upper() in ("L-BFGS-B", "TNC"):
        options["gtol"] = gtol
    res = scipy_minimize(
        fun,
        x0,
        jac=True,
        method=method,
        bounds=bounds,
        tol=tol,
        options=options,
    )
    if not hasattr(res, "nit"):  # some methods report nfev only
        res.nit = res.get("nfev", progress.number_iterations)
    logger.info("-- Finished Optimization: %s", res.message)
    return np.asarray(res.x), progress, res
